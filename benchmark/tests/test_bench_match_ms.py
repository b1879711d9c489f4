"""`match_ms` on a canned trace: M1's launches by name, both ranked-k
instances, over the scenes; nothing where M1 never ran (a program
without it)."""
import pytest

from benchmark import device_trace, harness

SPAN = device_trace.SCENE_SPAN
M1_K2 = "void (anonymous namespace)::hamming_topk_kernel<2>((anonymous namespace)::Args)"
M1_K1 = "void (anonymous namespace)::hamming_topk_kernel<1>((anonymous namespace)::Args)"


def _ctx(device_ops):
    tr = device_trace.Trace(device_ops, [(SPAN, 0.0, 4.0), (SPAN, 4.0, 8.0)])
    return harness.ReadContext(2, {}, {}, tr, tr.window())


def test_match_ms_sums_every_instance_over_the_scenes():
    reader = harness.metric_readers()["match_ms"]
    ctx = _ctx([(M1_K2, 0.5, 0.52), (M1_K1, 4.5, 4.51),
                ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 1.0, 2.0),
                (M1_K2, 7.99, 8.5)])  # clipped at the window's end
    assert reader.UNIT == "ms"
    assert reader.read(ctx) == pytest.approx(1e3 * (0.02 + 0.01 + 0.01) / 2)


def test_match_ms_is_silent_without_the_kernel():
    reader = harness.metric_readers()["match_ms"]
    ctx = _ctx([("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 1.0, 2.0),
                ("gatherTopK", 2.0, 2.5)])
    assert reader.read(ctx) is None
