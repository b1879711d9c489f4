"""The trace readers on a canned trace: two streams that overlap, kernels
replayed inside CUDA graphs under the same names, host spans open across
the idle gaps."""
import pytest

from benchmark import device_trace, harness

K1 = "void allview_ncc_kernel<4>(Scene, unsigned char const*, float*)"
SPAN = device_trace.SCENE_SPAN


def _trace():
    device_ops = [
        # main stream
        (K1, 1.0, 1.5),
        ("nm_reflect_kernel(Pose, float*)", 1.4, 1.6),  # side stream
        ("nm_contract_kernel(Pose, float const*)", 1.55, 1.7),
        (K1, 1.65, 2.0),  # replayed in a graph: same name
        ("nm_accept_kernel(float const*)", 2.0, 2.1),
        ("Memcpy HtoD (Pageable -> Device)", 3.0, 3.5),
        (K1, 5.0, 5.5),
        (K1, 9.5, 11.0),  # runs past the window's end
    ]
    host = [
        (SPAN, 0.5, 6.0), (SPAN, 6.0, 10.0),
        ("stage/seed", 0.6, 2.9), ("stage/expand", 3.6, 9.9),
        ("aten::nonzero", 2.2, 2.95), ("aten::copy_", 2.95, 3.0),
        ("cudaStreamSynchronize", 5.6, 9.4),
    ]
    return device_trace.Trace(device_ops, host)


def _ctx():
    tr = _trace()
    return harness.ReadContext(2, {"seed": 3.0, "expand": 5.0}, {}, tr,
                               tr.window())


def test_window_is_the_scenes_spans():
    assert _trace().window() == (0.5, 10.0)


def test_busy_is_the_union_not_the_sum():
    tr = _trace()
    lo, hi = tr.window()
    # union: [1.0, 2.1] + [3.0, 3.5] + [5.0, 5.5] + [9.5, 10.0] (clipped)
    assert device_trace.busy_seconds(tr, lo, hi) == pytest.approx(2.6)
    summed = sum(min(e, hi) - max(s, lo) for _, s, e in tr.device_ops)
    assert summed == pytest.approx(2.8)  # the overlap, counted twice


def test_idle_share_reader():
    reader = harness.metric_readers()["device_idle_share"]
    assert reader.read(_ctx()) == pytest.approx(1 - 2.6 / 9.5)


def test_kernel_readers_count_every_instance_by_name():
    readers = harness.metric_readers()
    # K1: 0.5 + 0.35 + 0.5 + 0.5 (clipped at the window), over 2 scenes
    assert readers["k1_ms"].read(_ctx()) == pytest.approx(1e3 * 1.85 / 2)
    assert readers["nm_step_ms"].read(_ctx()) == pytest.approx(
        1e3 * (0.2 + 0.15 + 0.1) / 2)


def test_readers_find_nothing_and_return_nothing():
    empty = device_trace.Trace([], [(SPAN, 0.0, 1.0)])
    ctx = harness.ReadContext(1, {}, {}, empty, empty.window())
    for name, reader in harness.metric_readers().items():
        assert reader.read(ctx) is None, name


def test_stage_readers():
    readers = harness.metric_readers()
    ctx = harness.ReadContext(
        4, {"seed": 8.0, "seed_filter": 1.0, "seed_optimize": 3.0,
            "expand": 6.0, "filter": 2.0, "color": 0.4}, {}, _trace(),
        (0.5, 10.0))
    assert readers["seed_s"].read(ctx) == pytest.approx(2.0)
    assert readers["seed_optimize_s"].read(ctx) == pytest.approx(1.0)
    assert readers["expand_s"].read(ctx) == pytest.approx(1.5)
    assert readers["filter_s"].read(ctx) == pytest.approx(0.6)


def test_gaps_are_labelled_by_what_the_host_was_doing():
    tr = _trace()
    lo, hi = tr.window()
    gaps = device_trace.idle_gaps(tr, lo, hi)
    assert gaps[0] == pytest.approx((5.5, 9.5))
    assert device_trace.gap_label(tr, *gaps[0]) == (
        "stage/expand > cudaStreamSynchronize")
    b = device_trace.breakdown(tr, lo, hi)
    assert b["device_ops"][0][0] == K1[:device_trace.NAME_CHARS]
    assert b["device_ops"][0][1] == pytest.approx(1.85)
    assert b["idle_gaps"][0] == [
        "stage/expand > cudaStreamSynchronize", pytest.approx(4.0)]
    assert len(b["idle_gaps"]) <= device_trace.TOP
    labels = [g[0] for g in b["idle_gaps"]]
    assert "stage/seed > aten::nonzero" in labels
