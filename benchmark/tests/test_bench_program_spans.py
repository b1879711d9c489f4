"""The readers of the program's own spans and counters on a canned trace:
idle time inside nested and overlapping spans counted once, K1's roofline
share from its counted work, and nothing read where nothing is there."""
import pytest

from benchmark import device_trace, harness, program_spans, roofline

K1 = "void allview_ncc_kernel<4>(Scene, unsigned char const*, float*)"
SPAN = device_trace.SCENE_SPAN
COUNTERS = {"k1_rows": 1000.0, "k1_textures": 20000.0,
            "k1_texels": 20000.0 * 121, "k1_bytes": 3.0e6,
            "expand_candidates": 400.0, "expand_accepted": 100.0}


def _trace():
    device_ops = [
        (K1, 1.0, 1.5),
        ("Memcpy DtoH (Device -> Pageable)", 1.4, 1.6),  # overlaps K1
        (K1, 3.0, 3.2),
        ("nm_accept_kernel(float const*)", 6.0, 6.5),
        (K1, 8.0, 8.5),
        (K1, 9.8, 11.0),  # runs past the window's end
    ]
    host = [
        (SPAN, 0.5, 5.0), (SPAN, 5.0, 10.0),
        # the harness's stage span and the program's own, same name
        ("stage/seed", 0.6, 4.0), ("stage/seed", 0.6, 4.0),
        # seed parts: detect nests a span of its own, tracks and match
        # overlap
        ("seed/detect", 0.8, 1.2), ("seed/detect", 0.9, 1.1),
        ("seed/match", 1.3, 2.5), ("seed/tracks", 2.0, 3.5),
        ("seed/triangulate", 3.6, 3.9),
        ("stage/expand", 4.5, 9.9),
        ("expand/round", 5.5, 7.0), ("expand/round", 7.0, 9.9),
        ("expand/solve", 6.0, 6.6),
        ("nm/solve", 6.0, 6.6), ("nm/capture", 6.1, 6.2),
        ("nm/capture", 9.5, 10.5),  # clipped at the window's end
        ("aten::copy_", 2.1, 2.2),
    ]
    return device_trace.Trace(device_ops, host)


def _ctx(counters=COUNTERS, trace=None):
    tr = trace or _trace()
    return harness.ReadContext(2, {"seed": 3.0, "expand": 5.0},
                               dict(counters), tr, tr.window())


def test_idle_inside_counts_each_instant_once():
    tr = _trace()
    lo, hi = tr.window()
    seed = program_spans.idle_inside(
        tr, lambda n: n.startswith("seed/"), lo, hi)
    # union of the seed spans: [0.8, 1.2] + [1.3, 3.5] + [3.6, 3.9];
    # busy inside it: [1.0, 1.2] + [1.3, 1.6] + [3.0, 3.2]
    assert seed == pytest.approx((0.4 + 2.2 + 0.3) - (0.2 + 0.3 + 0.2))
    rounds = program_spans.idle_inside(
        tr, lambda n: n == "expand/round", lo, hi)
    # [5.5, 9.9] less [6.0, 6.5], [8.0, 8.5] and [9.8, 9.9]
    assert rounds == pytest.approx(4.4 - 0.5 - 0.5 - 0.1)
    # all the idle time there is, at most
    idle = (hi - lo) - device_trace.busy_seconds(tr, lo, hi)
    assert seed + rounds <= idle


def test_host_readers_per_scene():
    readers = harness.metric_readers()
    assert readers["seed_host_s"].read(_ctx()) == pytest.approx(2.2 / 2)
    assert readers["expand_host_s"].read(_ctx()) == pytest.approx(3.3 / 2)


def test_capture_seconds_are_summed_inside_the_window():
    reader = harness.metric_readers()["nm_capture_s"]
    assert reader.read(_ctx()) == pytest.approx((0.1 + 0.5) / 2)


def test_accept_share():
    reader = harness.metric_readers()["expand_accept_share"]
    assert reader.read(_ctx()) == pytest.approx(0.25)
    assert reader.read(_ctx({**COUNTERS, "expand_candidates": 0.0})) is None


def test_k1_roofline_is_the_bound_of_the_counted_work():
    reader = harness.metric_readers()["k1_roofline"]
    assert reader.UNIT == "%"
    c = COUNTERS
    flops = (c["k1_rows"] * roofline.PATCH_FLOPS
             + c["k1_textures"] * roofline.TEXTURE_FLOPS
             + c["k1_texels"] * roofline.TEXEL_FLOPS)
    bound_s, by = roofline.bound(c["k1_bytes"], flops)
    assert by == "operations"
    # K1: 0.5 + 0.2 + 0.5 + 0.2 (clipped at the window)
    assert reader.read(_ctx()) == pytest.approx(100 * bound_s / 1.4)
    assert 0 < reader.read(_ctx()) <= 100
    missing = {k: v for k, v in COUNTERS.items() if k != "k1_texels"}
    assert reader.read(_ctx(missing)) is None


@pytest.mark.parametrize("name", ["k1_roofline", "seed_host_s",
                                  "expand_host_s", "nm_capture_s",
                                  "expand_accept_share"])
def test_nothing_to_read_gives_nothing(name):
    reader = harness.metric_readers()[name]
    # no device operation, no program span, no counter: the parent's trace
    # of a run on the CPU
    bare = device_trace.Trace([], [(SPAN, 0.0, 1.0), ("stage/seed", 0, 1)])
    assert reader.read(_ctx({}, bare)) is None
    # spans and counters but no device operation (a run on the CPU)
    host_only = device_trace.Trace([], _trace().host_spans)
    if name in ("seed_host_s", "expand_host_s", "k1_roofline"):
        assert reader.read(_ctx(COUNTERS, host_only)) is None
    # device operations but none of the program's spans (the parent)
    parent = device_trace.Trace(_trace().device_ops,
                                [(SPAN, 0.5, 5.0), (SPAN, 5.0, 10.0),
                                 ("stage/seed", 0.6, 4.0)])
    if name != "expand_accept_share" and name != "k1_roofline":
        assert reader.read(_ctx({}, parent)) is None
