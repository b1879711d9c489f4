"""The reader of Nelder-Mead's graph reuse on canned counters: reuses over
reuses and captures, nothing where the counters are absent (a program that
captures a graph per solve) or count no graph; and discovery lists it."""
import pytest

from benchmark import device_trace, harness

SPAN = device_trace.SCENE_SPAN


def _ctx(counters):
    trace = device_trace.Trace([], [(SPAN, 0.0, 1.0), (SPAN, 1.0, 2.0)])
    return harness.ReadContext(2, {"seed": 1.0}, dict(counters), trace,
                               trace.window())


def test_discovery_lists_the_reader():
    reader = harness.metric_readers()["nm_graph_reuse_share"]
    assert reader.UNIT == "fraction"


@pytest.mark.parametrize("captures, reuses, share", [
    (10.0, 140.0, 140 / 150), (76.0, 0.0, 0.0), (0.0, 12.0, 1.0)])
def test_reuses_over_solves_that_replayed(captures, reuses, share):
    reader = harness.metric_readers()["nm_graph_reuse_share"]
    counters = {"nm_graph_captures": captures, "nm_graph_reuses": reuses,
                "nm_graph_replays": 3000.0}
    assert reader.read(_ctx(counters)) == pytest.approx(share)
    assert 0.0 <= reader.read(_ctx(counters)) <= 1.0


@pytest.mark.parametrize("counters", [
    {},  # no solver counters at all
    {"nm_graph_captures": 152.0, "nm_graph_replays": 3048.0},  # the parent
    {"nm_graph_captures": 0.0, "nm_graph_reuses": 0.0},  # no graph made
])
def test_nothing_to_read_gives_nothing(counters):
    reader = harness.metric_readers()["nm_graph_reuse_share"]
    assert reader.read(_ctx(counters)) is None
