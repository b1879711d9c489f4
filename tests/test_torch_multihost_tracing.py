"""Expansion's spans and counters inside `densify_multihost`, over jobs of 1
and 2 gloo ranks on the CPU, and what the benchmark's readers take from
them.

The scene is `test_torch_multihost.py`'s (the textured plane, 5 views of
160 x 120, 40 seed points, 2 rounds), each rank under `torch.profiler`:

  * every rank opens `expand/insert_seeds` and, per round, `expand/round`
    around `expand/candidates`, `expand/solve` and `expand/insert`, all
    inside `stage/expand`, and each solve holds the solver's `nm/solve`;
  * `expand_candidates` and `expand_accepted` are the same on 2 ranks as
    on 1, and on both ranks of the job, with `rank_threads`;
  * `expand_accept_share` reads them, and `expand_host_s` reads the idle
    time inside the rounds of rank 0's spans (on a device timeline made
    for the test: the CPU has none).
"""
import numpy as np
import pytest

from benchmark import device_trace, harness
from tests.torch_parallel_util import run_job

ROUND_PARTS = ("candidates", "solve", "insert")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost_traced")
    inputs = {"max_iterations": np.int64(40), "max_rounds": np.int64(2)}
    return {world: run_job("multihost_traced", world, inputs, tmp)
            for world in (1, 2)}


def _spans(out):
    return [(str(n), int(s), int(e))
            for n, (s, e) in zip(out["span_names"], out["span_bounds"])]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("child, parent", [
    ("expand/insert_seeds", "stage/expand"),
    ("expand/round", "stage/expand"),
    *((f"expand/{p}", "expand/round") for p in ROUND_PARTS),
])
def test_spans_nest_on_every_rank(jobs, world, child, parent):
    for out in jobs[world]:
        spans = _spans(out)
        children = _named(spans, child)
        assert children and all(_inside(c, _named(spans, parent))
                                for c in children), child


def test_a_round_a_span(jobs):
    for out in jobs[1] + jobs[2]:
        spans = _spans(out)
        assert len(_named(spans, "expand/insert_seeds")) == 1
        assert len(_named(spans, "expand/round")) == 2  # max_rounds
        for part in ROUND_PARTS:
            assert len(_named(spans, f"expand/{part}")) == 2
        solves = _named(spans, "nm/solve")
        assert all(any(_inside(n, [s]) for n in solves)
                   for s in _named(spans, "expand/solve"))


def test_counters_equal_one_rank(jobs):
    one = jobs[1][0]
    assert one["counter_expand_candidates"] > one[
        "counter_expand_accepted"] > 0
    for out in jobs[2]:
        for name in ("expand_candidates", "expand_accepted"):
            assert out[f"counter_{name}"] == one[f"counter_{name}"], name
        # the worker runs one intra-op thread
        assert out["counter_rank_threads"] == 1


def test_the_readers_read_rank_0(jobs):
    out = jobs[2][0]
    spans = [(n, s * 1e-9, e * 1e-9) for n, s, e in _spans(out)]
    readers = harness.metric_readers()
    counters = {k[len("counter_"):]: float(v) for k, v in out.items()
                if k.startswith("counter_")}
    lo = min(s for _, s, _ in spans)
    hi = max(e for _, _, e in spans)
    # a device busy for the first half of each solve
    solves = _named(spans, "expand/solve")
    ops = [("kernel", s, (s + e) / 2) for _, s, e in solves]
    trace = device_trace.Trace(ops, spans + [(device_trace.SCENE_SPAN, lo,
                                              hi)])
    ctx = harness.ReadContext(1, {}, counters, trace, trace.window())
    share = readers["expand_accept_share"].read(ctx)
    assert share == (counters["expand_accepted"]
                     / counters["expand_candidates"])
    assert 0 < share < 1
    rounds = sum(e - s for _, s, e in _named(spans, "expand/round"))
    busy = sum(e - s for _, s, e in ops)
    assert readers["expand_host_s"].read(ctx) == pytest.approx(rounds - busy)
