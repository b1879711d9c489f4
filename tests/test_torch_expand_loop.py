"""The port's one wavefront loop (`pmvs/expand.py::wavefront`) against the
ops an entry point hands it.

  * with fake ops that record their calls: each stop rule (`max_rounds`,
    `max_patches`, an empty frontier, a round that accepts nothing, no
    candidate left, no seed inserted); the `first_id` of each `insert` is
    the running total; `expand_candidates` and `expand_accepted` are the
    sums of the rounds' log lines; the spans nest as the rounds run;
  * `densify_distributed` on one CPU rank, on the plane scene of
    `test_torch_local_job.py`, opens expansion's spans and reports its
    counters.
"""
import dataclasses
import logging
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from densepoints_tpu_torch.config import ExpandConfig, PipelineConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.parallel import mesh as pmesh
from densepoints_tpu_torch.parallel.pipeline import densify_distributed
from densepoints_tpu_torch.pmvs import expand
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.utils import StageMetrics
from tests.synthetic import TexturedPlaneScene

ROUND_LINE = re.compile(r"expansion round (\d+): frontier=(\d+) "
                        r"candidates=(\d+) accepted=(\d+) total=(\d+)")
ROUND_PARTS = ("candidates", "solve", "insert")


class _FakeOps:
    """Ops that record the loop's calls. `accept[i]` is how many rows the
    i-th `insert` accepts (the first ones; all once the list is spent);
    refined candidates keep `visible` visible views; `screen` empties the
    candidates (a pre-screen that drops them all)."""

    def __init__(self, accept, visible=3, screen=False):
        self.accept, self.visible, self.screen = list(accept), visible, screen
        self.calls = []

    def compact(self, state, keep):
        state = state.masked(keep).compact()
        self.calls.append(("compact", state.capacity))
        return state, state.capacity

    def candidates(self, grids, frontier, n):
        self.calls.append(("candidates", n))
        cand = frontier.map(lambda a: torch.cat([a] * 4))
        if self.screen:
            return cand.masked(torch.zeros_like(cand.alive)).compact(), 0
        return cand, 4 * n

    def refine(self, cand):
        self.calls.append(("refine", cand.capacity))
        vis = torch.zeros_like(cand.vis)
        vis[:, :self.visible] = True
        return dataclasses.replace(cand, vis=vis)

    def insert(self, grids, state, first_id):
        k = self.accept.pop(0) if self.accept else state.capacity
        self.calls.append(("insert", first_id, k))
        return torch.arange(state.capacity) < k, grids + 1


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _traced(fn):
    """(fn's result, its `expand/*` spans, its log lines, the expansion
    counters it added)."""
    lines = _Lines()
    logger = logging.getLogger("densepoints_tpu_torch")
    logger.addHandler(lines)
    before = expand.counts()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        logger.removeHandler(lines)
    metrics = StageMetrics()
    expand.count_since(metrics, before)
    spans = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                    ev.name())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith("expand/"))
    rounds = [tuple(int(g) for g in m.groups())
              for m in map(ROUND_LINE.search, lines.lines) if m]
    return out, spans, rounds, metrics.counters


def _named(spans, name):
    return [s for s in spans if s[2] == name]


def _inside(child, parents):
    return any(p[0] <= child[0] and child[1] <= p[1] for p in parents)


def _seeds(n=3, views=3):
    return PatchState.create(torch.rand(n, 3), torch.rand(n, 3),
                             torch.zeros(n, dtype=torch.int64),
                             torch.ones(n, views, dtype=torch.bool))


# (ops, config, rounds logged, rounds begun, patches out)
CASES = {
    "max_rounds": (dict(accept=[3, 5, 5, 5, 5]),
                   ExpandConfig(max_rounds=3), 3, 3, 18),
    "max_patches": (dict(accept=[3, 5, 5, 5, 5]),
                    ExpandConfig(max_rounds=10, max_patches=10), 2, 2, 13),
    "empty_frontier": (dict(accept=[3, 5], visible=1),
                       ExpandConfig(max_rounds=10), 1, 2, 8),
    "nothing_accepted": (dict(accept=[3, 2, 0]),
                         ExpandConfig(max_rounds=10), 2, 2, 5),
    "no_candidates": (dict(accept=[3], screen=True),
                      ExpandConfig(max_rounds=10), 0, 1, 3),
    "no_seed_inserted": (dict(accept=[0]), ExpandConfig(max_rounds=10),
                         0, 0, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wavefront_stops_ids_counters_and_spans(case):
    kw, config, n_logged, n_begun, n_out = CASES[case]
    ops = _FakeOps(**kw)
    (state, grids, total), spans, rounds, counters = _traced(
        lambda: expand.wavefront(ops, _seeds(), torch.tensor(0), config))

    # the stop rule: rounds logged, rounds begun, patches out
    assert len(rounds) == n_logged
    assert len(_named(spans, "expand/round")) == n_begun
    assert total == state.capacity == n_out
    inserts = [c for c in ops.calls if c[0] == "insert"]
    assert int(grids) == len(inserts) == 1 + n_logged

    # each insert's ids start at the running total
    running = 0
    for _, first_id, k in inserts:
        assert first_id == running
        running += k
    assert [r[4] for r in rounds] == list(np.cumsum(
        [k for _, _, k in inserts])[1:])

    # the counters are the rounds' sums
    assert counters["expand_candidates"] == sum(r[2] for r in rounds)
    assert counters["expand_accepted"] == sum(r[3] for r in rounds)
    assert [r[2] for r in rounds] == [4 * r[1] for r in rounds]

    # the span tree: seeds once, outside the rounds; a round's parts inside
    # it, in order; a round that finds no frontier or no candidate stops
    # inside `expand/candidates`
    seeds_span = _named(spans, "expand/insert_seeds")
    round_spans = _named(spans, "expand/round")
    assert len(seeds_span) == 1
    assert not _inside(seeds_span[0], round_spans)
    assert len(_named(spans, "expand/candidates")) == n_begun
    for part in ("solve", "insert"):
        assert len(_named(spans, f"expand/{part}")) == n_logged
    for r in round_spans:
        parts = [s for s in spans if s is not r and _inside(s, [r])]
        names = [s[2] for s in parts]
        assert names in (["expand/candidates"],
                         [f"expand/{p}" for p in ROUND_PARTS])


def _plane():
    """`test_torch_local_job.py`'s plane: 5 views of 160 x 120."""
    rng = np.random.default_rng(0)
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    cams = Cameras.from_projection_matrices(sc.P, widths=sc.width,
                                            heights=sc.height)
    return Scene(cameras=cams, images=sc.render_all(), colors=None)


def test_densify_distributed_reports_expansion():
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        optimize=dataclasses.replace(cfg.optimize, max_iterations=40),
        expand=dataclasses.replace(cfg.expand, max_rounds=2),
        matching=dataclasses.replace(cfg.matching,
                                     max_keypoints_per_view=384))
    res, spans, rounds, counters = _traced(
        lambda: densify_distributed(_plane(), cfg,
                                    mesh=pmesh.global_mesh("cpu")))
    assert len(rounds) == len(_named(spans, "expand/round")) == 2
    assert len(_named(spans, "expand/insert_seeds")) == 1
    for part in ROUND_PARTS:
        assert all(_inside(s, _named(spans, "expand/round"))
                   for s in _named(spans, f"expand/{part}"))
        assert len(_named(spans, f"expand/{part}")) == 2
    got = res.metrics.counters
    assert got["expand_candidates"] == counters["expand_candidates"] \
        == sum(r[2] for r in rounds) > got["expand_accepted"] > 0
    assert got["expand_accepted"] == sum(r[3] for r in rounds)
    assert got["patches_after_expand"] == rounds[-1][4]
