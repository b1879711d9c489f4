"""The port's own profiler spans and work counters, on `densify` of a tiny
sphere on the CPU.

  * every span of the program, named `layer/part`, nested as the layers
    are: `seed/*` inside `stage/seed`, `nm/solve` inside
    `stage/seed_optimize` and inside `expand/solve`, the parts of a round
    inside `expand/round`, inside `stage/expand` (`nm/capture` needs a
    CUDA graph: the `cuda` case);
  * K1's work counters (`k1_rows`, `k1_textures`, `k1_texels`,
    `k1_bytes`) equal a tally made by wrapping the plain scorer, and stay
    true under a graph's replays;
  * expansion's counters equal the rounds' log lines;
  * the seed tracks' counters (`seed_track_nodes`, `seed_track_rounds`)
    are in `densify`'s metrics;
  * the cloud is bitwise the same with and without a profiler recording;
  * on a card (`cuda`), one `optimize_patches` call counts the same K1
    work through its CUDA graph as with `nelder_mead(_eager=True)`.
"""
import logging
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from densepoints_tpu_torch.config import OptimizeConfig, load_config
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.ops import _build, allview_ncc, simplex
from densepoints_tpu_torch.pmvs import optimize
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.pipeline import densify
from densepoints_tpu_torch.utils import StageMetrics
from tests.synthetic import TexturedPlaneScene, TexturedSphereScene

SEED_PARTS = ("detect", "describe", "pairs", "match", "tracks",
              "triangulate")
ROUND_PARTS = ("candidates", "solve", "rescore", "insert")
CONFIG = {"matching": {"max_keypoints_per_view": 512},
          "optimize": {"max_iterations": 30},
          "expand": {"max_rounds": 2, "max_iterations": 20},
          "organizer": {"grid_scale": 4}}
ROUND_LINE = re.compile(r"expansion round \d+: frontier=\d+ "
                        r"candidates=(\d+) accepted=(\d+)")


def _scene():
    sc = TexturedSphereScene(np.random.default_rng(0), num_views=8,
                             width=200, height=150, focal=170.0, radius=1.0,
                             cam_radius=4.0, tex_size=512)
    cams = Cameras.from_projection_matrices(sc.P, widths=sc.width,
                                            heights=sc.height)
    return Scene(cameras=cams, images=sc.render_all(), colors=None)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _tally(real, tally):
    """`allview_scores_plain` that adds each call's work to `tally`."""
    def plain(images, cameras, position, normal, ref, vis, texture_size,
              frames=None):
        B, V = vis.shape
        pairs = int(vis.sum())
        tally["k1_rows"] += B
        tally["k1_textures"] += pairs
        tally["k1_texels"] += pairs * texture_size ** 2
        # position, normal 12 B a row each, ref 8, vis V, scores 4V,
        # anchor 8, anchor_ok 1
        tally["k1_bytes"] += B * (12 + 12 + 8 + V + 4 * V + 8 + 1)
        return real(images, cameras, position, normal, ref, vis,
                    texture_size, frames)

    return plain


@pytest.fixture(scope="module")
def runs():
    """`densify` twice on one scene: under `torch.profiler` (the plain
    scorer wrapped, the log read), then without either."""
    scene, config = _scene(), load_config(CONFIG)
    tally = dict.fromkeys(("k1_rows", "k1_textures", "k1_texels",
                           "k1_bytes"), 0)
    lines = _Lines()
    logger = logging.getLogger("densepoints_tpu_torch")
    logger.addHandler(lines)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(allview_ncc, "allview_scores_plain",
                       _tally(allview_ncc.allview_scores_plain, tally))
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                traced = densify(scene, config, device="cpu")
    finally:
        logger.removeHandler(lines)
    spans = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in prof.profiler.kineto_results.events()
             if re.match(r"(stage|seed|nm|expand)/", ev.name())]
    plain = densify(scene, config, device="cpu")
    return {"traced": traced, "plain": plain, "spans": spans,
            "tally": tally, "lines": lines.lines}


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def test_every_span_is_emitted(runs):
    names = {s[0] for s in runs["spans"]}
    want = ({f"seed/{p}" for p in SEED_PARTS}
            | {f"expand/{p}" for p in ROUND_PARTS}
            | {"expand/round", "expand/insert_seeds", "nm/solve"}
            | {f"stage/{s}" for s in ("seed", "seed_patches", "seed_filter",
                                      "seed_optimize", "expand", "filter",
                                      "color")})
    assert want <= names
    # the CPU runs its blocks eagerly: no graph is captured
    assert "nm/capture" not in names
    rounds = [line for line in runs["lines"] if ROUND_LINE.search(line)]
    assert len(_named(runs["spans"], "expand/round")) == len(rounds) == 2


@pytest.mark.parametrize("child, parents", [
    *((f"seed/{p}", ("stage/seed",)) for p in SEED_PARTS),
    ("nm/solve", ("stage/seed_optimize", "expand/solve")),
    ("expand/round", ("stage/expand",)),
    ("expand/insert_seeds", ("stage/expand",)),
    *((f"expand/{p}", ("expand/round",)) for p in ROUND_PARTS),
])
def test_spans_nest_as_the_layers(runs, child, parents):
    spans = runs["spans"]
    outer = [s for name in parents for s in _named(spans, name)]
    children = _named(spans, child)
    assert children and all(_inside(c, outer) for c in children)
    # each parent of a solve holds one
    if child == "nm/solve":
        for name in parents:
            assert all(_inside_any(p, children) for p in _named(spans, name))


def _inside_any(parent, children):
    return any(parent[1] <= c[1] and c[2] <= parent[2] for c in children)


def test_k1_counters_equal_an_independent_tally(runs):
    counters = runs["traced"].metrics.counters
    tally = runs["tally"]
    assert tally["k1_rows"] > 0 and tally["k1_textures"] > 0
    for name, value in tally.items():
        assert counters[name] == value, name
    # the seeds score textures of 16, expansion of 11
    assert 11 ** 2 * tally["k1_textures"] < tally["k1_texels"] \
        < 16 ** 2 * tally["k1_textures"]


def test_expansion_counters_equal_the_rounds(runs):
    counters = runs["traced"].metrics.counters
    rounds = [ROUND_LINE.search(line) for line in runs["lines"]]
    rounds = [(int(m[1]), int(m[2])) for m in rounds if m]
    assert counters["expand_candidates"] == sum(c for c, _ in rounds) > 0
    assert counters["expand_accepted"] == sum(a for _, a in rounds) > 0


def test_track_counters_are_in_the_metrics(runs):
    counters = runs["traced"].metrics.counters
    tracks_line = next(line for line in runs["lines"]
                       if line.startswith("tracks: "))
    assert int(tracks_line.split()[1]) > 0
    # every track holds >= 2 matched nodes; labels need >= 1 round
    assert counters["seed_track_nodes"] >= 2 * int(tracks_line.split()[1])
    assert counters["seed_track_rounds"] >= 1


def test_cloud_is_the_same_with_and_without_the_profiler(runs):
    a, b = runs["traced"].patches, runs["plain"].patches
    assert a.capacity == b.capacity > 0
    for field in ("position", "normal", "ref", "vis", "cand", "alive"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    # and the counters, a run apart
    for name, value in runs["plain"].metrics.counters.items():
        assert runs["traced"].metrics.counters[name] == value, name


def test_counts_since_leave_out_earlier_work():
    images = torch.rand(3, 40, 50)
    cams = Cameras.from_projection_matrices(
        TexturedPlaneScene(np.random.default_rng(1), num_views=3, width=50,
                           height=40).P, widths=50, heights=40)
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0]])
    nrm = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    ref = torch.tensor([0, 1])
    vis = torch.tensor([[True, True, False], [True, True, True]])
    allview_ncc.allview_scores(images, cams, pos, nrm, ref, vis, 5)
    before = allview_ncc.counts()
    score = allview_ncc.allview_scorer(images, cams, 3)
    for _ in range(3):
        score(pos, nrm, ref, vis)
    metrics = StageMetrics()
    allview_ncc.count_since(metrics, before)
    assert metrics.counters == {"k1_rows": 6, "k1_textures": 15,
                                "k1_texels": 15 * 9,
                                "k1_bytes": 3 * 2 * (41 + 5 * 3)}


def test_a_vis_is_summed_once_at_a_fold():
    """A call runs no op for K1's work: the calls are counted on the host,
    and the first fold sums the `vis`, once for every scorer that scored
    it; its entry goes with it."""
    images = torch.rand(3, 40, 50)
    cams = Cameras.from_projection_matrices(
        TexturedPlaneScene(np.random.default_rng(2), num_views=3, width=50,
                           height=40).P, widths=50, heights=40)
    pos, nrm = torch.zeros(4, 3), torch.tensor([[0.0, 0.0, 1.0]] * 4)
    ref, vis = torch.zeros(4, dtype=torch.int64), torch.ones(4, 3, dtype=bool)
    for _ in range(2):  # two scorers, as two calls of `allview_scores`
        allview_ncc.allview_scorer(images, cams, 5)(pos, nrm, ref, vis)
        allview_ncc.allview_scores(images, cams, pos, nrm, ref, vis, 5)
    pairs = allview_ncc._PAIRS[id(vis), 5]
    assert pairs.calls == 4 and pairs.count is None
    allview_ncc.fold()
    assert pairs.calls == 0 and int(pairs.count) == 12
    key = (id(vis), 5)
    del vis
    assert key not in allview_ncc._PAIRS


def test_pairs_count_at_each_replay(monkeypatch):
    """A scorer's call made while a graph is captured is recorded, not
    counted; each replay counts it, and the fold multiplies the visible
    pairs by the calls."""
    vis = torch.tensor([[True, False, True], [True, True, True]])
    pairs = allview_ncc._Pairs(vis, 11)
    before = allview_ncc.counts()
    _build.take_recorded()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    _build.count_launch(pairs)
    _build.count_launch(f"{allview_ncc.__name__}:ROWS", 2)
    recorded = _build.take_recorded()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    assert pairs.calls == 0
    for _ in range(4):
        _build.count_replay(recorded)
    assert pairs.calls == 4
    metrics = StageMetrics()
    allview_ncc.count_since(metrics, before)
    assert metrics.counters["k1_textures"] == 4 * 5
    assert metrics.counters["k1_texels"] == 4 * 5 * 121
    assert metrics.counters["k1_rows"] == 4 * 2


@pytest.mark.cuda
def test_graph_counts_the_work_of_the_eager_witness_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    sc = TexturedPlaneScene(rng, num_views=5, width=200, height=160)
    cams = Cameras.from_projection_matrices(sc.P, widths=sc.width,
                                            heights=sc.height, device=dev)
    images = torch.as_tensor(sc.render_all(), dtype=torch.float32,
                             device=dev)
    n = 256
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    position = np.concatenate([xy, rng.uniform(-0.03, 0.03, (n, 1))], 1)
    vis = rng.uniform(size=(n, 5)) > 0.25
    state = PatchState.create(
        torch.as_tensor(position, dtype=torch.float32, device=dev),
        torch.tensor([[0.0, 0.0, 1.0]] * n, device=dev),
        torch.as_tensor(rng.integers(0, 5, n), device=dev),
        torch.as_tensor(vis, device=dev))
    config = OptimizeConfig(max_iterations=41)

    def solve(eager):
        real = optimize.nelder_mead

        def nelder_mead(*args, **kw):
            return real(*args, _eager=eager, **kw)

        before = allview_ncc.counts()
        captures, launches = simplex.GRAPH_CAPTURES, allview_ncc.KERNEL_LAUNCHES
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(optimize, "nelder_mead", nelder_mead)
            optimize.optimize_patches(images, cams, state, 11, config)
        torch.cuda.synchronize()
        metrics = StageMetrics()
        allview_ncc.count_since(metrics, before)
        return (metrics.counters, simplex.GRAPH_CAPTURES - captures,
                allview_ncc.KERNEL_LAUNCHES - launches)

    eager, eager_captures, eager_launches = solve(True)
    graph, graph_captures, graph_launches = solve(False)
    assert eager_captures == 0 and graph_captures == 1
    assert graph_launches == eager_launches > 0
    assert graph == eager
    assert eager["k1_rows"] > n and eager["k1_textures"] > 0
