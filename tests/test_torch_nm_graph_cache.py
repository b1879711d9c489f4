"""Nelder-Mead's solve graphs kept across solves (`ops.simplex._Solve`).

On the card a solve of a `StepObjective` runs on buffers at a bucket
capacity (`simplex.bucket`) and replays the graph an earlier solve of the
same scene, texture size, cap, tolerance and bucket captured. Held here:
  * `bucket`, the rule `densify_multihost` had as its own `_bucket`;
  * the cache's key and lifetime: no entry serves a solve with other
    images, cameras, texture size, cap, tolerance or block, or a larger
    batch, and a scene's entries go with its images tensor, which no entry
    holds (it holds the storage);
  * the path itself on the CPU, with the capture replaced by a stand-in
    that replays the block eagerly (`_EagerGraph`): x, f and iterations
    bitwise against the eager solve for batches in one bucket and across
    buckets, dead lanes after each solve's lanes, and the counters of a
    known sequence of solves;
  * the CPU path and any other objective callable: no entry, no capture.
The `cuda` cases (skipped without a card) hold the cached graphs bitwise
against the per-call capture and the eager witness, several batches in one
bucket and across buckets, `optimize_patches` with a tail slice, and K1's
counters at the real lanes.
"""
import functools
import gc

import numpy as np
import pytest
import torch

from densepoints_tpu_torch.config import OptimizeConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.ops import allview_ncc, simplex
from densepoints_tpu_torch.parallel import multihost
from densepoints_tpu_torch.pmvs import optimize
from densepoints_tpu_torch.pmvs.patch import PatchState
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import cuda_device  # noqa: F401 (fixture)

STEP = (0.02, 0.2, 0.2)
COUNTERS = ("nm_graph_captures", "nm_graph_reuses", "nm_graph_replays")


def _old_bucket(n, n_dev, minimum=256):
    """`densify_multihost`'s `_bucket` before it moved, verbatim."""
    target = minimum
    while target < n:
        target *= 2
    return -(-target // n_dev) * n_dev


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 6, 8])
def test_bucket_is_the_multihost_rule(n_dev):
    for n in [0, 1, 255, 256, 257, 511, 512, 513, 1000, 4095, 8192, 8193,
              100_000]:
        assert simplex.bucket(n, n_dev) == _old_bucket(n, n_dev)
    assert [simplex.bucket(n) for n in (0, 256, 257, 8192, 8193)] == [
        256, 256, 512, 8192, 16384]
    assert simplex.bucket(300, 3) == 513 and simplex.bucket(5000, 6) == 8196
    # one rule: the row-block path uses the solver's
    assert not hasattr(multihost, "_bucket")


def _plane(seed, n, device="cpu"):
    """Cameras, images and `n` patches near the plane z = 0 of a textured
    plane scene (5 views); patch 0 sees nothing."""
    rng = np.random.default_rng(seed)
    scene = TexturedPlaneScene(rng, num_views=5, width=200, height=160)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height, device=device)
    V = cams.num_views
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    z = rng.uniform(-0.03, 0.03, (n, 1))
    position = np.concatenate([xy, z], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    refs = rng.integers(0, V, (n,))
    vis = rng.uniform(size=(n, V)) > 0.25
    vis[np.arange(n), refs] = False
    vis[0] = False
    st = PatchState.create(
        torch.as_tensor(position, device=device),
        torch.as_tensor(normal, device=device),
        torch.as_tensor(refs, device=device),
        torch.as_tensor(vis, device=device))
    images = torch.as_tensor(scene.render_all(), dtype=torch.float32,
                             device=device)
    return images, cams, st


def _objective(images, cams, st, k=11):
    return optimize.photometric_objective_paged(
        images, cams, st.position, st.normal, st.ref, st.vis, k)


def _solve(f, cap=41, tol=1e-4, **kwargs):
    B, dev = f.vis.shape[0], f.vis.device
    return simplex.nelder_mead(
        f, torch.zeros((B, 3), device=dev), torch.tensor(STEP, device=dev),
        max_iterations=cap, tolerance=tol, **kwargs)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _cached(f, Bb, m, max_iterations, tolerance):
    return simplex._cached(f, Bb, m, max_iterations, tolerance)[0]


def _entries(images):
    held = simplex._SOLVES.get(id(images))
    return {} if held is None else held[1]


def test_key_takes_everything_the_graph_bakes_in():
    images, cams, st = _plane(0, 8)
    f = _objective(images, cams, st)
    solve = _cached(f, 256, 2, 41, 1e-4)
    assert _cached(f, 256, 2, 41, 1e-4) is solve
    # another objective over the same scene: the same entry
    g = _objective(images, cams, st.map(lambda a: a[:5]))
    assert _cached(g, 256, 2, 41, 1e-4) is solve
    others = [
        _cached(f, 512, 2, 41, 1e-4),  # a larger bucket
        _cached(f, 256, 1, 41, 1e-4),  # another block
        _cached(f, 256, 2, 40, 1e-4),  # another cap
        _cached(f, 256, 2, 41, 1e-5),  # another tolerance
        _cached(_objective(images, cams, st, k=16), 256, 2, 41,
                        1e-4),  # another texture size
        # the same values in other tensors: other images, other cameras
        _cached(_objective(images.clone(), cams, st), 256, 2, 41,
                        1e-4),
        _cached(_objective(images, Cameras(
            **{name: t.clone() for name, t in vars(cams).items()}), st),
            256, 2, 41, 1e-4),
    ]
    assert len({id(s) for s in [solve] + others}) == 1 + len(others)
    # all but the one of the cloned images sit under these images
    assert len(_entries(images)) == len(others)
    # every buffer at the bucket's capacity
    assert solve.state[0].shape == (256, 4, 3)
    assert solve.objective.vis.shape == (256, 5)
    assert solve.advance.x_r.shape == (256, 3)


def test_entries_go_with_their_images():
    images, cams, st = _plane(1, 8)
    f = _objective(images, cams, st)
    solve = _cached(f, 256, 2, 41, 1e-4)
    key = id(images)
    # the entry holds the images' storage and the cameras, not the tensor
    assert solve.keep[0].data_ptr() == images.data_ptr()
    assert solve.objective.score is None
    assert key in simplex._SOLVES
    del images, f, solve
    gc.collect()
    assert key not in simplex._SOLVES


class _EagerGraph:
    """Stands in for a captured graph on the CPU: a replay runs the
    captured block eagerly, with the scorer bound at the capture."""

    def __init__(self, advance, state, limits):
        self.advance, self.state, self.limits = advance, state, limits
        self.score = advance.objective.score

    def pool(self):
        return None

    def replay(self):
        self.advance.objective.score = self.score
        try:
            simplex._block(self.advance, self.state, *self.limits)
        finally:
            self.advance.objective.score = None


def _eager_capture(advance, state, m, max_iterations, tolerance,
                   pool=None):
    simplex.GRAPH_CAPTURES += 1
    return (_EagerGraph(advance, state, (m, max_iterations, tolerance)),
            advance.flag, {})


def _counters():
    return {name: simplex.counts()[name] for name in COUNTERS}


def _since(before):
    now = _counters()
    return tuple(now[name] - before[name] for name in COUNTERS)


def test_a_known_sequence_of_solves(monkeypatch):
    images, cams, st = _plane(2, 600)
    run_eager = simplex._run_eager
    # (lanes, texture size, cap): captures, reuses
    sequence = [(40, 11, 41, 1, 0), (200, 11, 41, 0, 1), (256, 11, 41, 0, 1),
                (300, 11, 41, 1, 0), (40, 16, 41, 1, 0), (40, 11, 30, 1, 0),
                (511, 11, 41, 0, 1), (12, 11, 41, 0, 1), (12, 16, 41, 0, 1)]
    for B, k, cap, captures, reuses in sequence:
        f = _objective(images, cams, st.map(lambda a: a[:B]), k)
        monkeypatch.setattr(simplex, "_run_eager", run_eager)
        want = _solve(f, cap)
        monkeypatch.setattr(simplex, "_capture", _eager_capture)
        monkeypatch.setattr(simplex, "_run_eager", simplex._run_cached)
        before = _counters()
        got = _solve(f, cap)
        _assert_same(got, want)
        n_captures, n_reuses, replays = _since(before)
        assert (n_captures, n_reuses) == (captures, reuses), (B, k, cap)
        assert replays > 0
        # after the solve: its lanes, then dead lanes
        solve = _cached(f, simplex.bucket(B), simplex._BLOCK, cap,
                                1e-4)
        o = solve.objective
        assert torch.equal(o.vis[:B], f.vis)
        assert not o.vis[B:].any() and not o.payload[B:].any()
        assert not o.n_payload[B:].any() and solve.state[2][B:].all()
        assert not solve.state[3][B:].any()
    assert len(_entries(images)) == 4


def test_optimize_patches_with_a_tail_slice(monkeypatch):
    images, cams, st = _plane(3, 700)
    cfg = OptimizeConfig(max_iterations=30, depth_sweep_steps=9,
                         max_refine_batch=300)
    want = optimize.optimize_patches(images, cams, st, 11, cfg)
    monkeypatch.setattr(simplex, "_capture", _eager_capture)
    monkeypatch.setattr(simplex, "_run_eager", simplex._run_cached)
    before = _counters()
    got = optimize.optimize_patches(images, cams, st, 11, cfg)
    assert torch.equal(got.position, want.position)
    assert torch.equal(got.normal, want.normal)
    assert not torch.equal(got.position, st.position)
    # slices of 300, 300 and 100 lanes: the buckets of 512 and 256
    assert _since(before)[:2] == (2, 1)


def test_the_cpu_path_and_other_callables_keep_no_graph():
    images, cams, st = _plane(4, 30)
    f = _objective(images, cams, st)
    before = _counters()
    _solve(f)
    simplex.nelder_mead(lambda p: f(p), torch.zeros((30, 3)),
                        torch.tensor(STEP), 41, 1e-4)
    assert _since(before) == (0, 0, 0)
    assert id(images) not in simplex._SOLVES


@pytest.mark.cuda
def test_cached_graphs_are_bitwise_on_card(cuda_device, monkeypatch):
    images, cams, st = _plane(5, 1100, cuda_device)
    # three batches in the bucket of 256, two in 512, one in 2048, then
    # each bucket met again
    sizes = [64, 200, 256, 300, 512, 1100, 64, 511, 1100]
    seen = set()
    for B in sizes:
        f = _objective(images, cams, st.map(lambda a: a[:B]))
        eager = _solve(f, _eager=True)
        with monkeypatch.context() as m:
            m.setattr(simplex, "_run_cached", simplex._run_graph)
            before = _counters()
            per_call = _solve(f)
            assert _since(before)[:2] == (1, 0)
        before = _counters()
        got = _solve(f)
        torch.cuda.synchronize()
        _assert_same(got, eager)
        _assert_same(got, per_call)
        Bb = simplex.bucket(B)
        assert _since(before)[:2] == ((0, 1) if Bb in seen else (1, 0))
        seen.add(Bb)
    assert seen == {256, 512, 2048}
    # the scene's graphs share one memory pool
    graphs = [s.graph for s in _entries(images).values()]
    assert len(graphs) == 3 and len({g.pool() for g in graphs}) == 1


@pytest.mark.cuda
def test_optimize_patches_tail_slice_on_card(cuda_device, monkeypatch):
    images, cams, st = _plane(6, 700, cuda_device)
    cfg = OptimizeConfig(max_iterations=30, depth_sweep_steps=9,
                         max_refine_batch=300)
    monkeypatch.setattr(optimize, "nelder_mead", functools.partial(
        simplex.nelder_mead, _eager=True))
    want = optimize.optimize_patches(images, cams, st, 11, cfg)
    monkeypatch.undo()
    before = _counters()
    got = optimize.optimize_patches(images, cams, st, 11, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got.position, want.position)
    assert torch.equal(got.normal, want.normal)
    assert _since(before)[:2] == (2, 1)


@pytest.mark.cuda
def test_k1_counts_the_real_lanes_on_card(cuda_device):
    images, cams, st = _plane(7, 300, cuda_device)
    f = _objective(images, cams, st)

    def work(**kwargs):
        before = allview_ncc.counts()
        launches = allview_ncc.KERNEL_LAUNCHES
        _solve(f, **kwargs)
        torch.cuda.synchronize()
        after = allview_ncc.counts()
        pairs = sum(int(after["pairs"][key] - before["pairs"].get(key, 0))
                    for key in after["pairs"])
        return (after["k1_rows"] - before["k1_rows"],
                after["k1_bytes"] - before["k1_bytes"], pairs,
                allview_ncc.KERNEL_LAUNCHES - launches)

    eager = work(_eager=True)
    first, again = work(), work()  # a capture, then a reuse (bucket 512)
    assert first == eager and again == eager
    rows, _, _, launches = eager
    # the objective's first call scores 4 points a lane, then 2 a step
    assert rows == 300 * (4 + launches - 1)
