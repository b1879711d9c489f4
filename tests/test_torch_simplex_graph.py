"""Nelder-Mead as blocks of steps, against the per-iteration loop.

`ops.simplex.nelder_mead` runs a pure step in blocks of m steps and reads
the exit once per block; on a CUDA device it replays one captured block as
a CUDA graph. `_per_iteration_nelder_mead` below is the per-iteration
host loop the port ran before (a verbatim copy, the witness). Steps past
convergence or past the cap freeze every lane, so every comparison here
is bitwise (`torch.equal`), at every block size, on:
  * a quadratic batch whose lanes converge at many different steps and
    some of which hit a cap that is no multiple of m; B = 0 and B = 1;
  * `optimize_patches_once` on a synthetic plane scene (the all-views
    objective), with and without the depth sweep;
and the launch counts: at m = 1 the objective runs exactly as often as
in the witness, at m > 1 at most 2 (m - 1) more times per call.
JAX parity: the quadratic's minimum within 1e-5 of the JAX package's
`nelder_mead` at every m (the tolerance of `test_torch_optimize.py`).
The `cuda` cases (skipped without a card) hold the graph against the
eager witness on the card bitwise, and a capture that meets a host read
raises.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.ops.simplex import nelder_mead as jax_nelder_mead
from densepoints_tpu.pmvs import PatchState as JaxPatchState
from densepoints_tpu_torch.config import OptimizeConfig
from densepoints_tpu_torch.ops import _build, allview_ncc, simplex
from densepoints_tpu_torch.pmvs import optimize
from densepoints_tpu_torch.utils import StageMetrics
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import cuda_device, torch_cameras, torch_state

BLOCKS = (1, 2, 3, 5, 8)


def _per_iteration_nelder_mead(f, x0, init_step, max_iterations=500,
                               tolerance=1e-4):
    """The port's loop before blocks (no mesh): the exit read every
    iteration."""
    B, D = x0.shape
    offsets = torch.cat(
        [x0.new_zeros((1, D)), torch.diag(init_step.to(x0))], dim=0
    )  # (D+1, D)
    verts = x0[:, None, :] + offsets[None, :, :]  # (B, D+1, D)
    fvals = f(verts)  # (B, D+1)
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    iters = torch.zeros(B, dtype=torch.int32, device=x0.device)

    for _ in range(max_iterations):
        if bool(done.all()):
            break
        order = torch.argsort(fvals, dim=1, stable=True)
        verts = torch.take_along_dim(verts, order[:, :, None], dim=1)
        fvals = torch.take_along_dim(fvals, order, dim=1)
        best, second_worst, worst = fvals[:, 0], fvals[:, -2], fvals[:, -1]
        x_worst = verts[:, -1, :]
        centroid = verts[:, :-1, :].mean(dim=1)

        x_r = centroid + 1.0 * (centroid - x_worst)
        f_r = f(x_r[:, None, :])[:, 0]

        expand = f_r < best
        outside = f_r < worst
        x_e = centroid + 2.0 * (centroid - x_worst)
        x_oc = centroid + 0.5 * (x_r - centroid)
        x_ic = centroid - 0.5 * (centroid - x_worst)
        x_2 = torch.where(
            expand[:, None], x_e, torch.where(outside[:, None], x_oc, x_ic)
        )
        f_2 = f(x_2[:, None, :])[:, 0]

        # Accept rules (no shrink; contraction always replaces the worst).
        use_2 = torch.where(
            expand, f_2 < f_r, (f_r >= second_worst) & (f_2 < f_r)
        )
        x_new = torch.where(use_2[:, None], x_2, x_r)
        f_new = torch.where(use_2, f_2, f_r)
        improved = f_new < worst
        x_acc = torch.where(improved[:, None], x_new, x_worst)
        f_acc = torch.where(improved, f_new, worst)

        active = ~done
        verts[:, -1, :] = torch.where(active[:, None], x_acc, x_worst)
        fvals[:, -1] = torch.where(active, f_acc, worst)

        spread = fvals.max(dim=1).values - fvals.min(dim=1).values
        done = done | (spread < tolerance)
        iters = iters + active.to(torch.int32)

    ib = torch.argmin(fvals, dim=1)
    x_best = torch.take_along_dim(verts, ib[:, None, None], dim=1)[:, 0, :]
    f_best = torch.take_along_dim(fvals, ib[:, None], dim=1)[:, 0]
    return x_best, f_best, iters


def _quadratic(B, seed=0):
    """Lanes of scaled quadratics, scales 1e-3 ... 1e4: the small ones
    converge in a few steps, the large ones run long or hit the cap."""
    rng = np.random.default_rng(seed)
    targets = torch.as_tensor(rng.standard_normal((B, 3)).astype(np.float32))
    scales = torch.as_tensor(
        np.logspace(-3, 4, B).astype(np.float32)[rng.permutation(B)]
    )
    calls = [0]

    def f(x):
        calls[0] += 1
        return (scales[:, None] * ((x - targets[:, None, :]) ** 2).sum(-1))

    x0 = torch.zeros((B, 3))
    return f, x0, calls


STEP = torch.tensor([0.5, 0.5, 0.5])


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("max_iterations", [37, 500])
@pytest.mark.parametrize("m", BLOCKS)
def test_blocks_match_the_per_iteration_loop(m, max_iterations):
    f, x0, calls = _quadratic(24)
    want = _per_iteration_nelder_mead(f, x0, STEP, max_iterations, 1e-4)
    witness_calls = calls[0]
    calls[0] = 0
    got = simplex.nelder_mead(f, x0, STEP, max_iterations, 1e-4,
                              _block_steps=m)
    _assert_same(got, want)
    iters = want[2]
    # Lanes stop at many different steps; at the cap of 37 some run out.
    assert len(torch.unique(iters)) >= 5
    assert (int(iters.max()) == max_iterations) == (max_iterations == 37)
    # The objective: as often as the witness at m = 1, at most
    # 2 (m - 1) more times otherwise (frozen lanes only).
    assert witness_calls <= calls[0] <= witness_calls + 2 * (m - 1)
    if m == 1:
        assert calls[0] == witness_calls


@pytest.mark.parametrize("B", [0, 1])
@pytest.mark.parametrize("m", BLOCKS)
def test_tiny_batches(m, B):
    f, x0, _ = _quadratic(max(B, 1))
    x0 = x0[:B]
    want = _per_iteration_nelder_mead(f, x0, STEP, 41, 1e-7)
    steps = simplex.STEPS
    got = simplex.nelder_mead(f, x0, STEP, 41, 1e-7, _block_steps=m)
    _assert_same(got, want)
    if B == 0:
        assert simplex.STEPS == steps  # returns before any step


@pytest.mark.parametrize("m", BLOCKS)
def test_jax_parity_at_every_block_size(m):
    rng = np.random.default_rng(0)
    targets = rng.standard_normal((32, 3)).astype(np.float32)
    step = np.array([0.5, 0.5, 0.5], np.float32)
    jt = jnp.asarray(targets)
    xj, _, _ = jax_nelder_mead(
        lambda x: jnp.sum((x - jt[:, None, :]) ** 2, axis=-1),
        jnp.zeros((32, 3), jnp.float32), jnp.asarray(step),
        max_iterations=500, tolerance=1e-12,
    )
    tt = torch.as_tensor(targets)
    xt, _, _ = simplex.nelder_mead(
        lambda x: ((x - tt[:, None, :]) ** 2).sum(-1),
        torch.zeros((32, 3)), torch.as_tensor(step),
        max_iterations=500, tolerance=1e-12, _block_steps=m,
    )
    np.testing.assert_allclose(xt.numpy(), targets, atol=1e-5)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)


def _plane(rng, n=16, device="cpu"):
    scene = TexturedPlaneScene(rng, num_views=5, width=200, height=160)
    cams = JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    V = cams.num_views
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    z = rng.uniform(-0.03, 0.03, (n, 1))
    position = np.concatenate([xy, z], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    refs = rng.integers(0, V, (n,)).astype(np.int32)
    vis = rng.uniform(size=(n, V)) > 0.25
    vis[np.arange(n), refs] = False
    vis[0] = False
    st = JaxPatchState.create(position, normal, refs, vis)
    return (torch.as_tensor(scene.render_all(), device=device),
            torch_cameras(cams, device), torch_state(st, device))


def _refine(images, cams, st, cfg, solver, monkeypatch):
    monkeypatch.setattr(optimize, "nelder_mead", solver)
    return optimize.optimize_patches_once(images, cams, st, 11, cfg)


@pytest.mark.parametrize("sweep", [0, 9])
@pytest.mark.parametrize("m", BLOCKS)
def test_optimize_patches_once_matches_the_witness(rng, monkeypatch, m,
                                                   sweep):
    images, cams, st = _plane(rng)
    cfg = OptimizeConfig(max_iterations=30, depth_sweep_steps=sweep)

    def witness(f, x0, init_step, max_iterations, tolerance, mesh=None):
        return _per_iteration_nelder_mead(f, x0, init_step, max_iterations,
                                 tolerance)

    plain = allview_ncc.PLAIN_CALLS
    want = _refine(images, cams, st, cfg, witness, monkeypatch)
    witness_calls = allview_ncc.PLAIN_CALLS - plain
    plain = allview_ncc.PLAIN_CALLS
    got = _refine(images, cams, st, cfg, functools.partial(
        simplex.nelder_mead, _block_steps=m), monkeypatch)
    calls = allview_ncc.PLAIN_CALLS - plain
    assert torch.equal(got.position, want.position)
    assert torch.equal(got.normal, want.normal)
    assert not torch.equal(got.position, st.position)  # the solver moved
    assert witness_calls <= calls <= witness_calls + 2 * (m - 1)
    if m == 1:
        assert calls == witness_calls


def test_counters_reach_stage_metrics():
    f, x0, _ = _quadratic(8)
    metrics = StageMetrics()
    before = simplex.counts()
    simplex.nelder_mead(f, x0, STEP, 37, 1e-7, _block_steps=5)
    simplex.count_since(metrics, before)
    steps = metrics.counters["nm_steps"]
    assert steps % 5 == 0 and 0 < steps < 37 + 5
    # The eager blocks on the CPU capture and replay nothing.
    assert metrics.counters["nm_graph_captures"] == 0
    assert metrics.counters["nm_graph_replays"] == 0


def test_launches_under_capture_count_at_replay(monkeypatch):
    """A launch made while a graph is captured is recorded, not counted;
    each replay counts what was recorded."""
    module = allview_ncc.__name__
    launches = allview_ncc.KERNEL_LAUNCHES
    _build.take_recorded()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    _build.count_launch(module)
    _build.count_launch(module)
    assert allview_ncc.KERNEL_LAUNCHES == launches
    recorded = _build.take_recorded()
    assert recorded == {module: 2} and _build.take_recorded() == {}
    for _ in range(3):
        _build.count_replay(recorded)
    assert allview_ncc.KERNEL_LAUNCHES == launches + 6
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    _build.count_launch(module)
    assert allview_ncc.KERNEL_LAUNCHES == launches + 7
    allview_ncc.KERNEL_LAUNCHES = launches


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
def test_graph_matches_the_eager_witness_on_card(rng, cuda_device, m):
    images, cams, st = _plane(rng, n=64, device=cuda_device)
    f = optimize.photometric_objective_paged(
        images, cams, st.position, st.normal, st.ref, st.vis, 11)
    x0 = torch.zeros((64, 3), device=cuda_device)
    step = torch.tensor([0.02, 0.2, 0.2], device=cuda_device)
    launches = allview_ncc.KERNEL_LAUNCHES
    want = simplex.nelder_mead(f, x0, step, 41, 1e-4, _eager=True,
                               _block_steps=m)
    eager_launches = allview_ncc.KERNEL_LAUNCHES - launches
    captures, replays = simplex.GRAPH_CAPTURES, simplex.GRAPH_REPLAYS
    launches = allview_ncc.KERNEL_LAUNCHES
    got = simplex.nelder_mead(f, x0, step, 41, 1e-4, _block_steps=m)
    torch.cuda.synchronize()
    _assert_same(got, want)
    assert simplex.GRAPH_CAPTURES == captures + 1
    assert simplex.GRAPH_REPLAYS > replays
    # The device ran the same steps: the launches counted agree.
    assert allview_ncc.KERNEL_LAUNCHES - launches == eager_launches


@pytest.mark.cuda
def test_capture_meeting_a_host_read_raises(cuda_device):
    target = torch.ones((4, 3), device=cuda_device)

    def f(x):
        value = ((x - target[:, None, :]) ** 2).sum(-1)
        if float(value.max()) < 0:  # a host read: no capture takes it
            raise AssertionError
        return value

    captures, steps = simplex.GRAPH_CAPTURES, simplex.STEPS
    with pytest.raises(RuntimeError, match="CUDA graph"):
        simplex.nelder_mead(f, torch.zeros((4, 3), device=cuda_device),
                            torch.full((3,), 0.5, device=cuda_device),
                            200, 1e-9)
    # No capture counted and no eager retry after the first block.
    assert simplex.GRAPH_CAPTURES == captures
    assert simplex.STEPS == steps + simplex._BLOCK
