"""The Nelder-Mead step of the photometric objective as kernels
(`ops.nm_step`), against today's torch step and the JAX package.

On the CPU the kernel step (`KernelStep`) runs the three kernels' plain
twins around the plain scorer; they are `ops.simplex._step`'s ops and the
objective's, part by part in the same order, so every CPU comparison with
`_step` is bitwise (`torch.equal`):
  * one step at a time from a state whose lanes take every branch
    (expansion, outside and inside contraction, the middle case, no
    improvement), with ties among the f-values, a frozen lane, a lane whose
    payload is empty, and steps past the cap; B = 0, 1 and 37;
  * `optimize_patches_once`, the kernel step against the same objective
    handed to the solver as a plain callable (which takes `_step`).
JAX parity: `optimize_patches` after 1, 2, 3 and 5 iterations against the
JAX package's, at `test_torch_optimize.py`'s tolerance for
`test_optimize_patches_matches` (positions 1e-3, normals 0.05).
The `cuda` cases (skipped without a card): each kernel against its plain
twin on the same inputs (sorts, branch picks, `done`, `iters`, the step and
the flag exactly; f32 values within 1e-6, relative above magnitude 1, and a
branch test within 1e-6 of its threshold allowed to differ), five launches
a step, the captured graph against the eager kernel step bitwise at m = 1
and 4, and a refused launch raising.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.pmvs import PatchState as JaxPatchState
from densepoints_tpu.pmvs.optimize import optimize_patches as jax_optimize
from densepoints_tpu_torch.config import OptimizeConfig
from densepoints_tpu_torch.interop import patch_state_to_numpy
from densepoints_tpu_torch.ops import _build, allview_ncc, nm_step, simplex
from densepoints_tpu_torch.pmvs import optimize
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import cuda_device, torch_cameras, torch_state

TOL = 1e-4  # the solver's default tolerance
F32_ATOL = 1e-6  # kernel vs twin: f32 rounding only (relative above 1)
NEAR = 1e-6  # a branch test this close to its threshold may go either way


def _jax_scene(rng, n):
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
    vis[:1] = False  # nothing visible
    if n > 1:
        vis[1] = False  # only the anchor visible: no payload view
        vis[1, (refs[1] + 1) % V] = True
    return scene.render_all(), cams, JaxPatchState.create(
        position, normal, refs, vis)


def _objective(rng, n, device="cpu", k=11):
    images, cams, st = _jax_scene(rng, n)
    tst = torch_state(st, device)
    f = optimize.photometric_objective_paged(
        torch.as_tensor(images, device=device), torch_cameras(cams, device),
        tst.position, tst.normal, tst.ref, tst.vis, k)
    return f


# Lanes whose f-values are set so that the step takes a given branch (the
# objective lies in [0, 2]): every candidate beats 3 (expansion); best -1,
# worst 3 (outside contraction); all -1 (inside contraction, no
# improvement, and the spread 0 ends the lane); best -1, the rest 3 (the
# middle case: x_r accepted without its contraction); ties in the order
# the sort must keep.
FORCED = {2: [3.0, 3.0, 3.0, 3.0], 3: [3.0, -1.0, -1.0, -1.0],
          4: [-1.0, -1.0, -1.0, -1.0], 5: [3.0, 3.0, -1.0, 3.0],
          6: [0.5, 0.5, 0.25, 0.5]}
FROZEN = 7


def _state(f, rng, B, device="cpu"):
    """A solver state of B lanes: a jittered simplex around 0, its
    f-values (FORCED where set), lane FROZEN done."""
    step = np.array([0.02, 0.2, 0.2], np.float32)
    verts = np.concatenate([np.zeros((B, 1, 3)), np.tile(np.diag(step),
                                                         (B, 1, 1))], 1)
    verts += rng.uniform(-0.01, 0.01, verts.shape)
    verts = torch.as_tensor(verts.astype(np.float32), device=device)
    fvals = f(verts)
    for b, vals in FORCED.items():
        if b < B:
            fvals[b] = torch.tensor(vals, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    if FROZEN < B:
        done[FROZEN] = True
    return (verts, fvals, done, torch.zeros(B, dtype=torch.int32,
                                            device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def _clone(state):
    return tuple(t.clone() for t in state)


def _branches(f, state):
    """Each lane's branch in the step from `state`, by the plain twins:
    expansion, outside, inside, middle, and whether the worst improved."""
    verts, fvals, done, iters, step = _clone(state)
    sv, sf, c, xr, pos, nrm = nm_step.nm_reflect_plain(
        verts, fvals, f.position0, f.normal0, f.C_ref)
    f_r, x_2, pos2, nrm2 = nm_step.nm_contract_plain(
        f.score(pos, nrm, f.ref, f.vis)[0], f.payload, f.n_payload, sv, sf,
        c, xr, f.position0, f.normal0, f.C_ref)
    f_2 = nm_step._cost(f.score(pos2, nrm2, f.ref, f.vis)[0], f.payload,
                        f.n_payload)
    expand = f_r < sf[:, 0]
    outside = ~expand & (f_r < sf[:, -1])
    middle = outside & (f_r < sf[:, -2])
    inside = ~expand & ~outside
    use_2 = torch.where(expand, f_2 < f_r, (f_r >= sf[:, -2]) & (f_2 < f_r))
    improved = torch.where(use_2, f_2, f_r) < sf[:, -1]
    return {"expand": expand, "outside": outside & ~middle,
            "middle": middle, "inside": inside, "improved": improved}


@pytest.mark.parametrize("B", [0, 1, 37])
def test_twin_step_is_the_torch_step_bitwise(rng, B):
    f = _objective(rng, B)
    state = _state(f, rng, B)
    if B == 37:
        lanes = _branches(f, state)
        for name, lane in lanes.items():
            assert lane.any(), f"no lane takes the {name} branch"
        assert not lanes["improved"].all()
        assert int(f.n_payload[0]) == 0 and int(f.n_payload[1]) == 0
    max_iterations = 2
    want, got = _clone(state), _clone(state)
    advance = nm_step.KernelStep(f, got[0])
    plain = nm_step.PLAIN_CALLS
    for _ in range(max_iterations + 2):  # the last two are past the cap
        want = simplex._step(f, *want, max_iterations, TOL)
        got = advance(*got, max_iterations, TOL)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.equal(advance.exit_flag(got, max_iterations),
                           simplex._TorchStep.exit_flag(want,
                                                        max_iterations))
    assert nm_step.PLAIN_CALLS - plain == 3 * (max_iterations + 2)
    if B == 37:
        verts, fvals, done, iters, step = got
        assert int(step) == max_iterations + 2
        assert done[FROZEN] and int(iters[FROZEN]) == 0
        assert done.any() and not done.all()
        assert int(iters.max()) == max_iterations  # none past the cap


@pytest.mark.parametrize("sweep", [0, 9])
def test_optimize_patches_once_is_unchanged(rng, monkeypatch, sweep):
    images, cams, st = _jax_scene(rng, 24)
    args = (torch.as_tensor(images), torch_cameras(cams), torch_state(st),
            11, OptimizeConfig(max_iterations=30, depth_sweep_steps=sweep))
    kernel_steps = simplex.counts()["nm_kernel_launches"]
    plain = nm_step.PLAIN_CALLS
    got = optimize.optimize_patches_once(*args)
    assert nm_step.PLAIN_CALLS > plain  # the kernel step's twins ran
    assert simplex.counts()["nm_kernel_launches"] == kernel_steps

    def torch_step(f, *a, **kw):  # the objective as a plain callable
        return simplex.nelder_mead(lambda p: f(p), *a, **kw)

    monkeypatch.setattr(optimize, "nelder_mead", torch_step)
    plain = nm_step.PLAIN_CALLS
    want = optimize.optimize_patches_once(*args)
    assert nm_step.PLAIN_CALLS == plain
    assert torch.equal(got.position, want.position)
    assert torch.equal(got.normal, want.normal)
    assert not torch.equal(got.position, args[2].position)


@pytest.mark.parametrize("iterations", [1, 2, 3, 5])
def test_jax_parity_after_iterations(rng, iterations):
    images, cams, st = _jax_scene(rng, 10)
    want = jax_optimize(jnp.asarray(images), cams, st, 11,
                        JaxOptimizeConfig(max_iterations=iterations))
    got = optimize.optimize_patches(
        torch.as_tensor(images), torch_cameras(cams), torch_state(st), 11,
        OptimizeConfig(max_iterations=iterations))
    out = patch_state_to_numpy(got)
    np.testing.assert_allclose(out["position"], np.asarray(want.position),
                               atol=1e-3)
    np.testing.assert_allclose(out["normal"], np.asarray(want.normal),
                               atol=5e-2)
    moved = np.abs(out["position"] - np.asarray(st.position)).max()
    assert moved > 1e-6  # the solver moved the patches


def _close(got, want, what):
    """f32 values within F32_ATOL, relative where |want| > 1."""
    if want.numel():
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        assert err <= F32_ATOL, f"{what}: {err}"


def _agree_except_near(got, want, margin, what):
    """Branch picks equal except where the test's operands lie within NEAR
    of each other."""
    assert not ((got != want) & (margin.abs() >= NEAR)).any(), what


@pytest.mark.cuda
def test_each_kernel_matches_its_plain_twin(rng, cuda_device):
    B = 517
    f = _objective(rng, B, cuda_device)
    state = _state(f, rng, B, cuda_device)
    pose = (f.position0, f.normal0, f.C_ref)
    # nm_reflect
    want = nm_step.nm_reflect_plain(*state[:2], *pose)
    verts, fvals = state[0].clone(), state[1].clone()
    centroid, x_r, pos, nrm = (torch.empty_like(want[2]) for _ in range(4))
    nm_step.nm_reflect(verts, fvals, *pose, centroid, x_r, pos, nrm)
    torch.cuda.synchronize()
    assert torch.equal(verts, want[0]) and torch.equal(fvals, want[1])
    # The pose against the twin's pose of the kernel's own x_r (an ulp of
    # x_r at a large angle moves cos and sin by as much).
    for got, w, what in zip((centroid, x_r, pos, nrm),
                            (*want[2:4], *nm_step._pose(x_r, *pose)),
                            ("centroid", "x_r", "position", "normal")):
        _close(got, w, what)
    # nm_contract, on the twin's sorted state and x_r's grid
    sv, sf, c, xr = want[:4]
    scores = f.score(want[4], want[5], f.ref, f.vis)[0]
    wc = nm_step.nm_contract_plain(scores, f.payload, f.n_payload, sv, sf,
                                   c, xr, *pose)
    f_r, x_2, pos, nrm = (torch.empty_like(t) for t in wc)
    nm_step.nm_contract(scores, f.payload, f.n_payload, sv, sf, c, xr,
                        *pose, f_r, x_2, pos, nrm)
    torch.cuda.synchronize()
    _close(f_r, wc[0], "f_r")
    for op in (0, -1):
        _agree_except_near(f_r < sf[:, op], wc[0] < sf[:, op],
                           wc[0] - sf[:, op], "expand / outside")
    same = ((f_r < sf[:, 0]) == (wc[0] < sf[:, 0])) & (
        (f_r < sf[:, -1]) == (wc[0] < sf[:, -1]))
    _close(x_2[same], wc[1][same], "x_2")
    pose_2 = nm_step._pose(x_2, *pose)
    _close(pos[same], pose_2[0][same], "position")
    _close(nrm[same], pose_2[1][same], "normal")
    # nm_accept, on the twin's f_r and x_2 and x_2's grid
    scores = f.score(wc[2], wc[3], f.ref, f.vis)[0]
    for max_iterations in (50, 1):  # the second: the cap reached
        done, iters, step = (t.clone() for t in state[2:])
        wa = nm_step.nm_accept_plain(scores, f.payload, f.n_payload, sv, sf,
                                     done, iters, step, xr, wc[0], wc[1],
                                     max_iterations, TOL)
        av, af = sv.clone(), sf.clone()
        flag = torch.zeros((), dtype=torch.bool, device=cuda_device)
        counters = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        nm_step.nm_accept(scores, f.payload, f.n_payload, av, af, done,
                          iters, step, xr, wc[0], wc[1], max_iterations, TOL,
                          flag, counters)
        torch.cuda.synchronize()
        # f_2 differs from the twin's by the V-sum's order: where one of
        # its tests has operands within NEAR of each other, the lane may
        # take the other branch; every other lane agrees.
        f_2 = nm_step._cost(scores, f.payload, f.n_payload)
        use_2 = torch.where(wc[0] < sf[:, 0], f_2 < wc[0],
                            (wc[0] >= sf[:, -2]) & (f_2 < wc[0]))
        f_new = torch.where(use_2, f_2, wc[0])
        spread = wa[1].max(dim=1).values - wa[1].min(dim=1).values
        near = (((f_2 - wc[0]).abs() < NEAR)
                | ((f_new - sf[:, -1]).abs() < NEAR)
                | ((spread - TOL).abs() < NEAR))
        _close(av[~near], wa[0][~near], "verts")
        _close(af[~near], wa[1][~near], "fvals")
        assert torch.equal(done[~near], wa[2][~near])
        assert torch.equal(iters, wa[3]) and torch.equal(step, wa[4])
        assert torch.equal(counters, torch.zeros_like(counters))
        if torch.equal(done, wa[2]):  # else a near lane ended otherwise
            assert torch.equal(flag, wa[5])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
def test_graph_matches_the_eager_kernel_step(rng, cuda_device, m):
    f = _objective(rng, 64, cuda_device)
    x0 = torch.zeros((64, 3), device=cuda_device)
    step = torch.tensor([0.02, 0.2, 0.2], device=cuda_device)

    def launches():
        return (allview_ncc.KERNEL_LAUNCHES, nm_step.REFLECT_LAUNCHES,
                nm_step.CONTRACT_LAUNCHES, nm_step.ACCEPT_LAUNCHES)

    before, steps = launches(), simplex.STEPS
    want = simplex.nelder_mead(f, x0, step, 41, TOL, _eager=True,
                               _block_steps=m)
    torch.cuda.synchronize()
    eager = [a - b for a, b in zip(launches(), before)]
    n = simplex.STEPS - steps
    # Five launches a step, K1 twice; the initial simplex is one K1.
    assert eager == [2 * n + 1, n, n, n]
    before, captures = launches(), simplex.GRAPH_CAPTURES
    got = simplex.nelder_mead(f, x0, step, 41, TOL, _block_steps=m)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert simplex.GRAPH_CAPTURES == captures + 1
    assert [a - b for a, b in zip(launches(), before)] == eager


@pytest.mark.cuda
def test_a_refused_launch_raises(cuda_device):
    """An empty grid is refused by the launch; the wrapper's `launch`
    raises with the CUDA error (nothing runs, so no pointer is read)."""
    with pytest.raises(RuntimeError, match="nm_reflect_launch failed"):
        _build.launch("nm_reflect_launch", nm_step._REFLECT_ARGTYPES,
                      cuda_device, *([None] * 9), 0)
    torch.cuda.synchronize()
