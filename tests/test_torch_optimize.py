"""The port's optimization stage vs the JAX package on identical state.

Tolerances and why:
  * objective values rtol 1e-4 / atol 5e-4: f32 NCC scores differ in the
    summation order only (scores agree to ~1e-6, the mean over views adds
    the same order noise);
  * filter_by_error: vis and alive exactly equal; a decision may only flip
    for a score within 1e-4 of `score_threshold`, and there must be none
    at this seed;
  * Nelder-Mead on a quadratic, run to convergence: x_best within 1e-5 of
    the analytic minimum and of JAX's x_best (f32 at |x| ~ 1);
  * optimize_patches at equal batch: positions within 1e-3 (world units,
    scene scale ~5): last-bit score differences may move a simplex step.
    Normals within 0.05: roll and pitch of a plane patch are weakly
    determined by NCC, so the same step moves them further.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.ops.simplex import nelder_mead as jax_nelder_mead
from densepoints_tpu.ops.warp_ncc_paged import allview_scores_xla
from densepoints_tpu.pmvs import PatchState as JaxPatchState
from densepoints_tpu.pmvs.optimize import filter_by_error as jax_filter
from densepoints_tpu.pmvs.optimize import optimize_patches as jax_optimize
from densepoints_tpu.pmvs.optimize import photometric_objective_paged as jax_obj
from densepoints_tpu.pmvs.optimize import unparametrize as jax_unparametrize
from densepoints_tpu.pmvs.visibility import classify_views as jax_classify
from densepoints_tpu.pmvs.visibility import compute_color as jax_color
from densepoints_tpu_torch.config import OptimizeConfig
from densepoints_tpu_torch.interop import patch_state_to_numpy
from densepoints_tpu_torch.ops.simplex import nelder_mead
from densepoints_tpu_torch.pmvs.optimize import (
    filter_by_error,
    optimize_patches,
    photometric_objective_paged,
    unparametrize,
)
from densepoints_tpu_torch.pmvs.visibility import classify_views, compute_color
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import torch_cameras, torch_state


def _setup(rng):
    scene = TexturedPlaneScene(rng, num_views=5, width=200, height=160)
    cams = JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    return cams, scene.render_all()


def _state(rng, n, V, jitter=0.0):
    """Plane patches with mixed refs and visibility, optionally off-plane."""
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    z = rng.uniform(-jitter, jitter, (n, 1))
    position = np.concatenate([xy, z], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    refs = rng.integers(0, V, (n,)).astype(np.int32)
    vis = rng.uniform(size=(n, V)) > 0.25
    vis[np.arange(n), refs] = False
    vis[0] = False
    return JaxPatchState.create(position, normal, refs, vis)


@pytest.mark.parametrize("k", [11, 16])
def test_objective_matches(rng, k):
    cams, images = _setup(rng)
    st = _state(rng, 12, cams.num_views, jitter=0.02)
    params = rng.uniform(-0.05, 0.05, (12, 4, 3)).astype(np.float32)
    f_jax = jax_obj(
        jnp.asarray(images), cams, st.position, st.normal, st.ref, st.vis, k
    )
    ts = torch_state(st)
    f = photometric_objective_paged(
        torch.as_tensor(images), torch_cameras(cams), ts.position, ts.normal,
        ts.ref, ts.vis, k,
    )
    np.testing.assert_allclose(
        f(torch.as_tensor(params)).numpy(),
        np.asarray(f_jax(jnp.asarray(params))),
        rtol=1e-4, atol=5e-4,
    )


@pytest.mark.parametrize("k", [11, 16])
def test_filter_by_error_matches(rng, k):
    cams, images = _setup(rng)
    st = _state(rng, 24, cams.num_views, jitter=0.03)
    cfg = OptimizeConfig()
    want = jax_filter(jnp.asarray(images), cams, st, k, JaxOptimizeConfig())
    got = filter_by_error(
        torch.as_tensor(images), torch_cameras(cams), torch_state(st), k, cfg
    )
    scores = np.asarray(allview_scores_xla(
        jnp.asarray(images), cams, st.position, st.normal, st.ref, st.vis, k
    )[0])
    near = np.abs(scores - cfg.score_threshold) < 1e-4
    assert near.sum() == 0, f"{near.sum()} scores within 1e-4 of threshold"
    out = patch_state_to_numpy(got)
    np.testing.assert_array_equal(out["vis"], np.asarray(want.vis))
    np.testing.assert_array_equal(out["alive"], np.asarray(want.alive))
    # Both outcomes occur at this seed, so the comparison has teeth.
    assert 0 < out["alive"].sum() < len(out["alive"])


def test_filter_by_error_slices_like_one_batch(rng):
    cams, images = _setup(rng)
    st = torch_state(_state(rng, 24, cams.num_views, jitter=0.03))
    args = (torch.as_tensor(images), torch_cameras(cams), st, 11)
    whole = filter_by_error(*args, OptimizeConfig())
    sliced = filter_by_error(*args, OptimizeConfig(max_refine_batch=7))
    assert torch.equal(whole.vis, sliced.vis)
    assert torch.equal(whole.alive, sliced.alive)


def test_nelder_mead_quadratic_matches():
    rng = np.random.default_rng(0)
    targets = rng.standard_normal((32, 3)).astype(np.float32)
    step = np.array([0.5, 0.5, 0.5], np.float32)
    jt = jnp.asarray(targets)
    xj, fj, ij = jax_nelder_mead(
        lambda x: jnp.sum((x - jt[:, None, :]) ** 2, axis=-1),
        jnp.zeros((32, 3), jnp.float32), jnp.asarray(step),
        max_iterations=500, tolerance=1e-12,
    )
    tt = torch.as_tensor(targets)
    xt, ft, it = nelder_mead(
        lambda x: ((x - tt[:, None, :]) ** 2).sum(-1),
        torch.zeros((32, 3)), torch.as_tensor(step),
        max_iterations=500, tolerance=1e-12,
    )
    np.testing.assert_allclose(xt.numpy(), targets, atol=1e-5)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)


def test_unparametrize_matches(rng):
    params = rng.uniform(-0.3, 0.3, (8, 3)).astype(np.float32)
    p0 = rng.standard_normal((8, 3)).astype(np.float32)
    n0 = rng.standard_normal((8, 3)).astype(np.float32)
    C = rng.standard_normal((8, 3)).astype(np.float32)
    jp, jn = jax_unparametrize(*(jnp.asarray(a) for a in (params, p0, n0, C)))
    tp, tn = unparametrize(*(torch.as_tensor(a) for a in (params, p0, n0, C)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)


@pytest.mark.parametrize("sweep", [0, 9])
def test_optimize_patches_matches(rng, sweep):
    """Equal batches on both sides: the Nelder-Mead exit couples lanes."""
    cams, images = _setup(rng)
    st = _state(rng, 10, cams.num_views, jitter=0.02)
    jcfg = JaxOptimizeConfig(max_iterations=30, depth_sweep_steps=sweep)
    cfg = OptimizeConfig(max_iterations=30, depth_sweep_steps=sweep)
    want = jax_optimize(jnp.asarray(images), cams, st, 11, jcfg)
    got = optimize_patches(
        torch.as_tensor(images), torch_cameras(cams), torch_state(st), 11, cfg
    )
    out = patch_state_to_numpy(got)
    np.testing.assert_allclose(
        out["position"], np.asarray(want.position), atol=1e-3
    )
    np.testing.assert_allclose(
        out["normal"], np.asarray(want.normal), atol=5e-2
    )
    moved = np.abs(out["position"] - np.asarray(st.position)).max()
    assert moved > 1e-4  # the solver actually moved the patches


def test_classify_views_matches(rng):
    cams, _ = _setup(rng)
    pos = (rng.uniform(-1, 1, (40, 3)) * [1, 1, 0.2]).astype(np.float32)
    nrm = rng.standard_normal((40, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ref = rng.integers(0, cams.num_views, 40).astype(np.int32)
    jv, jc = jax_classify(
        cams, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(ref)
    )
    tv, tc = classify_views(
        torch_cameras(cams), torch.as_tensor(pos), torch.as_tensor(nrm),
        torch.as_tensor(ref).long(),
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_compute_color_matches(rng):
    cams, images = _setup(rng)
    colors = np.stack([images] * 3, axis=-1).clip(0, 255).astype(np.uint8)
    pos = (rng.uniform(-0.8, 0.8, (30, 3)) * [1, 1, 0]).astype(np.float32)
    want = jax_color(cams, jnp.asarray(colors), jnp.asarray(pos))
    got = compute_color(
        torch_cameras(cams), torch.as_tensor(colors), torch.as_tensor(pos)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_sampling_impl_outside_the_slice_raises(rng):
    """The chunked values are retired for the stages (ValueError, as in the
    JAX package); they live on as `impl` of `patch_ncc_scores`."""
    cams, images = _setup(rng)
    st = torch_state(_state(rng, 4, cams.num_views))
    cfg = dataclasses.replace(OptimizeConfig(), sampling_impl="fused")
    with pytest.raises(ValueError, match="retired"):
        filter_by_error(
            torch.as_tensor(images), torch_cameras(cams), st, 11, cfg
        )
