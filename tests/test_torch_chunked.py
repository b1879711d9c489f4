"""The port's chunked (compacted-slot) objective, as a whole, vs JAX.

Tolerances and why:
  * `_anchor_chunks`: ids and ok exactly equal (a stable sort of a bool on
    both sides);
  * `photometric_objective` vs the JAX function, and vs the port's own
    all-views `photometric_objective_paged`: rtol 1e-4 / atol 5e-4, the
    bound tests/ops/test_warp_ncc_paged.py holds the two JAX objectives to
    (f32 scores differ in the summation order only; the mean over views
    adds noise of the same order);
  * the (B, V) all-views grid vs the slot scores wherever both score: 1e-4;
  * `parametrize` vs JAX: 1e-5 (f32 norms and arctangents).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.pmvs import optimize as jax_optimize
from densepoints_tpu_torch import pmvs
from densepoints_tpu_torch.config import OptimizeConfig
from densepoints_tpu_torch.ops import allview_ncc
from densepoints_tpu_torch.pmvs import optimize
from densepoints_tpu_torch.pmvs.patch import PatchState
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import cuda_device, torch_cameras  # noqa: F401

OBJ_TOL = dict(rtol=1e-4, atol=5e-4)


def _setup(rng):
    scene = TexturedPlaneScene(rng, num_views=5, width=200, height=160)
    cams = JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    return cams, scene.render_all()


def _patches(rng, n, V, jitter=0.0):
    """Plane patches with mixed refs and visibility; row 0 sees nothing."""
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    z = rng.uniform(-jitter, jitter, (n, 1))
    position = np.concatenate([xy, z], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    refs = rng.integers(0, V, (n,)).astype(np.int32)
    vis = rng.uniform(size=(n, V)) > 0.3
    vis[np.arange(n), refs] = False
    vis[0] = False
    return position, normal, refs, vis


def _targs(cams, images, pos, nrm, refs, vis, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (t(images), torch_cameras(cams, device), t(pos), t(nrm),
            t(refs).long(), t(vis))


def _jargs(cams, images, pos, nrm, refs, vis):
    j = jnp.asarray
    return j(images), cams, j(pos), j(nrm), j(refs), j(vis)


@pytest.mark.parametrize("max_views", [3, 4, 16])
def test_anchor_chunks_match(rng, max_views):
    vis = rng.uniform(size=(30, 7)) > 0.4
    vis[0] = False
    vis[1] = True
    want = jax_optimize._anchor_chunks(jnp.asarray(vis), max_views)
    got = optimize._anchor_chunks(torch.as_tensor(vis), max_views)
    assert len(got) == len(want)
    widths = {ids.shape[1] for ids, _ in got}
    assert widths == {max(min(7, max_views), 2)}  # one stable width
    for (ids, ok), (jids, jok) in zip(got, want):
        assert ids.dtype == torch.int32 and ok.dtype == torch.bool
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    # Together the chunks hold every visible view once (the anchor once
    # per chunk).
    counted = sum(int(ok[:, 1:].sum()) for _, ok in got)
    assert counted == int(vis.sum() - vis.any(1).sum())


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_chunked_objective_matches_jax(rng, impl):
    cams, images = _setup(rng)
    patches = _patches(rng, 9, cams.num_views, jitter=0.02)
    params = rng.uniform(-0.05, 0.05, (9, 4, 3)).astype(np.float32)
    f_jax = jax_optimize.photometric_objective(
        *_jargs(cams, images, *patches), 11, impl="xla", max_score_views=3
    )
    f = optimize.photometric_objective(
        *_targs(cams, images, *patches), 11, impl=impl, max_score_views=3
    )
    got = f(torch.as_tensor(params)).numpy()
    assert got.shape == (9, 4) and np.all(got[0] == 2.0)
    assert np.all((got >= 0.0) & (got <= 2.0)) and got[1:].min() < 1.0
    np.testing.assert_allclose(
        got, np.asarray(f_jax(jnp.asarray(params))), **OBJ_TOL
    )


@pytest.mark.parametrize("max_score_views", [3, 16])
@pytest.mark.parametrize("k", [11, 16])
def test_chunked_objective_matches_all_views(rng, k, max_score_views):
    """Two derivations inside the port: slots in anchor-pinned chunks vs
    the all-views (B, V) grid."""
    cams, images = _setup(rng)
    args = _targs(cams, images, *_patches(rng, 9, cams.num_views, 0.02))
    params = torch.as_tensor(
        rng.uniform(-0.05, 0.05, (9, 4, 3)).astype(np.float32)
    )
    f_chunk = optimize.photometric_objective(
        *args, k, impl="xla", max_score_views=max_score_views
    )
    f_all = optimize.photometric_objective_paged(*args, k)
    np.testing.assert_allclose(
        f_chunk(params).numpy(), f_all(params).numpy(), **OBJ_TOL
    )


def _assert_grid_matches_slots(grid, slot_scores, view_ids, ok):
    """Slot m of patch b maps to column view_ids[b, m]; slot 0 is the
    anchor, which the grid marks -1 and the slots score against itself."""
    compared = 0
    for b in range(grid.shape[0]):
        for m in range(1, view_ids.shape[1]):
            if ok[b, m]:
                compared += 1
                np.testing.assert_allclose(
                    grid[b, view_ids[b, m]], slot_scores[b, m],
                    rtol=1e-4, atol=1e-4,
                )
    return compared


def test_all_views_grid_matches_slot_scores(rng):
    cams, images = _setup(rng)
    args = _targs(cams, images, *_patches(rng, 10, cams.num_views))
    grid, anchor, _ = allview_ncc.allview_scores(*args, 11)
    scores, view_ids, ok = optimize.patch_ncc_scores(*args, 11)
    has = ok[:, 0].numpy()
    np.testing.assert_array_equal(
        view_ids[:, 0].numpy()[has], anchor.numpy()[has]
    )
    compared = _assert_grid_matches_slots(
        grid.numpy(), scores.numpy(), view_ids.numpy(), ok.numpy()
    )
    assert compared > 10


def test_parametrize_matches(rng):
    cams, _ = _setup(rng)
    pos, _, refs, _ = _patches(rng, 20, cams.num_views, jitter=0.1)
    nrm = rng.standard_normal((20, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    want = jax_optimize.parametrize(
        cams, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(refs)
    )
    got = pmvs.parametrize(
        torch_cameras(cams), torch.as_tensor(pos), torch.as_tensor(nrm),
        torch.as_tensor(refs).long(),
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_package_exports_the_chunked_path():
    for name in ("PatchState", "classify_views", "compute_color",
                 "filter_by_error", "optimize_patches", "parametrize",
                 "patch_ncc_scores", "photometric_objective",
                 "unparametrize"):
        assert hasattr(pmvs, name), name


@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("stage", ["filter_by_error", "optimize_patches"])
def test_retired_sampling_impl_raises(rng, stage, impl):
    """"fused" and "xla" live on as `impl` of the parity functions only;
    the stages refuse them with ValueError, as the JAX package does."""
    cams, images = _setup(rng)
    im, tc, p, n, r, v = _targs(cams, images, *_patches(rng, 4, 5))
    state = PatchState.create(p, n, r, v)
    cfg = dataclasses.replace(OptimizeConfig(), sampling_impl=impl)
    with pytest.raises(ValueError, match="retired"):
        getattr(optimize, stage)(im, tc, state, 11, cfg)


@pytest.mark.cuda
def test_chunked_objective_on_card(rng, cuda_device):
    """On the card: the slot kernel's objective vs the all-views kernel's,
    and vs its own gather route through the row-wise NCC kernel."""
    cams, images = _setup(rng)
    args = _targs(cams, images, *_patches(rng, 64, cams.num_views, 0.02),
                  device=cuda_device)
    params = torch.as_tensor(
        rng.uniform(-0.05, 0.05, (64, 4, 3)).astype(np.float32),
        device=cuda_device,
    )
    auto = optimize.photometric_objective(*args, 11, max_score_views=3)(params)
    xla = optimize.photometric_objective(
        *args, 11, impl="xla", max_score_views=3
    )(params)
    paged = optimize.photometric_objective_paged(*args, 11)(params)
    np.testing.assert_allclose(auto.cpu().numpy(), paged.cpu().numpy(),
                               **OBJ_TOL)
    np.testing.assert_allclose(auto.cpu().numpy(), xla.cpu().numpy(),
                               rtol=0, atol=1e-4)
