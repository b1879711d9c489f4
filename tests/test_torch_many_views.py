"""The port against the JAX package past 254 views.

The JAX package scores a (B, V) grid for any V; the port's kernels once
refused more than 254 views (fewer at k = 21 and 31), so a scene of more
views is held here on the CPU, where the port runs its plain path: one
scene of 260 views of 24 x 32 on a grid of angles around a textured plane
(`default_rng(0)`, numpy), B = 12 patches of mixed visibility, k = 11, with
a row that sees only views past 254 and a row that sees none.

Tolerances: the scores as in `test_torch_allview_ncc.py` (1e-5 is well
within it: f32 on both sides, summation order only), with anchors,
anchor_ok and sentinels equal; `optimize_patches` at 10 Nelder-Mead
iterations as in `test_torch_optimize.py` (positions within 1e-3, normals
within 0.05: last-bit score differences may move a simplex step, and roll
and pitch are weakly determined by NCC).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.ops.warp_ncc_paged import allview_scores_xla
from densepoints_tpu.pmvs import PatchState as JaxPatchState
from densepoints_tpu.pmvs.optimize import optimize_patches as jax_optimize
from densepoints_tpu_torch.config import OptimizeConfig
from densepoints_tpu_torch.interop import patch_state_to_numpy
from densepoints_tpu_torch.ops import allview_ncc
from densepoints_tpu_torch.pmvs.optimize import optimize_patches
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import torch_cameras, torch_state

V, H, W, B, K = 260, 24, 32, 12, 11
SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    """(JAX cameras, images (V, H, W) f32, position, normal, ref, vis)."""
    rng = np.random.default_rng(0)
    plane = TexturedPlaneScene(rng, num_views=1, width=W, height=H,
                               focal=40.0, tex_size=256)
    # 20 x 13 cameras on a grid of angles 6 units from the origin, each
    # looking at it; rendered by the plane scene's exact renderer.
    Ps, Cs = [], []
    for pitch in np.linspace(-0.2, 0.2, 13):
        for yaw in np.linspace(-0.3, 0.3, 20):
            C = 6.0 * np.array([np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                                -np.cos(yaw) * np.cos(pitch)])
            z = -C / np.linalg.norm(C)
            x = np.cross([0.0, 1.0, 0.0], z)
            x /= np.linalg.norm(x)
            R = np.stack([x, np.cross(z, x), z])
            Ps.append(plane.K @ np.concatenate([R, (-R @ C)[:, None]], 1))
            Cs.append(C)
    plane.P, plane.C = np.stack(Ps), np.stack(Cs)
    images = plane.render_all()
    cams = JaxCameras.from_projection_matrices(plane.P, widths=W, heights=H)
    xy = rng.uniform(-0.4, 0.4, (B, 2))
    z = rng.uniform(-0.02, 0.02, (B, 1))
    position = np.concatenate([xy, z], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    ref = rng.integers(0, V, B).astype(np.int32)
    vis = rng.uniform(size=(B, V)) > 0.3
    vis[np.arange(B), ref] = False
    vis[0] = False
    vis[0, 256:] = True  # the anchor past the old limit
    ref[0] = 0
    vis[1] = False  # no visible view
    return cams, images, position, normal, ref, vis


def test_allview_scores_match_past_254_views(scene):
    cams, images, pos, nrm, ref, vis = scene
    want = [np.asarray(o) for o in allview_scores_xla(
        jnp.asarray(images), cams, jnp.asarray(pos), jnp.asarray(nrm),
        jnp.asarray(ref), jnp.asarray(vis), K)]
    plain = allview_ncc.PLAIN_CALLS
    got = [o.numpy() for o in allview_ncc.allview_scores(
        torch.as_tensor(images), torch_cameras(cams), torch.as_tensor(pos),
        torch.as_tensor(nrm), torch.as_tensor(ref).long(),
        torch.as_tensor(vis), K)]
    assert allview_ncc.PLAIN_CALLS == plain + 1
    (s, a, ok), (ws, wa, wok) = got, want
    assert s.shape == (B, V)
    np.testing.assert_array_equal(a, wa)
    np.testing.assert_array_equal(ok, wok)
    np.testing.assert_array_equal(s == -1.0, ws == -1.0)
    np.testing.assert_allclose(s, ws, atol=SCORE_ATOL, rtol=0)
    # The comparison has teeth: rows score across many tiles of 32 views,
    # and row 0's anchor lies past view 254.
    assert a[0] == 256 and ok[0] and (s[0] != -1).sum() >= 2
    assert not ok[1] and (s[1] == -1).all()
    scored = s != -1
    assert scored.sum() > 1000 and scored[:, 224:].any(axis=0).sum() > 10


def test_optimize_patches_match_past_254_views(scene):
    cams, images, pos, nrm, ref, vis = scene
    state = JaxPatchState.create(pos, nrm, ref, vis)
    want = jax_optimize(jnp.asarray(images), cams, state, K,
                        JaxOptimizeConfig(max_iterations=10))
    got = patch_state_to_numpy(optimize_patches(
        torch.as_tensor(images), torch_cameras(cams), torch_state(state), K,
        OptimizeConfig(max_iterations=10)))
    np.testing.assert_allclose(got["position"], np.asarray(want.position),
                               atol=1e-3)
    np.testing.assert_allclose(got["normal"], np.asarray(want.normal),
                               atol=5e-2)
    moved = np.abs(got["position"] - pos).max()
    assert moved > 1e-4  # the solver actually moved the patches
