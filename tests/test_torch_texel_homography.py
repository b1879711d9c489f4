"""The texel homography of the port's warp + NCC kernels, on the CPU.

The CUDA kernels do not project every texel: they form, once per (patch,
view), the homography that maps the k x k texel grid to pixels
(`ops.warp.texel_homography`, the plain mirror of the kernels' set-up) and
evaluate it per texel with one reciprocal. These tests put a number on that
arithmetic before a card sees it: the pixels it gives are held against the
port's `Cameras.project` of the texels' world points, against the JAX
package's coordinates (`patch_frames` + `Cameras.project`, what
`patch_textures` samples at) and against a float64 projection, at a small
refine-like rig and at DTU-sized intrinsics (1600 x 1200, focal 2900).

Tolerances, in pixels. An f32 pixel near 640 has a step of 6.1e-5 and one
near 1600 a step of 1.2e-4. The homography rounds once at the pixel's own
magnitude, so against float64 it is held to 4e-5 (refine; 1.7e-5 measured)
and 8e-5 (DTU; 6.2e-5 measured). The f32 projections it is compared with
round at |K R (X - C)| as well (5.3e-5 and 1.5e-4 from float64, measured):
1.5e-4 (refine; 6.1e-5 measured) and 3e-4 (DTU; 1.2e-4 measured) against
either package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.ops.warp import patch_frames as jax_frames
from densepoints_tpu_torch.ops.warp import (
    homography_pixels,
    patch_frames,
    texel_homography,
)
from tests.torch_port_util import noise_rig, torch_cameras

RIGS = {
    # width, height, focal, tolerance vs float64, tolerance vs f32 projection
    "refine": (640, 480, 500.0, 4e-5, 1.5e-4),
    "dtu": (1600, 1200, 2900.0, 8e-5, 3e-4),
}
NUM_VIEWS, NUM_PATCHES = 5, 48


def _rig(rng, name):
    W, H, focal, tol64, tol32 = RIGS[name]
    P, _, pos, nrm = noise_rig(rng, NUM_VIEWS, W, H, focal, NUM_PATCHES)
    jcams = JaxCameras.from_projection_matrices(P, widths=W, heights=H)
    ref = rng.integers(0, NUM_VIEWS, NUM_PATCHES).astype(np.int32)
    return jcams, torch_cameras(jcams), pos, nrm, ref, tol64, tol32


def _grid(k, dtype):
    return 2.0 * torch.arange(k, dtype=dtype) / k - 1.0


def _world(pos, sx, sy, k):
    co = _grid(k, pos.dtype)
    return (pos[:, None, None, :]
            + co[None, None, :, None] * sx[:, None, None, :]
            + co[None, :, None, None] * sy[:, None, None, :])


def _port_pixels(tc, pos, nrm, ref, k):
    t = torch.as_tensor
    sx, sy = patch_frames(tc, t(pos), t(nrm), t(ref).long(), k)
    pix = homography_pixels(*texel_homography(tc, t(pos), sx, sy, k), k)
    assert pix.dtype == torch.float32
    assert pix.shape == (NUM_VIEWS, NUM_PATCHES, k, k, 2)
    return pix, sx, sy


def _inside(pix, W, H):
    return bool(((pix[..., 0] > 0) & (pix[..., 0] < W)
                 & (pix[..., 1] > 0) & (pix[..., 1] < H)).all())


@pytest.mark.parametrize("k", [5, 11, 16])
@pytest.mark.parametrize("rig", ["refine", "dtu"])
def test_homography_pixels_match_port_projection(rng, rig, k):
    _, tc, pos, nrm, ref, _, tol32 = _rig(rng, rig)
    pix, sx, sy = _port_pixels(tc, pos, nrm, ref, k)
    want = tc.project(_world(torch.as_tensor(pos), sx, sy, k))
    assert _inside(want, *RIGS[rig][:2])  # every texel is a real sample
    assert float((pix - want).abs().max()) <= tol32


@pytest.mark.parametrize("k", [5, 11, 16])
@pytest.mark.parametrize("rig", ["refine", "dtu"])
def test_homography_pixels_match_jax_coordinates(rng, rig, k):
    """The coordinates JAX `patch_textures` samples at: its own frames, its
    texel grid, its `Cameras.project`."""
    jcams, tc, pos, nrm, ref, _, tol32 = _rig(rng, rig)
    pix, _, _ = _port_pixels(tc, pos, nrm, ref, k)
    jsx, jsy = jax_frames(jcams, jnp.asarray(pos), jnp.asarray(nrm),
                          jnp.asarray(ref), k)
    co = 2.0 * jnp.arange(k, dtype=jnp.float32) / k - 1.0
    world = (jnp.asarray(pos)[:, None, None, :]
             + co[None, None, :, None] * jsx[:, None, None, :]
             + co[None, :, None, None] * jsy[:, None, None, :])
    want = torch.as_tensor(np.array(jcams.project(world)))
    assert float((pix - want).abs().max()) <= tol32


@pytest.mark.parametrize("k", [5, 11, 16])
@pytest.mark.parametrize("rig", ["refine", "dtu"])
def test_homography_pixels_match_float64_projection(rng, rig, k):
    """Against the projection of the same f32 frames in float64 the
    homography is within one rounding of the pixel: it is the more exact
    side of the two comparisons above."""
    _, tc, pos, nrm, ref, tol64, tol32 = _rig(rng, rig)
    pix, sx, sy = _port_pixels(tc, pos, nrm, ref, k)
    world = _world(torch.as_tensor(pos).double(), sx.double(), sy.double(), k)
    rel = world[None] - tc.C.double()[:, None, None, None, :]
    cam = torch.einsum("vij,vbrcj->vbrci", tc.R.double(), rel)
    hom = torch.einsum("vij,vbrcj->vbrci", tc.K.double(), cam)
    want = hom[..., :2] / hom[..., 2:3]
    err = float((pix.double() - want).abs().max())
    assert err <= tol64
    plain = tc.project(_world(torch.as_tensor(pos), sx, sy, k))
    assert err <= float((plain.double() - want).abs().max()) <= tol32
