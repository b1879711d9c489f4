"""Shared helpers of the PyTorch-port parity tests.

Each test feeds identical numpy state to the JAX package (the reference)
and to `densepoints_tpu_torch`, through `densepoints_tpu_torch.interop`.
"""
import numpy as np
import pytest
import torch

from densepoints_tpu_torch.interop import (
    cameras_from_numpy,
    patch_state_from_numpy,
)

# The tier-1 run puts several test workers on one machine.
torch.set_num_threads(2)


def torch_cameras(jax_cams, device="cpu"):
    """The port's Cameras holding exactly the JAX Cameras' values."""
    return cameras_from_numpy(
        *(np.asarray(getattr(jax_cams, f))
          for f in ("P", "K", "E", "C", "x_axis", "width", "height")),
        device=device,
    )


def torch_state(jax_state, device="cpu"):
    """The port's PatchState holding exactly the JAX PatchState's values."""
    return patch_state_from_numpy(
        *(np.asarray(getattr(jax_state, f))
          for f in ("position", "normal", "ref", "vis", "cand", "alive",
                    "color")),
        device=device,
    )


@pytest.fixture()
def cuda_device():
    """A CUDA device, or skip: kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def noise_rig(rng, num_views, width, height, focal, num_patches, spread=0.5):
    """A rig for the warp + NCC tests: `num_views` pinhole views on an arc
    of `spread` radians at distance 6, looking at the plane z = 0, uniform
    noise images, and plane patches whose footprints lie inside every view.

    Returns (P (V, 3, 4) f64, images (V, H, W) f32, position (B, 3) f32,
    normal (B, 3) f32)."""
    Kmat = np.array([[focal, 0, width / 2], [0, focal, height / 2],
                     [0, 0, 1.0]])
    P = []
    for i in range(num_views):
        ang = (i - (num_views - 1) / 2) * (spread / max(num_views, 2))
        C = np.array([6.0 * np.sin(ang), 0.2 * np.sin(2 * i),
                      -6.0 * np.cos(ang)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        P.append(Kmat @ np.concatenate([R, (-R @ C)[:, None]], 1))
    images = rng.uniform(0, 255, (num_views, height, width)).astype(np.float32)
    # Half of the plane's visible half-extent at distance 6.
    reach = 0.5 * 6.0 * min(width, height) / (2 * focal)
    xy = rng.uniform(-reach, reach, (num_patches, 2))
    position = np.concatenate(
        [xy, np.zeros((num_patches, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (num_patches, 1)).astype(np.float32)
    return np.stack(P), images, position, normal


def awkward_rig(rng, num_views, num_patches):
    """`noise_rig` at 120 x 160 with what stresses a kernel's control flow:
    random reference views, mixed visibility, one row with no visible view
    (more than 2 patches) and four rows off every frustum (more than 8).

    Returns (P, images, position, normal, ref (B,) int64, vis (B, V) bool)."""
    P, images, pos, nrm = noise_rig(
        rng, num_views, 160, 120, 125.0, num_patches, spread=0.9)
    ref = rng.integers(0, num_views, num_patches)
    vis = rng.uniform(size=(num_patches, num_views)) > 0.3
    if num_views > 1:
        vis[np.arange(num_patches), ref] = False
    if num_patches > 2:
        vis[2] = False
    if num_patches > 8:
        pos[4:8] = [50.0, 50.0, 0.0]
    return P, images, pos, nrm, ref, vis
