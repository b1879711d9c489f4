"""Binary BRIEF keypoint descriptors kept as +-1 float vectors, so Hamming
distances become one matrix product: hamming(a, b) = (D - a.b) / 2."""
from __future__ import annotations

import numpy as np
import torch

from densepoints_tpu_torch.features.detector import gaussian_blur
from densepoints_tpu_torch.ops.warp import bilinear_sample

__all__ = ["brief_pattern", "compute_descriptors"]


def brief_pattern(
    bits: int = 256, patch_radius: int = 15, seed: int = 7
) -> np.ndarray:
    """Fixed comparison pattern (bits, 2, 2): pairs of (dx, dy) offsets,
    Gaussian with sigma = radius / 2, clipped to the patch, from a fixed
    numpy seed (identical on every host and device)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, patch_radius / 2.0, size=(bits, 2, 2))
    return np.clip(pts, -patch_radius, patch_radius).astype(np.float32)


def compute_descriptors(
    images: torch.Tensor,
    xy: torch.Tensor,
    pattern: torch.Tensor,
    blur_sigma: float = 2.0,
) -> torch.Tensor:
    """images: (V, H, W); xy: (V, N, 2); pattern: (D, 2, 2).
    Returns (V, N, D) float32 in {-1, +1}."""
    blurred = gaussian_blur(images.to(torch.float32), blur_sigma)
    pos = xy[:, :, None, None, :] + pattern[None, None]  # (V, N, D, 2, 2)
    out = []
    for v in range(images.shape[0]):
        a = bilinear_sample(blurred[v], pos[v, :, :, 0, :])
        b = bilinear_sample(blurred[v], pos[v, :, :, 1, :])
        out.append(torch.where(a > b, 1.0, -1.0))
    return torch.stack(out).to(torch.float32)
