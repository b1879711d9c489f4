"""Image pyramids + coarse-to-fine densification.

A 2x2-average pyramid with consistently scaled cameras (P' = diag(s, s, 1)
P halves focal lengths and principal points, so the projective geometry is
kept exactly), and a coarse-to-fine driver: expand at the coarsest level,
then at each finer level re-optimize and re-filter the carried-over patches
and expand further with that level's occupancy grids. Every level runs on
the device of its images.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from densepoints_tpu_torch.config import PipelineConfig
from densepoints_tpu_torch.core.cameras import Cameras

__all__ = ["downsample2", "build_pyramid", "scale_cameras",
           "densify_multiscale"]


def downsample2(images: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsample of (..., H, W) (H, W even-truncated)."""
    H, W = images.shape[-2:]
    H2, W2 = H // 2, W // 2
    x = images[..., : H2 * 2, : W2 * 2]
    x = x.reshape(x.shape[:-2] + (H2, 2, W2, 2))
    return x.mean(dim=(-3, -1))


def scale_cameras(cameras: Cameras, scale: float) -> Cameras:
    """Cameras for images resized by `scale` (e.g. 0.5 per pyramid level),
    on the device of `cameras`."""
    S = np.diag([scale, scale, 1.0])
    P = S @ cameras.P.cpu().numpy().astype(np.float64)
    return Cameras.from_projection_matrices(
        P,
        widths=np.maximum(
            (cameras.width.cpu().numpy() * scale).astype(np.int32), 1
        ),
        heights=np.maximum(
            (cameras.height.cpu().numpy() * scale).astype(np.int32), 1
        ),
        device=cameras.device,
    )


def build_pyramid(images: torch.Tensor, cameras: Cameras, levels: int):
    """[(images, cameras)] from finest (level 0) to coarsest."""
    out = [(images, cameras)]
    for lvl in range(1, levels):
        images = downsample2(images)
        out.append((images, scale_cameras(cameras, 0.5**lvl)))
    return out


def densify_multiscale(
    scene_images: torch.Tensor,
    cameras: Cameras,
    seeds,
    config: PipelineConfig,
    metrics=None,
):
    """Coarse-to-fine expansion. `seeds` is a PatchState at full-resolution
    geometry (world space is scale-invariant; only textures change). With
    `metrics` (a `StageMetrics`), each level's seconds are recorded as stage
    `multiscale_level_<l>`.

    Returns the final PatchState (world-space, finest level).
    """
    from densepoints_tpu_torch.pmvs.expand import expand_patches
    from densepoints_tpu_torch.pmvs.filter import run_filters
    from densepoints_tpu_torch.pmvs.optimize import (
        filter_by_error,
        optimize_patches,
    )
    from densepoints_tpu_torch.utils import log

    levels = max(1, config.multiscale.levels)
    pyramid = build_pyramid(scene_images, cameras, levels)

    state = seeds
    for lvl in range(levels - 1, -1, -1):
        images_l, cams_l = pyramid[lvl]
        log.info(
            "multiscale level %d: %dx%d, %d patches in",
            lvl, int(cams_l.width[0]), int(cams_l.height[0]), state.capacity,
        )
        timer = (metrics.stage(f"multiscale_level_{lvl}") if metrics
                 else contextlib.nullcontext())
        with timer:
            if lvl != levels - 1:
                # Carried-over patches: refine against the finer textures.
                state = optimize_patches(
                    images_l, cams_l, state, config.seed.texture_size,
                    config.optimize,
                )
                state = filter_by_error(
                    images_l, cams_l, state, config.seed.texture_size,
                    config.optimize,
                ).compact()
            state, _ = expand_patches(
                images_l, cams_l, state, config.expand, config.organizer,
                config.optimize,
            )
            state = run_filters(
                cams_l, state, config.filter, config.optimize,
                config.organizer.grid_scale,
            ).compact()
    return state
