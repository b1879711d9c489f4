"""Visibility classification of patches against all views, and colours.

For every non-reference view whose image contains the patch position, the
angle between the patch normal and the ray (position - view centre)
classifies the view: angle < visible_angle -> truly visible, <
candidate_angle -> candidate. `compute_color` averages nearest-pixel
colours over all views containing the point.
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.core.cameras import Cameras

__all__ = ["classify_views", "compute_color"]


def classify_views(
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    visible_angle: float = 0.78,
    candidate_angle: float = 1.04,
):
    """(vis, cand) boolean masks of shape (B, V)."""
    inside = cameras.points_inside(position).T  # (B, V)
    rays = position[:, None, :] - cameras.C[None, :, :]  # (B, V, 3)
    ray_norm = torch.linalg.norm(rays, dim=-1)
    cosang = (normal[:, None, :] * rays).sum(-1) / torch.clamp_min(
        ray_norm, 1e-12
    )
    angle = torch.arccos(cosang.clamp(-1.0, 1.0))
    views = torch.arange(cameras.num_views, device=position.device)
    base = inside & (views[None, :] != ref[:, None])
    vis = base & (angle < visible_angle)
    cand = base & (angle >= visible_angle) & (angle < candidate_angle)
    return vis, cand


def compute_color(
    cameras: Cameras, colors: torch.Tensor, position: torch.Tensor
) -> torch.Tensor:
    """colors: (V, H, W, 3); position: (B, 3) -> (B, 3) float RGB.

    Nearest-pixel sampling by truncation toward zero."""
    pix = cameras.project(position)  # (V, B, 2)
    inside = cameras.points_inside(position)  # (V, B)
    H, W = colors.shape[1], colors.shape[2]
    x = pix[..., 0].to(torch.int64).clamp(0, W - 1)
    y = pix[..., 1].to(torch.int64).clamp(0, H - 1)
    views = torch.arange(colors.shape[0], device=position.device)[:, None]
    sampled = colors[views, y, x].to(torch.float32)  # (V, B, 3)
    w = inside.to(torch.float32)[..., None]
    total = (sampled * w).sum(dim=0)
    count = torch.clamp_min(w.sum(dim=0), 1.0)
    return total / count
