"""Patch texture extraction: projective warp + bilinear sampling.

The patch is a textured plane, so the square-to-image map is composed
analytically: texel (r, c) of a k x k texture lies at the world point

    X = p + (2c/k - 1) * sx + (2r/k - 1) * sy

which is projected and bilinearly sampled (clamp-to-edge against the full
image). Semantics:
  * x_axis = unit camera x axis of the REFERENCE view; y = n x x_axis,
    NOT normalized;
  * the world half-extent scale is (k // 2) / dx, dx = pixels per world
    x_axis unit at the patch in the reference view;
  * a view's texture is invalid if ANY of the 4 corners p +- sx +- sy
    projects outside that view (strict bounds).
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.core.cameras import Cameras

__all__ = ["bilinear_sample", "patch_frames", "patch_textures"]


def bilinear_sample(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with clamp-to-edge. image: (H, W); xy: (..., 2)."""
    H, W = image.shape
    x = xy[..., 0].clamp(0.0, W - 1.0)
    y = xy[..., 1].clamp(0.0, H - 1.0)
    x0 = torch.floor(x).long().clamp(0, max(W - 2, 0))
    y0 = torch.floor(y).long().clamp(0, max(H - 2, 0))
    dx = x - x0
    dy = y - y0
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)
    return (
        image[y0, x0] * (1 - dx) * (1 - dy)
        + image[y0, x1] * dx * (1 - dy)
        + image[y1, x0] * (1 - dx) * dy
        + image[y1, x1] * dx * dy
    )


def patch_frames(
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    texture_size: int,
):
    """(sx, sy): (B, 3) world-space half-texture axes of each patch, scaled
    so the patch spans texture_size // 2 px in the reference view along x."""
    x_axis = cameras.x_axis[ref]  # (B, 3), unit
    y_axis = torch.linalg.cross(normal, x_axis)  # NOT normalized
    K, R, C = cameras.K[ref], cameras.R[ref], cameras.C[ref]

    def _proj(pts):
        cam = torch.einsum("bij,bj->bi", R, pts - C)
        pix = torch.einsum("bij,bj->bi", K, cam)
        return pix[:, :2] / pix[:, 2:3]

    dx = torch.linalg.norm(_proj(position + x_axis) - _proj(position), dim=-1)
    scale = (texture_size // 2) / torch.clamp_min(dx, 1e-12)
    return scale[:, None] * x_axis, scale[:, None] * y_axis


def patch_textures(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    view_mask: torch.Tensor,
    texture_size: int,
    frames=None,
):
    """k x k textures of every patch in every (masked) view.

    images: (V, H, W) grayscale float; position/normal: (B, 3); ref: (B,);
    view_mask: (B, V). `frames` optionally passes precomputed (sx, sy).
    Returns (textures (B, V, k, k), valid (B, V)).
    """
    k = texture_size
    sx, sy = frames if frames is not None else patch_frames(
        cameras, position, normal, ref, k
    )
    coords = (
        2.0 * torch.arange(k, dtype=position.dtype, device=position.device) / k
    ) - 1.0
    tt, ss = torch.meshgrid(coords, coords, indexing="ij")  # rows = tt
    world = (
        position[:, None, None, :]
        + ss[None, :, :, None] * sx[:, None, None, :]
        + tt[None, :, :, None] * sy[:, None, None, :]
    )  # (B, k, k, 3)
    corners = position[:, None, :] + torch.stack(
        [-sx - sy, sx - sy, sx + sy, -sx + sy], dim=1
    )  # (B, 4, 3)
    pix_world = cameras.project(world)  # (V, B, k, k, 2)
    pix_corners = cameras.project(corners)  # (V, B, 4, 2)
    w = cameras.width.to(position.dtype)[:, None, None]
    h = cameras.height.to(position.dtype)[:, None, None]
    inside = (
        (pix_corners[..., 0] > 0)
        & (pix_corners[..., 0] < w)
        & (pix_corners[..., 1] > 0)
        & (pix_corners[..., 1] < h)
    )  # (V, B, 4)
    valid = inside.all(-1).T & view_mask  # (B, V)
    V = images.shape[0]
    tex = torch.stack(
        [bilinear_sample(images[v], pix_world[v]) for v in range(V)], dim=1
    )  # (B, V, k, k)
    textures = torch.where(valid[:, :, None, None], tex, 0.0)
    return textures, valid
