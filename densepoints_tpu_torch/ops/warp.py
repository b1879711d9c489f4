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

__all__ = [
    "bilinear_sample",
    "patch_frames",
    "texel_homography",
    "homography_pixels",
    "patch_textures",
    "compact_visible",
    "patch_textures_indexed",
]


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


def texel_homography(
    cameras: Cameras,
    position: torch.Tensor,
    sx: torch.Tensor,
    sy: torch.Tensor,
    texture_size: int,
):
    """The texel homography of every (view, patch), as the CUDA kernels
    form it once per (patch, view). A plain version for tests; no path
    calls it.

    The world point of texel (r, c) is affine in (c, r), so its homogeneous
    pixel is A + c * B + r * Cc with A = K (R ((p - sx - sy) - C)),
    B = K (R (sx * 2 / k)), Cc = K (R (sy * 2 / k)), the decomposed order
    of `Cameras.project`. The columns are formed in f64 and kept relative
    to an origin pixel near the patch (the f32 pixel of its centre), so
    that  pix = origin + (a + c * b + r * cc) / (A2 + c * B2 + r * C2)
    has a quotient of a few pixels and carries one f32 rounding at its own
    magnitude. Returns f32 tensors (origin (V, B, 2), numerator (V, B, 3, 2)
    holding a, b, cc for x and y, denominator (V, B, 3) holding A2, B2, C2).
    """
    k = texture_size
    K, R, C = cameras.K.double(), cameras.R.double(), cameras.C.double()
    p, ax, ay = position.double(), sx.double(), sy.double()

    def _kr(vec):  # (V, B, 3) world vectors -> (V, B, 3) homogeneous pixels
        return torch.einsum("vij,vbj->vbi", K, torch.einsum(
            "vij,vbj->vbi", R, vec))

    V = cameras.num_views
    step = 2.0 / k
    cols = torch.stack([
        _kr(((p - ax) - ay)[None] - C[:, None, :]),
        _kr((ax * step).expand(V, -1, -1)),
        _kr((ay * step).expand(V, -1, -1)),
    ], dim=2)  # (V, B, 3 columns, 3 coordinates)
    centre = cols.float()
    centre = centre[:, :, 0] + (0.5 * k) * (centre[:, :, 1] + centre[:, :, 2])
    origin = centre[..., :2] / centre[..., 2:3]  # (V, B, 2), f32
    numerator = cols[..., :2] - origin.double()[:, :, None, :] * cols[..., 2:3]
    return origin, numerator.float(), cols[..., 2].float()


def homography_pixels(origin, numerator, denominator, texture_size: int):
    """Pixels (V, B, k, k, 2), f32, of the k x k texel grid from the parts
    `texel_homography` returns: one reciprocal per texel."""
    idx = torch.arange(texture_size, dtype=origin.dtype, device=origin.device)
    col = idx[None, None, None, :]
    row = idx[None, None, :, None]
    a, b, c = (numerator[:, :, i, None, None, :] for i in range(3))
    num = (a + col[..., None] * b) + row[..., None] * c  # (V, B, k, k, 2)
    a2, b2, c2 = (denominator[:, :, i, None, None] for i in range(3))
    inv = 1.0 / ((a2 + col * b2) + row * c2)  # (V, B, k, k)
    return origin[:, :, None, None, :] + num * inv[..., None]


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


def compact_visible(vis: torch.Tensor, max_views: int):
    """Compact each patch's visible-view set into M = min(V, max_views) slots.

    vis: (B, V) -> (view_ids (B, M) int32, ok (B, M) bool). Slot 0 is the
    FIRST visible view (the anchor); slots are in ascending view order,
    invisible views behind the visible ones (a stable sort); ok marks the
    visible slots.
    """
    M = min(vis.shape[1], max_views)
    order = torch.argsort((~vis).to(torch.uint8), dim=1, stable=True)[:, :M]
    return order.to(torch.int32), torch.gather(vis, 1, order)


def _bilinear_flat(images_flat, H, W, view_ids, xy):
    """Bilinear sample with a view per element, clamp-to-edge within each
    view's H x W page. images_flat: (V*H*W,); view_ids: (...,) int64
    broadcastable against xy (..., 2)."""
    x = xy[..., 0].clamp(0.0, W - 1.0)
    y = xy[..., 1].clamp(0.0, H - 1.0)
    x0 = torch.floor(x).long().clamp(0, W - 2)
    y0 = torch.floor(y).long().clamp(0, H - 2)
    dx = x - x0
    dy = y - y0
    base = view_ids * (H * W) + y0 * W + x0
    return (
        images_flat[base] * (1 - dx) * (1 - dy)
        + images_flat[base + 1] * dx * (1 - dy)
        + images_flat[base + W] * (1 - dx) * dy
        + images_flat[base + W + 1] * dx * dy
    )


def patch_textures_indexed(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    view_ids: torch.Tensor,
    view_ok: torch.Tensor,
    texture_size: int,
    frames=None,
):
    """Textures of each patch in its OWN (compacted) view list, so work
    scales with the slots per patch, not with the scene's view count.

    images: (V, H, W); view_ids: (B, M) integer; view_ok: (B, M) bool.
    `frames` optionally passes precomputed (sx, sy).
    Returns (textures (B, M, k, k), valid (B, M)).
    """
    k = texture_size
    V, H, W = images.shape
    sx, sy = frames if frames is not None else patch_frames(
        cameras, position, normal, ref, k
    )
    coords = (
        2.0 * torch.arange(k, dtype=position.dtype, device=position.device) / k
    ) - 1.0
    tt, ss = torch.meshgrid(coords, coords, indexing="ij")
    world = (
        position[:, None, None, :]
        + ss[None, :, :, None] * sx[:, None, None, :]
        + tt[None, :, :, None] * sy[:, None, None, :]
    ).reshape(-1, k * k, 3)  # (B, k*k, 3)
    corners = position[:, None, :] + torch.stack(
        [-sx - sy, sx - sy, sx + sy, -sx + sy], dim=1
    )  # (B, 4, 3)

    # Per-(patch, slot) camera parameters.
    ids = view_ids.long()
    K, R, C = cameras.K[ids], cameras.R[ids], cameras.C[ids]  # (B, M, ...)
    w = cameras.width.to(position.dtype)[ids]  # (B, M)
    h = cameras.height.to(position.dtype)[ids]

    def _proj(pts):  # (B, n, 3) -> (B, M, n, 2)
        rel = pts[:, None, :, :] - C[:, :, None, :]
        cam = torch.einsum("bmij,bmnj->bmni", R, rel)
        pix = torch.einsum("bmij,bmnj->bmni", K, cam)
        return pix[..., :2] / pix[..., 2:3]

    pix_corners = _proj(corners)  # (B, M, 4, 2)
    inside = (
        (pix_corners[..., 0] > 0)
        & (pix_corners[..., 0] < w[..., None])
        & (pix_corners[..., 1] > 0)
        & (pix_corners[..., 1] < h[..., None])
    )
    valid = inside.all(-1) & view_ok  # (B, M)
    tex = _bilinear_flat(
        images.reshape(-1), H, W, ids[:, :, None], _proj(world)
    )  # (B, M, k*k)
    textures = tex.reshape(tex.shape[0], tex.shape[1], k, k)
    return torch.where(valid[:, :, None, None], textures, 0.0), valid
