"""Batched plane-induced homographies and the 4-point DLT.

The hot path never builds a homography: a patch is a textured plane, so
`ops/warp.py` composes the square -> image map analytically per texel. The
4-point DLT is here for callers that need an explicit 3 x 3 H. A homography
is defined up to scale; `homography_from_4pts` returns it with H[2, 2] = 1.
"""
from __future__ import annotations

import torch

__all__ = ["homography_from_4pts", "apply_homography", "plane_homography"]


def _normalization_transform(pts: torch.Tensor):
    """Hartley similarity normalization: zero mean, sqrt(2) RMS radius.

    pts (..., N, 2) -> (T (..., 3, 3), normalized pts). Keeps the DLT
    normal matrix well conditioned in f32."""
    mean = pts.mean(dim=-2, keepdim=True)
    centered = pts - mean
    rms = torch.sqrt((centered**2).sum(dim=-1).mean(dim=-1))
    scale = 2.0**0.5 / torch.clamp_min(rms, 1e-12)
    normed = centered * scale[..., None, None]
    s = scale[..., None]
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack(
        [
            torch.cat([s, zero, -s * mean[..., 0, 0:1]], dim=-1),
            torch.cat([zero, s, -s * mean[..., 0, 1:2]], dim=-1),
            torch.cat([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return T, normed


def _homography_dlt_raw(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    x, y = src[..., 0], src[..., 1]  # (..., 4)
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    row_u = torch.stack(
        [x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], dim=-1
    )  # (..., 4, 9)
    row_v = torch.stack(
        [zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v], dim=-1
    )
    A = torch.cat([row_u, row_v], dim=-2)  # (..., 8, 9)
    AtA = torch.einsum("...ri,...rj->...ij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    h = vecs[..., 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def homography_from_4pts(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact homography mapping 4 src points to 4 dst points (batched).

    src, dst: (..., 4, 2). Hartley-normalized DLT on the 8 x 9 system,
    solved by the smallest eigenvector of the 9 x 9 normal matrix."""
    T_src, src_n = _normalization_transform(src)
    T_dst, dst_n = _normalization_transform(dst)
    Hn = _homography_dlt_raw(src_n, dst_n)
    H = torch.linalg.inv(T_dst) @ Hn @ T_src
    return H / H[..., 2:3, 2:3]


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """H: (..., 3, 3); pts: (..., N, 2) -> (..., N, 2)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = torch.einsum("...ij,...nj->...ni", H, ph)
    return out[..., :2] / out[..., 2:3]


def plane_homography(
    P: torch.Tensor, origin: torch.Tensor, ex: torch.Tensor, ey: torch.Tensor
) -> torch.Tensor:
    """Analytic homography from plane coordinates (s, t) to image pixels.

    The plane point is origin + s * ex + t * ey; its image under P is
    P @ [ex | ey | origin] applied to (s, t, 1), with P's last column added
    to the third. Batched over any leading axes of (P, origin, ex, ey)."""
    M = torch.stack([ex, ey, origin], dim=-1)  # (..., 3, 3) columns
    A = P[..., :, :3] @ M
    last = A[..., :, 2] + P[..., :, 3]
    return torch.cat([A[..., :, :2], last[..., None]], dim=-1)
