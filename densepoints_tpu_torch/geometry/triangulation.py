"""Batched, masked direct linear triangulation (DLT).

Each observation contributes two rows (x P_2 - P_0, y P_2 - P_1), scaled to
unit norm (preconditioning for f32); invalid rows are zeroed, so the
solution is the masked DLT. The point is the eigenvector of the smallest
eigenvalue of the 4x4 normal matrix A^T A (`torch.linalg.eigh`, ascending).
"""
from __future__ import annotations

import torch

__all__ = ["triangulate", "triangulate_pair"]


def triangulate(
    P: torch.Tensor, observations: torch.Tensor, mask=None
) -> torch.Tensor:
    """P: (B, V, 3, 4) or (V, 3, 4); observations: (B, V, 2); mask:
    optional (B, V) validity (>= 2 views for a meaningful solution).
    Returns (B, 3) world points."""
    if P.ndim == 3:
        P = P[None].expand(observations.shape[:1] + P.shape)
    x = observations[..., 0:1]
    y = observations[..., 1:2]
    rows = torch.stack(
        [x * P[..., 2, :] - P[..., 0, :], y * P[..., 2, :] - P[..., 1, :]],
        dim=-2,
    )  # (B, V, 2, 4)
    rows = rows / torch.clamp_min(
        torch.linalg.norm(rows, dim=-1, keepdim=True), 1e-12
    )
    if mask is not None:
        rows = rows * mask[..., None, None].to(rows.dtype)
    A = rows.reshape(rows.shape[0], -1, 4)
    AtA = torch.einsum("bri,brj->bij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    X = vecs[..., 0]
    return X[..., :3] / X[..., 3:4]


def triangulate_pair(
    P1: torch.Tensor, x1: torch.Tensor, P2: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Two-view convenience wrapper: P1, P2 (3, 4); x1, x2 (B, 2) -> (B, 3)."""
    B = x1.shape[0]
    P = torch.stack([P1.expand(B, 3, 4), P2.expand(B, 3, 4)], dim=1)
    return triangulate(P, torch.stack([x1, x2], dim=1))
