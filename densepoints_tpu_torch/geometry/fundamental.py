"""Fundamental matrices (host, float64) and batched epipolar geometry.

F from two projection matrices per Hartley-Zisserman p.244; epipolar lines
as (a, b, c) coefficient triples; point-line distances
|ax + by + c| / sqrt(a^2 + b^2) for whole keypoint matrices at once.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "fundamental_from_projections",
    "fundamental_matrices_for_pairs",
    "epipolar_lines",
    "point_line_distance",
    "epipolar_distance_matrix",
]


def fundamental_from_projections(P1: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """F with x2^T F x1 = 0: C = nullspace(P1), e' = P2 C,
    F = [e']_x P2 pinv(P1)."""
    P1 = np.asarray(P1, np.float64)
    P2 = np.asarray(P2, np.float64)
    _, _, vt = np.linalg.svd(P1)
    e_p = P2 @ vt[-1]
    e_x = np.array(
        [
            [0.0, -e_p[2], e_p[1]],
            [e_p[2], 0.0, -e_p[0]],
            [-e_p[1], e_p[0], 0.0],
        ]
    )
    return e_x @ P2 @ np.linalg.pinv(P1)


def fundamental_matrices_for_pairs(P_all: np.ndarray, pairs) -> np.ndarray:
    """(num_pairs, 3, 3) unit-norm F matrices for (num_pairs, 2) pairs."""
    P_all = np.asarray(P_all, np.float64)
    out = np.zeros((len(pairs), 3, 3))
    for i, (a, b) in enumerate(pairs):
        F = fundamental_from_projections(P_all[a], P_all[b])
        n = np.linalg.norm(F)
        out[i] = F / (n if n > 0 else 1.0)
    return out


def epipolar_lines(F: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Lines l' = F x in the second image: F (..., 3, 3), points
    (..., N, 2) -> (..., N, 3)."""
    ph = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.einsum("...ij,...nj->...ni", F, ph)


def point_line_distance(lines: torch.Tensor, points: torch.Tensor):
    """|ax + by + c| / sqrt(a^2 + b^2), broadcast over leading axes."""
    a, b, c = lines[..., 0], lines[..., 1], lines[..., 2]
    num = torch.abs(a * points[..., 0] + b * points[..., 1] + c)
    return num / torch.clamp_min(torch.sqrt(a * a + b * b), 1e-12)


def epipolar_distance_matrix(
    F: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor
) -> torch.Tensor:
    """All-pairs point-to-epipolar-line distances: F (..., 3, 3), pts1
    (..., N, 2), pts2 (..., M, 2) -> (..., N, M); entry (i, j) is the
    distance of pts2[j] to the epipolar line of pts1[i]."""
    lines = epipolar_lines(F, pts1)  # (..., N, 3)
    return point_line_distance(lines[..., :, None, :], pts2[..., None, :, :])
