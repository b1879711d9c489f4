"""Keypoint matching: Hamming 2-NN + Lowe ratio, and the epipolar filter.

Descriptors are +-1 vectors, so the N x M Hamming matrix of a view pair is
one f32 matrix product, (D - a.b) / 2. The products and sums of <= 2^24
+-1 terms are exact in f32, so `torch.matmul` gives exact integers here.
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.geometry.fundamental import (
    epipolar_lines,
    point_line_distance,
)

__all__ = ["hamming_distance_matrix", "match_pair", "filter_matches_epipolar"]

_BIG = 1e9


def hamming_distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor):
    """(..., N, M) Hamming distances between +-1 descriptor sets
    (..., N, D) and (..., M, D)."""
    D = desc1.shape[-1]
    return 0.5 * (D - torch.matmul(desc1, desc2.transpose(-1, -2)))


def match_pair(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    lowe_ratio: float = 0.7,
):
    """kNN(2) + Lowe ratio matching, batched over leading pair axes.

    desc: (..., N, D); valid: (..., N). Returns (match_idx (..., N) int64,
    index into view 2's keypoints or -1, distance (..., N) f32). Among
    equal distances the lower index ranks first, as jax.lax.top_k does:
    the integer distances are ranked by the unique key dist * M + index,
    with invalid partners at distance D + 1, after every valid one.
    """
    D = desc1.shape[-1]
    ham = hamming_distance_matrix(desc1, desc2)  # (..., N, M)
    M = ham.shape[-1]
    if (D + 2) * M >= 2**31:
        raise ValueError(f"{M} keypoints x {D} bits overflow the int32 key")
    valid_m = valid2[..., None, :]
    cols = torch.arange(M, device=ham.device, dtype=torch.int32)
    key = torch.where(valid_m, ham, D + 1).to(torch.int32) * M + cols
    top_key, _ = torch.topk(key, 2, dim=-1, largest=False, sorted=True)
    idx = (top_key % M).to(torch.int64)
    dist = torch.where(valid_m, ham, _BIG).gather(-1, idx)
    d1, d2 = dist[..., 0], dist[..., 1]
    ok = valid1 & (d1 < lowe_ratio * d2) & (d2 < _BIG)
    return torch.where(ok, idx[..., 0], -1), d1


def filter_matches_epipolar(
    F: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    match_idx: torch.Tensor,
    max_distance: float = 1.5,
):
    """Drop matches whose partner lies too far from the epipolar line.

    F: (..., 3, 3) with x2^T F x1 = 0; xy1: (..., N, 2); xy2: (..., M, 2);
    match_idx: (..., N) into xy2 or -1. Returns the filtered match_idx."""
    lines = epipolar_lines(F, xy1)  # (..., N, 3)
    partner = xy2.gather(
        -2, match_idx.clamp_min(0)[..., None].expand(*match_idx.shape, 2)
    )
    dist = point_line_distance(lines, partner)
    ok = (match_idx >= 0) & (dist <= max_distance)
    return torch.where(ok, match_idx, -1)
