"""Keypoint matching: Hamming 2-NN + Lowe ratio or an absolute cutoff, the
epipolar filter, and descriptor-free matching along epipolar lines.

Descriptors are +-1 vectors, so the N x M Hamming matrix of a view pair is
one f32 matrix product, (D - a.b) / 2. The products and sums of <= 2^24
+-1 terms are exact in f32, so `torch.matmul` gives exact integers here.
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.geometry.fundamental import (
    epipolar_distance_matrix,
    epipolar_lines,
    point_line_distance,
)

__all__ = [
    "hamming_distance_matrix",
    "match_pair",
    "match_pair_absolute",
    "filter_matches_epipolar",
    "direct_epipolar_pair",
    "direct_epipolar_pair_topk",
]

_BIG = 1e9


def hamming_distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor):
    """(..., N, M) Hamming distances between +-1 descriptor sets
    (..., N, D) and (..., M, D)."""
    D = desc1.shape[-1]
    return 0.5 * (D - torch.matmul(desc1, desc2.transpose(-1, -2)))


def _ranked_hamming(desc1, desc2, valid2, k: int):
    """The k nearest partners of every descriptor of view 1 by Hamming
    distance, lower index first among equals: (idx (..., N, k) int64,
    dist (..., N, k) f32, 1e9 for an invalid partner). The integer
    distances are ranked by the unique key dist * M + index, with invalid
    partners at distance D + 1, after every valid one."""
    D = desc1.shape[-1]
    ham = hamming_distance_matrix(desc1, desc2)  # (..., N, M)
    M = ham.shape[-1]
    if (D + 2) * M >= 2**31:
        raise ValueError(f"{M} keypoints x {D} bits overflow the int32 key")
    valid_m = valid2[..., None, :]
    cols = torch.arange(M, device=ham.device, dtype=torch.int32)
    key = torch.where(valid_m, ham, D + 1).to(torch.int32) * M + cols
    if k == 1:
        top_key = key.amin(dim=-1, keepdim=True)
    else:
        top_key, _ = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    idx = (top_key % M).to(torch.int64)
    return idx, torch.where(valid_m, ham, _BIG).gather(-1, idx)


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
    equal distances the lower index ranks first, as jax.lax.top_k does
    (`_ranked_hamming`).
    """
    idx, dist = _ranked_hamming(desc1, desc2, valid2, 2)
    d1, d2 = dist[..., 0], dist[..., 1]
    ok = valid1 & (d1 < lowe_ratio * d2) & (d2 < _BIG)
    return torch.where(ok, idx[..., 0], -1), d1


def match_pair_absolute(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    max_distance: float = 30.0,
):
    """Nearest-neighbour matching with an absolute Hamming-distance cutoff,
    batched over leading pair axes: the exact 1-NN, kept where its distance
    is below `max_distance`; the first of equal minima wins, as
    `jnp.argmin` has it. Returns (match_idx (..., N) int64 or -1, distance
    (..., N) f32)."""
    idx, dist = _ranked_hamming(desc1, desc2, valid2, 1)
    best, dbest = idx[..., 0], dist[..., 0]
    ok = valid1 & (dbest < max_distance)
    return torch.where(ok, best, -1), dbest


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


def _masked_epipolar_distances(F, xy1, xy2, valid2):
    dist = epipolar_distance_matrix(F, xy1, xy2)  # (..., N, M)
    return torch.where(valid2[..., None, :], dist, _BIG)


def direct_epipolar_pair(
    F: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    max_distance: float = 1.5,
):
    """Descriptor-free epipolar matching: each keypoint of view 1 takes the
    keypoint of view 2 closest to its epipolar line, if within
    `max_distance` px. `torch.argmin` returns the first of equal minima, as
    `jnp.argmin` does. Returns (match_idx (..., N) int64 or -1, distance
    (..., N) f32)."""
    dist = _masked_epipolar_distances(F, xy1, xy2, valid2)
    best = torch.argmin(dist, dim=-1)
    dbest = dist.gather(-1, best[..., None])[..., 0]
    ok = valid1 & (dbest <= max_distance)
    return torch.where(ok, best, -1), dbest


def direct_epipolar_pair_topk(
    F: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    max_distance: float = 1.5,
    k: int = 4,
):
    """All-pairs direct epipolar matching with a fixed shape: the k
    partners closest to the epipolar line, each kept if within
    `max_distance` px. Ranked by k rounds of argmin, each striking its
    pick out, so equal distances rank by the lower index as
    `jax.lax.top_k` ranks them (`torch.topk` promises no tie order).
    Returns (match_idx (..., N, k) int64 or -1, distance (..., N, k) f32)."""
    dist = _masked_epipolar_distances(F, xy1, xy2, valid2)
    if k > dist.shape[-1]:
        raise ValueError(f"k {k} exceeds the {dist.shape[-1]} keypoints")
    idx, d = [], []
    for _ in range(k):
        best = torch.argmin(dist, dim=-1, keepdim=True)
        idx.append(best)
        d.append(dist.gather(-1, best))
        dist = dist.scatter(-1, best, float("inf"))
    idx, d = torch.cat(idx, dim=-1), torch.cat(d, dim=-1)
    ok = valid1[..., None] & (d <= max_distance)
    return torch.where(ok, idx, -1), d
