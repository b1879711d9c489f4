"""Keypoint matching: Hamming 2-NN + Lowe ratio or an absolute cutoff, the
epipolar filter, and descriptor-free matching along epipolar lines.

Descriptors are +-1 vectors, so the N x M Hamming matrix of a view pair is
(D - a.b) / 2. The ranked partners of the Hamming matchers
(`ranked_hamming`) come on a CUDA tensor from M1, the hand-written kernel
in `csrc/hamming_topk.cu` (built with nvcc for sm_90a at first use and
bound with ctypes by `ops/_build.py`), which takes every pair of views in
one launch and keeps the N x M matrix out of device memory; there is no
fallback. On a CPU tensor they come from `_ranked_hamming`, the plain
version: one f32 matrix product (the products and sums of <= 2^24 +-1
terms are exact in f32, so `torch.matmul` gives exact integers) and a
top-k. The two agree bitwise. `KERNEL_LAUNCHES` counts M1's launches,
`PLAIN_CALLS` the calls the plain version answered, and `MATCH_PAIRS` the
view pairs M1 scored (`counts`, `count_since`).
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.geometry.fundamental import (
    epipolar_distance_matrix,
    epipolar_lines,
    point_line_distance,
)
from densepoints_tpu_torch.ops import _build

__all__ = [
    "hamming_distance_matrix",
    "ranked_hamming",
    "hamming_topk_cuda",
    "match_pair",
    "match_pair_absolute",
    "filter_matches_epipolar",
    "direct_epipolar_pair",
    "direct_epipolar_pair_topk",
    "KERNEL_LAUNCHES",
    "PLAIN_CALLS",
    "MATCH_PAIRS",
    "counts",
    "count_since",
]

_BIG = 1e9
KERNEL_LAUNCHES = 0  # M1 launches
PLAIN_CALLS = 0  # calls answered by the plain version (CPU tensors)
MATCH_PAIRS = 0  # view pairs scored by M1, summed

_VP, _I64 = _build.VOID_P, _build.INT64
_M1_ARGTYPES = (
    _VP, _VP, _VP, _VP, _VP,  # q, c, valid, a, b
    _VP, _VP,  # idx, dist
    _I64, _I64, _I64, _I64,  # VQ, VC, P, N
    _I64, _I64, _I64, _I64,  # M, D, row, k
    _VP,  # stream
)


def counts() -> dict:
    """M1's counter, under the name `StageMetrics` reports."""
    return {"seed_match_pairs": MATCH_PAIRS}


def count_since(metrics, before: dict):
    """Set the counts since `before` (a `counts()`) as `metrics`'
    counters."""
    for name, value in counts().items():
        metrics.count(name, value - before[name])


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
    _check_key(D, M)
    valid_m = valid2[..., None, :]
    cols = torch.arange(M, device=ham.device, dtype=torch.int32)
    key = torch.where(valid_m, ham, D + 1).to(torch.int32) * M + cols
    if k == 1:
        top_key = key.amin(dim=-1, keepdim=True)
    else:
        top_key, _ = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    idx = (top_key % M).to(torch.int64)
    return idx, torch.where(valid_m, ham, _BIG).gather(-1, idx)


def _check_key(D: int, M: int):
    if (D + 2) * M >= 2**31:
        raise ValueError(f"{M} keypoints x {D} bits overflow the int32 key")


def _operand(desc):
    """+-1 descriptors as M1 reads them: int8, contiguous, rows padded by
    zeros to a multiple of 16 bytes."""
    desc = desc.to(torch.int8)
    pad = -desc.shape[-1] % 16
    if pad:
        desc = torch.nn.functional.pad(desc, (0, pad))
    return desc.contiguous()


def hamming_topk_cuda(desc1, desc2, valid2, k: int, pairs=None):
    """`ranked_hamming` on a CUDA device: one launch of M1
    (`csrc/hamming_topk.cu`) for all pairs. Raises `ValueError` for what
    M1 does not take: k other than 1 or 2, fewer than k candidates, or a
    key that overflows int32 (as `_ranked_hamming`). Any number of bits:
    M1 takes rows past 256 bits in slices."""
    D = desc1.shape[-1]
    if desc2.shape[-1] != D:
        raise ValueError(f"descriptors of {D} and {desc2.shape[-1]} bits")
    if k not in (1, 2):
        raise ValueError(f"M1 ranks k = 1 or 2 partners, not {k}")
    dev = desc1.device
    for name, t in (("desc2", desc2), ("valid2", valid2)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, desc1 on {dev}")
    if pairs is None:
        lead = torch.broadcast_shapes(desc1.shape[:-2], desc2.shape[:-2],
                                      valid2.shape[:-1])
        N, M = desc1.shape[-2], desc2.shape[-2]
        desc1 = desc1.expand(*lead, N, D).reshape(-1, N, D)
        desc2 = desc2.expand(*lead, M, D).reshape(-1, M, D)
        valid2 = valid2.expand(*lead, M).reshape(-1, M)
        a = b = torch.arange(desc1.shape[0], device=dev)
        shape = (*lead, N, k)
    else:
        a, b = (t.to(device=dev, dtype=torch.int64).contiguous()
                for t in pairs)
        if a.shape != b.shape or a.ndim != 1:
            raise ValueError(f"pairs of shapes {tuple(a.shape)}, "
                             f"{tuple(b.shape)}: expected two (P,)")
        shape = (a.shape[0], desc1.shape[1], k)
    (VQ, N, _), (VC, M, _) = desc1.shape, desc2.shape
    if tuple(valid2.shape) != (VC, M):
        raise ValueError(f"valid2 has shape {tuple(valid2.shape)}, "
                         f"expected {(VC, M)}")
    if M < k:
        raise ValueError(f"{k} partners asked of {M} candidates")
    _check_key(D, M)
    q, c = _operand(desc1), _operand(desc2)
    valid2 = valid2.to(device=dev, dtype=torch.uint8).contiguous()
    P = a.shape[0]
    idx = torch.empty((P, N, k), dtype=torch.int64, device=dev)
    dist = torch.empty((P, N, k), dtype=torch.float32, device=dev)
    if P and N:
        _build.count_launch(__name__)
        _build.count_launch(f"{__name__}:MATCH_PAIRS", P)
        _build.launch(
            "hamming_topk_launch", _M1_ARGTYPES, dev,
            q.data_ptr(), c.data_ptr(), valid2.data_ptr(), a.data_ptr(),
            b.data_ptr(), idx.data_ptr(), dist.data_ptr(), VQ, VC, P, N, M,
            D, q.shape[-1], k)
    return idx.reshape(shape), dist.reshape(shape)


def ranked_hamming(desc1, desc2, valid2, k: int, pairs=None):
    """`_ranked_hamming`'s contract on any device: M1 on a CUDA tensor
    (`hamming_topk_cuda`), the plain version on a CPU one; bitwise the
    same. Descriptors are +-1, in f32 or int8. With `pairs` = (a, b),
    int64 (P,), desc1 (V1, N, D), desc2 (V2, M, D) and valid2 (V2, M) are
    stacks of views, and pair p ranks view b[p]'s descriptors for each of
    view a[p]'s: (idx, dist) (P, N, k), with no per-pair copy on the
    card."""
    global PLAIN_CALLS
    if desc1.device.type == "cuda":
        return hamming_topk_cuda(desc1, desc2, valid2, k, pairs)
    PLAIN_CALLS += 1
    if pairs is not None:
        a, b = pairs
        desc1, desc2, valid2 = desc1[a], desc2[b], valid2[b]
    return _ranked_hamming(desc1.to(torch.float32),
                           desc2.to(torch.float32), valid2, k)


def match_pair(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    lowe_ratio: float = 0.7,
    pairs=None,
):
    """kNN(2) + Lowe ratio matching, batched over leading pair axes.

    desc: (..., N, D); valid: (..., N). Returns (match_idx (..., N) int64,
    index into view 2's keypoints or -1, distance (..., N) f32). Among
    equal distances the lower index ranks first, as jax.lax.top_k does
    (`ranked_hamming`). With `pairs` = (a, b), the inputs are stacks of
    views and pair p matches view a[p] against view b[p] (P, N).
    """
    idx, dist = ranked_hamming(desc1, desc2, valid2, 2, pairs)
    if pairs is not None:
        valid1 = valid1[pairs[0]]
    d1, d2 = dist[..., 0], dist[..., 1]
    ok = valid1 & (d1 < lowe_ratio * d2) & (d2 < _BIG)
    return torch.where(ok, idx[..., 0], -1), d1


def match_pair_absolute(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    max_distance: float = 30.0,
    pairs=None,
):
    """Nearest-neighbour matching with an absolute Hamming-distance cutoff,
    batched over leading pair axes: the exact 1-NN, kept where its distance
    is below `max_distance`; the first of equal minima wins, as
    `jnp.argmin` has it. Returns (match_idx (..., N) int64 or -1, distance
    (..., N) f32). `pairs` as in `match_pair`."""
    idx, dist = ranked_hamming(desc1, desc2, valid2, 1, pairs)
    if pairs is not None:
        valid1 = valid1[pairs[0]]
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
