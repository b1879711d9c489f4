"""Photometric patch scores over the trailing axis (batched, mask-aware).

  * NCC = cov_pop(a, b) / max(sigma_a * sigma_b, 0.1) with population
    statistics (divide by N). Golden value: NCC(a3x3, b3x3) == 0.1005653.
  * NCC by channel: per-channel sum((a-am)(b-bm)) / max(sa*sb, 1e-3),
    summed over 3 channels, divided by (N * 3).
  * SSD = mean((a-b)^2), SAD = mean(|a-b|).
A mask with zero valid entries yields the -1 sentinel (NCC, SSD, SAD).
"""
from __future__ import annotations

import torch

__all__ = [
    "NCC_MIN_DENOM",
    "NCC_CHANNEL_MIN_DENOM",
    "EMPTY_SCORE",
    "ncc_score",
    "ssd_score",
    "sad_score",
    "ncc_score_by_channel",
]

NCC_MIN_DENOM = 0.1
NCC_CHANNEL_MIN_DENOM = 1e-3
EMPTY_SCORE = -1.0


def ncc_score(a: torch.Tensor, b: torch.Tensor, mask=None) -> torch.Tensor:
    """Normalized cross-correlation of (..., N) patches -> (...,)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if mask is None:
        n = torch.tensor(float(a.shape[-1]))
        ca = a - a.mean(-1, keepdim=True)
        cb = b - b.mean(-1, keepdim=True)
    else:
        m = mask.to(torch.float32)
        n = m.sum(-1).clamp_min(1.0)
        ca = (a - ((a * m).sum(-1) / n)[..., None]) * m
        cb = (b - ((b * m).sum(-1) / n)[..., None]) * m
    cov = (ca * cb).sum(-1) / n
    sa = torch.sqrt((ca * ca).sum(-1) / n)
    sb = torch.sqrt((cb * cb).sum(-1) / n)
    score = cov / torch.clamp_min(sa * sb, NCC_MIN_DENOM)
    if mask is not None:
        score = torch.where(mask.sum(-1) > 0, score, EMPTY_SCORE)
    return score


def _masked_mean(d: torch.Tensor, mask) -> torch.Tensor:
    """Mean of d over the trailing axis; with a mask, over its entries, and
    the -1 sentinel where it has none."""
    if mask is None:
        return d.mean(-1)
    m = mask.to(torch.float32)
    n = m.sum(-1)
    return torch.where(n > 0, (d * m).sum(-1) / n.clamp_min(1.0), EMPTY_SCORE)


def ssd_score(a: torch.Tensor, b: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean squared difference over the trailing axis."""
    return _masked_mean((a.to(torch.float32) - b.to(torch.float32)) ** 2, mask)


def sad_score(a: torch.Tensor, b: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean absolute difference over the trailing axis."""
    return _masked_mean((a.to(torch.float32) - b.to(torch.float32)).abs(), mask)


def ncc_score_by_channel(
    a: torch.Tensor, b: torch.Tensor, mask=None
) -> torch.Tensor:
    """Per-RGB-channel NCC, averaged. a, b: (..., N, 3); returns (...,):
    sum_c [ sum((a_c-am_c)(b_c-bm_c)) / max(sa_c*sb_c, 1e-3) ] / (N*3)."""
    ac = a.to(torch.float32).movedim(-1, 0)  # (3, ..., N)
    bc = b.to(torch.float32).movedim(-1, 0)
    if mask is None:
        n = float(a.shape[-2])
        ca = ac - ac.mean(-1, keepdim=True)
        cb = bc - bc.mean(-1, keepdim=True)
    else:
        m = mask.to(torch.float32)[None]
        n = m.sum(-1).clamp_min(1.0)  # (1, ...)
        ca = (ac - ((ac * m).sum(-1) / n)[..., None]) * m
        cb = (bc - ((bc * m).sum(-1) / n)[..., None]) * m
    num = (ca * cb).sum(-1)  # (3, ...)
    sa = torch.sqrt((ca * ca).sum(-1) / n)
    sb = torch.sqrt((cb * cb).sum(-1) / n)
    total = (num / torch.clamp_min(sa * sb, NCC_CHANNEL_MIN_DENOM)).sum(0)
    return total / (n if mask is None else n[0]) / 3.0
