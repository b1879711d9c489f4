"""Photometric NCC score over the trailing axis.

NCC = cov_pop(a, b) / max(sigma_a * sigma_b, 0.1) with population
statistics (divide by N). Golden value: NCC(a3x3, b3x3) == 0.1005653.
A mask with zero valid entries yields the -1 sentinel.
"""
from __future__ import annotations

import torch

__all__ = ["NCC_MIN_DENOM", "EMPTY_SCORE", "ncc_score"]

NCC_MIN_DENOM = 0.1
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
