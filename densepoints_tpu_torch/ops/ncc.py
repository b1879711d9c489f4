"""Row-wise NCC of (N, L) texture pairs.

`ncc_pairs(a, b, mask=None)` -> (N,) f32: population statistics,
cov / max(sigma_a * sigma_b, 0.1); with a mask the statistics see only its
entries and a row whose mask is empty gets -1 (`core.scores.ncc_score`).

On CUDA tensors the wrapper launches the hand-written kernel in
`csrc/ncc_pairs.cu` or raises. On CPU tensors it runs `ncc_pairs_plain`.
`KERNEL_LAUNCHES` and `PLAIN_CALLS` count which ran. The kernel holds a
row in the registers of a group of 8, 16 or 32 lanes for L <= 256 and
loops over it with a warp above (see the source).
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.core.scores import ncc_score
from densepoints_tpu_torch.ops import _build

__all__ = [
    "ncc_pairs",
    "ncc_pairs_plain",
    "ncc_pairs_cuda",
    "KERNEL_LAUNCHES",
    "PLAIN_CALLS",
]

KERNEL_LAUNCHES = 0  # kernel launches, counted where the kernel launches
PLAIN_CALLS = 0  # calls answered by the plain torch version (CPU tensors)

_VP, _I64 = _build.VOID_P, _build.INT64
_ARGTYPES = (_VP, _VP, _VP, _I64, _I64, _VP, _VP)  # a b mask N L out stream


def ncc_pairs_plain(a: torch.Tensor, b: torch.Tensor, mask=None):
    """Plain torch version of the (N, L) -> (N,) contract."""
    return ncc_score(a, b, mask)


def ncc_pairs_cuda(a: torch.Tensor, b: torch.Tensor, mask=None):
    """Launch the CUDA kernel on the current stream.

    a, b and the optional mask: (N, L) f32, contiguous, on one CUDA device.
    Returns (N,) f32.
    """
    global KERNEL_LAUNCHES
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"ncc_pairs_cuda needs CUDA tensors, got {dev}")
    if a.ndim != 2 or a.shape[1] < 1:
        raise ValueError(f"a has shape {tuple(a.shape)}, expected (N, L >= 1)")
    N, L = a.shape
    _build.check_tensor("a", a, dev, torch.float32, (N, L))
    _build.check_tensor("b", b, dev, torch.float32, (N, L))
    if mask is not None:
        _build.check_tensor("mask", mask, dev, torch.float32, (N, L))
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    KERNEL_LAUNCHES += 1
    _build.launch(
        "ncc_pairs_launch", _ARGTYPES, dev,
        a.data_ptr(), b.data_ptr(),
        None if mask is None else mask.data_ptr(), N, L, out.data_ptr(),
    )
    return out


def ncc_pairs(a: torch.Tensor, b: torch.Tensor, mask=None):
    """(N,) NCC of the rows of a and b: the CUDA kernel for CUDA tensors,
    the plain torch version for CPU tensors. Inputs are cast to f32."""
    global PLAIN_CALLS
    if a.device.type == "cpu":
        PLAIN_CALLS += 1
        return ncc_pairs_plain(a, b, mask)
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    return ncc_pairs_cuda(f32(a), f32(b), None if mask is None else f32(mask))
