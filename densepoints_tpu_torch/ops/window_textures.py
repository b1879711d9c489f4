"""Centred window-relative textures per slot, with ablation variants.

Slot s samples `n_real` texels at (xs, ys)[s, :n_real] inside the `win_h`-row
window at row `row0[s]` of page `page[s]` of a (P, R, W) page stack; the
window spans the page's width. Sampling is that of `ops.window_ncc` (taps
outside the window or the page contribute zero). The texture's mean is
subtracted; a dead slot (`page[s]` < 0) gets zeros. This is the first half
of the all-views scoring pass, held apart to be timed.

`window_centered_textures` launches the hand-written kernel in
`csrc/window_textures.cu` on CUDA tensors or raises; on CPU tensors it runs
`window_centered_textures_plain`. `KERNEL_LAUNCHES` and `PLAIN_CALLS` count
which ran. `full` is a warp per slot; `noload`, `noreduce` and `bare` switch
one cost centre of it off and exist to be timed (no CPU version); `block` is
the first body (a block per slot) and `staged` that body with the window in
shared memory (see the source). `SCORING_VARIANTS` compute the textures.
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.ops import _build
from densepoints_tpu_torch.ops.window_ncc import (
    check_offsets,
    check_smem,
    window_samples,
)

__all__ = [
    "window_centered_textures",
    "window_centered_textures_plain",
    "window_centered_textures_cuda",
    "VARIANTS",
    "SCORING_VARIANTS",
    "KERNEL_LAUNCHES",
    "PLAIN_CALLS",
]

KERNEL_LAUNCHES = 0  # kernel launches, counted where the kernel launches
PLAIN_CALLS = 0  # calls answered by the plain torch version (CPU tensors)

VARIANTS = ("full", "noload", "noreduce", "bare", "staged", "block")
SCORING_VARIANTS = ("full", "staged", "block")

_VP, _I64, _INT = _build.VOID_P, _build.INT64, _build.INT
_ARGTYPES = (
    _VP, _I64, _I64, _I64,  # pages, P, R, W
    _VP, _VP, _VP, _VP,  # page, row0, xs, ys
    _I64, _I64, _INT, _INT,  # N, S, n, win_h
    _VP, _VP,  # out, stream
)


def _check_variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")


def _check_shapes(pages, page, xs, n_real, win_h, variant):
    """Raise `ValueError` unless the kernel takes these shapes; shapes only,
    so it runs before any launch and on any device. Returns (P, R, W, N, S,
    n)."""
    if pages.ndim != 3 or page.ndim != 1 or xs.ndim != 2:
        raise ValueError(
            f"expected pages (P, R, W), page (N,), xs (N, S); got "
            f"{tuple(pages.shape)}, {tuple(page.shape)}, {tuple(xs.shape)}"
        )
    P, R, W = pages.shape
    N = page.shape[0]
    S = xs.shape[1]
    n = int(n_real)
    if not 1 <= n <= S:
        raise ValueError(f"n_real {n} outside 1..{S} (the lanes of xs)")
    if win_h < 1:
        raise ValueError(f"win_h {win_h} must be >= 1")
    check_offsets(win_h, W, W)
    # The warp body keeps nothing in shared memory.
    floats = {"block": n, "staged": n + win_h * W}.get(variant, 0)
    check_smem(variant, floats, f"n_real {n}, window {win_h} x {W}")
    return P, R, W, N, S, n


def window_centered_textures_plain(
    pages: torch.Tensor,
    page: torch.Tensor,
    row0: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    n_real: int,
    win_h: int = 56,
):
    """Plain torch version of the (N, n_real) contract, on any device."""
    live = (page >= 0) & (page < pages.shape[0])
    tex = window_samples(
        pages, row0, torch.zeros_like(row0), xs[:, :n_real], ys[:, :n_real],
        win_h, pages.shape[2], page=torch.where(live, page, 0),
    )
    centred = tex - tex.mean(dim=-1, keepdim=True)
    return torch.where(live[:, None], centred, 0.0)


def window_centered_textures_cuda(
    pages: torch.Tensor,
    page: torch.Tensor,
    row0: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    n_real: int,
    win_h: int = 56,
    variant: str = "full",
):
    """Launch one variant of the CUDA kernel on the current stream.

    pages (P, R, W) f32; page, row0 (N,) int32; xs, ys (N, S) f32 with
    S >= n_real (lanes past n_real are not read); all contiguous on one
    CUDA device. Returns textures (N, n_real) f32."""
    global KERNEL_LAUNCHES
    _check_variant(variant)
    P, R, W, N, S, n = _check_shapes(pages, page, xs, n_real, win_h, variant)
    dev = pages.device
    if dev.type != "cuda":
        raise ValueError(
            f"window_centered_textures_cuda needs CUDA tensors, got {dev}"
        )
    check = _build.check_tensor
    check("pages", pages, dev, torch.float32, (P, R, W))
    check("page", page, dev, torch.int32, (N,))
    check("row0", row0, dev, torch.int32, (N,))
    check("xs", xs, dev, torch.float32, (N, S))
    check("ys", ys, dev, torch.float32, (N, S))
    out = torch.empty((N, n), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    KERNEL_LAUNCHES += 1
    _build.launch(
        "window_textures_" + variant, _ARGTYPES, dev,
        pages.data_ptr(), P, R, W, page.data_ptr(), row0.data_ptr(),
        xs.data_ptr(), ys.data_ptr(), N, S, n, int(win_h), out.data_ptr(),
    )
    return out


def window_centered_textures(
    pages: torch.Tensor,
    page: torch.Tensor,
    row0: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    n_real: int,
    win_h: int = 56,
    variant: str = "full",
):
    """textures (N, n_real): the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors (texture-computing variants only)."""
    global PLAIN_CALLS
    _check_variant(variant)
    if pages.device.type == "cpu":
        if variant not in SCORING_VARIANTS:
            raise ValueError(
                f"variant {variant!r} only bounds a cost of the CUDA kernel "
                "and has no CPU version"
            )
        PLAIN_CALLS += 1
        return window_centered_textures_plain(
            pages, page, row0, xs, ys, n_real, win_h
        )
    c = lambda t, dt: t.to(dt).contiguous()  # noqa: E731
    f32, i32 = torch.float32, torch.int32
    return window_centered_textures_cuda(
        c(pages, f32), c(page, i32), c(row0, i32), c(xs, f32), c(ys, f32),
        n_real, win_h, variant,
    )
