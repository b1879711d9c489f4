"""Window-relative sampling + NCC against slot 0, with ablation variants.

Patch b carries M slots. Slot m samples `n_real` texels at
(xs, ys)[b, m, :n_real] inside the `win_h` x `win_w` window whose corner is
(row0, x0)[b, m] of a row-flattened image stack (R, W):

    value = sum over the rows r of max(0, 1 - |y - r|) * (left + fx * step)

with left = window[r, floor(x)], step = window[r, floor(x) + 1] - left and
fx = x - floor(x). A tap outside the window contributes zero; so does one
outside the stack; nothing is clamped. With `grad_stack`, a second stack
of horizontal differences, step = grad_window[r, floor(x)].
scores[b, m] = cov / max(sqrt(va) * sqrt(vt), 0.1) of slot m's texture
against slot 0's (population statistics); slot 0 scores itself. There is
no visibility and there are no sentinels.

`window_scores` launches the hand-written kernel in `csrc/window_ncc.cu` on
CUDA tensors or raises; on CPU tensors it runs `window_scores_plain`.
`KERNEL_LAUNCHES` and `PLAIN_CALLS` count which ran. `full` is a warp per
patch; `noload`, `noreduce` and `bare` switch one cost centre of it off and
exist to be timed (no CPU version); `block` is the first body (a block per
patch) and `staged` that body with the window in shared memory (see the
source). `SCORING_VARIANTS` compute the scores.
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.ops import _build

__all__ = [
    "window_scores",
    "window_scores_plain",
    "window_scores_cuda",
    "window_samples",
    "ncc_against_first",
    "VARIANTS",
    "GRAD_VARIANTS",
    "SCORING_VARIANTS",
    "KERNEL_LAUNCHES",
    "PLAIN_CALLS",
]

KERNEL_LAUNCHES = 0  # kernel launches, counted where the kernel launches
PLAIN_CALLS = 0  # calls answered by the plain torch version (CPU tensors)

VARIANTS = ("full", "noload", "noreduce", "bare", "staged", "block")
GRAD_VARIANTS = ("full", "noload", "noreduce")  # with a gradient stack
SCORING_VARIANTS = ("full", "staged", "block")
NCC_MIN_DENOM = 0.1
_SMEM_BYTES = 48 * 1024  # static limit: no opt-in attribute is set
# Mirrors of csrc/window_sample.cuh: warps (patches or slots) of a block of
# the warp body, and the most texels a warp holds in registers; above that
# the warp body keeps slot 0's centred texture in shared memory.
_WARPS = 4
_REGISTER_TEXELS = 256

_VP, _I64, _INT = _build.VOID_P, _build.INT64, _build.INT
_ARGTYPES = (
    _VP, _VP, _I64, _I64,  # stack, grad, rows, width
    _VP, _VP, _VP, _VP,  # row0, x0, xs, ys
    _I64, _I64, _I64, _INT, _INT, _INT,  # B, M, S, n, win_h, win_w
    _VP, _VP,  # scores, stream
)


def _check_variant(variant: str, grad: bool):
    allowed = GRAD_VARIANTS if grad else VARIANTS
    if variant not in allowed:
        raise ValueError(
            f"unknown variant {variant!r}"
            f"{' with a gradient stack' if grad else ''}: one of {allowed}"
        )


def check_offsets(win_h: int, win_w: int, width: int):
    """Raise unless a tap's offset from its window's corner, at most
    (win_h + 1) rows of `width` and win_w + 1 columns away, fits the
    kernels' 32-bit offsets."""
    if (win_h + 2) * width + win_w + 2 >= 2**31:
        raise ValueError(
            f"window {win_h} x {win_w} on rows of {width}: tap offsets from "
            "a window's corner are 32-bit, (win_h + 2) * width + win_w + 2 "
            "must stay below 2^31"
        )


def check_smem(variant: str, floats: int, what: str):
    if 4 * floats > _SMEM_BYTES:
        raise ValueError(
            f"variant {variant!r} needs {4 * floats} bytes of shared memory "
            f"at {what}; the limit is {_SMEM_BYTES}"
        )


def _check_shapes(stack, row0, xs, n_real, win_h, win_w, variant):
    """Raise `ValueError` unless the kernel takes these shapes; shapes only,
    so it runs before any launch and on any device. Returns (R, W, B, M,
    S, n)."""
    if stack.ndim != 2 or row0.ndim != 2 or xs.ndim != 3:
        raise ValueError(
            f"expected stack (R, W), row0 (B, M), xs (B, M, S); got "
            f"{tuple(stack.shape)}, {tuple(row0.shape)}, {tuple(xs.shape)}"
        )
    R, W = stack.shape
    B, M = row0.shape
    S = xs.shape[2]
    n = int(n_real)
    if not 1 <= n <= S:
        raise ValueError(f"n_real {n} outside 1..{S} (the lanes of xs)")
    if M < 1 or win_h < 1 or win_w < 1:
        raise ValueError(f"M {M}, window {win_h} x {win_w}: all must be >= 1")
    check_offsets(win_h, win_w, W)
    if variant in ("block", "staged"):
        floats = 2 * n + (win_h * win_w if variant == "staged" else 0)
    else:
        floats = _WARPS * n if n > _REGISTER_TEXELS else 0
    check_smem(variant, floats, f"n_real {n}, window {win_h} x {win_w}")
    return R, W, B, M, S, n


def window_samples(
    image: torch.Tensor,
    row0: torch.Tensor,
    x0: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    win_h: int,
    win_w: int,
    grad_image=None,
    page=None,
):
    """Plain torch window-relative bilinear samples.

    image (R, W) f32, or (P, R, W) with `page` (...) naming each slot's
    page; row0, x0 (...) integer corners; xs, ys (..., n) f32 window
    coordinates. Returns (..., n) f32."""
    R, W = image.shape[-2:]
    flat = image.reshape(-1)
    base = 0 if page is None else page.to(torch.int64)[..., None] * (R * W)
    gflat = None if grad_image is None else grad_image.reshape(-1)
    xf, yf = torch.floor(xs), torch.floor(ys)
    fx, fy = xs - xf, ys - yf
    # Clamped before the conversion, as in the kernel: a NaN or a huge
    # coordinate becomes a tap outside the window.
    ix = xf.clamp(-2, win_w).nan_to_num(nan=-2.0).to(torch.int64)
    iy = yf.clamp(-2, win_h).nan_to_num(nan=-2.0).to(torch.int64)
    r0 = row0.to(torch.int64)[..., None]
    c0 = x0.to(torch.int64)[..., None]

    def tap(src, r, c):
        ar, ac = r0 + r, c0 + c
        ok = (
            (r >= 0) & (r < win_h) & (c >= 0) & (c < win_w)
            & (ar >= 0) & (ar < R) & (ac >= 0) & (ac < W)
        )
        idx = base + ar.clamp(0, R - 1) * W + ac.clamp(0, W - 1)
        return torch.where(ok, src[idx], 0.0)

    acc = torch.zeros_like(xs)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        left = tap(flat, iy + dy, ix)
        if gflat is None:
            step = tap(flat, iy + dy, ix + 1) - left
        else:
            step = tap(gflat, iy + dy, ix)
        acc = acc + wy * (left + fx * step)
    return acc


def ncc_against_first(tex: torch.Tensor) -> torch.Tensor:
    """tex (B, M, n) -> (B, M): NCC of every slot against slot 0."""
    centred = tex - tex.mean(dim=-1, keepdim=True)
    anchor = centred[:, :1]
    cov = (centred * anchor).mean(dim=-1)
    vt = (centred * centred).mean(dim=-1)
    va = vt[:, :1]
    denom = torch.clamp_min(torch.sqrt(va) * torch.sqrt(vt), NCC_MIN_DENOM)
    return cov / denom


def window_scores_plain(
    stack: torch.Tensor,
    row0: torch.Tensor,
    x0: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    n_real: int,
    win_h: int = 56,
    win_w: int = 128,
    grad_stack=None,
):
    """Plain torch version of the (B, M) contract, on any device."""
    tex = window_samples(
        stack, row0, x0, xs[..., :n_real], ys[..., :n_real], win_h, win_w,
        grad_image=grad_stack,
    )
    return ncc_against_first(tex)


def window_scores_cuda(
    stack: torch.Tensor,
    row0: torch.Tensor,
    x0: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    n_real: int,
    win_h: int = 56,
    win_w: int = 128,
    variant: str = "full",
    grad_stack=None,
):
    """Launch one variant of the CUDA kernel on the current stream.

    stack (and grad_stack) (R, W) f32; row0, x0 (B, M) int32; xs, ys
    (B, M, S) f32 with S >= n_real (lanes past n_real are not read); all
    contiguous on one CUDA device. Returns scores (B, M) f32."""
    global KERNEL_LAUNCHES
    _check_variant(variant, grad_stack is not None)
    R, W, B, M, S, n = _check_shapes(
        stack, row0, xs, n_real, win_h, win_w, variant)
    dev = stack.device
    if dev.type != "cuda":
        raise ValueError(f"window_scores_cuda needs CUDA tensors, got {dev}")
    check = _build.check_tensor
    check("stack", stack, dev, torch.float32, (R, W))
    if grad_stack is not None:
        check("grad_stack", grad_stack, dev, torch.float32, (R, W))
    check("row0", row0, dev, torch.int32, (B, M))
    check("x0", x0, dev, torch.int32, (B, M))
    check("xs", xs, dev, torch.float32, (B, M, S))
    check("ys", ys, dev, torch.float32, (B, M, S))
    scores = torch.empty((B, M), dtype=torch.float32, device=dev)
    if B == 0:
        return scores
    name = "window_ncc_" + ("grad_" if grad_stack is not None else "") + variant
    KERNEL_LAUNCHES += 1
    _build.launch(
        name, _ARGTYPES, dev,
        stack.data_ptr(),
        None if grad_stack is None else grad_stack.data_ptr(),
        R, W, row0.data_ptr(), x0.data_ptr(), xs.data_ptr(), ys.data_ptr(),
        B, M, S, n, int(win_h), int(win_w), scores.data_ptr(),
    )
    return scores


def window_scores(
    stack: torch.Tensor,
    row0: torch.Tensor,
    x0: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    n_real: int,
    win_h: int = 56,
    win_w: int = 128,
    variant: str = "full",
    grad_stack=None,
):
    """scores (B, M): the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors (score-computing variants only)."""
    global PLAIN_CALLS
    _check_variant(variant, grad_stack is not None)
    if stack.device.type == "cpu":
        if variant not in SCORING_VARIANTS:
            raise ValueError(
                f"variant {variant!r} only bounds a cost of the CUDA kernel "
                "and has no CPU version"
            )
        PLAIN_CALLS += 1
        return window_scores_plain(
            stack, row0, x0, xs, ys, n_real, win_h, win_w, grad_stack
        )
    c = lambda t, dt: t.to(dt).contiguous()  # noqa: E731
    f32, i32 = torch.float32, torch.int32
    return window_scores_cuda(
        c(stack, f32), c(row0, i32), c(x0, i32), c(xs, f32), c(ys, f32),
        n_real, win_h, win_w, variant,
        None if grad_stack is None else c(grad_stack, f32),
    )
