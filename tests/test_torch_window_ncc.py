"""The port's window-relative warp + NCC (`ops.window_ncc`) vs the TPU bodies.

On CPU tensors `window_scores` runs its plain version. It is held against
the bodies of `scripts/kernel_ablate.py` (`make_variant`, `make_grad_variant`)
run through `pl.pallas_call(..., interpret=True)` with the specs of the
script's `run_variant`, on the same seeded numpy inputs. The TPU bodies read
bf16 stacks, so the stack is rounded to bf16 first and both sides get the
same values; every other step is f32 on both sides, and scores (in [-1, 1])
agree within 1e-5. A dense float64 numpy reference of the hat-weight
contract covers taps outside the window and outside the stack.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu_torch.ops import window_ncc
from tests.torch_port_util import cuda_device  # noqa: F401

ATOL = 1e-5
WIN_H, WIN_W = 56, 128


def _load_script(name):
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16(x):
    return np.array(  # a writable copy
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    )


def _inputs(rng, B=8, M=3, k=11, rows=128, W=256, outside=False):
    """The script's inputs at a small size, k * k texels in rows of S
    coordinates (128-lane multiples, as the script pads them); with
    `outside`, some taps fall out of the window."""
    S = -(-(k * k) // 128) * 128
    stack = _bf16(rng.uniform(0, 255, (rows, W)).astype(np.float32))
    grad = _bf16(np.concatenate(
        [stack[:, 1:] - stack[:, :-1], np.zeros((rows, 1), np.float32)], 1
    ))
    row0 = (rng.integers(0, (rows - WIN_H) // 8 + 1, (B, M)) * 8).astype(
        np.int32)
    x0 = (rng.integers(0, (W - WIN_W) // 128 + 1, (B, M)) * 128).astype(
        np.int32)
    lo, hi = (-3.0, 3.0) if outside else (10.0, -18.0)
    xs = rng.uniform(lo, WIN_W + hi, (B, M * S)).astype(np.float32)
    ys = rng.uniform(2 if not outside else -3.0,
                     WIN_H + (3.0 if outside else -6.0),
                     (B, M * S)).astype(np.float32)
    return stack, grad, row0, x0, xs, ys, S, k * k


def _tpu_scores(body, row0, x0, xs, ys, stacks, M, S, tile_b):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B = row0.shape[0]
    rows, W = stacks[0].shape
    smem = pl.BlockSpec((tile_b, M), lambda i: (i, 0),
                        memory_space=pltpu.SMEM)
    coord = pl.BlockSpec((tile_b, M * S), lambda i: (i, 0),
                         memory_space=pltpu.VMEM)
    img = pl.BlockSpec((rows, W), lambda i: (0, 0), memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct((B, M), jnp.float32),
        grid=(B // tile_b,),
        in_specs=[smem, smem, coord, coord] + [img] * len(stacks),
        out_specs=pl.BlockSpec((tile_b, M), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((M, S), jnp.float32)],
        interpret=True,
    )
    j = jnp.asarray
    return np.asarray(call(
        j(row0), j(x0), j(xs), j(ys),
        *(j(s).astype(jnp.bfloat16) for s in stacks),
    ))


def _port_scores(stack, row0, x0, xs, ys, S, n_real, grad=None, **kw):
    t = torch.as_tensor
    B, M = row0.shape
    return window_ncc.window_scores(
        t(stack), t(row0), t(x0), t(xs).reshape(B, M, S),
        t(ys).reshape(B, M, S), n_real, WIN_H, WIN_W,
        grad_stack=None if grad is None else t(grad), **kw,
    ).numpy()


def _dense_reference(stack, row0, x0, xs, ys, S, n_real):
    """float64 hat weights over the whole window, zeros outside the stack."""
    B, M = row0.shape
    rows, W = stack.shape
    tex = np.zeros((B, M, n_real))
    r = np.arange(WIN_H)[:, None]
    c = np.arange(WIN_W)[None, :]
    for b in range(B):
        for m in range(M):
            roi = np.zeros((WIN_H, WIN_W))
            rr, cc = row0[b, m] + r, x0[b, m] + c
            ok = (rr >= 0) & (rr < rows) & (cc >= 0) & (cc < W)
            roi[ok] = stack[np.clip(rr, 0, rows - 1),
                            np.clip(cc, 0, W - 1)][ok]
            for i in range(n_real):
                x = float(xs[b, m * S + i])
                y = float(ys[b, m * S + i])
                wgt = (np.maximum(0, 1 - np.abs(y - r))
                       * np.maximum(0, 1 - np.abs(x - c)))
                tex[b, m, i] = (wgt * roi).sum()
    ct = tex - tex.mean(-1, keepdims=True)
    cov = (ct * ct[:, :1]).mean(-1)
    var = (ct * ct).mean(-1)
    return cov / np.maximum(np.sqrt(var[:, :1]) * np.sqrt(var), 0.1)


# Texture sides whose texel counts (1, 25, 121, 256) take each register
# layout of the kernel's warp body: 1, 1, 4 and 8 texels per lane.
TEXTURE_SIDES = [1, 5, 11, 16]


@pytest.mark.parametrize("k", TEXTURE_SIDES, ids=lambda k: f"k{k}")
@pytest.mark.parametrize("mode", ["onehot", "fused"])
@pytest.mark.parametrize("outside", [False, True], ids=["inside", "outside"])
def test_plain_matches_tpu_variant(rng, mode, outside, k):
    stack, _, row0, x0, xs, ys, S, n = _inputs(rng, k=k, outside=outside)
    M = row0.shape[1]
    body = _load_script("kernel_ablate").make_variant(
        M, S, n, WIN_H, WIN_W, 8, mode)
    want = _tpu_scores(body, row0, x0, xs, ys, [stack], M, S, 8)
    got = _port_scores(stack, row0, x0, xs, ys, S, n)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # A textured slot 0 scores 1 against itself; a single texel is flat,
    # and the 0.1 clamp gives 0.
    np.testing.assert_allclose(got[:, 0], 1.0 if n > 1 else 0.0, atol=ATOL)


def test_plain_grad_matches_tpu_grad_variant(rng):
    stack, grad, row0, x0, xs, ys, S, n = _inputs(rng)
    M = row0.shape[1]
    body = _load_script("kernel_ablate").make_grad_variant(
        M, S, n, WIN_H, WIN_W, 8)
    want = _tpu_scores(body, row0, x0, xs, ys, [stack, grad], M, S, 8)
    got = _port_scores(stack, row0, x0, xs, ys, S, n, grad=grad)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # The gradient form rounds differently from the two-tap form (and the
    # bf16 gradient is not the exact difference): close, not equal.
    full = _port_scores(stack, row0, x0, xs, ys, S, n)
    assert 0 < np.abs(got - full).max() < 2e-2


def test_out_of_window_and_out_of_stack_taps_are_zero(rng):
    stack, _, row0, x0, xs, ys, S, n = _inputs(rng, B=3, M=2, k=5,
                                               outside=True)
    row0[0, 1], x0[0, 1] = -20, -40  # window hangs over the stack's corner
    row0[1, 0], x0[1, 1] = 100, 200  # and over its far edges
    xs[2, :4] = [-1.0, -0.25, WIN_W - 1.0, WIN_W - 0.5]  # last column: 1 tap
    ys[2, :4] = [WIN_H - 1.0, WIN_H - 0.5, -0.5, -1.0]  # last row: 1 tap
    got = _port_scores(stack, row0, x0, xs, ys, S, n)
    want = _dense_reference(stack, row0, x0, xs, ys, S, n)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_lanes_past_n_real_are_ignored(rng):
    stack, _, row0, x0, xs, ys, S, n = _inputs(rng)
    want = _port_scores(stack, row0, x0, xs, ys, S, n)
    xs = xs.reshape(-1, S).copy()
    xs[:, n:] = np.nan
    got = _port_scores(stack, row0, x0, xs.reshape(ys.shape), ys, S, n)
    np.testing.assert_array_equal(got, want)


def test_flat_anchor_takes_the_denominator_clamp(rng):
    stack, _, row0, x0, xs, ys, S, n = _inputs(rng, B=2, M=2)
    stack[:] = 7.0
    got = _port_scores(stack, row0, x0, xs, ys, S, n)
    np.testing.assert_allclose(got, 0.0, atol=ATOL)


def test_variants_and_devices(rng):
    stack, grad, row0, x0, xs, ys, S, n = _inputs(rng, B=2, M=2)
    full = _port_scores(stack, row0, x0, xs, ys, S, n)
    for variant in ("staged", "block"):  # same function on the CPU
        np.testing.assert_array_equal(
            _port_scores(stack, row0, x0, xs, ys, S, n, variant=variant),
            full)
    with pytest.raises(ValueError, match="unknown variant"):
        _port_scores(stack, row0, x0, xs, ys, S, n, variant="onehot")
    with pytest.raises(ValueError, match="gradient stack"):
        _port_scores(stack, row0, x0, xs, ys, S, n, grad=grad,
                     variant="staged")
    with pytest.raises(ValueError, match="no CPU version"):
        _port_scores(stack, row0, x0, xs, ys, S, n, variant="noload")
    t = torch.as_tensor
    with pytest.raises(ValueError, match="CUDA"):
        window_ncc.window_scores_cuda(
            t(stack), t(row0), t(x0), t(xs).reshape(2, 2, S),
            t(ys).reshape(2, 2, S), n)


def test_cpu_tensors_take_the_plain_path(rng):
    stack, _, row0, x0, xs, ys, S, n = _inputs(rng, B=2, M=2)
    launches, plain = window_ncc.KERNEL_LAUNCHES, window_ncc.PLAIN_CALLS
    _port_scores(stack, row0, x0, xs, ys, S, n)
    assert window_ncc.PLAIN_CALLS == plain + 1
    assert window_ncc.KERNEL_LAUNCHES == launches


@pytest.mark.parametrize(
    "case", ["offsets_2_31", "strided_smem", "block_smem", "staged_smem"])
def test_kernel_wrapper_validates_shapes(case):
    """Shapes the kernel does not take raise `ValueError` before any launch,
    so also here, where there is no card: tap offsets from a window's corner
    past 32 bits, and shared memory past 48 KB (the warp body above 256
    texels keeps slot 0 there; `block` and `staged` keep the textures and
    the staged window)."""
    B, M, n, R, W = 4, 3, 121, 300, 256
    win_h, win_w, variant = WIN_H, WIN_W, "full"
    match = "shared memory"
    if case == "offsets_2_31":  # tensors with no storage: shapes only
        R, W = 60, 2**26
        match = "2\\^31"
    elif case == "strided_smem":
        n = 4000  # 4 warps x 4000 words
    elif case == "block_smem":
        n, variant = 6200, "block"  # 2 x 6200 words
    else:
        win_h, variant = 100, "staged"  # 2 x 121 + 100 x 128 words
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    launches = window_ncc.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match=match):
        window_ncc.window_scores_cuda(
            meta(R, W), meta(B, M).int(), meta(B, M).int(), meta(B, M, n),
            meta(B, M, n), n, win_h, win_w, variant=variant)
    assert window_ncc.KERNEL_LAUNCHES == launches


# Texel counts of each register layout of the warp body (1, 1, 2, 4, 8 per
# lane, the strided form), and at n = 121 coordinate rows of 123 floats,
# which take the scalar coordinate loads.
CARD_SHAPES = [(1, 1), (32, 32), (33, 33), (121, 128), (121, 123),
               (256, 256), (300, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,S", CARD_SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize(
    "variant,with_grad",
    [("full", False), ("staged", False), ("block", False), ("full", True)],
)
def test_kernel_matches_plain_on_card(rng, cuda_device, variant, with_grad,
                                      n, S):
    """The CUDA kernel vs the plain version on the card, f32 both; B not a
    multiple of 8, taps outside the window, windows over the stack's edges:
    1e-4 (fused multiply-adds and the summation order)."""
    B, M = 37, 5
    stack, grad, _, _, _, _, _, _ = _inputs(rng, B=B, M=M)
    row0 = rng.integers(-20, stack.shape[0] - 30, (B, M)).astype(np.int32)
    x0 = rng.integers(-30, stack.shape[1] - 90, (B, M)).astype(np.int32)
    xs = rng.uniform(-3, WIN_W + 3, (B, M, S)).astype(np.float32)
    ys = rng.uniform(-3, WIN_H + 3, (B, M, S)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=cuda_device)  # noqa: E731
    args = (t(stack), t(row0), t(x0), t(xs), t(ys), n, WIN_H, WIN_W)
    g = t(grad) if with_grad else None
    launches = window_ncc.KERNEL_LAUNCHES
    got = window_ncc.window_scores(*args, variant=variant, grad_stack=g)
    want = window_ncc.window_scores_plain(*args, grad_stack=g)
    torch.cuda.synchronize()
    assert window_ncc.KERNEL_LAUNCHES == launches + 1
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("variant,with_grad",
                         [("noload", False), ("noreduce", False),
                          ("bare", False), ("noload", True),
                          ("noreduce", True)])
def test_timing_variants_launch_on_card(rng, cuda_device, variant, with_grad):
    stack, grad, row0, x0, xs, ys, S, n = _inputs(rng)
    t = lambda a: torch.as_tensor(a, device=cuda_device)  # noqa: E731
    B, M = row0.shape
    got = window_ncc.window_scores(
        t(stack), t(row0), t(x0), t(xs).reshape(B, M, S),
        t(ys).reshape(B, M, S), n, WIN_H, WIN_W, variant=variant,
        grad_stack=t(grad) if with_grad else None)
    torch.cuda.synchronize()
    assert got.shape == (B, M) and bool(torch.isfinite(got).all())
