"""The port's centred window textures (`ops.window_textures`) vs the TPU kernel.

On CPU tensors `window_centered_textures` runs its plain version. It is held
against `scripts/kernel_paged_ablate.py::make_call`, whose `pallas_call` is
patched to run in interpret mode, on the same seeded numpy inputs. The TPU
layout (one page per 128-slot step, 8 rows of 16 slots, 128 lanes) is mapped
onto the port's per-slot layout: `tbl[g]` repeated over the step's slots,
lanes past `n_real` dropped. Pages are rounded to bf16 first and both sides
get the same values. Textures are grey levels around +-128 whose f32
resolution is 1.5e-5; the two sides sum in another order, so they are held
to 1e-4 (measured: below 5e-5). Rows of a dead step come back unwritten
from the TPU kernel and as zeros from the port: only live rows are compared.
"""
import importlib.util
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu_torch.ops import window_textures
from tests.torch_port_util import cuda_device  # noqa: F401

ATOL = 1e-4
WIN_H, WIN_W = 56, 128
STEP = 128  # slots of one TPU grid step: 8 rows of 16


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


def _inputs(rng, tbl, V=2, R=64, k=11, outside=False):
    """The script's inputs at a small size, in the TPU layout: k * k texels
    in rows of S coordinates (128-lane multiples, as the script pads them)."""
    S = -(-(k * k) // 128) * 128
    nsteps = len(tbl)
    pages = _bf16(rng.uniform(0, 255, (V, R, WIN_W)).astype(np.float32))
    row0 = (rng.integers(0, (R - WIN_H) // 8 + 1, (nsteps * 8, 16)) * 8
            ).astype(np.int32)
    pad = 3.0 if outside else 0.0
    xs = rng.uniform(-pad, WIN_W - 1.01 + pad, (nsteps * 8, 16 * S)).astype(
        np.float32)
    ys = rng.uniform(-pad, WIN_H - 1.01 + pad, (nsteps * 8, 16 * S)).astype(
        np.float32)
    return pages, np.asarray(tbl, np.int32), row0, xs, ys, S, k


def _tpu_textures(mode, pages, tbl, row0, xs, ys, S, k):
    from jax.experimental import pallas as pl

    script = _load_script("kernel_paged_ablate")
    real = pl.pallas_call
    # `make_call` looks `pl.pallas_call` up when it is called and has no
    # interpret argument of its own.
    with mock.patch.object(
        pl, "pallas_call", lambda *a, **kw: real(*a, interpret=True, **kw)
    ):
        call = script.make_call(mode, len(tbl), pages.shape[1], S, k)
        j = jnp.asarray
        out = call(j(tbl), j(row0), j(xs), j(ys),
                   j(pages).astype(jnp.bfloat16))
    return np.asarray(out)


def _port_layout(tbl, row0, xs, ys, S):
    """The TPU step layout as per-slot arrays."""
    N = len(tbl) * STEP
    return (np.repeat(tbl, STEP), row0.reshape(N), xs.reshape(N, S),
            ys.reshape(N, S))


def _port_textures(pages, tbl, row0, xs, ys, S, k, **kw):
    t = torch.as_tensor
    page, r0, x, y = _port_layout(tbl, row0, xs, ys, S)
    return window_textures.window_centered_textures(
        t(pages), t(page), t(r0), t(x), t(y), k * k, WIN_H, **kw
    ).numpy()


# Texture sides whose texel counts (1, 25, 121, 256) take each register
# layout of the kernel's warp body: 1, 1, 4 and 8 texels per lane.
TEXTURE_SIDES = [1, 5, 11, 16]


@pytest.mark.parametrize("k", TEXTURE_SIDES, ids=lambda k: f"k{k}")
@pytest.mark.parametrize("mode", ["shipped", "fused"])
@pytest.mark.parametrize("outside", [False, True], ids=["inside", "outside"])
def test_plain_matches_tpu_kernel_on_live_rows(rng, mode, outside, k):
    args = _inputs(rng, tbl=[1, -1, 0], k=k, outside=outside)
    S, k = args[-2:]
    want = _tpu_textures(mode, *args)
    got = _port_textures(*args)
    assert got.shape == (3 * STEP, k * k) and got.dtype == np.float32
    live = np.repeat(np.asarray(args[1]) >= 0, STEP)
    err = np.abs(got[live] - want[live, : k * k]).max()
    print(f"window textures vs TPU {mode}: max |diff| {err:.3e}")
    assert err <= ATOL
    np.testing.assert_array_equal(want[live, k * k:], 0.0)  # padded lanes
    np.testing.assert_array_equal(got[~live], 0.0)
    if k > 1:  # real textures, not zeros (one texel centred is 0)
        assert np.abs(got[live]).max() > 10.0
    np.testing.assert_allclose(got[live].mean(axis=1), 0.0, atol=1e-3)


def test_dead_slots_are_zero_slot_by_slot(rng):
    pages, tbl, row0, xs, ys, S, k = _inputs(rng, tbl=[0])
    page, r0, x, y = _port_layout(tbl, row0, xs, ys, S)
    page = page.copy()
    page[5::7] = -1
    page[3] = 99  # past the last page: dead as well, never read
    t = torch.as_tensor
    got = window_textures.window_centered_textures(
        t(pages), t(page), t(r0), t(x), t(y), k * k, WIN_H).numpy()
    dead = (page < 0) | (page >= pages.shape[0])
    np.testing.assert_array_equal(got[dead], 0.0)
    full = _port_textures(pages, tbl, row0, xs, ys, S, k)
    np.testing.assert_array_equal(got[~dead], full[~dead])


def test_window_past_the_page_reads_zeros(rng):
    pages, tbl, row0, xs, ys, S, k = _inputs(rng, tbl=[0], R=64)
    page, r0, x, y = _port_layout(tbl, row0, xs, ys, S)
    r0 = r0.copy()
    r0[:] = 40  # rows 40..95 of a 64-row page: the last 32 are outside
    y = np.full_like(y, 30.25)  # taps on rows 70 and 71: beyond the page
    t = torch.as_tensor
    got = window_textures.window_centered_textures(
        t(pages), t(page), t(r0), t(x), t(y), k * k, WIN_H).numpy()
    np.testing.assert_array_equal(got, 0.0)


def test_variants_and_devices(rng):
    args = _inputs(rng, tbl=[0])
    full = _port_textures(*args)
    for variant in ("staged", "block"):  # same function on the CPU
        np.testing.assert_array_equal(
            _port_textures(*args, variant=variant), full)
    with pytest.raises(ValueError, match="unknown variant"):
        _port_textures(*args, variant="pack2")
    with pytest.raises(ValueError, match="no CPU version"):
        _port_textures(*args, variant="noreduce")
    pages, tbl, row0, xs, ys, S, k = args
    t = torch.as_tensor
    page, r0, x, y = _port_layout(tbl, row0, xs, ys, S)
    with pytest.raises(ValueError, match="CUDA"):
        window_textures.window_centered_textures_cuda(
            t(pages), t(page), t(r0), t(x), t(y), k * k)


def test_cpu_tensors_take_the_plain_path(rng):
    args = _inputs(rng, tbl=[0])
    launches = window_textures.KERNEL_LAUNCHES
    plain = window_textures.PLAIN_CALLS
    _port_textures(*args)
    assert window_textures.PLAIN_CALLS == plain + 1
    assert window_textures.KERNEL_LAUNCHES == launches


@pytest.mark.parametrize("case", ["offsets_2_31", "block_smem", "staged_smem"])
def test_kernel_wrapper_validates_shapes(case):
    """Shapes the kernel does not take raise `ValueError` before any launch,
    so also here, where there is no card: tap offsets from a window's corner
    past 32 bits, and shared memory past 48 KB for `block` (the texture)
    and `staged` (the texture and the window). The warp body keeps nothing
    in shared memory."""
    N, n, P, R, W = 5, 121, 2, 300, WIN_W
    win_h, variant = WIN_H, "full"
    match = "shared memory"
    if case == "offsets_2_31":  # tensors with no storage: shapes only
        R, W = 4, 2**26
        match = "2\\^31"
    elif case == "block_smem":
        n, variant = 12300, "block"
    else:
        win_h, variant = 100, "staged"  # 121 + 100 x 128 words
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    launches = window_textures.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match=match):
        window_textures.window_centered_textures_cuda(
            meta(P, R, W), meta(N).int(), meta(N).int(), meta(N, n),
            meta(N, n), n, win_h, variant=variant)
    assert window_textures.KERNEL_LAUNCHES == launches
    # The warp body takes the same shapes where they only cost `block` and
    # `staged` shared memory: it refuses them for want of a card alone.
    if case != "offsets_2_31":
        with pytest.raises(ValueError, match="CUDA"):
            window_textures.window_centered_textures_cuda(
                meta(P, R, W), meta(N).int(), meta(N).int(), meta(N, n),
                meta(N, n), n, win_h)


# Texel counts of each register layout of the warp body (1, 1, 2, 4, 8 per
# lane, the strided form), and at n = 121 coordinate rows of 123 floats,
# which take the scalar coordinate loads.
CARD_SHAPES = [(1, 1), (32, 32), (33, 33), (121, 128), (121, 123),
               (256, 256), (300, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,S", CARD_SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("variant", ["full", "staged", "block"])
def test_kernel_matches_plain_on_card(rng, cuda_device, variant, n, S):
    """The CUDA kernel vs the plain version on the card, f32 both; a slot
    count that is no multiple of 4, taps outside the window, windows past
    the page's ends, dead slots: 1e-3 grey levels (fused multiply-adds and
    the summation order on values of +-128); dead slots exactly zero."""
    N = 1003
    pages = rng.uniform(0, 255, (3, 200, WIN_W)).astype(np.float32)
    page = rng.integers(-1, 4, N).astype(np.int32)  # -1 and 3 are dead
    row0 = rng.integers(-10, 170, N).astype(np.int32)
    xs = rng.uniform(-3, WIN_W + 3, (N, S)).astype(np.float32)
    ys = rng.uniform(-3, WIN_H + 3, (N, S)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=cuda_device)  # noqa: E731
    args = (t(pages), t(page), t(row0), t(xs), t(ys), n, WIN_H)
    launches = window_textures.KERNEL_LAUNCHES
    got = window_textures.window_centered_textures(*args, variant=variant)
    want = window_textures.window_centered_textures_plain(*args)
    torch.cuda.synchronize()
    assert window_textures.KERNEL_LAUNCHES == launches + 1
    assert float((got - want).abs().max()) <= 1e-3
    dead = (t(page) < 0) | (t(page) >= 3)
    assert bool((got[dead] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["noload", "noreduce", "bare"])
def test_timing_variants_launch_on_card(rng, cuda_device, variant):
    pages, tbl, row0, xs, ys, S, k = _inputs(rng, tbl=[0, 1])
    page, r0, x, y = _port_layout(tbl, row0, xs, ys, S)
    t = lambda a: torch.as_tensor(a, device=cuda_device)  # noqa: E731
    got = window_textures.window_centered_textures(
        t(pages), t(page), t(r0), t(x), t(y), k * k, WIN_H, variant=variant)
    torch.cuda.synchronize()
    assert got.shape == (2 * STEP, k * k)
    assert bool(torch.isfinite(got).all())
