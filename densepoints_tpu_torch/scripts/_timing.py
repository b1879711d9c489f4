"""What the measurement programs share: the card's identity, CUDA-event
timing, the bound of a kernel from its bytes and operations, and the
launch counts and peak allocation of a run."""
from __future__ import annotations

import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published
INT8_OPS_PER_S = 1979e12  # H100 SXM, dense int8 tensor cores, published
INT32_OPS_PER_S = 64 * 132 * 1.98e9  # half the f32 lanes, boost clock


def cuda_device(name: str) -> torch.device:
    """The CUDA device `name` for a program that times kernels: any other
    device is a `ValueError` (there is no CPU mode), a missing card a
    `RuntimeError`."""
    device = torch.device(name)
    if device.type != "cuda":
        raise ValueError(
            f"device {name!r}: this program times CUDA kernels on a CUDA "
            "card (--device cuda); it has no CPU mode")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: no CUDA card is present")
    return device


def run_device(name: str) -> torch.device:
    """The device `name` for a program that runs on the card or, asked
    for it, on the CPU (its plain paths): a CUDA device must be present."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: no CUDA card is present")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: the port runs on cuda or cpu")
    return device


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warm: int = 3, batch: int = 10) -> float:
    """Median CUDA-event milliseconds per call over `reps` timings, after
    `warm` calls. Each timing queues `batch` calls behind a short
    device-side sleep, so that the card runs them back to back and a kernel
    shorter than the host's time to launch it (~0.05 ms through a Python
    wrapper) is timed and not the host; `batch` = 1 times one call between
    two events, as a caller makes it.

    `fn` may be a list of callables, each on its own inputs: the calls take
    them in turn, across timings too, so that with input sets larger than
    the L2 cache together (`rotation`) every call reads device memory."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    calls = 0

    def call():
        nonlocal calls
        fns[calls % len(fns)]()
        calls += 1

    for _ in range(warm):
        call()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if batch > 1:
            torch.cuda._sleep(200_000 * batch)  # ~0.1 ms per queued call
        start.record()
        for _ in range(batch):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    times.sort()
    return times[len(times) // 2]


def sync(device) -> None:
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_seconds(fn, device):
    """(result, seconds) of `fn()` on the host's clock, the device
    synchronised before and after: a stage's time, device work included."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def l2_bytes(device) -> int:
    """The L2 cache of `device`'s card, as the card reports it."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def rotation(set_bytes: int, l2: int) -> int:
    """How many input sets of `set_bytes` a rotated timing takes turns over:
    at least 4, and more than twice the L2 cache of `l2` bytes together, so
    that a set has left L2 before its next turn."""
    return max(4, 2 * l2 // set_bytes + 1)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over the memory rate and f32 operations over the peak rate."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F32_FLOPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def int8_bound(int8_ops: float, int_ops: float):
    """(bound_ms, bound_by) of a kernel whose products run on the int8
    tensor cores and whose epilogue runs as integer operations on the
    CUDA cores: the larger of the two."""
    by_int8 = 1e3 * int8_ops / INT8_OPS_PER_S
    by_int = 1e3 * int_ops / INT32_OPS_PER_S
    return (max(by_int8, by_int),
            "int8 operations" if by_int8 >= by_int else "integer operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# f32 operations the function needs per window-relative texel, whatever a
# kernel body spends: two floors, two fractions and the tests of four taps
# against the window 10; bilinear weights and taps 15; then the mean,
# variance and covariance sums 8 (scores), or the mean sum and the centring
# 2 (textures).
SCORE_TEXEL_FLOPS = 33
TEXTURE_TEXEL_FLOPS = 27


def window_bound(images, windows, window_bytes, texels, others,
                 flops_per_texel):
    """Bound of a window-sampling kernel over `texels` sampled texels.

    Of the images it must read no more than 16 B (4 taps) per texel, no
    more than its `windows` distinct windows of `window_bytes` each, and no
    more than the images once; the coordinates are 8 B per texel; `others`
    (corners, outputs) move once each."""
    image_bytes = min(nbytes(*images), 16 * texels, windows * window_bytes)
    return bound(image_bytes + 8 * texels + nbytes(*others),
                 texels * flops_per_texel)


# f32 operations a warp + NCC function (K1, K2) needs, whatever a kernel
# body spends. Per warped texel: the projection is affine in the texel's
# (column, row) before the division, h = A + c B + r C with A, B, C fixed
# per (patch, view), so 6 fused multiply-adds (12) and 2 divisions (14 in
# all); clamps and floors 10; bilinear weights and taps 15; mean / variance
# / covariance sums 8.
TEXEL_FLOPS = 47
# Per texture, A, B and C: three 3 x 3 products with the view's K R (45),
# one subtraction of the centre (3) and two scalings by 2 / k (6).
TEXTURE_FLOPS = 54
# Per patch, the frame (sx, sy): a cross product (9), p + x_axis (3), two
# decomposed projections of 35 (3 subtractions, two 3 x 3 products, 2
# divisions), their difference and its norm (6), the clamp and the division
# of the scale (2) and two scalings (6).
PATCH_FLOPS = 96


def tap_pixels(images, cams, position, normal, ref, pairs, k) -> int:
    """Distinct pixels of the image stack that the bilinear taps of the
    textures named by `pairs` ((B, V) bool: patch b sampled in view v)
    read: the texel grid, projection and clamp to the edge of the plain
    scoring path (`ops.warp.patch_textures`). A kernel that reads each
    such pixel from device memory once moves no fewer image bytes."""
    from densepoints_tpu_torch.ops.warp import patch_frames

    V, H, W = images.shape
    dev = images.device
    touched = torch.zeros(V * H * W, dtype=torch.bool, device=dev)
    sx, sy = patch_frames(cams, position, normal, ref, k)
    coords = (2.0 * torch.arange(k, dtype=position.dtype, device=dev) / k
              - 1.0)
    tt, ss = torch.meshgrid(coords, coords, indexing="ij")
    views = torch.arange(V, device=dev)[:, None, None, None]
    step = max(1, (1 << 24) // (V * k * k))  # patches per projection
    for s in range(0, position.shape[0], step):
        e = s + step
        world = (position[s:e, None, None, :]
                 + ss[..., None] * sx[s:e, None, None, :]
                 + tt[..., None] * sy[s:e, None, None, :])
        pix = torch.nan_to_num(cams.project(world))  # (V, b, k, k, 2)
        x = pix[..., 0].clamp(0.0, W - 1.0)
        y = pix[..., 1].clamp(0.0, H - 1.0)
        x0 = torch.floor(x).long().clamp(0, max(W - 2, 0))
        y0 = torch.floor(y).long().clamp(0, max(H - 2, 0))
        base = ((views * H + y0) * W + x0)[pairs[s:e].T]
        for offset in (0, 1, W, W + 1):
            touched[base + offset] = True
    return int(touched.sum())


def warp_counts(images, others, patches, textures, k, pixels):
    """(bytes, f32 operations) of a warp + NCC function that framed
    `patches` patches and sampled `textures` k x k textures whose taps
    read `pixels` distinct pixels of the image stack (`tap_pixels`), each
    moved once; `others` are the remaining inputs (cameras, position,
    normal, reference view, visibility or slots) and the outputs, moved
    once each."""
    flops = (patches * PATCH_FLOPS
             + textures * (k * k * TEXEL_FLOPS + TEXTURE_FLOPS))
    return pixels * images.element_size() + nbytes(*others), flops


def _camera_tensors(cams):
    """The camera arrays the warp + NCC kernels take."""
    return (cams.K, cams.E, cams.C, cams.x_axis, cams.width, cams.height)


def allview_counts(images, cams, position, normal, ref, vis, out, k):
    """`warp_counts` of the all-views function (K1) on these inputs, given
    its outputs `out` = (scores, anchor, anchor_ok): every scored slot and
    every valid anchor samples one texture."""
    scores, anchor, anchor_ok = out
    pairs = scores != -1
    rows = torch.arange(anchor.shape[0], device=anchor.device)
    pairs[rows, anchor] |= anchor_ok
    others = (*_camera_tensors(cams), position, normal, ref, vis, *out)
    return warp_counts(
        images, others, position.shape[0], int(pairs.sum()), k,
        tap_pixels(images, cams, position, normal, ref, pairs, k))


def slot_counts(images, cams, position, normal, ref, view_ids, ok, scores,
                k):
    """`warp_counts` of the slot function (K2) on these inputs, given its
    output `scores`: every slot that scored (slot 0 included) samples one
    texture."""
    B, V = scores.shape[0], images.shape[0]
    scored = scores != -1
    rows = torch.arange(B, device=scores.device)[:, None].expand_as(scored)
    pairs = torch.zeros((B, V), dtype=torch.bool, device=scores.device)
    pairs[rows[scored], view_ids.long()[scored]] = True
    others = (*_camera_tensors(cams), position, normal, ref, view_ids, ok,
              scores)
    return warp_counts(
        images, others, B, int(scored.sum()), k,
        tap_pixels(images, cams, position, normal, ref, pairs, k))


def _scoring_modules():
    from densepoints_tpu_torch.ops import allview_ncc, ncc, warp_ncc

    return {"allview_ncc": allview_ncc, "slot_ncc": warp_ncc,
            "ncc_pairs": ncc}


def summed(records) -> dict:
    """The launches and plain calls of several `Counts.read()` records
    (the ranks of a job) added up."""
    records = list(records)
    return {
        "launches": {k: sum(r["launches"][k] for r in records)
                     for k in ("allview_ncc", "slot_ncc")},
        "plain_calls": sum(r["plain_calls"] for r in records),
    }


class Counts:
    """What a run between `Counts(device)` and `read()` did: launches of
    the all-views (K1) and slot (K2) kernels, plain scoring calls (the
    three scoring wrappers' CPU route), and on a card the peak allocation
    (its statistics are reset here). The launch counters are read, never
    reset."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._start = self._now()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    @staticmethod
    def _now():
        modules = _scoring_modules()
        return {
            "allview_ncc": modules["allview_ncc"].KERNEL_LAUNCHES,
            "slot_ncc": modules["slot_ncc"].KERNEL_LAUNCHES,
            "plain_calls": sum(m.PLAIN_CALLS for m in modules.values()),
        }

    def read(self) -> dict:
        now = self._now()
        d = {key: now[key] - self._start[key] for key in now}
        return {
            "launches": {"allview_ncc": d["allview_ncc"],
                         "slot_ncc": d["slot_ncc"]},
            "plain_calls": d["plain_calls"],
            "max_memory_allocated": (
                torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None),
        }

