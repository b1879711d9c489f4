"""What the measurement programs share: the card's identity, CUDA-event
timing, and the bound of a kernel from its bytes and operations."""
from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published


def cuda_device(name: str) -> torch.device:
    """The CUDA device `name`, or an error: kernels are timed on a card."""
    device = torch.device(name)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(
            f"device {name!r}: this program times CUDA kernels and needs a "
            "CUDA card (there is no CPU mode)"
        )
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
