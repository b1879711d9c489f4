"""Ablation of the centred-texture kernel on a CUDA card.

    python -m densepoints_tpu_torch.scripts.kernel_paged_ablate [--device cuda]

Stands for `scripts/kernel_paged_ablate.py` of the JAX package: the same
inputs (`np.random.default_rng(0)`; 28,672 slots on 8 pages of 512 x 128,
then 102,400 slots on 50 pages of 1216 x 128; k = 11 in 128 lanes; one page
per step of 128 slots), here in f32 and per slot. Every variant of
`ops.window_textures` is timed back to back (`_timing.time_ms`: median of
20 timings of 10 calls queued behind a device-side sleep, after warm-up):
the warp body `full`, its switches `noload`, `noreduce`, `bare`, the first
body `block` and `staged`. The texture-computing ones are held against
`full`. Prints one JSON line per shape: per variant `ms`, `ns_per_slot` and
`max_abs_err_vs_full` (null for a variant that only bounds a cost), for
`full` the bound, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from densepoints_tpu_torch.ops import window_textures
from densepoints_tpu_torch.scripts import _timing

WIN_H, WIN_W = 56, 128
STEP = 128  # slots that share a page in the JAX script's layout

SHAPES = (  # name, slots, pages, rows per page, k
    ("bench_b4096_v8", 4096 * 7, 8, 512, 11),
    ("expand_b4096_v50", 4096 * 25, 50, 1216, 11),
)


def script_inputs(device, n_slots, V, R, k, seed=0):
    """The arrays of the JAX script's `run_shape` (same generator, same
    order of draws), per slot, as f32 / int32 tensors."""
    lanes = -(-(k * k) // 128) * 128
    nsteps = -(-n_slots // STEP)
    N = nsteps * STEP
    rng = np.random.default_rng(seed)
    pages = rng.uniform(0, 255, (V, R, WIN_W)).astype(np.float32)
    tbl = (np.arange(nsteps) * V // nsteps).astype(np.int32)
    row0 = (rng.integers(0, (R - WIN_H) // 8, (nsteps * 8, 16)) * 8).astype(
        np.int32)
    xs = rng.uniform(0, WIN_W - 1.01, (nsteps * 8, 16 * lanes)).astype(
        np.float32)
    ys = rng.uniform(0, WIN_H - 1.01, (nsteps * 8, 16 * lanes)).astype(
        np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {
        "pages": t(pages), "page": t(np.repeat(tbl, STEP)),
        "row0": t(row0.reshape(N)), "xs": t(xs.reshape(N, lanes)),
        "ys": t(ys.reshape(N, lanes)), "n_real": k * k,
    }


def textures_bound(inp, out):
    """(bound_ms, bound_by) of one pass over `inp`: dead slots sample
    nothing and are only written."""
    P, R, W = inp["pages"].shape
    live = (inp["page"] >= 0) & (inp["page"] < P)
    corners = (inp["page"].to(torch.int64) * R + inp["row0"])[live]
    return _timing.window_bound(
        [inp["pages"]], int(torch.unique(corners).numel()), WIN_H * W * 4,
        int(live.sum()) * inp["n_real"], (inp["page"], inp["row0"], out),
        _timing.TEXTURE_TEXEL_FLOPS,
    )


def run_shape(name, inp, reps=20):
    """Time every variant on `inp` (CUDA tensors); returns the record."""
    N = inp["page"].shape[0]
    args = (inp["pages"], inp["page"], inp["row0"], inp["xs"], inp["ys"],
            inp["n_real"], WIN_H)
    variants = {}
    full = None
    for variant in window_textures.VARIANTS:
        call = lambda: window_textures.window_centered_textures_cuda(  # noqa: E731
            *args, variant=variant)
        out = call()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"variant {variant}: non-finite textures")
        ms = _timing.time_ms(call, reps)
        entry = {"ms": ms, "ns_per_slot": 1e6 * ms / N,
                 "max_abs_err_vs_full": None}
        if variant == "full":
            full = out
            entry["bound_ms"], entry["bound_by"] = textures_bound(inp, out)
        if variant in window_textures.SCORING_VARIANTS:
            entry["max_abs_err_vs_full"] = float((out - full).abs().max())
        variants[variant] = entry
    return {
        "program": "kernel_paged_ablate",
        "shape": {"name": name, "slots": N, "n_real": inp["n_real"],
                  "lanes": inp["xs"].shape[1],
                  "pages": list(inp["pages"].shape), "win_h": WIN_H},
        "card": _timing.card_line(),
        "variants": variants,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = _timing.cuda_device(args.device)
    with torch.cuda.device(device):
        for name, n_slots, V, R, k in SHAPES:
            inp = script_inputs(device, n_slots, V, R, k)
            print(json.dumps(run_shape(name, inp)), flush=True)
            del inp
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
