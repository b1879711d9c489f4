"""Ablation of the window-relative warp + NCC kernel on a CUDA card.

    python -m densepoints_tpu_torch.scripts.kernel_ablate [--device cuda]

Stands for `scripts/kernel_ablate.py` of the JAX package: the same inputs
(`np.random.default_rng(0)`, 4096 patches of 8 slots, k = 11 in 128 lanes,
56 x 128 windows on a row-flattened stack of 16 images of 480 x 640, and
the stack of its horizontal differences), here in f32. Every variant of
`ops.window_ncc` is timed back to back (`_timing.time_ms`: median of 20
timings of 10 calls queued behind a device-side sleep, after warm-up): the
warp body `full`, its switches `noload`, `noreduce`, `bare`, the first
body `block` and `staged`, and the gradient form. The score-computing ones
are held against `full`. Prints one JSON line: per variant `ms`,
`ns_per_slot` and `max_abs_err_vs_full` (null for a variant that only
bounds a cost), for `full` and `grad` the bound, and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from densepoints_tpu_torch.ops import window_ncc
from densepoints_tpu_torch.scripts import _timing

WIN_H, WIN_W = 56, 128
LANES = 128  # lanes per slot in the coordinate arrays; k * k of them real


def script_inputs(device, B=4096, M=8, k=11, num_views=8, H=480, W=640,
                  seed=0):
    """The arrays of the JAX script's `run_variant` / `run_grad_variant`
    (same generator, same order of draws), as f32 / int32 tensors."""
    rng = np.random.default_rng(seed)
    P = 2 * num_views
    images = rng.uniform(0, 255, (P, H, W)).astype(np.float32)
    grad = np.concatenate(
        [images[:, :, 1:] - images[:, :, :-1], np.zeros((P, H, 1), np.float32)],
        axis=2,
    )
    y0 = rng.integers(0, (H - WIN_H) // 8, (B, M)).astype(np.int32) * 8
    views = rng.integers(0, P, (B, M)).astype(np.int32)
    row0 = views * H + y0
    x0 = rng.integers(0, (W - WIN_W) // 128, (B, M)).astype(np.int32) * 128
    xs = rng.uniform(10, 110, (B, M * LANES)).astype(np.float32)
    ys = rng.uniform(2, WIN_H - 6, (B, M * LANES)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {
        "stack": t(images.reshape(P * H, W)),
        "grad_stack": t(grad.reshape(P * H, W)),
        "row0": t(row0), "x0": t(x0),
        "xs": t(xs).reshape(B, M, LANES), "ys": t(ys).reshape(B, M, LANES),
        "n_real": k * k,
    }


def scores_bound(inp, scores, grad: bool):
    """(bound_ms, bound_by) of one scoring pass over `inp`."""
    B, M = inp["row0"].shape
    images = [inp["stack"]] + ([inp["grad_stack"]] if grad else [])
    corners = inp["row0"].to(torch.int64) * inp["stack"].shape[1] + inp["x0"]
    return _timing.window_bound(
        images, int(torch.unique(corners).numel()) * len(images),
        WIN_H * WIN_W * 4, B * M * inp["n_real"],
        (inp["row0"], inp["x0"], scores), _timing.SCORE_TEXEL_FLOPS,
    )


def run_shape(inp, reps=20):
    """Time every variant on `inp` (CUDA tensors); returns the record."""
    B, M = inp["row0"].shape
    args = (inp["stack"], inp["row0"], inp["x0"], inp["xs"], inp["ys"],
            inp["n_real"], WIN_H, WIN_W)
    runs = [(v, v, None) for v in window_ncc.VARIANTS] + [
        ("grad" if v == "full" else f"grad_{v}", v, inp["grad_stack"])
        for v in window_ncc.GRAD_VARIANTS
    ]
    variants = {}
    full = None  # scores of the two-tap `full`, the first run
    for label, variant, grad in runs:
        call = lambda: window_ncc.window_scores_cuda(  # noqa: E731
            *args, variant=variant, grad_stack=grad)
        scores = call()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(scores).all()):
            raise RuntimeError(f"variant {label}: non-finite scores")
        ms = _timing.time_ms(call, reps)
        entry = {"ms": ms, "ns_per_slot": 1e6 * ms / (B * M),
                 "max_abs_err_vs_full": None}
        if variant == "full":
            if full is None:
                full = scores
            entry["bound_ms"], entry["bound_by"] = scores_bound(
                inp, scores, grad is not None)
        if variant in window_ncc.SCORING_VARIANTS:
            # `grad` is held against the two-tap `full` as well: another
            # rounding of the same blend.
            entry["max_abs_err_vs_full"] = float(
                (scores - full).abs().max())
        variants[label] = entry
    return {
        "program": "kernel_ablate",
        "shape": {"B": B, "M": M, "n_real": inp["n_real"], "lanes": LANES,
                  "stack": list(inp["stack"].shape), "window": [WIN_H, WIN_W]},
        "card": _timing.card_line(),
        "variants": variants,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = _timing.cuda_device(args.device)
    with torch.cuda.device(device):
        print(json.dumps(run_shape(script_inputs(device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
