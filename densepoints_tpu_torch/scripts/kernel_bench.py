"""The slot warp + NCC kernel (K2) alone against the scoring pass around it,
on a CUDA card.

    python -m densepoints_tpu_torch.scripts.kernel_bench [--out FILE]
        [--device cuda] [--config JSON]

Stands for `scripts/kernel_bench.py` of the JAX package at its shape and
on its rig (`_rigs.kernel_bench_rig`: 8 views of 480 x 640, B = 4096 plane
patches, M = 8 slots, k = 11, `default_rng(0)`), at two levels:
  1. K2 alone: `ops.warp_ncc.slot_scores_cuda` on fixed slot tables (the
     visible views compacted to M slots once, `ops.warp.compact_visible`);
  2. the full scoring pass, `ops.warp_ncc.patch_ncc_scores_fused`: the
     compaction, the conversions of the wrapper and K2.
Each level is timed back to back (`_timing.time_ms`: 10 calls queued behind
a device-side sleep, the median of 20 timings) and one call at a time (as
a caller makes it); the gap between the levels is what surrounds the
kernel. The record also gives slot scores per second and the kernel's
bound on this run's bytes and operations (`_timing.slot_counts`: the
distinct image pixels its taps read, `_timing.tap_pixels`).

Departures from the JAX program:
  * The JAX level 1 fed 56 x 128 windows, column phases and a doubled
    stack (`images2`): TPU window mechanics the port's kernel does not
    have. K2 takes the same B x M slots as the full pass.
  * The bf16 MXU "ideal" lines are gone: the bound is the H100's, from
    this run's bytes and f32 operations. No `fori_loop`, perturbation or
    harness floor: CUDA events time the card.
  * `--out` has no default; `--device` must name a CUDA card (ValueError
    otherwise: there is no CPU mode).
"""
from __future__ import annotations

import argparse
import sys

from densepoints_tpu_torch.scripts import _rigs, _scene_runs, _timing

K, M = 11, 8


# The JAX program's batch and timing; `--config` overrides them.
CONFIG = {"patches": 4096, "reps": 20}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    _scene_runs.config_option(p, CONFIG)
    return p.parse_args(argv)


def run(args) -> dict:
    """The program's run; returns its record."""
    import torch

    from densepoints_tpu_torch.ops import warp_ncc
    from densepoints_tpu_torch.ops.warp import compact_visible

    device = _timing.cuda_device(args.device)
    reps = args.config["reps"]
    counter = _timing.Counts(device)
    cams, images, pos, nrm, ref, vis = _rigs.to_device(
        device, *_rigs.kernel_bench_rig(B=args.config["patches"], M=M))
    ids, ok = compact_visible(vis, M)
    kargs = (images, cams.K.contiguous(), cams.E.contiguous(),
             cams.C.contiguous(), cams.x_axis.contiguous(), cams.width,
             cams.height, pos, nrm, ref, ids, ok, K)
    levels = {
        "kernel": lambda: warp_ncc.slot_scores_cuda(*kargs),
        "full_pass": lambda: warp_ncc.patch_ncc_scores_fused(
            images, cams, pos, nrm, ref, vis, K, max_score_views=M),
    }
    alone = levels["kernel"]()
    full, full_ids, full_ok = levels["full_pass"]()
    torch.cuda.synchronize(device)
    if not (torch.equal(full_ids, ids)
            and torch.equal(full_ok, ok)):
        raise RuntimeError("the full pass compacted other slots")
    diff = float((alone - full).abs().max())
    B = pos.shape[0]
    nbytes, flops = _timing.slot_counts(images, cams, pos, nrm, ref, ids,
                                        ok, alone, K)
    bound_ms, bound_by = _timing.bound(nbytes, flops)
    out = {}
    for name, fn in levels.items():
        ms = _timing.time_ms(fn, reps)
        out[name] = {
            "ms": ms,
            "ms_1call": _timing.time_ms(fn, reps, batch=1),
            "slot_scores_per_sec": B * M / (ms * 1e-3),
            "bound_ms": bound_ms,
            "bound_share": bound_ms / ms,
        }
    return {
        "program": "kernel_bench",
        "device": _scene_runs.device_label(device),
        "shape": {"views": images.shape[0], "image": list(images.shape[1:]),
                  "B": B, "M": M, "texture": K,
                  "visible_slots": int(ok.sum())},
        "levels": out,
        "gap_ms": out["full_pass"]["ms"] - out["kernel"]["ms"],
        "gap_ms_1call": (out["full_pass"]["ms_1call"]
                         - out["kernel"]["ms_1call"]),
        "max_abs_diff_levels": diff,
        "bytes": nbytes, "flops": flops, "bound_by": bound_by,
        **counter.read(),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
