"""The control of the correctness check, and the faults it must catch.

The control is the reference put in the place of the program's scoring
kernel, computed a precision below the configuration's float32: the
sampled texels and the NCC in bfloat16, the geometry in float32. It takes
both of the kernel's places: the NCC filter's view decision
(`pmvs.optimize.filter_by_error`) and the photometric objective that
Nelder-Mead minimises (`pmvs.optimize.photometric_objective_paged`, solved
eagerly, since the reference reads sizes on the host and cannot be
captured in a CUDA graph). It is the step that would tempt a later change
(the scoring kernel is bound by the bytes of its texels). `control_solve`
takes the objective's place alone, for a reading of what a lower
precision in the solve moves.

The faults break the timed path underneath a run, one each:
  * `nm_unchanged`: Nelder-Mead returns the state it was given;
  * `half_unscored`: the NCC filter leaves the second half of each batch
    unscored and keeps their views as given, judging only the rest;
  * `exchange_left_out` (a cell of several cards): each `all_gather` of
    the mesh (the seed front end's keypoints, the refine slices, the
    grids' writes; `parallel/mesh.py`'s and the name that
    `parallel/distributed.py` binds) keeps rank 0's part and zeroes the
    other ranks' rows, as rank 0's cloud would be without the exchange;
    the collective still runs on every rank, so the ranks stay in step
    and their state alike. The `all_reduce`s (Nelder-Mead's exit flag,
    the grids' claims and votes) still exchange.

    python3 benchmark/control.py --workload CELL --seeds S1,S2,... \\
        --seconds S --mode MODE

(MODE: sound, control, control_solve, nm_unchanged, half_unscored or
exchange_left_out) runs one window per seed in one process (on the card;
a cell of several cards, one job of its ranks a seed, each rank in MODE)
and prints, per seed, one JSON line of the numbers compared and whether
the run was correct.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def reference_scores(dtype):
    """The pipeline's `allview_scores` contract computed by the plain
    reference in `dtype`."""
    from benchmark import reference

    def score(images, cameras, position, normal, ref, vis, texture_size):
        cams = reference.RefCameras(
            cameras.K.cpu(), cameras.R.cpu(), cameras.C.cpu(),
            int(cameras.width.max()), int(cameras.height.max()),
            images.device)
        return reference.all_view_scores(
            images.to(dtype), cams, position, normal, ref.long(), vis,
            texture_size, dtype)

    return score


def reference_scorer(dtype):
    """The pipeline's `allview_scorer` contract (the stack and the cameras
    bound, then score(position, normal, ref, vis)) computed by the plain
    reference in `dtype`."""
    score = reference_scores(dtype)

    def scorer(images, cameras, texture_size):
        return lambda position, normal, ref, vis: score(
            images, cameras, position, normal, ref, vis, texture_size)

    return scorer


@contextlib.contextmanager
def _solve_in(dtype):
    """The objective scored by the reference in `dtype`, and Nelder-Mead
    run eagerly on it through its plain step."""
    from densepoints_tpu_torch.ops import simplex
    from densepoints_tpu_torch.pmvs import optimize

    def eager(f, x0, init_step, **kw):
        return simplex.nelder_mead(lambda params: f(params), x0, init_step,
                                   _eager=True, **kw)

    with _patched(optimize, "allview_scorer", reference_scorer(dtype)), \
            _patched(optimize, "nelder_mead", eager):
        yield


@contextlib.contextmanager
def control():
    import torch
    from densepoints_tpu_torch.pmvs import optimize

    with _patched(optimize, "allview_scores",
                  reference_scores(torch.bfloat16)), \
            _solve_in(torch.bfloat16):
        yield


@contextlib.contextmanager
def control_solve():
    import torch

    with _solve_in(torch.bfloat16):
        yield


@contextlib.contextmanager
def nm_unchanged():
    from densepoints_tpu_torch.pmvs import optimize

    def unchanged(f, x0, init_step, **kw):
        return x0, None, None

    with _patched(optimize, "nelder_mead", unchanged):
        yield


@contextlib.contextmanager
def half_unscored():
    from densepoints_tpu_torch.pmvs import optimize

    real = optimize.allview_scores

    def half(images, cameras, position, normal, ref, vis, texture_size):
        scores, anchor, anchor_ok = real(images, cameras, position, normal,
                                         ref, vis, texture_size)
        rest = scores.shape[0] // 2
        scores[rest:] = 1.0
        return scores, anchor, anchor_ok

    with _patched(optimize, "allview_scores", half):
        yield


@contextlib.contextmanager
def exchange_left_out():
    from densepoints_tpu_torch.parallel import distributed
    from densepoints_tpu_torch.parallel import mesh as pmesh

    real = pmesh.all_gather

    def rank0_only(mesh, t):
        out = real(mesh, t)
        if mesh.world_size > 1:
            out = out.clone()
            out[t.shape[0]:] = 0
        return out

    with _patched(pmesh, "all_gather", rank0_only), \
            _patched(distributed, "all_gather", rank0_only):
        yield


MODES = {"sound": contextlib.nullcontext, "control": control,
         "control_solve": control_solve, "nm_unchanged": nm_unchanged,
         "half_unscored": half_unscored,
         "exchange_left_out": exchange_left_out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--mode", choices=sorted(MODES), default="control")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if cell["chips"] > 1:
            from benchmark import ranks

            result, checks, _ = ranks.run_job(cell, seed, args.seconds,
                                              False, "cuda", t,
                                              mode=args.mode)
        else:
            result, checks = harness.run_cell(cell, seed, args.seconds,
                                              False, "cuda", t,
                                              window=MODES[args.mode])
        print(json.dumps({
            "workload": args.workload, "mode": args.mode, "seed": seed,
            "correct": result["correct"], "scenes": result["attempted"],
            "scene_s": result["metrics"]["scene_s"]["value"],
            **{c["name"]: c["value"] for c in checks},
            "scenes_judged": result["verdicts"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
