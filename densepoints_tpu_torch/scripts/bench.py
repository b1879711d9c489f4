"""The port's headline benchmark: refine throughput, one all-views scoring
pass, and end-to-end densification throughput, each with its spread.

    python -m densepoints_tpu_torch.scripts.bench [--out FILE]
        [--device cuda] [--config JSON]

Stands for the root `bench.py` of the JAX package, at its configuration,
on its inputs (`_rigs.bench_rig`: one `default_rng(0)` drawn in its order):
  1. refine throughput: `pmvs.optimize.optimize_patches` on 8 views of
     480 x 640, 4096 plane patches on z = 0, reference view 0, every view
     but view 0 visible, k = 11, 30 Nelder-Mead iterations. One warm-up
     run, then `refine_runs` timed runs, run i with the positions moved by
     (1 + i) 1e-4 (the JAX `fori_loop`'s perturbation of its timed call),
     each on the host's clock between two device synchronisations;
  2. one all-views scoring pass (K1, `ops.allview_ncc.allview_scores`) on
     the same rig, back to back and one call at a time (`_timing.time_ms`;
     on the CPU, the plain pass on the host's clock), with slot scores per
     second and its bound on this run's bytes and operations
     (`_timing.allview_counts`, `_timing.bound`);
  3. end to end on the bench sphere (12 views of 512 x 384, focal 450,
     radius 150, cameras at 500, texture 2048): 3000 seeds on the sphere
     (`default_rng(7)`) -> NCC filter -> compaction -> Nelder-Mead ->
     `pmvs.pipeline._densify_from(..., "seeds_optimized")` (expansion,
     filters, colour; `scripts.prescreen_ab.densify_from_seeds`), the
     `scan` profile with 4 rounds of 40 Nelder-Mead iterations, 120 seed
     iterations and grid_scale 4. One cold run, then `warm_runs` warm runs
     with the seeds moved by 1e-4, 2e-4, ....

A line with the refine and kernel numbers is printed before the end-to-end
section; the record is the last line. Rates and seconds of repeated runs
are given as min / median / max with every run's value. The counts of
warm run 1 (seeds moved by 1e-4, the JAX program's warm run) are the ones
to hold against `BENCH_r05.json`'s.

Departures from the JAX program:
  * Its `fraction_of_roofline` (a bf16 MXU bound over TPU windows) is
    gone: the kernel's time stands beside the H100's bound on this run's
    bytes (the distinct pixels the taps read) and f32 operations.
  * Every rate has a spread over several runs, where the JAX program took
    one reading; the record adds final patches, the median radial error
    of the cloud, K1 launches and plain scoring calls. No `vs_baseline`:
    no bar of the port is set.
  * `--out` has no default and nothing is written without it: the JAX
    program's records are never written. `--device` (default cuda) picks
    the device; `cpu` runs the plain scoring paths.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from densepoints_tpu_torch.scripts import (
    _rigs,
    _scene_runs,
    _timing,
    prescreen_ab,
)

TEXTURE = 11
JITTER = 1e-4

# The JAX program's shapes, iterations and (at least) its repetitions;
# `--config` overrides them.
CONFIG = {"refine_views": 8, "refine_height": 480, "refine_width": 640,
          "refine_patches": 4096, "refine_nm_iters": 30, "refine_runs": 5,
          "kernel_reps": 20,
          "views": _rigs.SPHERE["num_views"], "width": _rigs.SPHERE["width"],
          "height": _rigs.SPHERE["height"], "focal": _rigs.SPHERE["focal"],
          "tex_size": _rigs.SPHERE["tex_size"], "seeds": 3000,
          "max_rounds": 4, "nm_iters": 120, "expand_nm_iters": 40,
          "warm_runs": 5}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    _scene_runs.config_option(p, CONFIG)
    return p.parse_args(argv)


def spread(values) -> dict:
    """min / median / max of repeated readings, and the readings."""
    values = [float(v) for v in values]
    return {"min": min(values), "median": float(np.median(values)),
            "max": max(values), "runs": values}


def sphere_sizes(c) -> dict:
    return {"num_views": c["views"], "width": c["width"],
            "height": c["height"], "focal": c["focal"],
            "radius": _rigs.SPHERE["radius"],
            "cam_radius": _rigs.SPHERE["cam_radius"],
            "tex_size": c["tex_size"]}


def refine_section(images, cams, state, c, device):
    """Refine throughput: one warm-up run, then `refine_runs` timed runs."""
    import dataclasses

    from densepoints_tpu_torch.config import OptimizeConfig
    from densepoints_tpu_torch.pmvs.optimize import optimize_patches

    cfg = OptimizeConfig(max_iterations=c["refine_nm_iters"])

    def refine(shift):
        moved = dataclasses.replace(state, position=state.position + shift)
        return optimize_patches(images, cams, moved, TEXTURE, cfg)

    refine(0.0)
    seconds = [_timing.host_seconds(lambda: refine((1 + i) * JITTER),
                                    device)[1]
               for i in range(c["refine_runs"])]
    return spread(state.capacity / s for s in seconds), spread(seconds)


def pass_ms(fn, device, reps, batch):
    """Milliseconds per call of `fn`: CUDA events on a card
    (`_timing.time_ms`), the host's clock (median of `reps`) on the CPU."""
    if device.type == "cuda":
        return _timing.time_ms(fn, reps, batch=batch)
    fn()
    return 1e3 * float(np.median(
        [_timing.host_seconds(fn, device)[1] for _ in range(reps)]))


def kernel_section(images, cams, state, c, device):
    """One all-views scoring pass at the refine shape, against its
    bound."""
    from densepoints_tpu_torch.ops.allview_ncc import allview_scores

    args = (images, cams, state.position, state.normal, state.ref,
            state.vis, TEXTURE)
    out = allview_scores(*args)
    nbytes, flops = _timing.allview_counts(*args[:-1], out, TEXTURE)
    bound_ms, bound_by = _timing.bound(nbytes, flops)
    ms = pass_ms(lambda: allview_scores(*args), device, c["kernel_reps"],
                 10)
    ms_1call = pass_ms(lambda: allview_scores(*args), device,
                       c["kernel_reps"], 1)
    slots = int(state.vis.sum()) + state.capacity  # payload + anchors
    return {
        "kernel_ms_per_pass": ms,
        "kernel_ms_per_pass_1call": ms_1call,
        "kernel_slots": slots,
        "kernel_slot_scores_per_sec": slots / (ms * 1e-3),
        "kernel_bytes": nbytes, "kernel_flops": flops,
        "kernel_bound_ms": bound_ms, "kernel_bound_by": bound_by,
        "kernel_bound_share": bound_ms / ms,
    }


def e2e_section(c, sphere, device):
    """End to end on the bench sphere: one cold run and `warm_runs` warm
    runs."""
    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.core.cameras import Cameras
    from densepoints_tpu_torch.io.scene import Scene

    images_np = sphere.render_all()
    cams = Cameras.from_projection_matrices(
        sphere.P, widths=c["width"], heights=c["height"], device=device)
    scene = Scene(cameras=cams, images=images_np, colors=None)
    images = torch.as_tensor(images_np, device=device)
    seeds = _rigs.sphere_seeds(c["seeds"], _rigs.SPHERE["radius"])
    cfg = load_config(prescreen_ab.config_dict(c, "off"))  # the default

    def densify(i):
        return prescreen_ab.densify_from_seeds(images, cams, scene, cfg,
                                               seeds + i * JITTER)

    _, cold = _timing.host_seconds(lambda: densify(0), device)
    warm = [_timing.host_seconds(lambda: densify(i), device)
            for i in range(1, c["warm_runs"] + 1)]
    finals = [res.patches.capacity for (res, _), _ in warm]
    (first, metrics), _ = warm[0]
    cloud = first.positions
    radial = (np.abs(np.linalg.norm(cloud, axis=1) - _rigs.SPHERE["radius"])
              if len(cloud) else np.array([np.inf]))
    return {
        "e2e_patches_per_sec": spread(n / s for n, (_, s) in
                                      zip(finals, warm)),
        "densify_seconds": spread(s for _, s in warm),
        "densify_cold_seconds": cold,
        "stage_seconds": {k: [m.times[k] for (_, m), _ in warm]
                          for k in metrics.times},
        "densify_patches_final": finals[0],
        "patches_after_expand": int(
            metrics.counters["patches_after_expand"]),
        "patches_final_runs": finals,
        "median_radial_error": float(np.median(radial)),
    }


def run(args) -> dict:
    """The program's run; returns its record."""
    from densepoints_tpu_torch.ops import allview_ncc
    from densepoints_tpu_torch.pmvs.patch import PatchState

    device = _timing.run_device(args.device)
    c = args.config
    counter = _timing.Counts(device)
    refine_rig, sphere = _rigs.bench_rig(
        num_views=c["refine_views"], H=c["refine_height"],
        W=c["refine_width"], B=c["refine_patches"], sphere=sphere_sizes(c))
    cams, images, pos, nrm, ref, vis = _rigs.to_device(device, *refine_rig)
    state = PatchState.create(pos, nrm, ref, vis)
    marks = [allview_ncc.KERNEL_LAUNCHES]  # K1's count before each section
    refine_pps, refine_s = refine_section(images, cams, state, c, device)
    marks.append(allview_ncc.KERNEL_LAUNCHES)
    kernel = kernel_section(images, cams, state, c, device)
    marks.append(allview_ncc.KERNEL_LAUNCHES)
    record = {
        "program": "bench",
        "device": _scene_runs.device_label(device),
        "refine_shape": {"views": c["refine_views"],
                         "image": [c["refine_height"], c["refine_width"]],
                         "patches": c["refine_patches"],
                         "texture": TEXTURE,
                         "nm_iterations": c["refine_nm_iters"]},
        "refine_patches_per_sec": refine_pps,
        "refine_seconds": refine_s,
        **kernel,
    }
    print(json.dumps({**record, "note": "early line: e2e section pending"}),
          flush=True)
    e2e = e2e_section(c, sphere, device)
    marks.append(allview_ncc.KERNEL_LAUNCHES)
    return {
        **record,
        "e2e_scene": {"views": c["views"], "image": [c["height"],
                                                     c["width"]],
                      "focal": c["focal"], "seeds": c["seeds"],
                      "grid_scale": 4, "max_rounds": c["max_rounds"]},
        **e2e,
        "allview_ncc_launches_by_section": dict(zip(
            ("refine", "kernel", "e2e"), np.diff(marks).tolist())),
        **counter.read(),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
