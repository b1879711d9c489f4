#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`densepoints_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-allview
    python3 chip_smoke.py --dump-scores FILE
    python3 chip_smoke.py --compare-scores FILE FILE
    python3 chip_smoke.py --time-window
    python3 chip_smoke.py --time-ncc
    python3 chip_smoke.py --profile-main
    python3 chip_smoke.py --kernel-resources
    python3 chip_smoke.py --dtu
    python3 chip_smoke.py --profile-dtu
    python3 chip_smoke.py --measure
    python3 chip_smoke.py --bench
    python3 chip_smoke.py --cards
    python3 chip_smoke.py --nm-graph
    python3 chip_smoke.py --nm-compare

Phases, each printing its own lines; any failure exits non-zero and prints
no result line:
  1. device: the card's name and `nvidia-smi` name/power limit (a CUDA card
     is required; there is no CPU fallback);
  2. build: compiles every CUDA kernel of the package from the sources in
     this checkout (one nvcc per source, all at once, then one link;
     sm_90a) and prints the build seconds;
  3. all-views kernel vs plain: `ops.allview_ncc` against its plain torch
     version on the card at the refine shape (8 views of 480 x 640, 4096
     patches, k = 11 and 16, plus mixed-visibility, no-visibility and
     off-frustum rows) and a DTU shape (49 views of 1600 x 1200, 16384
     patches, ~25 visible views each, k = 16): scores within 1e-4, equal
     anchors, equal sentinel placement; CUDA-event times of both; then at
     small awkward shapes (1 and 130 views, k = 1, 5, 7 and 21, batches of
     0 and 1) and at view counts past 254, which the kernels take in tiles
     of 32 views (255; 312 at k = 11 and 16 with 4096 patches; 1100; 300
     at k = 21 and 31, the strided variant; each with a row whose only
     visible view lies in the last tile and a row whose anchor is
     off-frustum while the last tile holds the footprint), and a profile
     showing that the entry point runs one device kernel and nothing
     before it;
  4. row-wise NCC kernel vs plain: `ops.ncc` at (32768, 121) and
     (262144, 256), maskless and masked (with empty-mask rows), timed back
     to back and over rotated input sets (the record keeps the rotated
     time, which may not fall under the bound); then untimed, at 20 row
     lengths from L = 1 to 300
     (every register tier of the group body and the strided body) and N =
     1, 1001, 20001, with flat rows, empty-mask and single-entry rows and
     rows of mean ~200 and spread ~2: within 1e-5, equal sentinels;
  5. slot kernel vs plain: `ops.warp_ncc` at the refine shape (8 slots,
     k = 11 and 16) and the DTU shape (4 anchor-pinned chunks of 16 slots,
     k = 16): scores within 1e-4, equal sentinel placement; the awkward
     shapes too, with a table of one slot, a table of 300 slots over the
     312-view rigs and view ids outside the stack;
  6. window kernels vs plain: `ops.window_ncc` (`full`, `staged`, `block`,
     and the gradient form against its own plain version) and
     `ops.window_textures` (`full`, `staged`, `block`) at the shapes of the
     two ablation programs and at one awkward shape each (a patch count
     that is no multiple of 8, k = 16, taps outside the window, windows
     over the stack's edges, dead slots), then at n = 1, 32, 33, 121, 256
     and 300 texels (each texels-per-lane layout of the warp bodies and the
     strided one) and at n = 121 in coordinate rows of 123 floats (the
     scalar coordinate loads): scores within 1e-4, textures within 1e-3
     grey levels, dead slots exactly zero; and M1,
     `features.matching.hamming_topk_cuda`, against its plain version
     (`_ranked_hamming` on the card: the f32 GEMM, the N x M passes and
     `torch.topk`, in the seed stage's chunks of pairs) at the seed
     stage's shapes, one launch for 32 DTU pairs of 8192 keypoints and 64
     temple pairs of 4096 (256 bits, k = 2), timed beside its bound (int8
     products at 1,979 TOPS or the epilogue's integer operations), then
     untimed at 1024 bits (rows taken in slices) and at 600 bits with
     k = 1 and 300 x 257 keypoints: idx and dist bitwise equal;
  7. the slot-scoring path: `pmvs.patch_ncc_scores` and the chunked
     `photometric_objective` through the slot kernel ("auto", "fused") and
     through torch gathers + the row-wise NCC kernel ("xla"), held against
     each other and against the all-views objective at the refine and DTU
     shapes, then 30 Nelder-Mead iterations on the chunked objective; every
     launch counter set to 0 just before;
  8. the ablation path: `scripts.kernel_ablate` and
     `scripts.kernel_paged_ablate` through their `main()` at their full
     shapes, every launch counter set to 0 just before; every variant
     timed, the score-computing ones held against `full`;
  9. the alternative seed front end on the sphere scene: FAST corners and
     the `hamming_absolute`, `epipolar` and `epipolar_all` matchers through
     `generate_seed_points`, then the CLI with `expand.prescreen = "claim"`
     (patch count and radial error checked, pre-screen counts printed);
  10. main path: `densepoints_tpu_torch.cli.main` on a 12-view 512 x 384
     textured-sphere scene written as PNG files + scene JSON, with every
     launch counter set to 0 just before; checks the counters (M1
     launched once, `seed_match_pairs` counted), the PLY, the patch count
     and the radial error against the analytic sphere;
  11. the rest of the pipeline, each a CLI run on the sphere with every
     counter set to 0 just before it, K1 launched and no plain call, at
     least 1000 patches and (but for BA) a median radial error under 1.5:
     `[ckpt]` a run with `--checkpoint-dir` writes its three stage files,
     and `--resume` from `seeds_optimized` alone gives the same patch
     count and positions within 1e-4 (the largest difference printed);
     `[multiscale]` two pyramid levels, seconds per level; `[ba]`
     `ba.enable` on the scene with the P of views 1-11 turned by +-0.002
     rad and on the exact scene: the seeds' RMSE falls, comes within 10%
     of what BA reaches from the exact cameras, and the two clouds' radial
     errors lie within 1.5 of each other; `[mesh]` `--mesh`, vertices and
     faces, finite, median radial error under a voxel, TSDF seconds;
     then `extract_surface` twice on phase 10's cloud, the two meshes
     bitwise equal (the fusion sums in a fixed order), with the fusion
     seconds beside the ones of the `index_add_` fusion before;
     `[debug]` / `[profile]` one run with `--debug-dir` (seed and final
     clouds, 12 occupancy images) and `--profile-dir` (a trace naming
     K1's kernel); `[native]` the native runtime built and loaded, the
     main path's seed seconds with it; `[metrics]` accuracy /
     completeness of phase 10's cloud against 20,000 samples of the
     sphere at threshold 1.5;
  12. the multi-process paths on the sphere (`[parallel]`), each rank a
     child process of this script (`--parallel-rank`, killed with the
     others past 300 s; any rank's failure fails the phase), every counter
     at 0 in each rank before its run, K1 launched and no plain call on
     every rank: a, the CLI's `--distributed` on 1 rank (NCCL), its cloud
     the main path's (count, `vis` and positions within 1e-5); b, 2 ranks
     on the one card (gloo), the ranks' clouds bitwise equal and equal to
     a's; a_launch, the CLI's `--distributed` with no --coordinator, one
     rank per card the process sees (one here), and a_visible, job a in a
     process that sees only CUDA_VISIBLE_DEVICES=0: each NCCL and a's cloud
     bitwise; c, `densify_clustered` on shared seeds on 1 and 2 ranks holding
     every view (count exact, positions within 5e-3), and the CLI's
     `--partition clustered --halo-threshold 0.5` on 2 ranks, each holding
     fewer image bytes than the stack; d, `run_ba_sharded` on 2 ranks on
     the turned calibration, its RMSE within twice the single-rank
     solver's spread over 5 orders of its sums (at least 1e-3 px) of the
     single rank's. Each `[parallel]` line gives the rank's backend, K1
     launches, patches, radial error, stage seconds and the traffic of
     its collectives, and each CLI job's rank table (rank, host, card, the
     card's UUID's first 8 characters). Between b and c, the in-process
     API from this process (every counter at 0 before each call):
     a_inproc, `densify_multihost(mesh=make_mesh(4))` (one rank on one
     card, so in place) with a's cloud bitwise and a's K1 launches, and
     `densify_distributed` with `parallel.num_devices` 0 and 4, each its
     own `make_mesh(1)` run's cloud bitwise; a_local1 and b_local2, the
     runner of `parallel.local_job` on `densify_multihost` with 1 rank
     (NCCL) and 2 ranks sharing the card (gloo), each a's cloud bitwise,
     every rank's card, UUID, K1 launches (a's) and plain calls (none)
     printed, no process group left in this process, and the call's wall
     beside job a's or b's. `--parallel` runs phases 10 and 12 alone;
  13. the three end-to-end programs of `densepoints_tpu_torch.scripts`
     through their `run` in four runs (`[dtu]`), each with every counter
     at 0 just before: a, `dtu_scale_run` at `DTU_r05.json`'s
     configuration (49 views of 1600 x 1200, kp 8192, 6 per cell, 120 / 40
     Nelder-Mead iterations, 25 score views, grid_scale 8, 20 rounds; no
     depth cut); b, `dtu_layout_run` and c, `occlusion_run` at their
     defaults, the configurations of their JAX records (21 views of 800 x
     600 through the on-disk DTU tree, with nuisances); d, `dtu_scale_run`
     with run a's flags at Middlebury `temple`'s 312 views of 640 x 480
     (focal 1160, run a's field of view; grid_scale 4; 12 rounds; no JAX
     record). Each run prints its render, stage and densify seconds,
     counts, K1 launches and plain calls, peak allocation, mean visible
     views per patch and quality, and its counts beside the JAX record's
     where there is one; it fails if a stage raises, K1 is never launched,
     a plain scoring call is made, or a quality gate is missed (a, b, c set
     from the JAX record; a: exact median under one pixel footprint, 650 /
     2900 mm, completeness under 2 mm >= 0.95, >= 10,000 patches; b: exact
     median under 0.5 mm, >= 1,500 patches; c: the occlusion filter's kept
     patches' median distance to the surface union under 2 mm; d: run a's
     gates at its own pixel footprint, exact median under 650 / 1160 mm,
     completeness under 2 mm >= 0.95, >= 5,000 patches). Run a's largest
     Nelder-Mead call holds the step kernels against their plain twins as
     phase 16 does at the sphere (`[nm-step] ... dtu_a_largest`). `--dtu`
     runs phase 13 alone; `--profile-dtu` runs a under `torch.profiler` (key
     averages, no trace file) and prints its device ops, device time, K1's
     time and launches, the ten costliest kernels and the device-busy
     share of `densify`'s wall;
  14. the measurement programs of `densepoints_tpu_torch.scripts`
     (`[measure]`), each through its `run` at its own defaults (the JAX
     package's configurations; nothing is cut), every counter at 0 just
     before: `expand_profile` (one expansion round of the bench sphere,
     phase by phase, cold and warm), `kernel_bench` (K2 alone against the
     full slot-scoring pass), `kernel_paged_bench` (the all-views pass
     against the chunked one at three shapes), `kernel_roofline` (K1 and
     K2 against their bounds at the refine and DTU shapes),
     `prescreen_ab` (the pre-screen's three modes on the sphere),
     `scaling_overhead` (the multi-process driver's overhead counters on
     one rank and the model built on them), `scaling_measure` (jobs of 1,
     2 and 4 `scaling_worker` processes sharing the card) and
     `scaling_bench` (the distributed refine step at 1 rank). Each prints
     its record; the phase fails if a program raises, K1 (or K2 where the
     program scores with it) is never launched, a plain scoring call is
     made (the workers' counts for the two programs that run workers), a
     program writes into the checkout or the working directory (a file
     added or changed outside the kernels' build and bytecode caches; the
     `--out` of the run is never written by `run`), a number of a record
     is not finite, or `prescreen_ab`'s mode `off` ends more than 10% off
     `PRESCREEN_r05.json`'s 4491 final patches. `--measure` runs phase 14
     alone;
  15. the port's bench program (`[bench]`), `scripts.bench` through its
     `run` at the root `bench.py`'s configuration, nothing cut (refine
     throughput over 5 timed runs, K1 alone against its bound, and the
     bench sphere end to end, cold and 5 warm runs and one profiled), with
     phase 14's checks and its final and after-expansion patches within
     10% of `BENCH_r05.json`'s 4648 and 6293 and a median radial error
     under 1.5; then (`[entry]`) `entry.entry()` once on the card (K1
     launched, no plain call, finite positions) and
     `entry.dryrun_multichip(8)`, eight gloo ranks sharing the card, which
     must print "refined 16 patches, 4 inserted" (`MULTICHIP_r05.json`),
     and nothing written into the checkout or the cwd. `--bench` runs
     phase 15 alone;
  16. (run right after phase 10) Nelder-Mead as captured CUDA graphs of
     the step kernels (`[nm-graph]`, `[nm-step]`; a step of the
     photometric objective is `nm_reflect`, K1, `nm_contract`, K1,
     `nm_accept`, `csrc/nm_step.cu`): phase 10's run captured and
     replayed graphs and launched each step kernel once a step; the CLI
     on the sphere through the eager witness (the kernel steps run
     eagerly on the card, the solver's private `_eager`) at m = 1 (and at
     the default m if it is not 1), and through graphs of m = 1, 2, 4 and
     8 steps (its private `_block_steps`), each cloud bitwise equal to
     phase 10's, and through the torch step (the objective handed to the
     solver as a plain callable), whose cloud must be within 2% of the
     count and under the radial error's gate; each a row of the table, the
     median of 3 runs (CLI wall, stage seconds, K1 and step-kernel
     launches, captures, replays, steps, solver calls, distinct (B, k)
     shapes, iterations, host ms per iteration, and the first expansion
     call's step: device ms by CUDA events around a replay, host ms from
     one replay to the next); m = 1 launches K1 exactly as often as the
     witness at m = 1 (the per-iteration loop), the default m at most
     2 (m - 1) more times per solver call; K1 launches of the kernel and
     the torch step side by side. Then the three step kernels against
     their plain twins along the sphere's first expansion call (every
     step, on the same inputs: sorts, `done`, `iters`, the step and the
     exit flag exactly, f32 values within 1e-6 relative above magnitude
     1; lanes whose branch test lies within 1e-6 of its threshold are
     counted as branched apart) and timed back to back beside their
     bound; phase 13 does the same at DTU run a's largest call. Then one
     run under `torch.profiler`, whose K1 and step-kernel device kernels
     must number what the counters say (launches inside a graph counted
     at each replay). Every sphere CLI run and every phase-13 run prints
     its captures, replays, steps and step-kernel launches on an
     `[nm-graph]` line. `--nm-graph` runs phases 10 and 16 alone.
Each kernel's time stands beside its bound: the larger of the bytes it must
move (every input read once, every output written once; of the image stack
no more than the 4 taps of every texel this run's data samples) over
3.35 TB/s and the f32 operations the function needs on this run's data over
67 TFLOP/s (H100 SXM data sheet; `densepoints_tpu_torch/scripts/_timing.py`,
whose `time_ms` also times every kernel: 10 calls back to back behind a
device-side sleep).
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.

With `--time-allview` the script only builds the kernels and prints one
JSON line of kernel-only times (three medians of 50 CUDA-event timings):
the all-views kernel at the refine k = 11, k = 16 and DTU k = 16 shapes,
the slot kernel at the refine k = 11 shape (8 slots) and on the first DTU
chunk (16 slots), both kernels again on the DTU shape's first 512 patches
(`dtu_k16_b512`), the all-views kernel past 254 views (312 views at k = 11
and 16 with 4096 patches, 1100 views with 256, each beside its bound, or
the refusal of a tree whose kernel refuses the shape), and the entry point
`allview_scores` at the refine k = 11 shape (`wrapper_refine_k11_ms` by
CUDA events, `wrapper_host_refine_k11_ms` on the host's clock until the
call returns). It takes the package
from the directory it lies in, so a copy of it placed in a checkout of
another commit, with this commit's `densepoints_tpu_torch/scripts/
_timing.py` copied beside it, times that commit's kernels: run the two in
turns (parent, change, change, parent) within one job to compare them on
one card. `--time-window` does the same for `full` of the two window
kernels: K4 at the ablation program's shape and the awkward one, K5 at
both of its program's shapes and the awkward one.
`--time-ncc` does the same for the row-wise NCC kernel at (32768, 121) and
(262144, 256), maskless and masked, each b2b time beside a rotated one
(the calls take turns over at least 4 seeded input sets larger than twice
the L2 cache together, so each call reads device memory) and the bound.
`--dump-scores FILE` saves the outputs of K1 and K2 at the refine, DTU
and awkward shapes of at most 254 views, and `--compare-scores A B` holds
two such files equal with `torch.equal` (no card needed): run the first
in two checkouts to compare their kernels' outputs bitwise.
`--cards` runs the sphere over every card of the host (a host of several
cards: the jobs of phase 12 need no more than one): a 1-rank reference,
one `--distributed` CLI process driving a rank per card, and one process
per card each seeing only its own; each must pick NCCL on distinct cards
and give the reference's cloud within 1e-5. Then the in-process API from
this process with `make_mesh(4)` (min(4, cards) ranks): `densify_multihost`
(NCCL on cards 0-3 with distinct UUIDs, the reference's cloud bitwise,
its K1 launches on every rank, no plain call), `densify_distributed`
(its 1-rank run's `vis`, positions and normals within 1e-5), and on the
turned calibration `generate_seed_points` and `run_ba_sharded` (the
RMSE within phase 12 d's tolerance of the single-rank solver's).
`--profile-main` runs the CLI on the sphere scene under `torch.profiler`
and prints one JSON line of its device ops, launches, the device-busy
share of the CLI's wall and stage seconds.
`--nm-compare` prints one `[nm-compare]` JSON line of what the solver's
step moves: the sphere CLI warm (solver calls, distinct (B, k) shapes,
iterations, host ms per iteration, stage seconds, launches, the first
expansion call's step: device ms by CUDA events around a replay, host ms
from one replay to the next) and its device ops and device-busy share,
one warm `expand_profile` round's `optimize_nm` against the round, DTU
run a's stage seconds, peak allocation, solver calls, its largest call's
step and device-busy share, runs b, c and d's stage seconds, and
`scripts.bench`'s e2e patches/s; like `--time-allview`, a copy placed in
another checkout measures that tree.
`--kernel-resources` prints the registers, stack and spills `ptxas`
reports for every kernel instance of the two warp + NCC kernels, the
row-wise NCC kernel (none of whose instances may spill) and the two window
kernels, the source lines where the warp + NCC kernels' spills sit
(`spill_lines`), and the instruction count and a digest of the SASS of every
function in the library the package built: run in two checkouts, or in one
with another `ops/_build.py`, it says whether two builds made the same code.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCORE_ATOL = 1e-4  # f32 kernel vs f32 plain: summation order only
BORDER_PX = 1e-3  # sentinel flips allowed only this close to a border
NCC_ATOL = 1e-5  # row-wise NCC, f32 kernel vs f32 plain: summation order
OBJ_ATOL = 5e-4  # chunked vs all-views objective: two derivations, f32
# Window kernels vs plain, f32 both: fused multiply-adds and summation order
# on scores in [-1, 1], and on centred textures of grey levels around +-128
# (whose f32 resolution is 1.5e-5).
WINDOW_SCORE_ATOL = 1e-4
WINDOW_TEXTURE_ATOL = 1e-3
GRAD_VS_FULL_ATOL = 1e-3  # left + fx * grad vs the two-tap blend, f32
SPHERE_RADIUS = 150.0
# Row-wise NCC, per element: two sums, two centrings, three products and
# three sums (10); the mask adds five multiplies and a count (15).
NCC_ELEMENT_FLOPS = {False: 10, True: 15}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    import torch

    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: this run needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch: {name} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"[device] nvidia-smi: {smi_line}", flush=True)
    return name, smi_line


def phase_build():
    """One nvcc per source builds every kernel (allview_ncc, slot_ncc,
    ncc_pairs, window_ncc, window_textures) into one library; the bindings
    fail later if a symbol is missing."""
    from densepoints_tpu_torch.ops import allview_ncc

    t0 = time.perf_counter()
    lib = allview_ncc.build_kernel()
    dt = time.perf_counter() - t0
    print(f"[build] {lib.relative_to(ROOT)} in {dt:.2f} s", flush=True)


def _result(err, ms, bound):
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound[0], "bound_by": bound[1]}


def _corner_margin(cams, pos, frames, b, v):
    """Smallest distance (px) of patch b's 4 corners to view v's border."""
    import torch

    sx, sy = frames
    offs = torch.stack([-sx[b] - sy[b], sx[b] - sy[b], sx[b] + sy[b],
                        -sx[b] + sy[b]])
    pix = cams.project(pos[b] + offs)[v]  # (4, 2)
    w, h = float(cams.width[v]), float(cams.height[v])
    return float(torch.stack([pix[:, 0], w - pix[:, 0], pix[:, 1],
                              h - pix[:, 1]]).abs().min())


def _time_ms(fn, reps=20, batch=1):
    """Median CUDA-event milliseconds per call over `reps` timings of `fn`
    (call it warm), `batch` calls back to back per timing
    (`scripts._timing.time_ms`)."""
    from densepoints_tpu_torch.scripts import _timing

    return _timing.time_ms(fn, reps, warm=0, batch=batch)


KERNEL_BATCH = 10  # calls per timing of a kernel alone


def _kernel_args(fn, cams, images, pos, nrm, ref, k, **extra):
    """Positional arguments of a kernel wrapper (`allview_scores_cuda`,
    `slot_scores_cuda`), picked by the names in its signature: the cameras'
    arrays, position, normal and reference view, `extra` (visibility or
    slots), and precomputed frames `sx`, `sy` for a checkout whose kernels
    still take them."""
    import inspect

    import torch

    names = list(inspect.signature(fn).parameters)
    pool = {"images": images, "K": cams.K.contiguous(),
            "R": cams.R.contiguous(), "E": cams.E.contiguous(),
            "C": cams.C.contiguous(), "x_axis": cams.x_axis.contiguous(),
            "width": cams.width, "height": cams.height,
            "position": pos.contiguous(), "normal": nrm.contiguous(),
            "ref": ref.to(torch.int64).contiguous(), "texture_size": k,
            **{name: t.contiguous() for name, t in extra.items()}}
    if "sx" in names:
        from densepoints_tpu_torch.ops.warp import patch_frames

        sx, sy = patch_frames(cams, pos, nrm, ref, k)
        pool.update(sx=sx.contiguous(), sy=sy.contiguous())
    return tuple(pool[name] for name in names)


def _device_kernels(fn, attempts=3):
    """Names of the device kernels one call of `fn` launches. A trace with
    no device event at all (the profiler's tracer has handed one back on a
    card that ran the call) is taken again, up to `attempts` times; it is
    never read as a call that launched nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = []
        for event in prof.key_averages():
            if event.device_type == torch.autograd.DeviceType.CUDA:
                names += [event.key] * event.count
        if names:
            break
    return names


def check_kernel(label, cams, images, pos, nrm, ref, vis, k):
    """The all-views kernel vs its plain version on one input set: anchors,
    sentinel placement and scores; returns (scores, anchor, anchor_ok,
    max_abs_err, scored, sentinel flips) of the kernel's run."""
    import torch

    from densepoints_tpu_torch.ops import allview_ncc
    from densepoints_tpu_torch.ops.warp import patch_frames

    args = (images, cams, pos, nrm, ref, vis, k)
    sk, ak, okk = allview_ncc.allview_scores(*args)
    sp, ap, okp = allview_ncc.allview_scores_plain(*args)
    torch.cuda.synchronize()
    check(sk.shape == sp.shape and sk.dtype == torch.float32,
          f"{label}: scores {tuple(sk.shape)} {sk.dtype}")
    check(bool((ak == ap).all()), f"{label}: anchors differ")
    check(bool((okk == okp).all()), f"{label}: anchor_ok differs")
    flips = ((sk == -1) != (sp == -1)).nonzero().tolist()
    frames = patch_frames(cams, pos, nrm, ref, k)
    for b, v in flips:
        margin = _corner_margin(cams, pos, frames, b, v)
        print(f"  [{label}] sentinel differs at (patch {b}, view {v}): "
              f"kernel {float(sk[b, v]):.6f} plain {float(sp[b, v]):.6f}, "
              f"corner {margin:.2e} px from the border", flush=True)
        check(margin < BORDER_PX,
              f"{label}: sentinel placement differs away from a border")
    both = (sk != -1) & (sp != -1)
    err = float((sk - sp)[both].abs().max()) if bool(both.any()) else 0.0
    check(err <= SCORE_ATOL, f"{label}: max |kernel - plain| {err:.3e}")
    check(bool(torch.isfinite(sk).all()), f"{label}: non-finite scores")
    return sk, ak, okk, err, int(both.sum()), len(flips)


def compare_kernel(label, cams, images, pos, nrm, ref, vis, k):
    """Kernel vs plain on one input set, then the times of both."""
    from densepoints_tpu_torch.ops import allview_ncc
    from densepoints_tpu_torch.ops.warp import patch_frames
    from densepoints_tpu_torch.scripts import _timing

    args = (images, cams, pos, nrm, ref, vis, k)
    sk, ak, okk, err, scored, flips = check_kernel(
        label, cams, images, pos, nrm, ref, vis, k)
    frames = patch_frames(cams, pos, nrm, ref, k)
    # Times of the kernel alone, of the plain version on ready frames, and
    # of the whole entry point `allview_scores`.
    kargs = _kernel_args(allview_ncc.allview_scores_cuda, cams, images, pos,
                         nrm, ref, k, vis=vis)
    runs = {
        "kernel": lambda: allview_ncc.allview_scores_cuda(*kargs),
        "plain": lambda: allview_ncc.allview_scores_plain(*args,
                                                          frames=frames),
        "wrapper": lambda: allview_ncc.allview_scores(*args),
    }
    ms = _time_runs(runs)
    B, V = vis.shape
    bound = _timing.bound(*_timing.allview_counts(
        images, cams, pos, nrm, ref, vis, (sk, ak, okk), k))
    print(f"[allview_ncc] {label}: B={B} V={V} k={k} slots={int(vis.sum())} "
          f"scored={scored} max_abs_err={err:.3e} "
          f"sentinel_flips={flips} kernel_ms={ms['kernel']:.4f} "
          f"plain_ms={ms['plain']:.4f} wrapper_ms={ms['wrapper']:.4f} "
          f"bound_ms={bound[0]:.5f} ({bound[1]})", flush=True)
    return _result(err, ms, bound)


def _time_runs(runs, reps=20):
    """Times of named runs; the runs named "kernel" and "b2b" (a kernel's
    wrapper alone) are timed back to back, the others call by call."""
    for fn in runs.values():  # warm
        fn()
        fn()
    return {name: _time_ms(fn, reps,
                           KERNEL_BATCH if name in ("kernel", "b2b") else 1)
            for name, fn in runs.items()}


NCC_TIMED = ((32768, 121), (262144, 256))  # refine k=11; one DTU chunk


def _ncc_inputs(N, L, masked, device, seed):
    """Seeded (N, L) pairs: b correlated with a, and with `masked` a mask
    of ~70% entries."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda: torch.rand((N, L), generator=gen, device=device)  # noqa: E731
    a = rand() * 255.0
    b = 0.6 * a + 0.4 * 255.0 * rand()
    mask = (rand() > 0.3).to(torch.float32) if masked else None
    return a, b, mask


def compare_ncc_pairs(N, L, masked, device):
    """The row-wise NCC kernel vs plain on seeded (N, L) pairs."""
    import torch

    from densepoints_tpu_torch.ops import ncc
    from densepoints_tpu_torch.scripts import _timing

    a, b, mask = _ncc_inputs(N, L, masked, device, seed=N + L + int(masked))
    a[2] = 7.0  # a flat row: the 0.1 clamp decides
    if masked:
        mask[::1000] = 0.0  # rows with an empty mask: the -1 sentinel
    label = f"N={N} L={L} {'masked' if masked else 'maskless'}"
    got = ncc.ncc_pairs(a, b, mask)
    want = ncc.ncc_pairs_plain(a, b, mask)
    torch.cuda.synchronize()
    check(got.shape == (N,) and got.dtype == torch.float32, f"{label}: shape")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite scores")
    check(bool(((got == -1) == (want == -1)).all()),
          f"{label}: sentinel placement differs")
    if masked:
        check(int((got == -1).sum()) == len(range(0, N, 1000)),
              f"{label}: empty-mask rows are not exactly the -1 rows")
    err = float((got - want).abs().max())
    check(err <= NCC_ATOL, f"{label}: max |kernel - plain| {err:.3e}")
    inputs = (a, b) if mask is None else (a, b, mask)
    bound = _timing.bound(_timing.nbytes(*inputs, got),
                          N * L * NCC_ELEMENT_FLOPS[masked])
    # The kernel's time in the record is the rotated one: one set under the
    # L2 cache's size is partly served from L2, under the DRAM bound.
    sets = [(a, b, mask)] + [
        _ncc_inputs(N, L, masked, device, seed=N + L + s)
        for s in range(2, _timing.rotation(_timing.nbytes(*inputs),
                                           _timing.l2_bytes(device)) + 1)]
    kernels = [lambda s=s: ncc.ncc_pairs_cuda(*s) for s in sets]
    ms = _time_runs({"b2b": kernels[0],
                     "plain": lambda: ncc.ncc_pairs_plain(a, b, mask)})
    ms["kernel"] = _time_ms(kernels, 20, KERNEL_BATCH)
    print(f"[ncc_pairs] {label}: max_abs_err={err:.3e} "
          f"kernel_ms={ms['kernel']:.4f} (rotated over {len(sets)} sets; "
          f"b2b on one {ms['b2b']:.4f}) plain_ms={ms['plain']:.4f} "
          f"bound_ms={bound[0]:.5f} ({bound[1]})", flush=True)
    check(ms["kernel"] >= bound[0],
          f"{label}: rotated {ms['kernel']} ms under the bound {bound[0]}")
    return _result(err, ms, bound)


# Row lengths of the untimed K3 shapes: each register tier of the group
# body (G = 8 lanes a row holding C = 1 ... 8 elements each up to L = 64,
# G = 16 with C = 5 ... 8 up to 128, G = 32 with C = 5 ... 8 up to 256;
# ragged and full last chunks) and the strided body above 256; row counts
# of one row, of no multiple of a block's rows, and of more rows than one
# wave of warps (each warp walks several).
NCC_AWKWARD_L = (1, 12, 17, 31, 32, 33, 45, 50, 64, 65, 90, 100, 121, 129,
                 170, 200, 255, 256, 257, 300)
NCC_AWKWARD_N = (1, 1001, 20001)


def _ncc_awkward_pairs(N, L, masked, device):
    """Seeded (N, L) pairs: correlated rows, and from N = 8 on a flat row
    (the 0.1 clamp), an empty-mask row (-1), a single-entry row, and rows
    of mean ~200 and spread ~2 (the variance a one-pass formula loses)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7 * N + L + int(masked))
    a = rng.uniform(0, 255, (N, L))
    b = 0.6 * a + 0.4 * rng.uniform(0, 255, (N, L))
    mask = rng.uniform(size=(N, L)) > 0.3 if masked else None
    if N >= 8:
        a[2] = 7.0
        a[4:8] = 200.0 + rng.uniform(-2, 2, (4, L))
        b[4:8] = 200.0 + 0.5 * (a[4:8] - 200.0) + rng.uniform(-1, 1, (4, L))
        if masked:
            mask[0] = False
            mask[3] = False
            mask[3, L // 2] = True
            mask[::97] = False
    t = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.float32), device=device)
    return t(a), t(b), None if mask is None else t(mask)


def check_ncc_pairs_shapes(device):
    """The row-wise NCC kernel vs plain at every (N, L) of NCC_AWKWARD_N x
    NCC_AWKWARD_L, maskless and masked: within NCC_ATOL, the -1 rows exactly
    the empty-mask rows; returns the largest error."""
    import torch

    from densepoints_tpu_torch.ops import ncc

    worst, cases = 0.0, 0
    for N in NCC_AWKWARD_N:
        for L in NCC_AWKWARD_L:
            for masked in (False, True):
                a, b, mask = _ncc_awkward_pairs(N, L, masked, device)
                want = ncc.ncc_pairs_plain(a, b, mask)
                empty = (torch.zeros(N, dtype=torch.bool, device=device)
                         if mask is None else mask.sum(1) == 0)
                label = f"N={N} L={L} {'masked' if masked else 'maskless'}"
                got = ncc.ncc_pairs_cuda(a, b, mask)
                torch.cuda.synchronize()
                check(got.shape == (N,) and bool(torch.isfinite(got).all()),
                      f"{label}: shape or non-finite scores")
                check(bool(((got == -1) == empty).all())
                      and bool(((want == -1) == empty).all()),
                      f"{label}: the -1 rows are not the empty-mask rows")
                err = float((got - want).abs().max())
                check(err <= NCC_ATOL,
                      f"{label}: max |kernel - plain| {err:.3e}")
                worst, cases = max(worst, err), cases + 1
    print(f"[ncc_pairs] awkward: {cases} cases (N in {NCC_AWKWARD_N}, L in "
          f"{NCC_AWKWARD_L}, maskless and masked), max_abs_err={worst:.3e}",
          flush=True)
    return {"max_abs_err": worst}


def check_slot_kernel(label, cams, images, pos, nrm, ref, view_ids, ok, k,
                      plain_ok=None):
    """The slot kernel vs its plain version on one (view_ids, ok) slot
    table; `plain_ok` replaces `ok` for the plain version (which cannot
    index a view id outside the stack). Returns (scores, max_abs_err,
    scored, sentinel flips)."""
    import torch

    from densepoints_tpu_torch.ops import warp_ncc
    from densepoints_tpu_torch.ops.warp import patch_frames

    V = images.shape[0]
    sk = warp_ncc.slot_scores(images, cams, pos, nrm, ref, view_ids, ok, k)
    sp = warp_ncc.slot_scores_plain(
        images, cams, pos, nrm, ref, view_ids.clamp(0, V - 1),
        ok if plain_ok is None else plain_ok, k)
    torch.cuda.synchronize()
    check(sk.shape == sp.shape and sk.dtype == torch.float32,
          f"{label}: scores {tuple(sk.shape)} {sk.dtype}")
    flips = ((sk == -1) != (sp == -1)).nonzero().tolist()
    frames = patch_frames(cams, pos, nrm, ref, k)
    for b, m in flips:
        # A flip of slot 0 flips its whole row: the border is slot 0's.
        views = {min(max(int(view_ids[b, s]), 0), V - 1) for s in (m, 0)}
        margin = min(_corner_margin(cams, pos, frames, b, v) for v in views)
        print(f"  [{label}] sentinel differs at (patch {b}, slot {m}): "
              f"kernel {float(sk[b, m]):.6f} plain {float(sp[b, m]):.6f}, "
              f"corner {margin:.2e} px from the border", flush=True)
        check(margin < BORDER_PX,
              f"{label}: sentinel placement differs away from a border")
    both = (sk != -1) & (sp != -1)
    err = float((sk - sp)[both].abs().max()) if bool(both.any()) else 0.0
    check(err <= SCORE_ATOL, f"{label}: max |kernel - plain| {err:.3e}")
    check(bool(torch.isfinite(sk).all()), f"{label}: non-finite scores")
    check(bool((sk[~ok] == -1).all()), f"{label}: a slot without ok scored")
    return sk, err, int(both.sum()), len(flips)


def compare_slot_kernel(label, cams, images, pos, nrm, ref, view_ids, ok, k,
                        plain_reps=20):
    """The slot kernel vs plain on one slot table, then the times of both."""
    from densepoints_tpu_torch.ops import warp_ncc
    from densepoints_tpu_torch.ops.warp import patch_frames
    from densepoints_tpu_torch.scripts import _timing

    args = (images, cams, pos, nrm, ref, view_ids, ok, k)
    sk, err, scored, flips = check_slot_kernel(
        label, cams, images, pos, nrm, ref, view_ids, ok, k)
    frames = patch_frames(cams, pos, nrm, ref, k)
    kargs = _kernel_args(warp_ncc.slot_scores_cuda, cams, images, pos, nrm,
                         ref, k, view_ids=view_ids, ok=ok)
    ms = {
        **_time_runs({
            "kernel": lambda: warp_ncc.slot_scores_cuda(*kargs),
            "wrapper": lambda: warp_ncc.slot_scores(*args),
        }),
        **_time_runs({
            "plain": lambda: warp_ncc.slot_scores_plain(*args, frames=frames),
        }, plain_reps),
    }
    B, M = view_ids.shape
    bound = _timing.bound(*_timing.slot_counts(
        images, cams, pos, nrm, ref, view_ids, ok, sk, k))
    print(f"[slot_ncc] {label}: B={B} M={M} k={k} slots={int(ok.sum())} "
          f"scored={scored} max_abs_err={err:.3e} "
          f"sentinel_flips={flips} kernel_ms={ms['kernel']:.4f} "
          f"plain_ms={ms['plain']:.4f} wrapper_ms={ms['wrapper']:.4f} "
          f"bound_ms={bound[0]:.5f} ({bound[1]})", flush=True)
    return _result(err, ms, bound)


# Texel counts of the awkward window shapes: one of each texels-per-lane
# dispatch of the warp bodies (1, 1, 2, 4, 8 per lane and the strided form),
# and at n = 121 a coordinate row of 123 floats, which takes the scalar
# coordinate loads (no float4).
WINDOW_AWKWARD = ((1, None), (32, None), (33, None), (121, None),
                  (121, 123), (256, None), (300, None))


def _window_ncc_awkward(device, n=256, S=None, seed=5):
    """B not a multiple of 8, n texels in rows of S >= n coordinates, taps
    outside the window, windows that hang over the stack's edges."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    B, M, R, W = 1001, 5, 700, 300
    S = S or n
    stack = rng.uniform(0, 255, (R, W)).astype(np.float32)
    grad = np.concatenate([stack[:, 1:] - stack[:, :-1],
                           np.zeros((R, 1), np.float32)], 1)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {
        "stack": t(stack), "grad_stack": t(grad),
        "row0": t(rng.integers(-20, R - 30, (B, M)).astype(np.int32)),
        "x0": t(rng.integers(-30, W - 90, (B, M)).astype(np.int32)),
        "xs": t(rng.uniform(-3, 131, (B, M, S)).astype(np.float32)),
        "ys": t(rng.uniform(-3, 59, (B, M, S)).astype(np.float32)),
        "n_real": n,
    }


def compare_window_ncc(label, inp, plain_reps=20, timed=True):
    """`ops.window_ncc` vs plain on one input set: every score-computing
    variant, and the gradient form against its own plain version; then,
    when `timed`, the times of `full` and of the plain version."""
    import torch

    from densepoints_tpu_torch.ops import window_ncc
    from densepoints_tpu_torch.scripts import kernel_ablate

    args = (inp["stack"], inp["row0"], inp["x0"], inp["xs"], inp["ys"],
            inp["n_real"], kernel_ablate.WIN_H, kernel_ablate.WIN_W)
    want = window_ncc.window_scores_plain(*args)
    want_grad = window_ncc.window_scores_plain(
        *args, grad_stack=inp["grad_stack"])
    errs = {}
    for variant in window_ncc.SCORING_VARIANTS:
        got = window_ncc.window_scores(*args, variant=variant)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label} {variant}: not finite")
        errs[variant] = float((got - want).abs().max())
    got = window_ncc.window_scores(*args, grad_stack=inp["grad_stack"])
    torch.cuda.synchronize()
    errs["grad"] = float((got - want_grad).abs().max())
    for variant, err in errs.items():
        check(err <= WINDOW_SCORE_ATOL,
              f"{label} {variant}: max |kernel - plain| {err:.3e}")
    B, M = inp["row0"].shape
    line = (f"[window_ncc] {label}: B={B} M={M} n={inp['n_real']} "
            f"S={inp['xs'].shape[2]} "
            + " ".join(f"{v}_err={e:.3e}" for v, e in errs.items()))
    if not timed:
        print(line, flush=True)
        return {"max_abs_err": max(errs.values())}
    ms = {
        **_time_runs({
            "kernel": lambda: window_ncc.window_scores_cuda(*args),
            "wrapper": lambda: window_ncc.window_scores(*args),
        }),
        **_time_runs({
            "plain": lambda: window_ncc.window_scores_plain(*args),
        }, plain_reps),
    }
    bound = kernel_ablate.scores_bound(inp, want, grad=False)
    print(line + f" kernel_ms={ms['kernel']:.4f} plain_ms={ms['plain']:.4f} "
          f"wrapper_ms={ms['wrapper']:.4f} bound_ms={bound[0]:.5f} "
          f"({bound[1]})", flush=True)
    return _result(max(errs.values()), ms, bound)


def _window_textures_awkward(device, n=256, S=None, seed=6):
    """A slot count that is no multiple of 4, n texels in rows of S >= n
    coordinates, taps outside the window, windows past the page's ends,
    dead slots."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    N, P, R = 10007, 5, 300
    S = S or n
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {
        "pages": t(rng.uniform(0, 255, (P, R, 128)).astype(np.float32)),
        "page": t(rng.integers(-1, P, N).astype(np.int32)),
        "row0": t(rng.integers(-20, R - 30, N).astype(np.int32)),
        "xs": t(rng.uniform(-3, 131, (N, S)).astype(np.float32)),
        "ys": t(rng.uniform(-3, 59, (N, S)).astype(np.float32)),
        "n_real": n,
    }


def compare_window_textures(label, inp, plain_reps=20, timed=True):
    """`ops.window_textures` vs plain on one input set: every
    texture-computing variant, dead slots exactly zero; then, when `timed`,
    the times of `full` and of the plain version."""
    import torch

    from densepoints_tpu_torch.ops import window_textures
    from densepoints_tpu_torch.scripts import kernel_paged_ablate

    args = (inp["pages"], inp["page"], inp["row0"], inp["xs"], inp["ys"],
            inp["n_real"], kernel_paged_ablate.WIN_H)
    want = window_textures.window_centered_textures_plain(*args)
    dead = (inp["page"] < 0) | (inp["page"] >= inp["pages"].shape[0])
    errs = {}
    for variant in window_textures.SCORING_VARIANTS:
        got = window_textures.window_centered_textures(*args, variant=variant)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label} {variant}: not finite")
        check(bool((got[dead] == 0).all()),
              f"{label} {variant}: a dead slot is not zero")
        errs[variant] = float((got - want).abs().max())
        check(errs[variant] <= WINDOW_TEXTURE_ATOL,
              f"{label} {variant}: max |kernel - plain| {errs[variant]:.3e}")
    line = (f"[window_textures] {label}: N={inp['page'].shape[0]} "
            f"n={inp['n_real']} S={inp['xs'].shape[1]} "
            f"dead={int(dead.sum())} "
            + " ".join(f"{v}_err={e:.3e}" for v, e in errs.items()))
    if not timed:
        print(line, flush=True)
        return {"max_abs_err": max(errs.values())}
    ms = {
        **_time_runs({
            "kernel": lambda:
                window_textures.window_centered_textures_cuda(*args),
        }),
        **_time_runs({
            "plain": lambda:
                window_textures.window_centered_textures_plain(*args),
        }, plain_reps),
    }
    bound = kernel_paged_ablate.textures_bound(inp, want)
    print(line + f" kernel_ms={ms['kernel']:.4f} plain_ms={ms['plain']:.4f} "
          f"bound_ms={bound[0]:.5f} ({bound[1]})", flush=True)
    return _result(max(errs.values()), ms, bound)


def small_rig(device, V, B, seed):
    """V views of 120 x 160 on an arc around a noise-textured plane, B
    patches with mixed visibility, one row with no visible view (when
    B > 2) and rows off every frustum (when B > 8)."""
    import numpy as np
    import torch

    from densepoints_tpu_torch.scripts import _rigs

    rng = np.random.default_rng(seed)
    H, W = 120, 160
    Cs = []
    for i in range(V):
        ang = (i - (V - 1) / 2) * (0.9 / max(V, 8))
        Cs.append(np.array([6.0 * np.sin(ang), 0.2 * np.sin(2 * i),
                            -6.0 * np.cos(ang)]))
    cams = _rigs.cameras(Cs, 125.0, W, H, device)
    images = rng.uniform(0, 255, (V, H, W)).astype(np.float32)
    xy = rng.uniform(-1.0, 1.0, (B, 2))
    pos = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    ref = rng.integers(0, V, B)
    vis = rng.uniform(size=(B, V)) > 0.3
    if V > 1:
        vis[np.arange(B), ref] = False
    if B > 2:
        vis[2] = False
    if B > 8:
        pos[4:8] = [50.0, 50.0, 0.0]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return cams, t(images), t(pos), t(nrm), t(ref), t(vis)


# Phase 3's awkward shapes (V, B, k): one view, more views than a block
# has threads, textures of 1, 25, 49 and 441 texels (fewer texels than
# lanes; two per lane; the strided variant), batches of 0 and 1; then view
# counts the kernels once refused (more than 254 views at k = 11 and 16,
# 218 at k = 21, 174 at k = 31), whose rows the kernels take in tiles of
# 32 views: 255, 312 at the refine batch, 1100, and 300 in the strided
# variant.
AWKWARD_SHAPES = ((1, 33, 11), (130, 40, 5), (130, 40, 16), (8, 64, 1),
                  (8, 64, 5), (8, 64, 7), (8, 64, 21), (8, 1, 11),
                  (8, 0, 11), (49, 64, 11))
MANY_VIEW_SHAPES = ((255, 64, 11), (312, 4096, 11), (312, 4096, 16),
                    (1100, 256, 11), (300, 64, 21), (300, 64, 31))
MANY_SLOTS = 300  # phase 5's wide slot table, on the 312-view rigs


def awkward_rig(device, V, B, k):
    """`small_rig` of an awkward shape, seeded by the shape; past 254 views
    with the rows of `_rigs.tile_edge_rows` (anchor in the last tile,
    anchor off-frustum)."""
    from densepoints_tpu_torch.scripts import _rigs

    cams, images, pos, nrm, ref, vis = small_rig(device, V, B,
                                                 seed=100 + V + B + k)
    if V > 254:
        pos, ref, vis = _rigs.tile_edge_rows(cams, pos, nrm, ref, vis, k)
    return cams, images, pos, nrm, ref, vis


def phase_awkward_shapes(device, results):
    """K1 and K2 against their plain versions at the shapes that stress the
    kernels' control flow (`AWKWARD_SHAPES`, `MANY_VIEW_SHAPES`), with a
    slot table of one slot, one of `MANY_SLOTS` slots and view ids outside
    the stack."""
    import torch

    from densepoints_tpu_torch.ops import allview_ncc, warp_ncc
    from densepoints_tpu_torch.ops.warp import compact_visible

    worst = {"allview_ncc": 0.0, "slot_ncc": 0.0}
    lines = []
    for V, B, k in AWKWARD_SHAPES + MANY_VIEW_SHAPES:
        rig = awkward_rig(device, V, B, k)
        label = f"V={V} B={B} k={k}"
        launches = allview_ncc.KERNEL_LAUNCHES
        sk, ak, okk, err, scored, flips = check_kernel(f"awkward {label}",
                                                       *rig, k)
        check(allview_ncc.KERNEL_LAUNCHES == launches + (1 if B else 0),
              f"awkward {label}: the all-views kernel did not launch once")
        check(tuple(sk.shape) == (B, V), f"awkward {label}: {sk.shape}")
        worst["allview_ncc"] = max(worst["allview_ncc"], err)
        lines.append(f"{label}: scored={scored} err={err:.3e} flips={flips}")
        if V > 254:
            check(int(ak[9]) == V - 1 and bool((sk[9] == -1).all())
                  and int(ak[10]) == 0 and not bool(okk[10])
                  and bool((sk[10] == -1).all()),
                  f"awkward {label}: the rows of the last tile and of the "
                  "off-frustum anchor")
        # The slot kernel on the same rig: the default compaction, for V = 8
        # a single slot and a table with ids outside [0, V), and for V = 312
        # a table of MANY_SLOTS slots.
        cams, images, pos, nrm, ref, vis = rig
        tables = [("M=16", *compact_visible(vis, 16), None)]
        if V == 312:
            tables.append((f"M={MANY_SLOTS}",
                           *compact_visible(vis, MANY_SLOTS), None))
        if V == 8:
            tables.append(("M=1", *compact_visible(vis, 1), None))
            ids, ok = compact_visible(vis, 8)
            ids = ids.clone()
            ids[:, 3] = -1
            ids[:, 5] = V + 3
            dead = ok.clone()
            dead[:, 3] = False
            dead[:, 5] = False
            tables.append(("ids outside [0, V)", ids, ok, dead))
        for name, ids, ok, plain_ok in tables:
            sk, err, scored, flips = check_slot_kernel(
                f"awkward {label} {name}", cams, images, pos, nrm, ref, ids,
                ok, k, plain_ok=plain_ok)
            if plain_ok is not None:
                check(bool((sk[ok & ~plain_ok] == -1).all()),
                      f"awkward {label}: a slot with a view id outside the "
                      "stack scored")
            worst["slot_ncc"] = max(worst["slot_ncc"], err)
            lines.append(f"{label} slots {name}: scored={scored} "
                         f"err={err:.3e} flips={flips}")
    for line in lines:
        print(f"[awkward] {line}", flush=True)
    for kernel, err in worst.items():
        results[kernel]["awkward"] = {"max_abs_err": err}
    torch.cuda.empty_cache()


def check_no_torch_op_before_launch(refine, ids, ok):
    """On CUDA tensors `allview_scores` and `slot_scores` run exactly one
    device kernel, their own: the frames are computed inside it."""
    from densepoints_tpu_torch.ops import allview_ncc, warp_ncc

    cams, images, pos, nrm, ref, vis = refine
    for name, fn in (
        ("allview_ncc", lambda: allview_ncc.allview_scores(
            images, cams, pos, nrm, ref, vis, 11)),
        ("slot_ncc", lambda: warp_ncc.slot_scores(
            images, cams, pos, nrm, ref, ids, ok, 11)),
    ):
        fn()
        kernels = _device_kernels(fn)
        print(f"[{name}] device kernels of one wrapper call: {kernels}",
              flush=True)
        check(len(kernels) == 1 and f"{name}_kernel" in kernels[0],
              f"{name}: the wrapper ran {kernels} on the device")


def _slot_tables(label, vis, max_views):
    """The anchor-pinned chunks of `vis`, made on the card; checks that the
    stable sort behind them and behind `compact_visible` gives the same ids
    and ok on the card as on the CPU."""
    import torch

    from densepoints_tpu_torch.ops.warp import compact_visible
    from densepoints_tpu_torch.pmvs.optimize import _anchor_chunks

    chunks = _anchor_chunks(vis, max_views)
    pairs = zip(chunks + [compact_visible(vis, max_views)],
                _anchor_chunks(vis.cpu(), max_views)
                + [compact_visible(vis.cpu(), max_views)])
    for (ids, ok), (hids, hok) in pairs:
        check(torch.equal(ids.cpu(), hids) and torch.equal(ok.cpu(), hok),
              f"{label}: slot tables differ between card and CPU")
    return chunks


# M1 at the seed stage's shapes (name, N, M, D bits, pairs a launch, k,
# timed): 8192 and 4096 keypoints of 256 bits a view (DTU and temple), then
# untimed rows past 256 bits (taken in slices) and an awkward k = 1 shape.
HAMMING_SHAPES = (("dtu_8192", 8192, 8192, 256, 32, 2, True),
                  ("temple_4096", 4096, 4096, 256, 64, 2, True),
                  ("wide_d1024", 2048, 1999, 1024, 8, 2, False),
                  ("awkward_d600_k1", 300, 257, 600, 4, 1, False))
HAMMING_VIEWS = 16
# Integer operations of M1's epilogue an entry: the key's IMAD, then the
# min / max that keep the k smallest (three for k = 2, one for k = 1).
HAMMING_EPILOGUE_OPS = {1: 2, 2: 4}


def _hamming_inputs(N, M, D, P, device, seed):
    """A stack of +-1 views (int8) with a tenth of the candidates invalid;
    view v's first queries are near copies of view v + 1's candidates
    (5% of signs turned), so distances tie and partners are real; pair p
    matches view p % V against a later view."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def pm1(n):
        bits = torch.randint(0, 2, (HAMMING_VIEWS, n, D), generator=gen,
                             device=device)
        return (2 * bits - 1).to(torch.int8)

    cands, queries = pm1(M), pm1(N)
    rows = min(N, M)
    flip = torch.rand((HAMMING_VIEWS, rows, D), generator=gen,
                      device=device) < 0.05
    queries[:, :rows] = torch.where(flip, -cands[:, :rows],
                                    cands[:, :rows]).roll(-1, dims=0)
    valid = torch.rand((HAMMING_VIEWS, M), generator=gen, device=device) < 0.9
    a = torch.arange(P, device=device) % HAMMING_VIEWS
    b = (a + 1 + torch.arange(P, device=device) // HAMMING_VIEWS) % \
        HAMMING_VIEWS
    return queries, cands, valid, (a, b)


def _hamming_plain(queries, cands, valid, k, pairs):
    """The plain version on the card, as the seed stage ran it before M1:
    `_ranked_hamming` (an f32 GEMM, exact on +-1 with TF32 off, the N x M
    passes and `torch.topk`) over the stage's chunks of pairs."""
    import torch

    from densepoints_tpu_torch.features import matching
    from densepoints_tpu_torch.pmvs import seed

    a, b = pairs
    chunk = seed._pair_chunk(queries.shape[1])
    parts = [matching._ranked_hamming(
        queries[a[lo:lo + chunk]].float(), cands[b[lo:lo + chunk]].float(),
        valid[b[lo:lo + chunk]], k) for lo in range(0, len(a), chunk)]
    return tuple(torch.cat(t) for t in zip(*parts))


def compare_hamming(label, N, M, D, P, k, timed, device):
    """M1 (`matching.hamming_topk_cuda`, one launch for P pairs) against
    its plain version: idx and dist bitwise equal, one launch counted and
    no plain call; timed, both, beside M1's bound (2 N M D int8
    operations a pair at 1,979 TOPS, or the epilogue's integer operations
    on the CUDA cores)."""
    import torch

    from densepoints_tpu_torch.features import matching
    from densepoints_tpu_torch.scripts import _timing

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the plain version's f32 GEMM would not be exact")
    queries, cands, valid, pairs = _hamming_inputs(N, M, D, P, device,
                                                   seed=N + M + D + P)

    def m1():
        return matching.hamming_topk_cuda(queries, cands, valid, k, pairs)

    before = matching.KERNEL_LAUNCHES, matching.PLAIN_CALLS
    got = m1()
    check((matching.KERNEL_LAUNCHES, matching.PLAIN_CALLS)
          == (before[0] + 1, before[1]),
          f"[hamming_topk] {label}: not one launch and no plain call")
    want = _hamming_plain(queries, cands, valid, k, pairs)
    torch.cuda.synchronize()
    for name, g, w in zip(("idx", "dist"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape
              and torch.equal(g, w),
              f"[hamming_topk] {label}: {name} differs from the plain "
              "version's")
    line = (f"[hamming_topk] {label}: P={P} N={N} M={M} D={D} k={k} "
            "bitwise")
    if not timed:
        print(line, flush=True)
        return {"max_abs_err": 0.0}
    ms = _time_runs({"kernel": m1, "plain": lambda: _hamming_plain(
        queries, cands, valid, k, pairs)}, reps=5)
    bound = _timing.int8_bound(2 * P * N * M * D,
                               HAMMING_EPILOGUE_OPS[k] * P * N * M)
    print(line + f" kernel_ms={ms['kernel']:.4f} plain_ms={ms['plain']:.4f} "
          f"bound_ms={bound[0]:.5f} ({bound[1]}), a pair: kernel "
          f"{ms['kernel'] / P:.5f} plain {ms['plain'] / P:.4f} bound "
          f"{bound[0] / P:.5f}", flush=True)
    check(ms["kernel"] >= bound[0],
          f"[hamming_topk] {label}: {ms['kernel']} ms under the bound "
          f"{bound[0]}")
    return _result(0.0, ms, bound)


def phase_kernels(device):
    """Every kernel against its plain version; returns per-kernel results
    keyed by shape."""
    import torch

    from densepoints_tpu_torch.scripts import (
        _rigs,
        kernel_ablate,
        kernel_paged_ablate,
    )

    results = {"allview_ncc": {}, "slot_ncc": {}, "ncc_pairs": {},
               "window_ncc": {}, "window_textures": {}, "hamming_topk": {}}
    for label, *shape in HAMMING_SHAPES:
        results["hamming_topk"][label] = compare_hamming(label, *shape,
                                                         device)
    torch.cuda.empty_cache()
    results["window_ncc"]["script"] = compare_window_ncc(
        "script shape", kernel_ablate.script_inputs(device))
    results["window_ncc"]["awkward"] = compare_window_ncc(
        "awkward shape", _window_ncc_awkward(device))
    for name, n_slots, V, R, k in kernel_paged_ablate.SHAPES:
        results["window_textures"][name] = compare_window_textures(
            name, kernel_paged_ablate.script_inputs(device, n_slots, V, R, k),
            plain_reps=5)
    results["window_textures"]["awkward"] = compare_window_textures(
        "awkward shape", _window_textures_awkward(device))
    for n, S in WINDOW_AWKWARD:
        key = f"awkward_n{n}" + (f"_S{S}" if S else "")
        results["window_ncc"][key] = compare_window_ncc(
            f"awkward n={n}", _window_ncc_awkward(device, n, S, seed=n),
            timed=False)
        results["window_textures"][key] = compare_window_textures(
            f"awkward n={n}", _window_textures_awkward(device, n, S, seed=n),
            timed=False)
    torch.cuda.empty_cache()
    for N, L in NCC_TIMED:
        for masked in (False, True):
            key = f"{N}x{L}_{'masked' if masked else 'maskless'}"
            results["ncc_pairs"][key] = compare_ncc_pairs(N, L, masked, device)
    results["ncc_pairs"]["awkward"] = check_ncc_pairs_shapes(device)
    torch.cuda.empty_cache()
    refine = _rigs.refine_inputs(device)
    (ids, ok), = _slot_tables("refine", refine[5], 8)  # V = 8: one chunk
    for k in (11, 16):
        results["allview_ncc"][f"refine_k{k}"] = compare_kernel(
            f"refine k={k}", *refine, k)
        results["slot_ncc"][f"refine_k{k}"] = compare_slot_kernel(
            f"refine k={k}", *refine[:5], ids, ok, k)
    check_no_torch_op_before_launch(refine, ids, ok)
    del refine
    phase_awkward_shapes(device, results)
    dtu = _rigs.dtu_inputs(device)
    results["allview_ncc"]["dtu_k16"] = compare_kernel("dtu k=16", *dtu, 16)
    chunks = _slot_tables("dtu", dtu[5], 16)
    check(len(chunks) == 4 and chunks[0][0].shape == (dtu[5].shape[0], 16),
          f"dtu: expected 4 chunks of 16 slots, got {len(chunks)}")
    for c, (ids, ok) in enumerate(chunks):
        results["slot_ncc"][f"dtu_k16_chunk{c}"] = compare_slot_kernel(
            f"dtu k=16 chunk {c}", *dtu[:5], ids, ok, 16, plain_reps=5)
    del dtu
    torch.cuda.empty_cache()
    return results


def _counters():
    from densepoints_tpu_torch.features import matching
    from densepoints_tpu_torch.ops import (
        allview_ncc,
        ncc,
        warp_ncc,
        window_ncc,
        window_textures,
    )

    return {"allview_ncc": allview_ncc, "slot_ncc": warp_ncc,
            "ncc_pairs": ncc, "window_ncc": window_ncc,
            "window_textures": window_textures, "hamming_topk": matching}


# The Nelder-Mead step kernels of `ops.nm_step`: record name -> counter.
NM_KERNELS = {"nm_reflect": "REFLECT_LAUNCHES",
              "nm_contract": "CONTRACT_LAUNCHES",
              "nm_accept": "ACCEPT_LAUNCHES"}


def _nm_step():
    """`ops.nm_step`, or None in a tree whose solver steps in torch alone
    (before the step kernels: a copy of this script measuring the parent)."""
    import importlib.util

    if importlib.util.find_spec("densepoints_tpu_torch.ops.nm_step") is None:
        return None
    from densepoints_tpu_torch.ops import nm_step

    return nm_step


def _reset_counters():
    for module in _counters().values():
        module.KERNEL_LAUNCHES = 0
        module.PLAIN_CALLS = 0
    nm = _nm_step()
    if nm is not None:
        for counter in NM_KERNELS.values():
            setattr(nm, counter, 0)
        nm.PLAIN_CALLS = 0


def _read_counters():
    launches = {name: m.KERNEL_LAUNCHES for name, m in _counters().items()}
    plain = {name: m.PLAIN_CALLS for name, m in _counters().items()}
    nm = _nm_step()
    if nm is not None:
        launches.update({name: getattr(nm, counter)
                         for name, counter in NM_KERNELS.items()})
        plain["nm_step"] = nm.PLAIN_CALLS
    return launches, plain


def _objectives_agree(label, inputs, k, max_score_views, K, seed):
    """Chunked objective through the slot kernel vs the all-views objective
    (two kernels, two derivations) and vs its own gather + row-wise NCC
    route, on seeded (B, K, 3) parameters; returns the slot-kernel one."""
    import numpy as np
    import torch

    from densepoints_tpu_torch import pmvs
    from densepoints_tpu_torch.pmvs.optimize import photometric_objective_paged

    images, cams, pos, nrm, ref, vis = inputs
    B = pos.shape[0]
    params = torch.as_tensor(
        np.random.default_rng(seed).uniform(-0.05, 0.05, (B, K, 3))
        .astype(np.float32), device=pos.device)
    f_auto = pmvs.photometric_objective(
        images, cams, pos, nrm, ref, vis, k, impl="auto",
        max_score_views=max_score_views)
    f_xla = pmvs.photometric_objective(
        images, cams, pos, nrm, ref, vis, k, impl="xla",
        max_score_views=max_score_views)
    f_paged = photometric_objective_paged(images, cams, pos, nrm, ref, vis, k)
    t0 = time.perf_counter()
    auto, xla, paged = f_auto(params), f_xla(params), f_paged(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for name, c in (("auto", auto), ("xla", xla), ("paged", paged)):
        check(c.shape == (B, K) and bool(torch.isfinite(c).all()),
              f"{label}: objective {name} not finite (B, K)")
    d_paged = float((auto - paged).abs().max())
    d_xla = float((auto - xla).abs().max())
    print(f"[slice] {label}: objective (B={B}, K={K}, k={k}, "
          f"max_score_views={max_score_views}) |slot - allview| "
          f"{d_paged:.3e}, |slot - gather+ncc_pairs| {d_xla:.3e}, "
          f"mean cost {float(auto.mean()):.4f}, {dt:.2f} s", flush=True)
    check(d_paged <= OBJ_ATOL, f"{label}: chunked vs all-views {d_paged:.3e}")
    check(d_xla <= SCORE_ATOL, f"{label}: slot kernel vs xla route {d_xla:.3e}")
    return f_auto


def phase_slice_path(device):
    """The slot-scoring path through its entry points, counters set to 0
    just before; returns the kernels' launch counts on this path."""
    import torch

    from densepoints_tpu_torch import pmvs
    from densepoints_tpu_torch.ops.simplex import nelder_mead
    from densepoints_tpu_torch.scripts import _rigs

    refine = _rigs.refine_inputs(device)
    cams, images, pos, nrm, ref, vis = refine
    refine = (images, cams, pos, nrm, ref, vis)
    _reset_counters()
    # Slot scores at the refine shape by all three routes.
    by_impl = {
        impl: pmvs.patch_ncc_scores(*refine, 11, max_score_views=8, impl=impl)
        for impl in ("auto", "fused", "xla")
    }
    torch.cuda.synchronize()
    s_auto, ids, ok = by_impl["auto"]
    check(s_auto.shape == (pos.shape[0], 8), f"slot scores {s_auto.shape}")
    check(bool(torch.isfinite(s_auto).all()), "slot scores not finite")
    check(bool((s_auto[:, 0][ok[:, 0] & (s_auto[:, 0] != -1)] > 0.999).all()),
          "a textured anchor does not score 1 against itself")
    check(bool(torch.equal(s_auto, by_impl["fused"][0])),
          "impl auto and fused differ on the card")
    s_xla = by_impl["xla"][0]
    check(bool(((s_auto == -1) == (s_xla == -1)).all()),
          "slot kernel and xla route place sentinels differently")
    d = float((s_auto - s_xla).abs().max())
    print(f"[slice] refine: patch_ncc_scores {tuple(s_auto.shape)} |slot kernel - "
          f"gather+ncc_pairs| {d:.3e}, scored "
          f"{int((s_auto != -1).sum())}", flush=True)
    check(d <= SCORE_ATOL, f"slot kernel vs xla route: {d:.3e}")
    # (a) the objectives at the refine shape.
    f_auto = _objectives_agree("refine", refine, 11, 16, 4, seed=2)
    # (c) 30 Nelder-Mead iterations on the chunked objective.
    x0 = torch.zeros((pos.shape[0], 3), device=device)
    step = torch.tensor([0.02, 0.2, 0.2], device=device)
    # The starting cost, evaluated in the batch shape of the solver's first
    # call (x0 is vertex 0 of the initial simplex).
    verts = x0[:, None, :] + torch.cat([x0.new_zeros((1, 3)),
                                        torch.diag(step)])[None]
    start = f_auto(verts)[:, 0]
    t0 = time.perf_counter()
    # The eager blocks: the chunked objective is a parity path, never
    # captured (the graph path's phase is 16).
    _, best, iters = nelder_mead(f_auto, x0, step, max_iterations=30,
                                 _eager=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(best).all()), "Nelder-Mead: non-finite cost")
    excess = float((best - start).max())
    check(excess <= 1e-5,
          f"Nelder-Mead: a patch ended {excess:.3e} above its starting cost")
    print(f"[slice] refine: 30 Nelder-Mead iterations on the chunked "
          f"objective, 4096 patches, {dt:.3f} s, mean cost "
          f"{float(start.mean()):.4f} -> {float(best.mean()):.4f}, "
          f"iterations used max {int(iters.max())}", flush=True)
    del refine, f_auto
    # (b) the objectives at the DTU shape: 4 chunks of 16 slots.
    cams, images, pos, nrm, ref, vis = _rigs.dtu_inputs(device)
    _objectives_agree("dtu", (images, cams, pos, nrm, ref, vis), 16, 16, 2,
                      seed=3)
    launches, plain = _read_counters()
    print(f"[slice] kernel launches {launches}, plain calls {plain}",
          flush=True)
    for name in ("slot_ncc", "ncc_pairs", "allview_ncc"):
        check(launches[name] > 0, f"the slice's path never launched {name}")
    check(not any(plain.values()), f"the slice's path took plain paths {plain}")
    del images
    torch.cuda.empty_cache()
    return launches


def phase_ablation_path():
    """The two ablation programs through their `main()` on the card at
    their full shapes, counters set to 0 just before; returns the launch
    counts of the two window kernels."""
    import contextlib
    import io

    from densepoints_tpu_torch.scripts import (
        kernel_ablate,
        kernel_paged_ablate,
    )

    _reset_counters()
    records = []
    t0 = time.perf_counter()
    for program in (kernel_ablate, kernel_paged_ablate):
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            rc = program.main(["--device", "cuda"])
        check(rc == 0, f"{program.__name__}.main returned {rc}")
        for line in captured.getvalue().splitlines():
            print(f"[ablate] {line}", flush=True)
            records.append(json.loads(line))
    dt = time.perf_counter() - t0
    launches, plain = _read_counters()
    check(len(records) == 3, f"expected 3 ablation records, got {len(records)}")
    for rec in records:
        full = rec["variants"]["full"]
        check(full["bound_ms"] > 0 and full["ms"] >= full["bound_ms"],
              f"{rec['program']}: full {full['ms']} ms against a bound of "
              f"{full['bound_ms']}")
        atol = (WINDOW_SCORE_ATOL if rec["program"] == "kernel_ablate"
                else WINDOW_TEXTURE_ATOL)
        for name, v in rec["variants"].items():
            check(v["ms"] > 0, f"{rec['program']} {name}: no time")
            err = v["max_abs_err_vs_full"]
            if err is None:
                continue  # a variant that only bounds a cost
            limit = GRAD_VS_FULL_ATOL if name == "grad" else atol
            check(err <= limit,
                  f"{rec['program']} {name}: {err:.3e} from full")
    print(f"[ablate] kernel launches {launches}, plain calls {plain}, "
          f"{dt:.2f} s", flush=True)
    for name in ("window_ncc", "window_textures"):
        check(launches[name] > 0, f"the ablation path never launched {name}")
    check(not any(plain.values()),
          f"the ablation path took plain paths {plain}")
    return launches


def write_sphere_scene(directory: Path, turn: float = 0.0):
    """bench.py's e2e scene as PNG images + a scene JSON; returns its path.
    With `turn`, the P of views 1, 2, ... is turned about the world's z
    axis by +turn, -turn, ... radians, as if the calibration were noisy
    (the perturbation of `tests/pmvs/test_ba_integration.py`)."""
    import numpy as np
    from PIL import Image

    sys.path.insert(0, str(ROOT / "tests"))
    from synthetic import TexturedSphereScene

    sc = TexturedSphereScene(
        np.random.default_rng(0), num_views=12, width=512, height=384,
        focal=450.0, radius=SPHERE_RADIUS, cam_radius=500.0, tex_size=2048,
        layout="grid", yaw_span=0.9, pitch_span=0.45,
    )
    views = []
    for v in range(sc.P.shape[0]):
        name = f"view_{v:02d}.png"
        img = sc.render(v).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(directory / name)
        P = sc.P[v]
        if v and turn:
            a = turn if v % 2 else -turn
            Rz = np.eye(4)
            Rz[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            P = P @ Rz
        views.append({"filename": name, "projectionMatrix": P.tolist()})
    path = directory / "scene.json"
    path.write_text(json.dumps({"imagesPath": str(directory),
                                "views": views}))
    return path


SPHERE_SETTINGS = {
    "profile": "scan",
    "expand": {"max_rounds": 4, "max_iterations": 40},
    "optimize": {"max_iterations": 120},
    "organizer": {"grid_scale": 4},
}


def _cli_on_sphere(device: str, settings: dict, flags=(), scene_path=None):
    """`cli.main` on the sphere scene (written anew unless `scene_path` is
    given) with `settings` and extra `flags`, every launch counter set to 0
    just before; returns (positions, the `DensifyResult`, wall seconds,
    launches, plain calls)."""
    import numpy as np

    from densepoints_tpu_torch import cli
    from densepoints_tpu_torch.io.ply import read_ply
    from densepoints_tpu_torch.pmvs import pipeline

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        scene_path = scene_path or write_sphere_scene(tmp)
        settings_path = tmp / "settings.json"
        settings_path.write_text(json.dumps(settings))
        out = tmp / "cloud.ply"
        captured = {}
        densify = pipeline.densify

        def recording_densify(*a, **kw):
            captured["result"] = densify(*a, **kw)
            return captured["result"]

        pipeline.densify = recording_densify
        _reset_counters()
        t0 = time.perf_counter()
        try:
            rc = cli.main(["-i", str(scene_path), "-s", str(settings_path),
                           "-o", str(out), "--device", device, *flags])
        finally:
            pipeline.densify = densify
        wall = time.perf_counter() - t0
        launches, plain = _read_counters()
        check(rc == 0, f"cli.main returned {rc}")
        pts = read_ply(out)["positions"]
    changed = {k: v for k, v in settings.items()
               if SPHERE_SETTINGS.get(k) != v}
    print(f"[nm-graph] cli {' '.join(flags)} {json.dumps(changed)}: "
          f"{json.dumps(_nm_counters(captured['result'].metrics))}",
          flush=True)
    check(pts.ndim == 2 and pts.shape[1] == 3, f"PLY positions {pts.shape}")
    check(bool(np.isfinite(pts).all()), "non-finite positions in the PLY")
    return pts, captured["result"], wall, launches, plain


def _radial_error(pts):
    import numpy as np

    if not len(pts):
        return float("inf")
    return float(np.median(np.abs(np.linalg.norm(pts, axis=1)
                                  - SPHERE_RADIUS)))


def phase_main_path(device: str):
    """The CLI on the sphere scene; returns (launches by kernel, stage
    seconds, positions, the final PatchState, the `DensifyResult`)."""
    pts, result, wall, all_launches, all_plain = _cli_on_sphere(
        device, SPHERE_SETTINGS)
    metrics = result.metrics
    launches = all_launches["allview_ncc"]
    plain = sum(all_plain.values())
    med = _radial_error(pts)
    print(f"[main] cli wall {wall:.2f} s; stage seconds: "
          + " ".join(f"{k}={v:.3f}" for k, v in metrics.times.items()),
          flush=True)
    print(f"[main] counters: " + " ".join(
        f"{k}={v:g}" for k, v in metrics.counters.items()), flush=True)
    print(f"[main] kernel launches {launches}, plain calls {plain}, "
          f"{len(pts)} patches, median radial error {med:.4f} "
          f"(radius {SPHERE_RADIUS:g})", flush=True)
    if device == "cuda":
        check(launches > 0, "the main path launched no kernel")
        check(plain == 0, f"the main path took the plain path {plain} times")
        steps = {all_launches[name] for name in NM_KERNELS}
        print(f"[main] step kernels: " + " ".join(
            f"{name}={all_launches[name]}" for name in NM_KERNELS),
            flush=True)
        check(len(steps) == 1 and steps.pop() > 0,
              "the main path did not launch each step kernel once a step")
        pairs = metrics.counters.get("seed_match_pairs", 0)
        print(f"[main] M1 launches {all_launches['hamming_topk']}, "
              f"seed_match_pairs {pairs}", flush=True)
        check(all_launches["hamming_topk"] == 1 and pairs > 0,
              "the main path did not match its view pairs in one M1 launch")
    check(len(pts) >= 1000, f"only {len(pts)} patches (need >= 1000)")
    check(med < 0.01 * SPHERE_RADIUS,
          f"median radial error {med:.4f} >= {0.01 * SPHERE_RADIUS}")
    return all_launches, metrics.times, pts, result.patches, result


def phase_seed_variants(device: str):
    """The alternative seed front end on the sphere scene: FAST corners and
    each of the three other matchers through `generate_seed_points`, then
    one CLI run with the expansion pre-screen."""
    import logging

    import torch

    from densepoints_tpu_torch.config import MatchingConfig
    from densepoints_tpu_torch.io import load_scene
    from densepoints_tpu_torch.pmvs.seed import generate_seed_points

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        scene = load_scene(write_sphere_scene(Path(tmp)), device=device)
        cameras = scene.cameras.to(device)
        images = torch.as_tensor(scene.images, dtype=torch.float32,
                                 device=device)
    counts = {}
    for label, change in (
        ("harris + hamming_knn", {}),
        ("fast + hamming_knn", {"detector": "fast"}),
        ("harris + hamming_absolute", {"matcher": "hamming_absolute"}),
        ("harris + epipolar", {"matcher": "epipolar"}),
        ("harris + epipolar_all", {"matcher": "epipolar_all"}),
    ):
        t0 = time.perf_counter()
        points, _, mask = generate_seed_points(
            images, cameras, MatchingConfig(**change))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[label] = len(points)
        print(f"[seed] {label}: {len(points)} seed points, "
              f"{int(mask.sum())} observations, median | |p| - "
              f"{SPHERE_RADIUS:g} | {_radial_error(points):.4f}, {dt:.2f} s",
              flush=True)
        check(len(points) > 0, f"{label}: no seed points")
    # Descriptor matching must put its seeds on the sphere; descriptor-free
    # matching accepts false partners by design and is only reported.
    for label in ("fast + hamming_knn", "harris + hamming_absolute"):
        check(counts[label] >= 100, f"{label}: only {counts[label]} seeds")

    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("densepoints_tpu_torch")
    logger.addHandler(handler)
    try:
        settings = json.loads(json.dumps(SPHERE_SETTINGS))
        settings["expand"]["prescreen"] = "claim"
        pts, result, wall, launches, plain = _cli_on_sphere(device, settings)
    finally:
        logger.removeHandler(handler)
    screened = [line for line in lines if "prescreen" in line]
    for line in screened:
        print(f"[prescreen] {line}", flush=True)
    med = _radial_error(pts)
    print(f"[prescreen] cli wall {wall:.2f} s, expand "
          f"{result.metrics.times['expand']:.3f} s, allview_ncc launches "
          f"{launches['allview_ncc']}, plain calls {sum(plain.values())}, "
          f"{len(pts)} patches, median radial error {med:.4f}", flush=True)
    check(len(screened) > 0, "the pre-screen logged no round")
    check(sum(plain.values()) == 0, f"the pre-screen run took plain paths")
    check(len(pts) >= 1000, f"pre-screen run: only {len(pts)} patches")
    check(med < 0.01 * SPHERE_RADIUS,
          f"pre-screen run: median radial error {med:.4f}")


def _sphere_run(label, device, settings, flags=(), scene_path=None,
                radial_limit=0.01 * SPHERE_RADIUS):
    """One CLI run of phase 11: K1 launched and no plain call, at least
    1000 patches, a median radial error under `radial_limit` (unless None);
    prints and returns (positions, metrics)."""
    pts, result, wall, launches, plain = _cli_on_sphere(
        device, settings, flags, scene_path)
    metrics = result.metrics
    med = _radial_error(pts)
    print(f"[{label}] cli wall {wall:.2f} s; stage seconds: "
          + " ".join(f"{k}={v:.3f}" for k, v in metrics.times.items()),
          flush=True)
    print(f"[{label}] allview_ncc launches {launches['allview_ncc']}, "
          f"plain calls {sum(plain.values())}, {len(pts)} patches, median "
          f"radial error {med:.4f}", flush=True)
    check(launches["allview_ncc"] > 0, f"{label}: K1 was never launched")
    check(sum(plain.values()) == 0, f"{label}: plain paths {plain}")
    check(len(pts) >= 1000, f"{label}: only {len(pts)} patches")
    check(radial_limit is None or med < radial_limit,
          f"{label}: median radial error {med:.4f}")
    return pts, metrics


def _ba_rmse_orders(scene_path, settings, device, n_orders):
    """RMSE in pixels of the single-rank `run_ba` of the scene's seed tracks
    with the observations in their order, then shuffled by seeds 1, 2, ...
    (`n_orders` solves in all). The same problem each time; only the order
    in which the segment sums add changes."""
    import numpy as np
    import torch

    from densepoints_tpu_torch.ba import BAProblem, reprojection_rmse, run_ba
    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.io import load_scene
    from densepoints_tpu_torch.pmvs.seed import generate_seed_points

    config = load_config(settings)
    scene = load_scene(scene_path, device=device)
    cams = scene.cameras
    images = torch.as_tensor(scene.images, dtype=torch.float32, device=device)
    points, obs, mask = generate_seed_points(images, cams, config.matching)
    tp, tv = np.nonzero(mask)
    out = []
    for seed in range(n_orders):
        order = (np.arange(len(tp)) if seed == 0
                 else np.random.default_rng(seed).permutation(len(tp)))
        p, v = tp[order], tv[order]
        problem = BAProblem(
            K=cams.K, R0=cams.R, C0=cams.C,
            points0=torch.as_tensor(points, dtype=torch.float32,
                                    device=device),
            obs_point=torch.as_tensor(p, dtype=torch.int64, device=device),
            obs_view=torch.as_tensor(v, dtype=torch.int64, device=device),
            obs_xy=torch.as_tensor(obs[p, v], dtype=torch.float32,
                                   device=device),
            obs_mask=torch.ones((len(p),), dtype=torch.bool, device=device),
        )
        R, C, X, _ = run_ba(problem, config.ba.max_outer_iterations,
                            config.ba.cg_iterations, config.ba.damping,
                            config.ba.robust_delta)
        out.append(float(reprojection_rmse(problem, R, C, X)))
    return out


def _seed_rmse(scene_path, settings, device):
    """Reprojection RMSE of the scene's seed tracks against its own cameras
    (the pipeline's bundle adjustment with no iteration), on the card."""
    return _ba_rmse(scene_path, settings, device, iterations=0)


def _ba_rmse(scene_path, settings, device, iterations=None, mesh=None):
    """The pipeline's bundle adjustment of the scene's seed tracks on one
    rank (with `iterations` LM iterations in place of the settings'), as a
    CLI run makes it; returns the RMSE in pixels. With `mesh`, the seed
    front end and the solve run over its ranks (`generate_seed_points` and
    `run_ba_sharded` with `mesh`)."""
    import dataclasses

    import torch

    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.io import load_scene
    from densepoints_tpu_torch.pmvs.pipeline import _bundle_adjust
    from densepoints_tpu_torch.pmvs.seed import generate_seed_points

    config = load_config(settings)
    scene = load_scene(scene_path, device=device)
    images = torch.as_tensor(scene.images, dtype=torch.float32, device=device)
    points, obs, mask = generate_seed_points(images, scene.cameras,
                                             config.matching, mesh=mesh)
    ba = config.ba
    if iterations is not None:
        ba = dataclasses.replace(ba, max_outer_iterations=iterations)
    return _bundle_adjust(scene.cameras, points, obs, mask, ba,
                          mesh=mesh)[2]


def _with_settings(**sections):
    settings = json.loads(json.dumps(SPHERE_SETTINGS))
    for name, values in sections.items():
        settings.setdefault(name, {}).update(values)
    return settings


# `fuse_tsdf`'s seconds on the card when it summed with `index_add_`
# (f32 atomics in no fixed order): the `--mesh` run of phase 11 on the
# sphere, R = 128 (PERF.md).
FUSION_S_INDEX_ADD = 0.001


def phase_rest_of_pipeline(device, main_pts, main_times, main_patches):
    """Phase 11: checkpoint / resume, multi-scale, bundle adjustment, the
    mesh (and two meshes of phase 10's cloud, bitwise equal), debug and
    profile dumps, the native runtime and the cloud metrics, each CLI run on
    the sphere with every counter set to 0 just before. Returns the BA RMSE
    of the turned calibration."""
    import numpy as np
    import torch

    from densepoints_tpu_torch import native
    from densepoints_tpu_torch.config import SurfaceConfig
    from densepoints_tpu_torch.io.ply import read_ply
    from densepoints_tpu_torch.surface import tsdf
    from densepoints_tpu_torch.utils.metrics import accuracy_completeness

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        (tmp / "scene").mkdir()
        scene = write_sphere_scene(tmp / "scene")

        # Checkpoints, then a resume from the first stage.
        ckpt = tmp / "ckpt"
        pts, _ = _sphere_run("ckpt", device, SPHERE_SETTINGS,
                                ["--checkpoint-dir", str(ckpt)], scene)
        stages = sorted(p.stem for p in ckpt.glob("*.npz"))
        check(stages == ["expanded", "final", "seeds_optimized"],
              f"checkpoint stages {stages}")
        for stage in ("expanded", "final"):
            (ckpt / f"{stage}.npz").unlink()
        resumed, metrics = _sphere_run(
            "ckpt", device, SPHERE_SETTINGS,
            ["--checkpoint-dir", str(ckpt), "--resume"], scene)
        check("seed" not in metrics.times, "the resumed run seeded anew")
        check(len(resumed) == len(pts),
              f"resumed {len(resumed)} patches, uninterrupted {len(pts)}")
        diff = float(np.abs(resumed - pts).max()) if len(pts) else 0.0
        print(f"[ckpt] resumed from seeds_optimized: {len(resumed)} patches "
              f"as uninterrupted, max |position difference| {diff:.3e}, "
              f"bitwise {np.array_equal(resumed, pts)}", flush=True)
        check(diff <= 1e-4, f"resumed cloud differs by {diff:.3e}")

        # Two pyramid levels: K1 at 256 x 192, then at 512 x 384.
        _, metrics = _sphere_run(
            "multiscale", device, _with_settings(multiscale={"levels": 2}),
            (), scene)
        levels = {k: v for k, v in metrics.times.items()
                  if k.startswith("multiscale_level_")}
        print("[multiscale] seconds per level: " + " ".join(
            f"{k[len('multiscale_'):]}={v:.3f}" for k, v in levels.items()),
            flush=True)
        check(sorted(levels) == ["multiscale_level_0", "multiscale_level_1"],
              f"levels timed: {sorted(levels)}")

        # Bundle adjustment of a calibration turned by +-0.002 rad, held
        # to bundle adjustment of the exact calibration. Both packages' BA
        # leaves the RMSE of this scene's seeds above a pixel (it counts
        # mismatched tracks, which Huber weights do not silence) and moves
        # the cloud off the sphere by a few units (PERF.md, PR 7), so the
        # exact run is the yardstick, not the plain run's cloud.
        (tmp / "turned").mkdir()
        turned = write_sphere_scene(tmp / "turned", turn=0.002)
        ba_settings = _with_settings(ba={"enable": True})
        runs = {}
        for name, path in (("exact", scene), ("turned", turned)):
            pts, metrics = _sphere_run(f"ba {name}", device, ba_settings,
                                          (), path, radial_limit=None)
            runs[name] = (metrics.counters["ba_rmse_px"], _radial_error(pts),
                          metrics.times["bundle_adjust"])
        before = _seed_rmse(turned, ba_settings, device)
        (rmse, radial, secs), (rmse_x, radial_x, _) = (runs["turned"],
                                                       runs["exact"])
        print(f"[ba] turned calibration: seeds' reprojection RMSE {before:.4f}"
              f" px before BA, {rmse:.4f} px after ({secs:.3f} s), cloud's "
              f"median radial error {radial:.4f}; exact calibration: "
              f"{rmse_x:.4f} px after BA, radial error {radial_x:.4f}",
              flush=True)
        check(rmse < before, f"BA left the RMSE at {rmse:.4f} px")
        check(rmse <= 1.1 * rmse_x,
              f"BA RMSE {rmse:.4f} px, from exact cameras {rmse_x:.4f} px")
        check(abs(radial - radial_x) < 0.01 * SPHERE_RADIUS,
              f"radial error {radial:.4f} after BA of the turned calibration,"
              f" {radial_x:.4f} after BA of the exact one")

        # The mesh of the plain run; its two halves timed apart.
        timed = {}

        def timing(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                timed[name] = time.perf_counter() - t0
                return out
            return run

        mesh_path = tmp / "mesh.ply"
        saved = tsdf.extract_surface, tsdf.fuse_tsdf
        tsdf.extract_surface = timing("extract_surface", saved[0])
        tsdf.fuse_tsdf = timing("fuse_tsdf", saved[1])
        try:
            pts, _ = _sphere_run("mesh", device, SPHERE_SETTINGS,
                                    ["--mesh", str(mesh_path)], scene)
        finally:
            tsdf.extract_surface, tsdf.fuse_tsdf = saved
        head = mesh_path.read_bytes()[:400].decode("ascii", "replace")
        faces = int(head.split("element face ")[1].split()[0])
        verts = read_ply(mesh_path)["positions"]
        # extract_surface's voxel: the cloud's largest extent, padded by 5%
        # on each side, over R - 1.
        R = SurfaceConfig().voxel_resolution
        voxel = float(np.ptp(pts, axis=0).max()) * 1.1 / (R - 1)
        med = _radial_error(verts)
        print(f"[mesh] {len(verts)} vertices, {faces} faces, median | |v| - "
              f"{SPHERE_RADIUS:g} | {med:.4f} (voxel {voxel:.3f}); TSDF "
              f"fusion {timed['fuse_tsdf']:.3f} s on the card at R = {R}, "
              f"surface in all {timed['extract_surface']:.3f} s", flush=True)
        check(len(verts) > 0 and faces > 0, "empty mesh")
        check(bool(np.isfinite(verts).all()), "non-finite mesh vertices")
        check(med < voxel, f"mesh radial error {med:.4f} >= voxel {voxel:.3f}")

        # The same cloud gives the same mesh: phase 10's cloud twice.
        cloud = (main_patches.position.cpu().numpy(),
                 main_patches.normal.cpu().numpy())
        meshes, fusion_s = [], []
        tsdf.fuse_tsdf = timing("fuse_tsdf", saved[1])
        try:
            for _ in range(2):
                meshes.append(tsdf.extract_surface(*cloud, SurfaceConfig(),
                                                   device))
                fusion_s.append(timed["fuse_tsdf"])
        finally:
            tsdf.fuse_tsdf = saved[1]
        same = all(np.array_equal(a, b) for a, b in zip(*meshes))
        print(f"[mesh] phase 10's cloud ({len(cloud[0])} points) twice: "
              f"{len(meshes[0][0])} and {len(meshes[1][0])} vertices, "
              f"{len(meshes[0][1])} and {len(meshes[1][1])} faces, bitwise "
              f"equal {same}; TSDF fusion "
              + " and ".join(f"{t:.4f}" for t in fusion_s)
              + f" s in fixed order (index_put_), {FUSION_S_INDEX_ADD} s "
              "with index_add_ (PERF.md)", flush=True)
        check(same, "two meshes of one cloud differ")

        # Debug dumps and a profile trace of one run.
        dbg, prof = tmp / "debug", tmp / "profile"
        _sphere_run("debug", device, SPHERE_SETTINGS,
                    ["--debug-dir", str(dbg), "--profile-dir", str(prof)],
                    scene)
        dumped = sorted(str(p.relative_to(dbg)) for p in dbg.rglob("*.*"))
        views = [d for d in dumped if d.startswith("view_")]
        print(f"[debug] {len(dumped)} files: points/seeds.ply "
              f"{'points/seeds.ply' in dumped}, points/final.ply "
              f"{'points/final.ply' in dumped}, {len(views)} occupancy "
              f"images", flush=True)
        check({"points/seeds.ply", "points/final.ply"} <= set(dumped),
              f"debug dumps {dumped}")
        check(len(views) == 12, f"{len(views)} occupancy images")
        trace = prof / "densify.pt.trace.json"
        text = trace.read_text()
        print(f"[profile] {trace.name}: {trace.stat().st_size / 1e6:.1f} MB, "
              f"allview_ncc_kernel named "
              f"{text.count('allview_ncc_kernel')} times", flush=True)
        check("allview_ncc_kernel" in text, "the trace never names K1")

    # The native runtime (g++ is on any machine with nvcc).
    check(native.available(), "the native runtime did not build or load")
    print(f"[native] {native.library_path().name} loaded; seed stage of the "
          f"main path {main_times['seed']:.3f} s with it", flush=True)

    # Accuracy / completeness of the main path's cloud against the sphere.
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((20000, 3))
    gt *= SPHERE_RADIUS / np.linalg.norm(gt, axis=1, keepdims=True)
    m = accuracy_completeness(main_pts, gt, threshold=1.5)
    print(f"[metrics] main path vs 20000 samples of the sphere: "
          f"{m.summary()}", flush=True)
    check(np.isfinite([m.accuracy_mean, m.completeness_mean]).all(),
          "non-finite cloud metrics")
    return rmse


# Phase 12: every rank of a job is a child process of this script
# (`python -m chip_smoke --parallel-rank SPEC`), killed with the others if
# one fails or the job runs past this.
PARALLEL_CHILD_S = 300
# Clustered partitioning with a halo of views covisible above 0.5: each of
# the sphere's two clusters holds 9 of its 12 views.
PARALLEL_HALO = 0.5
PARALLEL_ATOL = 1e-5  # N ranks vs 1 rank, replicated driver
CLUSTERED_ATOL = 5e-3  # N ranks vs 1 rank, clustered driver
BA_RMSE_ATOL = 1e-3  # pixels, sharded vs single-rank BA
BA_ORDERS = 5  # single-rank BA in the observations' order and 4 shuffles


def _run_ranks(label, world, spec, tmp, env=None):
    """The `world` ranks of one job, each this script with --parallel-rank
    (`scripts._jobs.run_ranks`: every rank is killed if one fails or the
    job runs past PARALLEL_CHILD_S seconds), with `env` added to their
    environment. Returns each rank's record (its last `[parallel-rank]`
    JSON line)."""
    from densepoints_tpu_torch.scripts import _jobs

    def rank_args(rank, port):
        child = dict(spec, rank=rank, world=world, port=port,
                     out=str(tmp / f"{label}.{rank}.npz"))
        return ["--parallel-rank", json.dumps(child)]

    try:
        _jobs.run_ranks("chip_smoke", world, rank_args, tmp,
                        PARALLEL_CHILD_S, env=env, name=label)
    except RuntimeError as exc:
        raise SmokeFailure(f"[parallel] {label}: {exc}") from exc
    records = []
    for rank in range(world):
        log = _jobs.rank_log(tmp, label, world, rank).read_text()
        lines = [line for line in log.splitlines()
                 if line.startswith("[parallel-rank] ")]
        check(lines, f"[parallel] {label}: rank {rank}/{world} printed no "
              f"record:\n{log[-3000:]}")
        records.append(json.loads(lines[-1][len("[parallel-rank] "):]))
    return records


def parallel_rank(spec):
    """The `--parallel-rank SPEC` mode: one rank of a phase 12 job. With
    "flags", `cli.main` with those flags joined to the job (counters at 0
    before), or with "launch", with those flags alone (the CLI forms the
    job, `parallel.launch`); with "ba", the view-sharded seeds and
    `run_ba_sharded` of the scene. Writes its cloud to SPEC["out"] and
    prints one JSON line."""
    import numpy as np
    import torch

    spec = json.loads(spec)
    if spec.get("visible"):  # this rank sees only its own card
        os.environ["CUDA_VISIBLE_DEVICES"] = str(spec["rank"])
    check(spec["device"] != "cuda" or torch.cuda.is_available(),
          "a rank found no CUDA card")
    job = ["--coordinator", f"127.0.0.1:{spec['port']}", "--num-processes",
           str(spec["world"]), "--process-id", str(spec["rank"])]
    if spec.get("ba"):
        record = _parallel_ba_rank(spec)
    else:
        from densepoints_tpu_torch import cli
        from densepoints_tpu_torch.parallel import clustered, multihost

        captured = {}

        def recording(module, name):
            inner = getattr(module, name)

            def run(*args, **kwargs):
                captured["mesh"] = kwargs["mesh"]
                captured["result"] = inner(*args, **kwargs)
                return captured["result"]

            setattr(module, name, run)
            return inner

        saved = (recording(multihost, "densify_multihost"),
                 recording(clustered, "densify_clustered"))
        _reset_counters()
        t0 = time.perf_counter()
        try:
            rc = (_seeded_clustered_rank(spec, clustered) if "halo" in spec
                  else cli.main(spec["flags"]
                                + ([] if spec.get("launch") else job)))
        finally:
            multihost.densify_multihost, clustered.densify_clustered = saved
        wall = time.perf_counter() - t0
        launches, plain = _read_counters()
        check(rc == 0, f"cli.main returned {rc}")
        res, mesh = captured["result"], captured["mesh"]
        pts = res.patches.position.cpu().numpy()
        np.savez(spec["out"], position=pts,
                 normal=res.patches.normal.cpu().numpy(),
                 vis=res.patches.vis.cpu().numpy())
        record = {
            "backend": mesh.backend, "device": str(mesh.device),
            "launches": launches["allview_ncc"],
            "plain": sum(plain.values()), "patches": len(pts),
            "radial": _radial_error(pts), "wall_s": round(wall, 3),
            "stage_s": {k: round(v, 3) for k, v in res.metrics.times.items()},
            "counters": res.metrics.counters,
            "cards_seen": torch.cuda.device_count(),
            "table": [list(row) for row in mesh.table],
        }
    record.update(rank=spec["rank"], world=spec["world"])
    print("[parallel-rank] " + json.dumps(record), flush=True)
    return 0


def _seeded_clustered_rank(spec, clustered):
    """`densify_clustered` with seed points every rank shares (the single
    front end's, computed on each rank), the canonical priorities that make
    the cloud independent of the number of ranks."""
    import torch

    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.io import load_scene
    from densepoints_tpu_torch.parallel import mesh as pmesh
    from densepoints_tpu_torch.pmvs.seed import generate_seed_points

    pmesh.initialize_multihost(f"127.0.0.1:{spec['port']}", spec["world"],
                               spec["rank"], device=spec["device"])
    mesh = pmesh.global_mesh()
    config = load_config(spec["settings"])
    scene = load_scene(spec["scene"], device=mesh.device)
    images = torch.as_tensor(scene.images, dtype=torch.float32,
                             device=mesh.device)
    points, _, _ = generate_seed_points(images, scene.cameras,
                                        config.matching)
    clustered.densify_clustered(scene, config, seed_points=points,
                                halo_threshold=spec["halo"], mesh=mesh)
    pmesh.shutdown_multihost()
    return 0


def _parallel_ba_rank(spec):
    import torch

    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.io import load_scene
    from densepoints_tpu_torch.parallel import mesh as pmesh
    from densepoints_tpu_torch.pmvs.pipeline import _bundle_adjust
    from densepoints_tpu_torch.pmvs.seed import generate_seed_points

    pmesh.initialize_multihost(f"127.0.0.1:{spec['port']}", spec["world"],
                               spec["rank"], device=spec["device"])
    mesh = pmesh.global_mesh()
    config = load_config(spec["settings"])
    scene = load_scene(spec["scene"], device=mesh.device)
    images = torch.as_tensor(scene.images, dtype=torch.float32,
                             device=mesh.device)
    points, obs, mask = generate_seed_points(images, scene.cameras,
                                             config.matching, mesh=mesh)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else None
    if sync:
        sync()
    t0 = time.perf_counter()
    _, _, rmse = _bundle_adjust(scene.cameras, points, obs, mask, config.ba,
                                mesh=mesh)
    secs = time.perf_counter() - t0
    traffic = mesh.traffic
    record = {"backend": mesh.backend, "rmse": rmse, "ba_s": round(secs, 3),
              "seeds": len(points), "observations": int(mask.sum()),
              "collective_bytes": traffic.collective_bytes,
              "collective_calls": traffic.calls,
              "host_bytes": traffic.host_bytes}
    pmesh.shutdown_multihost()
    return record


def _parallel_line(label, rec):
    c = rec.get("counters", {})
    overhead = " ".join(f"{k[len('overhead_'):]}={c[k]:g}" for k in sorted(c)
                        if k.startswith("overhead_"))
    held = (f" image_bytes_held={c['image_bytes_held']:g}"
            if "image_bytes_held" in c else "")
    print(f"[parallel] {label} rank {rec['rank']}/{rec['world']} "
          f"backend={rec['backend']} device={rec['device']} "
          f"K1_launches={rec['launches']} plain_calls={rec['plain']} "
          f"patches={rec['patches']} median_radial_error={rec['radial']:.4f} "
          f"wall={rec['wall_s']:.3f}s stage_s=" + ",".join(
              f"{k}:{v:.3f}" for k, v in rec["stage_s"].items())
          + (f" {overhead}" if overhead else "") + held, flush=True)


def _same_cloud(label, got, want, atol, nearest=False):
    """Equal count; `vis` equal and positions and normals within `atol` row
    for row, or (`nearest`) every position within `atol` of the other
    cloud's nearest. Returns the largest position difference."""
    import numpy as np

    check(len(got["position"]) == len(want["position"]),
          f"[parallel] {label}: {len(got['position'])} patches, "
          f"expected {len(want['position'])}")
    if not len(got["position"]):
        return 0.0
    if nearest:
        d = np.linalg.norm(got["position"][:, None] - want["position"][None],
                           axis=-1).min(axis=1)
        worst = float(d.max())
    else:
        check(bool(np.array_equal(got["vis"], want["vis"])),
              f"[parallel] {label}: vis differs")
        worst = float(np.abs(got["position"] - want["position"]).max())
        worst_n = float(np.abs(got["normal"] - want["normal"]).max())
        check(worst_n <= atol, f"[parallel] {label}: normals differ by "
              f"{worst_n:.3e}")
    check(worst <= atol, f"[parallel] {label}: positions differ by "
          f"{worst:.3e} (limit {atol:g})")
    return worst


def phase_parallel(device, main_patches, ba_turned_rmse):
    """Phase 12: the multi-process paths on the sphere, each rank a child
    process with every counter at 0 before its run. a: `--distributed`, 1
    rank (NCCL), against the main path's cloud; b: 2 ranks on the one card
    (gloo), both ranks' clouds bitwise equal and equal to a's; a_launch
    (the CLI forms the job itself) and a_visible (CUDA_VISIBLE_DEVICES=0):
    NCCL and a's cloud bitwise; the in-process API (`phase_inproc`);
    c: clustered
    partitioning, 2 ranks against 1 with every view held, and 2 ranks with
    a halo of 9 of the 12 views (fewer image bytes than the stack); d:
    `run_ba_sharded` on 2 ranks on the turned calibration, against the
    single-rank BA within twice that solver's own spread over the order of
    its sums. Returns the K1 launches of every rank of every run."""
    import numpy as np

    from densepoints_tpu_torch.io.ply import read_ply

    main = {"position": main_patches.position.cpu().numpy(),
            "normal": main_patches.normal.cpu().numpy(),
            "vis": main_patches.vis.cpu().numpy()}
    launches, walls = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        (tmp / "scene").mkdir()
        scene = write_sphere_scene(tmp / "scene")
        settings = tmp / "settings.json"
        settings.write_text(json.dumps(SPHERE_SETTINGS))
        base = ["-i", str(scene), "-s", str(settings), "--device", device]

        def job(label, world, flags, halo=None, launch=False, env=None):
            """A CLI run with `flags` (`launch`: the CLI forms the job), or
            with `halo`, `densify_clustered` on the seeds of the single
            front end (no PLY then)."""
            ply = tmp / f"{label}.ply"
            spec = {"flags": base + flags + ["-o", str(ply)],
                    "device": device, "launch": launch}
            if halo is not None:
                spec.update(halo=halo, scene=str(scene),
                            settings=SPHERE_SETTINGS)
            t0 = time.perf_counter()
            recs = _run_ranks(label, world, spec, tmp, env=env)
            walls[label] = time.perf_counter() - t0
            clouds = []
            if recs[0].get("table"):
                print(f"[parallel] {label} rank table: " + "; ".join(
                    f"rank {r} host {h} card {c} uuid {u}"
                    for r, h, c, u in recs[0]["table"])
                    + f"; backend {recs[0]['backend']}", flush=True)
            for rec in recs:
                _parallel_line(label, rec)
                launches[f"{label}_rank{rec['rank']}"] = rec["launches"]
                check(rec["launches"] > 0,
                      f"[parallel] {label}: rank {rec['rank']} launched no K1")
                check(rec["plain"] == 0, f"[parallel] {label}: rank "
                      f"{rec['rank']} took the plain path {rec['plain']} times")
                with np.load(tmp / f"{label}.{rec['rank']}.npz") as f:
                    clouds.append({k: f[k] for k in f.files})
            if halo is None:
                written = read_ply(ply)["positions"]
                check(np.array_equal(written, clouds[0]["position"]),
                      f"[parallel] {label}: the PLY is not rank 0's cloud")
            for rank, cloud in enumerate(clouds[1:], 1):
                for key in ("position", "normal", "vis"):
                    check(np.array_equal(cloud[key], clouds[0][key]),
                          f"[parallel] {label}: rank {rank}'s {key} differs "
                          "from rank 0's")
            return recs, clouds[0]

        a_recs, a = job("a", 1, ["--distributed"])
        want = "nccl" if device == "cuda" else "gloo"
        check(a_recs[0]["backend"] == want,
              f"[parallel] a: backend {a_recs[0]['backend']}, expected {want}")
        exact = (len(a["position"]) == len(main["position"])
                 and np.array_equal(a["vis"], main["vis"]))
        if exact:
            worst = _same_cloud("a vs main", a, main, PARALLEL_ATOL)
            print(f"[parallel] a vs the main path: {len(a['position'])} "
                  f"patches each, vis equal, positions within {worst:.3e}",
                  flush=True)
        else:
            n, m = len(a["position"]), len(main["position"])
            print(f"[parallel] a vs the main path: {n} patches against {m} "
                  f"({100.0 * (n - m) / m:+.3f}%), vis "
                  f"{'equal' if n == m else 'of other rows'}", flush=True)
            check(abs(n - m) <= 0.01 * m,
                  f"[parallel] a: {n} patches against the main path's {m}")
        b_recs, b = job("b", 2, ["--distributed"])
        check(all(r["backend"] == "gloo" for r in b_recs),
              "[parallel] b: two ranks on one card should use gloo")
        worst = _same_cloud("b vs a", b, a, PARALLEL_ATOL)
        print(f"[parallel] b vs a: {len(b['position'])} patches each, vis "
              f"equal, positions within {worst:.3e}", flush=True)
        # The launcher: `--distributed` with no --coordinator drives every
        # card the process sees (one here); and a rank that sees only its
        # own card (CUDA_VISIBLE_DEVICES, as per-task launchers set it).
        for label, env in (("a_launch", None),
                           ("a_visible", {"CUDA_VISIBLE_DEVICES": "0"})):
            recs, cloud = job(label, 1, ["--distributed"],
                              launch=label == "a_launch", env=env)
            check(recs[0]["backend"] == want, f"[parallel] {label}: backend "
                  f"{recs[0]['backend']}, expected {want}")
            check(env is None or recs[0]["cards_seen"] == 1,
                  f"[parallel] {label}: the rank sees "
                  f"{recs[0]['cards_seen']} cards")
            for key in ("position", "normal", "vis"):
                check(np.array_equal(cloud[key], a[key]),
                      f"[parallel] {label}: {key} differs from a's")
            print(f"[parallel] {label} vs a: {len(cloud['position'])} "
                  f"patches each, bitwise equal, backend "
                  f"{recs[0]['backend']}", flush=True)

        launches.update(phase_inproc(device, scene, a, a_recs[0], walls))

        # Shared seeds: each rank's own seeds would take priorities offset
        # by its rank, and the cloud would depend on the number of ranks.
        _, c1 = job("c_one", 1, [], halo=-1.0)
        _, c2 = job("c_two", 2, [], halo=-1.0)
        worst = _same_cloud("c_two vs c_one", c2, c1, CLUSTERED_ATOL,
                            nearest=True)
        print(f"[parallel] c: clustered 2 ranks vs 1 rank, every view held, "
              f"shared seeds: {len(c2['position'])} patches each, nearest "
              f"positions within {worst:.3e}", flush=True)
        halo_recs, _ = job("c_halo", 2, [
            "--partition", "clustered", "--halo-threshold",
            str(PARALLEL_HALO)])
        c = halo_recs[0]["counters"]
        stack = int(c["image_bytes_held"] / c["images_held"]
                    * c["images_total"])
        for rec in halo_recs:
            held = rec["counters"]["image_bytes_held"]
            check(held < stack, f"[parallel] c_halo: rank {rec['rank']} "
                  f"holds {held:g} bytes of the {stack} of the stack")
        print(f"[parallel] c: halo {PARALLEL_HALO}: ranks hold " + ", ".join(
            f"{r['counters']['images_held']:g}" for r in halo_recs)
            + f" of {c['images_total']:g} views (" + ", ".join(
                f"{r['counters']['image_bytes_held']:g}" for r in halo_recs)
            + f" of {stack} bytes)", flush=True)

        # d: sharded BA on the turned calibration, against one rank's.
        (tmp / "turned").mkdir()
        turned = write_sphere_scene(tmp / "turned", turn=0.002)
        ba_settings = _with_settings(ba={"enable": True})
        orders = _ba_rmse_orders(turned, ba_settings, device, BA_ORDERS)
        single, lo, hi = orders[0], min(orders), max(orders)
        print(f"[parallel] d: single-rank run_ba RMSE {single:.6f} px in the "
              f"observations' order, {lo:.6f} - {hi:.6f} px over it and "
              f"{BA_ORDERS - 1} permutations of it (the sums' order moves "
              f"this problem's solution)", flush=True)
        d_recs = _run_ranks("d", 2, {"ba": True, "scene": str(turned),
                                     "settings": ba_settings,
                                     "device": device}, tmp)
        for rec in d_recs:
            print(f"[parallel] d rank {rec['rank']}/2 backend={rec['backend']}"
                  f" run_ba_sharded RMSE {rec['rmse']:.6f} px in "
                  f"{rec['ba_s']:.3f} s over {rec['observations']} "
                  f"observations of {rec['seeds']} seeds; collective "
                  f"bytes={rec['collective_bytes']} calls="
                  f"{rec['collective_calls']} host_bytes={rec['host_bytes']}",
                  flush=True)
            # The sharded sums add in another order, which moves this
            # problem's solution as much as a shuffle of the observations
            # moves the single rank's: held to twice that spread (PERF.md,
            # section 6), and to BA_RMSE_ATOL where the spread is smaller.
            tol = max(BA_RMSE_ATOL, 2.0 * (hi - lo))
            check(abs(rec["rmse"] - single) <= tol,
                  f"[parallel] d: sharded RMSE {rec['rmse']:.6f} px, single "
                  f"rank {single:.6f} px (limit {tol:.6f}: twice the single "
                  f"rank's spread over the sums' orders)")
            print(f"[parallel] d rank {rec['rank']}: |sharded - single| "
                  f"{abs(rec['rmse'] - single):.6f} px (limit {tol:.6f})",
                  flush=True)
        print(f"[parallel] d: single-rank run_ba RMSE {single:.6f} px here, "
              f"{ba_turned_rmse:.6f} px in phase 11's CLI run", flush=True)
        check(abs(single - ba_turned_rmse) <= BA_RMSE_ATOL,
              f"[parallel] d: single-rank RMSE {single:.6f} px, phase 11 "
              f"{ba_turned_rmse:.6f} px")
    return launches


def _bitwise(label, got, want):
    """`got`'s position, normal and vis equal `want`'s."""
    import numpy as np

    for key in ("position", "normal", "vis"):
        check(got[key].shape == want[key].shape
              and np.array_equal(got[key], want[key]),
              f"{label}: {key} differs ({len(got['position'])} patches "
              f"against {len(want['position'])})")


def _inproc(run, device):
    """`run()` -> `DensifyResult` in this process, every counter at 0 just
    before; returns (cloud, result, wall seconds, K1 launches, plain calls
    of this process)."""
    import torch

    _reset_counters()
    t0 = time.perf_counter()
    res = run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = _read_counters()
    cloud = {"position": res.patches.position.cpu().numpy(),
             "normal": res.patches.normal.cpu().numpy(),
             "vis": res.patches.vis.cpu().numpy()}
    return cloud, res, wall, launches["allview_ncc"], sum(plain.values())


def _job_ranks(tag, res, want_launches, want_nccl):
    """The per-rank counters of a call that ran as a job of its own ranks
    (`parallel.local_job`): prints each rank's card, UUID, K1 launches and
    plain calls, and fails unless every rank launched K1 `want_launches`
    times with no plain call and the job's backend is as wanted. Returns
    the rows (rank, card, uuid8, launches)."""
    c = res.metrics.counters
    check("job_ranks" in c, f"{tag}: the call ran no job of ranks")
    rows = []
    for rank in range(int(c["job_ranks"])):
        card, uuid8 = int(c[f"rank{rank}_card"]), int(c[f"rank{rank}_uuid8"])
        launches = int(c[f"rank{rank}_allview_ncc_launches"])
        plain = int(c[f"rank{rank}_plain_calls"])
        print(f"{tag} rank {rank}/{int(c['job_ranks'])} card {card} uuid "
              f"{uuid8:08x} backend {'nccl' if c['job_nccl'] else 'gloo'} "
              f"K1_launches={launches} plain_calls={plain}", flush=True)
        check(launches == want_launches and plain == 0,
              f"{tag}: rank {rank} K1 launches {launches} (want "
              f"{want_launches}), plain calls {plain}")
        rows.append((rank, card, uuid8, launches))
    check(bool(c["job_nccl"]) == want_nccl,
          f"{tag}: job_nccl {c['job_nccl']}, expected {int(want_nccl)}")
    return rows


def phase_inproc(device, scene_path, a, a_rec, walls):
    """Phase 12's in-process lines on the one card. a_inproc:
    `densify_multihost(mesh=make_mesh(4))` from this process (L = 1 here,
    so in place) gives job a's cloud bitwise, and `densify_distributed`
    with `parallel.num_devices` 0 and 4 its own `make_mesh(1)` run's;
    a_local1 / b_local2: `parallel.local_job.run` on `densify_multihost`
    with 1 rank (NCCL) and 2 ranks sharing the card (gloo), each job a's
    cloud bitwise, every rank with job a's K1 launches and no plain call,
    and no process group left in this process. Returns the K1 launches."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from densepoints_tpu_torch.config import ParallelConfig, load_config
    from densepoints_tpu_torch.io import load_scene
    from densepoints_tpu_torch.parallel import local_job
    from densepoints_tpu_torch.parallel import mesh as pmesh
    from densepoints_tpu_torch.parallel.multihost import densify_multihost
    from densepoints_tpu_torch.parallel.pipeline import densify_distributed

    config = load_config(SPHERE_SETTINGS)
    scene = load_scene(scene_path, device=device)
    launches = {}
    mesh = pmesh.make_mesh(4, device=device)
    check(mesh.world_size == 1 and mesh.started,
          f"[parallel] a_inproc: make_mesh(4) on one card spans "
          f"{mesh.world_size} rank(s), backend {mesh.backend}")
    cloud, _, wall, n, plain = _inproc(
        lambda: densify_multihost(scene, config, mesh=mesh), device)
    launches["a_inproc"] = n
    check(n == a_rec["launches"] and plain == 0, f"[parallel] a_inproc: "
          f"K1 launches {n} (job a {a_rec['launches']}), plain {plain}")
    _bitwise("[parallel] a_inproc vs a", cloud, a)
    print(f"[parallel] a_inproc densify_multihost(mesh=make_mesh(4)): 1 "
          f"rank in place, {len(cloud['position'])} patches, a's cloud "
          f"bitwise, K1_launches={n} plain_calls={plain} wall={wall:.3f}s",
          flush=True)
    runs = {}
    for label, n_dev in (("make_mesh(1)", None), ("num_devices 0", 0),
                         ("num_devices 4", 4)):
        cfg = config if n_dev is None else dataclasses.replace(
            config, parallel=ParallelConfig(num_devices=n_dev))
        dmesh = pmesh.make_mesh(1, device=device) if n_dev is None else None
        runs[label], _, wall, n, plain = _inproc(
            lambda: densify_distributed(scene, cfg, mesh=dmesh,
                                        device=device), device)
        launches[f"a_inproc_distributed_{label}"] = n
        check(n > 0 and plain == 0, f"[parallel] a_inproc "
              f"densify_distributed {label}: K1 launches {n}, plain {plain}")
        _bitwise(f"[parallel] a_inproc densify_distributed {label}",
                 runs[label], runs["make_mesh(1)"])
        print(f"[parallel] a_inproc densify_distributed {label}: "
              f"{len(runs[label]['position'])} patches, the make_mesh(1) "
              f"run's bitwise, K1_launches={n} plain_calls={plain} "
              f"wall={wall:.3f}s", flush=True)
    for label, world, cli_job in (("a_local1", 1, "a"), ("b_local2", 2, "b")):
        mesh = pmesh.Mesh(rank=0, world_size=world,
                          device=torch.device(device, 0),
                          backend=pmesh.LOCAL)
        cloud, res, wall, n, plain = _inproc(
            lambda: local_job.run("densify_multihost", mesh, scene=scene,
                                  config=config), device)
        check(n == 0 and plain == 0, f"[parallel] {label}: this process "
              f"launched K1 {n} times, made {plain} plain calls")
        for rank, *_, ranks_launches in _job_ranks(
                f"[parallel] {label}", res, a_rec["launches"],
                want_nccl=world == 1):
            launches[f"{label}_rank{rank}"] = ranks_launches
        _bitwise(f"[parallel] {label} vs a", cloud, a)
        check(not dist.is_initialized() and pmesh.global_mesh().world_size
              == 1, f"[parallel] {label}: this process holds a process "
              "group after the call")
        print(f"[parallel] {label}: {world} rank(s) started for one call "
              f"from this process, a's cloud bitwise, no process group "
              f"left; call wall {wall:.3f} s, job {cli_job} (CLI ranks "
              f"started by this script) {walls[cli_job]:.3f} s", flush=True)
    return launches


# `--cards`: a line of the rank table `initialize_multihost` logs on rank 0.
_TABLE_LINE = re.compile(r"multihost: rank (\d+)/(\d+) host (\S+) card (\S+) "
                         r"uuid (\S+) backend (\w+)")


def cards_only(device):
    """The `--cards` mode: the sphere over every card of the host. a: the
    CLI's `--distributed` on 1 hand-started rank that sees card 0 alone
    (the reference); launch:
    `python -m densepoints_tpu_torch.cli --distributed` in one process,
    one rank per card (`parallel.launch`), its rank table read from its
    log; visible: one hand-started process per card, each seeing only its
    own (CUDA_VISIBLE_DEVICES), K1 launched and no plain call in each.
    Each multi-card job must pick NCCL on distinct cards and give a's
    cloud (count, positions within PARALLEL_ATOL)."""
    import numpy as np
    import torch

    from densepoints_tpu_torch.io.ply import read_ply

    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        (tmp / "scene").mkdir()
        scene = write_sphere_scene(tmp / "scene")
        settings = tmp / "settings.json"
        settings.write_text(json.dumps(SPHERE_SETTINGS))
        base = ["-i", str(scene), "-s", str(settings), "--device", device,
                "--distributed"]
        # The reference sees one card: a process that sees several drives
        # a rank on each (parallel.launch).
        a_rec = _run_ranks("a", 1, {"flags": base + ["-o", str(tmp / "a.ply")],
                                    "device": device}, tmp,
                           env={"CUDA_VISIBLE_DEVICES": "0"})[0]
        _parallel_line("a", a_rec)
        with np.load(tmp / "a.0.npz") as f:
            a = {k: f[k] for k in f.files}

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "densepoints_tpu_torch.cli", *base, "-o",
             str(tmp / "launch.ply")], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            timeout=PARALLEL_CHILD_S)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"[cards] launch: exit "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}")
        rows = _TABLE_LINE.findall(proc.stdout)
        for line in proc.stdout.splitlines():
            if any(k in line for k in ("launch:", "multihost: rank",
                                       "densify done")):
                print(f"[cards] launch: {line.split(' INFO ')[-1]}",
                      flush=True)
        check(len(rows) == cards and {int(r[1]) for r in rows} == {cards},
              f"[cards] launch: {len(rows)} table rows, {cards} cards")
        check({r[5] for r in rows} == {"nccl"},
              f"[cards] launch: backends {sorted({r[5] for r in rows})}")
        check(len({r[3] for r in rows}) == cards
              and len({r[4] for r in rows}) == cards,
              f"[cards] launch: cards {[r[3] for r in rows]}")
        got = read_ply(tmp / "launch.ply")["positions"]
        check(len(got) == len(a["position"]), f"[cards] launch: "
              f"{len(got)} patches, a {len(a['position'])}")
        worst = float(np.abs(got - a["position"]).max()) if len(got) else 0.0
        check(worst <= PARALLEL_ATOL, f"[cards] launch: positions differ "
              f"from a's by {worst:.3e}")
        print(f"[cards] launch: {cards} ranks in one process, backend nccl, "
              f"{len(got)} patches, positions within {worst:.3e} of a's, "
              f"command wall {wall:.3f} s", flush=True)

        recs = _run_ranks("visible", cards, {
            "flags": base + ["-o", str(tmp / "visible.ply")],
            "device": device, "visible": True}, tmp)
        print("[cards] visible rank table: " + "; ".join(
            f"rank {r} host {h} card {c} uuid {u}"
            for r, h, c, u in recs[0]["table"]), flush=True)
        check(len({u for *_, u in recs[0]["table"]}) == cards,
              "[cards] visible: the ranks' cards are not distinct")
        for rec in recs:
            _parallel_line("visible", rec)
            check(rec["backend"] == "nccl" and rec["cards_seen"] == 1,
                  f"[cards] visible: rank {rec['rank']} backend "
                  f"{rec['backend']}, sees {rec['cards_seen']} cards")
            check(rec["launches"] > 0 and rec["plain"] == 0,
                  f"[cards] visible: rank {rec['rank']} K1 launches "
                  f"{rec['launches']}, plain calls {rec['plain']}")
            with np.load(tmp / f"visible.{rec['rank']}.npz") as f:
                cloud = {k: f[k] for k in f.files}
            worst = _same_cloud(f"visible rank {rec['rank']} vs a", cloud, a,
                                PARALLEL_ATOL)
        print(f"[cards] visible: {cards} processes of one card each, NCCL, "
              f"clouds within {worst:.3e} of a's", flush=True)
        cards_inproc(device, scene, a, a_rec, wall)


def cards_inproc(device, scene_path, a, a_rec, launch_wall):
    """`--cards`, the in-process API over every card: `make_mesh(4)` from
    this process is a mesh of min(4, cards) ranks not yet started, which
    `densify_multihost` runs as a job of NCCL ranks on distinct cards
    (a's cloud bitwise, a's K1 launches on every rank, no plain call),
    `densify_distributed` as well (its `make_mesh(1)` run's cloud within
    PARALLEL_ATOL), and on the turned calibration `generate_seed_points`
    and `run_ba_sharded` (through the pipeline's bundle adjustment), the
    RMSE within phase 12 d's tolerance of the single-rank solver's."""
    import torch
    import torch.distributed as dist

    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.io import load_scene
    from densepoints_tpu_torch.parallel import mesh as pmesh
    from densepoints_tpu_torch.parallel.multihost import densify_multihost
    from densepoints_tpu_torch.parallel.pipeline import densify_distributed

    cards = torch.cuda.device_count()
    world = min(4, cards)
    mesh = pmesh.make_mesh(4, device=device)
    check(world > 1 and mesh.world_size == world and not mesh.started,
          f"[cards] inproc: make_mesh(4) on {cards} cards spans "
          f"{mesh.world_size} rank(s), backend {mesh.backend}")
    config = load_config(SPHERE_SETTINGS)
    scene = load_scene(scene_path, device=device)
    cloud, res, wall, n, plain = _inproc(
        lambda: densify_multihost(scene, config, mesh=mesh), device)
    check(n == 0 and plain == 0, f"[cards] inproc: this process launched "
          f"K1 {n} times, made {plain} plain calls")
    rows = _job_ranks("[cards] inproc densify_multihost", res,
                      a_rec["launches"], want_nccl=True)
    check([card for _, card, _, _ in rows] == list(range(world))
          and len({uuid for _, _, uuid, _ in rows}) == world,
          f"[cards] inproc: cards and UUIDs {rows}")
    _bitwise("[cards] inproc densify_multihost vs a", cloud, a)
    check(not dist.is_initialized(), "[cards] inproc: this process holds a "
          "process group after the call")
    print(f"[cards] inproc densify_multihost(mesh=make_mesh(4)): {world} "
          f"NCCL ranks on cards 0-{world - 1}, {world} distinct UUIDs, "
          f"{len(cloud['position'])} patches, a's cloud bitwise; call wall "
          f"{wall:.3f} s, the CLI launcher's command {launch_wall:.3f} s",
          flush=True)

    one, _, _, _, _ = _inproc(lambda: densify_distributed(
        scene, config, mesh=pmesh.make_mesh(1, device=device)), device)
    got, res, wall, _, _ = _inproc(lambda: densify_distributed(
        scene, config, mesh=mesh), device)
    _job_ranks("[cards] inproc densify_distributed", res,
               int(res.metrics.counters["rank0_allview_ncc_launches"]),
               want_nccl=True)
    worst = _same_cloud("[cards] inproc densify_distributed vs 1 rank", got,
                        one, PARALLEL_ATOL)
    print(f"[cards] inproc densify_distributed(mesh=make_mesh(4)): "
          f"{len(got['position'])} patches, vis equal, positions within "
          f"{worst:.3e} of its 1-rank run's; call wall {wall:.3f} s",
          flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        turned = write_sphere_scene(Path(tmp), turn=0.002)
        settings = _with_settings(ba={"enable": True})
        orders = _ba_rmse_orders(turned, settings, device, BA_ORDERS)
        t0 = time.perf_counter()
        rmse = _ba_rmse(turned, settings, device, mesh=mesh)
        wall = time.perf_counter() - t0
    single, lo, hi = orders[0], min(orders), max(orders)
    tol = max(BA_RMSE_ATOL, 2.0 * (hi - lo))
    print(f"[cards] inproc generate_seed_points + run_ba_sharded "
          f"(mesh=make_mesh(4)): RMSE {rmse:.6f} px in {wall:.3f} s "
          f"(two jobs of {world} ranks); single rank {single:.6f} px, "
          f"{lo:.6f} - {hi:.6f} over {BA_ORDERS} orders of its sums; "
          f"|difference| {abs(rmse - single):.6f} (limit {tol:.6f})",
          flush=True)
    check(abs(rmse - single) <= tol, f"[cards] inproc: sharded RMSE "
          f"{rmse:.6f} px, single rank {single:.6f} px (limit {tol:.6f})")


# Phase 13: the three end-to-end programs of the port, a, b and c at the
# JAX package's recorded configurations, d at 312 views. Run a is
# `DTU_r05.json`'s: 49 views of 1600 x 1200 and its 20 rounds. Views and
# resolution are never cut; should the script outgrow its time,
# `--max-rounds` (depth) is the one to cut, run d's first.
DTU_RUNS = (
    # label, program, flags, the JAX package's record of the configuration
    # (None: there is none)
    ("a", "dtu_scale_run",
     ["--kp", "8192", "--max-per-cell", "6", "--nm-iters", "120",
      "--expand-nm-iters", "40", "--score-views", "25", "--grid-scale", "8",
      "--max-rounds", "20"], "DTU_r05.json"),
    ("b", "dtu_layout_run", [], "DTU_LAYOUT_r04.json"),
    ("c", "occlusion_run", [], "OCCLUSION_r05.json"),
    # Run a's program and flags at Middlebury `temple`'s 312 views of 640 x
    # 480: the focal length keeps run a's field of view (2900 x 640 /
    # 1600), grid_scale 4 about its patch density on the object (cells of
    # 4 x 0.560 mm against 8 x 0.224), 12 rounds. No JAX record exists at
    # this configuration.
    ("d", "dtu_scale_run",
     ["--kp", "4096", "--max-per-cell", "6", "--nm-iters", "120",
      "--expand-nm-iters", "40", "--score-views", "25", "--grid-scale", "4",
      "--max-rounds", "12", "--views", "312", "--width", "640", "--height",
      "480", "--focal", "1160"], None),
)
# Quality gates, each from the JAX package's record of the same run (its
# value in the comment); quality, not speed.
DTU_PIXEL_MM = 650.0 / 2900.0  # run a's pixel footprint, 0.224 mm
DTU_D_PIXEL_MM = 650.0 / 1160.0  # run d's pixel footprint, 0.560 mm
DTU_GATES = {
    # exact median < one pixel footprint (0.1636), completeness under 2 mm
    # >= 0.95 (0.9994), final patches >= 10,000 (16,595)
    "a": lambda art: [
        ("accuracy_exact_median",
         art["quality_mm"]["accuracy_exact_median"], "<", DTU_PIXEL_MM),
        ("completeness_frac_under",
         art["quality_mm"]["completeness_frac_under"], ">=", 0.95),
        ("patches", art["patches"], ">=", 10_000)],
    # exact median < 0.5 mm (0.1849), final patches >= 1,500 (2,526)
    "b": lambda art: [
        ("accuracy_exact_median",
         art["quality_mm"]["accuracy_exact_median"], "<", 0.5),
        ("patches", art["patches"], ">=", 1_500)],
    # the occlusion filter's kept patches: median distance to the surface
    # union < 2 mm (0.5406)
    "c": lambda art: [
        ("kept_gt_dist_median",
         art["occlusion_filter"]["kept"].get("gt_dist_median",
                                              float("inf")), "<", 2.0)],
    # No record: run a's gates in absolute quality against the sphere, at
    # run d's pixel footprint; final patches >= 5,000 (about 10,000
    # expected from run a's 16,594 at its cell size)
    "d": lambda art: [
        ("accuracy_exact_median",
         art["quality_mm"]["accuracy_exact_median"], "<", DTU_D_PIXEL_MM),
        ("completeness_frac_under",
         art["quality_mm"]["completeness_frac_under"], ">=", 0.95),
        ("patches", art["patches"], ">=", 5_000)],
}


def _dtu_counts(art):
    """The counts a run and a JAX record share, by name."""
    counts = dict(art.get("counters", {}))
    counts["patches"] = art["patches"]
    occ = art.get("occlusion_filter")
    if occ:
        counts["expanded_patches"] = occ["expanded_patches"]
        counts["occlusion_killed"] = occ["killed"]["count"]
    return counts


def dtu_run(label, device, profile=False):
    """One program of phase 13 through its `run`, every counter at 0 just
    before; returns (artifact, K1 launches, plain calls, peak bytes, wall
    seconds, the profiler or None)."""
    import importlib

    import torch

    _, name, flags, _ = next(r for r in DTU_RUNS if r[0] == label)
    program = importlib.import_module(f"densepoints_tpu_torch.scripts.{name}")
    args = program.parse_args(flags + ["--device", device])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    prof = None
    t0 = time.perf_counter()
    try:
        if profile:
            from torch.profiler import ProfilerActivity, profile as profiler

            with profiler(activities=[ProfilerActivity.CUDA]) as prof:
                artifact = program.run(args)
                torch.cuda.synchronize()
        else:
            artifact = program.run(args)
    except SmokeFailure:
        raise
    except Exception as exc:  # a stage that raises fails the phase
        raise SmokeFailure(f"[dtu] {label} ({name}) raised "
                           f"{type(exc).__name__}: {exc}") from exc
    wall = time.perf_counter() - t0
    launches, plain = _read_counters()
    return (artifact, launches["allview_ncc"], sum(plain.values()),
            torch.cuda.max_memory_allocated(), wall, prof)


def _dtu_check(label, artifact, launches, plain, peak, wall):
    _, name, _, record = next(r for r in DTU_RUNS if r[0] == label)
    counts = _dtu_counts(artifact)
    line = {
        "render_s": artifact["render_seconds"],
        "layout_s": artifact.get("layout_seconds"),
        "densify_s": artifact["densify_seconds"],
        "run_s": round(wall, 2),
        "stage_s": artifact["stage_seconds"],
        "counts": counts,
        "allview_ncc_launches": launches, "plain_calls": plain,
        "max_memory_allocated": peak,
        "quality_mm": artifact["quality_mm"],
    }
    if "occlusion_filter" in artifact:
        line["occlusion_filter"] = artifact["occlusion_filter"]
    sides = [artifact.get("tail_mm", {}).get(k, {})
             for k in ("tail", "inliers")]
    if sum(side.get("count", 0) for side in sides):
        # Mean visible views per final patch, from the two populations'
        # means (each rounded to 2 decimals).
        line["visible_views_mean"] = round(
            sum(side.get("count", 0) * side.get("visible_views_mean", 0.0)
                for side in sides)
            / sum(side.get("count", 0) for side in sides), 2)
    print(f"[dtu] {label} {name}: {json.dumps(line)}", flush=True)
    nm = {k: int(v) for k, v in counts.items() if k.startswith("nm_")}
    print(f"[nm-graph] dtu {label}: {json.dumps(nm)}", flush=True)
    if record is not None:
        want = json.loads((ROOT / record).read_text())
        want_counts = _dtu_counts(want)
        shared = {k: (v, want_counts[k], round(100.0 * (v - want_counts[k])
                                                / want_counts[k], 2))
                  for k, v in counts.items()
                  if want_counts.get(k)}
        print(f"[dtu] {label} against {record} (port, JAX record, diff %, "
              f"for information): {json.dumps(shared)}", flush=True)
    check(launches > 0, f"[dtu] {label}: the all-views kernel was never "
          "launched")
    check(plain == 0, f"[dtu] {label}: {plain} plain scoring calls")
    ops = {"<": lambda x, y: x < y, ">=": lambda x, y: x >= y}
    for gate, value, op, limit in DTU_GATES[label](artifact):
        check(ops[op](value, limit),
              f"[dtu] {label}: {gate} {value} is not {op} {limit:g}")


def phase_dtu(device, nm_results=None):
    """Phase 13: the three end-to-end programs on the card, runs a, b and c
    at the JAX package's recorded configurations and d at 312 views;
    returns the K1 launches of each run by label. Run a's largest solver
    call holds the step kernels against their twins (`_nm_kernel_check`),
    their records added to `nm_results[kernel]["dtu_a_largest"]`."""
    launches = {}
    nm_results = {} if nm_results is None else nm_results
    for label, *_ in DTU_RUNS:
        with _nm_recorded(keep_inputs=label == "a") as calls:
            artifact, k1, plain, peak, wall, _ = dtu_run(label, device)
        _dtu_check(label, artifact, k1, plain, peak, wall)
        if label == "a":
            largest = max(calls, key=lambda call: call["B"])["inputs"]
            calls.clear()
            records, _, _ = _nm_kernel_check("dtu_a_largest", largest)
            del largest
            for name, record in records.items():
                nm_results.setdefault(name, {})["dtu_a_largest"] = record
        check(artifact["counters"].get("nm_graph_captures", 0) > 0,
              f"[dtu] {label}: Nelder-Mead captured no CUDA graph")
        launches[label] = k1
    return launches


def dtu_only(device):
    """The `--dtu` mode: phase 13 alone, after the device and the build."""
    print(json.dumps({"allview_ncc_launches_dtu": phase_dtu(device)}),
          flush=True)


# Phase 14: the measurement programs of the port, each through its `run` at
# its defaults, the JAX package's configurations; none needed a cut to fit
# the phase into ~120 s (88 s alone, 57 s after phases 1-13).
MEASURE_RUNS = (
    # program, runs in this process (its launches are counted here) or in
    # worker processes (counted by their records), kernels that must launch
    ("expand_profile", True, ("allview_ncc",)),
    ("kernel_bench", True, ("slot_ncc",)),
    ("kernel_paged_bench", True, ("allview_ncc", "slot_ncc")),
    ("kernel_roofline", True, ("allview_ncc", "slot_ncc")),
    ("prescreen_ab", True, ("allview_ncc",)),
    ("scaling_overhead", True, ("allview_ncc",)),
    ("scaling_measure", False, ("allview_ncc",)),
    ("scaling_bench", False, ("allview_ncc",)),
)
PRESCREEN_RTOL = 0.10  # mode off's final patches against PRESCREEN_r05.json
# Left out of the check that nothing is written: the kernels' build, the
# git-ignored run-output directory, bytecode caches.
UNWATCHED = ("densepoints_tpu_torch/_build", "chiprun_out", "__pycache__")


def _tree_state(root: Path) -> dict:
    """{path: (size, mtime)} of every file under `root` but the unwatched
    directories."""
    state = {}
    for path in root.rglob("*"):
        rel = path.relative_to(root).as_posix()
        if any(part in rel for part in UNWATCHED) or rel.startswith(".git"):
            continue
        if path.is_file():
            st = path.stat()
            state[rel] = (st.st_size, st.st_mtime_ns)
    return state


def _numbers(value, where=""):
    """(path, number) of every number in a record."""
    if isinstance(value, dict):
        for key, v in value.items():
            yield from _numbers(v, f"{where}.{key}")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _numbers(v, f"{where}[{i}]")
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        yield where, value


def measure_run(name, in_process, kernels, device, tmp, tag="measure"):
    """One program of phase 14 (or 15) through its `run`, every counter at
    0 just before; checks and prints its record under `[tag]`, and returns
    it."""
    import importlib
    import math

    import torch

    program = importlib.import_module(f"densepoints_tpu_torch.scripts.{name}")
    args = program.parse_args(["--device", device,
                               "--out", str(tmp / f"{name}.json")])
    before = {ROOT: _tree_state(ROOT), Path.cwd(): _tree_state(Path.cwd())}
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    try:
        record = program.run(args)
    except SmokeFailure:
        raise
    except Exception as exc:  # a program that raises fails the phase
        raise SmokeFailure(f"[{tag}] {name} raised "
                           f"{type(exc).__name__}: {exc}") from exc
    wall = time.perf_counter() - t0
    launches, plain = _read_counters()
    if not in_process:  # the ranks' counts, from their records
        launches = dict(launches, **record["launches"])
        plain = {"ranks": record["plain_calls"]}
    print(f"[{tag}] {name}: {json.dumps(record)}", flush=True)
    print(f"[{tag}] {name} run_s={wall:.2f} launches="
          f"{json.dumps(launches)} plain_calls={sum(plain.values())}",
          flush=True)
    for kernel in kernels:
        check(launches[kernel] > 0,
              f"[{tag}] {name}: {kernel} was never launched")
    check(sum(plain.values()) == 0,
          f"[{tag}] {name}: {sum(plain.values())} plain scoring calls "
          "on the card")
    for root, state in before.items():
        check(_tree_state(root) == state,
              f"[{tag}] {name} wrote into {root}")
    check(not (tmp / f"{name}.json").exists(),
          f"[{tag}] {name}: run() wrote its --out file")
    for where, number in _numbers(record):
        check(math.isfinite(number),
              f"[{tag}] {name}: {where} is {number}")
    return record


def _prescreen_check(record):
    want = json.loads((ROOT / "PRESCREEN_r05.json").read_text())["modes"]
    for mode, got in record["modes"].items():
        print(f"[measure] prescreen_ab {mode}: final "
              f"{got['patches_final']} after expand "
              f"{got['patches_after_expand']} (PRESCREEN_r05.json "
              f"{want[mode]['patches_final']}, "
              f"{want[mode]['patches_after_expand']})", flush=True)
    got = record["modes"]["off"]["patches_final"]
    ref = want["off"]["patches_final"]
    check(abs(got - ref) <= PRESCREEN_RTOL * ref,
          f"[measure] prescreen_ab off: {got} final patches, "
          f"PRESCREEN_r05.json {ref} (+-{PRESCREEN_RTOL:.0%})")


def phase_measure(device):
    """Phase 14: the measurement programs on the card; returns the K1
    launches of each by name."""
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_measure_") as tmp:
        for name, in_process, kernels in MEASURE_RUNS:
            record = measure_run(name, in_process, kernels, device,
                                 Path(tmp))
            launches[name] = record["launches"]["allview_ncc"]
            if name == "prescreen_ab":
                _prescreen_check(record)
            if name == "scaling_measure":
                # The worker program's records, as scaling_measure read
                # them from its ranks.
                print("[measure] scaling_worker: " + json.dumps(
                    {r["nproc"]: {k: r[k] for k in (
                        "backend", "wall_seconds", "stage_seconds",
                        "counters", "patches_per_rank", "launches")}
                     for r in record["measured"]}), flush=True)
    return launches


def measure_only(device):
    """The `--measure` mode: phase 14 alone, after the device and the
    build."""
    print(json.dumps({"allview_ncc_launches_measure":
                      phase_measure(device)}), flush=True)


# Phase 15: the port's bench program at the root `bench.py`'s configuration
# (nothing cut), then the entry points of `__graft_entry__.py`.
BENCH_RTOL = 0.10  # final and after-expansion patches against BENCH_r05.json
BENCH_RADIAL = 1.5  # median radial error of the bench cloud (radius 150)
DRYRUN_RANKS = 8
DRYRUN_WANT = (16, 4)  # MULTICHIP_r05.json: refined 16 patches, 4 inserted


def _bench_record_counts():
    """(final, after expansion) patches of the JAX bench's warm run, from
    `BENCH_r05.json` (its log's last `patches_after_expand`)."""
    import re

    rec = json.loads((ROOT / "BENCH_r05.json").read_text())
    after = re.findall(r"patches_after_expand=(\d+)", rec["tail"])
    return rec["parsed"]["densify_patches_final"], int(after[-1])


def phase_bench(device):
    """Phase 15: `scripts.bench` through its `run` (phase 14's checks, and
    its counts against `BENCH_r05.json`), then `entry.entry()` and
    `entry.dryrun_multichip(8)` on the card; returns the K1 launches of
    the bench run and of `entry()`."""
    import math

    import torch

    from densepoints_tpu_torch import entry

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        rec = measure_run("bench", True, ("allview_ncc",), device, Path(tmp),
                          tag="bench")
    want_final, want_after = _bench_record_counts()
    final, after = rec["densify_patches_final"], rec["patches_after_expand"]
    print(f"[bench] {rec['device']}: final {final} (BENCH_r05.json "
          f"{want_final}), after expand {after} ({want_after}); e2e "
          "patches/s min / median / max "
          + " / ".join(f"{rec['e2e_patches_per_sec'][k]:.1f}"
                       for k in ("min", "median", "max"))
          + "; refine patches/s "
          + " / ".join(f"{rec['refine_patches_per_sec'][k]:.1f}"
                       for k in ("min", "median", "max"))
          + f"; K1 {rec['kernel_ms_per_pass']:.5f} ms b2b, bound "
          f"{rec['kernel_bound_ms']:.5f} ({rec['kernel_bound_by']}), share "
          f"{rec['kernel_bound_share']:.3f}; median radial error "
          f"{rec['median_radial_error']:.4f}", flush=True)
    for name, got, want in (("final", final, want_final),
                            ("after expand", after, want_after)):
        check(abs(got - want) <= BENCH_RTOL * want,
              f"[bench] {name} {got} patches, BENCH_r05.json {want} "
              f"(+-{BENCH_RTOL:.0%})")
    check(rec["median_radial_error"] < BENCH_RADIAL,
          f"[bench] median radial error {rec['median_radial_error']:.4f}")

    before = {ROOT: _tree_state(ROOT), Path.cwd(): _tree_state(Path.cwd())}
    _reset_counters()
    try:
        fn, example = entry.entry(device)
        out = fn(*example)
        torch.cuda.synchronize()
    except Exception as exc:
        raise SmokeFailure(f"[entry] entry() raised {type(exc).__name__}: "
                           f"{exc}") from exc
    launches, plain = _read_counters()
    finite = bool(torch.isfinite(out.position).all())
    print(f"[entry] entry(): {launches['allview_ncc']} K1 launches, "
          f"{sum(plain.values())} plain calls, {int(out.alive.sum())} of "
          f"{out.capacity} patches alive, positions finite {finite}",
          flush=True)
    check(launches["allview_ncc"] > 0, "[entry] entry() launched no K1")
    check(sum(plain.values()) == 0, "[entry] entry() took the plain path")
    check(finite and out.position.device.type == "cuda",
          "[entry] entry(): non-finite positions or not on the card")
    t0 = time.perf_counter()
    try:
        got = entry.dryrun_multichip(DRYRUN_RANKS, device)
    except Exception as exc:  # a rank that fails fails the phase
        raise SmokeFailure(f"[entry] dryrun_multichip({DRYRUN_RANKS}) raised"
                           f" {type(exc).__name__}: {exc}") from exc
    print(f"[entry] dryrun_multichip({DRYRUN_RANKS}) on the card: refined "
          f"{got[0]} patches, {got[1]} inserted in "
          f"{time.perf_counter() - t0:.2f} s (MULTICHIP_r05.json: refined "
          f"{DRYRUN_WANT[0]} patches, {DRYRUN_WANT[1]} inserted)", flush=True)
    check(got == DRYRUN_WANT, f"[entry] dryrun_multichip: {got}")
    for root, state in before.items():
        check(_tree_state(root) == state, f"[entry] wrote into {root}")
    return {"bench": rec["launches"]["allview_ncc"],
            "entry": launches["allview_ncc"]}


def bench_only(device):
    """The `--bench` mode: phase 15 alone, after the device and the
    build."""
    print(json.dumps({"allview_ncc_launches_bench": phase_bench(device)}),
          flush=True)


def _profile_dtu(device):
    """Run a of phase 13 under `torch.profiler` (key averages only, no
    trace file); a record of its device ops, device time, K1's time and
    launches, the ten costliest kernels and the device-busy share of
    `densify`'s wall and of the run's."""
    import torch

    artifact, k1, plain, peak, wall, prof = dtu_run("a", device, True)
    _dtu_check("a", artifact, k1, plain, peak, wall)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    k1_events = [e for e in kernels if "allview_ncc_kernel" in e.key]
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)
    densify_s = artifact["densify_seconds"]
    return {
        "root": str(ROOT), "card": torch.cuda.get_device_name(0),
        "device_ops": sum(e.count for e in kernels),
        "device_ms": round(device_ms, 3),
        "allview_ncc": {
            "ms": round(sum(e.device_time_total for e in k1_events) / 1e3,
                        3),
            "events": sum(e.count for e in k1_events), "launches": k1},
        "top10": [{"name": e.key[:120], "count": e.count,
                   "ms": round(e.device_time_total / 1e3, 3)}
                  for e in top[:10]],
        "densify_s": densify_s, "run_s": round(wall, 2),
        "busy_share_of_densify": round(device_ms / 1e3 / densify_s, 4),
        "busy_share_of_run": round(device_ms / 1e3 / wall, 4),
        "stage_s": artifact["stage_seconds"],
        "patches": artifact["patches"],
    }


def profile_dtu(device):
    """The `--profile-dtu` mode: one JSON line of `_profile_dtu`."""
    print(json.dumps(_profile_dtu(device)), flush=True)


def nm_compare(device):
    """The `--nm-compare` mode: the numbers the solver's host loop moves,
    in one JSON line, for the tree this script lies in (copy it into
    another checkout to run that tree's code; run the two in turns within
    one call): the sphere through the CLI warm (solver calls, distinct (B,
    k) shapes, iterations, host ms per iteration, stage seconds), its
    device-busy share under `torch.profiler`, one warm `expand_profile`
    round (`optimize_nm` against the round), DTU run a (stage seconds,
    peak allocation, solver calls, host ms per iteration) and its
    device-busy share, and `scripts.bench`'s e2e patches/s."""
    import importlib

    import torch

    from densepoints_tpu_torch.ops import simplex

    record = {"root": str(ROOT), "card": torch.cuda.get_device_name(0),
              "block_steps": simplex._BLOCK}
    _cli_on_sphere(device, SPHERE_SETTINGS)
    with _nm_recorded(step_times=True) as calls:
        pts, result, wall, launches, _ = _cli_on_sphere(device,
                                                        SPHERE_SETTINGS)
    record["sphere"] = {
        "cli_wall_s": round(wall, 4),
        "stage_s": {k: round(v, 4) for k, v in result.metrics.times.items()},
        "patches": len(pts), "median_radial_error": _radial_error(pts),
        "launches": launches, **_nm_counters(result.metrics),
        **_nm_summary(calls),
        "first_expand_step": _step_split(_first_expand(calls),
                                         simplex._BLOCK)}
    prof = _profile_sphere(device)
    record["profile_main"] = {k: prof[k] for k in (
        "busy_share_of_cli", "cli_wall_s", "device_ops")}

    program = importlib.import_module(
        "densepoints_tpu_torch.scripts.expand_profile")
    warm = program.run(program.parse_args(["--device", device]))["warm"]
    record["expand_profile_warm"] = {
        "optimize_nm_s": warm["optimize_nm"], "round_s": warm["TOTAL"],
        "optimize_nm_share": round(warm["optimize_nm"] / warm["TOTAL"], 4)}

    with _nm_recorded(step_times=True) as calls:
        artifact, k1, _, peak, _, _ = dtu_run("a", device)
    record["dtu_a"] = {
        "densify_s": artifact["densify_seconds"],
        "stage_s": artifact["stage_seconds"],
        "patches": artifact["patches"], "k1_launches": k1,
        "max_memory_allocated": peak,
        **{k: int(v) for k, v in artifact.get("counters", {}).items()
           if k.startswith("nm_")},
        **_nm_summary(calls),
        "largest_call_step": _step_split(
            max(calls, key=lambda call: call["B"]), simplex._BLOCK)}
    for label in ("b", "c", "d"):
        artifact, k1, _, _, _, _ = dtu_run(label, device)
        record[f"dtu_{label}"] = {
            "densify_s": artifact["densify_seconds"],
            "stage_s": artifact["stage_seconds"],
            "patches": artifact["patches"], "k1_launches": k1}
    prof = _profile_dtu(device)
    record["profile_dtu"] = {k: prof[k] for k in (
        "busy_share_of_densify", "densify_s", "device_ms", "device_ops",
        "allview_ncc")}

    program = importlib.import_module("densepoints_tpu_torch.scripts.bench")
    bench = program.run(program.parse_args(["--device", device]))
    record["bench_e2e_patches_per_sec"] = bench["e2e_patches_per_sec"]
    print(f"[nm-compare] {json.dumps(record)}", flush=True)


def nm_graph_only(device):
    """The `--nm-graph` mode: phase 10, then phase 16."""
    _, _, _, _, result = phase_main_path(device)
    phase_nm_graph(device, result)


KERNELS = (
    # name, source, TPU kernel it replaces, shape reported in the record
    ("allview_ncc", "densepoints_tpu_torch/csrc/allview_ncc.cu",
     "densepoints_tpu/ops/warp_ncc_paged.py:287", "refine_k11"),
    ("slot_ncc", "densepoints_tpu_torch/csrc/slot_ncc.cu",
     "densepoints_tpu/ops/warp_ncc.py:98", "refine_k11"),
    ("ncc_pairs", "densepoints_tpu_torch/csrc/ncc_pairs.cu",
     "densepoints_tpu/ops/ncc.py:36", "32768x121_maskless"),
    ("window_ncc", "densepoints_tpu_torch/csrc/window_ncc.cu",
     "scripts/kernel_ablate.py:25 and scripts/kernel_ablate.py:120",
     "script"),
    ("window_textures", "densepoints_tpu_torch/csrc/window_textures.cu",
     "scripts/kernel_paged_ablate.py:42", "expand_b4096_v50"),
    # The step kernels have no Pallas counterpart: XLA fuses the same work
    # of the JAX package's while_loop body and objective.
    ("nm_reflect", "densepoints_tpu_torch/csrc/nm_step.cu",
     "no Pallas kernel; XLA's fusion of densepoints_tpu/ops/simplex.py:55-62"
     " and densepoints_tpu/pmvs/optimize.py:319-321", "sphere_expand1"),
    ("nm_contract", "densepoints_tpu_torch/csrc/nm_step.cu",
     "no Pallas kernel; XLA's fusion of densepoints_tpu/ops/simplex.py:67-74"
     " and densepoints_tpu/pmvs/optimize.py:319-321 and :326-335",
     "sphere_expand1"),
    ("nm_accept", "densepoints_tpu_torch/csrc/nm_step.cu",
     "no Pallas kernel; XLA's fusion of densepoints_tpu/ops/simplex.py:81-103"
     ", :111-117 (the loop's predicate) and densepoints_tpu/pmvs/"
     "optimize.py:326-335", "sphere_expand1"),
    # M1 has no Pallas counterpart either: XLA runs the JAX package's
    # matching as a matrix product and a sort.
    ("hamming_topk", "densepoints_tpu_torch/csrc/hamming_topk.cu",
     "no Pallas kernel; XLA's dot_general (bf16) and lax.top_k of "
     "densepoints_tpu/features/matching.py:36-52", "dtu_8192"),
)


def time_allview(device):
    """The `--time-allview` mode: one JSON line of kernel-only times of the
    all-views kernel and the slot kernel, and of the whole entry point
    `allview_scores` at the refine k = 11 shape."""
    import torch

    from densepoints_tpu_torch.ops import allview_ncc, warp_ncc
    from densepoints_tpu_torch.ops.warp import compact_visible
    from densepoints_tpu_torch.pmvs.optimize import _anchor_chunks
    from densepoints_tpu_torch.scripts import _rigs, _timing

    out = {"root": str(ROOT), "card": torch.cuda.get_device_name(0)}

    def medians(label, fn):
        for _ in range(5):
            fn()
        out[label] = [round(_time_ms(fn, 50, KERNEL_BATCH), 4)
                      for _ in range(3)]

    def host_medians(label, fn):
        """Host milliseconds until the call returns (its launches queued)."""
        out[label] = []
        for _ in range(3):
            times = []
            for _ in range(50):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
            out[label].append(round(sorted(times)[25], 4))

    def run(label, slots, wrapper, cams, images, pos, nrm, ref, vis, k):
        kargs = _kernel_args(allview_ncc.allview_scores_cuda, cams, images,
                             pos, nrm, ref, k, vis=vis)
        medians(f"{label}_ms",
                lambda: allview_ncc.allview_scores_cuda(*kargs))
        if slots is not None:
            ids, ok = slots(vis)
            sargs = _kernel_args(warp_ncc.slot_scores_cuda, cams, images, pos,
                                 nrm, ref, k, view_ids=ids.to(torch.int32),
                                 ok=ok)
            medians(f"slot_{label}_ms",
                    lambda: warp_ncc.slot_scores_cuda(*sargs))
        if wrapper:
            args = (images, cams, pos, nrm, ref, vis, k)
            # One call between the events, as a caller makes it.
            fn = lambda: allview_ncc.allview_scores(*args)  # noqa: E731
            out[f"wrapper_{label}_ms"] = [round(_time_ms(fn, 50), 4)
                                          for _ in range(3)]
            host_medians(f"wrapper_host_{label}_ms",
                         lambda: allview_ncc.allview_scores(*args))

    refine = _rigs.refine_inputs(device)
    run("refine_k11", lambda vis: compact_visible(vis, 8), True, *refine, 11)
    run("refine_k16", None, False, *refine, 16)
    del refine
    dtu = _rigs.dtu_inputs(device)
    run("dtu_k16", lambda vis: _anchor_chunks(vis, 16)[0], False, *dtu, 16)
    cams, images, pos, nrm, ref, vis = dtu
    run("dtu_k16_b512", lambda vis: _anchor_chunks(vis, 16)[0], False, cams,
        images, pos[:512], nrm[:512], ref[:512], vis[:512], 16)
    del dtu, cams, images, pos, nrm, ref, vis
    torch.cuda.empty_cache()
    # K1 past 254 views, beside its bound; a tree whose kernel refuses the
    # shape records the refusal.
    for V, B, k in ((312, 4096, 11), (312, 4096, 16), (1100, 256, 11)):
        label = f"v{V}_b{B}_k{k}"
        cams, images, pos, nrm, ref, vis = awkward_rig(device, V, B, k)
        try:
            got = allview_ncc.allview_scores(images, cams, pos, nrm, ref, vis,
                                             k)
        except ValueError as exc:
            out[f"{label}_ms"] = f"refused: {exc}"
            continue
        run(label, None, False, cams, images, pos, nrm, ref, vis, k)
        out[f"{label}_bound_ms"] = list(_timing.bound(*_timing.allview_counts(
            images, cams, pos, nrm, ref, vis, got, k)))
        del cams, images, pos, nrm, ref, vis, got
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def dump_scores(device, path):
    """The `--dump-scores FILE` mode: K1's (scores, anchor, anchor_ok) and
    K2's scores at the refine shape (k = 11 and 16), the DTU shape (k = 16,
    K2 on its four chunks) and the awkward shapes of at most 254 views
    (K2 on their slot tables), saved to FILE with `torch.save`, so that two
    checkouts' kernels can be held equal bitwise (`--compare-scores`)."""
    import torch

    from densepoints_tpu_torch.ops import allview_ncc, warp_ncc
    from densepoints_tpu_torch.ops.warp import compact_visible
    from densepoints_tpu_torch.pmvs.optimize import _anchor_chunks
    from densepoints_tpu_torch.scripts import _rigs

    out = {}

    def save(label, cams, images, pos, nrm, ref, vis, k, tables):
        got = allview_ncc.allview_scores(images, cams, pos, nrm, ref, vis, k)
        for name, t in zip(("scores", "anchor", "anchor_ok"), got):
            out[f"allview {label} {name}"] = t.cpu()
        for name, (ids, ok) in tables.items():
            out[f"slot {label} {name}"] = warp_ncc.slot_scores(
                images, cams, pos, nrm, ref, ids, ok, k).cpu()

    refine = _rigs.refine_inputs(device)
    for k in (11, 16):
        save(f"refine k={k}", *refine, k,
             {"M=8": compact_visible(refine[5], 8)})
    del refine
    dtu = _rigs.dtu_inputs(device)
    save("dtu k=16", *dtu, 16,
         {f"chunk {c}": t for c, t in enumerate(_anchor_chunks(dtu[5], 16))})
    del dtu
    torch.cuda.empty_cache()
    for V, B, k in AWKWARD_SHAPES:
        rig = awkward_rig(device, V, B, k)
        tables = {"M=16": compact_visible(rig[5], 16)}
        if V == 8:
            tables["M=1"] = compact_visible(rig[5], 1)
        save(f"V={V} B={B} k={k}", *rig, k, tables)
    torch.save(out, path)
    print(json.dumps({"root": str(ROOT), "dumped": len(out),
                      "path": str(path)}), flush=True)


def compare_scores(first, second):
    """The `--compare-scores A B` mode: the outputs two `--dump-scores`
    runs saved, held equal key by key with `torch.equal`; fails unless
    both hold the same keys and every pair is equal."""
    import torch

    a, b = torch.load(first), torch.load(second)
    differ = sorted(k for k in a.keys() & b.keys()
                    if not torch.equal(a[k], b[k]))
    print(json.dumps({"keys": len(a), "equal": len(a) - len(differ),
                      "differ": differ,
                      "missing": sorted(a.keys() ^ b.keys())}), flush=True)
    check(a.keys() == b.keys(), "the two dumps hold different outputs")
    check(not differ, f"outputs differ: {differ}")


def _profile_sphere(device):
    """The CLI on the sphere scene once to warm up, then once under
    `torch.profiler`; a record of the device ops of that run (count and
    milliseconds, the scoring kernel and the batched matmuls apart), its
    launches, the device-busy share of the CLI's wall, stage seconds,
    patches and radial error."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _cli_on_sphere(device, SPHERE_SETTINGS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pts, result, wall, launches, plain = _cli_on_sphere(
            device, SPHERE_SETTINGS)
        torch.cuda.synchronize()
    metrics = result.metrics
    groups = {"all": [0, 0.0], "allview_ncc_kernel": [0, 0.0],
              "nm_step_kernels": [0, 0.0], "bmm_or_gemm": [0, 0.0]}
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        keys = ["all"]
        if "allview_ncc_kernel" in event.key:
            keys.append("allview_ncc_kernel")
        elif any(f"{name}_kernel" in event.key for name in NM_KERNELS):
            keys.append("nm_step_kernels")
        elif "gemm" in event.key.lower() or "bmm" in event.key.lower():
            keys.append("bmm_or_gemm")
        for key in keys:
            groups[key][0] += event.count
            groups[key][1] += event.device_time_total / 1e3
    return {
        "root": str(ROOT), "card": torch.cuda.get_device_name(0),
        "device_ops": {k: {"count": c, "ms": round(ms, 3)}
                       for k, (c, ms) in groups.items()},
        "allview_ncc_launches": launches["allview_ncc"],
        "plain_calls": sum(plain.values()),
        "cli_wall_s": round(wall, 3),
        "busy_share_of_cli": round(groups["all"][1] / 1e3 / wall, 4),
        "stage_s": {k: round(v, 3) for k, v in metrics.times.items()},
        "nm_counters": _nm_counters(metrics),
        "patches": len(pts), "median_radial_error": _radial_error(pts),
    }


def profile_main(device):
    """The `--profile-main` mode: one JSON line of `_profile_sphere`."""
    print(json.dumps(_profile_sphere(device)), flush=True)


# The block sizes of the `[nm-graph]` table (steps per captured graph),
# each the median of NM_REPEATS runs of the sphere.
NM_BLOCKS = (1, 2, 4, 8)
NM_REPEATS = 3


def _nm_counters(metrics):
    """The solver's counters of one run (absent in trees before the graph
    path: then empty)."""
    return {k: int(v) for k, v in metrics.counters.items()
            if k.startswith("nm_")}


class _TimedGraph:
    """A captured graph whose replays are timed, in the solver call that
    replays it (the newest of `calls`: a graph kept across calls,
    `ops.simplex._Solve`, is replayed by later ones): the device's
    milliseconds between two CUDA events around each replay, and the
    host's from one replay's start to the next (the enqueue, the counters
    and the exit read in between: a step's host time when a block is one
    step). `finish` turns a call's events into times."""

    def __init__(self, graph, calls):
        self.graph, self.calls = graph, calls

    def pool(self):
        return self.graph.pool()

    def replay(self):
        import torch

        call = self.calls[-1]
        now = time.perf_counter()
        host = call.setdefault("replay_host_ms", [])
        if call.get("_t") is not None:
            host.append(1e3 * (now - call["_t"]))
        call["_t"] = now
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        call.setdefault("_events", []).append((start, end))

    @staticmethod
    def finish(call):
        """After the call, synchronised: its replays' device times."""
        call.pop("_t", None)
        events = call.pop("_events", [])
        if events:
            call["replay_device_ms"] = [s.elapsed_time(e) for s, e in events]


@contextlib.contextmanager
def _nm_recorded(torch_step=False, keep_inputs=False, step_times=False,
                 **solver_kwargs):
    """Within, every Nelder-Mead call of `pmvs.optimize` is timed between
    two device synchronisations; yields the list of its calls, each {"B",
    "k" (texture size), "max_iterations", "s", "capture_s" (the graph's
    capture, within "s"), "iterations" (the most any lane ran: the
    iterations of a per-iteration loop)}. `torch_step` hands the solver
    the objective as a plain callable, so it steps with the torch step
    (`ops.simplex._step`) and not the step kernels; `keep_inputs` keeps
    each call's (objective, x0, arguments) as "inputs"; `step_times` times
    each replay (`_TimedGraph`: "replay_device_ms", "replay_host_ms").
    `solver_kwargs` go to the solver: `_eager` (the eager witness on the
    card) and `_block_steps` (steps per block), its private arguments."""
    import torch

    from densepoints_tpu_torch.pmvs import optimize

    from densepoints_tpu_torch.ops import simplex

    calls, k = [], [None]
    solver, once = optimize.nelder_mead, optimize.optimize_patches_once
    capture = getattr(simplex, "_capture", None)  # absent before graphs
    nm = _nm_step()

    def timed_capture(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = capture(*args)
        torch.cuda.synchronize()
        calls[-1]["capture_s"] = time.perf_counter() - t0
        if step_times:
            graph, flag, recorded = out
            out = (_TimedGraph(graph, calls), flag, recorded)
        return out

    def once_k(images, cameras, state, texture_size, config, mesh=None):
        k[0] = texture_size
        return once(images, cameras, state, texture_size, config, mesh=mesh)

    def timed(f, x0, *args, **kwargs):
        calls.append({"B": x0.shape[0], "k": k[0], "capture_s": 0.0,
                      "max_iterations": kwargs.get("max_iterations")})
        if keep_inputs:
            calls[-1]["inputs"] = (f, x0, args, kwargs)
        if torch_step and nm is not None and isinstance(f, nm.StepObjective):
            f = (lambda objective: lambda params: objective(params))(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver(f, x0, *args, **kwargs, **solver_kwargs)
        torch.cuda.synchronize()
        calls[-1].update(s=time.perf_counter() - t0,
                         iterations=int(out[2].max()) if len(x0) else 0)
        _TimedGraph.finish(calls[-1])
        return out

    optimize.nelder_mead, optimize.optimize_patches_once = timed, once_k
    if capture is not None:
        simplex._capture = timed_capture
    try:
        yield calls
    finally:
        optimize.nelder_mead, optimize.optimize_patches_once = solver, once
        if capture is not None:
            simplex._capture = capture


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def _step_split(call, m=1):
    """One solver call's step, device against host: medians over its
    replays of the device ms (CUDA events around a replay) and of the
    host's ms from one replay to the next, each over the m steps of a
    block."""
    device = call.get("replay_device_ms", [])
    host = call.get("replay_host_ms", [])
    return {"B": call["B"], "k": call["k"],
            "max_iterations": call["max_iterations"], "replays": len(device),
            "device_ms_per_step": (round(_median(device) / m, 5)
                                   if device else None),
            "host_ms_per_step": (round(_median(host) / m, 5)
                                 if host else None)}


def _nm_summary(calls):
    """Calls, distinct (B, k) shapes, iterations and host seconds of the
    solver over one run; host ms per iteration."""
    iters = sorted(c["iterations"] for c in calls)
    total = sum(iters)
    seconds = sum(c["s"] for c in calls)
    return {
        "calls": len(calls),
        "distinct_shapes": len({(c["B"], c["k"]) for c in calls}),
        "batch_sizes": sorted({c["B"] for c in calls}),
        "iterations": total,
        "iterations_per_call_min_median_max": (
            [iters[0], iters[len(iters) // 2], iters[-1]] if iters else []),
        "nm_s": round(seconds, 4),
        "capture_s": round(sum(c["capture_s"] for c in calls), 4),
        "host_ms_per_iteration": (round(1e3 * seconds / total, 4)
                                  if total else None),
    }


def _cloud(result):
    return {key: getattr(result.patches, key).cpu().numpy()
            for key in ("position", "normal", "vis")}


def _nm_line(label, result, launches, wall, calls, extra=None):
    row = {"cli_wall_s": round(wall, 3),
           "stage_s": {k: round(result.metrics.times[k], 4)
                       for k in ("seed_optimize", "expand")},
           "k1_launches": launches["allview_ncc"],
           **{name: launches[name] for name in NM_KERNELS
              if name in launches},
           **_nm_counters(result.metrics), **_nm_summary(calls),
           **(extra or {})}
    print(f"[nm-graph] {label}: {json.dumps(row)}", flush=True)
    return row


# Step kernels vs their plain twins on the same inputs: sorts, branch
# picks, `done`, `iters`, the step and the flag exactly; f32 values within
# NM_F32_RTOL, relative above magnitude 1 (DTU positions lie ~700 mm from
# the origin, where an f32 ulp is 6e-5). The twins sum the payload views
# and rotate the normal in another order, so a branch test whose operands
# lie within NM_NEAR of each other may go either way: such lanes are
# counted as branched apart, and compared no further in that step.
NM_F32_RTOL = 1e-6
NM_NEAR = 1e-6


def _rel_err(got, want):
    """Largest |got - want|, relative where |want| > 1 (0 if empty)."""
    if not want.numel():
        return 0.0
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def _nm_counts(name, B, V, P):
    """(bytes, f32 operations) a step kernel's function needs for B lanes
    of V views with P payload entries in all: each input it needs read
    once, each output written once; of the grid only the payload views'
    scores. Per lane: nm_reflect reads the 4 vertices and f-values and the
    pose (100 B) and writes the sorted ones, the centroid, x_r and its pose
    (112 B), with 56 operations (5 comparisons, 18 for the centroid and
    x_r, 33 for the pose, a cosine or sine counted as one); nm_contract
    reads the payload flags, the count, the worst vertex, two f-values,
    the centroid, x_r and the pose (88 B) and writes f_r, x_2 and its pose
    (40 B), with 2 operations per payload score and 45; nm_accept reads the
    flags, the count, the 4 f-values, done, iters, x_r, f_r and x_2 (57 B)
    and writes the worst vertex, its f-value, done and iters (21 B), with 2
    per payload score and 14, and once the step (16 B) and the flag."""
    lane, ops = {"nm_reflect": (212, 56), "nm_contract": (V + 128, 45),
                 "nm_accept": (V + 78, 14)}[name]
    scores = 0 if name == "nm_reflect" else P
    extra = 17 if name == "nm_accept" else 0
    return B * lane + 4 * scores + extra, B * ops + 2 * scores


def _nm_kernel_check(label, inputs):
    """The three step kernels against their plain twins along one solver
    call's trajectory on the card. From the call's initial simplex each
    step runs every twin and every kernel on the same inputs (a kernel's
    inputs are its twins' outputs before it), compares them, and goes on
    from the kernels' state, to the call's cap or until every lane is done;
    then each kernel's time back to back and its twin's, at the initial
    simplex, beside the bound. Returns ({kernel: record}, lanes that
    branched apart, steps)."""
    import torch

    from densepoints_tpu_torch.scripts import _timing

    nm = _nm_step()
    f, x0, args, kwargs = inputs
    init_step = args[0]
    max_iterations, tolerance = kwargs["max_iterations"], kwargs["tolerance"]
    B, D = x0.shape
    V = f.vis.shape[1]
    dev = x0.device
    offsets = torch.cat([x0.new_zeros((1, D)), torch.diag(init_step.to(x0))])
    verts = (x0[:, None, :] + offsets[None]).contiguous()
    start = (verts, f(verts), torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev))
    pose = tuple(t.contiguous() for t in (f.position0, f.normal0, f.C_ref))
    payload, n_payload = f.payload.contiguous(), f.n_payload.contiguous()
    limits = (max_iterations, tolerance)

    def score(pos, nrm):
        return f.score(pos, nrm, f.ref, f.vis)[0]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def reflect(verts, fvals):
        out = [verts.clone(), fvals.clone()] + [empty(B, 3) for _ in range(4)]
        return out, lambda: nm.nm_reflect(*out[:2], *pose, *out[2:])

    def contract(scores, sv, sf, c, xr):
        out = [empty(B)] + [empty(B, 3) for _ in range(3)]
        return out, lambda: nm.nm_contract(scores, payload, n_payload, sv,
                                           sf, c, xr, *pose, *out)

    def accept(scores, state, xr, f_r, x_2):
        out = [t.clone() for t in state] + [
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev)]
        return out, lambda: nm.nm_accept(scores, payload, n_payload,
                                         *out[:5], xr, f_r, x_2, *limits,
                                         *out[5:])

    def fail(what):
        raise SmokeFailure(f"[nm-step] {label} step {steps}: {what}")

    errs = {}  # "kernel.output" -> the largest error over the steps

    def note(name, outputs, gots, wants):
        for output, got, want in zip(outputs.split(), gots, wants):
            key = f"{name}.{output}"
            errs[key] = max(errs.get(key, 0.0), _rel_err(got, want))

    apart = steps = 0
    state = start
    for steps in range(1, max_iterations + 1):
        want = nm.nm_reflect_plain(*state[:2], *pose)
        got, launch = reflect(*state[:2])
        launch()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail("nm_reflect sorted otherwise than its twin")
        # The pose against the twin's pose of the kernel's own x_r: an ulp
        # of x_r at a large angle moves cos and sin by as much.
        note("nm_reflect", "centroid x_r position normal", got[2:],
             (*want[2:4], *nm._pose(got[3], *pose)))
        sv, sf, c, xr, pos, nrm = want
        scores = score(pos, nrm)
        wc = nm.nm_contract_plain(scores, payload, n_payload, sv, sf, c, xr,
                                  *pose)
        gc, launch = contract(scores, sv, sf, c, xr)
        launch()
        f_r = wc[0]
        note("nm_contract", "f_r", gc[:1], wc[:1])
        split = torch.zeros(B, dtype=torch.bool, device=dev)
        for threshold in (sf[:, 0], sf[:, -1]):  # expansion, outside
            differ = (gc[0] < threshold) != (f_r < threshold)
            if bool((differ & ((f_r - threshold).abs() >= NM_NEAR)).any()):
                fail("nm_contract picked another branch than its twin")
            split |= differ
        note("nm_contract", "x_2 position normal",
             (g[~split] for g in gc[1:]),
             (w[~split] for w in (wc[1], *nm._pose(gc[1], *pose))))
        scores = score(wc[2], wc[3])
        wa = nm.nm_accept_plain(scores, payload, n_payload, sv, sf,
                                *state[2:], xr, f_r, wc[1], *limits)
        ga, launch = accept(scores, (sv, sf, *state[2:]), xr, f_r, wc[1])
        launch()
        f_2 = nm._cost(scores, payload, n_payload)
        use_2 = torch.where(f_r < sf[:, 0], f_2 < f_r,
                            (f_r >= sf[:, -2]) & (f_2 < f_r))
        f_new = torch.where(use_2, f_2, f_r)
        spread = wa[1].max(dim=1).values - wa[1].min(dim=1).values
        near = (((f_2 - f_r).abs() < NM_NEAR)
                | ((f_new - sf[:, -1]).abs() < NM_NEAR)
                | ((spread - tolerance).abs() < NM_NEAR))
        if not (torch.equal(ga[3], wa[3]) and torch.equal(ga[4], wa[4])):
            fail("nm_accept's iters or step differ from its twin's")
        if not torch.equal(ga[2][~near], wa[2][~near]):
            fail("nm_accept's done differs from its twin's")
        if bool(ga[6].any()):
            fail("nm_accept left its counters set")
        done_apart = ga[2] != wa[2]
        if not bool(done_apart.any()) and not torch.equal(ga[5], wa[5]):
            fail("nm_accept's exit flag differs from its twin's")
        note("nm_accept", "verts fvals", (g[~near] for g in ga[:2]),
             (w[~near] for w in wa[:2]))
        moved = (ga[0] != wa[0]).flatten(1).any(1) | done_apart
        apart += int((split | (near & moved)).sum())
        state = tuple(ga[:5])
        if bool(ga[5]):
            break
    err = {name: max(e for key, e in errs.items()
                     if key.startswith(name + "."))
           for name in NM_KERNELS}
    print(f"[nm-step] {label}: largest error by output over {steps} steps "
          f"{json.dumps(errs)}", flush=True)
    for name, e in err.items():
        check(e <= NM_F32_RTOL, f"[nm-step] {label}: {name} {e:.3e} from its "
              f"twin (limit {NM_F32_RTOL:g})")

    # Times at the initial simplex: each kernel alone back to back (on
    # buffers of its own) and its twin call by call.
    verts, fvals = start[:2]
    sv, sf, c, xr, pos, nrm = nm.nm_reflect_plain(verts, fvals, *pose)
    scores_r = score(pos, nrm)
    wc = nm.nm_contract_plain(scores_r, payload, n_payload, sv, sf, c, xr,
                              *pose)
    scores_2 = score(wc[2], wc[3])
    runs = {
        "nm_reflect": (reflect(verts, fvals)[1],
                       lambda: nm.nm_reflect_plain(verts, fvals, *pose)),
        "nm_contract": (contract(scores_r, sv, sf, c, xr)[1],
                        lambda: nm.nm_contract_plain(
                            scores_r, payload, n_payload, sv, sf, c, xr,
                            *pose)),
        "nm_accept": (accept(scores_2, (sv, sf, *start[2:]), xr, wc[0],
                             wc[1])[1],
                      lambda: nm.nm_accept_plain(
                          scores_2, payload, n_payload, sv, sf, *start[2:],
                          xr, wc[0], wc[1], *limits)),
    }
    P = int(n_payload.sum())
    records = {}
    for name, (kernel, plain) in runs.items():
        ms = _time_runs({"kernel": kernel, "plain": plain})
        bound = _timing.bound(*_nm_counts(name, B, V, P))
        records[name] = dict(_result(err[name], ms, bound), B=B, V=V)
        print(f"[nm-step] {name} {label}: B={B} V={V} payload={P} "
              f"max_rel_err={err[name]:.3e} kernel_ms={ms['kernel']:.5f} "
              f"plain_ms={ms['plain']:.4f} bound_ms={bound[0]:.6f} "
              f"({bound[1]})", flush=True)
    print(f"[nm-step] {label}: {steps} steps of B={B} compared, {apart} "
          f"lane-steps branched apart (a test within {NM_NEAR:g} of its "
          "threshold)", flush=True)
    return records, apart, steps


def _first_expand(calls):
    """The sphere's first expansion call (the first of the expansion's
    iteration cap)."""
    cap = SPHERE_SETTINGS["expand"]["max_iterations"]
    return next(c for c in calls if c["max_iterations"] == cap)


def phase_nm_graph(device, main_result):
    """Phase 16 (after phase 10): Nelder-Mead as captured CUDA graphs of
    the step kernels (`ops.nm_step`: five launches a step, K1 twice).
    Phase 10's run captured and replayed graphs; the eager witness (the
    same kernel steps run eagerly) gives its cloud bitwise; so does every
    block size m of `NM_BLOCKS`, each a row of the table (CLI wall, stage
    seconds, K1 and step-kernel launches, captures, replays, steps, solver
    calls, distinct (B, k) shapes, iterations, host ms per iteration, and
    the first expansion call's step: device ms by CUDA events around a
    replay, host ms from one replay to the next); m = 1 launches K1
    exactly as often as the per-iteration loop (the witness at m = 1), the
    default m at most 2 (m - 1) more times per call. The torch step (the
    objective handed in as a plain callable) makes the same cloud within
    2% of the count and the radial error's gate, its K1 launches stated
    beside the kernel step's. The step kernels are held against their
    twins along the first expansion call's trajectory (`_nm_kernel_check`)
    and timed. Under `torch.profiler` the device runs as many K1 and step
    kernels as the counters say, each named. Returns the step kernels'
    records ({kernel: {"sphere_expand1": record}})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from densepoints_tpu_torch.ops import simplex

    main_counts = _nm_counters(main_result.metrics)
    print(f"[nm-graph] main path (phase 10, m = {simplex._BLOCK}): "
          f"{json.dumps(main_counts)}", flush=True)
    check(main_counts["nm_graph_captures"] > 0
          and main_counts["nm_graph_replays"] > 0,
          "[nm-graph] the main path captured or replayed no graph")
    want = _cloud(main_result)
    table, inputs = {}, None
    m = simplex._BLOCK
    runs = [("eager witness m=1", {"_eager": True, "_block_steps": 1})]
    if m != 1:
        runs.append(("eager witness", {"_eager": True}))
    runs += [(f"m={b}", {"_block_steps": b, "step_times": True})
             for b in NM_BLOCKS]
    runs.append(("torch step", {"torch_step": True, "step_times": True,
                                "_block_steps": 1}))
    for label, kwargs in runs:
        rows = []
        for _ in range(NM_REPEATS):
            keep = inputs is None and label == "m=1"
            with _nm_recorded(keep_inputs=keep, **kwargs) as calls:
                pts, result, wall, launches, _ = _cli_on_sphere(
                    device, SPHERE_SETTINGS)
            if label == "torch step":
                n, n_want = len(pts), len(want["position"])
                check(abs(n - n_want) <= 0.02 * n_want,
                      f"[nm-graph] the torch step made {n} patches, the "
                      f"kernel step {n_want}")
            else:
                _bitwise(f"[nm-graph] {label}", _cloud(result), want)
            split = ({"first_expand_step": _step_split(
                _first_expand(calls), kwargs.get("_block_steps", m))}
                if kwargs.get("step_times") else {})
            rows.append(_nm_line(label, result, launches, wall, calls,
                                 split))
            if keep:
                inputs = _first_expand(calls)["inputs"]
        rows.sort(key=lambda row: row["host_ms_per_iteration"])
        table[label] = dict(rows[len(rows) // 2], patches=len(pts),
                            median_radial_error=_radial_error(pts))
        spread = [row["host_ms_per_iteration"] for row in rows]
        print(f"[nm-graph] {label}: host ms per iteration min / median / "
              f"max {spread[0]} / {spread[len(spread) // 2]} / "
              f"{spread[-1]} over {NM_REPEATS} runs", flush=True)
    per_iteration = table["eager witness m=1"]
    check(table["m=1"]["k1_launches"] == per_iteration["k1_launches"],
          f"[nm-graph] m = 1 launched K1 {table['m=1']['k1_launches']} "
          f"times, the per-iteration loop {per_iteration['k1_launches']}")
    extra = table[f"m={m}"]["k1_launches"] - per_iteration["k1_launches"]
    limit = 2 * (m - 1) * per_iteration["calls"]
    print(f"[nm-graph] m = {m}: {extra} K1 launches over the per-iteration "
          f"loop's {per_iteration['k1_launches']} (limit {limit}: "
          f"{per_iteration['calls']} calls); {len(want['position'])} "
          f"patches, median radial error "
          f"{table[f'm={m}']['median_radial_error']:.7f}", flush=True)
    check(0 <= extra <= limit, f"[nm-graph] {extra} more K1 launches")
    for label in table:
        if label.startswith("m="):
            check(table[label]["nm_graph_captures"] > 0,
                  f"[nm-graph] {label} captured no graph")
    kernel, torch_step = table["m=1"], table["torch step"]
    check(torch_step["median_radial_error"] < 0.01 * SPHERE_RADIUS,
          f"[nm-graph] the torch step's radial error "
          f"{torch_step['median_radial_error']}")
    check(torch_step["nm_reflect"] == 0,
          "[nm-graph] the torch step launched step kernels")
    check(kernel["nm_reflect"] == kernel["nm_contract"]
          == kernel["nm_accept"] == kernel["nm_steps"] > 0,
          "[nm-graph] the kernel step did not launch each step kernel once "
          "a step")
    print(f"[nm-graph] kernel step against torch step (m = 1, medians): "
          f"patches {kernel['patches']} / {torch_step['patches']}, median "
          f"radial error {kernel['median_radial_error']:.7f} / "
          f"{torch_step['median_radial_error']:.7f}, K1 launches "
          f"{kernel['k1_launches']} / {torch_step['k1_launches']} (difference "
          f"{kernel['k1_launches'] - torch_step['k1_launches']}), first "
          f"expansion call's step {json.dumps(kernel['first_expand_step'])} "
          f"/ {json.dumps(torch_step['first_expand_step'])}", flush=True)
    records, apart, steps = _nm_kernel_check("sphere_expand1", inputs)
    del inputs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, result, _, launches, _ = _cli_on_sphere(device, SPHERE_SETTINGS)
        torch.cuda.synchronize()
    for name in ("allview_ncc", *NM_KERNELS):
        events = sum(e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and f"{name}_kernel" in e.key)
        print(f"[nm-graph] profiled: {name}_kernel named in {events} device "
              f"events; counter {launches[name]}", flush=True)
        check(events == launches[name] > 0,
              f"[nm-graph] the profile shows {events} {name} kernels, the "
              f"counter {launches[name]}")
    print(f"[nm-graph] profiled: {json.dumps(_nm_counters(result.metrics))}",
          flush=True)
    return {name: {"sphere_expand1": rec} for name, rec in records.items()}


def time_window(device):
    """The `--time-window` mode: one JSON line of kernel-only times of
    `full` of the two window kernels (three medians of 50 back-to-back
    timings): K4 at the ablation program's shape and the awkward one, K5 at
    both of its program's shapes and the awkward one."""
    import torch

    from densepoints_tpu_torch.ops import window_ncc, window_textures
    from densepoints_tpu_torch.scripts import (
        kernel_ablate,
        kernel_paged_ablate,
    )

    out = {"root": str(ROOT), "card": torch.cuda.get_device_name(0)}

    def medians(label, fn):
        for _ in range(5):
            fn()
        out[label] = [round(_time_ms(fn, 50, KERNEL_BATCH), 4)
                      for _ in range(3)]

    for label, inp in (("window_ncc_script_ms",
                        kernel_ablate.script_inputs(device)),
                       ("window_ncc_awkward_ms",
                        _window_ncc_awkward(device))):
        args = (inp["stack"], inp["row0"], inp["x0"], inp["xs"], inp["ys"],
                inp["n_real"], kernel_ablate.WIN_H, kernel_ablate.WIN_W)
        medians(label, lambda: window_ncc.window_scores_cuda(*args))
        del inp, args
    shapes = [(name, kernel_paged_ablate.script_inputs(device, n_slots, V, R,
                                                       k))
              for name, n_slots, V, R, k in kernel_paged_ablate.SHAPES]
    shapes.append(("awkward", _window_textures_awkward(device)))
    for name, inp in shapes:
        args = (inp["pages"], inp["page"], inp["row0"], inp["xs"], inp["ys"],
                inp["n_real"], kernel_paged_ablate.WIN_H)
        medians(f"window_textures_{name}_ms",
                lambda: window_textures.window_centered_textures_cuda(*args))
    print(json.dumps(out), flush=True)


def time_ncc(device):
    """The `--time-ncc` mode: one JSON line of kernel-only times of the
    row-wise NCC kernel at the two shapes of its path, maskless and masked
    (three medians of 50 back-to-back timings), each beside a rotated
    reading (the calls take turns over seeded input sets larger than twice
    the L2 cache together, so each call reads device memory) and its
    bound."""
    import torch

    from densepoints_tpu_torch.ops import ncc
    from densepoints_tpu_torch.scripts import _timing

    out = {"root": str(ROOT), "card": torch.cuda.get_device_name(0)}
    l2 = _timing.l2_bytes(device)

    def medians(fn):
        return [round(_time_ms(fn, 50, KERNEL_BATCH), 5) for _ in range(3)]

    for N, L in NCC_TIMED:
        for masked in (False, True):
            key = f"{N}x{L}_{'masked' if masked else 'maskless'}"
            first = _ncc_inputs(N, L, masked, device, seed=0)
            inputs = [t for t in first if t is not None]
            sets = [first] + [
                _ncc_inputs(N, L, masked, device, seed=s)
                for s in range(1, _timing.rotation(
                    _timing.nbytes(*inputs), l2))]
            got = ncc.ncc_pairs_cuda(*first)
            out[f"{key}_bound_ms"] = round(_timing.bound(
                _timing.nbytes(*inputs, got),
                N * L * NCC_ELEMENT_FLOPS[masked])[0],
                5)
            out[f"{key}_rotated_sets"] = len(sets)
            fns = [lambda s=s: ncc.ncc_pairs_cuda(*s) for s in sets]
            for fn in fns:
                fn()
            out[f"{key}_ms"] = medians(fns[0])
            out[f"{key}_rotated_ms"] = medians(fns)
            del first, inputs, sets, fns, got
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def _ptxas_resources(source):
    """Registers, stack and spills of every kernel in `source` as `nvcc
    -Xptxas -v` reports them for sm_90a, keyed by the kernel's name and
    template arguments."""
    import re
    import shutil

    from densepoints_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        proc = subprocess.run(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / "kernels.o"), str(source)],
            capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc failed: {proc.stderr}")
    found = {}
    for chunk in proc.stderr.split("Compiling entry function '")[1:]:
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads.*?Used (\d+) registers",
                      chunk, flags=re.S)
        check(m is not None, f"{source}: no resources in ptxas -v")
        stack, st, ld, regs = map(int, m.groups())
        found[chunk.split("'", 1)[0]] = {
            "registers": regs, "stack_bytes": stack,
            "spill_store_bytes": st, "spill_load_bytes": ld}
    check(len(found) > 0, f"{source}: no kernel in ptxas -v")
    names = list(found)
    filt = shutil.which("c++filt")
    if filt:
        demangled = subprocess.run([filt], input="\n".join(names),
                                   capture_output=True, text=True
                                   ).stdout.splitlines()
        if len(demangled) == len(names):
            # "void (anonymous namespace)::name<args>(params)" -> name<args>
            names = [re.search(r"\w+(<[^()]*>)?(?=\()", d).group(0)
                     for d in demangled]
    return dict(zip(names, found.values()))


def _spill_lines(source):
    """Where the local-memory spills of the kernel instances in `source`
    sit: compiled for sm_90a with line info, disassembled (`nvdisasm -g`),
    the spill stores and loads (STL, LDL) counted by source line, keyed
    `name<T>` by the first template argument."""
    import collections
    import re

    from densepoints_tpu_torch.ops import _build

    bin_dir = Path(_build._nvcc()).parent
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cubin = Path(tmp) / "kernels.cubin"
        proc = subprocess.run(
            [str(bin_dir / "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-lineinfo", "-cubin", "-o", str(cubin),
             str(source)], capture_output=True, text=True)
        check(proc.returncode == 0, f"nvcc failed: {proc.stderr}")
        proc = subprocess.run([str(bin_dir / "nvdisasm"), "-g", "-c",
                               str(cubin)], capture_output=True, text=True)
    check(proc.returncode == 0, f"nvdisasm failed: {proc.stderr}")
    counts = collections.defaultdict(collections.Counter)
    name, where = None, "?"
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*\.text\.\S*?\d([a-z_]+_kernel)ILi(-?\d+)E\S*:",
                     line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
            continue
        m = re.search(r'//## File "([^"]+)", line (\d+)', line)
        if m:
            where = f"{Path(m.group(1)).name}:{m.group(2)}"
            continue
        m = re.search(r"\b(STL|LDL)\b", line)
        if m and name:
            counts[name][f"{m.group(1)} {where}"] += 1
    return {k: dict(v.most_common()) for k, v in counts.items()}


def _library_sass():
    """Instruction count and a digest of the SASS (addresses and encodings
    left out) of every function in the library the package built, keyed by
    its mangled name with the hash of its anonymous namespace taken out
    (the hash differs from build to build) (`cuobjdump -sass`)."""
    import hashlib
    import re

    from densepoints_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.build_library())],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr}")
    code, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_", m.group(1))
            code[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            code[name].append(m.group(1))
    check(len(code) > 0, "cuobjdump -sass: no function in the library")
    return {name: {"instructions": len(lines), "sha256": hashlib.sha256(
        "\n".join(lines).encode()).hexdigest()[:16]}
        for name, lines in code.items()}


def kernel_resources(device):
    """The `--kernel-resources` mode: registers, spills and stack of every
    kernel instance of the warp + NCC kernels, the row-wise NCC kernel and
    the two window kernels, the source lines of the warp + NCC kernels'
    spills, and the SASS digest of every function of the built library,
    one JSON line. Fails if an instance of the row-wise NCC kernel
    spills."""
    out = {"root": str(ROOT)}
    for name in ("allview_ncc", "slot_ncc", "ncc_pairs", "window_ncc",
                 "window_textures"):
        out[name] = _ptxas_resources(
            ROOT / "densepoints_tpu_torch" / "csrc" / f"{name}.cu")
    spills = [k for k, v in out["ncc_pairs"].items()
              if v["spill_store_bytes"] or v["spill_load_bytes"]]
    check(not spills, f"row-wise NCC instances spill: {spills}")
    out["spill_lines"] = {
        name: _spill_lines(
            ROOT / "densepoints_tpu_torch" / "csrc" / f"{name}.cu")
        for name in ("allview_ncc", "slot_ncc")}
    out["sass"] = _library_sass()
    print(json.dumps(out), flush=True)


def parallel_only(device):
    """The `--parallel` mode: the main path (phase 10), then phase 12, with
    the single-rank BA of the turned calibration computed here in place of
    phase 11's CLI run."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        turned = write_sphere_scene(Path(tmp), turn=0.002)
        ba_turned = _ba_rmse(turned, _with_settings(ba={"enable": True}),
                             device)
    _, _, _, main_patches, _ = phase_main_path(device)
    launches = phase_parallel(device, main_patches, ba_turned)
    print(json.dumps({"allview_ncc_launches_parallel": launches}),
          flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-rank":
        try:
            return parallel_rank(sys.argv[2])
        except SmokeFailure as exc:
            print(f"FAIL: {exc}", flush=True)
            return 1
    modes = {"--time-allview": time_allview, "--time-window": time_window,
             "--time-ncc": time_ncc, "--profile-main": profile_main,
             "--kernel-resources": kernel_resources,
             "--parallel": parallel_only, "--dtu": dtu_only,
             "--measure": measure_only, "--bench": bench_only,
             "--cards": cards_only,
             "--profile-dtu": profile_dtu, "--nm-compare": nm_compare,
             "--nm-graph": nm_graph_only}
    if len(sys.argv) == 4 and sys.argv[1] == "--compare-scores":
        try:
            compare_scores(Path(sys.argv[2]), Path(sys.argv[3]))
        except SmokeFailure as exc:
            print(f"FAIL: {exc}", flush=True)
            return 1
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--dump-scores":
        path = Path(sys.argv[2])
        modes[sys.argv[1]] = lambda device: dump_scores(device, path)
        del sys.argv[2]
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        try:
            phase_device()
            phase_build()
            modes[sys.argv[1]]("cuda")
        except SmokeFailure as exc:
            print(f"FAIL: {exc}", flush=True)
            return 1
        return 0
    if sys.argv[1:]:
        print(f"unknown arguments {sys.argv[1:]}", flush=True)
        return 2
    try:
        name, smi_line = phase_device()
        phase_build()
        results = phase_kernels("cuda")
        launches = phase_slice_path("cuda")
        ablation = phase_ablation_path()
        for name in ("window_ncc", "window_textures"):
            launches[name] = ablation[name]
        # The all-views kernel's own path is the CLI run; the slot and
        # row-wise kernels are counted on the slot-scoring path, the two
        # window kernels on the ablation path above.
        phase_seed_variants("cuda")
        (main_launches, main_times, main_pts,
         main_patches, main_result) = phase_main_path("cuda")
        for name in ("allview_ncc", *NM_KERNELS, "hamming_topk"):
            launches[name] = main_launches[name]
        results.update(phase_nm_graph("cuda", main_result))
        ba_turned = phase_rest_of_pipeline("cuda", main_pts, main_times,
                                           main_patches)
        parallel = phase_parallel("cuda", main_patches, ba_turned)
        dtu = phase_dtu("cuda", results)
        phase_measure("cuda")
        bench = phase_bench("cuda")
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    import torch

    record = []
    for kernel, source, replaces, shape in KERNELS:
        check((ROOT / source).exists(), f"{source} is missing")
        shown = results[kernel][shape]
        record.append({
            "name": kernel,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"]
                               for r in results[kernel].values()),
            "ms": shown["ms"],
            "plain_ms": shown["plain_ms"],
            "bound_ms": shown["bound_ms"],
            "bound_by": shown["bound_by"],
            # Phase 12's runs, every rank's own count (K1 alone).
            # Phase 13's runs a, b and c (K1 alone).
            # Phase 15's bench run and entry() (K1 alone).
            **({"launches_parallel": parallel, "launches_dtu": dtu,
                "launches_bench": bench["bench"],
                "launches_entry": bench["entry"]}
               if kernel == "allview_ncc" else {}),
            # No single PyTorch call computes a projective warp + NCC, a
            # clamped row-wise NCC, window-relative sampling with zeros
            # outside the window (`grid_sample` clamps or pads by image,
            # takes no per-slot window and no NCC), or a Nelder-Mead step.
            # M1's plain version is the library's chain (cuBLAS's GEMM,
            # `torch.topk`).
            "library_ms": (shown["plain_ms"] if kernel == "hamming_topk"
                           else None),
        })
    print(smi_line, flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
