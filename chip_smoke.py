#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`densepoints_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-allview
    python3 chip_smoke.py --time-window
    python3 chip_smoke.py --time-ncc
    python3 chip_smoke.py --profile-main
    python3 chip_smoke.py --kernel-resources
    python3 chip_smoke.py --dtu
    python3 chip_smoke.py --profile-dtu

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
     0 and 1), and a profile showing that the entry point runs one device
     kernel and nothing before it;
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
     shapes too, with a table of one slot and view ids outside the stack;
  6. window kernels vs plain: `ops.window_ncc` (`full`, `staged`, `block`,
     and the gradient form against its own plain version) and
     `ops.window_textures` (`full`, `staged`, `block`) at the shapes of the
     two ablation programs and at one awkward shape each (a patch count
     that is no multiple of 8, k = 16, taps outside the window, windows
     over the stack's edges, dead slots), then at n = 1, 32, 33, 121, 256
     and 300 texels (each texels-per-lane layout of the warp bodies and the
     strided one) and at n = 121 in coordinate rows of 123 floats (the
     scalar coordinate loads): scores within 1e-4, textures within 1e-3
     grey levels, dead slots exactly zero;
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
     launch counter set to 0 just before; checks the counters, the PLY, the
     patch count and the radial error against the analytic sphere;
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
     a's; c, `densify_clustered` on shared seeds on 1 and 2 ranks holding
     every view (count exact, positions within 5e-3), and the CLI's
     `--partition clustered --halo-threshold 0.5` on 2 ranks, each holding
     fewer image bytes than the stack; d, `run_ba_sharded` on 2 ranks on
     the turned calibration, its RMSE within twice the single-rank
     solver's spread over 5 orders of its sums (at least 1e-3 px) of the
     single rank's. Each `[parallel]` line gives the rank's backend, K1
     launches, patches, radial error, stage seconds and the traffic of
     its collectives. `--parallel` runs phases 10 and 12 alone;
  13. the three end-to-end programs of `densepoints_tpu_torch.scripts`
     through their `run`, each with every counter at 0 just before, at
     the configurations of the JAX package's records (`[dtu]`): a,
     `dtu_scale_run` at `DTU_r05.json`'s (49 views of 1600 x 1200, kp
     8192, 6 per cell, 120 / 40 Nelder-Mead iterations, 25 score views,
     grid_scale 8, 20 rounds; no depth cut); b, `dtu_layout_run` and c,
     `occlusion_run` at their defaults (21 views of 800 x 600 through the
     on-disk DTU tree, with nuisances). Each run prints its render,
     stage and densify seconds, counts, K1 launches and plain calls, peak
     allocation and quality, and its counts beside the JAX record's; it
     fails if a stage raises, K1 is never launched, a plain scoring call
     is made, or a quality gate set from the JAX record is missed (a:
     exact median under one pixel footprint, 650 / 2900 mm, completeness
     under 2 mm >= 0.95, >= 10,000 patches; b: exact median under 0.5 mm,
     >= 1,500 patches; c: the occlusion filter's kept patches' median
     distance to the surface union under 2 mm). `--dtu` runs phase 13
     alone; `--profile-dtu` runs a under `torch.profiler` (key averages,
     no trace file) and prints its device ops, device time, K1's time and
     launches, the ten costliest kernels and the device-busy share of
     `densify`'s wall.
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
chunk (16 slots), and the entry point `allview_scores` at the refine k = 11
shape (`wrapper_refine_k11_ms` by CUDA events, `wrapper_host_refine_k11_ms`
on the host's clock until the call returns). It takes the package
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
`--profile-main` runs the CLI on the sphere scene under `torch.profiler`
and prints one JSON line of its device ops, launches and stage seconds.
`--kernel-resources` prints the registers, stack and spills `ptxas`
reports for every kernel instance of the two warp + NCC kernels, the
row-wise NCC kernel (none of whose instances may spill) and the two window
kernels, and the instruction count and a digest of the SASS of every
function in the library the package built: run in two checkouts, or in one
with another `ops/_build.py`, it says whether two builds made the same code.
"""
from __future__ import annotations

import json
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
# f32 operations the function needs for one warped texel, whatever a kernel
# body spends: the projection is affine in the texel's (column, row) before
# the division, h = A + c B + r C with A, B, C fixed per (patch, view), so
# 6 fused multiply-adds (12) and 2 divisions (14 in all); clamps and floors
# 10; bilinear weights and taps 15; mean / variance / covariance sums 8.
TEXEL_FLOPS = 47
# Per texture, A, B and C: three 3 x 3 products with the view's K R (45),
# one subtraction of the centre (3) and two scalings by 2 / k (6).
TEXTURE_FLOPS = 54
# Per patch, the frame (sx, sy): a cross product (9), p + x_axis (3), two
# decomposed projections of 35 (3 subtractions, two 3 x 3 products, 2
# divisions), their difference and its norm (6), the clamp and the division
# of the scale (2) and two scalings (6).
PATCH_FLOPS = 96
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


def _nbytes(*tensors):
    from densepoints_tpu_torch.scripts import _timing

    return _timing.nbytes(*tensors)


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take
    (`scripts._timing.bound`)."""
    from densepoints_tpu_torch.scripts import _timing

    return _timing.bound(nbytes, flops)


def _warp_bound(images, others, patches, textures, k):
    """Bound of a warp+NCC function that framed `patches` patches and
    sampled `textures` k x k textures: of the image stack it must read no
    more than 4 f32 taps per texel, and no more than the stack once;
    `others` are the remaining inputs (cameras, position, normal, reference
    view, visibility or slots) and the outputs, moved once each."""
    image_bytes = min(_nbytes(images), textures * k * k * 4 * 4)
    flops = (patches * PATCH_FLOPS
             + textures * (k * k * TEXEL_FLOPS + TEXTURE_FLOPS))
    return _bound(image_bytes + _nbytes(*others), flops)


def _result(err, ms, bound):
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound[0], "bound_by": bound[1]}


def _look_at(C):
    import numpy as np

    z = -C / np.linalg.norm(C)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _cameras(Cs, focal, W, H, device):
    import numpy as np

    from densepoints_tpu_torch.core.cameras import Cameras

    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    P = []
    for C in Cs:
        R = _look_at(C)
        P.append(K @ np.concatenate([R, (-R @ C)[:, None]], 1))
    return Cameras.from_projection_matrices(np.stack(P), W, H, device=device)


def refine_inputs(device):
    """bench.py's refine shape + mixed, no-visibility and off-frustum rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    V, H, W, B = 8, 480, 640, 4096
    Cs = []
    for i in range(V):
        ang = (i - (V - 1) / 2) * 0.12
        Cs.append(np.array([6.0 * np.sin(ang), 0.2 * np.sin(2 * i),
                            -6.0 * np.cos(ang)]))
    cams = _cameras(Cs, 500.0, W, H, device)
    images = rng.uniform(0, 255, (V, H, W)).astype(np.float32)
    xy = rng.uniform(-1.0, 1.0, (B, 2))
    pos = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    ref = np.zeros((B,), np.int64)
    vis = np.ones((B, V), bool)
    vis[:, 0] = False
    mixed = slice(0, 256)
    ref[mixed] = rng.integers(0, V, 256)
    vis[mixed] = rng.uniform(size=(256, V)) > 0.3
    vis[np.arange(256), ref[mixed]] = False
    vis[256] = False  # no visible view at all
    pos[257:261] = [50.0, 50.0, 0.0]  # off every frustum
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return cams, t(images), t(pos), t(nrm), t(ref), t(vis)


def dtu_inputs(device):
    """49 views of 1600 x 1200 on a 7 x 7 grid, 16384 patches, ~25 visible."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    V, H, W, B = 49, 1200, 1600, 16384
    yaws = np.linspace(-0.45, 0.45, 7)
    pitches = np.linspace(-0.225, 0.225, 7)
    Cs = [np.array([6.0 * np.sin(y), 6.0 * np.sin(p),
                    -6.0 * np.cos(y) * np.cos(p)])
          for p in pitches for y in yaws]
    cams = _cameras(Cs, 1500.0, W, H, device)
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.rand((V, H, W), generator=gen, device=device) * 255.0
    xy = rng.uniform(-1.0, 1.0, (B, 2))
    pos = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    ref = np.full((B,), 24, np.int64)
    vis = rng.uniform(size=(B, V)) < 0.51
    vis[:, 24] = False
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return cams, images, t(pos), t(nrm), t(ref), t(vis)


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
    # Textures this run's data makes the kernel sample: one per scored slot
    # and one per valid anchor.
    textures = int((sk != -1).sum()) + int(okk.sum())
    bound = _warp_bound(images, (*kargs[1:-1], sk, ak, okk), B, textures, k)
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
    bound = _bound(_nbytes(*inputs, got), N * L * NCC_ELEMENT_FLOPS[masked])
    # The kernel's time in the record is the rotated one: one set under the
    # L2 cache's size is partly served from L2, under the DRAM bound.
    sets = [(a, b, mask)] + [
        _ncc_inputs(N, L, masked, device, seed=N + L + s)
        for s in range(2, _timing.rotation(_nbytes(*inputs),
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
    textures = int((sk != -1).sum())  # slot 0 included
    bound = _warp_bound(images, (*kargs[1:-1], sk), B, textures, k)
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

    rng = np.random.default_rng(seed)
    H, W = 120, 160
    Cs = []
    for i in range(V):
        ang = (i - (V - 1) / 2) * (0.9 / max(V, 8))
        Cs.append(np.array([6.0 * np.sin(ang), 0.2 * np.sin(2 * i),
                            -6.0 * np.cos(ang)]))
    cams = _cameras(Cs, 125.0, W, H, device)
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


def phase_awkward_shapes(device, results):
    """K1 and K2 against their plain versions at the shapes that stress the
    kernels' control flow: one view, more views than a block has threads,
    textures of 1, 25, 49 and 441 texels (fewer texels than lanes; two per
    lane; the strided variant), batches of 0 and 1, a slot table of one slot, and view ids
    outside the stack."""
    import torch

    from densepoints_tpu_torch.ops import allview_ncc, warp_ncc
    from densepoints_tpu_torch.ops.warp import compact_visible

    worst = {"allview_ncc": 0.0, "slot_ncc": 0.0}
    lines = []
    for V, B, k in ((1, 33, 11), (130, 40, 5), (130, 40, 16), (8, 64, 1),
                    (8, 64, 5), (8, 64, 7), (8, 64, 21), (8, 1, 11),
                    (8, 0, 11), (49, 64, 11)):
        rig = small_rig(device, V, B, seed=100 + V + B + k)
        label = f"V={V} B={B} k={k}"
        launches = allview_ncc.KERNEL_LAUNCHES
        sk, _, _, err, scored, flips = check_kernel(f"awkward {label}",
                                                    *rig, k)
        check(allview_ncc.KERNEL_LAUNCHES == launches + (1 if B else 0),
              f"awkward {label}: the all-views kernel did not launch once")
        check(tuple(sk.shape) == (B, V), f"awkward {label}: {sk.shape}")
        worst["allview_ncc"] = max(worst["allview_ncc"], err)
        lines.append(f"{label}: scored={scored} err={err:.3e} flips={flips}")
        # The slot kernel on the same rig: the default compaction, and for
        # V = 8 a single slot and a table with ids outside [0, V).
        cams, images, pos, nrm, ref, vis = rig
        tables = [("M=16", *compact_visible(vis, 16), None)]
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


def phase_kernels(device):
    """Every kernel against its plain version; returns per-kernel results
    keyed by shape."""
    import torch

    from densepoints_tpu_torch.scripts import (
        kernel_ablate,
        kernel_paged_ablate,
    )

    results = {"allview_ncc": {}, "slot_ncc": {}, "ncc_pairs": {},
               "window_ncc": {}, "window_textures": {}}
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
    refine = refine_inputs(device)
    (ids, ok), = _slot_tables("refine", refine[5], 8)  # V = 8: one chunk
    for k in (11, 16):
        results["allview_ncc"][f"refine_k{k}"] = compare_kernel(
            f"refine k={k}", *refine, k)
        results["slot_ncc"][f"refine_k{k}"] = compare_slot_kernel(
            f"refine k={k}", *refine[:5], ids, ok, k)
    check_no_torch_op_before_launch(refine, ids, ok)
    del refine
    phase_awkward_shapes(device, results)
    dtu = dtu_inputs(device)
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
    from densepoints_tpu_torch.ops import (
        allview_ncc,
        ncc,
        warp_ncc,
        window_ncc,
        window_textures,
    )

    return {"allview_ncc": allview_ncc, "slot_ncc": warp_ncc,
            "ncc_pairs": ncc, "window_ncc": window_ncc,
            "window_textures": window_textures}


def _reset_counters():
    for module in _counters().values():
        module.KERNEL_LAUNCHES = 0
        module.PLAIN_CALLS = 0


def _read_counters():
    return ({name: m.KERNEL_LAUNCHES for name, m in _counters().items()},
            {name: m.PLAIN_CALLS for name, m in _counters().items()})


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

    refine = refine_inputs(device)
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
    _, best, iters = nelder_mead(f_auto, x0, step, max_iterations=30)
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
    cams, images, pos, nrm, ref, vis = dtu_inputs(device)
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
    """The CLI on the sphere scene; returns (launches, stage seconds,
    positions, the final PatchState)."""
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
    check(len(pts) >= 1000, f"only {len(pts)} patches (need >= 1000)")
    check(med < 0.01 * SPHERE_RADIUS,
          f"median radial error {med:.4f} >= {0.01 * SPHERE_RADIUS}")
    return launches, metrics.times, pts, result.patches


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


def _ba_rmse(scene_path, settings, device, iterations=None):
    """The pipeline's bundle adjustment of the scene's seed tracks on one
    rank (with `iterations` LM iterations in place of the settings'), as a
    CLI run makes it; returns the RMSE in pixels."""
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
                                             config.matching)
    ba = config.ba
    if iterations is not None:
        ba = dataclasses.replace(ba, max_outer_iterations=iterations)
    return _bundle_adjust(scene.cameras, points, obs, mask, ba)[2]


def _with_settings(**sections):
    settings = json.loads(json.dumps(SPHERE_SETTINGS))
    for name, values in sections.items():
        settings.setdefault(name, {}).update(values)
    return settings


def phase_rest_of_pipeline(device, main_pts, main_times):
    """Phase 11: checkpoint / resume, multi-scale, bundle adjustment, the
    mesh, debug and profile dumps, the native runtime and the cloud metrics,
    each CLI run on the sphere with every counter set to 0 just before.
    Returns the BA RMSE of the turned calibration."""
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
# (--parallel-rank SPEC), killed with the others if one runs past this.
PARALLEL_CHILD_S = 300
# One host: the ranks meet on the loopback interface.
PARALLEL_ENV = {"NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo"}
# Clustered partitioning with a halo of views covisible above 0.5: each of
# the sphere's two clusters holds 9 of its 12 views.
PARALLEL_HALO = 0.5
PARALLEL_ATOL = 1e-5  # N ranks vs 1 rank, replicated driver
CLUSTERED_ATOL = 5e-3  # N ranks vs 1 rank, clustered driver
BA_RMSE_ATOL = 1e-3  # pixels, sharded vs single-rank BA
BA_ORDERS = 5  # single-rank BA in the observations' order and 4 shuffles


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(label, world, spec, tmp):
    """The `world` ranks of one job, each this script with --parallel-rank;
    waits for all within PARALLEL_CHILD_S seconds (every rank is killed if
    one exceeds it) and fails if a rank fails. Returns each rank's record
    (its last `[parallel-rank]` JSON line)."""
    import os

    port = _free_port()
    env = dict(os.environ, **PARALLEL_ENV)
    procs = []
    for rank in range(world):
        child = dict(spec, rank=rank, world=world, port=port,
                     out=str(tmp / f"{label}.{rank}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank",
             json.dumps(child)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    deadline = time.monotonic() + PARALLEL_CHILD_S
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        raise SmokeFailure(f"[parallel] {label}: a rank ran past "
                           f"{PARALLEL_CHILD_S} s; every rank was killed")
    records = []
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        lines = [line for line in log.splitlines()
                 if line.startswith("[parallel-rank] ")]
        check(proc.returncode == 0 and lines,
              f"[parallel] {label}: rank {rank}/{world} failed "
              f"({proc.returncode}):\n{log[-3000:]}")
        records.append(json.loads(lines[-1][len("[parallel-rank] "):]))
    return records


def parallel_rank(spec):
    """The `--parallel-rank SPEC` mode: one rank of a phase 12 job. With
    "flags", `cli.main` with those flags joined to the job (counters at 0
    before); with "ba", the view-sharded seeds and `run_ba_sharded` of the
    scene. Writes its cloud to SPEC["out"] and prints one JSON line."""
    import numpy as np
    import torch

    spec = json.loads(spec)
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
                  else cli.main(spec["flags"] + job))
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
    (gloo), both ranks' clouds bitwise equal and equal to a's; c: clustered
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
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        (tmp / "scene").mkdir()
        scene = write_sphere_scene(tmp / "scene")
        settings = tmp / "settings.json"
        settings.write_text(json.dumps(SPHERE_SETTINGS))
        base = ["-i", str(scene), "-s", str(settings), "--device", device]

        def job(label, world, flags, halo=None):
            """A CLI run with `flags`, or with `halo`, `densify_clustered`
            on the seeds of the single front end (no PLY then)."""
            ply = tmp / f"{label}.ply"
            spec = {"flags": base + flags + ["-o", str(ply)],
                    "device": device}
            if halo is not None:
                spec.update(halo=halo, scene=str(scene),
                            settings=SPHERE_SETTINGS)
            recs = _run_ranks(label, world, spec, tmp)
            clouds = []
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


# Phase 13: the three end-to-end programs of the port at the JAX package's
# recorded configurations. Run a is `DTU_r05.json`'s: 49 views of 1600 x
# 1200 and its 20 rounds. Views and resolution are never cut; should the
# script outgrow its time, `--max-rounds` (depth) is the one to cut.
DTU_RUNS = (
    # label, program, flags, the JAX package's record of the configuration
    ("a", "dtu_scale_run",
     ["--kp", "8192", "--max-per-cell", "6", "--nm-iters", "120",
      "--expand-nm-iters", "40", "--score-views", "25", "--grid-scale", "8",
      "--max-rounds", "20"], "DTU_r05.json"),
    ("b", "dtu_layout_run", [], "DTU_LAYOUT_r04.json"),
    ("c", "occlusion_run", [], "OCCLUSION_r05.json"),
)
# Quality gates, each from the JAX package's record of the same run (its
# value in the comment); quality, not speed.
DTU_PIXEL_MM = 650.0 / 2900.0  # run a's pixel footprint, 0.224 mm
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
    print(f"[dtu] {label} {name}: {json.dumps(line)}", flush=True)
    want = json.loads((ROOT / record).read_text())
    want_counts = _dtu_counts(want)
    shared = {k: (v, want_counts[k], round(100.0 * (v - want_counts[k])
                                            / want_counts[k], 2))
              for k, v in counts.items()
              if want_counts.get(k)}
    print(f"[dtu] {label} against {record} (port, JAX record, diff %, for "
          f"information): {json.dumps(shared)}", flush=True)
    check(launches > 0, f"[dtu] {label}: the all-views kernel was never "
          "launched")
    check(plain == 0, f"[dtu] {label}: {plain} plain scoring calls")
    ops = {"<": lambda x, y: x < y, ">=": lambda x, y: x >= y}
    for gate, value, op, limit in DTU_GATES[label](artifact):
        check(ops[op](value, limit),
              f"[dtu] {label}: {gate} {value} is not {op} {limit:g}")


def phase_dtu(device):
    """Phase 13: the three end-to-end programs on the card at the JAX
    package's recorded configurations; returns the K1 launches of each
    run by label."""
    launches = {}
    for label, *_ in DTU_RUNS:
        artifact, k1, plain, peak, wall, _ = dtu_run(label, device)
        _dtu_check(label, artifact, k1, plain, peak, wall)
        launches[label] = k1
    return launches


def dtu_only(device):
    """The `--dtu` mode: phase 13 alone, after the device and the build."""
    print(json.dumps({"allview_ncc_launches_dtu": phase_dtu(device)}),
          flush=True)


def profile_dtu(device):
    """The `--profile-dtu` mode: run a of phase 13 under `torch.profiler`
    (key averages only, no trace file); one JSON line of its device ops,
    device time, K1's time and launches, the ten costliest kernels and the
    device-busy share of `densify`'s wall and of the run's."""
    import torch

    artifact, k1, plain, peak, wall, prof = dtu_run("a", device, True)
    _dtu_check("a", artifact, k1, plain, peak, wall)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    k1_events = [e for e in kernels if "allview_ncc_kernel" in e.key]
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)
    densify_s = artifact["densify_seconds"]
    print(json.dumps({
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
    }), flush=True)


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
)


def time_allview(device):
    """The `--time-allview` mode: one JSON line of kernel-only times of the
    all-views kernel and the slot kernel, and of the whole entry point
    `allview_scores` at the refine k = 11 shape."""
    import torch

    from densepoints_tpu_torch.ops import allview_ncc, warp_ncc
    from densepoints_tpu_torch.ops.warp import compact_visible
    from densepoints_tpu_torch.pmvs.optimize import _anchor_chunks

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

    refine = refine_inputs(device)
    run("refine_k11", lambda vis: compact_visible(vis, 8), True, *refine, 11)
    run("refine_k16", None, False, *refine, 16)
    del refine
    run("dtu_k16", lambda vis: _anchor_chunks(vis, 16)[0], False,
        *dtu_inputs(device), 16)
    print(json.dumps(out), flush=True)


def profile_main(device):
    """The `--profile-main` mode: the CLI on the sphere scene once to warm
    up, then once under `torch.profiler`; one JSON line of the device ops
    of that run (count and milliseconds, the scoring kernel and the batched
    matmuls apart), its launches, stage seconds, patches and radial error."""
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
              "bmm_or_gemm": [0, 0.0]}
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        keys = ["all"]
        if "allview_ncc_kernel" in event.key:
            keys.append("allview_ncc_kernel")
        elif "gemm" in event.key.lower() or "bmm" in event.key.lower():
            keys.append("bmm_or_gemm")
        for key in keys:
            groups[key][0] += event.count
            groups[key][1] += event.device_time_total / 1e3
    print(json.dumps({
        "root": str(ROOT), "card": torch.cuda.get_device_name(0),
        "device_ops": {k: {"count": c, "ms": round(ms, 3)}
                       for k, (c, ms) in groups.items()},
        "allview_ncc_launches": launches["allview_ncc"],
        "plain_calls": sum(plain.values()),
        "cli_wall_s": round(wall, 3),
        "stage_s": {k: round(v, 3) for k, v in metrics.times.items()},
        "patches": len(pts), "median_radial_error": _radial_error(pts),
    }), flush=True)


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
                for s in range(1, _timing.rotation(_nbytes(*inputs), l2))]
            got = ncc.ncc_pairs_cuda(*first)
            out[f"{key}_bound_ms"] = round(_bound(
                _nbytes(*inputs, got), N * L * NCC_ELEMENT_FLOPS[masked])[0],
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
    the two window kernels, and the SASS digest of every function of the
    built library, one JSON line. Fails if an instance of the row-wise NCC
    kernel spills."""
    out = {"root": str(ROOT)}
    for name in ("allview_ncc", "slot_ncc", "ncc_pairs", "window_ncc",
                 "window_textures"):
        out[name] = _ptxas_resources(
            ROOT / "densepoints_tpu_torch" / "csrc" / f"{name}.cu")
    spills = [k for k, v in out["ncc_pairs"].items()
              if v["spill_store_bytes"] or v["spill_load_bytes"]]
    check(not spills, f"row-wise NCC instances spill: {spills}")
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
    _, _, _, main_patches = phase_main_path(device)
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
             "--profile-dtu": profile_dtu}
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
        (launches["allview_ncc"], main_times, main_pts,
         main_patches) = phase_main_path("cuda")
        ba_turned = phase_rest_of_pipeline("cuda", main_pts, main_times)
        parallel = phase_parallel("cuda", main_patches, ba_turned)
        dtu = phase_dtu("cuda")
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
            **({"launches_parallel": parallel, "launches_dtu": dtu}
               if kernel == "allview_ncc" else {}),
            # No single PyTorch call computes a projective warp + NCC, a
            # clamped row-wise NCC, or window-relative sampling with zeros
            # outside the window (`grid_sample` clamps or pads by image,
            # takes no per-slot window and no NCC).
            "library_ms": None,
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
