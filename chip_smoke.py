#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`densepoints_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero and prints
no result line:
  1. device: the card's name and `nvidia-smi` name/power limit (a CUDA card
     is required; there is no CPU fallback);
  2. build: compiles every CUDA kernel of the main path from the sources in
     this checkout (nvcc, sm_90a) and prints the build seconds;
  3. kernel vs plain: the all-views warp+NCC kernel against its plain torch
     version on the card at the refine shape (8 views of 480 x 640, 4096
     patches, k = 11 and 16, plus mixed-visibility, no-visibility and
     off-frustum rows) and a DTU shape (49 views of 1600 x 1200, 16384
     patches, ~25 visible views each, k = 16): scores within 1e-4, equal
     anchors, equal sentinel placement; CUDA-event times of both;
  4. main path: `densepoints_tpu_torch.cli.main` on a 12-view 512 x 384
     textured-sphere scene written as PNG files + scene JSON, with every
     launch counter set to 0 just before; checks the counters, the PLY, the
     patch count and the radial error against the analytic sphere.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
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
SPHERE_RADIUS = 150.0


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
    from densepoints_tpu_torch.ops import allview_ncc

    t0 = time.perf_counter()
    lib = allview_ncc.build_kernel()
    dt = time.perf_counter() - t0
    print(f"[build] {lib.relative_to(ROOT)} in {dt:.2f} s", flush=True)


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


def _time_ms(fn, reps=20):
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def compare_kernel(label, cams, images, pos, nrm, ref, vis, k):
    """Kernel vs plain on one input set; returns (max_abs_err, ms, plain_ms)."""
    import torch

    from densepoints_tpu_torch.ops import allview_ncc
    from densepoints_tpu_torch.ops.warp import patch_frames

    args = (images, cams, pos, nrm, ref, vis, k)
    sk, ak, okk = allview_ncc.allview_scores(*args)
    sp, ap, okp = allview_ncc.allview_scores_plain(*args)
    torch.cuda.synchronize()
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
    # Times of the kernel and of the plain version on the same frames,
    # then of the whole wrapper (frames in torch + kernel).
    sx, sy = frames
    kargs = (images, cams.K.contiguous(), cams.R.contiguous(),
             cams.C.contiguous(), cams.width, cams.height, pos.contiguous(),
             sx.contiguous(), sy.contiguous(), vis.contiguous(), k)
    runs = {
        "kernel": lambda: allview_ncc.allview_scores_cuda(*kargs),
        "plain": lambda: allview_ncc.allview_scores_plain(*args,
                                                          frames=frames),
        "wrapper": lambda: allview_ncc.allview_scores(*args),
    }
    for fn in runs.values():  # warm
        fn()
        fn()
    ms = {name: _time_ms(fn) for name, fn in runs.items()}
    B, V = vis.shape
    print(f"[kernel] {label}: B={B} V={V} k={k} slots={int(vis.sum())} "
          f"scored={int(both.sum())} max_abs_err={err:.3e} "
          f"sentinel_flips={len(flips)} kernel_ms={ms['kernel']:.4f} "
          f"plain_ms={ms['plain']:.4f} wrapper_ms={ms['wrapper']:.4f}",
          flush=True)
    return err, ms["kernel"], ms["plain"]


def phase_kernels(device):
    import torch

    refine = refine_inputs(device)
    results = {}
    for k in (11, 16):
        results[f"refine_k{k}"] = compare_kernel(f"refine k={k}", *refine, k)
    del refine
    dtu = dtu_inputs(device)
    results["dtu_k16"] = compare_kernel("dtu k=16", *dtu, 16)
    del dtu
    torch.cuda.empty_cache()
    return results


def write_sphere_scene(directory: Path):
    """bench.py's e2e scene as PNG images + a scene JSON; returns its path."""
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
        views.append({"filename": name, "projectionMatrix": sc.P[v].tolist()})
    path = directory / "scene.json"
    path.write_text(json.dumps({"imagesPath": str(directory),
                                "views": views}))
    return path


def phase_main_path(device: str):
    """The CLI on the sphere scene; returns (launches, stage seconds)."""
    import numpy as np

    from densepoints_tpu_torch import cli
    from densepoints_tpu_torch.io.ply import read_ply
    from densepoints_tpu_torch.ops import allview_ncc
    from densepoints_tpu_torch.pmvs import pipeline

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        scene_path = write_sphere_scene(tmp)
        settings = tmp / "settings.json"
        settings.write_text(json.dumps({
            "profile": "scan",
            "expand": {"max_rounds": 4, "max_iterations": 40},
            "optimize": {"max_iterations": 120},
            "organizer": {"grid_scale": 4},
        }))
        out = tmp / "cloud.ply"
        captured = {}
        densify = pipeline.densify

        def recording_densify(*a, **kw):
            captured["result"] = densify(*a, **kw)
            return captured["result"]

        pipeline.densify = recording_densify
        allview_ncc.KERNEL_LAUNCHES = 0
        allview_ncc.PLAIN_CALLS = 0
        t0 = time.perf_counter()
        try:
            rc = cli.main(["-i", str(scene_path), "-s", str(settings),
                           "-o", str(out), "--device", device])
        finally:
            pipeline.densify = densify
        wall = time.perf_counter() - t0
        launches = allview_ncc.KERNEL_LAUNCHES
        plain = allview_ncc.PLAIN_CALLS
        check(rc == 0, f"cli.main returned {rc}")
        cloud = read_ply(out)
    metrics = captured["result"].metrics
    pts = cloud["positions"]
    radial = np.abs(np.linalg.norm(pts, axis=1) - SPHERE_RADIUS)
    med = float(np.median(radial)) if len(pts) else float("inf")
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
    check(pts.ndim == 2 and pts.shape[1] == 3, f"PLY positions {pts.shape}")
    check(bool(np.isfinite(pts).all()), "non-finite positions in the PLY")
    check(len(pts) >= 1000, f"only {len(pts)} patches (need >= 1000)")
    check(med < 0.01 * SPHERE_RADIUS,
          f"median radial error {med:.4f} >= {0.01 * SPHERE_RADIUS}")
    return launches, metrics.times


def main() -> int:
    sys.path.insert(0, str(ROOT))
    try:
        name, smi_line = phase_device()
        phase_build()
        results = phase_kernels("cuda")
        launches, _ = phase_main_path("cuda")
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    import torch

    err = max(r[0] for r in results.values())
    _, ms, plain_ms = results["refine_k11"]
    print(smi_line, flush=True)
    print(json.dumps({"kernels": [{
        "name": "allview_ncc",
        "route": "cuda",
        "source": "densepoints_tpu_torch/csrc/allview_ncc.cu",
        "replaces": "densepoints_tpu/ops/warp_ncc_paged.py:287",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
