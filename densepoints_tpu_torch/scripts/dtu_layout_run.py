"""End-to-end densification of the port from an on-disk DTU layout.

    python -m densepoints_tpu_torch.scripts.dtu_layout_run [--out FILE]
        [--views 21] [--width 800] [--height 600] [--clean]
        [--device cuda] [--layout-dir DIR] [--checkpoint-dir DIR]

Stands for `scripts/dtu_layout_run.py` of the JAX package, with its flags,
defaults, config dict, scene and seeds. It drives the real-dataset path as
a user of the reference would (programs/densify/main.cpp:12-40): a DTU
tree on disk (`Calibration/pos_XXX.txt` + `Rectified/rect_XXX_max_r5000.png`)
-> `io.datasets.dtu_to_scene_json` -> `io.scene.load_scene` -> `densify`,
with photometric nuisances baked into the PNGs (`add_nuisances`):

  * per-view gain/bias (exposure differences between views),
  * radial vignetting,
  * a view-dependent specular lobe (breaks photometric constancy),
  * a textureless surface region (consistent across views),
  * sensor noise + 8-bit quantization (PNG round-trip).

The artifact reports accuracy / completeness on the analytic-sphere
protocol of `dtu_scale_run`. It is printed as the last line, and written
to `--out` if given.

Departures from the JAX program, each a repair:
  * `--layout-dir` and `--checkpoint-dir` default to fresh temporary
    directories removed at the end. The JAX program wrote the tree under a
    fixed /tmp path and resumed from the checkpoints beside it, so a rerun
    with other code picked up a stale run.
  * `--out` has no default: the JAX default wrote over the repo's own
    records (DTU_LAYOUT_r04.json) when run from the root.
  * No compile cache (an XLA mechanic); `artifact["device"]` is the card's
    name and power limit, and `--device` (default cuda) picks the device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from densepoints_tpu_torch.scripts import _scene_runs

NUISANCES = [
    "per_view_gain_bias",
    "vignetting_25pct",
    "view_dependent_specular_lobe",
    "textureless_pole_region",
    "sensor_noise_sigma2",
    "8bit_png_quantization",
]


def add_nuisances(images, scene_gen, rng, radius):
    """Per-view photometric non-idealities, in place on f32 images."""
    V, H, W = images.shape
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    r2 = ((xx - W / 2) / (W / 2)) ** 2 + ((yy - H / 2) / (H / 2)) ** 2
    vignette = 1.0 - 0.25 * r2  # ~25% corner falloff
    pole = np.array([0.0, 0.0, float(radius)])  # textureless surface spot
    for v in range(V):
        img = images[v]
        gain = float(rng.normal(1.0, 0.06))
        bias = float(rng.normal(0.0, 4.0))
        img *= gain * vignette
        img += bias
        # View-dependent specular lobe: a Gaussian highlight at the
        # sphere point whose normal bisects view direction and a fixed
        # light, approximated by the projection of a point that slides
        # with the camera azimuth (photometric-constancy violation).
        C = scene_gen.C[v]
        toward = -C / np.linalg.norm(C)
        spec_pt = -radius * 0.9 * toward + np.array([0.0, 0.0, 0.1 * radius])
        P = scene_gen.P[v]
        h = P @ np.append(spec_pt, 1.0)
        if h[2] > 0:
            sx, sy = h[0] / h[2], h[1] / h[2]
            d2 = (xx - sx) ** 2 + (yy - sy) ** 2
            img += 60.0 * np.exp(-0.5 * d2 / (0.03 * W) ** 2)
        # Textureless region: flatten a disk around the pole's projection
        # toward its local mean (the same SURFACE region in every view).
        hp = P @ np.append(pole, 1.0)
        if hp[2] > 0:
            px, py = hp[0] / hp[2], hp[1] / hp[2]
            mask = (xx - px) ** 2 + (yy - py) ** 2 < (0.05 * W) ** 2
            if mask.any():
                img[mask] = 0.9 * img[mask].mean() + 0.1 * img[mask]
        # Sensor noise.
        img += rng.normal(0.0, 2.0, img.shape)
    np.clip(images, 0, 255, out=images)
    return images


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the artifact to this JSON file")
    p.add_argument("--views", type=int, default=21)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--kp", type=int, default=2048)
    p.add_argument("--focal", type=float, default=1450.0)
    p.add_argument("--radius", type=float, default=60.0)
    p.add_argument("--cam-radius", type=float, default=650.0)
    p.add_argument("--max-rounds", type=int, default=6)
    p.add_argument("--impl", default="paged", choices=["auto", "paged"])
    p.add_argument("--expand-nm-iters", type=int, default=40)
    p.add_argument("--clean", action="store_true",
                   help="skip the nuisances (delta baseline)")
    p.add_argument("--layout-dir", default="",
                   help="where the DTU tree is written (default: a fresh "
                   "temporary directory)")
    p.add_argument("--threshold-mm", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint-dir", default="",
                   help="stage checkpoints, resumed from (default: a fresh "
                   "temporary directory)")
    return p.parse_args(argv)


def config_dict(args) -> dict:
    """The JAX program's config dict, without its runtime section."""
    return {
        "profile": "scan",
        "matching": {
            "max_keypoints_per_view": args.kp,
        },
        "optimize": {
            "max_iterations": 120,
            "sampling_impl": args.impl,
        },
        "expand": {
            "max_rounds": args.max_rounds,
            "max_iterations": args.expand_nm_iters,
        },
    }


def make_images(args):
    """The sphere scene (`default_rng(0)`, whose stream then draws the
    nuisances); returns (generator, f32 images (V, H, W))."""
    rng = np.random.default_rng(0)
    scene_gen = _scene_runs.synthetic().TexturedSphereScene(
        rng,
        num_views=args.views,
        width=args.width,
        height=args.height,
        focal=args.focal,
        radius=args.radius,
        cam_radius=args.cam_radius,
        tex_size=4096,
        layout="grid",
        yaw_span=1.0,
        pitch_span=0.5,
    )
    images = scene_gen.render_all().astype(np.float32)
    if not args.clean:
        images = add_nuisances(images, scene_gen, rng, args.radius)
    return scene_gen, images


def run(args) -> dict:
    """The program's run; returns its artifact."""
    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.pmvs.pipeline import densify

    t0 = time.perf_counter()
    scene_gen, images = make_images(args)
    t_render = time.perf_counter() - t0
    tag = "clean" if args.clean else "nuisance"
    with _scene_runs.work_dir(args.layout_dir,
                              f"dtu_layout_{tag}_") as root, \
            _scene_runs.work_dir(args.checkpoint_dir,
                                 "dtu_layout_ckpt_") as ckpt:
        t0 = time.perf_counter()
        _scene_runs.write_dtu_layout(root, scene_gen.P, images)
        scene = _scene_runs.load_dtu_layout(root, args.device)
        t_layout = time.perf_counter() - t0
        config = load_config({
            **config_dict(args),
            "runtime": {"checkpoint_dir": str(ckpt), "resume": True},
        })
        t1 = time.perf_counter()
        result = densify(scene, config, device=args.device)
        t_densify = time.perf_counter() - t1

    cloud = result.positions
    metrics, acc_exact = _scene_runs.sphere_quality(
        cloud, args.radius, scene_gen.C, args.threshold_mm)
    return {
        "scene": {
            "kind": f"on_disk_dtu_layout_{tag}",
            "layout_dir": str(root),
            "views": args.views,
            "width": args.width,
            "height": args.height,
            "nuisances": [] if args.clean else NUISANCES,
        },
        "config": {
            "profile": "scan",
            "sampling_impl": args.impl,
            "expand_nm_iterations": args.expand_nm_iters,
            "max_rounds": args.max_rounds,
        },
        "patches": int(cloud.shape[0]),
        "render_seconds": round(t_render, 2),
        "layout_seconds": round(t_layout, 2),
        "densify_seconds": round(t_densify, 2),
        "stage_seconds": {
            k: round(v, 2) for k, v in result.metrics.times.items()
        },
        "counters": {
            k: float(v) for k, v in result.metrics.counters.items()
        },
        "quality_mm": {
            "threshold_mm": args.threshold_mm,
            "accuracy_mean": round(metrics.accuracy_mean, 4),
            "accuracy_median": round(metrics.accuracy_median, 4),
            "completeness_median": round(metrics.completeness_median, 4),
            "accuracy_frac_under": round(metrics.accuracy_frac_under, 4),
            "completeness_frac_under": round(
                metrics.completeness_frac_under, 4
            ),
            "accuracy_exact_mean": round(float(np.mean(acc_exact)), 4),
            "accuracy_exact_median": round(float(np.median(acc_exact)), 4),
        },
        "device": _scene_runs.device_label(args.device),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    print(json.dumps(artifact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
