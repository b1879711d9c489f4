"""DTU-scale end-to-end densification of the port on a CUDA card.

    python -m densepoints_tpu_torch.scripts.dtu_scale_run [--out FILE]
        [--views 49] [--width 1600] [--height 1200] [--kp 4096]
        [--device cuda] [--checkpoint-dir DIR] [--surface]

Stands for `scripts/dtu_scale_run.py` of the JAX package, with its flags,
defaults, config dict, scene and seeds: a DTU-shaped synthetic (49 cameras
on a 7 x 7 angular grid 650 mm from a textured 60 mm sphere, 1600 x 1200
px at a DTU-like focal length of 2900 px, `default_rng(0)`), `densify`,
then the DTU protocol's accuracy / completeness in mm against 200,000
sphere samples inside the cameras' 0.78 rad visible cone (`default_rng(1)`),
the exact distance | |p| - r |, the forensics of the points farther than
the threshold, and with `--surface` a TSDF mesh's distance to the sphere.
Prints the artifact as its last line, and writes it to `--out` if given.

Departures from the JAX program, each a repair:
  * `--checkpoint-dir`: the stage checkpoints (resume on) go there, by
    default to a fresh temporary directory removed at the end. The JAX
    program resumed from a fixed path under /tmp, so a rerun with other
    code picked up a stale run.
  * `--out` has no default: the JAX default wrote over the repo's own
    records (DTU_r03.json) when run from the root.
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


def _tail_forensics(result, cloud, acc_exact, radius, scene_gen, thr):
    """Classify the > threshold exact-accuracy population: fringe normals
    (the patch normal off the true surface normal), low-view patches, rim
    patches (grazing viewing angles), outward vs inward floaters. Reported
    for the tail AND the inliers, so the differences read directly."""
    if not len(cloud):
        return {}
    normals = result.normals
    vis_counts = result.patches.vis.cpu().numpy().sum(axis=1)
    n_gt = cloud / np.maximum(
        np.linalg.norm(cloud, axis=1, keepdims=True), 1e-9
    )
    align = np.abs(np.sum(normals * n_gt, axis=1)) / np.maximum(
        np.linalg.norm(normals, axis=1), 1e-9
    )
    # Rim-ness: angle between the inward surface normal and the mean
    # camera direction (the grazing band sits near the 0.78 rad cutoff).
    mean_cam = scene_gen.C.mean(axis=0)
    mean_cam /= np.linalg.norm(mean_cam)
    rim_angle = np.arccos(np.clip(n_gt @ mean_cam, -1, 1))
    outward = np.linalg.norm(cloud, axis=1) > radius
    tail = acc_exact > thr

    def side(mask):
        n = int(mask.sum())
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "normal_alignment_median": round(
                float(np.median(align[mask])), 4
            ),
            "visible_views_mean": round(
                float(np.mean(vis_counts[mask])), 2
            ),
            "rim_angle_median_rad": round(
                float(np.median(rim_angle[mask])), 4
            ),
            "frac_outward": round(float(np.mean(outward[mask])), 4),
            "exact_mm_median": round(
                float(np.median(acc_exact[mask])), 4
            ),
        }

    return {
        "threshold_mm": thr,
        "tail": side(tail),
        "inliers": side(~tail),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the artifact to this JSON file")
    p.add_argument("--views", type=int, default=49)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--height", type=int, default=1200)
    p.add_argument("--kp", type=int, default=4096,
                   help="max keypoints per view (reference ORB uses 40000)")
    p.add_argument("--max-per-cell", type=int, default=4,
                   help="grid-filter keypoints per 16px cell (the knob "
                   "that binds at DTU image sizes)")
    p.add_argument("--focal", type=float, default=2900.0)
    p.add_argument("--radius", type=float, default=60.0, help="object mm")
    p.add_argument("--cam-radius", type=float, default=650.0)
    p.add_argument("--max-rounds", type=int, default=12)
    p.add_argument("--nm-iters", type=int, default=120,
                   help="Nelder-Mead iteration cap (reference cap is 500)")
    p.add_argument("--score-views", type=int, default=25,
                   help="max_score_views of the optimize config")
    p.add_argument("--threshold-mm", type=float, default=2.0)
    p.add_argument("--grid-scale", type=int, default=8,
                   help="occupancy cell size in px (patch_organizer.h:46 "
                   "default 8); 4 doubles linear patch density")
    p.add_argument("--impl", default="auto", choices=["auto", "paged"],
                   help="sampling_impl: both name the all-views pass")
    p.add_argument("--expand-nm-iters", type=int, default=0,
                   help="Nelder-Mead cap for EXPANSION candidates only "
                   "(0 = same as --nm-iters)")
    p.add_argument("--surface", action="store_true",
                   help="also extract a TSDF surface and report mesh-vertex "
                   "distance to the analytic sphere")
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint-dir", default="",
                   help="stage checkpoints, resumed from (default: a fresh "
                   "temporary directory)")
    return p.parse_args(argv)


def config_dict(args) -> dict:
    """The JAX program's config dict, without its runtime section."""
    return {
        "matching": {
            "max_keypoints_per_view": args.kp,
            "max_keypoints_per_cell": args.max_per_cell,
            # all C(49,2)=1176 pairs is the reference default; prune to
            # covisible neighbours at scan scale (SURVEY §2.4 pair list)
            "max_pairs_per_view": 10,
        },
        "optimize": {
            "max_iterations": args.nm_iters,
            "max_score_views": args.score_views,
            "sampling_impl": args.impl,
        },
        "expand": {
            "max_rounds": args.max_rounds,
            "max_iterations": args.expand_nm_iters,
        },
        "organizer": {"grid_scale": args.grid_scale},
        # The scan-scale filter preset (FILTER_SWEEP_r03.json).
        "filter": {
            "min_support_cells": 4,
            "depth_consistency": 0.005,
            "occlusion_slack": 0.02,
        },
    }


def make_scene(args):
    """The DTU-shaped sphere scene (`default_rng(0)`); returns (generator,
    f32 images (V, H, W))."""
    scene_gen = _scene_runs.synthetic().TexturedSphereScene(
        np.random.default_rng(0),
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
    return scene_gen, scene_gen.render_all()


def run(args) -> dict:
    """The program's run; returns its artifact."""
    from densepoints_tpu_torch.config import SurfaceConfig, load_config
    from densepoints_tpu_torch.core.cameras import Cameras
    from densepoints_tpu_torch.io.scene import Scene
    from densepoints_tpu_torch.pmvs.pipeline import densify

    t0 = time.perf_counter()
    scene_gen, images = make_scene(args)
    t_render = time.perf_counter() - t0
    print(f"rendered {args.views} views {args.width}x{args.height} "
          f"in {t_render:.1f}s ({images.nbytes / 1e6:.0f} MB f32)",
          flush=True)

    cams = Cameras.from_projection_matrices(
        scene_gen.P, widths=args.width, heights=args.height,
        device=args.device,
    )
    scene = Scene(cameras=cams, images=images, colors=None)
    with _scene_runs.work_dir(args.checkpoint_dir, "dtu_ckpt_") as ckpt:
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
    patches = int(cloud.shape[0])
    artifact = {
        "scene": {
            "kind": "synthetic_dtu_sphere",
            "views": args.views,
            "width": args.width,
            "height": args.height,
            "focal_px": args.focal,
            "object_radius_mm": args.radius,
            "camera_distance_mm": args.cam_radius,
            "pixel_footprint_mm": args.cam_radius / args.focal,
        },
        "config": {
            "max_keypoints_per_view": args.kp,
            "max_keypoints_per_cell": args.max_per_cell,
            "max_pairs_per_view": 10,
            "nm_iterations": args.nm_iters,
            "max_score_views": args.score_views,
            "expand_max_rounds": args.max_rounds,
            "grid_scale": args.grid_scale,
            "sampling_impl": args.impl,
            "expand_nm_iterations": args.expand_nm_iters,
        },
        "patches": patches,
        "render_seconds": round(t_render, 2),
        "densify_seconds": round(t_densify, 2),
        "patches_per_sec_end_to_end": round(patches / t_densify, 1),
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
            "completeness_mean": round(metrics.completeness_mean, 4),
            "completeness_median": round(metrics.completeness_median, 4),
            "accuracy_frac_under": round(metrics.accuracy_frac_under, 4),
            "completeness_frac_under": round(
                metrics.completeness_frac_under, 4
            ),
            "accuracy_exact_mean": round(float(np.mean(acc_exact)), 4),
            "accuracy_exact_median": round(
                float(np.median(acc_exact)), 4
            ),
            "accuracy_exact_p95": round(
                float(np.percentile(acc_exact, 95)), 4
            ),
            "accuracy_exact_p99": round(
                float(np.percentile(acc_exact, 99)), 4
            ),
        },
        "tail_mm": _tail_forensics(
            result, cloud, acc_exact, args.radius, scene_gen,
            args.threshold_mm,
        ),
    }
    if args.surface:
        from densepoints_tpu_torch.surface.tsdf import extract_surface

        ts = time.perf_counter()
        verts, faces = extract_surface(
            result.positions,
            result.normals,
            SurfaceConfig(enable=True, voxel_resolution=192, min_weight=2.0),
            device=args.device,
        )
        t_surface = time.perf_counter() - ts
        verts = np.asarray(verts)
        vex = (
            np.abs(np.linalg.norm(verts, axis=1) - args.radius)
            if len(verts)
            else np.array([np.nan])
        )
        artifact["surface"] = {
            "voxel_resolution": 192,
            "min_weight": 2.0,
            "vertices": int(len(verts)),
            "faces": int(len(np.asarray(faces))),
            "extract_seconds": round(t_surface, 1),
            "vertex_dist_mm": {
                "median": round(float(np.median(vex)), 3),
                "mean": round(float(np.mean(vex)), 3),
                "p95": round(float(np.percentile(vex, 95)), 3),
            },
        }
        print("surface:", artifact["surface"], flush=True)
    artifact["device"] = _scene_runs.device_label(args.device)
    return artifact


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
