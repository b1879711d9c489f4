"""Grade the port on a scene that occludes itself.

    python -m densepoints_tpu_torch.scripts.occlusion_run [--out FILE]
        [--views 21] [--width 800] [--height 600] [--clean]
        [--device cuda] [--layout-dir DIR] [--checkpoint-dir DIR]

Stands for `scripts/occlusion_run.py` of the JAX package, with its flags,
defaults, config dict, scene and seeds. `MultiObjectScene` (two spheres +
a background plane: real self-occlusion, depth discontinuities, a
background surface) goes through the on-disk DTU-layout path with the
nuisances of `dtu_layout_run`, and the artifact reports:

  * accuracy (exact analytic distance to the surface union) and
    completeness (against ground-truth samples on the VISIBLE parts of the
    union);
  * occlusion-filter forensics (`occlusion_forensics`): the patches
    `filter_occlusion` kills on the expanded cloud (the `expanded.npz`
    checkpoint), classified against ground truth. A kill is justified if
    the patch sits off the true surface (> threshold) or claims visibility
    in a view where the segment test says another object hides it.

The artifact is printed as the last line, and written to `--out` if given.

Departures from the JAX program, each a repair:
  * `--layout-dir` and `--checkpoint-dir` default to fresh temporary
    directories removed at the end (the JAX program used a fixed /tmp
    path); the forensics read `expanded.npz` from the checkpoint directory
    of this run.
  * `--out` has no default: the JAX default wrote over the repo's own
    record (OCCLUSION_r05.json) when run from the root.
  * No compile cache (an XLA mechanic); `artifact["device"]` is the card's
    name and power limit, and `--device` (default cuda) picks the device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from densepoints_tpu_torch.scripts import _scene_runs
from densepoints_tpu_torch.scripts.dtu_layout_run import add_nuisances


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the artifact to this JSON file")
    p.add_argument("--views", type=int, default=21)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--kp", type=int, default=2048)
    p.add_argument("--max-rounds", type=int, default=6)
    p.add_argument("--threshold-mm", type=float, default=2.0)
    p.add_argument("--clean", action="store_true")
    p.add_argument("--layout-dir", default="",
                   help="where the DTU tree is written (default: a fresh "
                   "temporary directory)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint-dir", default="",
                   help="stage checkpoints (default: a fresh temporary "
                   "directory)")
    return p.parse_args(argv)


def config_dict(args) -> dict:
    """The JAX program's config dict, without its runtime section."""
    return {
        "profile": "scan",
        "matching": {"max_keypoints_per_view": args.kp},
        "optimize": {"max_iterations": 120},
        "expand": {"max_rounds": args.max_rounds, "max_iterations": 40},
    }


def make_images(args):
    """The two-spheres-and-a-plane scene (`default_rng(0)`, whose stream
    then draws the nuisances); returns (generator, f32 images)."""
    rng = np.random.default_rng(0)
    sc = _scene_runs.synthetic().MultiObjectScene(
        rng, num_views=args.views, width=args.width, height=args.height,
    )
    images = sc.render_all().astype(np.float32)
    if not args.clean:
        # The nuisances of dtu_layout_run; the "pole" flattening lands on
        # the back sphere.
        images = add_nuisances(images, sc, rng, sc.spheres[1][1])
    return sc, images


def occlusion_kills(cameras, state, config):
    """`filter_occlusion` at the run's settings on `state`; returns the
    (alive, killed, kept) masks as numpy bool arrays."""
    from densepoints_tpu_torch.pmvs.filter import filter_occlusion

    filtered = filter_occlusion(
        cameras,
        state,
        grid_scale=config.organizer.grid_scale,
        occlusion_slack=config.filter.occlusion_slack,
        min_visible_views=config.optimize.min_visible_views,
    )
    alive = state.alive.cpu().numpy()
    survives = filtered.alive.cpu().numpy()
    return alive, alive & ~survives, alive & survives


def classify_kills(sc, position, vis, alive, killed, kept, threshold):
    """Ground-truth grading of the filter's kill and keep sets. A patch is
    off-surface if it lies > `threshold` from the union, phantom-visible if
    it claims >= 1 view where its position is occluded by ANOTHER surface;
    a kill is justified if either holds."""
    d_surf = sc.distance_to_surface(position)
    occluded_claims = np.zeros(len(position), np.int32)
    for v in range(vis.shape[1]):
        visible = sc.point_visible(position, v, eps=5e-3)
        occluded_claims += vis[:, v] & ~visible
    off_surface = d_surf > threshold
    bad = off_surface | (occluded_claims >= 1)

    def stats(mask):
        n = int(mask.sum())
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "gt_dist_median": round(float(np.median(d_surf[mask])), 4),
            "gt_dist_p95": round(
                float(np.percentile(d_surf[mask], 95)), 4
            ),
            "frac_off_surface": round(float(off_surface[mask].mean()), 4),
            "frac_with_occluded_claims": round(
                float((occluded_claims[mask] >= 1).mean()), 4
            ),
            "frac_justified": round(float(bad[mask].mean()), 4),
        }

    return {
        "expanded_patches": int(alive.sum()),
        "killed": stats(killed),
        "kept": stats(kept),
        "note": "a kill is justified if the patch is off-surface or "
        "claims visibility through another object; kept patches' "
        "frac_justified is the false-negative view",
    }


def occlusion_forensics(sc, cameras, checkpoint, config, threshold,
                        device):
    """The occlusion filter's kills on the expanded cloud of `checkpoint`
    (the run's `expanded.npz`), graded against ground truth."""
    from densepoints_tpu_torch.utils.checkpoint import load_checkpoint

    state, _, _ = load_checkpoint(checkpoint, device=device)
    alive, killed, kept = occlusion_kills(cameras, state, config)
    return classify_kills(sc, state.position.cpu().numpy(),
                          state.vis.cpu().numpy(), alive, killed, kept,
                          threshold)


def run(args) -> dict:
    """The program's run; returns its artifact."""
    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.pmvs.pipeline import densify
    from densepoints_tpu_torch.utils.metrics import accuracy_completeness

    t0 = time.perf_counter()
    sc, images = make_images(args)
    t_render = time.perf_counter() - t0
    tag = "clean" if args.clean else "nuisance"
    with _scene_runs.work_dir(args.layout_dir,
                              f"occlusion_layout_{tag}_") as root, \
            _scene_runs.work_dir(args.checkpoint_dir,
                                 "occlusion_ckpt_") as ckpt:
        t0 = time.perf_counter()
        _scene_runs.write_dtu_layout(root, sc.P, images)
        scene = _scene_runs.load_dtu_layout(root, args.device)
        t_layout = time.perf_counter() - t0
        config = load_config({
            **config_dict(args),
            "runtime": {"checkpoint_dir": str(ckpt)},
        })
        t1 = time.perf_counter()
        result = densify(scene, config, device=args.device)
        t_densify = time.perf_counter() - t1
        cloud = result.positions

        # ---- quality vs analytic ground truth ------------------------
        acc = (sc.distance_to_surface(cloud) if len(cloud)
               else np.array([np.nan]))
        gt = sc.sample_visible_surface(np.random.default_rng(1), 60_000)
        metrics = accuracy_completeness(
            cloud, gt, threshold=args.threshold_mm, max_dist=20.0
        )
        print(metrics.summary(), flush=True)
        forensics = occlusion_forensics(
            sc, scene.cameras, Path(ckpt) / "expanded.npz", config,
            args.threshold_mm, args.device,
        )

    return {
        "scene": {
            "kind": f"multi_object_occlusion_{tag}",
            "objects": "sphere r55 front + sphere r70 back + plane z=220",
            "views": args.views,
            "width": args.width,
            "height": args.height,
            "layout_dir": str(root),
            "nuisances": [] if args.clean else [
                "per_view_gain_bias", "vignetting_25pct",
                "view_dependent_specular_lobe", "sensor_noise_sigma2",
                "8bit_png_quantization",
            ],
        },
        "patches": int(len(cloud)),
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
            "accuracy_exact_mean": round(float(np.mean(acc)), 4),
            "accuracy_exact_median": round(float(np.median(acc)), 4),
            "accuracy_exact_p95": round(
                float(np.percentile(acc, 95)), 4
            ),
            "accuracy_exact_p99": round(
                float(np.percentile(acc, 99)), 4
            ),
            "completeness_median": round(metrics.completeness_median, 4),
            "completeness_frac_under": round(
                metrics.completeness_frac_under, 4
            ),
            "accuracy_frac_under": round(metrics.accuracy_frac_under, 4),
        },
        "occlusion_filter": forensics,
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
