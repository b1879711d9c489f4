"""A/B of the expansion pre-screen (`expand.prescreen`): claim, free, off.

    python -m densepoints_tpu_torch.scripts.prescreen_ab [--out FILE]
        [--device cuda] [--config JSON]

Stands for `scripts/prescreen_ab.py` of the JAX package, with its scene,
seeds and config: the bench e2e sphere and seeds of `expand_profile` (12
views of 512 x 384, 3000 seeds uniform on the sphere), the `scan` profile
with 4 rounds of 40 Nelder-Mead iterations, 120 seed iterations and
grid_scale 4. Per mode two runs, first with the seeds as they are, then
moved by 1e-4 (cold, then warm): seeds -> NCC filter -> compaction ->
Nelder-Mead -> `pmvs.pipeline._densify_from(..., "seeds_optimized")`
(expansion, filters), each on the host's clock between two device
synchronisations. The record gives per mode the cold and warm seconds,
the patches after expansion, the final patches, patches per second and the
stage seconds of the warm run, and the K1 launches of the mode's two runs.

Departures from the JAX program:
  * `--out` has no default and nothing is written without it: the JAX
    program wrote PRESCREEN_r05.json into the repo's root.
  * `--device` (default cuda) picks the device; `cpu` runs the plain
    scoring paths. The record names the card and its power limit.
"""
from __future__ import annotations

import argparse
import sys

import torch

from densepoints_tpu_torch.scripts import _rigs, _scene_runs, _timing

MODES = ("claim", "free", "off")


# The JAX program's scene and config; `--config` overrides them.
CONFIG = {"seeds": 3000, "views": _rigs.SPHERE["num_views"],
          "width": _rigs.SPHERE["width"], "height": _rigs.SPHERE["height"],
          "focal": _rigs.SPHERE["focal"],
          "tex_size": _rigs.SPHERE["tex_size"], "max_rounds": 4,
          "nm_iters": 120, "expand_nm_iters": 40}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    _scene_runs.config_option(p, CONFIG)
    return p.parse_args(argv)


def config_dict(c, mode) -> dict:
    return {
        **_rigs.SPHERE_CONFIG,
        "expand": {"max_rounds": c["max_rounds"],
                   "max_iterations": c["expand_nm_iters"],
                   "prescreen": mode},
        "optimize": {"max_iterations": c["nm_iters"]},
    }


def densify_from_seeds(images, cams, scene, cfg, seeds):
    """Seeds -> NCC filter -> compaction -> Nelder-Mead -> `_densify_from`
    from `seeds_optimized`; returns (result, metrics)."""
    from densepoints_tpu_torch.pmvs.optimize import (
        filter_by_error,
        optimize_patches,
    )
    from densepoints_tpu_torch.pmvs.pipeline import _densify_from
    from densepoints_tpu_torch.pmvs.seed import create_patches_from_points
    from densepoints_tpu_torch.utils import StageMetrics

    device = images.device
    st = create_patches_from_points(cams, seeds, cfg.optimize, cfg.seed)
    st = filter_by_error(images, cams, st, cfg.seed.texture_size,
                         cfg.optimize).compact()
    st = optimize_patches(images, cams, st, cfg.seed.texture_size,
                          cfg.optimize)
    metrics = StageMetrics(sync=lambda: _timing.sync(device))
    res = _densify_from(images, cams, scene, cfg, metrics, st,
                        "seeds_optimized")
    return res, metrics


def run(args) -> dict:
    """The program's run; returns its record."""
    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.core.cameras import Cameras
    from densepoints_tpu_torch.io.scene import Scene
    from densepoints_tpu_torch.ops import allview_ncc

    device = _timing.run_device(args.device)
    c = args.config
    scene_gen, images_np = _rigs.sphere_scene(
        num_views=c["views"], width=c["width"], height=c["height"],
        focal=c["focal"], tex_size=c["tex_size"])
    cams = Cameras.from_projection_matrices(
        scene_gen.P, widths=c["width"], heights=c["height"], device=device)
    scene = Scene(cameras=cams, images=images_np, colors=None)
    images = torch.as_tensor(images_np, device=device)
    seeds = _rigs.sphere_seeds(c["seeds"], _rigs.SPHERE["radius"])
    counter = _timing.Counts(device)
    modes = {}
    for mode in MODES:
        cfg = load_config(config_dict(c, mode))
        k1 = allview_ncc.KERNEL_LAUNCHES
        (_, _), cold = _timing.host_seconds(
            lambda: densify_from_seeds(images, cams, scene, cfg, seeds),
            device)
        (res, metrics), warm = _timing.host_seconds(
            lambda: densify_from_seeds(images, cams, scene, cfg,
                                       seeds + 1e-4),
            device)
        final = res.patches.capacity
        modes[mode] = {
            "densify_seconds_cold": cold,
            "densify_seconds_warm": warm,
            "patches_after_expand": int(
                metrics.counters["patches_after_expand"]),
            "patches_final": final,
            "e2e_patches_per_sec": final / warm,
            "stage_seconds": dict(metrics.times),
            "allview_ncc_launches": allview_ncc.KERNEL_LAUNCHES - k1,
        }
        print(mode, modes[mode], flush=True)
    return {
        "program": "prescreen_ab",
        "device": _scene_runs.device_label(device),
        "scene": {"views": c["views"], "image": [c["height"], c["width"]],
                  "focal": c["focal"], "seeds": c["seeds"],
                  "grid_scale": 4},
        "modes": modes,
        **counter.read(),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
