"""One rank of a `scaling_measure` job: the multi-process driver on a
fixed workload.

    python -m densepoints_tpu_torch.scripts.scaling_worker --rank R
        --world N --port P --out FILE [--device cuda] [--config JSON]

Stands for `scripts/scaling_worker.py` of the JAX package, with its
workload: `TexturedPlaneScene` (`default_rng(0)`, 9 views of 320 x 240),
a sparse grid of 2500 seeds over +-0.7 of the plane, 3 expansion rounds of
40 Nelder-Mead iterations, `parallel.multihost.densify_multihost` after
`parallel.mesh.initialize_multihost` (127.0.0.1:P, gloo between ranks that
share a device). The device total is fixed whatever N is: on `--device
cuda` every rank runs on the one card, on `--device cpu` each rank takes
the config's `threads` torch threads (the caller gives total / N), as the
JAX worker took 8 / N virtual devices. Writes its record (wall, stage seconds,
overhead counters, patches, launches) to `--out`.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from densepoints_tpu_torch.scripts import _scene_runs, _timing

# The JAX worker's workload; `threads` is this rank's torch threads on the
# CPU (0: torch's default). `--config` overrides them.
CONFIG = {"seeds": 2500, "rounds": 3, "nm_iters": 40, "views": 9,
          "width": 320, "height": 240, "threads": 0}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    _scene_runs.config_option(p, CONFIG)
    return p.parse_args(argv)


def sparse_seeds(n: int) -> np.ndarray:
    """`n` seeds taken with a stride from a grid over +-0.7 of the plane,
    so that most occupancy cells stay free and every round has a frontier
    (`scripts/scaling_worker.py:54-64`), f32."""
    g = np.linspace(-0.7, 0.7, int(np.ceil(np.sqrt(n))))
    gx, gy = np.meshgrid(g, g)
    step = max(1, gx.size // n)
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], 1)[
        ::step][:n].astype(np.float32)


def run(args) -> dict:
    """This rank's run; returns its record."""
    import torch

    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.parallel.mesh import (
        global_mesh,
        initialize_multihost,
        shutdown_multihost,
    )
    from densepoints_tpu_torch.parallel.multihost import densify_multihost
    from densepoints_tpu_torch.scripts.scaling_overhead import plane_scene

    device = _timing.run_device(args.device)
    c = args.config
    if device.type == "cpu" and c["threads"] > 0:
        torch.set_num_threads(c["threads"])
    initialize_multihost(f"127.0.0.1:{args.port}", args.world, args.rank,
                         device=device.type)
    try:
        mesh = global_mesh()
        scene = plane_scene(c["views"], c["width"], c["height"])
        cfg = load_config({"expand": {"max_rounds": c["rounds"]},
                           "optimize": {"max_iterations": c["nm_iters"]}})
        counter = _timing.Counts(mesh.device)
        res, wall = _timing.host_seconds(
            lambda: densify_multihost(scene, cfg,
                                      seed_points=sparse_seeds(c["seeds"])),
            mesh.device)
        record = {
            "rank": args.rank, "nproc": args.world,
            "backend": mesh.backend, "device": str(mesh.device),
            "threads": torch.get_num_threads(),
            "wall_seconds": wall,
            "stage_seconds": dict(res.metrics.times),
            "counters": {k: float(v)
                         for k, v in res.metrics.counters.items()},
            "patches": res.patches.capacity,
            **counter.read(),
        }
    finally:
        shutdown_multihost()
    print(f"worker {args.rank}/{args.world}: {record['patches']} patches "
          f"in {wall:.1f}s", flush=True)
    return record


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
