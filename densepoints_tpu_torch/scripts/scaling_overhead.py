"""Distribution overhead of the multi-process driver per expansion round,
measured on one card, and the model of N-host efficiency built on it.

    python -m densepoints_tpu_torch.scripts.scaling_overhead [--out FILE]
        [--device cuda] [--seeds 50000] [--rounds 3] [--nm-iters 60]
        [--link-bytes-per-s 12.5e9] [--config JSON]

Stands for `scripts/scaling_overhead.py` of the JAX package, with its
workload: `TexturedPlaneScene` (`default_rng(0)`, 9 views of 640 x 480),
50,000 seeds on a grid over +-0.75 of the plane, 3 expansion rounds of 60
Nelder-Mead iterations, `parallel.multihost.densify_multihost` with
`seed_points` on a mesh of one rank (`parallel.mesh.make_mesh(1)`). The
driver's `_Overhead` counts what the rounds pull to the host, the host
synchronisation seconds and the bytes, calls and seconds of the
collectives. From them, per round (`overhead_model`, the JAX program's
arithmetic):
    device seconds  t_d = (expand s - host sync s) / rounds
    fixed seconds   t_f = host sync s / rounds
                          + collective bytes / rounds / link bytes per s
    eff(N) = t_d / (t_d + N t_f)          (N = 2, 4, 8)
Device work is patch-parallel and scales as 1/N; the fixed cost does not.

The link rate is a model input, not a measurement: `--link-bytes-per-s`
(default 12.5e9 B/s, the JAX program's figure for a data-centre network
between hosts) is an assumed inter-host link. `--out` has no default (the
JAX default wrote SCALING_r03.json into the working directory);
`--device` (default cuda) picks the device, `cpu` the plain paths.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from densepoints_tpu_torch.scripts import _scene_runs, _timing

LINK_BYTES_PER_S = 12.5e9  # assumed inter-host link, a model input
# The JAX program's scene; `--config` overrides it.
CONFIG = {"views": 9, "width": 640, "height": 480}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, default=50_000)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--nm-iters", type=int, default=60)
    p.add_argument("--link-bytes-per-s", type=float,
                   default=LINK_BYTES_PER_S,
                   help="assumed inter-host link rate (a model input)")
    _scene_runs.config_option(p, CONFIG)
    return p.parse_args(argv)


def grid_seeds(n: int) -> np.ndarray:
    """`n` seeds on a square grid over +-0.75 of the plane z = 0, f32."""
    side = int(np.ceil(np.sqrt(n)))
    g = np.linspace(-0.75, 0.75, side)
    gx, gy = np.meshgrid(g, g)
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)],
                    1).astype(np.float32)[:n]


def plane_scene(views, width, height):
    """`TexturedPlaneScene` (`default_rng(0)`) as the port's Scene, with
    its cameras on the CPU (the driver moves them to its device)."""
    from densepoints_tpu_torch.core.cameras import Cameras
    from densepoints_tpu_torch.io.scene import Scene

    sc = _scene_runs.synthetic().TexturedPlaneScene(
        np.random.default_rng(0), num_views=views, width=width,
        height=height)
    cams = Cameras.from_projection_matrices(sc.P, widths=sc.width,
                                            heights=sc.height)
    return Scene(cameras=cams, images=sc.render_all(), colors=None)


def overhead_model(times: dict, counters: dict, rounds: int,
                   link_bytes_per_s: float) -> dict:
    """Per-round device and fixed seconds and the model's eff(N) from a
    run's stage seconds and `_Overhead` counters."""
    rounds = max(rounds, 1)
    host_sync = float(counters.get("overhead_host_sync_s", 0.0))
    coll_bytes = int(counters.get("overhead_collective_bytes", 0))
    t_expand = float(times.get("expand", 0.0))
    t_device = max(t_expand - host_sync, 1e-9) / rounds
    t_link = coll_bytes / rounds / link_bytes_per_s
    t_fixed = host_sync / rounds + t_link

    def eff(n):
        return t_device / (t_device + n * t_fixed)

    return {
        "per_round": {
            "device_seconds": t_device,
            "fixed_seconds": t_fixed,
            "host_sync_seconds": host_sync / rounds,
            "host_bytes": int(counters.get("overhead_host_bytes", 0))
            // rounds,
            "collective_bytes": coll_bytes // rounds,
            "collective_seconds_at_link": t_link,
        },
        "predicted_efficiency": {f"{n}_hosts": eff(n) for n in (2, 4, 8)},
    }


def run(args) -> dict:
    """The program's run; returns its record."""
    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.parallel.mesh import make_mesh
    from densepoints_tpu_torch.parallel.multihost import densify_multihost

    device = _timing.run_device(args.device)
    c = args.config
    scene = plane_scene(c["views"], c["width"], c["height"])
    seeds = grid_seeds(args.seeds)
    cfg = load_config({"expand": {"max_rounds": args.rounds},
                       "optimize": {"max_iterations": args.nm_iters}})
    mesh = make_mesh(1, device=device)
    counter = _timing.Counts(device)
    res, wall = _timing.host_seconds(
        lambda: densify_multihost(scene, cfg, mesh=mesh, seed_points=seeds),
        device)
    m = res.metrics
    return {
        "program": "scaling_overhead",
        "device": _scene_runs.device_label(device),
        "mesh_ranks": mesh.world_size,
        "scene": {"views": c["views"], "image": [c["height"], c["width"]],
                  "seeds": args.seeds},
        "config": {"expand_rounds": args.rounds,
                   "nm_iterations": args.nm_iters},
        "wall_seconds": wall,
        "stage_seconds": dict(m.times),
        "counters": {k: float(v) for k, v in m.counters.items()},
        "patches": res.patches.capacity,
        "model": {
            "link_bytes_per_s": args.link_bytes_per_s,
            "link_note": "an assumed inter-host link rate, a model input "
                         "and not a measurement",
            **overhead_model(m.times, m.counters, args.rounds,
                             args.link_bytes_per_s),
        },
        **counter.read(),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
