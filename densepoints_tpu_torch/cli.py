"""`densify` command-line interface of the PyTorch port.

    python -m densepoints_tpu_torch.cli -i scene.json -o cloud.ply \\
        [-s settings.json] [--profile scan] [--ascii] [--device cuda] \\
        [--platform cpu|gpu|cuda] [--mesh mesh.ply] \\
        [--checkpoint-dir DIR [--resume]] [--debug-dir DIR] \\
        [--profile-dir DIR] [--distributed] \\
        [--coordinator HOST:PORT --num-processes N --process-id I] \\
        [--partition replicated|clustered [--halo-threshold T]]

A multi-process job starts one process per rank with the same flags but
`--process-id`; rank 0 alone writes the PLY and the mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from densepoints_tpu_torch.config import PipelineConfig, load_config
from densepoints_tpu_torch.utils import log

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="densify",
        description="PMVS-style multi-view stereo densification (PyTorch)",
    )
    p.add_argument("-i", "--input", required=True, help="scene JSON file")
    p.add_argument("-s", "--settings", help="pipeline config JSON")
    p.add_argument(
        "--profile",
        help="named config preset (config.PROFILES, e.g. 'scan'); "
        "--settings keys override it",
    )
    p.add_argument(
        "-o", "--output", default="cloud.ply", help="output point cloud (.ply)"
    )
    p.add_argument("--ascii", action="store_true", help="write ascii PLY")
    p.add_argument(
        "--device", help="torch device to run on (cuda, the default; cpu)"
    )
    p.add_argument(
        "--platform",
        help="the JAX CLI's backend flag: cpu means --device cpu, gpu or "
        "cuda means --device cuda",
    )
    p.add_argument(
        "--mesh", help="also extract a surface mesh to this path (.ply)"
    )
    p.add_argument(
        "--checkpoint-dir",
        help="write stage-boundary checkpoints here (resume with --resume)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="resume from the latest checkpoint in --checkpoint-dir; "
        "without one a plain run, as in the JAX CLI",
    )
    p.add_argument(
        "--debug-dir",
        help="dump stage artifacts (seed/final clouds, occupancy grids)",
    )
    p.add_argument(
        "--profile-dir",
        help="write a torch.profiler Chrome trace of the run here",
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        help="run densify_multihost over the job's ranks (one rank without "
        "--coordinator); with --coordinator/--num-processes/--process-id, "
        "joins a torch.distributed job first",
    )
    p.add_argument("--coordinator", help="rank 0's host:port of the job")
    p.add_argument(
        "--num-processes", type=int, help="number of processes (ranks)"
    )
    p.add_argument("--process-id", type=int, help="this process's rank")
    p.add_argument(
        "--partition", choices=["replicated", "clustered"],
        default="replicated",
        help="image partitioning: 'replicated' (every rank holds the whole "
        "image stack) or 'clustered' (covisibility view clusters, each rank "
        "holds its cluster's images + halo)",
    )
    p.add_argument(
        "--halo-threshold",
        type=float,
        default=0.25,
        help="clustered partitioning: minimum covisibility for a "
        "non-member view to be held by a cluster's rank",
    )
    return p


# --platform values and the device each means.
_PLATFORM_DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def resolve_device(device: str | None, platform: str | None) -> str:
    """The torch device of `--device` and `--platform`: `platform` maps to
    a device, an explicit `device` of another kind is refused, and neither
    means cuda. There is no fallback to the CPU."""
    if platform is None:
        return device or "cuda"
    mapped = _PLATFORM_DEVICES.get(platform)
    if mapped is None:
        raise ValueError(
            f"--platform {platform!r}: the port runs on "
            f"{' or '.join(_PLATFORM_DEVICES)}; choose the torch device "
            "with --device (cpu or cuda)"
        )
    if device is not None and device.split(":", 1)[0] != mapped:
        raise ValueError(
            f"--platform {platform} means --device {mapped}, but --device "
            f"{device} was given"
        )
    return device or mapped


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, args.platform)
    settings = {}
    if args.settings:
        with open(args.settings) as f:
            settings = json.load(f)
    if args.profile:
        settings["profile"] = args.profile
    config = load_config(settings) if settings else PipelineConfig()
    runtime_overrides = {
        key: value
        for key, value in (
            ("checkpoint_dir", args.checkpoint_dir),
            ("resume", args.resume),
            ("debug_dir", args.debug_dir),
            ("profile_dir", args.profile_dir),
        )
        if value
    }
    if runtime_overrides:
        config = config.replace(
            runtime=dataclasses.replace(config.runtime, **runtime_overrides))

    from densepoints_tpu_torch.parallel import mesh as pmesh

    if args.coordinator or args.num_processes:
        pmesh.initialize_multihost(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=device,
        )
    mesh = pmesh.global_mesh(device)
    if mesh.backend != "none":
        device = mesh.device  # a rank's own: cuda:(rank % device_count)

    from densepoints_tpu_torch.io.scene import load_scene
    from densepoints_tpu_torch.pmvs import pipeline

    scene = load_scene(args.input, device=device)
    log.info("scene: %d views", scene.cameras.num_views)
    if args.partition == "clustered":
        from densepoints_tpu_torch.parallel.clustered import densify_clustered

        result = densify_clustered(
            scene, config, halo_threshold=args.halo_threshold, mesh=mesh
        )
    elif args.distributed or args.coordinator:
        from densepoints_tpu_torch.parallel.multihost import densify_multihost

        result = densify_multihost(scene, config, mesh=mesh)
    else:
        result = pipeline.densify(scene, config, device=device)
    if mesh.rank == 0:
        # Every rank holds the same cloud; one writer per output path.
        _write_outputs(args, config, result, device)
    pmesh.shutdown_multihost()
    return 0


def _write_outputs(args, config, result, device):
    result.save_ply(args.output, binary=not args.ascii)
    log.info("wrote %d points to %s", len(result.positions), args.output)
    if args.mesh:
        from densepoints_tpu_torch.io.ply import write_mesh_ply
        from densepoints_tpu_torch.surface.tsdf import extract_surface

        verts, faces = extract_surface(
            result.positions, result.normals, config.surface, device=device
        )
        write_mesh_ply(args.mesh, verts, faces)
        log.info("wrote mesh with %d vertices / %d faces to %s",
                 len(verts), len(faces), args.mesh)


if __name__ == "__main__":
    sys.exit(main())
