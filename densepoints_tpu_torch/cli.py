"""`densify` command-line interface of the PyTorch port (single host).

    python -m densepoints_tpu_torch.cli -i scene.json -o cloud.ply \\
        [-s settings.json] [--profile scan] [--ascii] [--device cuda] \\
        [--platform cpu|gpu|cuda] [--mesh mesh.ply] \\
        [--checkpoint-dir DIR [--resume]] [--debug-dir DIR] \\
        [--profile-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from densepoints_tpu_torch.config import PipelineConfig, load_config
from densepoints_tpu_torch.utils import log

# Flags of the JAX CLI that the port does not carry yet (multi-host and
# multi-device runs), with the ROADMAP item that brings them.
_NOT_PORTED = {
    "--distributed": "A.11",
    "--coordinator": "A.11",
    "--num-processes": "A.11",
    "--process-id": "A.11",
    "--halo-threshold": "A.11",
}


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
        "--partition", choices=["replicated", "clustered"],
        default="replicated",
        help="image partitioning; only 'replicated' (one host holding the "
        "whole image stack) is ported",
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
    argv = sys.argv[1:] if argv is None else list(argv)
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in _NOT_PORTED:
            raise NotImplementedError(
                f"{flag} is not ported to densepoints_tpu_torch yet "
                f"(ROADMAP {_NOT_PORTED[flag]})"
            )
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, args.platform)
    if args.partition == "clustered":
        raise NotImplementedError(
            "--partition clustered is not ported to densepoints_tpu_torch "
            "yet (ROADMAP A.11)"
        )
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

    from densepoints_tpu_torch.io.scene import load_scene
    from densepoints_tpu_torch.pmvs import pipeline

    scene = load_scene(args.input, device=device)
    log.info("scene: %d views", scene.cameras.num_views)
    result = pipeline.densify(scene, config, device=device)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
