"""`densify` command-line interface of the PyTorch port (single host).

    python -m densepoints_tpu_torch.cli -i scene.json -o cloud.ply \\
        [-s settings.json] [--profile scan] [--ascii] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

from densepoints_tpu_torch.config import PipelineConfig, load_config
from densepoints_tpu_torch.utils import log

# Flags of the JAX CLI that the port does not carry yet, with the ROADMAP
# item that brings them.
_NOT_PORTED = {
    "--mesh": "A.11",
    "--checkpoint-dir": "A.9",
    "--resume": "A.9",
    "--debug-dir": "A.9",
    "--profile-dir": "A.9",
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
        "--device", default="cuda", help="torch device to run on (cuda, cpu)"
    )
    p.add_argument(
        "--partition", choices=["replicated", "clustered"],
        default="replicated",
        help="image partitioning; only 'replicated' (one host holding the "
        "whole image stack) is ported",
    )
    return p


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

    from densepoints_tpu_torch.io.scene import load_scene
    from densepoints_tpu_torch.pmvs import pipeline

    scene = load_scene(args.input, device=args.device)
    log.info("scene: %d views", scene.cameras.num_views)
    result = pipeline.densify(scene, config, device=args.device)
    result.save_ply(args.output, binary=not args.ascii)
    log.info("wrote %d points to %s", len(result.positions), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
