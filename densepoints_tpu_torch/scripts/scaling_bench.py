"""Refine throughput of the distributed refine step at N ranks.

    python -m densepoints_tpu_torch.scripts.scaling_bench [--out FILE]
        [--device cuda] [--ranks 1,2,...] [--work-dir DIR] [--config JSON]

Stands for `scripts/scaling_bench.py` of the JAX package, with its
workload (`_rigs.plane_problem`: 8 views of 240 x 320, 4096 plane patches,
`default_rng(0)`) and step: `parallel.distributed.distributed_refine_step`
(Nelder-Mead of 20 iterations, visibility, the NCC filter; k = 11), each
rank refining its row block and one `all_gather` making the result
replicated. For each N of `--ranks` (default: the powers of two up to the
number of CUDA cards, on a CPU `1`) a job of N processes runs the step once
to warm up and once timed, the positions moved by 1e-4 (the JAX program's
compile call and timed call), on the host's clock between two device
synchronisations; the record gives patches per second per N. Ranks take
cuda:(rank % cards), so N ranks are on distinct devices only while N is
at most the number of cards; the scaling efficiency is recorded only when
more than one N ran on distinct devices, and is null otherwise (on one
card, and on the CPU, where ranks share the threads).

`--out` has no default; `--work-dir` (default: a fresh temporary
directory) holds the ranks' records, logs and rank 0's refined positions
(`refined_<N>.npy`). A rank runs `--rank R --world N --port P`.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from densepoints_tpu_torch.scripts import _jobs, _rigs, _scene_runs, _timing

MODULE = "densepoints_tpu_torch.scripts.scaling_bench"
TEXTURE = 11
JOB_TIMEOUT_S = 900.0
# The JAX program's problem; `threads` is each rank's torch threads on the
# CPU (0: torch's default). `--config` overrides them.
CONFIG = {"patches": 4096, "nm_iters": 20, "views": 8, "width": 320,
          "height": 240, "threads": 0}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", default="",
                   help="rank counts, comma-separated (default: powers of "
                   "two up to the number of CUDA cards)")
    p.add_argument("--work-dir", default="")
    _scene_runs.config_option(p, CONFIG)
    # One rank of a job (set by the program for its processes).
    p.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def rank_counts(spec: str, device) -> list[int]:
    if spec:
        return [int(n) for n in spec.split(",")]
    import torch

    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    return [n for n in (1, 2, 4, 8, 16) if n <= max(cards, 1)]


def problem(c, device):
    """(images, cameras, state) of the workload `c` on `device`."""
    from densepoints_tpu_torch.pmvs.patch import PatchState

    cams, images, pos, nrm, ref, vis = _rigs.to_device(
        device, *_rigs.plane_problem(c["patches"], c["views"], c["height"],
                                     c["width"]))
    return images, cams, PatchState.create(pos, nrm, ref, vis)


def rank_run(args) -> dict:
    """One rank's run: warm-up step, timed step; rank 0 keeps its refined
    positions."""
    import dataclasses

    import torch

    from densepoints_tpu_torch.config import OptimizeConfig
    from densepoints_tpu_torch.parallel.distributed import (
        distributed_refine_step,
    )
    from densepoints_tpu_torch.parallel.mesh import (
        global_mesh,
        initialize_multihost,
        shutdown_multihost,
    )

    device = _timing.run_device(args.device)
    c = args.config
    if device.type == "cpu" and c["threads"] > 0:
        torch.set_num_threads(c["threads"])
    initialize_multihost(f"127.0.0.1:{args.port}", args.world, args.rank,
                         device=device.type)
    try:
        mesh = global_mesh()
        images, cams, state = problem(c, mesh.device)
        cfg = OptimizeConfig(max_iterations=c["nm_iters"])
        counter = _timing.Counts(mesh.device)

        def step(shift):
            moved = dataclasses.replace(state,
                                        position=state.position + shift)
            return distributed_refine_step(images, cams, moved, TEXTURE,
                                           cfg, mesh)

        step(0.0)
        out, seconds = _timing.host_seconds(lambda: step(1e-4), mesh.device)
        record = {"rank": args.rank, "world": args.world,
                  "backend": mesh.backend, "device": str(mesh.device),
                  "seconds": seconds, "alive": int(out.alive.sum()),
                  **counter.read()}
        if args.rank == 0:
            np.save(Path(args.out).with_name(f"refined_{args.world}.npy"),
                    out.position.cpu().numpy())
    finally:
        shutdown_multihost()
    return record


def run(args) -> dict:
    """The program's run; returns its record."""
    import torch

    device = _timing.run_device(args.device)
    c = args.config
    counts = rank_counts(args.ranks, device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    rows = []
    with _scene_runs.work_dir(args.work_dir, "scaling_bench_") as work:
        for n in counts:
            def rank_args(rank, port, n=n):
                return ["--rank", rank, "--world", n, "--port", port,
                        "--out", work / f"rank_{n}_{rank}.json",
                        "--device", args.device,
                        "--config", json.dumps(c)]

            _jobs.run_ranks(MODULE, n, rank_args, work, JOB_TIMEOUT_S)
            ranks = [json.loads((work / f"rank_{n}_{r}.json").read_text())
                     for r in range(n)]
            seconds = max(r["seconds"] for r in ranks)
            rows.append({
                "ranks": n, "backend": ranks[0]["backend"],
                "devices": sorted({r["device"] for r in ranks}),
                "seconds": seconds,
                "patches_per_sec": c["patches"] / seconds,
                "alive": ranks[0]["alive"],
                **_timing.summed(ranks),
            })
            print(json.dumps(rows[-1]), flush=True)
    distinct = [r for r in rows if r["ranks"] <= cards]
    efficiency = None
    if len(distinct) > 1:
        base, top = distinct[0], distinct[-1]
        efficiency = {
            "from_ranks": base["ranks"], "to_ranks": top["ranks"],
            "value": top["patches_per_sec"]
            / (base["patches_per_sec"] * top["ranks"] / base["ranks"]),
        }
    return {
        "program": "scaling_bench",
        "device": _scene_runs.device_label(device),
        "cards": cards,
        "problem": {"patches": c["patches"], "views": c["views"],
                    "image": [c["height"], c["width"]],
                    "nm_iterations": c["nm_iters"], "texture": TEXTURE},
        "measured": rows,
        "scaling_efficiency": efficiency,
        "efficiency_note": (
            "recorded only when more than one rank count ran on distinct "
            "devices" if efficiency is None else "distinct devices"),
        **_timing.summed(rows),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    record = rank_run(args) if args.rank >= 0 else run(args)
    _scene_runs.emit(record, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
