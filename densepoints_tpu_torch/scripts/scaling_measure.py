"""Measured multi-process cost of the multi-process driver at a fixed
device total.

    python -m densepoints_tpu_torch.scripts.scaling_measure [--out FILE]
        [--device cuda] [--seeds 2500] [--work-dir DIR] [--config JSON]

Stands for `scripts/scaling_measure.py` of the JAX package: jobs of N =
1, 2 and 4 `scaling_worker` processes on the same workload (9 views of
320 x 240, 2500 sparse seeds, 3 rounds of 40 Nelder-Mead iterations).
The device total is held fixed, as in the JAX design (8 virtual devices
over N processes): on `--device cuda` every rank shares the one card
(gloo, device tensors staged through the host); on `--device cpu` each of
the N ranks takes the config's `total_threads` / N torch threads. The
device term is then the same for every N, and the wall's growth over N = 1
is the cost of distribution: the collectives, the replicated host pulls, the ranks'
coordination and, on one card, their time-slicing of it.

Per N the record gives the job's wall (processes started to all exited),
rank 0's wall, stage seconds and overhead counters, rank 0's patch count,
the K1 launches of all ranks, and the wall delta against N = 1. A worker
that fails, or a job that outlives 1800 s, fails the run after every
worker has been killed (`_jobs.run_ranks`). The workers' records and logs
go to `--work-dir` (default: a fresh temporary directory, removed at the
end). `--out` has no default (the JAX default wrote
SCALING_MEASURED_r05.json into the working directory).
"""
from __future__ import annotations

import argparse
import json
import sys

from densepoints_tpu_torch.scripts import _jobs, _scene_runs, _timing

WORKER = "densepoints_tpu_torch.scripts.scaling_worker"
JOB_TIMEOUT_S = 1800.0  # the JAX program's limit on a job
# The JAX program's jobs and its workers' workload: `nprocs` the process
# counts, `total_threads` the torch threads of all ranks together on the
# CPU. `--config` overrides them.
CONFIG = {"nprocs": [1, 2, 4], "total_threads": 8, "rounds": 3,
          "nm_iters": 40, "views": 9, "width": 320, "height": 240}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, default=2500)
    _scene_runs.config_option(p, CONFIG)
    p.add_argument("--work-dir", default="",
                   help="the workers' records and logs (default: a fresh "
                   "temporary directory)")
    return p.parse_args(argv)


def run_job(args, nproc, work) -> dict:
    """One job of `nproc` workers; returns its row."""
    c = args.config
    workload = {key: c[key] for key in ("rounds", "nm_iters", "views",
                                        "width", "height")}
    workload.update(seeds=args.seeds,
                    threads=max(1, c["total_threads"] // nproc))

    def rank_args(rank, port):
        return ["--rank", rank, "--world", nproc, "--port", port,
                "--out", work / f"worker_{nproc}_{rank}.json",
                "--device", args.device, "--config", json.dumps(workload)]

    job_wall = _jobs.run_ranks(WORKER, nproc, rank_args, work,
                               JOB_TIMEOUT_S)
    ranks = [json.loads((work / f"worker_{nproc}_{r}.json").read_text())
             for r in range(nproc)]
    r0 = ranks[0]
    sync = float(r0["counters"].get("overhead_host_sync_s", 0.0))
    return {
        "nproc": nproc,
        "threads_per_rank": r0["threads"],
        "backend": r0["backend"],
        "job_wall_seconds": job_wall,
        "wall_seconds": r0["wall_seconds"],
        "expand_seconds": r0["stage_seconds"].get("expand"),
        "stage_seconds": r0["stage_seconds"],
        "counters": r0["counters"],
        "host_sync_seconds_total": sync,
        "host_sync_per_round": sync / max(c["rounds"], 1),
        "patches_after_expand": r0["counters"].get("patches_after_expand"),
        "patches_final": r0["patches"],
        "patches_per_rank": [r["patches"] for r in ranks],
        **_timing.summed(ranks),
    }


def run(args) -> dict:
    """The program's run; returns its record."""
    device = _timing.run_device(args.device)
    rows = []
    with _scene_runs.work_dir(args.work_dir, "scaling_measure_") as work:
        for nproc in args.config["nprocs"]:
            rows.append(run_job(args, nproc, work))
            print(nproc, json.dumps(rows[-1]), flush=True)
    base = rows[0]
    for row in rows:
        row["fixed_cost_vs_first_seconds"] = (row["wall_seconds"]
                                              - base["wall_seconds"])
        row["job_wall_vs_first_seconds"] = (row["job_wall_seconds"]
                                            - base["job_wall_seconds"])
    return {
        "program": "scaling_measure",
        "device": _scene_runs.device_label(device),
        "protocol": (
            "fixed device total, fixed workload; the process count varies, "
            "so the device term is constant and the wall's growth over the "
            "first job is the cost of distribution. On a card every rank "
            "shares the one device; on the CPU the ranks share "
            f"{args.config['total_threads']} torch threads."),
        "scene": {"views": args.config["views"],
                  "image": [args.config["height"], args.config["width"]],
                  "seeds": args.seeds},
        "rounds": args.config["rounds"],
        "measured": rows,
        **_timing.summed(rows),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
