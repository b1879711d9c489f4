"""A cell of several cards: one job of ranks, started once in set-up.

`run_job`, in the process that `run.py` runs, builds the kernels once,
then starts the cell's `chips` ranks at once, one process a card
(`densepoints_tpu_torch.parallel.launch.run_processes`, the program's one
copy of the start, wait and kill logic), which meet on a free loopback
port. Rank i joins with `parallel.mesh.initialize_multihost(...,
ranks_per_process=chips)`, so it drives card i and the job's collectives
run over NCCL between the distinct cards (gloo on the CPU). Every rank
then runs the harness's steps with `densify_multihost(scene, config,
mesh)`, the mesh being the job's:

  * set-up (`harness.set_up`): the warm-up call, then the capture pool
    rendered on the rank's own card from the same seed and keys; the
    ranks check once that they hold the same captures (a sum of the
    images' bits, its least and largest over the job);
  * the window (`harness.measure`): every rank calls `densify_multihost`
    on the same scenes in the same order. Before each scene rank 0 alone
    decides whether time remains and broadcasts the decision, one int32
    over the job's gloo group, outside the `bench/scene` span;
  * after it: the largest of the ranks' memory peaks is kept, the job is
    left, and rank 0 alone judges the clouds (`harness.report`) and
    writes the result, which `run_job` hands back to be printed.

`setup_s`, `scene_s` and `patches_per_s` are read on rank 0's clock;
`setup_s` counts from the start of `run.py`'s process (`perf_counter` is
the host's monotonic clock, one for every process). `--trace 1` profiles
rank 0 alone, its card, its spans and its counters; the other ranks run
untraced. Every rank reports the modules of JAX or of the JAX package it
has loaded. A rank that fails ends the job: the others are killed and
`run_job` raises with that rank's traceback. No rank outlives the run:
`run_processes` kills every rank when one fails, at the job's timeout and
when `run.py` is interrupted or sent SIGTERM, and a rank dies with
`run.py` if that is killed outright (Linux's PR_SET_PDEATHSIG).

    python3 benchmark/ranks.py WORK ADDRESS WORLD RANK DEVICE

runs one rank; only `run_job` starts it.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# A job outliving this is killed: under the 1200 s that a checkout's first
# run, which builds and compiles, may take.
JOB_TIMEOUT_S = 1100.0
PR_SET_PDEATHSIG = 1
_JOB = "job.json"
_RESULT = "result.json"
_TAIL = 8000


def run_job(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_process: float, bench_dir: Path = harness.BENCH_DIR,
            mode: str = "sound"):
    """One run of `cell` as a job of `cell["chips"]` ranks on `device`'s
    kind; returns (result, checks, the JAX modules any rank loaded).
    `mode` names the context of `control.MODES` that every rank enters
    around its window."""
    import torch
    from densepoints_tpu_torch.parallel import launch

    world = cell["chips"]
    if torch.device(device).type == "cuda":
        from densepoints_tpu_torch.ops import _build

        _build.build_library()
    with tempfile.TemporaryDirectory(prefix="bench_ranks_") as tmp:
        work = Path(tmp)
        (work / _JOB).write_text(json.dumps({
            "cell": cell["name"], "bench_dir": str(bench_dir), "seed": seed,
            "seconds": seconds, "trace": trace, "t_process": t_process,
            "mode": mode, "parent": os.getpid()}))
        address = launch.loopback_address()
        commands = [[sys.executable, str(Path(__file__).resolve()),
                     str(work), address, str(world), str(rank),
                     torch.device(device).type] for rank in range(world)]
        # The environment the program's own job launcher gives its ranks
        # (`parallel/local_job.py`): on the CPU they share this process's
        # threads, on cards they are left as they start.
        env = launch.child_env(loopback=True)
        if torch.device(device).type == "cpu":
            env.setdefault("OMP_NUM_THREADS",
                           str(max(1, torch.get_num_threads() // world)))
        logs = [work / f"rank{rank}.log" for rank in range(world)]
        try:
            first, codes = launch.run_processes(commands, env=env, logs=logs,
                                                timeout=JOB_TIMEOUT_S)
        except TimeoutError as exc:
            raise TimeoutError(f"{cell['name']}: {exc}; every rank was "
                               f"killed. Rank 0's log ends:\n"
                               f"{_tail(logs[0])}") from None
        if first is not None:
            raise RuntimeError(_failure(cell["name"], work, logs, first,
                                        codes))
        sys.stderr.write(logs[0].read_text())
        sys.stderr.flush()
        out = json.loads((work / _RESULT).read_text())
        loaded = sorted({name for rank in range(world) for name in json.loads(
            (work / f"rank{rank}.json").read_text())["loaded"]})
    return out["result"], out["checks"], loaded


def _tail(path: Path) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-_TAIL:]


def _failure(name, work: Path, logs, first: int, codes) -> str:
    """The program's message of a failed job (`local_job._failure`: the
    rank that raised first, with its traceback), and the end of the log
    of the first rank seen to exit where no rank wrote a traceback."""
    from densepoints_tpu_torch.parallel import local_job

    message = local_job._failure(name, work, len(logs), first, codes)
    if any((work / f"error.{rank}.json").exists()
           for rank in range(len(logs))):
        return message
    return f"{message}rank {first}'s log ends:\n{_tail(logs[first])}"


def _die_with(parent: int):
    """End this rank when the process that started it ends, however it
    ends; exit at once if it has ended already."""
    import ctypes
    import signal

    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):  # not Linux: run_processes' kill
        return
    prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
    prctl.restype = ctypes.c_int
    prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:
        sys.exit(f"rank: the process that started it ({parent}) is gone")


def _same_captures(pool):
    """Raise unless every rank holds the same captures: the sum of each
    image stack's bits, its least and its largest over the job."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sums = torch.tensor([int(s.images.view(np.int32).sum(dtype=np.int64))
                         for s in pool], dtype=torch.int64)
    lo, hi = sums.clone(), sums.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if not torch.equal(lo, hi):
        raise RuntimeError(
            f"the ranks rendered different captures: image sums from "
            f"{lo.tolist()} to {hi.tolist()}")


def _rank0_decides(more: bool) -> bool:
    """Rank 0's `more`, on every rank."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(more)], dtype=torch.int32)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def _run_rank(work: Path, job: dict, address: str, world: int, rank: int,
              device: str):
    import torch
    import torch.distributed as dist
    from densepoints_tpu_torch.parallel import mesh as pmesh
    from densepoints_tpu_torch.parallel.multihost import densify_multihost

    from benchmark import control

    bench_dir = Path(job["bench_dir"])
    cell = harness.load_cell(job["cell"], bench_dir)
    pmesh.initialize_multihost(address, world, rank, device=device,
                               ranks_per_process=world)
    mesh = pmesh.global_mesh()
    dev = mesh.device
    trace = bool(job["trace"]) and rank == 0

    def call(scene, config):
        return densify_multihost(scene, config, mesh)

    geo, config, pool, t_warm = harness.set_up(cell, job["seed"], dev, call)
    _same_captures(pool)
    dist.barrier()  # the window starts once every rank is set up
    win = harness.measure(pool, config, call, job["seconds"], trace, dev,
                          job["t_process"], t_warm,
                          control.MODES[job["mode"]], go=_rank0_decides)
    peak = torch.tensor([harness.peak_bytes(dev)], dtype=torch.int64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    del pool
    pmesh.shutdown_multihost()
    harness.release(dev)
    if rank == 0:
        result, checks = harness.report(
            cell, geo, win, trace, dev, harness.metric_readers(bench_dir),
            int(peak), count=world)
        (work / _RESULT).write_text(json.dumps({"result": result,
                                                "checks": checks}))
    (work / f"rank{rank}.json").write_text(json.dumps(
        {"loaded": harness.forbidden_modules(sys.modules)}))


def main(argv) -> int:
    """One rank: join the job, run the cell's steps, write what it gives;
    on a failure, its traceback, then leave the job at once."""
    work, address, world, rank, device = argv
    work, world, rank = Path(work), int(world), int(rank)
    job = json.loads((work / _JOB).read_text())
    _die_with(job["parent"])
    try:
        _run_rank(work, job, address, world, rank, device)
    except BaseException:
        (work / f"error.{rank}.json").write_text(json.dumps({
            "time": time.time(), "traceback": traceback.format_exc()}))
        from densepoints_tpu_torch.parallel import mesh as pmesh

        pmesh.abort_multihost()
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
