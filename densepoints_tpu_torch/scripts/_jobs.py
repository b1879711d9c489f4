"""Jobs of several processes: one process per rank of a `python -m` module
of the checkout (the scaling programs' workers, `chip_smoke.py`'s ranks, the
tests' parallel worker), on a free local port, each logging to a file of
the job's directory. A rank that fails, or a job that outlives its time
limit, fails the job after every process of it has been killed."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from densepoints_tpu_torch.scripts._scene_runs import REPO

# The ranks meet on the loopback interface.
LOOPBACK_ENV = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_log(work: Path, name: str, world: int, rank: int) -> Path:
    """The file that holds the output of rank `rank` of job `name`."""
    return work / f"{name}_{world}_{rank}.log"


def run_ranks(module: str, world: int, rank_args, work: Path,
              timeout: float, env: dict | None = None,
              name: str = "") -> float:
    """Run `world` processes of `python -m module *rank_args(rank, port)`
    in `work`, each rank's output in `rank_log(work, name, world, rank)`
    (`name` defaults to the module's last part), and wait for all of them;
    returns the job's wall seconds. Raises `RuntimeError` with the failing
    rank's log when a rank exits non-zero or the job outlives `timeout`
    seconds; no process is left running."""
    port = free_port()
    penv = dict(os.environ, **LOOPBACK_ENV, **(env or {}))
    penv["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    logs = [rank_log(work, name or module.rsplit(".", 1)[-1], world, rank)
            for rank in range(world)]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(world):
            with open(logs[rank], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module,
                     *map(str, rank_args(rank, port))],
                    cwd=str(work), env=penv, stdout=log,
                    stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(module, world, failed[0],
                                            procs, logs))
            if time.perf_counter() - t0 > timeout:
                raise RuntimeError(
                    f"{module}: a job of {world} rank(s) outlived its "
                    f"{timeout:g} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(_failure(module, world, failed[0], procs,
                                        logs))
        return time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def _failure(module, world, rank, procs, logs) -> str:
    tail = Path(logs[rank]).read_text()[-4000:]
    return (f"{module}: rank {rank}/{world} failed "
            f"({procs[rank].returncode}):\n{tail}")
