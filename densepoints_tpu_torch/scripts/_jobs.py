"""Jobs of several processes: one process per rank of a `python -m` module
of the checkout (the scaling programs' workers, `chip_smoke.py`'s ranks, the
tests' parallel worker), on a free local port, each logging to a file of
the job's directory. A rank that fails, or a job that outlives its time
limit, fails the job after every process of it has been killed."""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

from densepoints_tpu_torch.parallel.launch import (
    LOOPBACK_ENV,
    free_port,
    run_processes,
)
from densepoints_tpu_torch.scripts._scene_runs import REPO


def rank_log(work: Path, name: str, world: int, rank: int) -> Path:
    """The file that holds the output of rank `rank` of job `name`."""
    return work / f"{name}_{world}_{rank}.log"


def run_ranks(module: str, world: int, rank_args, work: Path,
              timeout: float, env: dict | None = None,
              name: str = "") -> float:
    """Run `world` processes of `python -m module *rank_args(rank, port)`
    in `work`, each rank's output in `rank_log(work, name, world, rank)`
    (`name` defaults to the module's last part), and wait for all of them
    (`parallel.launch.run_processes`); returns the job's wall seconds.
    Raises `RuntimeError` with the failing rank's log when a rank exits
    non-zero or the job outlives `timeout` seconds; no process is left
    running."""
    port = free_port()
    penv = dict(os.environ, **LOOPBACK_ENV, **(env or {}))
    penv["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    logs = [rank_log(work, name or module.rsplit(".", 1)[-1], world, rank)
            for rank in range(world)]
    commands = [[sys.executable, "-m", module,
                 *map(str, rank_args(rank, port))] for rank in range(world)]
    t0 = time.perf_counter()
    try:
        failed, codes = run_processes(commands, env=penv, cwd=str(work),
                                      logs=logs, timeout=timeout)
    except TimeoutError:
        raise RuntimeError(f"{module}: a job of {world} rank(s) outlived "
                           f"its {timeout:g} s") from None
    if failed is not None:
        tail = Path(logs[failed]).read_text()[-4000:]
        raise RuntimeError(f"{module}: rank {failed}/{world} failed "
                           f"({codes[failed]}):\n{tail}")
    return time.perf_counter() - t0
