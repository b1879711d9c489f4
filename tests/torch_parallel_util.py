"""Launch a `densepoints_tpu_torch.parallel` job on the CPU for a test.

`run_job(task, world, inputs, tmp_path)` writes `inputs` to an npz, starts
`world` processes of `tests/torch_parallel_worker.py` on a free local port
(gloo) through `densepoints_tpu_torch.scripts._jobs.run_ranks`, waits for
them within `timeout` seconds (every process is killed if one fails or the
job exceeds it) and returns each rank's outputs as a dict of arrays.
"""
import itertools
import os
from pathlib import Path

import numpy as np

from densepoints_tpu_torch.scripts import _jobs

WORKER = "tests.torch_parallel_worker"
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
_jobs_run = itertools.count()


def run_job(task: str, world: int, inputs: dict, tmp_path: Path,
            timeout: float = 240.0) -> list[dict]:
    tag = f"{task}_{os.getpid()}_{next(_jobs_run)}"
    src = tmp_path / f"{tag}_in.npz"
    dst = tmp_path / f"{tag}_out"
    np.savez(src, **inputs)
    _jobs.run_ranks(
        WORKER, world,
        lambda rank, port: [task, rank, world, port, src, dst],
        tmp_path, timeout, env=ONE_THREAD, name=tag)
    outs = []
    for rank in range(world):
        with np.load(f"{dst}.{rank}.npz", allow_pickle=False) as data:
            outs.append({k: data[k] for k in data.files})
    return outs
