"""Launch a `densepoints_tpu_torch.parallel` job on the CPU for a test.

`run_job(task, world, inputs, tmp_path)` writes `inputs` to an npz, starts
`world` processes of `tests/torch_parallel_worker.py` on a free local port
(gloo), waits for them within `timeout` seconds (every process is killed
if one exceeds it) and returns each rank's outputs as a dict of arrays.
"""
import itertools
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

WORKER = Path(__file__).with_name("torch_parallel_worker.py")
_jobs = itertools.count()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(task: str, world: int, inputs: dict, tmp_path: Path,
            timeout: float = 240.0) -> list[dict]:
    tag = f"{task}_{world}_{os.getpid()}_{next(_jobs)}"
    src = tmp_path / f"{tag}_in.npz"
    dst = tmp_path / f"{tag}_out"
    np.savez(src, **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), task, str(rank), str(world),
             str(port), str(src), str(dst)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(world)
    ]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            remaining = max(deadline - time.monotonic(), 1.0)
            logs.append(p.communicate(timeout=remaining)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(
            f"{task} with {world} rank(s) exceeded {timeout} s") from None
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (
            f"{task}: rank {rank}/{world} failed ({p.returncode}):\n"
            f"{log[-4000:]}")
    outs = []
    for rank in range(world):
        with np.load(f"{dst}.{rank}.npz", allow_pickle=False) as data:
            outs.append({k: data[k] for k in data.files})
    return outs
