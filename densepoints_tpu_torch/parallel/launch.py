"""One process, every card it sees: the CLI's launcher of a job's ranks.

The JAX package runs one controller per host over all of its chips
(`jax.devices()`); PyTorch runs one process per card. A `--distributed`
run of the CLI bridges the two: the process drives L ranks
(`ranks_per_process`), L the number of cards it sees (on the CPU,
`parallel.num_devices`, at least 1).

  * L = 1: the process is the rank itself and joins the job in place
    (`initialize_multihost`; a job of one rank at a free loopback port
    when no coordinator is given).
  * L > 1: the process starts L children, each `python -m
    densepoints_tpu_torch.cli` with the same arguments, as global ranks
    `process_id * L + i` of a world of `num_processes * L`
    (`launch_ranks`). The parent holds no CUDA context, passes its
    children's output through, waits for them and exits with the first
    non-zero code; when one child fails, it kills the others.

Each child learns its L from `CHILD_ENV`; the rank table of
`initialize_multihost` holds every process of a job to one L. The
in-process API has its own route to L ranks: outside a job `make_mesh(n)`
gives an unstarted mesh of L = `ranks_per_process(device, None, n)` ranks,
and the job-level entry points run their call on it as a job of L
children of `parallel.local_job`.

`run_processes` is the one copy of the start / wait / kill logic of a job
of processes, which `parallel.local_job` and `scripts._jobs.run_ranks`
also run on.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from densepoints_tpu_torch.utils import log

__all__ = [
    "CHILD_ENV",
    "LOOPBACK_ENV",
    "child_env",
    "child_width",
    "free_port",
    "launch_ranks",
    "loopback_address",
    "ranks_per_process",
    "run_processes",
]

# Set in each child of `launch_ranks`: the L of the process that started it.
CHILD_ENV = "DENSEPOINTS_TORCH_RANKS_PER_PROCESS"
# The ranks of a job on one host meet on the loopback interface.
LOOPBACK_ENV = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}
_POLL_S = 0.05
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loopback_address() -> str:
    """A coordinator address on a free loopback port."""
    return f"127.0.0.1:{free_port()}"


def child_env(extra: dict | None = None, loopback: bool = False) -> dict:
    """The environment of a job's child: this process's with `extra`, the
    loopback interface for gloo and NCCL unless set (`loopback`: a job of
    this host alone), and the checkout's root first on PYTHONPATH."""
    env = dict(os.environ, **(extra or {}))
    if loopback:
        for key, value in LOOPBACK_ENV.items():
            env.setdefault(key, value)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_PACKAGE_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def child_width() -> int:
    """The L of the process that started this one (`CHILD_ENV`); 1 for a
    process started by hand."""
    return int(os.environ.get(CHILD_ENV, "1"))


def ranks_per_process(device: str, num_processes: int | None,
                      num_devices: int) -> int:
    """L, the ranks one process drives. On cuda, the cards the process
    sees; when it is the job's only process and `num_devices` N > 0, the
    first min(N, cards) of them (JAX's `make_mesh(N)` takes
    `devices[:N]`). On the CPU, max(1, N). A launched child is one rank.
    Calls no `torch.cuda` API but `device_count()`, so no CUDA context."""
    if CHILD_ENV in os.environ:
        return 1
    if torch.device(device).type != "cuda":
        return max(1, num_devices)
    cards = torch.cuda.device_count()
    if (num_processes or 1) == 1 and num_devices > 0:
        return max(1, min(num_devices, cards))
    return max(1, cards)


def _kill(proc):
    """Kill `proc` and what it started (its own session), if it runs."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _exit_on_term(signum, frame):
    raise SystemExit(128 + signum)


def run_processes(commands, env=None, cwd=None, logs=None,
                  timeout: float | None = None):
    """Start every command of `commands` at once and wait for all of them.
    Each process's output goes to `logs[i]` when given, else to this
    process's own. Returns (first, codes): the index of the first process
    seen to exit non-zero (None when every one exits 0) and every exit
    code. Once one fails, the others are killed (a negative code); past
    `timeout` seconds every process is killed and `TimeoutError` raised.
    No process of the job, nor one it started, is left running, also when
    this process is interrupted or sent SIGTERM."""
    procs = []
    first = None
    t0 = time.monotonic()
    # SIGTERM would end this process without its `finally`: make it an exit.
    main = threading.current_thread() is threading.main_thread()
    saved = signal.signal(signal.SIGTERM, _exit_on_term) if main else None
    try:
        for i, cmd in enumerate(commands):
            if logs is None:
                procs.append(subprocess.Popen(cmd, cwd=cwd, env=env,
                                              start_new_session=True))
                continue
            with open(logs[i], "w") as out:
                procs.append(subprocess.Popen(
                    cmd, cwd=cwd, env=env, stdout=out,
                    stderr=subprocess.STDOUT, start_new_session=True))
        while True:
            codes = [p.poll() for p in procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                first = failed[0]
                break
            if None not in codes:
                break
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"a job of {len(procs)} process(es) outlived its "
                    f"{timeout:g} s")
            time.sleep(_POLL_S)
    finally:
        for p in procs:
            _kill(p)
        for p in procs:
            p.wait()
        if main:
            signal.signal(signal.SIGTERM,
                          signal.SIG_DFL if saved is None else saved)
    return first, [p.returncode for p in procs]


def launch_ranks(argv, width: int, coordinator: str | None,
                 num_processes: int | None, process_id: int | None) -> int:
    """Run `width` children of the CLI with `argv`, as ranks `process_id *
    width + i` of `num_processes * width` at `coordinator` (a free
    loopback port when the process is the job's only one and none is
    given); returns the first non-zero exit code of a child, else 0."""
    nproc = num_processes or 1
    pid = process_id or 0
    env = child_env({CHILD_ENV: str(width)}, loopback=coordinator is None)
    if coordinator is None:
        if nproc != 1:
            raise ValueError(
                f"a job of {nproc} processes needs --coordinator HOST:PORT")
        coordinator = loopback_address()
    world = nproc * width
    log.info("launch: process %d of %d drives ranks %d-%d of %d, "
             "coordinator %s", pid, nproc, pid * width,
             pid * width + width - 1, world, coordinator)
    # argparse keeps the last value of a flag given twice.
    commands = [[sys.executable, "-m", "densepoints_tpu_torch.cli", *argv,
                 "--coordinator", coordinator, "--num-processes", str(world),
                 "--process-id", str(pid * width + i)]
                for i in range(width)]
    first, codes = run_processes(commands, env=env)
    if first is None:
        return 0
    code = codes[first]
    log.error("launch: rank %d exited with %d; the other ranks were "
              "stopped", pid * width + first, code)
    return code if code > 0 else 128 - code
