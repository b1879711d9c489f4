"""One call over several ranks from one Python process: the job that a
job-level entry point starts for an unstarted mesh.

JAX runs `densify_distributed(scene, config, mesh=make_mesh(n))` from one
controller over n devices. PyTorch runs one process per rank, so outside
a job `make_mesh(n)` gives an unstarted mesh of L ranks (backend "local",
`parallel/mesh.py`), and the four entry points that the JAX package calls
in-process with such a mesh (`mesh.ENTRY_POINTS`) hand their call to
`run`:

  * the call's arguments go to a temporary directory (`torch.save`, every
    tensor on the CPU);
  * L children of this module start at once (`launch.run_processes`, the
    one copy of the start / wait / kill logic) and meet on a free loopback
    port. Child i joins as rank i of L with `initialize_multihost(...,
    ranks_per_process=L)`, so the card and backend rule of
    `mesh.plan_ranks` holds: NCCL on distinct cards, gloo on the CPU or on
    a shared card. It loads the arguments onto its card, calls the same
    entry point with the job's mesh and leaves the job;
  * rank 0 writes the result, and every rank its K1 launches, its plain
    calls and its row of the rank table. The caller returns the result on
    `mesh.device`; a `DensifyResult` carries the ranks' records as
    per-rank counters (`rank<i>_allview_ncc_launches`,
    `rank<i>_plain_calls`, `rank<i>_card` and `rank<i>_uuid8`, the card's
    UUID's first 8 hex digits as an integer, -1 on the CPU; `job_ranks`,
    `job_nccl`).

On the CPU the ranks share the caller's threads (`OMP_NUM_THREADS`,
unless set). A rank that raises writes its traceback to the directory and exits
non-zero; the others are killed, and the call raises `RuntimeError`
naming the rank, with its traceback. Past `mesh.TIMEOUT_S` every child is
killed and the call raises `TimeoutError`. No child outlives the call,
the caller joins no process group, and nothing falls back to fewer ranks
or to the CPU.

    python -m densepoints_tpu_torch.parallel.local_job WORK ADDRESS WORLD RANK DEVICE

runs one rank (`main`); only `run` starts it.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from densepoints_tpu_torch.parallel import launch
from densepoints_tpu_torch.parallel import mesh as pmesh

__all__ = ["run"]

_MODULE = "densepoints_tpu_torch.parallel.local_job"
_CALL = "call.pt"
_RESULT = "result.pt"


@dataclasses.dataclass
class _Cloud:
    """A `DensifyResult` as it crosses back: its `StageMetrics` holds a
    closure, which does not pickle, so only the times and counters do."""

    patches: object
    times: dict
    counters: dict


def _to(obj, device):
    """`obj` with every tensor in it on `device`: tensors, dataclasses of
    them (`Scene`, `Cameras`, `PatchState`, `BAProblem`), tuples, lists and
    dicts; anything else (numpy arrays, configs' scalars) as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(a, device) for a in obj)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj


def _uuid8(uuid: str) -> int:
    try:
        return int(uuid, 16)
    except ValueError:  # "-": a rank on the CPU
        return -1


def _failure(entry: str, work: Path, world: int, first: int, codes) -> str:
    """The message of a failed job: the rank that raised first (by the
    time in its traceback file), else the first rank seen to exit
    non-zero, with its exit code and traceback."""
    errors = {}
    for rank in range(world):
        path = work / f"error.{rank}.json"
        if path.exists():
            errors[rank] = json.loads(path.read_text())
    if errors:
        rank = min(errors, key=lambda r: (errors[r]["time"], r))
        text = errors[rank]["traceback"]
    else:
        rank, text = first, "(it wrote no traceback)\n"
    return (f"{entry} over {world} ranks: rank {rank} failed (exit code "
            f"{codes[rank]}); the other ranks were stopped:\n{text}")


def run(entry: str, mesh: pmesh.Mesh, **args):
    """`entry(**args, mesh=<the job's mesh>)` as a job of `mesh.world_size`
    ranks started for this call; rank 0's result on `mesh.device`."""
    if entry not in pmesh.ENTRY_POINTS:
        raise ValueError(
            f"{entry!r} is none of {', '.join(pmesh.ENTRY_POINTS)}")
    world = mesh.world_size
    with tempfile.TemporaryDirectory(prefix="densepoints_local_job_") as tmp:
        work = Path(tmp)
        torch.save({"entry": entry, "args": _to(args, "cpu")}, work / _CALL)
        address = launch.loopback_address()
        commands = [[sys.executable, "-m", _MODULE, str(work), address,
                     str(world), str(rank), mesh.device.type]
                    for rank in range(world)]
        env = launch.child_env(loopback=True)
        if mesh.device.type == "cpu":
            # The ranks share this process's threads, unless told.
            env.setdefault("OMP_NUM_THREADS",
                           str(max(1, torch.get_num_threads() // world)))
        try:
            first, codes = launch.run_processes(commands, env=env,
                                                timeout=pmesh.TIMEOUT_S)
        except TimeoutError as exc:
            raise TimeoutError(f"{entry} over {world} ranks: {exc}") from None
        if first is not None:
            raise RuntimeError(_failure(entry, work, world, first, codes))
        # This call's own files, written by its children.
        result = torch.load(work / _RESULT, weights_only=False)
        ranks = [json.loads((work / f"rank.{r}.json").read_text())
                 for r in range(world)]
    result = _to(result, mesh.device)
    if not isinstance(result, _Cloud):
        return result
    from densepoints_tpu_torch.pmvs.pipeline import DensifyResult
    from densepoints_tpu_torch.utils import StageMetrics

    metrics = StageMetrics()
    metrics.times.update(result.times)
    metrics.counters.update(result.counters)
    for rec in ranks:
        r = rec["rank"]
        metrics.count(f"rank{r}_allview_ncc_launches", rec["launches"])
        metrics.count(f"rank{r}_plain_calls", rec["plain"])
        metrics.count(f"rank{r}_card",
                      -1 if rec["card"] is None else rec["card"])
        metrics.count(f"rank{r}_uuid8", _uuid8(rec["uuid"]))
    metrics.count("job_ranks", world)
    metrics.count("job_nccl", int(ranks[0]["backend"] == "nccl"))
    return DensifyResult(patches=result.patches, metrics=metrics)


def _pack(result):
    """The result on the CPU, a `DensifyResult` as a `_Cloud`."""
    from densepoints_tpu_torch.pmvs.pipeline import DensifyResult

    if isinstance(result, DensifyResult):
        result = _Cloud(result.patches, dict(result.metrics.times),
                        dict(result.metrics.counters))
    return _to(result, "cpu")


def main(argv) -> int:
    """One rank: join the job, run the call, write what it gives."""
    work, address, world, rank, device = argv
    work, world, rank = Path(work), int(world), int(rank)
    try:
        from densepoints_tpu_torch.ops import allview_ncc

        call = torch.load(work / _CALL, weights_only=False)
        pmesh.initialize_multihost(address, world, rank, device=device,
                                   ranks_per_process=world)
        mesh = pmesh.global_mesh()
        entry = call["entry"]
        fn = getattr(importlib.import_module(pmesh.ENTRY_POINTS[entry]),
                     entry)
        result = fn(**_to(call["args"], mesh.device), mesh=mesh)
        if rank == 0:
            torch.save(_pack(result), work / _RESULT)
        _, host, card, uuid = mesh.table[rank]
        (work / f"rank.{rank}.json").write_text(json.dumps({
            "rank": rank, "host": host, "card": card, "uuid": uuid,
            "backend": mesh.backend,
            "launches": allview_ncc.KERNEL_LAUNCHES,
            "plain": allview_ncc.PLAIN_CALLS}))
        pmesh.shutdown_multihost()
    except BaseException:
        (work / f"error.{rank}.json").write_text(json.dumps({
            "time": time.time(), "traceback": traceback.format_exc()}))
        pmesh.abort_multihost()
        raise
    return 0


if __name__ == "__main__":
    # By the module's own name, so that what rank 0 pickles (`_Cloud`)
    # loads in the caller.
    from densepoints_tpu_torch.parallel.local_job import main as rank_main

    sys.exit(rank_main(sys.argv[1:]))
