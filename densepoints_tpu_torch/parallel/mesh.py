"""The process mesh: one rank per device, and the collectives over it.

The JAX package runs one controller over a global device mesh whose single
axis, `PATCH_AXIS`, splits the patch dimension. Here the mesh is a process
group, one rank per device, each rank running the same program (SPMD):

  * `PATCH_AXIS` splits dim 0 of a patch-major tensor into contiguous row
    blocks, one per rank in rank order (`shard_patches`), exactly as
    `NamedSharding(mesh, P(PATCH_AXIS))` splits it; replicated data is a
    full copy on every rank (`replicate`);
  * the JAX collectives map onto `torch.distributed`: `lax.pmin` and
    `lax.psum` onto `all_reduce` (MIN, SUM), a replicated output of a
    sharded computation onto `all_gather`, `broadcast_one_to_all` onto
    `broadcast` from rank 0.

The card and backend rule (`plan_ranks`, on the rank table that
`initialize_multihost` gathers before any group is made, logged once):
a rank's card is `cuda:(local_index % cards)`, its local index its
position among the ranks of its host in rank order, and the backend is
NCCL when the job runs on cuda and the ranks' cards (by UUID) are
pairwise distinct, gloo otherwise (CPU tensors, or ranks sharing a card,
as two ranks on one card do). gloo reduces and gathers host tensors, so
the gloo collectives copy a device tensor to the host and back;
`MeshTraffic` counts those bytes beside the collective bytes. A rank
never moves its compute to the CPU, and a failure to initialise raises.

Outside a job (before any `initialize_multihost`), `global_mesh()` has
world size 1 and every collective is the identity. `make_mesh(n)` there
follows JAX's `make_mesh(n)` over the process's devices: it takes L =
min(n, cards) of the cards (every card when n is None or 0), or L =
max(1, n) ranks on the CPU (`launch.ranks_per_process`). With L = 1 it is
that world-size-1 mesh; with L > 1 it is an unstarted mesh of L ranks
(backend "local"), which the job-level entry points (`ENTRY_POINTS`) run
their call on as a job of L child processes (`parallel/local_job.py`).
The building blocks run inside a rank and refuse it (`require_started`).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import time

import torch

from densepoints_tpu_torch.parallel.launch import ranks_per_process
from densepoints_tpu_torch.utils import log

__all__ = [
    "PATCH_AXIS",
    "Mesh",
    "MeshTraffic",
    "make_mesh",
    "global_mesh",
    "initialize_multihost",
    "plan_ranks",
    "require_started",
    "shutdown_multihost",
    "abort_multihost",
    "shard_patches",
    "replicate",
    "pad_to_multiple",
    "all_reduce",
    "all_gather",
    "broadcast",
]

PATCH_AXIS = "patch"
# Every collective of a job waits at most this long for the other ranks,
# and a job started for one call (`parallel/local_job.py`) as long in all.
TIMEOUT_S = 600.0
# The backend of an unstarted mesh: L ranks that a job-level entry point
# starts for its call.
LOCAL = "local"
# The entry points that run a call on an unstarted mesh as a job, and the
# module of each.
ENTRY_POINTS = {
    "densify_distributed": "densepoints_tpu_torch.parallel.pipeline",
    "densify_multihost": "densepoints_tpu_torch.parallel.multihost",
    "run_ba_sharded": "densepoints_tpu_torch.ba.ba",
    "generate_seed_points": "densepoints_tpu_torch.pmvs.seed",
}


@dataclasses.dataclass
class MeshTraffic:
    """What the mesh's collectives moved: bytes between ranks, bytes
    staged between the device and the host for gloo, calls and seconds."""

    collective_bytes: int = 0
    host_bytes: int = 0
    calls: int = 0
    seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """rank / world_size of this process in the job; `device` is its
    device; `backend` is "nccl", "gloo", "none" (world size 1, no process
    group) or "local" (`world_size` ranks not yet started, `device` the
    first card or the CPU: `make_mesh` outside a job); `group` is the
    process group of the tensor collectives (None: the default group);
    `table` the job's rank table, a (rank, host, card, the card's UUID's
    first 8 characters) row per rank."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object = None
    table: tuple = dataclasses.field(default=(), compare=False)
    traffic: MeshTraffic = dataclasses.field(
        default_factory=MeshTraffic, compare=False
    )

    @property
    def started(self) -> bool:
        """False for a mesh of ranks not yet started (backend "local")."""
        return self.backend != LOCAL


_GLOBAL: Mesh | None = None  # the job's mesh, set by initialize_multihost


def plan_ranks(table, device_type: str):
    """(card index per rank, backend) of a job from its rank table, one
    record per rank in rank order: {"host", "uuids" (the UUIDs of the
    cards its process sees), "per_process" (the ranks its process
    drives)}. A rank's card is its local index (its position among its
    host's ranks) modulo its process's cards; the backend is NCCL when the
    job runs on cuda and the chosen cards' UUIDs are pairwise distinct,
    gloo otherwise. Cards are None on the CPU. Raises `ValueError` when
    the processes drive unequal numbers of ranks, or a cuda rank sees no
    card."""
    widths = sorted({rec["per_process"] for rec in table})
    if len(widths) > 1:
        raise ValueError(
            f"the job's processes drive {widths} ranks each: every process "
            "of a job must see the same number of cards")
    if device_type != "cuda":
        return [None] * len(table), "gloo"
    cards, taken, local = [], set(), {}
    for rank, rec in enumerate(table):
        if not rec["uuids"]:
            raise ValueError(f"rank {rank} on {rec['host']} sees no card")
        index = local.get(rec["host"], 0)
        local[rec["host"]] = index + 1
        cards.append(index % len(rec["uuids"]))
        taken.add(rec["uuids"][cards[-1]])
    return cards, "nccl" if len(taken) == len(table) else "gloo"


def _gather_table(store, record: dict, rank: int, world: int, width: int):
    """Every rank's record through the job's store, before any process
    group: keyed by (process, local rank), so processes that disagree on
    `width` (and so on rank numbers) still all see the whole table and
    raise in `plan_ranks` instead of meeting in a group of clashing
    ranks. Returns the records in rank order."""
    if world % width:
        raise ValueError(f"{world} ranks do not split into processes of "
                         f"{width}")
    process, index = divmod(rank, width)
    store.set(f"rank_table/{process}/{index}", json.dumps(record))
    table, keys = [], []
    for p in range(world // width):
        first = json.loads(store.get(f"rank_table/{p}/0"))
        table.append(first)
        table += [json.loads(store.get(f"rank_table/{p}/{i}"))
                  for i in range(1, first["per_process"])]
        keys += [f"rank_table/read/{p}/{i}"
                 for i in range(first["per_process"])]
    store.set(f"rank_table/read/{process}/{index}", "1")
    if rank == 0:
        store.wait(keys)  # rank 0 holds the store until every rank has read
    return table


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | None = None,
    ranks_per_process: int = 1,
):
    """Join (or form) the job at `coordinator_address` ("host:port", rank 0
    listens there). Returns (rank, world size).

    Every rank first puts its record in the rank table (host, the UUIDs
    of the cards its process sees, `ranks_per_process`: the ranks its
    process drives, the L of `parallel.launch`); `plan_ranks` then gives
    each rank its card and the job its backend, and the rank sets its
    card before any group is made. The default process group is gloo (it
    also carries the host-side exchanges); when the plan is NCCL, an NCCL
    group over the same ranks carries the tensor collectives. Every
    collective of the job waits at most `TIMEOUT_S` seconds."""
    global _GLOBAL
    import socket

    import torch.distributed as dist

    if coordinator_address is None or num_processes is None:
        raise ValueError(
            "initialize_multihost needs coordinator_address (host:port) and "
            "num_processes: torch.distributed detects no cluster"
        )
    rank = 0 if process_id is None else int(process_id)
    world = int(num_processes)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    kind = torch.device(device or "cuda").type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_multihost: no CUDA device; pass device='cpu' "
                "to run the job on the CPU"
            )
        uuids = [str(torch.cuda.get_device_properties(i).uuid)
                 for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        uuids = []
    else:
        raise ValueError(f"device {device!r}: the port runs on cuda or cpu")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), is_master=rank == 0,
                          timeout=timeout, wait_for_workers=False)
    record = {"host": socket.gethostname(), "uuids": uuids,
              "per_process": int(ranks_per_process)}
    table = _gather_table(store, record, rank, world, int(ranks_per_process))
    cards, backend = plan_ranks(table, kind)
    dev = torch.device("cpu")
    if kind == "cuda":
        dev = torch.device("cuda", cards[rank])
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=store, world_size=world,
                            rank=rank, timeout=timeout)
    group = None
    if backend == "nccl":
        group = dist.new_group(backend="nccl", timeout=timeout)
    rows = tuple(
        (r, rec["host"], cards[r],
         rec["uuids"][cards[r]][:8] if cards[r] is not None else "-")
        for r, rec in enumerate(table))
    _GLOBAL = Mesh(rank=rank, world_size=world, device=dev, backend=backend,
                   group=group, table=rows)
    if rank == 0:
        for r, h, card, uuid in rows:
            log.info("multihost: rank %d/%d host %s card %s uuid %s "
                     "backend %s", r, world, h,
                     "-" if card is None else card, uuid, backend)
    return rank, world


def shutdown_multihost():
    """Leave the job (after a barrier, so no rank tears the group down
    under another); nothing without one."""
    global _GLOBAL
    import torch.distributed as dist

    if _GLOBAL is None or not dist.is_initialized():
        return
    dist.barrier()
    dist.destroy_process_group()
    _GLOBAL = None


def abort_multihost():
    """Leave the job at once, without the barrier: a rank that failed
    must not wait for ranks that wait for it. Nothing without one."""
    global _GLOBAL
    import torch.distributed as dist

    if _GLOBAL is None:
        return
    _GLOBAL = None
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(device=None) -> Mesh:
    """This process's rank: the job's mesh after `initialize_multihost`;
    otherwise a mesh of world size 1 on `device` (default cuda). Unlike
    JAX's `global_mesh()`, which spans every device, it starts no process:
    the CLI and the workers read it as their own rank. `make_mesh()` spans
    every card."""
    if _GLOBAL is not None:
        return _GLOBAL
    return Mesh(rank=0, world_size=1,
                device=torch.device(device or "cuda"), backend="none")


def make_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """JAX's `make_mesh(n)`: a mesh over n of the process's devices.

    Inside a job (after `initialize_multihost`) it is the job's mesh, and
    `num_devices`, when given, must equal its world size. Outside a job it
    spans L ranks: on cuda L = min(n, cards), every card when n is None or
    0; on the CPU L = max(1, n) (`launch.ranks_per_process`). With L = 1 it
    is `global_mesh(device)`, and everything runs in this process. With L
    > 1 it is an unstarted mesh (backend "local") on the first card or the
    CPU: `densify_distributed`, `densify_multihost`, `run_ba_sharded` and
    `generate_seed_points` given it run their call as a job of L ranks
    started for that call (`parallel/local_job.py`) and return the result
    here."""
    if _GLOBAL is not None:
        if num_devices and num_devices != _GLOBAL.world_size:
            raise ValueError(
                f"num_devices={num_devices}, but this process is a rank of "
                f"a job of {_GLOBAL.world_size}: inside a job the mesh is "
                "the job's"
            )
        return _GLOBAL
    dev = torch.device(device or "cuda")
    width = ranks_per_process(dev.type, None, num_devices or 0)
    if width == 1:
        return global_mesh(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    return Mesh(rank=0, world_size=width, device=dev, backend=LOCAL)


def require_started(mesh: Mesh | None, what: str):
    """Raise `ValueError` when `what`, which runs inside a rank, is given
    an unstarted mesh (`make_mesh` outside a job)."""
    if mesh is not None and not mesh.started:
        raise ValueError(
            f"{what} runs inside a rank of a job, but this mesh of "
            f"{mesh.world_size} ranks is not started: pass it to one of "
            f"{', '.join(ENTRY_POINTS)}, which run the call as a job of its "
            "ranks"
        )


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _row_block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of a dim 0 of length `n` (a multiple of
    the world size)."""
    require_started(mesh, "shard_patches")
    if n % mesh.world_size:
        raise ValueError(
            f"{n} rows do not split into {mesh.world_size} equal blocks"
        )
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_patches(mesh: Mesh, a: torch.Tensor) -> torch.Tensor:
    """This rank's row block of a (P, ...) patch-major tensor."""
    return a[_row_block(mesh, a.shape[0])]


def replicate(mesh: Mesh, a):
    """Replicated data is a full copy on every rank: the identity."""
    return a


def _collective(mesh: Mesh, t: torch.Tensor, fn, out_numel_factor: int):
    """Run `fn(tensor)` -> result over the mesh's group, staging a device
    tensor through the host for gloo (a host tensor through the device for
    NCCL); the result lies where `t` lies. Counts the traffic."""
    t0 = time.perf_counter()
    if mesh.backend == "gloo":
        staged = t.device.type != "cpu"  # gloo reduces host tensors
        src = t.cpu() if staged else t
    else:
        staged = t.device.type == "cpu"  # NCCL reduces device tensors
        src = t.to(mesh.device) if staged else t
    out = fn(src)
    if staged:
        mesh.traffic.host_bytes += (
            t.numel() + out.numel()) * t.element_size()
        out = out.to(t.device)
    mesh.traffic.collective_bytes += (
        t.numel() * t.element_size() * out_numel_factor)
    mesh.traffic.calls += 1
    mesh.traffic.seconds += time.perf_counter() - t0
    return out


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The elementwise `op` ("sum", "min", "max") of `t` over the ranks,
    on every rank (`lax.psum` / `lax.pmin`)."""
    if mesh.world_size == 1:
        return t
    import torch.distributed as dist

    reduce_op = getattr(dist.ReduceOp, op.upper())

    def run(x):
        x = x.clone()
        dist.all_reduce(x, op=reduce_op, group=mesh.group)
        return x

    return _collective(mesh, t, run, 1)


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (one shape on all ranks) concatenated along dim 0
    in rank order, on every rank: a sharded result made replicated."""
    if mesh.world_size == 1:
        return t
    import torch.distributed as dist

    as_bool = t.dtype == torch.bool

    def run(x):
        x = x.contiguous()
        if as_bool:
            x = x.to(torch.uint8)
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x, group=mesh.group)
        out = torch.cat(parts, dim=0)
        return out.to(torch.bool) if as_bool else out

    return _collective(mesh, t, run, mesh.world_size)


def broadcast(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's `t` on every rank (`broadcast_one_to_all`)."""
    if mesh.world_size == 1:
        return t
    import torch.distributed as dist

    def run(x):
        x = x.clone()
        dist.broadcast(x, src=0, group=mesh.group)
        return x

    return _collective(mesh, t, run, 1)

