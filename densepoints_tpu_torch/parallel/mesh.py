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

The backend rule (`_choose_backend`, logged once by `initialize_multihost`):
NCCL when every rank has a GPU of its own on its host (the ranks of a host
map to distinct `rank % torch.cuda.device_count()`), gloo otherwise (CPU
tensors, or more ranks than GPUs on a host). gloo reduces and gathers
host tensors, so the gloo collectives copy a device tensor to the host and
back; `MeshTraffic` counts those bytes beside the collective bytes. A rank
never moves its compute to the CPU, and a failure to initialise raises.

A mesh made without a process group (`make_mesh()` before any
`initialize_multihost`) has world size 1, and every collective is the
identity.
"""
from __future__ import annotations

import dataclasses
import datetime
import time

import torch

from densepoints_tpu_torch.utils import log

__all__ = [
    "PATCH_AXIS",
    "Mesh",
    "MeshTraffic",
    "make_mesh",
    "global_mesh",
    "initialize_multihost",
    "shutdown_multihost",
    "shard_patches",
    "replicate",
    "pad_to_multiple",
    "all_reduce",
    "all_gather",
    "broadcast",
    "all_true",
]

PATCH_AXIS = "patch"
# Every collective of a job waits at most this long for the other ranks.
TIMEOUT_S = 600.0


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
    device; `backend` is "nccl", "gloo" or "none" (world size 1, no process
    group); `group` is the process group of the tensor collectives (None:
    the default group)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object = None
    traffic: MeshTraffic = dataclasses.field(
        default_factory=MeshTraffic, compare=False
    )


_GLOBAL: Mesh | None = None  # the job's mesh, set by initialize_multihost


def _choose_backend(ranks_hosts, device_counts, device_type: str) -> str:
    """NCCL when the ranks of every host map to distinct GPUs (`rank %
    device_count`), gloo otherwise."""
    if device_type != "cuda":
        return "gloo"
    seen = {}
    for rank, (host, count) in enumerate(zip(ranks_hosts, device_counts)):
        if count < 1:
            return "gloo"
        taken = seen.setdefault(host, set())
        if rank % count in taken:
            return "gloo"
        taken.add(rank % count)
    return "nccl"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | None = None,
):
    """Join (or form) the job at `coordinator_address` ("host:port", rank 0
    listens there). Returns (rank, world size).

    The default process group is gloo (it also carries the host-side
    exchanges); when `_choose_backend` picks NCCL, an NCCL group over the
    same ranks carries the tensor collectives. Each rank runs on
    `cuda:(rank % device_count)` unless `device` is "cpu". Every
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
        count = torch.cuda.device_count()
        dev = torch.device("cuda", rank % count)
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        count, dev = 0, torch.device("cpu")
    else:
        raise ValueError(f"device {device!r}: the port runs on cuda or cpu")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank, timeout=timeout,
    )
    hosts = [None] * world
    dist.all_gather_object(hosts, (socket.gethostname(), count))
    backend = _choose_backend([h for h, _ in hosts], [c for _, c in hosts],
                              kind)
    group = None
    if backend == "nccl":
        group = dist.new_group(backend="nccl", timeout=timeout)
    _GLOBAL = Mesh(rank=rank, world_size=world, device=dev, backend=backend,
                   group=group)
    log.info(
        "multihost: rank %d/%d on %s, backend %s (nccl when the ranks of "
        "every host map to distinct GPUs, rank %% device_count; gloo "
        "otherwise)", rank, world, dev, backend,
    )
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


def global_mesh(device=None) -> Mesh:
    """The job's mesh after `initialize_multihost`; otherwise a mesh of
    world size 1 on `device` (default cuda)."""
    if _GLOBAL is not None:
        return _GLOBAL
    return Mesh(rank=0, world_size=1,
                device=torch.device(device or "cuda"), backend="none")


def make_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """The mesh over the job's ranks (`global_mesh`). `num_devices`, when
    given, must equal its world size: one rank drives one device."""
    mesh = global_mesh(device)
    if num_devices and num_devices != mesh.world_size:
        raise ValueError(
            f"num_devices={num_devices}, but the job has {mesh.world_size} "
            "rank(s): start one process per device (initialize_multihost)"
        )
    return mesh


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _row_block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of a dim 0 of length `n` (a multiple of
    the world size)."""
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


def all_true(mesh: Mesh, flag: torch.Tensor) -> bool:
    """Whether a 0-dim bool tensor is True on every rank: one
    `all_reduce(MIN)` of an int32 flag, read on the host."""
    if mesh.world_size == 1:
        return bool(flag)
    if mesh.backend == "gloo":
        flag = torch.tensor([int(bool(flag))], dtype=torch.int32)
    else:
        flag = flag.to(torch.int32).reshape(1)
    return bool(all_reduce(mesh, flag, "min").item())
