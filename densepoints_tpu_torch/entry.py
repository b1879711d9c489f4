"""Entry points of the port: one refine step on a tiny problem, and
a dry run of the sharded step over several ranks.

    python -m densepoints_tpu_torch.entry [--device cuda|cpu] [--ranks 8]

Stands for the root `__graft_entry__.py` of the JAX package:
  * `entry(device)` -> (fn, example_args): the hot path of the framework,
    one batched photometric refine step (Nelder-Mead -> visibility ->
    NCC filter; `parallel.distributed.distributed_refine_step` with k = 11
    and 10 iterations) on `_tiny_problem` (4 views of 48 x 64 looking at
    the plane z = 0, uniform noise images, 16 plane patches, drawn from
    `default_rng(0)` in the root file's order). `fn` is a plain callable
    on tensors; in a process without a process group the step's mesh has
    one rank (`parallel.mesh.global_mesh`).
  * `dryrun_multichip(n, device)`: a job of n ranks of this module
    (`scripts._jobs.run_ranks`, gloo on loopback), each running the
    sharded step once on `_tiny_problem` with max(16, 2n) patches: the
    refine step, then `distributed_insert` of the pre-refine state (its
    random images make the NCC filter prune the refined visibility) into
    occupancy grids of 8-pixel cells with `OrganizerConfig()`. Rank 0
    prints `dryrun_multichip(n): refined P patches, I inserted`, which the
    caller prints again and gets back as (P, I).
`main` runs `entry()` once ("entry(): ok"), then `dryrun_multichip(ranks)`.

Departures from the JAX entry points:
  * No `jit`: `fn` runs eagerly. On a card it launches the all-views
    kernel (K1), built from `csrc/` at first use.
  * The JAX step takes a state sharded over an n-device mesh
    (`shard_state`). The port's step takes the whole replicated state;
    each rank refines its row block of it and an `all_gather` makes the
    result replicated again (`pmvs.optimize._sliced`).
  * An n-device mesh is n processes. On a card they share it when there
    are fewer cards than ranks: gloo carries the collectives, device
    tensors staged through the host (`parallel.mesh`). The kernels are
    built in the caller before the ranks start, so that no two ranks build
    them at once.
"""
from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

MODULE = "densepoints_tpu_torch.entry"
TEXTURE = 11
NM_ITERATIONS = 10
CELL_PIXELS = 8
JOB_TIMEOUT_S = 300.0
_LINE = re.compile(r"dryrun_multichip\((\d+)\): refined (\d+) patches, "
                   r"(\d+) inserted")


def _tiny_problem(num_views=4, num_patches=16, hw=(48, 64), device="cuda"):
    """(images (V, H, W), cameras, state) on `device`: cameras on a small
    arc at focal 80 looking at the plane z = 0, uniform noise images, and
    plane patches within +-0.3 with reference view 0 and every other view
    visible, all drawn from `default_rng(0)` as the root file draws
    them."""
    from densepoints_tpu_torch.core.cameras import Cameras
    from densepoints_tpu_torch.pmvs.patch import PatchState
    from densepoints_tpu_torch.scripts import _rigs

    H, W = hw
    rng = np.random.default_rng(0)
    Cs = [np.array([3.0 * np.sin(ang), 0.1 * i, -3.0 * np.cos(ang)])
          for i, ang in enumerate(
              (i - (num_views - 1) / 2) * 0.2 for i in range(num_views))]
    cams = Cameras.from_projection_matrices(
        _rigs.projections(Cs, 80.0, W, H), W, H, device=device)
    images = torch.as_tensor(
        rng.uniform(0, 255, (num_views, H, W)).astype(np.float32),
        device=device)
    pos, nrm = _rigs.plane_patches(rng.uniform(-0.3, 0.3, (num_patches, 2)))
    vis = np.ones((num_patches, num_views), bool)
    vis[:, 0] = False
    state = PatchState.create(
        torch.as_tensor(pos, device=device), nrm,
        np.zeros((num_patches,), np.int64), vis)
    return images, cams, state


def entry(device="cuda"):
    """(fn, example_args): `fn(images, cameras, state)` is one refine step
    of the tiny problem on `device`."""
    from densepoints_tpu_torch.config import OptimizeConfig
    from densepoints_tpu_torch.parallel.distributed import (
        distributed_refine_step,
    )

    images, cams, state = _tiny_problem(device=device)
    cfg = OptimizeConfig(max_iterations=NM_ITERATIONS)

    def fn(images, cams, state):
        return distributed_refine_step(images, cams, state, TEXTURE, cfg)

    return fn, (images, cams, state)


def dryrun_step(mesh):
    """The sharded step on this rank of `mesh`: (refined patches, inserted
    patches)."""
    from densepoints_tpu_torch.config import OptimizeConfig, OrganizerConfig
    from densepoints_tpu_torch.parallel.distributed import (
        distributed_insert,
        distributed_refine_step,
    )
    from densepoints_tpu_torch.pmvs.organizer import make_grids

    images, cams, state = _tiny_problem(
        num_patches=max(16, 2 * mesh.world_size), device=mesh.device)
    cfg = OptimizeConfig(max_iterations=NM_ITERATIONS, sampling_impl="auto")
    refined = distributed_refine_step(images, cams, state, TEXTURE, cfg,
                                      mesh)
    ids = torch.arange(refined.capacity, dtype=torch.int32,
                       device=mesh.device)
    accepted, _ = distributed_insert(mesh, make_grids(cams, CELL_PIXELS),
                                     cams, state, ids, OrganizerConfig())
    if not bool(torch.isfinite(refined.position).all()):
        raise RuntimeError("the refine step gave non-finite positions")
    return refined.capacity, int(accepted.sum())


def dryrun_multichip(n_devices: int, device="cuda", work_dir=""):
    """Run the sharded step once on `n_devices` ranks; prints rank 0's line
    and returns (refined patches, inserted patches). The ranks' logs are
    in `work_dir` (a fresh temporary directory, removed after, unless
    given)."""
    from densepoints_tpu_torch.scripts import _jobs, _scene_runs, _timing

    kind = _timing.run_device(device).type
    if kind == "cuda":
        from densepoints_tpu_torch.ops import allview_ncc

        allview_ncc.build_kernel()
    with _scene_runs.work_dir(work_dir, "dryrun_multichip_") as work:
        _jobs.run_ranks(
            MODULE, n_devices,
            lambda rank, port: ["--rank", rank, "--world", n_devices,
                                "--port", port, "--device", kind],
            work, JOB_TIMEOUT_S)
        text = _jobs.rank_log(work, "entry", n_devices, 0).read_text()
    match = _LINE.search(text)
    if match is None or int(match.group(1)) != n_devices:
        raise RuntimeError(f"rank 0 printed no dry-run line:\n{text[-2000:]}")
    print(match.group(0), flush=True)
    return int(match.group(2)), int(match.group(3))


def rank_main(args) -> int:
    """One rank of a `dryrun_multichip` job."""
    from densepoints_tpu_torch.parallel.mesh import (
        global_mesh,
        initialize_multihost,
        shutdown_multihost,
    )

    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{args.port}", args.world, args.rank,
                         device=args.device)
    try:
        mesh = global_mesh()
        refined, inserted = dryrun_step(mesh)
        if mesh.rank == 0:
            print(f"dryrun_multichip({mesh.world_size}): refined {refined} "
                  f"patches, {inserted} inserted", flush=True)
    finally:
        shutdown_multihost()
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=8,
                   help="ranks of the dry run")
    # One rank of a dry run (set by `dryrun_multichip` for its processes).
    p.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank >= 0:
        return rank_main(args)
    fn, example = entry(args.device)
    out = fn(*example)
    if not bool(torch.isfinite(out.position).all()):
        raise RuntimeError("entry(): non-finite positions")
    print("entry(): ok", flush=True)
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
