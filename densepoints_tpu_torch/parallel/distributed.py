"""Multi-rank PMVS: patch refinement split over ranks, insertion agreed by
collectives.

  * the patch set splits into contiguous row blocks, one per rank
    (`shard_state`); optimization, visibility and the NCC filter are
    patch-parallel, so each rank refines its block with no communication
    (each stops Nelder-Mead on its own block's exit flag) but an
    `all_gather` that makes the result replicated again
    (`distributed_refine_step`);
  * occupancy insertion needs global agreement. With replicated grids
    (`distributed_insert`) each rank claims cells for its block of
    candidates by a scatter-min of GLOBAL candidate ids, one
    `all_reduce(MIN)` over the `V*Hg*Wg + 1` int32 claims merges them, and
    each rank decides its winners against the merged claims. With grids
    split by view (`viewsharded_insert`) a cell has exactly one owner, the
    K claim rounds run on the owner alone, and the only collective is an
    `all_reduce(SUM)` of the (P,) int32 win counts;
  * host-side orchestration (rounds, compaction) is the single-rank one.

Claims are decided by global ids, never by arrival order, so the N-rank
result equals the 1-rank result.

These building blocks are the SPMD body: they run inside a rank, and
refuse a mesh whose ranks are not started (`mesh.require_started`), which
only the job-level entry points run a call on.
"""
from __future__ import annotations

import dataclasses

import torch

from densepoints_tpu_torch.config import OptimizeConfig, OrganizerConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    global_mesh,
    pad_to_multiple,
    require_started,
    shard_patches,
)
from densepoints_tpu_torch.pmvs.optimize import (
    _sliced,
    filter_by_error,
    filter_by_error_once,
    optimize_patches,
    optimize_patches_once,
    zero_pad,
)
from densepoints_tpu_torch.pmvs.organizer import (
    OccupancyGrids,
    _assign_slots,
    _claim_rounds,
    candidate_cells,
)
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.visibility import classify_views

__all__ = [
    "shard_state",
    "refine_step_impl",
    "refine_step_once",
    "distributed_refine_step",
    "distributed_insert",
    "pad_views",
    "shard_views",
    "viewsharded_insert",
]


def shard_state(state: PatchState, mesh: Mesh) -> PatchState:
    """This rank's row block of `state`, whose capacity is first padded
    with zeroed dead patches to a multiple of the world size."""
    require_started(mesh, "shard_state")
    state = zero_pad(state, pad_to_multiple(state.capacity, mesh.world_size))
    return state.map(lambda a: shard_patches(mesh, a))


def _reclassify(cameras, state, config):
    vis, cand = classify_views(
        cameras, state.position, state.normal, state.ref,
        config.visible_angle, config.candidate_angle,
    )
    return dataclasses.replace(state, vis=vis, cand=cand)


def refine_step_impl(
    images: torch.Tensor,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    optimize_config: OptimizeConfig = OptimizeConfig(),
    mesh: Mesh | None = None,
) -> PatchState:
    """One refine step: optimize -> reclassify -> NCC filter. With `mesh`,
    `state` is the whole (replicated) batch and each sliced stage splits it
    over the ranks (`pmvs.optimize._sliced`); the result is replicated."""
    state = optimize_patches(images, cameras, state, texture_size,
                             optimize_config, mesh=mesh)
    state = _reclassify(cameras, state, optimize_config)
    return filter_by_error(images, cameras, state, texture_size,
                           optimize_config, mesh=mesh)


def refine_step_once(
    images: torch.Tensor,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    optimize_config: OptimizeConfig = OptimizeConfig(),
    mesh: Mesh | None = None,
) -> PatchState:
    """`refine_step_impl` of one unsliced batch; with `mesh`, `state` is
    this rank's row block (Nelder-Mead's exit waits for every rank)."""
    state = optimize_patches_once(images, cameras, state, texture_size,
                                  optimize_config, mesh=mesh)
    state = _reclassify(cameras, state, optimize_config)
    return filter_by_error_once(images, cameras, state, texture_size,
                                optimize_config)


def distributed_refine_step(
    images: torch.Tensor,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    optimize_config: OptimizeConfig = OptimizeConfig(),
    mesh: Mesh | None = None,
) -> PatchState:
    """`refine_step_impl` with the three stages fused per slice: each rank
    refines its row block of every `max_refine_batch` slice of the whole
    (replicated) `state`, and one `all_gather` per slice makes the result
    replicated. Without `mesh`, this process's rank (`global_mesh`: the
    job's mesh, world size 1 outside a job)."""
    if mesh is None:
        mesh = global_mesh(device=state.position.device)
    require_started(mesh, "distributed_refine_step")
    return _sliced(refine_step_once, images, cameras, state, texture_size,
                   optimize_config, mesh)


def distributed_insert(
    mesh: Mesh,
    grids: OccupancyGrids,
    cameras: Cameras,
    state: PatchState,
    global_ids: torch.Tensor,
    organizer_config: OrganizerConfig = OrganizerConfig(),
):
    """Insertion into replicated grids, claims merged across ranks.

    `state` (P patches) and `global_ids` (P,) are replicated; each rank
    claims for its row block. Returns (accepted (P,) bool, new grids), both
    replicated."""
    require_started(mesh, "distributed_insert")
    if grids.slots_per_cell != 1:
        raise ValueError(
            "distributed insertion supports max_patches_per_cell=1"
        )
    V, Hg, Wg = grids.cells.shape
    n_cells = V * Hg * Wg
    P = state.capacity
    dev = state.position.device
    cells = candidate_cells(grids, cameras, state.position, state.vis,
                            organizer_config.grid_scale)
    prio = global_ids.to(device=dev, dtype=torch.int32)
    Pp = pad_to_multiple(P, mesh.world_size)
    rows = shard_patches(mesh, torch.arange(Pp, device=dev))
    real = rows < P
    rows = torch.where(real, rows, 0)
    my_cells, my_prio = cells[rows], prio[rows]

    occupied = torch.cat([grids.cells.reshape(-1) >= 0,
                          torch.ones((1,), dtype=torch.bool, device=dev)])
    active = (state.alive[rows] & real)[:, None] & (my_cells >= 0)
    safe = torch.where(active, my_cells, n_cells)
    active = active & ~occupied[safe]
    safe = torch.where(active, my_cells, n_cells)
    big = torch.iinfo(torch.int32).max
    claim = torch.full((n_cells + 1,), big, dtype=torch.int32, device=dev)
    claim = claim.scatter_reduce(
        0, safe.reshape(-1),
        torch.where(active, my_prio[:, None], big).reshape(-1),
        reduce="amin",
    )
    # Merge claims across ranks: the global minimum priority per cell.
    claim = all_reduce(mesh, claim, "min")
    won = active & (claim[safe] == my_prio[:, None])
    accepted = won.sum(dim=1) >= organizer_config.min_grids_to_accept
    write = all_gather(mesh, won & accepted[:, None])[:P]
    accepted = all_gather(mesh, accepted)[:P]

    # Final write on the replicated grids (the same on every rank).
    flat = torch.cat([grids.cells.reshape(-1),
                      grids.cells.new_zeros((1,))])
    flat[torch.where(write, cells, n_cells).reshape(-1)] = (
        global_ids.to(device=dev, dtype=flat.dtype)[:, None]
        .expand(write.shape).reshape(-1))
    return accepted, dataclasses.replace(
        grids, cells=flat[:-1].reshape(V, Hg, Wg))


def pad_views(grids: OccupancyGrids, n: int) -> OccupancyGrids:
    """Pad the view dimension to a multiple of n (padded views stay empty:
    cols/rows = 0 makes every candidate cell out of bounds)."""
    V = grids.cells.shape[0]
    pad = (-V) % n
    if not pad:
        return grids
    return dataclasses.replace(
        grids,
        cells=torch.cat([grids.cells, grids.cells.new_full(
            (pad,) + tuple(grids.cells.shape[1:]), -1)]),
        cols=torch.cat([grids.cols, grids.cols.new_zeros((pad,))]),
        rows=torch.cat([grids.rows, grids.rows.new_zeros((pad,))]),
    )


def shard_views(mesh: Mesh, grids: OccupancyGrids) -> OccupancyGrids:
    """This rank's slice of views of `pad_views`-padded grids."""
    require_started(mesh, "shard_views")
    return OccupancyGrids(cells=shard_patches(mesh, grids.cells),
                          cols=shard_patches(mesh, grids.cols),
                          rows=shard_patches(mesh, grids.rows))


def viewsharded_insert(
    mesh: Mesh,
    grids: OccupancyGrids,
    cell_ids: torch.Tensor,
    candidate_alive: torch.Tensor,
    global_ids: torch.Tensor,
    min_grids: int = 2,
):
    """Insertion into grids split by view: `grids` is this rank's slice
    (`shard_views`), v_loc views of the Vp = v_loc * world_size views.

    cell_ids: (P, Vp) from `candidate_cells` with view-major flat ids
      (view * Hg * Wg + row * Wg + col) over all Vp views, -1 invalid;
      candidate_alive: (P,); global_ids: (P,), replicated.
    A cell has one owner, so the K claim rounds of `bulk_try_insert` run
    unchanged on the owner's slice; the only collective is the (P,) int32
    `all_reduce(SUM)` of the win counts behind the >= `min_grids` vote.
    Returns (accepted (P,) bool replicated, this rank's new grid slice).
    """
    require_started(mesh, "viewsharded_insert")
    v_loc, Hg, Wg = grids.cells.shape[:3]
    K = grids.slots_per_cell
    if cell_ids.shape[1] != v_loc * mesh.world_size:
        raise ValueError(
            f"cell ids over {cell_ids.shape[1]} views, grids of "
            f"{mesh.world_size} x {v_loc}: pad_views() first"
        )
    n_local = v_loc * Hg * Wg
    P = cell_ids.shape[0]
    dev = cell_ids.device
    cell_slice = cell_ids[:, mesh.rank * v_loc:(mesh.rank + 1) * v_loc]
    # Rebase global view-major ids to this rank's slice.
    local_ids = cell_slice - mesh.rank * n_local
    slots = grids.cells.reshape(n_local, K)
    fill = (slots >= 0).sum(dim=1)
    active = candidate_alive[:, None] & (cell_slice >= 0)
    # Claims by the order of the global ids (ranks 0..P-1 of a stable
    # sort), which is what a scatter-min of the ids themselves decides.
    order = torch.argsort(global_ids.to(dev), stable=True)
    prio = torch.empty_like(order)
    prio[order] = torch.arange(P, device=dev)
    prio = prio[:, None].expand(P, v_loc)
    won = _claim_rounds(local_ids, active, prio, fill, K, n_local)
    # The one collective: per-candidate win counts summed over the slices.
    wins = all_reduce(mesh, won.sum(dim=1).to(torch.int32), "sum")
    accepted = wins >= min_grids
    write = won & accepted[:, None]
    slot_of = _assign_slots(write, local_ids, prio, fill, K, n_local)
    wflat = torch.where(
        write, local_ids * K + slot_of.clamp(0, K - 1), n_local * K
    ).reshape(-1)
    new_flat = torch.cat([slots.reshape(-1), slots.new_zeros((1,))])
    new_flat[wflat] = (global_ids.to(device=dev, dtype=new_flat.dtype)
                       [:, None].expand(P, v_loc).reshape(-1))
    return accepted, dataclasses.replace(
        grids, cells=new_flat[:-1].reshape(grids.cells.shape))
