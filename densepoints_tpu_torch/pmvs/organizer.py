"""Per-view occupancy grids as one dense tensor + bulk insertion.

Grids are ONE (V, Hg, Wg) int64 tensor of global patch ids (-1 = empty),
or (V, Hg, Wg, K) with `max_patches_per_cell` K > 1. Insertion of a whole
batch of candidates is a scatter-min of candidate priority (= candidate
index) into contested cells, then a gather-back to find the winners; a
candidate is accepted iff it wins >= `min_grids` cells, and only accepted
candidates are written. Contention resolution is deterministic.
"""
from __future__ import annotations

import dataclasses

import torch

from densepoints_tpu_torch.core.cameras import Cameras

__all__ = [
    "OccupancyGrids",
    "make_grids",
    "candidate_cells",
    "bulk_try_insert",
    "prescreen_candidates",
]


@dataclasses.dataclass(frozen=True)
class OccupancyGrids:
    """cells: (V, Hg, Wg) or (V, Hg, Wg, K) int64 patch ids, -1 empty.
    cols/rows: (V,) per-view valid grid extents (floor(W / scale),
    floor(H / scale))."""

    cells: torch.Tensor
    cols: torch.Tensor
    rows: torch.Tensor

    @property
    def num_views(self) -> int:
        return self.cells.shape[0]

    @property
    def slots_per_cell(self) -> int:
        return 1 if self.cells.ndim == 3 else self.cells.shape[3]


def make_grids(
    cameras: Cameras, grid_scale: int, max_patches_per_cell: int = 1
) -> OccupancyGrids:
    cols = cameras.width // grid_scale
    rows = cameras.height // grid_scale
    shape = (cameras.num_views, int(rows.max()), int(cols.max()))
    if max_patches_per_cell > 1:
        shape = shape + (max_patches_per_cell,)
    cells = torch.full(shape, -1, dtype=torch.int64, device=cameras.device)
    return OccupancyGrids(cells=cells, cols=cols, rows=rows)


def candidate_cells(
    grids: OccupancyGrids,
    cameras: Cameras,
    position: torch.Tensor,
    vis: torch.Tensor,
    grid_scale: int,
) -> torch.Tensor:
    """Flat cell ids (B, V) for each patch in each view; -1 where invalid
    (view not visible, or the projected cell outside that view's grid)."""
    V, Hg, Wg = grids.cells.shape[:3]
    pix = cameras.project(position)  # (V, B, 2)
    col = torch.floor(pix[..., 0] / grid_scale).to(torch.int64).T  # (B, V)
    row = torch.floor(pix[..., 1] / grid_scale).to(torch.int64).T
    ok = (
        vis
        & (col >= 0)
        & (col < grids.cols[None, :])
        & (row >= 0)
        & (row < grids.rows[None, :])
    )
    views = torch.arange(V, device=position.device)[None, :]
    flat = views * (Hg * Wg) + row * Wg + col
    return torch.where(ok, flat, -1)


def _scatter_min(n: int, index: torch.Tensor, values: torch.Tensor,
                 fill: int) -> torch.Tensor:
    out = torch.full((n,), fill, dtype=torch.int64, device=index.device)
    return out.scatter_reduce_(
        0, index.reshape(-1), values.reshape(-1), reduce="amin"
    )


def _claim_rounds(cell_ids, active, prio, fill, K: int, n_cells: int):
    """K scatter-min claim rounds; returns won (B, V) bool. Each round
    awards one slot per cell to the lowest remaining priority among
    candidates whose cell still has free slots."""
    B = cell_ids.shape[0]
    safe_cells = torch.where(active, cell_ids, n_cells)
    fill_ext = torch.cat([fill, fill.new_full((1,), K)])
    won = torch.zeros_like(active)
    for _ in range(K):
        a = active & ~won & (fill_ext[safe_cells] < K)
        sc = torch.where(a, cell_ids, n_cells)
        claim = _scatter_min(n_cells + 1, sc, torch.where(a, prio, B), B)
        won_r = a & (claim[sc] == prio)
        won = won | won_r
        fill_ext = fill_ext.index_add(
            0, torch.where(won_r, cell_ids, n_cells).reshape(-1),
            won_r.reshape(-1).to(fill_ext.dtype),
        )
    return won


def _assign_slots(write, cell_ids, prio, fill, K: int, n_cells: int):
    """Accepted winners take successive free slots of their cell, in
    priority order: the K claim rounds replayed over the writes only.
    Returns slot_of (B, V) int64."""
    B = cell_ids.shape[0]
    slot_of = torch.zeros(write.shape, dtype=torch.int64,
                          device=cell_ids.device)
    next_slot = torch.cat([fill, fill.new_zeros((1,))])
    assigned = torch.zeros_like(write)
    for _ in range(K):
        a = write & ~assigned
        sc = torch.where(a, cell_ids, n_cells)
        claim = _scatter_min(n_cells + 1, sc, torch.where(a, prio, B), B)
        pick = a & (claim[sc] == prio)
        slot_of = torch.where(pick, next_slot[sc], slot_of)
        assigned = assigned | pick
        next_slot = next_slot.index_add(
            0, torch.where(pick, cell_ids, n_cells).reshape(-1),
            pick.reshape(-1).to(next_slot.dtype),
        )
    return slot_of


def prescreen_candidates(
    grids: OccupancyGrids,
    cell_ids: torch.Tensor,
    candidate_alive: torch.Tensor,
    min_grids: int = 2,
    mode: str = "claim",
):
    """Which candidates could still be accepted at insertion time.

    Both modes are necessary conditions for `bulk_try_insert` acceptance,
    evaluated on the pose before optimization (which moves a candidate by
    less than about one cell, so the screen is slightly soft):

      * "free":  >= min_grids of the candidate's valid cells have at least
        one free slot (ignores contention within the batch);
      * "claim": the candidate would win >= min_grids cells in the
        deterministic K-round claim against the rest of this batch:
        the `bulk_try_insert` contest without the writes.

    Returns keep (B,) bool."""
    K = grids.slots_per_cell
    n_cells = grids.cells.numel() // K
    fill = (grids.cells.reshape(n_cells, K) >= 0).sum(dim=1)
    active = candidate_alive[:, None] & (cell_ids >= 0)
    if mode == "free":
        has_free = active & (fill[torch.where(active, cell_ids, 0)] < K)
        return has_free.sum(dim=1) >= min_grids
    if mode != "claim":
        raise ValueError(f"unknown prescreen mode {mode!r}")
    B, V = cell_ids.shape
    prio = torch.arange(B, device=cell_ids.device)[:, None].expand(B, V)
    won = _claim_rounds(cell_ids, active, prio, fill, K, n_cells)
    return won.sum(dim=1) >= min_grids


def bulk_try_insert(
    grids: OccupancyGrids,
    cell_ids: torch.Tensor,
    candidate_alive: torch.Tensor,
    global_ids: torch.Tensor,
    min_grids: int = 2,
):
    """Insert a batch of candidates with deterministic contention resolution.

    cell_ids: (B, V) from `candidate_cells`; candidate_alive: (B,);
    global_ids: (B,) the ids accepted candidates occupy cells as.
    Returns (accepted (B,) bool, new_grids).
    """
    K = grids.slots_per_cell
    B, V = cell_ids.shape
    n_cells = grids.cells.numel() // K
    slots = grids.cells.reshape(n_cells, K)
    fill = (slots >= 0).sum(dim=1)  # (n_cells,) used slots

    active = candidate_alive[:, None] & (cell_ids >= 0)
    prio = torch.arange(B, device=cell_ids.device)[:, None].expand(B, V)
    won = _claim_rounds(cell_ids, active, prio, fill, K, n_cells)
    accepted = won.sum(dim=1) >= min_grids

    write = won & accepted[:, None]
    slot_of = _assign_slots(write, cell_ids, prio, fill, K, n_cells)

    # Only the dropped sentinel index n_cells * K receives duplicate writes:
    # a real (cell, slot) has at most one writer.
    wflat = torch.where(
        write, cell_ids * K + slot_of.clamp(0, K - 1), n_cells * K
    ).reshape(-1)
    values = global_ids.to(torch.int64)[:, None].expand(B, V).reshape(-1)
    new_slots = torch.cat([slots.reshape(-1), slots.new_zeros((1,))])
    new_slots[wflat] = values
    new_cells = new_slots[:-1].reshape(grids.cells.shape)
    return accepted, dataclasses.replace(grids, cells=new_cells)
