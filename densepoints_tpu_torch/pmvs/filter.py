"""PMVS visibility/consistency filtering, as scatter/gather over per-view
depth grids:

  * occlusion filter: for every (view, cell) the minimum patch depth claims
    the cell; a patch deeper than the cell minimum by more than
    `occlusion_slack` (relative) loses that view; patches dropping below
    `min_visible_views` die;
  * weak-support filter: a patch needs neighbours (patches in the 3x3 cell
    neighbourhood of its reference-view cell whose depth agrees within
    `depth_consistency`, relative) in at least `min_support_cells` cells.
"""
from __future__ import annotations

import dataclasses

import torch

from densepoints_tpu_torch.config import FilterConfig, OptimizeConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.pmvs.patch import PatchState

__all__ = ["filter_occlusion", "filter_weak_support", "run_filters"]


def _grid_dims(cameras: Cameras, grid_scale: int):
    return (int(cameras.height.max()) // grid_scale,
            int(cameras.width.max()) // grid_scale)


def _cells_and_depth(cameras: Cameras, position, grid_scale: int, Hg: int,
                     Wg: int):
    """(V, B) flat cell ids (-1 invalid), depths and validity."""
    pix, depth = cameras.project_with_depth(position)  # (V, B, 2), (V, B)
    col = torch.floor(pix[..., 0] / grid_scale).to(torch.int64)
    row = torch.floor(pix[..., 1] / grid_scale).to(torch.int64)
    cols = (cameras.width // grid_scale)[:, None]
    rows = (cameras.height // grid_scale)[:, None]
    ok = (col >= 0) & (col < cols) & (row >= 0) & (row < rows) & (depth > 0)
    views = torch.arange(pix.shape[0], device=position.device)[:, None]
    flat = views * (Hg * Wg) + row * Wg + col
    return torch.where(ok, flat, -1), depth, ok


def _scatter(n, index, values, fill, reduce):
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, index.reshape(-1), values.reshape(-1),
                               reduce=reduce)


def filter_occlusion(
    cameras: Cameras,
    state: PatchState,
    grid_scale: int = 8,
    occlusion_slack: float = 0.05,
    min_visible_views: int = 3,
) -> PatchState:
    Hg, Wg = _grid_dims(cameras, grid_scale)
    n_cells = cameras.num_views * Hg * Wg
    cells, depth, ok = _cells_and_depth(
        cameras, state.position, grid_scale, Hg, Wg
    )  # (V, B)
    vis_vb = state.vis.T & ok & state.alive[None, :]
    safe = torch.where(vis_vb, cells, n_cells)
    inf = float("inf")
    mindepth = _scatter(
        n_cells + 1, safe, torch.where(vis_vb, depth, inf), inf, "amin"
    )
    occluded = vis_vb & (depth > mindepth[safe] * (1.0 + occlusion_slack))
    new_vis = state.vis & ~occluded.T
    alive = state.alive & (new_vis.sum(dim=1) >= min_visible_views)
    return dataclasses.replace(state, vis=new_vis, alive=alive)


def filter_weak_support(
    cameras: Cameras,
    state: PatchState,
    grid_scale: int = 8,
    depth_consistency: float = 0.01,
    min_support_cells: int = 1,
) -> PatchState:
    """Drop patches without depth-consistent neighbours near their ref cell."""
    Hg, Wg = _grid_dims(cameras, grid_scale)
    n_cells = cameras.num_views * Hg * Wg
    cells, depth, ok = _cells_and_depth(
        cameras, state.position, grid_scale, Hg, Wg
    )
    bidx = torch.arange(state.capacity, device=state.position.device)
    ref_cell = cells[state.ref, bidx]  # (B,)
    ref_depth = depth[state.ref, bidx]
    ref_proj_ok = ok[state.ref, bidx]  # in ref bounds, positive depth
    ref_ok = ref_proj_ok & state.alive

    # Min and max depth grids over reference-view projections only (the
    # max lets thick same-cell clusters support each other).
    safe = torch.where(ref_ok, ref_cell, n_cells)
    inf = float("inf")
    grid_min = _scatter(
        n_cells + 1, safe, torch.where(ref_ok, ref_depth, inf), inf, "amin"
    )
    grid_max = _scatter(
        n_cells + 1, safe, torch.where(ref_ok, ref_depth, -inf), -inf, "amax"
    )

    # 3x3 neighbourhood with PER-AXIS bounds: flat-id offsets alone would
    # wrap at grid borders into the previous row or view.
    ref_row = (ref_cell // Wg) % Hg
    ref_col = ref_cell % Wg
    tol = depth_consistency * ref_depth
    support = torch.zeros_like(bidx)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            row_ok = (ref_row + dy >= 0) & (ref_row + dy < Hg)
            col_ok = (ref_col + dx >= 0) & (ref_col + dx < Wg)
            nb = ref_cell + dy * Wg + dx
            nb = torch.where(
                row_ok & col_ok & (nb >= 0) & (nb < n_cells), nb, n_cells
            )
            lo = grid_min[nb]
            hi = grid_max[nb]
            agree = (lo <= ref_depth + tol) & (hi >= ref_depth - tol)
            support = support + (agree & torch.isfinite(lo)).to(support.dtype)
    # A patch whose reference-view projection is invalid has no cell to be
    # supported in (and no anchor texture): it dies.
    alive = state.alive & ref_proj_ok & (support >= min_support_cells)
    return dataclasses.replace(state, alive=alive)


def run_filters(
    cameras: Cameras,
    state: PatchState,
    config: FilterConfig = FilterConfig(),
    optimize_config: OptimizeConfig = OptimizeConfig(),
    grid_scale: int = 8,
) -> PatchState:
    if not config.enable:
        return state
    state = filter_occlusion(
        cameras, state, grid_scale=grid_scale,
        occlusion_slack=config.occlusion_slack,
        min_visible_views=optimize_config.min_visible_views,
    )
    state = filter_weak_support(
        cameras, state, grid_scale=grid_scale,
        depth_consistency=config.depth_consistency,
        min_support_cells=config.min_support_cells,
    )
    if config.min_final_visible_views > 0:
        state = state.masked(
            state.num_visible() >= config.min_final_visible_views
        )
    return state
