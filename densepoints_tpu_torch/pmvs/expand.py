"""Patch expansion as bulk-synchronous wavefront rounds.

  round:  frontier (alive, >= 2 visible views, not yet expanded)
          -> 4 candidates each (tangent-plane steps of one grid cell)
          -> optionally the occupancy pre-screen (`expand.prescreen`)
          -> batched simplex optimization (texture 11)
          -> batched visibility re-classification + NCC filter
          -> deterministic bulk grid insertion (scatter-priority dedup)
          -> accepted candidates are appended and form the next frontier

The winner of a contested cell is the lowest candidate index, so a run is
deterministic for a given input.
"""
from __future__ import annotations

import dataclasses

import torch

from densepoints_tpu_torch.config import (
    ExpandConfig,
    OptimizeConfig,
    OrganizerConfig,
)
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.ops.warp import patch_frames
from densepoints_tpu_torch.pmvs.optimize import filter_by_error, optimize_patches
from densepoints_tpu_torch.pmvs.organizer import (
    bulk_try_insert,
    candidate_cells,
    make_grids,
    prescreen_candidates,
)
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.visibility import classify_views
from densepoints_tpu_torch.utils import log

__all__ = ["make_expansion_candidates", "expand_patches"]


def make_expansion_candidates(
    cameras: Cameras, state: PatchState, grid_scale: int
) -> PatchState:
    """4 directional candidates per patch, ordered [+x, -x, +y, -y] blocks.

    Steps are grid_scale / dx world units along the tangent axes: one
    occupancy cell in the reference image (patch_frames with k =
    2 * grid_scale scales by exactly grid_scale / dx)."""
    sx, sy = patch_frames(
        cameras, state.position, state.normal, state.ref, 2 * grid_scale
    )
    offsets = torch.cat([sx, -sx, sy, -sy], dim=0)  # (4P, 3)
    cand = state.map(lambda a: torch.cat([a, a, a, a], dim=0))
    return dataclasses.replace(cand, position=cand.position + offsets)


def expand_patches(
    images: torch.Tensor,
    cameras: Cameras,
    seeds: PatchState,
    expand_config: ExpandConfig = ExpandConfig(),
    organizer_config: OrganizerConfig = OrganizerConfig(),
    optimize_config: OptimizeConfig = OptimizeConfig(),
):
    """Seed insertion + wavefront expansion.

    Returns (PatchState with only accepted patches, grids).
    """
    grid_scale = organizer_config.grid_scale
    min_grids = organizer_config.min_grids_to_accept
    grids = make_grids(
        cameras, grid_scale, organizer_config.max_patches_per_cell
    )
    if expand_config.max_iterations > 0:
        optimize_config = dataclasses.replace(
            optimize_config, max_iterations=expand_config.max_iterations
        )
    dev = seeds.position.device

    seeds = seeds.compact()
    cells = candidate_cells(
        grids, cameras, seeds.position, seeds.vis, grid_scale
    )
    accepted, grids = bulk_try_insert(
        grids, cells, seeds.alive,
        torch.arange(seeds.capacity, device=dev), min_grids,
    )
    state = seeds.masked(accepted).compact()
    log.info("expansion: %d/%d seeds inserted", state.capacity, seeds.capacity)
    frontier = state
    parts = [state]
    total = state.capacity

    for round_idx in range(expand_config.max_rounds):
        if frontier.capacity == 0 or total >= expand_config.max_patches:
            break
        expandable = frontier.alive & (
            frontier.num_visible()
            >= expand_config.min_visible_views_to_expand
        )
        frontier = frontier.masked(expandable).compact()
        if frontier.capacity == 0:
            break
        cand = make_expansion_candidates(cameras, frontier, grid_scale)
        if expand_config.prescreen != "off":
            # Drop candidates that cannot reach min_grids cell wins before
            # paying for Nelder-Mead, the dominant cost of a round.
            pre_cells = candidate_cells(
                grids, cameras, cand.position, cand.vis, grid_scale
            )
            keep = prescreen_candidates(
                grids, pre_cells, cand.alive, min_grids,
                expand_config.prescreen,
            )
            n_before = int(cand.alive.sum())
            cand = cand.masked(keep & cand.alive).compact()
            log.info(
                "expansion round %d: prescreen %d -> %d candidates",
                round_idx, n_before, cand.capacity,
            )
            if cand.capacity == 0:
                break
        # Optimize at the expansion texture size, then re-classify
        # visibility and NCC-filter.
        cand = optimize_patches(
            images, cameras, cand, expand_config.texture_size,
            optimize_config,
        )
        vis, cnd = classify_views(
            cameras, cand.position, cand.normal, cand.ref,
            optimize_config.visible_angle, optimize_config.candidate_angle,
        )
        cand = dataclasses.replace(cand, vis=vis, cand=cnd)
        cand = filter_by_error(
            images, cameras, cand, expand_config.texture_size,
            optimize_config,
        )
        cells = candidate_cells(
            grids, cameras, cand.position, cand.vis, grid_scale
        )
        accepted, grids = bulk_try_insert(
            grids, cells, cand.alive,
            total + torch.arange(cand.capacity, device=dev), min_grids,
        )
        new_patches = cand.masked(accepted).compact()
        log.info(
            "expansion round %d: frontier=%d candidates=%d accepted=%d "
            "total=%d",
            round_idx, frontier.capacity, cand.capacity,
            new_patches.capacity, total + new_patches.capacity,
        )
        if new_patches.capacity == 0:
            break
        parts.append(new_patches)
        total += new_patches.capacity
        frontier = new_patches

    return PatchState.concatenate(parts), grids
