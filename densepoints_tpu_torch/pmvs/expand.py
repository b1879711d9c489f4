"""Patch expansion as bulk-synchronous wavefront rounds: one loop for every
entry point.

`wavefront(ops, seeds, grids, expand_config)` inserts the seeds, then runs
rounds:

  frontier (alive, >= `min_visible_views_to_expand` visible views)
  -> 4 candidates a patch (tangent-plane steps of one grid cell)
  -> refine (Nelder-Mead at the expansion texture, visibility
     re-classification, NCC filter)
  -> bulk grid insertion under the ids `total + arange`
  -> the accepted candidates are appended and form the next frontier

until the frontier is empty, `max_patches` patches are in, a round accepts
nothing, or `max_rounds` rounds have run. The winner of a contested cell is
the lowest id, so a run is deterministic for a given input.

The loop alone owns the order of the steps, the stop rules, the running
total and the ids, the counters and the spans: `expand/insert_seeds`, then
per round `expand/round` around `expand/candidates`, `expand/solve` (around
`refine`) and `expand/insert`. Each entry point hands it an ops object:

  compact(state, keep) -> (state, n)   the alive rows where `keep` (a (P,)
                                       bool on the device) first, and how
                                       many they are
  candidates(grids, frontier, n) -> (cand, m)
                                       the candidates of the frontier's n
                                       rows, and how many are real
  refine(cand) -> cand                 Nelder-Mead, re-classification, NCC
                                       filter
  insert(grids, state, first_id) -> (accepted, grids)
                                       under the ids first_id +
                                       arange(capacity)

`DeviceOps` is the one-card ops (`expand_patches`, behind `densify` and
`densify_multiscale`): it compacts on the device, applies the occupancy
pre-screen (`expand.prescreen`) in `candidates`, and opens `expand/rescore`
around the re-classification and the NCC filter, inside `expand/solve`.
`parallel/multihost.py` and `parallel/pipeline.py` hand the loop their ops
over a mesh, which open no span of their own.

`CANDIDATES` and `ACCEPTED` sum the rounds' candidates optimized and
patches accepted (`counts`, `count_since`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

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

__all__ = ["make_expansion_candidates", "expand_optimize_config",
           "wavefront", "DeviceOps", "expand_patches", "counts",
           "count_since"]

CANDIDATES = 0  # candidates optimized, summed over rounds
ACCEPTED = 0  # candidates inserted, summed over rounds


def tally(candidates: int, accepted: int):
    """Add a round's candidates optimized and patches accepted."""
    global CANDIDATES, ACCEPTED
    CANDIDATES += candidates
    ACCEPTED += accepted


def counts() -> dict:
    """The rounds' counters, under the names `StageMetrics` reports."""
    return {"expand_candidates": CANDIDATES, "expand_accepted": ACCEPTED}


def count_since(metrics, before: dict):
    """Set the rounds' counts since `before` (a `counts()`) as `metrics`'
    counters."""
    for name, value in counts().items():
        metrics.count(name, value - before[name])


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


def expand_optimize_config(expand_config: ExpandConfig,
                           optimize_config: OptimizeConfig) -> OptimizeConfig:
    """The solver's settings for expansion candidates: `optimize_config`
    with `expand_config.max_iterations` where that is set."""
    if expand_config.max_iterations > 0:
        return dataclasses.replace(
            optimize_config, max_iterations=expand_config.max_iterations
        )
    return optimize_config


def wavefront(ops, seeds: PatchState, grids, expand_config: ExpandConfig):
    """Seed insertion, then rounds until a stop rule. Returns (the accepted
    patches, grids, their number)."""
    with record_function("expand/insert_seeds"):
        accepted, grids = ops.insert(grids, seeds, 0)
        state, total = ops.compact(seeds, accepted)
    log.info("expansion: %d seeds inserted", total)
    frontier, n = state, total
    parts = [state]
    for round_idx in range(expand_config.max_rounds):
        if n == 0 or total >= expand_config.max_patches:
            break
        with record_function("expand/round"):
            with record_function("expand/candidates"):
                frontier, n_front = ops.compact(
                    frontier, frontier.num_visible()
                    >= expand_config.min_visible_views_to_expand)
                if n_front == 0:
                    break
                cand, n_cand = ops.candidates(grids, frontier, n_front)
            if n_cand == 0:
                break
            with record_function("expand/solve"):
                cand = ops.refine(cand)
            with record_function("expand/insert"):
                accepted, grids = ops.insert(grids, cand, total)
                frontier, n = ops.compact(cand, accepted)
        tally(n_cand, n)
        log.info(
            "expansion round %d: frontier=%d candidates=%d accepted=%d "
            "total=%d", round_idx, n_front, n_cand, n, total + n,
        )
        if n == 0:
            break
        parts.append(frontier)
        total += n
    return PatchState.concatenate(parts), grids, total


class DeviceOps:
    """The wavefront's ops on one device (see the module docstring)."""

    def __init__(self, images, cameras, expand_config: ExpandConfig,
                 organizer_config: OrganizerConfig,
                 optimize_config: OptimizeConfig):
        self.images, self.cameras = images, cameras
        self.grid_scale = organizer_config.grid_scale
        self.min_grids = organizer_config.min_grids_to_accept
        self.texture_size = expand_config.texture_size
        self.prescreen = expand_config.prescreen
        self.optimize_config = expand_optimize_config(expand_config,
                                                      optimize_config)

    def compact(self, state, keep):
        # holds a sync: `compact()`, a boolean index, waits for the device
        state = state.masked(keep).compact()
        return state, state.capacity

    def candidates(self, grids, frontier, n):
        cand = make_expansion_candidates(self.cameras, frontier,
                                         self.grid_scale)
        if self.prescreen != "off":
            # Drop candidates that cannot reach min_grids cell wins before
            # paying for Nelder-Mead, the dominant cost of a round. Holds
            # syncs: the count and `compact()`.
            cells = candidate_cells(grids, self.cameras, cand.position,
                                    cand.vis, self.grid_scale)
            keep = prescreen_candidates(grids, cells, cand.alive,
                                        self.min_grids, self.prescreen)
            n_before = int(cand.alive.sum())
            cand = cand.masked(keep & cand.alive).compact()
            log.info("expansion prescreen: %d -> %d candidates", n_before,
                     cand.capacity)
        return cand, cand.capacity

    def refine(self, cand):
        # Holds syncs: Nelder-Mead reads its exit flag once a block.
        cand = optimize_patches(self.images, self.cameras, cand,
                                self.texture_size, self.optimize_config)
        with record_function("expand/rescore"):
            vis, cnd = classify_views(
                self.cameras, cand.position, cand.normal, cand.ref,
                self.optimize_config.visible_angle,
                self.optimize_config.candidate_angle,
            )
            cand = dataclasses.replace(cand, vis=vis, cand=cnd)
            return filter_by_error(self.images, self.cameras, cand,
                                   self.texture_size, self.optimize_config)

    def insert(self, grids, state, first_id):
        cells = candidate_cells(grids, self.cameras, state.position,
                                state.vis, self.grid_scale)
        ids = torch.arange(first_id, first_id + state.capacity,
                           device=state.position.device)
        return bulk_try_insert(grids, cells, state.alive, ids,
                               self.min_grids)


def expand_patches(
    images: torch.Tensor,
    cameras: Cameras,
    seeds: PatchState,
    expand_config: ExpandConfig = ExpandConfig(),
    organizer_config: OrganizerConfig = OrganizerConfig(),
    optimize_config: OptimizeConfig = OptimizeConfig(),
):
    """Seed insertion + wavefront expansion on the device of `images`.

    Returns (PatchState with only accepted patches, grids).
    """
    grids = make_grids(
        cameras, organizer_config.grid_scale,
        organizer_config.max_patches_per_cell,
    )
    ops = DeviceOps(images, cameras, expand_config, organizer_config,
                    optimize_config)
    # the ids of the seeds are their rows: first drop the dead ones
    state, grids, _ = wavefront(ops, seeds.compact(), grids, expand_config)
    return state, grids
