"""Multi-rank end-to-end densification (`densify_distributed`).

The single-host driver with its two hot stages swapped for the split
versions: patch refinement runs on each rank's row block
(`distributed_refine_step`) and occupancy insertion agrees across ranks by
the MIN-merge of claims (`distributed_insert`). Host-side orchestration
(seeding, compaction between rounds, export) is unchanged; seeds come from
the same deterministic path on every rank.

`seed_refine_patches_per_sec` in the metrics is the refine rate of the
seed stage, the ratio a 1-rank and an N-rank run are compared by.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from densepoints_tpu_torch.config import PipelineConfig
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.parallel.distributed import (
    distributed_insert,
    distributed_refine_step,
)
from densepoints_tpu_torch.parallel.mesh import Mesh, make_mesh
from densepoints_tpu_torch.pmvs.expand import make_expansion_candidates
from densepoints_tpu_torch.pmvs.filter import run_filters
from densepoints_tpu_torch.pmvs.organizer import make_grids
from densepoints_tpu_torch.pmvs.pipeline import DensifyResult
from densepoints_tpu_torch.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints_tpu_torch.pmvs.visibility import compute_color
from densepoints_tpu_torch.utils import StageMetrics, log

__all__ = ["densify_distributed"]


def _sync(mesh: Mesh):
    if mesh.device.type == "cuda":
        return lambda: torch.cuda.synchronize(mesh.device)
    return None


def densify_distributed(
    scene: Scene,
    config: PipelineConfig = PipelineConfig(),
    mesh: Mesh | None = None,
) -> DensifyResult:
    """Every rank calls this with the same scene and config and receives
    the same result. Without `mesh`, the job's mesh (`make_mesh`, world
    size 1 outside a job)."""
    if mesh is None:
        mesh = make_mesh(config.parallel.num_devices or None)
    metrics = StageMetrics(sync=_sync(mesh))
    dev = mesh.device
    cameras = scene.cameras.to(dev)
    images = torch.as_tensor(scene.images, dtype=torch.float32, device=dev)
    log.info("distributed densify over %d rank(s)", mesh.world_size)

    with metrics.stage("seed"):
        points, _, _ = generate_seed_points(images, cameras, config.matching)
        state = create_patches_from_points(
            cameras, points, config.optimize, config.seed
        )

    with metrics.stage("seed_refine"):
        t0 = time.perf_counter()
        refined = distributed_refine_step(
            images, cameras, state, config.seed.texture_size,
            config.optimize, mesh=mesh,
        )
        n_alive = refined.num_alive()  # waits for the device
        dt = time.perf_counter() - t0
        metrics.count("seed_refine_patches_per_sec",
                      state.capacity / max(dt, 1e-9))
        state = refined.compact()
    log.info("seeds surviving distributed refine: %d", n_alive)

    # Wavefront expansion with split refine + collective insertion.
    grids = make_grids(cameras, config.organizer.grid_scale)
    accepted, grids = distributed_insert(
        mesh, grids, cameras, state,
        torch.arange(state.capacity, device=dev), config.organizer,
    )
    state = state.masked(accepted).compact()
    frontier = state

    with metrics.stage("expand"):
        for round_idx in range(config.expand.max_rounds):
            if (frontier.capacity == 0
                    or state.capacity >= config.expand.max_patches):
                break
            expandable = frontier.alive & (
                frontier.num_visible()
                >= config.expand.min_visible_views_to_expand
            )
            frontier = frontier.masked(expandable).compact()
            if frontier.capacity == 0:
                break
            cand = make_expansion_candidates(
                cameras, frontier, config.organizer.grid_scale
            )
            cand = distributed_refine_step(
                images, cameras, cand, config.expand.texture_size,
                config.optimize, mesh=mesh,
            )
            base = state.capacity
            gids = base + torch.arange(cand.capacity, device=dev)
            accepted, grids = distributed_insert(
                mesh, grids, cameras, cand, gids, config.organizer
            )
            new_patches = cand.masked(accepted).compact()
            log.info(
                "distributed round %d: frontier=%d accepted=%d total=%d",
                round_idx, frontier.capacity, new_patches.capacity,
                base + new_patches.capacity,
            )
            if new_patches.capacity == 0:
                break
            state = state.concatenate([state, new_patches])
            frontier = new_patches
    metrics.count("patches_after_expand", state.capacity)

    with metrics.stage("filter"):
        state = run_filters(
            cameras, state, config.filter, config.optimize,
            config.organizer.grid_scale,
        ).compact()
    metrics.count("patches_final", state.capacity)

    with metrics.stage("color"):
        if scene.colors is not None and state.capacity:
            colors = torch.as_tensor(scene.colors, device=dev)
            state = dataclasses.replace(
                state, color=compute_color(cameras, colors, state.position)
            )

    log.info("distributed densify done: %s", metrics.summary())
    return DensifyResult(patches=state, metrics=metrics)
