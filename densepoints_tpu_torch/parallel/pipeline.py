"""Multi-rank end-to-end densification (`densify_distributed`).

The single-host driver with its two hot stages swapped for the split
versions: patch refinement runs on each rank's row block
(`distributed_refine_step`) and occupancy insertion agrees across ranks by
the MIN-merge of claims (`distributed_insert`). Expansion is
`pmvs/expand.py`'s `wavefront` with those two as its `refine` and `insert`
(`_SplitOps`; compaction on the device, no pre-screen), so it opens
expansion's spans and reports its counters as `densify` does. Seeds come
from the same deterministic path on every rank.

`seed_refine_patches_per_sec` in the metrics is the refine rate of the
seed stage, the ratio a 1-rank and an N-rank run are compared by.

Outside a job, `densify_distributed(scene, config)` spans
`make_mesh(config.parallel.num_devices or None)` as in JAX: every card
when `num_devices` is 0. A mesh of L > 1 ranks made there runs the call
as a job of L ranks started for it (`parallel/local_job.py`).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from densepoints_tpu_torch.config import PipelineConfig
from densepoints_tpu_torch.features import matching
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.ops import allview_ncc, simplex
from densepoints_tpu_torch.parallel.distributed import (
    distributed_insert,
    distributed_refine_step,
)
from densepoints_tpu_torch.parallel.mesh import Mesh, make_mesh
from densepoints_tpu_torch.pmvs import expand
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


class _SplitOps(expand.DeviceOps):
    """`densify_distributed`'s wavefront ops: the one-card compaction, the
    candidates without the pre-screen, refinement on each rank's row block
    (`config.optimize`'s iterations) and insertion into replicated grids
    by the MIN-merge of claims."""

    def __init__(self, mesh: Mesh, images, cameras, config: PipelineConfig):
        super().__init__(images, cameras, config.expand, config.organizer,
                         config.optimize)
        self.mesh, self.config = mesh, config

    def candidates(self, grids, frontier, n):
        return make_expansion_candidates(self.cameras, frontier,
                                         self.grid_scale), 4 * n

    def refine(self, cand):
        return distributed_refine_step(
            self.images, self.cameras, cand, self.texture_size,
            self.config.optimize, mesh=self.mesh,
        )

    def insert(self, grids, state, first_id):
        ids = torch.arange(first_id, first_id + state.capacity,
                           device=state.position.device)
        return distributed_insert(self.mesh, grids, self.cameras, state,
                                  ids, self.config.organizer)


def densify_distributed(
    scene: Scene,
    config: PipelineConfig = PipelineConfig(),
    mesh: Mesh | None = None,
    device=None,
) -> DensifyResult:
    """Every rank calls this with the same scene and config and receives
    the same result. Without `mesh`, `make_mesh(config.parallel.num_devices
    or None, device)` (`device` default cuda): the job's mesh inside a job;
    outside one, that many cards (every card for 0) or CPU ranks. Given a
    mesh of L > 1 ranks not yet started (`make_mesh` outside a job), the
    call runs as a job of L ranks started for it and returns rank 0's
    result (`parallel/local_job.py`)."""
    if mesh is None:
        mesh = make_mesh(config.parallel.num_devices or None, device=device)
    if not mesh.started:
        from densepoints_tpu_torch.parallel import local_job

        return local_job.run("densify_distributed", mesh, scene=scene,
                             config=config)
    metrics = StageMetrics(sync=_sync(mesh))
    nm_before, k1_before = simplex.counts(), allview_ncc.counts()
    expand_before, match_before = expand.counts(), matching.counts()
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

    with metrics.stage("expand"):
        state, _, n = expand.wavefront(
            _SplitOps(mesh, images, cameras, config), state,
            make_grids(cameras, config.organizer.grid_scale), config.expand)
    metrics.count("patches_after_expand", n)

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

    simplex.count_since(metrics, nm_before)
    allview_ncc.count_since(metrics, k1_before)
    expand.count_since(metrics, expand_before)
    matching.count_since(metrics, match_before)
    log.info("distributed densify done: %s", metrics.summary())
    return DensifyResult(patches=state, metrics=metrics)
