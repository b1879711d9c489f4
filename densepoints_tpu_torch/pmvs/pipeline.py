"""The end-to-end densification driver (single host, one device).

Pipeline: seeds (detect/match/track/triangulate) -> patches -> NCC filter
-> batched simplex optimization -> wavefront expansion -> visibility
filters -> colours -> PLY.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from densepoints_tpu_torch.config import PipelineConfig
from densepoints_tpu_torch.io.ply import write_ply
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.pmvs.expand import expand_patches
from densepoints_tpu_torch.pmvs.filter import run_filters
from densepoints_tpu_torch.pmvs.optimize import filter_by_error, optimize_patches
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints_tpu_torch.pmvs.visibility import compute_color
from densepoints_tpu_torch.utils import StageMetrics, log

__all__ = ["densify", "DensifyResult", "check_supported"]


@dataclasses.dataclass
class DensifyResult:
    patches: PatchState
    metrics: StageMetrics

    @property
    def positions(self) -> np.ndarray:
        return self.patches.position.cpu().numpy()

    @property
    def normals(self) -> np.ndarray:
        return self.patches.normal.cpu().numpy()

    @property
    def colors(self) -> np.ndarray:
        return np.clip(self.patches.color.cpu().numpy(), 0, 255).astype(
            np.uint8
        )

    def save_ply(self, path, binary: bool = True):
        write_ply(path, self.positions, self.normals, self.colors,
                  binary=binary)


def check_supported(config: PipelineConfig):
    """Raise NotImplementedError for pipeline branches the port lacks (an
    unknown detector, matcher, pre-screen mode or sampling route raises
    ValueError in its own stage module). `runtime.resume` without a
    checkpoint directory is a plain run, as in the JAX package, which
    resumes only when both are set."""
    unsupported = [
        (config.ba.enable, "ba.enable", "A.11"),
        (config.multiscale.levels > 1, "multiscale.levels > 1", "A.11"),
        (bool(config.runtime.checkpoint_dir), "runtime.checkpoint_dir",
         "A.9"),
        (bool(config.runtime.debug_dir), "runtime.debug_dir", "A.9"),
        (bool(config.runtime.profile_dir), "runtime.profile_dir", "A.9"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to densepoints_tpu_torch yet "
                f"(ROADMAP {item})"
            )


def densify(
    scene: Scene, config: PipelineConfig = PipelineConfig(), device="cuda"
) -> DensifyResult:
    """Run the full PMVS pipeline on a loaded scene on `device`."""
    check_supported(config)
    device = torch.device(device)
    sync = (
        (lambda: torch.cuda.synchronize(device))
        if device.type == "cuda" else None
    )
    metrics = StageMetrics(sync=sync)
    cameras = scene.cameras.to(device)
    images = torch.as_tensor(scene.images, dtype=torch.float32, device=device)

    with metrics.stage("seed"):
        points, _, _ = generate_seed_points(images, cameras, config.matching)

    with metrics.stage("seed_patches"):
        state = create_patches_from_points(
            cameras, points, config.optimize, config.seed
        )
    metrics.count("seed_points", state.capacity)

    with metrics.stage("seed_filter"):
        state = filter_by_error(
            images, cameras, state, config.seed.texture_size, config.optimize
        ).compact()
    metrics.count("seeds_after_ncc", state.capacity)
    log.info("seeds surviving NCC filter: %d", state.capacity)

    with metrics.stage("seed_optimize"):
        if state.capacity:
            state = optimize_patches(
                images, cameras, state, config.seed.texture_size,
                config.optimize,
            )

    with metrics.stage("expand"):
        state, _ = expand_patches(
            images, cameras, state, config.expand, config.organizer,
            config.optimize,
        )
    metrics.count("patches_after_expand", state.capacity)

    with metrics.stage("filter"):
        state = run_filters(
            cameras, state, config.filter, config.optimize,
            config.organizer.grid_scale,
        ).compact()
    metrics.count("patches_final", state.capacity)

    with metrics.stage("color"):
        if scene.colors is not None and state.capacity:
            colors = torch.as_tensor(scene.colors, device=device)
            state = dataclasses.replace(
                state, color=compute_color(cameras, colors, state.position)
            )

    log.info("densify done: %s", metrics.summary())
    return DensifyResult(patches=state, metrics=metrics)
