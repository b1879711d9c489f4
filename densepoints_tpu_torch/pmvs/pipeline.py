"""The end-to-end densification driver (single host, one device).

Pipeline: seeds (detect/match/track/triangulate) -> patches -> NCC filter
-> batched simplex optimization -> wavefront expansion -> visibility
filters -> colours -> PLY. Optionally bundle adjustment (ba/) of the
seeds' cameras and multi-scale coarse-to-fine expansion (multiscale/).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from densepoints_tpu_torch.ba import BAProblem, reprojection_rmse, run_ba
from densepoints_tpu_torch.config import PipelineConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.io.ply import write_ply
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.multiscale import densify_multiscale
from densepoints_tpu_torch.pmvs.expand import expand_patches
from densepoints_tpu_torch.pmvs.filter import run_filters
from densepoints_tpu_torch.pmvs.optimize import filter_by_error, optimize_patches
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints_tpu_torch.pmvs.visibility import compute_color
from densepoints_tpu_torch.utils import StageMetrics, debug, log
from densepoints_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["densify", "DensifyResult"]


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


def _bundle_adjust(cameras: Cameras, points, obs, obs_mask, ba_config):
    """Refine cameras + seed points from the matched tracks (ba/), on the
    cameras' device. Returns (cameras, points (S, 3) numpy, RMSE px)."""
    dev = cameras.device
    tp, tv = np.nonzero(obs_mask)
    problem = BAProblem(
        K=cameras.K,
        R0=cameras.R,
        C0=cameras.C,
        points0=torch.as_tensor(points, dtype=torch.float32, device=dev),
        obs_point=torch.as_tensor(tp, dtype=torch.int64, device=dev),
        obs_view=torch.as_tensor(tv, dtype=torch.int64, device=dev),
        obs_xy=torch.as_tensor(obs[tp, tv], dtype=torch.float32, device=dev),
        obs_mask=torch.ones((len(tp),), dtype=torch.bool, device=dev),
    )
    R, C, new_points, _ = run_ba(
        problem,
        max_outer_iterations=ba_config.max_outer_iterations,
        cg_iterations=ba_config.cg_iterations,
        damping=ba_config.damping,
        robust_delta=ba_config.robust_delta,
    )
    rmse = float(reprojection_rmse(problem, R, C, new_points))
    # Rebuild cameras from the refined extrinsics (host f64 keeps the
    # decomposition invariants), back on the cameras' device.
    Rn = R.cpu().numpy().astype(np.float64)
    Cn = C.cpu().numpy().astype(np.float64)
    Kn = cameras.K.cpu().numpy().astype(np.float64)
    P = Kn @ np.concatenate([Rn, -Rn @ Cn[:, :, None]], axis=2)
    new_cams = Cameras.from_projection_matrices(
        P, widths=cameras.width.cpu().numpy(),
        heights=cameras.height.cpu().numpy(), device=dev,
    )
    return new_cams, new_points.cpu().numpy(), rmse


def densify(
    scene: Scene, config: PipelineConfig = PipelineConfig(), device="cuda"
) -> DensifyResult:
    """Run the full PMVS pipeline on a loaded scene on `device`.

    `config.runtime` adds the persistence and observability shell: stage
    checkpoints (and resume from the newest one), debug dumps, and a
    `torch.profiler` trace of the run (CPU, and CUDA on a CUDA device)
    written as `densify.pt.trace.json` into `runtime.profile_dir`.
    """
    device = torch.device(device)
    profile_dir = config.runtime.profile_dir
    if not profile_dir:
        return _densify_inner(scene, config, device)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = _densify_inner(scene, config, device)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "densify.pt.trace.json"))
    return result


def _checkpoint(rt, state, stage, cameras):
    if rt.checkpoint_dir:
        save_checkpoint(
            Path(rt.checkpoint_dir) / f"{stage}.npz", state, stage=stage,
            cameras=cameras,
        )


def _densify_inner(scene: Scene, config: PipelineConfig,
                   device: torch.device) -> DensifyResult:
    sync = (
        (lambda: torch.cuda.synchronize(device))
        if device.type == "cuda" else None
    )
    metrics = StageMetrics(sync=sync)
    cameras = scene.cameras.to(device)
    images = torch.as_tensor(scene.images, dtype=torch.float32, device=device)
    rt = config.runtime

    if rt.resume and rt.checkpoint_dir:
        ckpt = latest_checkpoint(rt.checkpoint_dir)
        if ckpt is not None:
            state, meta, ckpt_cams = load_checkpoint(ckpt, device=device)
            if ckpt_cams is not None:
                # BA refined the extrinsics before this checkpoint; resume
                # with the geometry the patches were optimized against.
                cameras = ckpt_cams
            log.info("resuming from %s (stage %s)", ckpt, meta.get("stage"))
            return _densify_from(images, cameras, scene, config, metrics,
                                 state, meta.get("stage"))

    with metrics.stage("seed"):
        points, obs, obs_mask = generate_seed_points(
            images, cameras, config.matching
        )

    if config.ba.enable and len(points) >= 8:
        with metrics.stage("bundle_adjust"):
            cameras, points, rmse = _bundle_adjust(
                cameras, points, obs, obs_mask, config.ba
            )
        metrics.count("ba_rmse_px", rmse)
        log.info("bundle adjustment: reprojection RMSE %.3f px", rmse)

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
    _checkpoint(rt, state, "seeds_optimized", cameras)

    return _densify_from(
        images, cameras, scene, config, metrics, state, "seeds_optimized"
    )


def _densify_from(images, cameras, scene, config, metrics, state,
                  stage) -> DensifyResult:
    """Run the pipeline from `stage` onward (also the resume entry point).

    Stages: seeds_optimized -> expanded -> final. Checkpoints carry the
    cameras beside the patch state, so a resumed run reconstructs with the
    (possibly BA-refined) extrinsics the patches were optimized against.
    """
    rt = config.runtime
    if rt.debug_dir and stage == "seeds_optimized":
        debug.dump_cloud(rt.debug_dir, "seeds", state)

    if stage == "seeds_optimized":
        if config.multiscale.levels > 1:
            with metrics.stage("expand_multiscale"):
                state = densify_multiscale(images, cameras, state, config,
                                           metrics)
            metrics.count("patches_final", state.capacity)
            _checkpoint(rt, state, "final", cameras)
            stage = "final"
        else:
            with metrics.stage("expand"):
                state, grids = expand_patches(
                    images, cameras, state, config.expand, config.organizer,
                    config.optimize,
                )
            metrics.count("patches_after_expand", state.capacity)
            if rt.debug_dir:
                debug.dump_occupancy(rt.debug_dir, grids)
            _checkpoint(rt, state, "expanded", cameras)
            stage = "expanded"

    if stage == "expanded":
        with metrics.stage("filter"):
            state = run_filters(
                cameras, state, config.filter, config.optimize,
                config.organizer.grid_scale,
            ).compact()
        metrics.count("patches_final", state.capacity)
        _checkpoint(rt, state, "final", cameras)

    with metrics.stage("color"):
        if scene.colors is not None and state.capacity:
            colors = torch.as_tensor(scene.colors, device=images.device)
            state = dataclasses.replace(
                state, color=compute_color(cameras, colors, state.position)
            )

    if rt.debug_dir:
        debug.dump_cloud(rt.debug_dir, "final", state)

    log.info("densify done: %s", metrics.summary())
    return DensifyResult(patches=state, metrics=metrics)
