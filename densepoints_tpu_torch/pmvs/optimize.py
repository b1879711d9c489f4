"""Photometric patch optimization and NCC-based visibility filtering.

  * parametrization (depth, roll, pitch): depth along the reference ray
    RELATIVE to the current position (position' = C + (1+depth)(p - C)),
    compositional rotation of the normal by an explicit roll/pitch matrix;
  * objective: mean over non-anchor visible views of (1 - NCC(tex_anchor,
    tex_v)) in [0, 2]; invalid warps score NCC = -1 (-> penalty 2); no
    scorable views -> 2. The anchor is the FIRST truly-visible view;
  * solver: Nelder-Mead from x0 = 0 (or the best of a depth sweep) with
    init step (0.02, 0.2, 0.2), batched over every patch via ops/simplex;
  * filter: per visible non-anchor view NCC against the anchor texture;
    views under `score_threshold` are dropped from the visible mask, and
    the patch dies with fewer than `min_visible_views` remaining.

Both stages score through `ops.allview_ncc.allview_scores` (the CUDA
kernel on the GPU) and process at most `max_refine_batch` patches per
slice, a memory bound.
"""
from __future__ import annotations

import dataclasses

import torch

from densepoints_tpu_torch.config import OptimizeConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.ops.allview_ncc import allview_scores
from densepoints_tpu_torch.ops.simplex import nelder_mead
from densepoints_tpu_torch.pmvs.patch import PatchState

__all__ = [
    "unparametrize",
    "photometric_objective_paged",
    "filter_by_error",
    "optimize_patches",
]


def _rotation(roll, pitch):
    """The explicit roll/pitch rotation, (..., 3, 3)."""
    ca, sa = torch.cos(roll), torch.sin(roll)
    cb, sb = torch.cos(pitch), torch.sin(pitch)
    zero = torch.zeros_like(ca)
    return torch.stack(
        [
            torch.stack([cb, zero, -sb], -1),
            torch.stack([sa * sb, ca, cb * sa], -1),
            torch.stack([ca * sb, -sa, ca * cb], -1),
        ],
        -2,
    )


def unparametrize(params, position0, normal0, C_ref):
    """Apply relative (depth, roll, pitch) params (..., 3) to the pose."""
    depth = params[..., 0:1]
    position = C_ref + (1.0 + depth) * (position0 - C_ref)
    R = _rotation(params[..., 1], params[..., 2])
    normal = torch.einsum("...ij,...j->...i", R, normal0)
    return position, normal


def _payload(vis: torch.Tensor) -> torch.Tensor:
    """Visible views other than the anchor (the first visible view)."""
    anchor = torch.argmax(vis.to(torch.uint8), dim=1)
    cols = torch.arange(vis.shape[1], device=vis.device)
    return vis & (cols[None, :] != anchor[:, None])


def photometric_objective_paged(
    images: torch.Tensor,
    cameras: Cameras,
    position0: torch.Tensor,
    normal0: torch.Tensor,
    ref: torch.Tensor,
    vis: torch.Tensor,
    texture_size: int,
):
    """All-views batched objective f(params (B, K, 3)) -> (B, K).

    The K candidate points of every lane are scored in ONE scoring pass
    over B * K rows (rows are independent, so this equals K passes)."""
    payload = _payload(vis)
    n_payload = payload.sum(dim=1)
    C_ref = cameras.C[ref]

    def f(params: torch.Tensor) -> torch.Tensor:
        B, K, _ = params.shape
        pos, nrm = unparametrize(
            params, position0[:, None, :], normal0[:, None, :],
            C_ref[:, None, :],
        )
        scores, _, _ = allview_scores(
            images, cameras, pos.reshape(B * K, 3), nrm.reshape(B * K, 3),
            ref.repeat_interleave(K), vis.repeat_interleave(K, dim=0),
            texture_size,
        )
        err = torch.where(
            payload[:, None, :], 1.0 - scores.reshape(B, K, -1), 0.0
        ).sum(dim=2)
        n = n_payload[:, None]
        return torch.where(n > 0, err / torch.clamp_min(n, 1), 2.0)

    return f


def _sliced(fn, images, cameras, state: PatchState, texture_size, config):
    """Run a per-patch stage over `max_refine_batch` slices (memory bound)."""
    B = state.capacity
    mb = config.max_refine_batch
    if mb <= 0 or B <= mb:
        return fn(images, cameras, state, texture_size, config)
    outs = [
        fn(images, cameras, state.map(lambda a: a[lo : lo + mb]),
           texture_size, config)
        for lo in range(0, B, mb)
    ]
    return PatchState.concatenate(outs)


def _check_impl(impl: str):
    if impl not in ("auto", "paged"):
        raise NotImplementedError(
            f"sampling_impl {impl!r}: the port scores through the all-views "
            "pass only; the chunked parity path waits (ROADMAP B, K2 and K3)"
        )


def filter_by_error(
    images: torch.Tensor,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    config: OptimizeConfig = OptimizeConfig(),
) -> PatchState:
    """NCC visibility pruning + patch rejection, in slices."""
    _check_impl(config.sampling_impl)
    return _sliced(
        _filter_by_error_once, images, cameras, state, texture_size, config
    )


def _filter_by_error_once(images, cameras, state, texture_size, config):
    B, V = state.vis.shape
    scores, anchor, _ = allview_scores(
        images, cameras, state.position, state.normal, state.ref,
        state.vis, texture_size,
    )
    cols = torch.arange(V, device=state.vis.device)[None, :]
    has = state.vis.any(dim=1)
    payload = state.vis & (cols != anchor[:, None])
    anchor_slot = (cols == anchor[:, None]) & has[:, None]
    new_vis = anchor_slot | (payload & (scores >= config.score_threshold))
    alive = (
        state.alive
        & (payload.sum(dim=1) > 0)
        & (new_vis.sum(dim=1) >= config.min_visible_views)
    )
    return dataclasses.replace(state, vis=new_vis, alive=alive)


def optimize_patches(
    images: torch.Tensor,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    config: OptimizeConfig = OptimizeConfig(),
) -> PatchState:
    """Batched (depth, roll, pitch) refinement of every patch, in slices.

    Slicing changes the batch each Nelder-Mead early exit couples over, so
    results can differ (both validly converged) between slice widths."""
    _check_impl(config.sampling_impl)
    return _sliced(
        _optimize_patches_once, images, cameras, state, texture_size, config
    )


def _optimize_patches_once(images, cameras, state, texture_size, config):
    f = photometric_objective_paged(
        images, cameras, state.position, state.normal, state.ref,
        state.vis, texture_size,
    )
    B = state.capacity
    dt, dev = state.position.dtype, state.position.device
    x0 = torch.zeros((B, 3), dtype=dt, device=dev)
    if config.depth_sweep_steps > 1:
        # Depth-sweep re-init: one batched objective call over D relative
        # depths along the reference ray; Nelder-Mead starts from the best.
        D = config.depth_sweep_steps
        depths = torch.linspace(
            -config.depth_sweep_span, config.depth_sweep_span, D,
            dtype=dt, device=dev,
        )
        sweep = torch.zeros((B, D, 3), dtype=dt, device=dev)
        sweep[:, :, 0] = depths[None, :]
        best = torch.argmin(f(sweep), dim=1)
        x0[:, 0] = depths[best]
    init_step = torch.tensor(
        [config.init_step_depth, config.init_step_angle,
         config.init_step_angle],
        dtype=dt, device=dev,
    )
    x_best, _, _ = nelder_mead(
        f, x0, init_step,
        max_iterations=config.max_iterations, tolerance=config.tolerance,
    )
    pos, nrm = unparametrize(
        x_best, state.position, state.normal, cameras.C[state.ref]
    )
    keep = state.alive[:, None]
    return dataclasses.replace(
        state,
        position=torch.where(keep, pos, state.position),
        normal=torch.where(keep, nrm, state.normal),
    )
