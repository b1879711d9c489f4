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

`patch_ncc_scores`, `_anchor_chunks` and `photometric_objective` are the
compacted-slot ("chunked") derivation of the same scores and the same
objective. No stage dispatches them; they are the parity reference the
all-views path is held against, on the CPU and on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from densepoints_tpu_torch.config import OptimizeConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.ops.allview_ncc import allview_scores
from densepoints_tpu_torch.ops.ncc import ncc_pairs
from densepoints_tpu_torch.ops.simplex import nelder_mead
from densepoints_tpu_torch.ops.warp import compact_visible
from densepoints_tpu_torch.ops.warp_ncc import (
    gather_scores,
    patch_ncc_scores_fused,
    slot_scores,
)
from densepoints_tpu_torch.pmvs.patch import PatchState

__all__ = [
    "parametrize",
    "unparametrize",
    "patch_ncc_scores",
    "photometric_objective",
    "photometric_objective_paged",
    "filter_by_error",
    "optimize_patches",
]


def parametrize(cameras: Cameras, position, normal, ref):
    """(depth, roll, pitch) of the current patch pose. Diagnostic: the
    solver always starts at 0 relative."""
    depth = torch.linalg.norm(position - cameras.C[ref], dim=-1)
    x_axis = cameras.x_axis[ref]
    y_axis = torch.linalg.cross(normal, x_axis)
    z_axis = torch.linalg.cross(x_axis, y_axis)
    roll = torch.atan2(z_axis[..., 1], z_axis[..., 2])
    pitch = torch.atan2(
        -z_axis[..., 0],
        torch.sqrt(z_axis[..., 1] ** 2 + z_axis[..., 2] ** 2),
    )
    return depth, roll, pitch


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


def patch_ncc_scores(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    vis: torch.Tensor,
    texture_size: int,
    max_score_views: int = 16,
    impl: str = "auto",
    view_ids=None,
    ok=None,
):
    """Per-slot NCC against the anchor (first visible) view's texture.

    Views are compacted to M = min(V, max_score_views) slots per patch;
    explicit `view_ids`/`ok` slot arrays score a chosen view subset instead
    (slot 0 must be the anchor). Returns (scores (B, M), view_ids (B, M),
    ok (B, M)); scores[b, 0] is the anchor against itself; slots whose warp
    is invalid or whose anchor is invalid score -1.

    `impl` dispatches on the tensors' device, with no fallback:
    "auto" = the slot kernel (`ops.warp_ncc`) for CUDA tensors, its plain
    version for CPU tensors; "fused" = the slot kernel, CUDA tensors only;
    "xla" = `ops.warp_ncc.gather_scores`: gathered textures in torch, then
    `ops.ncc.ncc_pairs` (the row-wise NCC kernel for CUDA tensors, its plain
    version on the CPU).
    """
    if impl == "fused":
        return patch_ncc_scores_fused(
            images, cameras, position, normal, ref, vis, texture_size,
            max_score_views, view_ids=view_ids, ok=ok,
        )
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown sampling impl {impl!r}")
    if view_ids is None:
        view_ids, ok = compact_visible(vis, max_score_views)
    args = (images, cameras, position, normal, ref, view_ids, ok, texture_size)
    if impl == "auto":
        return slot_scores(*args), view_ids, ok
    return gather_scores(*args, ncc_pairs), view_ids, ok


def _anchor_chunks(vis: torch.Tensor, max_views: int):
    """Split each patch's visible set into anchor-pinned slot chunks.

    Every chunk is (view_ids (B, M) int32, ok (B, M)) with slot 0 = the
    patch's FIRST visible view (the anchor texture) and up to M-1 payload
    views in ascending view order. Together the chunks cover ALL visible
    views, so scenes with V > max_views score every view. The tail chunk is
    padded to the same width with the anchor's id and ok False.
    """
    B, V = vis.shape
    M = min(V, max_views)
    order = torch.argsort((~vis).to(torch.uint8), dim=1, stable=True)
    okf = torch.gather(vis, 1, order)
    payload = max(M - 1, 1)
    n_chunks = max(1, -(-(V - 1) // payload))
    chunks = []
    for c in range(n_chunks):
        lo = 1 + c * payload
        hi = min(lo + payload, V)
        pad = payload - (hi - lo)
        ids = torch.cat(
            [order[:, :1], order[:, lo:hi], order[:, :1].expand(B, pad)], dim=1
        )
        ok = torch.cat(
            [okf[:, :1], okf[:, lo:hi], okf.new_zeros((B, pad))], dim=1
        )
        chunks.append((ids.to(torch.int32), ok))
    return chunks


def photometric_objective(
    images: torch.Tensor,
    cameras: Cameras,
    position0: torch.Tensor,
    normal0: torch.Tensor,
    ref: torch.Tensor,
    vis: torch.Tensor,
    texture_size: int,
    impl: str = "auto",
    max_score_views: int = 16,
):
    """Chunked batched objective f(params (B, K, 3)) -> (B, K).

    Same semantics as `photometric_objective_paged` (mean of 1 - NCC over
    every visible non-anchor view, 2 where none), with the views scored in
    anchor-pinned chunks of `max_score_views` slots (`_anchor_chunks`)
    through `patch_ncc_scores(impl=impl)`.
    """
    C_ref = cameras.C[ref]
    chunks = _anchor_chunks(vis, max_score_views)

    def f(params: torch.Tensor) -> torch.Tensor:
        B, K, _ = params.shape
        pos, nrm = unparametrize(
            params, position0[:, None, :], normal0[:, None, :],
            C_ref[:, None, :],
        )
        pos = pos.reshape(B * K, 3)
        nrm = nrm.reshape(B * K, 3)
        ref_bk = ref.repeat_interleave(K)
        vis_bk = vis.repeat_interleave(K, dim=0)
        err_sum = params.new_zeros((B * K,))
        n_sum = torch.zeros((B * K,), dtype=torch.int64, device=params.device)
        for chunk_ids, chunk_ok in chunks:
            scores, _, ok = patch_ncc_scores(
                images, cameras, pos, nrm, ref_bk, vis_bk, texture_size,
                impl=impl,
                view_ids=chunk_ids.repeat_interleave(K, dim=0),
                ok=chunk_ok.repeat_interleave(K, dim=0),
            )
            counted = ok.clone()
            counted[:, 0] = False  # visible slots except the anchor
            err_sum = err_sum + torch.where(counted, 1.0 - scores, 0.0).sum(1)
            n_sum = n_sum + counted.sum(dim=1)
        cost = torch.where(n_sum > 0, err_sum / n_sum.clamp_min(1), 2.0)
        return cost.reshape(B, K)

    return f


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
    """One production scoring semantics: the all-views pass. The chunked
    values "fused" and "xla" are retired for the stages, loudly."""
    if impl not in ("auto", "paged"):
        raise ValueError(
            f"sampling_impl {impl!r} was retired: the all-views pass "
            "(ops.allview_ncc) is the single production scoring semantics. "
            "The chunked implementation remains available as a parity "
            "reference (patch_ncc_scores / photometric_objective with "
            "impl='fused' or 'xla')."
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
