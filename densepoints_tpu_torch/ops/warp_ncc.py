"""The compacted-slot warp+NCC scoring pass: (B, M) NCC against slot 0.

Patch b carries M view slots `view_ids[b]` with flags `ok[b]`; slot 0 is
the anchor (its first visible view). scores[b, m] is NCC(texture of slot 0,
texture of slot m), slot 0 against itself included (1.0 for a textured
anchor, variance / 0.1 below the denominator clamp). A slot is valid when
its `ok` is set and all 4 corners p -+ sx -+ sy project strictly inside its
view; the score is -1 unless slot m and slot 0 are both valid. Sampling,
statistics and clamp are those of `ops.allview_ncc`: this is a second
derivation of the same scores, by slots instead of a visibility row.

On CUDA tensors `slot_scores` launches the hand-written kernel in
`csrc/slot_ncc.cu` or raises; the kernel computes the patch frames itself,
so no torch op runs before the launch (slot tables are handed over as
int32). On CPU tensors it runs `slot_scores_plain`
(gathered textures through `patch_textures_indexed`, then row-wise NCC).
`KERNEL_LAUNCHES` and `PLAIN_CALLS` count which path ran.
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.ops import _build
from densepoints_tpu_torch.ops.ncc import ncc_pairs_plain
from densepoints_tpu_torch.ops.warp import (
    compact_visible,
    patch_textures_indexed,
)

__all__ = [
    "patch_ncc_scores_fused",
    "slot_scores",
    "gather_scores",
    "slot_scores_plain",
    "slot_scores_cuda",
    "KERNEL_LAUNCHES",
    "PLAIN_CALLS",
]

KERNEL_LAUNCHES = 0  # kernel launches, counted where the kernel launches
PLAIN_CALLS = 0  # calls answered by the plain torch version (CPU tensors)

_VP, _I64 = _build.VOID_P, _build.INT64
_ARGTYPES = (
    _VP, _I64, _I64, _I64,  # images, V, H, W
    _VP, _VP, _VP, _VP, _VP, _VP,  # K, E, C, x_axis, width, height
    _VP, _VP, _VP, _VP, _VP,  # position, normal, ref, view_ids, ok
    _I64, _I64, _build.INT,  # B, M, k
    _VP, _VP,  # scores, stream
)


def slot_scores_cuda(
    images: torch.Tensor,
    K: torch.Tensor,
    E: torch.Tensor,
    C: torch.Tensor,
    x_axis: torch.Tensor,
    width: torch.Tensor,
    height: torch.Tensor,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    view_ids: torch.Tensor,
    ok: torch.Tensor,
    texture_size: int,
):
    """Launch the CUDA kernel on the current stream; nothing else runs on
    the device (the kernel computes the patch frames itself).

    images (V, H, W) f32; K (V, 3, 3), E (V, 3, 4), C, x_axis (V, 3) f32;
    width, height (V,) int32; position, normal (B, 3) f32; ref (B,) int64
    (the kernel clamps it into [0, V)); view_ids (B, M) int32 (a slot whose
    id lies outside 0..V-1 counts as not ok); ok (B, M) bool; all contiguous
    on one CUDA device. Returns scores (B, M) f32.
    """
    global KERNEL_LAUNCHES
    k = int(texture_size)
    if view_ids.ndim != 2 or view_ids.shape[1] < 1:
        raise ValueError(
            f"view_ids has shape {tuple(view_ids.shape)}, expected (B, M >= 1)"
        )
    M = view_ids.shape[1]
    V, H, W, B = _build.check_warp_scene(
        images, K, position, normal, ref, k, entries=M
    )
    dev = images.device
    if dev.type != "cuda":
        raise ValueError(f"slot_scores_cuda needs CUDA tensors, got {dev}")
    check = _build.check_tensor
    check("images", images, dev, torch.float32, (V, H, W))
    check("K", K, dev, torch.float32, (V, 3, 3))
    check("E", E, dev, torch.float32, (V, 3, 4))
    check("C", C, dev, torch.float32, (V, 3))
    check("x_axis", x_axis, dev, torch.float32, (V, 3))
    check("width", width, dev, torch.int32, (V,))
    check("height", height, dev, torch.int32, (V,))
    check("position", position, dev, torch.float32, (B, 3))
    check("normal", normal, dev, torch.float32, (B, 3))
    check("ref", ref, dev, torch.int64, (B,))
    check("view_ids", view_ids, dev, torch.int32, (B, M))
    check("ok", ok, dev, torch.bool, (B, M))
    scores = torch.empty((B, M), dtype=torch.float32, device=dev)
    if B == 0:
        return scores
    KERNEL_LAUNCHES += 1
    _build.launch(
        "slot_ncc_launch", _ARGTYPES, dev,
        images.data_ptr(), V, H, W,
        K.data_ptr(), E.data_ptr(), C.data_ptr(), x_axis.data_ptr(),
        width.data_ptr(), height.data_ptr(),
        position.data_ptr(), normal.data_ptr(), ref.data_ptr(),
        view_ids.data_ptr(), ok.data_ptr(),
        B, M, k, scores.data_ptr(),
    )
    return scores


def gather_scores(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    view_ids: torch.Tensor,
    ok: torch.Tensor,
    texture_size: int,
    ncc,
    frames=None,
):
    """The gather route to the (B, M) contract: textures of every slot
    through `patch_textures_indexed`, then the row-wise NCC `ncc(a, b)` of
    each against slot 0's. With `ops.ncc.ncc_pairs` it is the "xla" route of
    `pmvs.optimize.patch_ncc_scores` (the row-wise NCC kernel on CUDA
    tensors); with `ncc_pairs_plain` it is the slot kernel's plain version."""
    tex, valid = patch_textures_indexed(
        images, cameras, position, normal, ref, view_ids, ok, texture_size,
        frames=frames,
    )
    B, M = valid.shape
    n = texture_size * texture_size  # spelt out: B may be 0
    flat = tex.reshape(B, M, n)
    aflat = flat[:, :1].expand_as(flat)
    scores = ncc(
        aflat.reshape(B * M, n), flat.reshape(B * M, n)
    ).reshape(B, M)
    return torch.where(valid & valid[:, :1], scores, -1.0)


def slot_scores_plain(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    view_ids: torch.Tensor,
    ok: torch.Tensor,
    texture_size: int,
    frames=None,
):
    """Plain torch version of the slot kernel: the gather route with the
    plain row-wise NCC."""
    return gather_scores(
        images, cameras, position, normal, ref, view_ids, ok, texture_size,
        ncc_pairs_plain, frames=frames,
    )


def slot_scores(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    view_ids: torch.Tensor,
    ok: torch.Tensor,
    texture_size: int,
):
    """scores (B, M): the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors."""
    global PLAIN_CALLS
    if images.device.type == "cpu":
        PLAIN_CALLS += 1
        return slot_scores_plain(
            images, cameras, position, normal, ref, view_ids, ok,
            texture_size,
        )
    return slot_scores_cuda(
        images, cameras.K.contiguous(), cameras.E.contiguous(),
        cameras.C.contiguous(), cameras.x_axis.contiguous(),
        cameras.width, cameras.height,
        position.contiguous(), normal.contiguous(),
        ref.to(torch.int64).contiguous(),
        view_ids.to(torch.int32).contiguous(), ok.contiguous(), texture_size,
    )


def patch_ncc_scores_fused(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    vis: torch.Tensor,
    texture_size: int,
    max_score_views: int = 16,
    view_ids=None,
    ok=None,
):
    """The kernel route of `pmvs.optimize.patch_ncc_scores`, CUDA tensors
    only: (scores (B, M), view_ids (B, M), ok (B, M)). Explicit
    `view_ids`/`ok` replace the default compaction of `vis`."""
    if images.device.type != "cuda":
        raise ValueError(
            f"patch_ncc_scores_fused needs CUDA tensors, got {images.device}: "
            "the kernel has no CPU mode"
        )
    if view_ids is None:
        view_ids, ok = compact_visible(vis, max_score_views)
    scores = slot_scores(
        images, cameras, position, normal, ref, view_ids, ok, texture_size
    )
    return scores, view_ids, ok
