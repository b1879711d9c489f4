"""The all-views warp+NCC scoring pass: (B, V) NCC against the anchor view.

`allview_scores` is the one photometric primitive of the main path: every
`filter_by_error` call and every Nelder-Mead objective evaluation goes
through it. For patch b the anchor is its first visible view;
scores[b, v] is NCC(anchor texture, view-v texture) for every visible
non-anchor view with a valid warp (all 4 corners strictly inside the view)
while the anchor's warp is valid too, and -1 everywhere else (the anchor's
own column, invisible views, rows with no visible view).

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/allview_ncc.cu` (built with nvcc for sm_90a at first use and bound
with ctypes by `ops/_build.py`) or raises; the kernel takes position,
normal and reference view and computes the patch frames itself, so no torch
op runs before the launch. On a CPU tensor it runs `allview_scores_plain`,
the plain torch version of the same contract (frames by
`ops.warp.patch_frames`).
`KERNEL_LAUNCHES` and `PLAIN_CALLS` count which path ran.
"""
from __future__ import annotations

import torch

from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.core.scores import NCC_MIN_DENOM
from densepoints_tpu_torch.ops import _build
from densepoints_tpu_torch.ops.warp import patch_textures

__all__ = [
    "allview_scores",
    "allview_scores_plain",
    "allview_scores_cuda",
    "build_kernel",
    "KERNEL_LAUNCHES",
    "PLAIN_CALLS",
]

KERNEL_LAUNCHES = 0  # kernel launches, counted where the kernel launches
PLAIN_CALLS = 0  # calls answered by the plain torch version (CPU tensors)

_VP, _I64 = _build.VOID_P, _build.INT64
_ARGTYPES = (
    _VP, _I64, _I64, _I64,  # images, V, H, W
    _VP, _VP, _VP, _VP, _VP, _VP,  # K, E, C, x_axis, width, height
    _VP, _VP, _VP, _VP,  # position, normal, ref, vis
    _I64, _build.INT,  # B, k
    _VP, _VP, _VP, _VP,  # scores, anchor, anchor_ok, stream
)

build_kernel = _build.build_library  # builds every kernel of the package
_check = _build.check_tensor


def allview_scores_cuda(
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
    vis: torch.Tensor,
    texture_size: int,
):
    """Launch the CUDA kernel on the current stream; nothing else runs on
    the device (the kernel computes the patch frames itself).

    images (V, H, W) f32; K (V, 3, 3), E (V, 3, 4), C, x_axis (V, 3) f32;
    width, height (V,) int32; position, normal (B, 3) f32; ref (B,) int64
    (the kernel clamps it into [0, V)); vis (B, V) bool; all contiguous on
    one CUDA device. Returns (scores (B, V) f32, anchor (B,) int64,
    anchor_ok (B,) bool).
    """
    global KERNEL_LAUNCHES
    k = int(texture_size)
    V, H, W, B = _build.check_warp_scene(
        images, K, position, normal, ref, k, entries=images.shape[0]
    )
    dev = images.device
    if dev.type != "cuda":
        raise ValueError(f"allview_scores_cuda needs CUDA tensors, got {dev}")
    _check("images", images, dev, torch.float32, (V, H, W))
    _check("K", K, dev, torch.float32, (V, 3, 3))
    _check("E", E, dev, torch.float32, (V, 3, 4))
    _check("C", C, dev, torch.float32, (V, 3))
    _check("x_axis", x_axis, dev, torch.float32, (V, 3))
    _check("width", width, dev, torch.int32, (V,))
    _check("height", height, dev, torch.int32, (V,))
    _check("position", position, dev, torch.float32, (B, 3))
    _check("normal", normal, dev, torch.float32, (B, 3))
    _check("ref", ref, dev, torch.int64, (B,))
    _check("vis", vis, dev, torch.bool, (B, V))
    scores = torch.empty((B, V), dtype=torch.float32, device=dev)
    anchor = torch.empty((B,), dtype=torch.int64, device=dev)
    anchor_ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return scores, anchor, anchor_ok
    KERNEL_LAUNCHES += 1
    _build.launch(
        "allview_ncc_launch", _ARGTYPES, dev,
        images.data_ptr(), V, H, W,
        K.data_ptr(), E.data_ptr(), C.data_ptr(), x_axis.data_ptr(),
        width.data_ptr(), height.data_ptr(),
        position.data_ptr(), normal.data_ptr(), ref.data_ptr(),
        vis.data_ptr(),
        B, k,
        scores.data_ptr(), anchor.data_ptr(), anchor_ok.data_ptr(),
    )
    return scores, anchor, anchor_ok


def allview_scores_plain(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    vis: torch.Tensor,
    texture_size: int,
    frames=None,
):
    """Plain torch version of the (B, V) contract (gather-based sampling
    of every patch in every view through `patch_textures`)."""
    B, V = vis.shape
    k = texture_size
    n = float(k * k)
    tex, valid = patch_textures(
        images, cameras, position, normal, ref, vis, k, frames=frames
    )  # valid = corner-valid & vis
    flat = tex.reshape(B, V, k * k).to(torch.float32)
    anchor = torch.argmax(vis.to(torch.uint8), dim=1)
    has = vis.any(dim=1)
    bidx = torch.arange(B, device=vis.device)
    aflat = flat[bidx, anchor]  # (B, k*k)
    aok = valid[bidx, anchor] & has
    cam_ = aflat - aflat.mean(dim=1, keepdim=True)
    sa = torch.sqrt((cam_ * cam_).sum(dim=1) / n)
    ct = flat - flat.mean(dim=2, keepdim=True)
    st = torch.sqrt((ct * ct).sum(dim=2) / n)
    cov = (ct * cam_[:, None, :]).sum(dim=2) / n
    den = torch.clamp_min(sa[:, None] * st, NCC_MIN_DENOM)
    cols = torch.arange(V, device=vis.device)[None, :]
    payload = vis & (cols != anchor[:, None])
    scores = torch.where(payload & valid & aok[:, None], cov / den, -1.0)
    return scores, anchor, aok


def allview_scores(
    images: torch.Tensor,
    cameras: Cameras,
    position: torch.Tensor,
    normal: torch.Tensor,
    ref: torch.Tensor,
    vis: torch.Tensor,
    texture_size: int,
):
    """(scores (B, V), anchor (B,), anchor_ok (B,)): the CUDA kernel for
    CUDA tensors, the plain torch version for CPU tensors."""
    global PLAIN_CALLS
    if images.device.type == "cpu":
        PLAIN_CALLS += 1
        return allview_scores_plain(
            images, cameras, position, normal, ref, vis, texture_size
        )
    return allview_scores_cuda(
        images, cameras.K.contiguous(), cameras.E.contiguous(),
        cameras.C.contiguous(), cameras.x_axis.contiguous(),
        cameras.width, cameras.height,
        position.contiguous(), normal.contiguous(),
        ref.to(torch.int64).contiguous(), vis.contiguous(), texture_size,
    )
