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
`KERNEL_LAUNCHES` and `PLAIN_CALLS` count which path ran; under a CUDA
graph `KERNEL_LAUNCHES` counts the launches the device makes (those the
capture recorded, at each replay), not the capture itself.
`allview_scorer` binds the stack and the cameras once for a caller that
scores many batches against them (Nelder-Mead, twice a step).

The work of K1 is counted at this contract, so the plain path and the
kernel count alike, and through `_build.count_launch`, so a call replayed
in a CUDA graph counts at each replay: `ROWS` (B a call) and `BYTES` (what
a call must move at least, from its shapes: position and normal 12 B a
row each, ref 8, vis V, scores 4V, anchor 8, anchor_ok 1; no image pixel)
on the host, and the visible (row, view) pairs, anchors included, on the
device. A call runs no op for them: each `vis` keeps a count of the calls
that scored it, and `fold` (after a stage's solve or filter, and in
`counts`) sums a `vis` the first time it folds it (a caller that changes
one in place hands a new tensor instead) and adds that sum times its
calls to a total per texture size; `counts` and `count_since` read the
totals for `StageMetrics`. A caller that scores padded rows (Nelder-Mead's
cached graphs, `ops/simplex.py`) calls the scorer's `launch`, which counts
no work, and counts its real rows' with `count_work`.
"""
from __future__ import annotations

import weakref

import torch

from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.core.scores import NCC_MIN_DENOM
from densepoints_tpu_torch.ops import _build
from densepoints_tpu_torch.ops.warp import patch_textures

__all__ = [
    "allview_scores",
    "allview_scorer",
    "allview_scores_plain",
    "allview_scores_cuda",
    "build_kernel",
    "KERNEL_LAUNCHES",
    "PLAIN_CALLS",
    "ROWS",
    "BYTES",
    "fold",
    "count_work",
    "counts",
    "count_since",
]

KERNEL_LAUNCHES = 0  # kernel launches, counted where the kernel launches
PLAIN_CALLS = 0  # calls answered by the plain torch version (CPU tensors)
ROWS = 0  # rows scored through `allview_scorer` / `allview_scores`
BYTES = 0  # bytes those calls must move at least
_ROW_BYTES = 12 + 12 + 8 + 8 + 1  # position, normal, ref, anchor, anchor_ok
_VIEW_BYTES = 1 + 4  # vis, scores
# Visible (row, view) pairs scored, by (device, texture size): an int64
# scalar on the device.
_TEXTURES: dict = {}
_PAIRS: dict = {}  # (id(vis), texture size) -> `_Pairs` of a live `vis`
_PENDING: list = []  # `_Pairs` with calls not yet folded into `_TEXTURES`

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
    k = int(texture_size)
    V, H, W, B = _build.check_warp_scene(
        images, K, position, normal, ref, k
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
    _build.count_launch(__name__)
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


class _Pairs:
    """The visible (row, view) pairs of one `vis` and the calls that scored
    them since the last `fold` (`add` is a `_build.count_launch` counter).
    `vis` is held while calls wait to be folded, and summed at the first
    fold."""

    def __init__(self, vis: torch.Tensor, texture_size: int):
        key = (id(vis), texture_size)
        # `_PAIRS`'s entry goes with `vis`, before its id can be reused
        self._ref = weakref.ref(vis, lambda _: _PAIRS.pop(key, None))
        self.key = (vis.device, texture_size)
        self.count = None
        self.calls = 0
        self._held = None

    def add(self, n: int):
        if not self.calls:
            _PENDING.append(self)
            self._held = self._ref()
        self.calls += n

    def fold(self):
        if self.count is None:
            self.count = self._held.sum()
        elif self.count.is_cuda:  # read on this stream, maybe not its own
            self.count.record_stream(torch.cuda.current_stream())
        total = _TEXTURES.get(self.key)
        if total is None:
            _TEXTURES[self.key] = self.count * self.calls
        else:
            total.add_(self.count, alpha=self.calls)
        self.calls, self._held = 0, None


def _pairs_of(vis: torch.Tensor, texture_size: int) -> _Pairs:
    pairs = _PAIRS.get((id(vis), texture_size))
    if pairs is None:
        pairs = _PAIRS[id(vis), texture_size] = _Pairs(vis, texture_size)
    return pairs


def fold():
    """Add the visible pairs of the calls counted since the last fold to
    the totals: a sum the first time a `vis` is folded, then one small add,
    on the current stream."""
    for pairs in _PENDING:
        pairs.fold()
    _PENDING.clear()


def count_work(vis: torch.Tensor, texture_size: int, calls: int = 1,
               count=_build.count):
    """Count `calls` scoring calls over the rows of `vis` (B, V) at
    `texture_size` through `count` (`_build.count`, or
    `_build.count_launch` for calls a CUDA graph may replay): `ROWS`,
    `BYTES` and the visible pairs of `vis`."""
    B, V = vis.shape
    if B and calls:
        count(f"{__name__}:ROWS", calls * B)
        count(f"{__name__}:BYTES", calls * B * (_ROW_BYTES + _VIEW_BYTES * V))
        count(_pairs_of(vis, texture_size), calls)


def counts() -> dict:
    """K1's work so far, as `count_since` takes it: rows and bytes, and a
    copy of each total of visible pairs (copied on the device, not read)."""
    fold()
    return {"k1_rows": ROWS, "k1_bytes": BYTES,
            "pairs": {key: t.clone() for key, t in _TEXTURES.items()}}


def count_since(metrics, before: dict):
    """Set K1's work since `before` (a `counts()`) as `metrics`' counters
    `k1_rows`, `k1_textures` (visible (row, view) pairs), `k1_texels`
    (textures times k^2) and `k1_bytes`. Reads the device's totals once
    (one read a device; the caller has synced)."""
    fold()
    textures = texels = 0
    for device in {key[0] for key in _TEXTURES}:
        keys = [key for key in _TEXTURES if key[0] == device]
        since = torch.stack([_TEXTURES[key] - before["pairs"].get(key, 0)
                             for key in keys]).tolist()
        for (_, k), n in zip(keys, since):
            textures += n
            texels += n * k * k
    metrics.count("k1_rows", ROWS - before["k1_rows"])
    metrics.count("k1_textures", textures)
    metrics.count("k1_texels", texels)
    metrics.count("k1_bytes", BYTES - before["k1_bytes"])


class _Scorer:
    """score(position, normal, ref, vis) -> (scores, anchor, anchor_ok)
    with the stack and the cameras bound, counting each call's work;
    `launch` is the call without counting its work."""

    def __init__(self, images: torch.Tensor, cameras: Cameras,
                 texture_size: int):
        self.images, self.cameras = images, cameras
        self.texture_size = int(texture_size)
        # the stack and the cameras' contiguous copies, made once: what a
        # launch reads
        self.scene = (images, cameras.K.contiguous(),
                      cameras.E.contiguous(), cameras.C.contiguous(),
                      cameras.x_axis.contiguous(), cameras.width,
                      cameras.height)

    def __call__(self, position, normal, ref, vis):
        plain = self.images.device.type == "cpu"
        count_work(vis, self.texture_size,
                   count=_build.count if plain else _build.count_launch)
        return self.launch(position, normal, ref, vis)

    def launch(self, position, normal, ref, vis):
        """The call without counting its work (`count_work`); a launch of
        the kernel still counts in `KERNEL_LAUNCHES`."""
        global PLAIN_CALLS
        if self.images.device.type == "cpu":
            PLAIN_CALLS += 1
            return allview_scores_plain(
                self.images, self.cameras, position, normal, ref, vis,
                self.texture_size,
            )
        return allview_scores_cuda(
            *self.scene, position.contiguous(), normal.contiguous(),
            ref.to(torch.int64).contiguous(), vis.contiguous(),
            self.texture_size,
        )


def allview_scorer(images: torch.Tensor, cameras: Cameras,
                   texture_size: int):
    """`allview_scores` with the stack and the cameras bound: returns
    score(position, normal, ref, vis) -> (scores, anchor, anchor_ok). The
    cameras' contiguous copies are made here, once."""
    return _Scorer(images, cameras, texture_size)


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
    return allview_scorer(images, cameras, texture_size)(
        position, normal, ref, vis
    )
