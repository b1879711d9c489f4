"""Corner detection + grid filtering.

A corner response evaluated as a stencil over the whole image batch: Harris
(separable 1-D correlations by slicing, so no convolution library and no
cuDNN) or the FAST-9/16 segment test (16 shifted slices). Then 3x3
non-maximum suppression, the top `max_per_cell` responses per cell of a
`cell_size` grid and the global top `max_keypoints`.

Ties break toward the LOWER index (a stable descending sort), as
`jax.lax.top_k` does: `torch.topk` promises no order among equal values.
"""
from __future__ import annotations

import torch

__all__ = [
    "harris_response",
    "fast_response",
    "detect_keypoints",
    "gaussian_blur",
]

_SOBEL = (-1.0, 0.0, 1.0)
_SMOOTH = (0.25, 0.5, 0.25)


def _conv1d(img: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """1-D correlation along `axis` (-1 or -2) with edge replication."""
    r = (len(kernel) - 1) // 2
    n = img.shape[axis]
    idx = torch.arange(-r, n + r, device=img.device).clamp(0, n - 1)
    x = img.index_select(img.ndim + axis, idx)
    out = torch.zeros_like(img)
    for i in range(len(kernel)):
        out = out + kernel[i] * x.narrow(axis, i, n)
    return out


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None):
    """Separable Gaussian blur over the trailing two axes."""
    if sigma <= 0:
        return img
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    return _conv1d(_conv1d(img, k, -1), k, -2)


def harris_response(
    images: torch.Tensor, k: float = 0.04, window_sigma: float = 1.5
) -> torch.Tensor:
    """Harris corner response R = det(M) - k tr(M)^2 per pixel.

    images: (..., H, W) float; returns the same shape."""
    img = images.to(torch.float32)
    gx = _conv1d(_conv1d(img, _SOBEL, -1), _SMOOTH, -2)
    gy = _conv1d(_conv1d(img, _SOBEL, -2), _SMOOTH, -1)
    ixx = gaussian_blur(gx * gx, window_sigma)
    iyy = gaussian_blur(gy * gy, window_sigma)
    ixy = gaussian_blur(gx * gy, window_sigma)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


# Bresenham circle of radius 3: the 16 (dy, dx) ring offsets of FAST-16,
# clockwise from 12 o'clock.
_FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_response(
    images: torch.Tensor, threshold: float = 10.0, arc: int = 9
) -> torch.Tensor:
    """FAST segment-test corner response as a pure stencil.

    A pixel is a corner when `arc` contiguous pixels of the 16-pixel ring
    (edge-replicated at the border) are all brighter, or all darker, than
    the centre by more than `threshold`; its response is the summed margin
    over the brighter (darker) ring pixels, used only for ranking.
    Non-corners score -inf. images: (..., H, W) -> the same shape."""
    img = images.to(torch.float32)
    H, W = img.shape[-2:]
    rows = torch.arange(-3, H + 3, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-3, W + 3, device=img.device).clamp(0, W - 1)
    padded = img.index_select(-2, rows).index_select(-1, cols)
    diffs = torch.stack([
        padded[..., 3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] - img
        for dy, dx in _FAST_RING
    ])  # (16, ..., H, W)
    bright = diffs > threshold
    dark = diffs < -threshold
    corner_b = torch.zeros_like(img, dtype=torch.bool)
    corner_d = torch.zeros_like(img, dtype=torch.bool)
    for s in range(16):  # OR over the starts of an AND over `arc` in a row
        run_b, run_d = bright[s], dark[s]
        for j in range(1, arc):
            run_b = run_b & bright[(s + j) % 16]
            run_d = run_d & dark[(s + j) % 16]
        corner_b = corner_b | run_b
        corner_d = corner_d | run_d
    score_b = torch.clamp_min(diffs - threshold, 0.0).sum(dim=0)
    score_d = torch.clamp_min(-diffs - threshold, 0.0).sum(dim=0)
    score = torch.where(corner_b, score_b, 0.0) + torch.where(
        corner_d, score_d, 0.0
    )
    return torch.where(corner_b | corner_d, score, float("-inf"))


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression mask. Exact ties break by raster order:
    strict > against earlier neighbours, >= against later ones."""
    H, W = resp.shape[-2:]
    r = torch.nn.functional.pad(resp, (1, 1, 1, 1), value=float("-inf"))
    ok = torch.ones_like(resp, dtype=torch.bool)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            nb = r[..., dy : dy + H, dx : dx + W]
            ok = ok & ((resp > nb) if (dy, dx) < (1, 1) else (resp >= nb))
    return ok


def _top_k(values: torch.Tensor, k: int):
    """Largest k along the last axis, ties toward the lower index."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_keypoints(
    images: torch.Tensor,
    cell_size: int = 16,
    max_per_cell: int = 4,
    max_keypoints: int = 4096,
    k: float = 0.04,
    border: int = 8,
    method: str = "harris",
    fast_threshold: float = 10.0,
):
    """Grid-filtered corners of a batch of images (V, H, W); `method` is
    "harris" or "fast".

    Returns (xy (V, N, 2) f32, response (V, N) f32, valid (V, N) bool),
    N = max_keypoints."""
    V, H, W = images.shape
    dev = images.device
    if method == "harris":
        resp = harris_response(images, k=k)
    elif method == "fast":
        resp = fast_response(images, threshold=fast_threshold)
    else:
        raise ValueError(f"unknown detector {method!r}")
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    in_border = (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )
    resp = torch.where(_nms3(resp) & in_border, resp, float("-inf"))

    Hp = -(-H // cell_size) * cell_size
    Wp = -(-W // cell_size) * cell_size
    resp_p = torch.nn.functional.pad(
        resp, (0, Wp - W, 0, Hp - H), value=float("-inf")
    )
    hc, wc = Hp // cell_size, Wp // cell_size
    cells = resp_p.reshape(V, hc, cell_size, wc, cell_size)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(V, hc * wc, -1)
    top_vals, top_idx = _top_k(cells, max_per_cell)  # (V, C, m)

    cell_ids = torch.arange(hc * wc, device=dev)
    py = (cell_ids // wc)[None, :, None] * cell_size + top_idx // cell_size
    px = (cell_ids % wc)[None, :, None] * cell_size + top_idx % cell_size
    flat_vals = top_vals.reshape(V, -1)
    n_keep = min(max_keypoints, flat_vals.shape[1])
    sel_vals, sel = _top_k(flat_vals, n_keep)
    xy = torch.stack(
        [px.reshape(V, -1).gather(1, sel), py.reshape(V, -1).gather(1, sel)],
        dim=-1,
    ).to(torch.float32)
    valid = torch.isfinite(sel_vals) & (sel_vals > 0)
    pad = max_keypoints - n_keep
    if pad:
        xy = torch.nn.functional.pad(xy, (0, 0, 0, pad))
        sel_vals = torch.nn.functional.pad(sel_vals, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return xy, sel_vals, valid
