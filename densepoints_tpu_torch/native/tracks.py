"""Native union-find track assembly binding."""
from __future__ import annotations

import ctypes

import numpy as np

from densepoints_tpu_torch.native import _load, available

__all__ = ["available", "union_matches", "roots"]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def union_matches(
    num_views: int, n_kp: int, pairs: np.ndarray, matches: np.ndarray
) -> np.ndarray:
    """Parent array (V*N,) after unioning all matches (smaller root wins).

    pairs: (P, 2) view pairs; matches: (P, n_kp) keypoint of the pair's
    second view matched to each keypoint of its first view, or -1."""
    lib = _lib()
    pairs = np.ascontiguousarray(pairs, np.int32).reshape(-1, 2)
    matches = np.ascontiguousarray(matches, np.int32)
    if pairs.shape != (len(pairs), 2) or matches.shape != (len(pairs), n_kp):
        raise ValueError(
            f"pairs {pairs.shape} and matches {matches.shape} do not match "
            f"{len(pairs)} pairs of {n_kp} keypoints"
        )
    if len(pairs) and not (
        (pairs >= 0).all() and (pairs < num_views).all()
        and (matches < n_kp).all()
    ):
        raise ValueError("a view or keypoint index is out of range")
    parent = np.empty(num_views * n_kp, np.int64)
    lib.dp_union_matches(
        num_views, n_kp, len(pairs), _ptr(pairs, ctypes.c_int32),
        _ptr(matches, ctypes.c_int32), _ptr(parent, ctypes.c_int64),
    )
    return parent


def roots(parent: np.ndarray) -> np.ndarray:
    """The root of every node of a union-find parent array."""
    lib = _lib()
    parent = np.array(parent, np.int64)  # compressed in place: a copy
    out = np.empty_like(parent)
    lib.dp_compress_roots(
        len(parent), _ptr(parent, ctypes.c_int64), _ptr(out, ctypes.c_int64)
    )
    return out
