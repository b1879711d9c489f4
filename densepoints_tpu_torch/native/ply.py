"""Native binary PLY writer binding (fallback: `io.ply.write_ply`)."""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from densepoints_tpu_torch.native import _load, available

__all__ = ["available", "write_ply_native"]


def write_ply_native(path, positions, normals=None, colors=None) -> bool:
    """Write a binary PLY with the C++ writer; False if the library is
    unavailable or the file cannot be opened."""
    lib = _load()
    if lib is None:
        return False
    positions = np.ascontiguousarray(positions, np.float32)
    if normals is not None:
        normals = np.ascontiguousarray(normals, np.float32)
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8)
    n = len(positions)
    for name, a in (("positions", positions), ("normals", normals),
                    ("colors", colors)):
        if a is not None and a.shape != (n, 3):
            raise ValueError(f"{name} has shape {a.shape}, expected {(n, 3)}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rc = lib.dp_write_ply(
        str(path).encode(),
        n,
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None if normals is None
        else normals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None if colors is None
        else colors.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return rc == 0
