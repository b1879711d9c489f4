"""Stage-boundary checkpoint / resume.

Every pipeline stage boundary can snapshot its PatchState + metadata (and
the cameras that produced it) to one .npz. The file format is the JAX
package's: the seven patch fields (`ref` as int32), `__meta__` as JSON, and
every derived camera field under `__cam_P__ ... __cam_h__`, so a file
written by either package loads in the other.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.interop import (
    cameras_from_numpy,
    patch_state_from_numpy,
    patch_state_to_numpy,
)
from densepoints_tpu_torch.pmvs.patch import PatchState

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

_FIELDS = ("position", "normal", "ref", "vis", "cand", "alive", "color")
# Camera field -> npz key.
_CAMERA_KEYS = {
    "P": "__cam_P__", "K": "__cam_K__", "E": "__cam_E__", "C": "__cam_C__",
    "x_axis": "__cam_x__", "width": "__cam_w__", "height": "__cam_h__",
}


def save_checkpoint(
    path,
    state: PatchState,
    stage: str,
    extra: dict | None = None,
    cameras: Cameras | None = None,
):
    """Snapshot patch state (+ optionally the cameras that produced it).

    Cameras matter when bundle adjustment refined the extrinsics: a resumed
    run must reconstruct with the same geometry the patches were optimized
    against, not the scene file's original cameras.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = patch_state_to_numpy(state)
    if cameras is not None:
        # Every derived field, not just P: rebuilding K/R/C from P by RQ
        # decomposition on load is a ulp-level round trip that breaks
        # bitwise resume (the batched Nelder-Mead amplifies camera-frame
        # ulps into diverging patch poses).
        for field, key in _CAMERA_KEYS.items():
            arrays[key] = getattr(cameras, field).cpu().numpy()
    meta = {"stage": stage, "capacity": state.capacity}
    if extra:
        meta.update(extra)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_checkpoint(path, device="cuda"):
    """Returns (PatchState, meta dict, Cameras-or-None), tensors on
    `device`."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        state = patch_state_from_numpy(
            *(data[f] for f in _FIELDS), device=device
        )
        cameras = None
        if "__cam_K__" in data:  # bit-faithful restore of derived fields
            cameras = cameras_from_numpy(
                *(data[key] for key in _CAMERA_KEYS.values()), device=device
            )
        elif "__cam_P__" in data:  # older checkpoints: re-derive from P
            cameras = Cameras.from_projection_matrices(
                data["__cam_P__"],
                widths=data["__cam_w__"],
                heights=data["__cam_h__"],
                device=device,
            )
    return state, meta, cameras


def latest_checkpoint(directory):
    """Most recent .npz checkpoint in a directory, or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    candidates = sorted(
        directory.glob("*.npz"), key=lambda p: p.stat().st_mtime
    )
    return candidates[-1] if candidates else None
