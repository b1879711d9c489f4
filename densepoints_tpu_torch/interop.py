"""Build the port's state from numpy arrays, and back.

Takes and returns numpy only, so state produced by any other
implementation (e.g. the JAX package, via `np.asarray` of its fields) can
be carried across without this package importing it.
"""
from __future__ import annotations

import numpy as np
import torch

from densepoints_tpu_torch.ba import BAProblem
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.pmvs.patch import PatchState

__all__ = [
    "ba_problem_from_numpy",
    "cameras_from_numpy",
    "patch_state_from_numpy",
    "patch_state_to_numpy",
]


def cameras_from_numpy(P, K, E, C, x_axis, width, height, device="cpu"):
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    return Cameras(
        P=f32(P), K=f32(K), E=f32(E), C=f32(C), x_axis=f32(x_axis),
        width=i32(width), height=i32(height),
    )


def patch_state_from_numpy(position, normal, ref, vis, cand, alive, color,
                           device="cpu") -> PatchState:
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return PatchState(
        position=t(position, torch.float32),
        normal=t(normal, torch.float32),
        ref=t(ref, torch.int64),
        vis=t(vis, torch.bool),
        cand=t(cand, torch.bool),
        alive=t(alive, torch.bool),
        color=t(color, torch.float32),
    )


def patch_state_to_numpy(state: PatchState) -> dict:
    """Field name -> numpy array (ref as int32, as the JAX package keeps it)."""
    out = {
        name: getattr(state, name).cpu().numpy()
        for name in ("position", "normal", "ref", "vis", "cand", "alive",
                     "color")
    }
    out["ref"] = out["ref"].astype(np.int32)
    return out


def ba_problem_from_numpy(K, R0, C0, points0, obs_point, obs_view, obs_xy,
                          obs_mask, device="cpu"):
    """A `ba.BAProblem` holding these arrays (f32; indices as int64)."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return BAProblem(
        K=t(K, torch.float32), R0=t(R0, torch.float32),
        C0=t(C0, torch.float32), points0=t(points0, torch.float32),
        obs_point=t(obs_point, torch.int64),
        obs_view=t(obs_view, torch.int64),
        obs_xy=t(obs_xy, torch.float32), obs_mask=t(obs_mask, torch.bool),
    )
