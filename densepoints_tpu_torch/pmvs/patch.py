"""Patch state: the unit of reconstruction, as a dataclass of tensors.

All patches live in one struct-of-arrays with boolean visibility bitmasks
(P, V) and an `alive` mask; every pipeline stage maps PatchState ->
PatchState. `compact` drops dead patches and changes the leading shape.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["PatchState"]


@dataclasses.dataclass(frozen=True)
class PatchState:
    """position: (P, 3) f32 world positions.
    normal:   (P, 3) f32 unit normals, pointing AWAY from the reference camera.
    ref:      (P,) int64 reference view ids.
    vis:      (P, V) bool truly-visible mask (excludes the reference view).
    cand:     (P, V) bool potentially-visible mask.
    alive:    (P,) bool.
    color:    (P, 3) f32 RGB in [0, 255].
    """

    position: torch.Tensor
    normal: torch.Tensor
    ref: torch.Tensor
    vis: torch.Tensor
    cand: torch.Tensor
    alive: torch.Tensor
    color: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def num_views(self) -> int:
        return self.vis.shape[1]

    def num_alive(self) -> int:
        return int(self.alive.sum())

    def num_visible(self) -> torch.Tensor:
        """(P,) count of truly-visible views per patch."""
        return self.vis.sum(dim=1)

    def map(self, fn) -> "PatchState":
        """Apply fn to every field tensor."""
        return PatchState(
            **{f.name: fn(getattr(self, f.name))
               for f in dataclasses.fields(self)}
        )

    @classmethod
    def empty(cls, capacity: int, num_views: int, dtype=torch.float32,
              device="cuda"):
        """`capacity` dead patches of `num_views` views on `device`."""
        real = {"dtype": dtype, "device": device}
        mask = {"dtype": torch.bool, "device": device}
        return cls(
            position=torch.zeros((capacity, 3), **real),
            normal=torch.zeros((capacity, 3), **real),
            ref=torch.zeros((capacity,), dtype=torch.int64, device=device),
            vis=torch.zeros((capacity, num_views), **mask),
            cand=torch.zeros((capacity, num_views), **mask),
            alive=torch.zeros((capacity,), **mask),
            color=torch.zeros((capacity, 3), **real),
        )

    @classmethod
    def create(cls, position, normal, ref, vis, cand=None, alive=None,
               color=None):
        position = torch.as_tensor(position, dtype=torch.float32)
        dev = position.device
        P, V = position.shape[0], vis.shape[1]
        return cls(
            position=position,
            normal=torch.as_tensor(normal, dtype=torch.float32, device=dev),
            ref=torch.as_tensor(ref, dtype=torch.int64, device=dev),
            vis=torch.as_tensor(vis, dtype=torch.bool, device=dev),
            cand=(
                torch.as_tensor(cand, dtype=torch.bool, device=dev)
                if cand is not None
                else torch.zeros((P, V), dtype=torch.bool, device=dev)
            ),
            alive=(
                torch.as_tensor(alive, dtype=torch.bool, device=dev)
                if alive is not None
                else torch.ones((P,), dtype=torch.bool, device=dev)
            ),
            color=(
                torch.as_tensor(color, dtype=torch.float32, device=dev)
                if color is not None
                else torch.zeros((P, 3), dtype=torch.float32, device=dev)
            ),
        )

    def compact(self) -> "PatchState":
        """Drop dead patches (changes the leading shape)."""
        keep = self.alive
        return self.map(lambda a: a[keep])

    def masked(self, keep: torch.Tensor) -> "PatchState":
        """Kill patches where keep is False (shape-preserving)."""
        return dataclasses.replace(self, alive=self.alive & keep)

    @staticmethod
    def concatenate(parts) -> "PatchState":
        return PatchState(
            **{f.name: torch.cat([getattr(p, f.name) for p in parts], dim=0)
               for f in dataclasses.fields(PatchState)}
        )
