"""Batched pinhole cameras as a dataclass of tensors.

All views live in one `(V, 3, 4)` tensor. The decomposition into K, R and
the camera centre runs once per scene on the host in float64 (numpy) and
the results are stored as float32 tensors on the scene's device; projection
and bounds tests are the only camera ops on the hot path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Cameras",
    "decompose_projection_matrix",
    "is_inside",
    "project_points",
    "project_point_all_views",
]


@dataclasses.dataclass(frozen=True)
class Cameras:
    """All views of a scene, struct-of-arrays.

    P: (V, 3, 4) projection matrices.
    K: (V, 3, 3) intrinsics, K[2,2] == 1, positive diagonal.
    E: (V, 3, 4) extrinsics [R | -R C] with K @ E == P (up to scale).
    C: (V, 3) camera centres.
    x_axis: (V, 3) unit camera x axes in world coordinates (row 0 of R).
    width, height: (V,) int32 image sizes in pixels.
    """

    P: torch.Tensor
    K: torch.Tensor
    E: torch.Tensor
    C: torch.Tensor
    x_axis: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor

    @property
    def num_views(self) -> int:
        return self.P.shape[0]

    @property
    def R(self) -> torch.Tensor:
        return self.E[:, :, :3]

    @property
    def device(self) -> torch.device:
        return self.P.device

    def to(self, device) -> "Cameras":
        return Cameras(
            **{f.name: getattr(self, f.name).to(device)
               for f in dataclasses.fields(self)}
        )

    def project(self, points: torch.Tensor) -> torch.Tensor:
        """Project (..., 3) world points into all views -> (V, ..., 2).

        Uses the decomposed form K @ (R @ (p - C)), which is far better
        conditioned in f32 than the raw P @ [p; 1] product.
        """
        return self.project_with_depth(points)[0]

    def project_with_depth(self, points: torch.Tensor):
        """As `project`, also returning the camera-frame depth (V, ...)."""
        n = points.ndim - 1
        C = self.C.reshape(self.C.shape[:1] + (1,) * n + (3,))
        rel = points[None] - C  # (V, ..., 3)
        cam = torch.einsum("vij,v...j->v...i", self.R, rel)
        pix_h = torch.einsum("vij,v...j->v...i", self.K, cam)
        return pix_h[..., :2] / pix_h[..., 2:3], cam[..., 2]

    def points_inside(self, points: torch.Tensor) -> torch.Tensor:
        """(V, ...) strict-bounds visibility of world points in every view."""
        pix = self.project(points)
        extra = (1,) * (pix.ndim - 2)
        w = self.width.reshape((-1,) + extra).to(pix.dtype)
        h = self.height.reshape((-1,) + extra).to(pix.dtype)
        return is_inside(pix, w, h)

    @classmethod
    def from_projection_matrices(
        cls, P, widths, heights, device="cpu"
    ) -> "Cameras":
        """Build cameras from (V, 3, 4) projection matrices (host, float64)."""
        P = np.asarray(P, dtype=np.float64)
        if P.ndim == 2:
            P = P[None]
        V = P.shape[0]
        K = np.zeros((V, 3, 3))
        E = np.zeros((V, 3, 4))
        C = np.zeros((V, 3))
        for i in range(V):
            K[i], E[i], C[i] = decompose_projection_matrix(P[i])
        x_axis = E[:, 0, :3]
        x_axis = x_axis / np.linalg.norm(x_axis, axis=-1, keepdims=True)
        widths = np.broadcast_to(np.asarray(widths, np.int32), (V,))
        heights = np.broadcast_to(np.asarray(heights, np.int32), (V,))

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            P=f32(P), K=f32(K), E=f32(E), C=f32(C), x_axis=f32(x_axis),
            width=torch.as_tensor(widths.copy(), device=device),
            height=torch.as_tensor(heights.copy(), device=device),
        )


def _rq3(M: np.ndarray):
    """RQ decomposition of a 3x3 matrix: M = R @ Q, R upper-triangular
    (reverse the rows, QR of the transpose, undo the permutations)."""
    Prev = np.flipud(np.eye(3))
    q, r = np.linalg.qr((Prev @ M).T)
    R = Prev @ r.T @ Prev
    Q = Prev @ q.T
    return R, Q


def decompose_projection_matrix(P: np.ndarray):
    """Decompose a 3x4 projection matrix into (K, E, C), host float64.

    K: 3x3 intrinsics with positive diagonal and K[2,2] == 1.
    E: 3x4 extrinsics [R | -R C].
    C: camera centre (nullspace of P, dehomogenized).
    """
    P = np.asarray(P, dtype=np.float64)
    _, _, vt = np.linalg.svd(P)
    c_h = vt[-1]
    C = c_h[:3] / c_h[3]
    K, Q = _rq3(P[:, :3])
    # Force a positive diagonal on K; absorb the signs into the rotation.
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    S = np.diag(signs)
    K = K @ S
    Q = S @ Q
    K = K / K[2, 2]
    E = np.concatenate([Q, (-Q @ C)[:, None]], axis=1)
    return K, E, C


def project_points(P: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Project world points with the raw projection matrix: P (..., 3, 4),
    points (..., 3) -> pixel coordinates (..., 2)."""
    xyz = torch.einsum("...ij,...j->...i", P[..., :3], points) + P[..., 3]
    return xyz[..., :2] / xyz[..., 2:3]


def project_point_all_views(P_all: torch.Tensor, points: torch.Tensor):
    """Project (..., 3) points into all V views: (V, ..., 2)."""
    n = points.ndim - 1
    P = P_all.reshape(P_all.shape[:1] + (1,) * n + (3, 4))
    return project_points(P, points[None])


def is_inside(xy: torch.Tensor, width, height) -> torch.Tensor:
    """Strict in-image bounds test (exclusive on all four edges)."""
    x, y = xy[..., 0], xy[..., 1]
    return (x > 0) & (x < width) & (y > 0) & (y < height)
