"""Surface extraction: TSDF fusion of oriented points + marching tetrahedra.

  * TSDF: the oriented point cloud is splatted into a voxel grid on the
    device: every point updates the voxels in a (2r+1)^3 window around it
    with the signed distance along its normal (a local plane
    approximation), weighted by tangential distance; the window's offsets
    are scatter-adds (`index_add_`) into two (R^3 + 1)-long f32 buffers.
    On CUDA those adds are f32 atomics in no fixed order.
  * meshing: marching tetrahedra over the fused grid on the host (numpy, a
    copy of the JAX package's mesher): each cube splits into 6 tetrahedra
    with a 16-case table; vertices are linearly interpolated zero
    crossings, deduplicated by integer edge keys.
"""
from __future__ import annotations

import numpy as np
import torch

from densepoints_tpu_torch.config import SurfaceConfig

__all__ = ["fuse_tsdf", "marching_tetrahedra", "extract_surface"]

# Points per pass of `fuse_tsdf`: its (offsets, points) temporaries stay
# near 4 M entries whatever the cloud's size.
_POINTS_PER_PASS = 32768


def fuse_tsdf(
    positions: torch.Tensor,
    normals: torch.Tensor,
    origin: torch.Tensor,
    voxel_size: torch.Tensor,
    resolution: int,
    truncation: torch.Tensor,
    window: int = 2,
):
    """Fuse oriented points into (R, R, R) TSDF and weight grids, on the
    device of `positions`. Unobserved voxels (weight <= 1e-6) get
    +truncation, so surfaces close around the observed crust."""
    R = resolution
    dev = positions.device
    r = torch.arange(-window, window + 1, device=dev)
    dz, dy, dx = torch.meshgrid(r, r, r, indexing="ij")
    offsets = torch.stack([dx, dy, dz], -1).reshape(-1, 1, 3)  # (O, 1, 3)
    sigma2 = torch.clamp_min(voxel_size * window, 1e-9) ** 2
    tsdf = torch.zeros((R * R * R + 1,), dtype=torch.float32, device=dev)
    weight = torch.zeros_like(tsdf)
    for lo in range(0, positions.shape[0], _POINTS_PER_PASS):
        pos = positions[lo : lo + _POINTS_PER_PASS]
        nrm = normals[lo : lo + _POINTS_PER_PASS]
        vox = (pos - origin) / voxel_size  # fractional voxel coords
        idx = torch.floor(vox).to(torch.int64) + offsets  # (O, P, 3)
        ok = ((idx >= 0) & (idx < R)).all(-1)
        center = (idx.to(torch.float32) - vox) * voxel_size
        # Signed distance to the point's tangent plane.
        sdf = (center * nrm).sum(-1)
        # Weight by tangential proximity (within the splat radius).
        tang2 = (center * center).sum(-1) - sdf * sdf
        w = torch.exp(-0.5 * tang2 / sigma2)
        ok = ok & (torch.abs(sdf) <= truncation)
        flat = torch.where(
            ok, (idx[..., 2] * R + idx[..., 1]) * R + idx[..., 0], R * R * R
        ).reshape(-1)
        clipped = torch.clamp(sdf, -truncation, truncation)
        tsdf.index_add_(0, flat, torch.where(ok, w * clipped, 0.0).reshape(-1))
        weight.index_add_(0, flat, torch.where(ok, w, 0.0).reshape(-1))
    tsdf = tsdf[:-1] / torch.clamp_min(weight[:-1], 1e-9)
    tsdf = torch.where(weight[:-1] > 1e-6, tsdf, truncation)
    return tsdf.reshape(R, R, R), weight[:-1].reshape(R, R, R)


# The 6 tetrahedra of a cube (indices into the 8 cube corners).
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)
# Corner offsets (x, y, z) of a unit cube, standard binary order:
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.float64,
)


def _build_tet_case_table():
    """(16, 2, 3, 2) int8: per 4-bit inside-mask, up to 2 triangles of 3
    edges, each edge a (local vertex, local vertex) pair; -1 = absent.

    Generated from the same case logic the original sequential mesher
    used (one isolated corner -> one triangle, reversed when the isolated
    corner is outside; 2-2 split -> quad -> two triangles), so geometry
    and winding are bit-identical in intent.
    """
    table = np.full((16, 2, 3, 2), -1, np.int8)
    for mask in range(16):
        inside = [bool(mask >> i & 1) for i in range(4)]
        n_in = sum(inside)
        if n_in in (0, 4):
            continue
        if n_in in (1, 3):
            iso = inside.index(True) if n_in == 1 else inside.index(False)
            others = [i for i in range(4) if i != iso]
            tri = [(iso, o) for o in others]
            if n_in == 3:
                tri = tri[::-1]
            table[mask, 0] = tri
        else:
            ins = [i for i in range(4) if inside[i]]
            outs = [i for i in range(4) if not inside[i]]
            q = [
                (ins[0], outs[0]),
                (ins[0], outs[1]),
                (ins[1], outs[1]),
                (ins[1], outs[0]),
            ]
            table[mask, 0] = [q[0], q[1], q[2]]
            table[mask, 1] = [q[0], q[2], q[3]]
    return table


_TET_CASES = _build_tet_case_table()
_CORNERS_I = _CORNERS.astype(np.int64)  # (8, 3) x, y, z


def marching_tetrahedra(tsdf: np.ndarray, origin, voxel_size, valid=None):
    """Triangulate the zero level set — fully vectorized numpy.

    All straddling cubes' 6 tetrahedra are processed at once through a
    16-case table; edge vertices are deduplicated globally by canonical
    integer edge keys via np.unique (the round-3 per-cube Python loop
    cost 60 s at 192^3; this is array math end to end).
    Returns (vertices (N, 3) f32, faces (M, 3) int32).

    `valid` (R,R,R) bool marks OBSERVED voxels: cubes touching unobserved
    voxels are skipped. Without it, the +truncation fill of unobserved
    space behind the crust flips sign against the crust's negative band
    and triangulates a phantom inner shell ~truncation behind the real
    surface (measured 1.3 mm median error on a perfect sphere cloud vs
    0.2 mm with the mask)."""
    tsdf = np.asarray(tsdf)
    R = tsdf.shape[0]
    origin = np.asarray(origin, np.float64)
    vs = float(voxel_size)
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    sign = tsdf < 0
    straddles = _cube_straddles(sign)
    if valid is not None:
        straddles &= _cube_all_valid(np.asarray(valid))
    cz, cy, cx = np.nonzero(straddles)
    if len(cz) == 0:
        return empty
    cube = np.stack([cx, cy, cz], axis=1).astype(np.int64)  # (Nc, 3)

    # Corner integer coords and values: (Nc, 8, 3) / (Nc, 8).
    corner_xyz = cube[:, None, :] + _CORNERS_I[None, :, :]
    vals8 = tsdf[corner_xyz[..., 2], corner_xyz[..., 1], corner_xyz[..., 0]]

    # Tetrahedra: (Nc, 6, 4) values, (Nc, 6, 4, 3) coords, 4-bit cases.
    vals_t = vals8[:, _TETS]
    xyz_t = corner_xyz[:, _TETS]
    inside = vals_t < 0
    case = (
        inside[..., 0] * 1
        + inside[..., 1] * 2
        + inside[..., 2] * 4
        + inside[..., 3] * 8
    )  # (Nc, 6)

    tris = _TET_CASES[case]  # (Nc, 6, 2, 3, 2) local edge pairs
    has_tri = tris[..., 0, 0] >= 0  # (Nc, 6, 2)
    ci, ti, wi = np.nonzero(has_tri)
    if len(ci) == 0:
        return empty
    edges = tris[ci, ti, wi].astype(np.int64)  # (T, 3, 2) local ids

    # Gather endpoint coords/values per triangle edge: (T, 3, 2, 3)/(T, 3, 2)
    tet_xyz = xyz_t[ci, ti]  # (T, 4, 3)
    tet_val = vals_t[ci, ti]  # (T, 4)
    ar = np.arange(len(ci))[:, None, None]
    e_xyz = tet_xyz[ar, edges]  # (T, 3, 2, 3)
    e_val = tet_val[ar, edges]  # (T, 3, 2)

    # Canonical integer edge keys (grid-point id pairs, sorted).
    pid = (e_xyz[..., 2] * R + e_xyz[..., 1]) * R + e_xyz[..., 0]  # (T,3,2)
    swap = pid[..., 0] > pid[..., 1]
    key = np.where(swap, pid[..., 1], pid[..., 0]) * (R * R * R) + np.where(
        swap, pid[..., 0], pid[..., 1]
    )
    uniq, inv = np.unique(key.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)

    # Zero-crossing positions for the unique edges (decode the key; the
    # interpolation formula is symmetric in endpoint order).
    id0 = uniq // (R * R * R)
    id1 = uniq % (R * R * R)

    def decode(i):
        x = i % R
        y = (i // R) % R
        z = i // (R * R)
        return np.stack([x, y, z], axis=1).astype(np.float64)

    p0 = decode(id0)
    p1 = decode(id1)
    v0 = tsdf[p0[:, 2].astype(int), p0[:, 1].astype(int), p0[:, 0].astype(int)]
    v1 = tsdf[p1[:, 2].astype(int), p1[:, 1].astype(int), p1[:, 0].astype(int)]
    t = (v0 / (v0 - v1))[:, None]
    verts = (origin + vs * (p0 + t * (p1 - p0))).astype(np.float32)
    return verts, faces


def _cube_all_valid(valid: np.ndarray) -> np.ndarray:
    """(R-1)^3 bool: all 8 cube corners are observed voxels."""
    out = np.ones(np.array(valid.shape) - 1, bool)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out &= valid[
                    dz : valid.shape[0] - 1 + dz,
                    dy : valid.shape[1] - 1 + dy,
                    dx : valid.shape[2] - 1 + dx,
                ]
    return out


def _cube_straddles(sign: np.ndarray) -> np.ndarray:
    """(R-1)^3 bool: cube has both inside and outside corners."""
    s = sign
    all_in = np.ones(np.array(s.shape) - 1, bool)
    any_in = np.zeros(np.array(s.shape) - 1, bool)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = s[
                    dz : s.shape[0] - 1 + dz,
                    dy : s.shape[1] - 1 + dy,
                    dx : s.shape[2] - 1 + dx,
                ]
                all_in &= c
                any_in |= c
    return any_in & ~all_in


def extract_surface(
    positions: np.ndarray,
    normals: np.ndarray,
    config: SurfaceConfig = SurfaceConfig(),
    device="cuda",
):
    """Point cloud -> (vertices, faces): TSDF fusion on `device`, marching
    tetrahedra on the host."""
    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    if len(positions) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    lo = positions.min(axis=0)
    hi = positions.max(axis=0)
    pad = 0.05 * float(np.max(hi - lo) or 1.0)
    lo, hi = lo - pad, hi + pad
    R = config.voxel_resolution
    voxel = float(np.max(hi - lo)) / (R - 1)
    trunc = config.truncation_voxels * voxel

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    tsdf, weight = fuse_tsdf(
        f32(positions), f32(normals), f32(lo), f32(voxel), R, f32(trunc)
    )
    return marching_tetrahedra(
        tsdf.cpu().numpy(),
        lo,
        voxel,
        valid=weight.cpu().numpy() > max(config.min_weight, 1e-6),
    )
