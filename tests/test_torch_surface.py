"""Surface extraction of the port against the JAX package.

`fuse_tsdf` on the same oriented points: TSDF within 1e-5 where the
weight is above 1e-6 (f32 scatter-adds summed in another order), weights
within 1e-5, the same observed set. `marching_tetrahedra` is a host copy:
array-equal on the same grid. `write_mesh_ply` is byte-equal. Then the JAX
package's four surface cases on the port. On the card (`cuda`), the grids
agree with the CPU's, and two fusions, and two meshes, of one cloud are
bitwise equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import SurfaceConfig as JaxSurfaceConfig
from densepoints_tpu.io.ply import write_mesh_ply as jax_write_mesh_ply
from densepoints_tpu.surface import tsdf as jax_tsdf
from densepoints_tpu_torch.config import SurfaceConfig
from densepoints_tpu_torch.io.ply import read_ply, write_mesh_ply
from densepoints_tpu_torch.surface import tsdf
from tests.torch_port_util import cuda_device  # noqa: F401  (fixture)


def _plane(rng, n=4000):
    xy = rng.uniform(-1, 1, (n, 2))
    pos = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    return pos, np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)


def _sphere(rng, n=8000):
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return dirs.astype(np.float32), dirs.astype(np.float32)


def _grid_inputs(pos, R):
    lo = pos.min(axis=0) - 0.1
    voxel = float(np.max(pos.max(axis=0) + 0.1 - lo)) / (R - 1)
    return lo.astype(np.float32), np.float32(voxel), np.float32(3 * voxel)


@pytest.fixture(scope="module")
def sphere_grids():
    """Both packages' TSDF and weight grids of one sphere cloud, R = 48."""
    pos, nrm = _sphere(np.random.default_rng(0))
    lo, voxel, trunc = _grid_inputs(pos, 48)
    want = jax_tsdf.fuse_tsdf(jnp.asarray(pos), jnp.asarray(nrm),
                              jnp.asarray(lo), jnp.asarray(voxel), 48,
                              jnp.asarray(trunc))
    got = tsdf.fuse_tsdf(*(torch.as_tensor(a) for a in (pos, nrm, lo)),
                         torch.tensor(voxel), 48, torch.tensor(trunc))
    return ([g.numpy() for g in got], [np.asarray(w) for w in want],
            lo, voxel)


def test_fuse_tsdf_matches_jax(sphere_grids):
    (t_got, w_got), (t_want, w_want), _, _ = sphere_grids
    assert t_got.shape == t_want.shape == (48, 48, 48)
    np.testing.assert_allclose(w_got, w_want, atol=1e-5, rtol=1e-5)
    seen = w_want > 1e-6
    np.testing.assert_array_equal(w_got > 1e-6, seen)
    assert 0.05 < seen.mean() < 0.9
    np.testing.assert_allclose(t_got[seen], t_want[seen], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_got[~seen], t_want[~seen])


def test_fuse_tsdf_in_passes(monkeypatch):
    """Clouds above one pass of points (here 1000) add pass by pass."""
    pos, nrm = _sphere(np.random.default_rng(1), n=2500)
    lo, voxel, trunc = _grid_inputs(pos, 32)
    args = (*(torch.as_tensor(a) for a in (pos, nrm, lo)),
            torch.tensor(voxel), 32, torch.tensor(trunc))
    whole = tsdf.fuse_tsdf(*args)
    monkeypatch.setattr(tsdf, "_POINTS_PER_PASS", 1000)
    parts = tsdf.fuse_tsdf(*args)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_marching_tetrahedra_array_equal(sphere_grids, masked):
    _, (t_want, w_want), lo, voxel = sphere_grids
    valid = w_want > 1e-6 if masked else None
    got = tsdf.marching_tetrahedra(t_want, lo, voxel, valid=valid)
    want = jax_tsdf.marching_tetrahedra(t_want, lo, voxel, valid=valid)
    assert len(got[0]) > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_write_mesh_ply_byte_equal(tmp_path, rng, binary):
    verts = rng.standard_normal((50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (80, 3)).astype(np.int32)
    write_mesh_ply(tmp_path / "port.ply", verts, faces, binary=binary)
    jax_write_mesh_ply(tmp_path / "jax.ply", verts, faces, binary=binary)
    got = (tmp_path / "port.ply").read_bytes()
    assert got == (tmp_path / "jax.ply").read_bytes()
    assert b"element face 80" in got
    np.testing.assert_allclose(read_ply(tmp_path / "port.ply")["positions"],
                               verts, atol=1e-6 if not binary else 0)


def test_plane_surface(rng):
    pos, nrm = _plane(rng)
    verts, faces = tsdf.extract_surface(
        pos, nrm, SurfaceConfig(voxel_resolution=64), device="cpu")
    assert len(verts) > 100 and len(faces) > 100
    interior = (np.abs(verts[:, 0]) < 0.8) & (np.abs(verts[:, 1]) < 0.8)
    assert interior.sum() > 50
    assert np.percentile(np.abs(verts[interior, 2]), 90) < 0.1


def test_sphere_surface(rng):
    pos, nrm = _sphere(rng)
    verts, faces = tsdf.extract_surface(
        pos, nrm, SurfaceConfig(voxel_resolution=64), device="cpu")
    want, _ = jax_tsdf.extract_surface(
        pos, nrm, JaxSurfaceConfig(voxel_resolution=64))
    assert len(verts) > 200
    assert abs(len(verts) - len(want)) <= 0.01 * len(want)
    radii = np.linalg.norm(verts, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.08, np.median(radii)


def test_empty_cloud():
    verts, faces = tsdf.extract_surface(
        np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
        device="cpu")
    assert verts.shape == (0, 3) and faces.shape == (0, 3)


def test_faces_index_valid_vertices(rng):
    pos, nrm = _plane(rng, n=2000)
    verts, faces = tsdf.extract_surface(
        pos, nrm, SurfaceConfig(voxel_resolution=48), device="cpu")
    assert faces.min() >= 0 and faces.max() < len(verts)


@pytest.mark.cuda
def test_fuse_tsdf_on_card_matches_cpu(cuda_device):
    """The scatter-adds on the card (f32 atomics in no fixed order) agree
    with the CPU's within 1e-5; the mesh of `extract_surface` on the card
    has the CPU mesh's size within 1%."""
    pos, nrm = _sphere(np.random.default_rng(2))
    lo, voxel, trunc = _grid_inputs(pos, 64)
    args = [torch.as_tensor(a) for a in (pos, nrm, lo)]
    scalars = [torch.tensor(voxel), torch.tensor(trunc)]
    want = tsdf.fuse_tsdf(*args, scalars[0], 64, scalars[1])
    got = tsdf.fuse_tsdf(*(a.to(cuda_device) for a in args),
                         scalars[0].to(cuda_device), 64,
                         scalars[1].to(cuda_device))
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-5)
    config = SurfaceConfig(voxel_resolution=64)
    v_card, _ = tsdf.extract_surface(pos, nrm, config, device=cuda_device)
    v_cpu, _ = tsdf.extract_surface(pos, nrm, config, device="cpu")
    assert abs(len(v_card) - len(v_cpu)) <= 0.01 * len(v_cpu)


@pytest.mark.cuda
def test_fusion_on_card_is_bitwise_repeatable(cuda_device):
    """The same cloud gives the same grids and the same mesh on the card:
    two `fuse_tsdf` runs are bitwise equal (`torch.equal`), and so are two
    `extract_surface` runs (`np.array_equal`). The cloud spans two passes
    of `_POINTS_PER_PASS` points; its adds collide on every crust voxel."""
    pos, nrm = _sphere(np.random.default_rng(3), n=40000)
    lo, voxel, trunc = _grid_inputs(pos, 64)
    args = [torch.as_tensor(a, device=cuda_device) for a in (pos, nrm, lo)]
    scalars = [torch.tensor(s, device=cuda_device) for s in (voxel, trunc)]
    runs = [tsdf.fuse_tsdf(*args, scalars[0], 64, scalars[1])
            for _ in range(2)]
    for first, second in zip(*runs):
        assert first.device.type == "cuda"
        assert torch.equal(first, second)
    config = SurfaceConfig(voxel_resolution=64)
    meshes = [tsdf.extract_surface(pos, nrm, config, device=cuda_device)
              for _ in range(2)]
    assert len(meshes[0][0]) > 200
    for first, second in zip(*meshes):
        assert np.array_equal(first, second)
