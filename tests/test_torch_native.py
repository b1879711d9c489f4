"""The port's binding to the native C++ runtime: tracks identical with and
without the library and identical to the JAX package's `build_tracks`; its
PLY readable by both packages' readers; the build lands in the port's
`_build/` and writes nothing under `native/`."""
import hashlib
from pathlib import Path

import numpy as np
import pytest

import densepoints_tpu_torch
import densepoints_tpu_torch.native as nat
from densepoints_tpu.features.tracks import build_tracks as jax_build_tracks
from densepoints_tpu.io.ply import read_ply as jax_read_ply
from densepoints_tpu_torch.features import tracks as T
from densepoints_tpu_torch.io.ply import read_ply, write_ply
from densepoints_tpu_torch.native import tracks as nt
from densepoints_tpu_torch.native.ply import write_ply_native

_NATIVE_DIR = nat._SOURCE.parent


@pytest.fixture()
def library():
    """The port's native library, or skip: it needs a C++ compiler."""
    if not nat.available():
        pytest.skip("no C++ compiler to build the native runtime")


@pytest.fixture()
def without_library(monkeypatch):
    """The port as it runs when the library cannot be built."""
    def refuse():
        raise RuntimeError("no compiler in this test")

    monkeypatch.setattr(nat, "_build", refuse)
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", False)


def _match_tables(rng, num_views=4, N=64):
    pairs = np.array([[0, 1], [0, 2], [1, 2], [2, 3]], np.int32)
    matches = np.full((4, N), -1, np.int64)
    m = rng.integers(0, N, 40)
    for k in range(40):
        matches[rng.integers(0, 4), rng.integers(0, N)] = m[k]
    kp = rng.uniform(0, 100, (num_views, N, 2)).astype(np.float32)
    return num_views, kp, pairs, matches


def test_union_matches_and_roots(library):
    num_views, N = 3, 5
    pairs = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    matches = np.full((3, N), -1, np.int32)
    matches[0, 0] = 2  # (0,0) ~ (1,2)
    matches[1, 2] = 4  # (1,2) ~ (2,4)
    matches[2, 3] = 3  # (0,3) ~ (2,3)
    parent = nt.union_matches(num_views, N, pairs, matches)
    roots = nt.roots(parent)
    assert roots[0] == roots[1 * N + 2] == roots[2 * N + 4] == 0
    assert roots[3] == roots[2 * N + 3] == 3
    uf = T._UnionFind(num_views * N)
    for p, (a, b) in enumerate(pairs):
        for i in np.nonzero(matches[p] >= 0)[0]:
            uf.union(a * N + i, b * N + matches[p, i])
    np.testing.assert_array_equal(
        roots, [uf.find(i) for i in range(num_views * N)])
    with pytest.raises(ValueError, match="out of range"):
        nt.union_matches(2, N, pairs, matches)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracks_identical_with_and_without_library(library, seed,
                                                   monkeypatch):
    args = _match_tables(np.random.default_rng(seed))
    with_lib = T.build_tracks(*args)
    want = jax_build_tracks(*args)
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", True)
    assert not nat.available()
    without = T.build_tracks(*args)
    for got_n, got_p, ref in zip(with_lib, without, want):
        assert got_n.dtype == ref.dtype
        np.testing.assert_array_equal(got_n, got_p)
        np.testing.assert_array_equal(got_n, ref)
    assert len(with_lib[0]) > 0


def test_failed_build_warns_once_and_falls_back(rng, without_library,
                                                caplog):
    args = _match_tables(rng)
    with caplog.at_level("WARNING", logger="densepoints_tpu_torch"):
        first = T.build_tracks(*args)
        second = T.build_tracks(*args)
    warnings = [r for r in caplog.records if "native runtime" in r.message]
    assert len(warnings) == 1
    assert write_ply_native("unused.ply", np.zeros((1, 3))) is False
    for a, b, c in zip(first, second, jax_build_tracks(*args)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("fields", ["pnc", "p"])
def test_native_ply_read_by_both_packages(library, tmp_path, rng, fields):
    pos = rng.standard_normal((1000, 3)).astype(np.float32)
    nrm = rng.standard_normal((1000, 3)).astype(np.float32)
    col = rng.integers(0, 256, (1000, 3)).astype(np.uint8)
    path = tmp_path / "native.ply"
    if fields == "pnc":
        assert write_ply_native(path, pos, nrm, col)
    else:
        assert write_ply_native(path, pos)
    for read in (read_ply, jax_read_ply):
        out = read(path)
        np.testing.assert_array_equal(out["positions"], pos)
        if fields == "pnc":
            np.testing.assert_array_equal(out["normals"], nrm)
            np.testing.assert_array_equal(out["colors"], col)
        else:
            assert "normals" not in out and "colors" not in out
    with pytest.raises(ValueError, match="normals"):
        write_ply_native(path, pos, nrm[:5])


def test_big_cloud_written_natively(library, tmp_path, rng):
    """Binary clouds of 10,000 points or more take the C++ writer (its
    header's comment says so); the records are the Python writer's."""
    pos = rng.standard_normal((20000, 3)).astype(np.float32)
    nrm = rng.standard_normal((20000, 3)).astype(np.float32)
    col = rng.integers(0, 256, (20000, 3)).astype(np.uint8)
    path = tmp_path / "big.ply"
    write_ply(path, pos, nrm, col)
    assert b"native" in path.read_bytes()[:200]
    small = tmp_path / "small.ply"
    write_ply(small, pos[:9999], nrm[:9999], col[:9999])
    assert b"native" not in small.read_bytes()[:200]
    body = path.read_bytes().split(b"end_header\n", 1)[1]
    small_body = small.read_bytes().split(b"end_header\n", 1)[1]
    assert body[: len(small_body)] == small_body
    np.testing.assert_array_equal(jax_read_ply(path)["colors"], col)


def _tree_digest(directory):
    digest = hashlib.sha256()
    for p in sorted(directory.rglob("*")):
        digest.update(str(p.relative_to(directory)).encode())
        if p.is_file():
            digest.update(p.read_bytes())
    return digest.hexdigest()


def test_build_lands_in_the_port_build_dir(library, tmp_path, monkeypatch):
    package = Path(densepoints_tpu_torch.__file__).parent
    assert nat.library_path().parent == package / "_build"
    before = _tree_digest(_NATIVE_DIR)
    monkeypatch.setattr(nat, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", False)
    assert nat.available()
    built = sorted((tmp_path / "_build").iterdir())
    assert built == [nat.library_path()]
    assert built[0].name.startswith("libdensepoints_native_")
    assert _tree_digest(_NATIVE_DIR) == before
