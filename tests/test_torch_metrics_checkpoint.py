"""Cloud metrics, checkpoints and the small PatchState / OccupancyGrids API
of the port against the JAX package.

Metrics: the same numpy clouds through both `accuracy_completeness`, every
`CloudMetrics` field equal to rtol 1e-12 (both are numpy + cKDTree in
float64). Checkpoints: one file format; a file written by either package
loads in the other with every patch field and camera field bitwise equal.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from densepoints_tpu.core.cameras import Cameras as JaxCameras
from densepoints_tpu.pmvs.organizer import make_grids as jax_make_grids
from densepoints_tpu.pmvs.patch import PatchState as JaxPatchState
from densepoints_tpu.utils import checkpoint as jax_ckpt
from densepoints_tpu.utils.metrics import (
    accuracy_completeness as jax_accuracy_completeness,
)
from densepoints_tpu_torch.interop import patch_state_to_numpy
from densepoints_tpu_torch.pmvs.organizer import make_grids
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from densepoints_tpu_torch.utils.metrics import accuracy_completeness
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import cuda_device  # noqa: F401  (fixture)
from tests.torch_port_util import torch_cameras, torch_state

_FIELDS = ("position", "normal", "ref", "vis", "cand", "alive", "color")
_CAMERA_FIELDS = ("P", "K", "E", "C", "x_axis", "width", "height")


def _identical(rng):
    cloud = rng.standard_normal((500, 3))
    return cloud, cloud, 0.02


def _shifted(rng):
    gt = rng.standard_normal((1000, 3))
    return gt + np.array([0.05, 0.0, 0.0]), gt, 0.1


def _incomplete(rng):
    gt = rng.uniform(-1, 1, (2000, 3))
    return gt[gt[:, 0] < 0], gt, 0.05


def _empty(rng):
    return np.zeros((0, 3)), rng.standard_normal((10, 3)), 0.02


@pytest.mark.parametrize("case", [_identical, _shifted, _incomplete, _empty],
                         ids=["identical", "shifted", "incomplete", "empty"])
def test_metrics_match_jax(rng, case):
    cloud, gt, threshold = case(rng)
    got = accuracy_completeness(cloud, gt, threshold=threshold)
    want = jax_accuracy_completeness(cloud, gt, threshold=threshold)
    np.testing.assert_allclose(
        list(dataclasses.asdict(got).values()),
        list(dataclasses.asdict(want).values()), rtol=1e-12, atol=0,
    )
    assert got.summary() == want.summary()
    if case is _identical:
        assert got.accuracy_mean == 0.0 and got.completeness_median == 0.0
        assert got.accuracy_frac_under == 1.0
    elif case is _shifted:
        assert 0.0 < got.accuracy_median <= 0.051
        assert got.accuracy_frac_under > 0.9
    elif case is _incomplete:
        assert got.accuracy_median < 1e-9
        assert got.completeness_median > 1e-3


def test_metrics_clip_at_max_dist(rng):
    cloud, gt, _ = _shifted(rng)
    cloud[:10] += 100.0  # floaters
    got = accuracy_completeness(cloud, gt, max_dist=0.5)
    want = jax_accuracy_completeness(cloud, gt, max_dist=0.5)
    assert got.accuracy_mean == pytest.approx(want.accuracy_mean, rel=1e-12)
    assert got.accuracy_mean < 0.06


def _jax_state(rng, P=37, V=5):
    return JaxPatchState.create(
        rng.standard_normal((P, 3)).astype(np.float32),
        rng.standard_normal((P, 3)).astype(np.float32),
        rng.integers(0, V, P).astype(np.int32),
        rng.uniform(size=(P, V)) > 0.5,
        cand=rng.uniform(size=(P, V)) > 0.5,
        alive=rng.uniform(size=P) > 0.2,
        color=rng.uniform(0, 255, (P, 3)).astype(np.float32),
    )


def _jax_cameras(rng):
    scene = TexturedPlaneScene(rng, num_views=3, width=64, height=48)
    return JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )


def test_checkpoint_roundtrip(tmp_path, rng):
    state = torch_state(_jax_state(rng))
    path = tmp_path / "ckpt" / "stage_expand.npz"
    save_checkpoint(path, state, "expand", {"round": 3})
    loaded, meta, cams = load_checkpoint(path, device="cpu")
    assert meta == {"stage": "expand", "capacity": 37, "round": 3}
    assert cams is None  # no cameras were saved
    for f in _FIELDS:
        got, want = getattr(loaded, f), getattr(state, f)
        assert got.dtype == want.dtype and got.device.type == "cpu"
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert latest_checkpoint(tmp_path / "ckpt") == path
    assert latest_checkpoint(tmp_path / "nonexistent") is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_in_the_other_package(tmp_path, rng, writer):
    """A file written by one package loads in the other: every patch field
    and every camera field bitwise, `ref` as int32 on disk."""
    jstate, jcams = _jax_state(rng), _jax_cameras(rng)
    path = tmp_path / f"{writer}.npz"
    if writer == "port":
        save_checkpoint(path, torch_state(jstate), "final",
                        cameras=torch_cameras(jcams))
        loaded, meta, cams = jax_ckpt.load_checkpoint(path)
        got_state = {f: np.asarray(getattr(loaded, f)) for f in _FIELDS}
    else:
        jax_ckpt.save_checkpoint(path, jstate, "final", cameras=jcams)
        loaded, meta, cams = load_checkpoint(path, device="cpu")
        got_state = patch_state_to_numpy(loaded)
    assert meta == {"stage": "final", "capacity": 37}
    with np.load(path) as raw:
        assert raw["ref"].dtype == np.int32
    for f in _FIELDS:
        want = np.asarray(getattr(jstate, f))
        assert got_state[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got_state[f], want)
    for f in _CAMERA_FIELDS:
        got = getattr(cams, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(getattr(jcams, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want)


def test_checkpoint_of_p_only_rederives_cameras(tmp_path, rng):
    """An older file with only P, width and height re-derives the cameras,
    as the JAX package does."""
    jcams = _jax_cameras(rng)
    path = tmp_path / "old.npz"
    arrays = {f: np.asarray(getattr(_jax_state(rng), f)) for f in _FIELDS}
    np.savez_compressed(
        path, __meta__='{"stage": "final", "capacity": 37}',
        __cam_P__=np.asarray(jcams.P), __cam_w__=np.asarray(jcams.width),
        __cam_h__=np.asarray(jcams.height), **arrays,
    )
    _, _, cams = load_checkpoint(path, device="cpu")
    _, _, want = jax_ckpt.load_checkpoint(path)
    np.testing.assert_allclose(cams.C.numpy(), np.asarray(want.C), atol=1e-5)
    np.testing.assert_allclose(cams.K.numpy(), np.asarray(want.K),
                               rtol=1e-5, atol=1e-4)


def test_latest_checkpoint_orders_by_mtime(tmp_path, rng):
    state = torch_state(_jax_state(rng))
    names = ["seeds_optimized", "final", "expanded"]
    for i, name in enumerate(names):
        path = tmp_path / f"{name}.npz"
        save_checkpoint(path, state, name)
        os.utime(path, (1_000_000 + i, 1_000_000 + i))
    assert latest_checkpoint(tmp_path).name == "expanded.npz"
    assert jax_ckpt.latest_checkpoint(tmp_path).name == "expanded.npz"
    os.utime(tmp_path / "final.npz", (2_000_000, 2_000_000))
    assert latest_checkpoint(tmp_path).name == "final.npz"
    assert latest_checkpoint(tmp_path / "empty") is None


def test_patch_state_and_grids_api_match_jax(rng):
    jstate = _jax_state(rng)
    state = torch_state(jstate)
    assert state.num_views == jstate.num_views == 5
    assert state.num_alive() == jstate.num_alive()
    empty = PatchState.empty(6, 4, device="cpu")
    jempty = JaxPatchState.empty(6, 4)
    for f in _FIELDS:
        got, want = getattr(empty, f), np.asarray(getattr(jempty, f))
        assert got.shape == want.shape and got.device.type == "cpu"
        assert not got.any()
    assert empty.ref.dtype == torch.int64 and empty.num_alive() == 0
    assert PatchState.empty(2, 3, dtype=torch.float64,
                            device="cpu").position.dtype == torch.float64
    jcams = _jax_cameras(rng)
    grids = make_grids(torch_cameras(jcams), 4)
    assert grids.num_views == jax_make_grids(jcams, 4).num_views == 3


@pytest.mark.cuda
def test_checkpoint_loads_onto_the_card(tmp_path, rng, cuda_device):
    jstate, jcams = _jax_state(rng), _jax_cameras(rng)
    path = tmp_path / "jax.npz"
    jax_ckpt.save_checkpoint(path, jstate, "final", cameras=jcams)
    state, _, cams = load_checkpoint(path, device=cuda_device)
    assert state.position.device.type == cams.P.device.type == "cuda"
    for f in _FIELDS:
        np.testing.assert_array_equal(patch_state_to_numpy(state)[f],
                                      np.asarray(getattr(jstate, f)))
    assert PatchState.empty(3, 2, device=cuda_device).alive.is_cuda
