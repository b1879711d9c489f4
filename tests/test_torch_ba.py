"""Bundle adjustment of the port against the JAX package, on the problem of
the JAX package's own BA tests (6 views of 640 x 480 around a plane, 120
points, every point seen by every view), built once in numpy for both.

Tolerances: rodrigues 1e-6; residuals and both Jacobian blocks 1e-4 (f32,
two derivations: XLA's `jacfwd` and `torch.func.jacfwd`); refined centres
and the final RMSE 1e-3 (15 LM iterations of f32 CG on either side, whose
segment sums add in different orders).
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from densepoints_tpu.ba import ba as jax_ba
from densepoints_tpu_torch.ba import ba
from densepoints_tpu_torch.config import (
    BAConfig,
    ExpandConfig,
    MatchingConfig,
    OptimizeConfig,
    PipelineConfig,
)
from densepoints_tpu_torch.interop import ba_problem_from_numpy
from densepoints_tpu_torch.io import load_scene
from densepoints_tpu_torch.ops import allview_ncc
from densepoints_tpu_torch.pmvs.pipeline import densify
from tests.ba.test_ba import _make_problem
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import cuda_device  # noqa: F401  (fixture)

_FIELDS = ("K", "R0", "C0", "points0", "obs_point", "obs_view", "obs_xy",
           "obs_mask")
# The JAX solver's static arguments, one compiled program for every case.
_ITERS = {"max_outer_iterations": 15, "cg_iterations": 50}


def _both(jax_problem):
    """The port's BAProblem holding the JAX problem's arrays."""
    return ba_problem_from_numpy(
        *(np.asarray(getattr(jax_problem, f)) for f in _FIELDS))


def _rmse(fn, problem, solution):
    return float(fn(problem, *solution[:3]))


def test_rodrigues_matches_jax(rng):
    w = rng.normal(0, 1, (64, 3)).astype(np.float32)
    w[:8] *= 1e-5  # the Taylor branch
    w[8] = 0.0
    w[9] = [0.0, 0.0, np.pi / 2]
    got = ba.rodrigues(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ba.rodrigues(jnp.asarray(w))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[8], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(got[9] @ [1.0, 0, 0], [0, 1, 0], atol=1e-6)


@pytest.mark.parametrize("at", ["zero", "moved"])
def test_residuals_and_jacobians_match_jax(rng, at):
    problem, *_ = _make_problem(rng, cam_rot_pert=0.01, cam_trans_pert=0.05,
                                point_pert=0.05)
    V, N = problem.K.shape[0], problem.points0.shape[0]
    cam = np.zeros((V, 6), np.float32)
    if at == "moved":  # away from the linearization point w = 0
        cam = rng.normal(0, 0.01, (V, 6)).astype(np.float32)
    points = np.array(problem.points0)
    want = jax_ba._residuals_and_jacobians(problem, jnp.asarray(cam),
                                           jnp.asarray(points))
    got = ba._residuals_and_jacobians(_both(problem), torch.as_tensor(cam),
                                      torch.as_tensor(points))
    shapes = [(V * N, 2), (V * N, 2, 6), (V * N, 2, 3)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("noise,limit", [(0.0, 0.1), (0.5, 1.0),
                                         ("outliers", 1.0)],
                         ids=["noise_free", "noisy", "outliers"])
def test_run_ba_recovers_cameras_and_matches_jax(rng, noise, limit):
    """With "outliers", 2% of the observations are off by 30-100 px and
    stay in the problem, as mismatched seed tracks do: the Huber weights
    are active, the RMSE stays above a pixel, and the packages agree."""
    pert = (dict(noise_px=0.5, cam_rot_pert=0.005, cam_trans_pert=0.02,
                 point_pert=0.02) if noise else
            dict(cam_rot_pert=0.01, cam_trans_pert=0.05, point_pert=0.05))
    problem, *_ = _make_problem(rng, **pert)
    clean = _both(problem)
    if noise == "outliers":
        xy = np.array(problem.obs_xy)
        bad = rng.permutation(len(xy))[: len(xy) // 50]
        xy[bad] += rng.uniform(30, 100, (len(bad), 2)) * rng.choice(
            [-1, 1], (len(bad), 2))
        problem = dataclasses.replace(problem, obs_xy=jnp.asarray(xy))
    port = _both(problem)
    rmse0 = _rmse(ba.reprojection_rmse, port,
                  (port.R0, port.C0, port.points0))
    got = ba.run_ba(port, **_ITERS)
    want = jax_ba.run_ba(problem, **_ITERS)
    rmse = _rmse(ba.reprojection_rmse, port, got)
    rmse_jax = _rmse(jax_ba.reprojection_rmse, problem, want)
    inliers = _rmse(ba.reprojection_rmse, clean, got)
    print(f"rmse {rmse0:.4f} -> port {rmse:.6f}, jax {rmse_jax:.6f}; "
          f"against the clean observations {inliers:.6f}")
    if noise == 0.0:
        assert rmse0 > 1.0
    if noise == "outliers":
        assert rmse > 1.0
    assert inliers < limit
    assert abs(rmse - rmse_jax) < 1e-3
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-3, rtol=0)
    assert abs(float(got[3]) - float(want[3])) < 1e-3


def test_masked_observations_ignored(rng):
    problem, *_ = _make_problem(rng, cam_rot_pert=0.005, cam_trans_pert=0.02)
    port = _both(problem)
    M = port.obs_xy.shape[0]
    bad = rng.permutation(M)[: M // 5]
    xy = port.obs_xy.clone()
    xy[bad] += 300.0
    mask = torch.ones(M, dtype=torch.bool)
    mask[bad] = False
    corrupt = ba.BAProblem(**{**port.__dict__, "obs_xy": xy,
                              "obs_mask": mask})
    got = ba.run_ba(corrupt, **_ITERS)
    assert _rmse(ba.reprojection_rmse, port, got) < 0.2  # vs clean obs


def test_ba_inside_densify_fixes_perturbed_cameras(tmp_path, rng):
    """The perturbed plane of the JAX package's BA integration test: P rows
    of views 1-4 turned by +-0.002 rad about z; the port's densify with
    `ba.enable` brings the seeds' RMSE under a pixel and still
    reconstructs, on the CPU's plain path."""
    scene = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    views = []
    for v in range(5):
        img = scene.render(v).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / f"v{v}.png")
        P = scene.P[v].copy()
        if v > 0:
            ang = 0.002 * (1 if v % 2 else -1)
            Rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                           [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
            P = P @ np.block([[Rz, np.zeros((3, 1))],
                              [np.zeros((1, 3)), np.ones((1, 1))]])
        views.append({"filename": f"v{v}.png", "projectionMatrix": P.tolist()})
    path = tmp_path / "scene.json"
    path.write_text(json.dumps({"imagesPath": str(tmp_path), "views": views}))
    config = PipelineConfig(
        matching=MatchingConfig(max_keypoints_per_view=256),
        optimize=OptimizeConfig(max_iterations=30),
        expand=ExpandConfig(max_rounds=1),
        ba=BAConfig(enable=True, max_outer_iterations=12),
    )
    plain = allview_ncc.PLAIN_CALLS
    result = densify(load_scene(path, device="cpu"), config, device="cpu")
    assert allview_ncc.PLAIN_CALLS > plain
    assert result.metrics.counters["ba_rmse_px"] < 1.0
    assert "bundle_adjust" in result.metrics.times
    assert result.patches.capacity > 10
    assert np.median(np.abs(result.positions[:, 2])) < 0.05


@pytest.mark.cuda
def test_run_ba_on_card_matches_cpu(rng, cuda_device):
    """On CUDA tensors the solve stays on the card, gives the same solution
    twice (bitwise: the segment sums add in a fixed order) and agrees with
    the CPU solve within 1e-3 (another summation order)."""
    problem, *_ = _make_problem(rng, noise_px=0.5, cam_rot_pert=0.005,
                                cam_trans_pert=0.02, point_pert=0.02)
    cpu = _both(problem)
    card = ba.BAProblem(**{k: v.to(cuda_device)
                           for k, v in cpu.__dict__.items()})
    got = ba.run_ba(card, **_ITERS)
    again = ba.run_ba(card, **_ITERS)
    want = ba.run_ba(cpu, **_ITERS)
    assert all(t.device.type == "cuda" for t in got)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-3,
                                   rtol=0)
