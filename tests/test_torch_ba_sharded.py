"""`run_ba_sharded` of the port on 1 and 2 gloo processes against the JAX
package's on its 8-device mesh and against the port's `run_ba`.

The problem is the JAX BA tests' (6 views of 640 x 480 around a plane,
120 points; `tests/ba/test_ba.py::_make_problem`) with one observation
dropped, so 719 observations pad to a multiple of 2 (and of 8) with a
masked slot. The observations split over the ranks, so every segment sum
adds in another order: refined centres and the RMSE are held to 1e-3, the
port's BA tolerance against the JAX package (`test_torch_ba.py`).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from densepoints_tpu.ba import ba as jax_ba
from densepoints_tpu.parallel.mesh import make_mesh as jax_make_mesh
from densepoints_tpu_torch.ba import ba
from densepoints_tpu_torch.interop import ba_problem_from_numpy
from tests.ba.test_ba import _make_problem
from tests.torch_parallel_util import run_job

_FIELDS = ("K", "R0", "C0", "points0", "obs_point", "obs_view", "obs_xy",
           "obs_mask")
_ITERS = {"max_outer_iterations": 15, "cg_iterations": 50}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    problem, *_ = _make_problem(rng, noise_px=0.5, cam_rot_pert=0.005,
                                cam_trans_pert=0.02, point_pert=0.02)
    keep = np.arange(problem.obs_xy.shape[0]) != 17
    problem = dataclasses.replace(problem, **{
        f: jnp.asarray(np.asarray(getattr(problem, f))[keep])
        for f in ("obs_point", "obs_view", "obs_xy", "obs_mask")})
    inputs = {"ba_" + f: np.asarray(getattr(problem, f)) for f in _FIELDS}
    inputs.update(outer=np.int64(_ITERS["max_outer_iterations"]),
                  cg=np.int64(_ITERS["cg_iterations"]))
    tmp = tmp_path_factory.mktemp("ba")
    runs = {world: run_job("ba", world, inputs, tmp) for world in (1, 2)}
    return problem, runs


def test_sharded_ba_matches_jax(case):
    problem, runs = case
    assert problem.obs_xy.shape[0] % 2 == 1  # the padded slot is in use
    want = jax_ba.run_ba_sharded(problem, mesh=jax_make_mesh(), **_ITERS)
    rmse = float(jax_ba.reprojection_rmse(problem, *want[:3]))
    for world, ranks in runs.items():
        for out in ranks:
            print(f"{world} rank(s): rmse {float(out['rmse']):.6f}, "
                  f"jax {rmse:.6f}")
            assert abs(float(out["rmse"]) - rmse) < 1e-3
            np.testing.assert_allclose(out["C"], np.asarray(want[1]),
                                       atol=1e-3, rtol=0)
            np.testing.assert_allclose(out["R"], np.asarray(want[0]),
                                       atol=1e-3, rtol=0)


def test_sharded_ba_matches_run_ba(case):
    """Against the port's unsharded solver; the two ranks of a job agree
    bitwise (their sums are all-reduced, not recomputed)."""
    problem, runs = case
    port = ba_problem_from_numpy(
        *(np.asarray(getattr(problem, f)) for f in _FIELDS))
    R, C, pts, _ = ba.run_ba(port, **_ITERS)
    rmse = float(ba.reprojection_rmse(port, R, C, pts))
    a, b = runs[2]
    for key in ("R", "C", "points", "cost", "rmse"):
        np.testing.assert_array_equal(a[key], b[key])
    for out in (runs[1][0], a):
        assert abs(float(out["rmse"]) - rmse) < 1e-3
        np.testing.assert_allclose(out["C"], C.numpy(), atol=1e-3, rtol=0)
        np.testing.assert_allclose(out["points"], pts.numpy(), atol=1e-3,
                                   rtol=0)
    assert rmse < 1.0  # the noisy problem converged (0.5 px noise)
