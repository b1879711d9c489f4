"""The in-process API over several ranks (`parallel/local_job.py`): outside
a job `make_mesh(2, device="cpu")` is a mesh of 2 ranks not yet started,
and the four job-level entry points run their call on it as a job of 2
gloo processes started for that call, as the JAX package's single
controller runs them on a 2-device mesh.

  * each entry point's result equals the hand-started 2-rank worker job's
    (`tests/torch_parallel_worker.py`) bitwise, and matches the JAX
    package's on `make_mesh(2)` (the conftest's CPU devices) at the
    tolerance of the worker job's own test;
  * `parallel.num_devices` 2 without a mesh runs the same job;
  * `make_mesh(1)` starts no process: the result is the one of today's
    world-size-1 mesh, bitwise;
  * a rank that raises makes the call raise `RuntimeError` naming the
    rank with its traceback, a job past `mesh.TIMEOUT_S` raises, and no
    child survives either; the caller never joins a process group;
  * the building blocks refuse an unstarted mesh, naming the entry points,
    and inside a job `make_mesh(n)` for another world size still raises.

One thread a rank (`ONE_THREAD`), as in the worker jobs.
"""
import contextlib
import dataclasses
import re
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from densepoints_tpu.ba import ba as jax_ba
from densepoints_tpu.config import MatchingConfig as JaxMatchingConfig
from densepoints_tpu.config import PipelineConfig as JaxPipelineConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.io.scene import Scene as JaxScene
from densepoints_tpu.parallel.mesh import make_mesh as jax_make_mesh
from densepoints_tpu.parallel.multihost import (
    densify_multihost as jax_densify_multihost,
)
from densepoints_tpu.parallel.pipeline import (
    densify_distributed as jax_densify_distributed,
)
from densepoints_tpu_torch.ba import ba
from densepoints_tpu_torch.config import (
    MatchingConfig,
    ParallelConfig,
    PipelineConfig,
)
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.interop import ba_problem_from_numpy
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.ops.simplex import nelder_mead
from densepoints_tpu_torch.parallel import distributed, launch
from densepoints_tpu_torch.parallel import mesh as pmesh
from densepoints_tpu_torch.parallel.clustered import densify_clustered
from densepoints_tpu_torch.parallel.multihost import densify_multihost
from densepoints_tpu_torch.parallel.pipeline import densify_distributed
from densepoints_tpu_torch.pmvs.seed import generate_seed_points
from tests.ba.test_ba import _make_problem
from tests.synthetic import TexturedPlaneScene
from tests.test_torch_scaling_programs import _running
from tests.torch_parallel_util import ONE_THREAD, run_job

_ITERS = 40
_ENTRY_POINTS = ("densify_distributed, densify_multihost, run_ba_sharded, "
                 "generate_seed_points")
_BA_FIELDS = ("K", "R0", "C0", "points0", "obs_point", "obs_view", "obs_xy",
              "obs_mask")
_BA_ITERS = {"max_outer_iterations": 15, "cg_iterations": 50}
_SEED_CAMS = ("P", "K", "E", "C", "x_axis", "width", "height")


@contextlib.contextmanager
def _one_thread():
    """One thread a rank, here and in the children the call starts."""
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        for key, value in ONE_THREAD.items():
            mp.setenv(key, value)
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)


def _plane():
    """The worker's plane scene (`torch_parallel_worker.plane_scene`, the
    JAX multi-host test scene) in both packages: 5 views of 160 x 120
    and 40 seed points on the plane, in the same order of draws."""
    rng = np.random.default_rng(0)
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    images = sc.render_all()
    xy = rng.uniform(-0.6, 0.6, (40, 2))
    pts = np.concatenate([xy, np.zeros((40, 1))], 1).astype(np.float32)
    cams = Cameras.from_projection_matrices(sc.P, widths=sc.width,
                                            heights=sc.height)
    jcams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                                heights=sc.height)
    return (Scene(cameras=cams, images=images, colors=None),
            JaxScene(cameras=jcams, images=images, colors=None), pts)


def _config(cls, rounds, keypoints=None):
    cfg = cls()
    cfg = dataclasses.replace(
        cfg,
        optimize=dataclasses.replace(cfg.optimize, max_iterations=_ITERS),
        expand=dataclasses.replace(cfg.expand, max_rounds=rounds))
    if keypoints:
        matching = (MatchingConfig if cls is PipelineConfig
                    else JaxMatchingConfig)
        cfg = dataclasses.replace(
            cfg, matching=matching(max_keypoints_per_view=keypoints))
    return cfg


def _cloud(res):
    return {"position": res.patches.position.numpy(),
            "normal": res.patches.normal.numpy(),
            "vis": res.patches.vis.numpy()}


def _assert_bitwise(got, want):
    for key in ("position", "normal", "vis"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.fixture(scope="module")
def plane():
    return _plane()


@pytest.fixture(scope="module")
def distributed_runs(plane, tmp_path_factory):
    """`densify_distributed` as `test_densify_distributed_matches_jax` runs
    it (its own seeds, one round): on an unstarted 2-rank mesh, as the
    hand-started 2-rank worker job, and on today's world-size-1 mesh."""
    scene, _, _ = plane
    cfg = _config(PipelineConfig, 1, keypoints=384)
    inputs = {"max_iterations": np.int64(_ITERS), "max_rounds": np.int64(1),
              "max_keypoints": np.int64(384)}
    with _one_thread():
        mesh = pmesh.make_mesh(2, device="cpu")
        local = densify_distributed(scene, cfg, mesh=mesh)
        one = densify_distributed(scene, cfg, mesh=pmesh.global_mesh("cpu"))
    worker = run_job("densify_distributed", 2, inputs,
                     tmp_path_factory.mktemp("local_job"))
    return {"cfg": cfg, "local": local, "one": one, "worker": worker}


def test_densify_distributed_on_two_ranks(distributed_runs):
    """The 2-rank worker job's cloud bitwise; the 1-rank cloud as the
    worker test holds it; each rank's K1 count (the plain path here) and
    rank-table row as counters."""
    res = distributed_runs["local"]
    got = _cloud(res)
    assert res.patches.position.device == torch.device("cpu")
    for rank in distributed_runs["worker"]:
        _assert_bitwise(got, rank)
    one = _cloud(distributed_runs["one"])
    assert got["position"].shape == one["position"].shape
    np.testing.assert_array_equal(got["vis"], one["vis"])
    np.testing.assert_allclose(got["position"], one["position"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["normal"], one["normal"], atol=1e-5,
                               rtol=0)
    c = res.metrics.counters
    assert c["job_ranks"] == 2 and c["job_nccl"] == 0
    for rank in (0, 1):
        assert c[f"rank{rank}_allview_ncc_launches"] == 0
        assert c[f"rank{rank}_plain_calls"] > 0
        assert c[f"rank{rank}_card"] == -1 and c[f"rank{rank}_uuid8"] == -1
    assert c["patches_final"] == len(got["position"])
    assert res.metrics.times["expand"] > 0
    assert not dist.is_initialized()
    assert pmesh.global_mesh("cpu").world_size == 1


def test_num_devices_without_a_mesh(plane, distributed_runs):
    """`parallel.num_devices` 2 and no mesh: `make_mesh(2)`, the same job
    (it raised before the in-process API could start one)."""
    scene, _, _ = plane
    cfg = dataclasses.replace(distributed_runs["cfg"],
                              parallel=ParallelConfig(num_devices=2))
    with _one_thread():
        res = densify_distributed(scene, cfg, device="cpu")
    assert res.metrics.counters["job_ranks"] == 2
    _assert_bitwise(_cloud(res), _cloud(distributed_runs["local"]))


def test_densify_distributed_matches_jax(plane, distributed_runs):
    """Against the JAX package on a 2-device mesh: within 15% in count,
    the plane found (`test_densify_distributed_matches_jax`)."""
    _, jscene, _ = plane
    want = jax_densify_distributed(
        jscene, _config(JaxPipelineConfig, 1, keypoints=384),
        mesh=jax_make_mesh(2))
    n_jax, got = want.patches.capacity, _cloud(distributed_runs["local"])
    print(f"densify_distributed patches: jax {n_jax}, port "
          f"{len(got['position'])}")
    assert len(got["position"]) >= 50
    assert np.median(np.abs(got["position"][:, 2])) < 0.05
    assert abs(len(got["position"]) - n_jax) <= 0.15 * n_jax


def test_densify_multihost_matches_jax(plane):
    """On the JAX multi-host test's seeds and two rounds: within 15% of
    the JAX package's count on a 2-device mesh, the plane found in both
    (`test_torch_multihost.py::test_port_matches_jax`)."""
    scene, jscene, pts = plane
    with _one_thread():
        res = densify_multihost(scene, _config(PipelineConfig, 2),
                                mesh=pmesh.make_mesh(2, device="cpu"),
                                seed_points=pts)
    assert res.metrics.counters["job_ranks"] == 2
    want = jax_densify_multihost(jscene, _config(JaxPipelineConfig, 2),
                                 mesh=jax_make_mesh(2), seed_points=pts)
    n_jax, got = want.patches.capacity, res.patches.position.numpy()
    z_jax = np.median(np.abs(np.asarray(want.patches.position)[:, 2]))
    z_port = np.median(np.abs(got[:, 2]))
    print(f"multihost patches: jax {n_jax}, port {len(got)}; median |z|: "
          f"jax {z_jax:.5f}, port {z_port:.5f}")
    assert z_jax < 0.05 and z_port < 0.05
    assert abs(len(got) - n_jax) <= 0.15 * n_jax


def test_run_ba_sharded_matches_jax():
    """The sharded-BA test's problem (719 observations, one masked pad
    slot on 2 ranks): refined R, C and RMSE within 1e-3 of the JAX
    package's `run_ba_sharded` (`test_torch_ba_sharded.py`)."""
    rng = np.random.default_rng(0)
    problem, *_ = _make_problem(rng, noise_px=0.5, cam_rot_pert=0.005,
                                cam_trans_pert=0.02, point_pert=0.02)
    keep = np.arange(problem.obs_xy.shape[0]) != 17
    problem = dataclasses.replace(problem, **{
        f: jnp.asarray(np.asarray(getattr(problem, f))[keep])
        for f in ("obs_point", "obs_view", "obs_xy", "obs_mask")})
    port = ba_problem_from_numpy(
        *(np.asarray(getattr(problem, f)) for f in _BA_FIELDS))
    with _one_thread():
        R, C, pts, cost = ba.run_ba_sharded(
            port, pmesh.make_mesh(2, device="cpu"), **_BA_ITERS)
    assert R.device == torch.device("cpu") and cost.ndim == 0
    want = jax_ba.run_ba_sharded(problem, mesh=jax_make_mesh(2), **_BA_ITERS)
    rmse = float(jax_ba.reprojection_rmse(problem, *want[:3]))
    got = float(ba.reprojection_rmse(port, R, C, pts))
    print(f"2 local ranks: rmse {got:.6f}, jax {rmse:.6f}")
    assert abs(got - rmse) < 1e-3
    np.testing.assert_allclose(C.numpy(), np.asarray(want[1]), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(R.numpy(), np.asarray(want[0]), atol=1e-3,
                               rtol=0)


def test_generate_seed_points_on_two_ranks(tmp_path):
    """The view-sharded front end on 2 ranks: the 2-rank worker job's
    seed points bitwise (`test_torch_seed_sharding.py`)."""
    rng = np.random.default_rng(0)
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    jcams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                                heights=sc.height)
    images = sc.render_all().astype(np.float32)
    inputs = {f"cam_{f}": np.asarray(getattr(jcams, f)) for f in _SEED_CAMS}
    inputs.update(images=images, max_keypoints=np.int64(256),
                  matcher=np.asarray("hamming_knn"))
    cams = Cameras.from_projection_matrices(sc.P, widths=sc.width,
                                            heights=sc.height)
    cfg = MatchingConfig(max_keypoints_per_view=256, matcher="hamming_knn")
    with _one_thread():
        points, obs, mask = generate_seed_points(
            torch.as_tensor(images), cams, cfg,
            mesh=pmesh.make_mesh(2, device="cpu"))
    worker = run_job("seed", 2, inputs, tmp_path)
    assert len(points) > 0 and obs.shape[:1] == mask.shape[:1]
    for rank in worker:
        np.testing.assert_array_equal(np.asarray(points), rank["points"])


def test_one_rank_starts_no_process(plane, distributed_runs, monkeypatch):
    """`make_mesh(1)` is today's world-size-1 mesh: the call runs in this
    process, bitwise as before."""

    def refuse(*args, **kwargs):
        raise AssertionError("a process was started for one rank")

    monkeypatch.setattr(launch, "run_processes", refuse)
    scene, _, _ = plane
    mesh = pmesh.make_mesh(1, device="cpu")
    assert mesh == pmesh.global_mesh("cpu") and mesh.started
    with _one_thread():
        res = densify_distributed(scene, distributed_runs["cfg"], mesh=mesh)
    _assert_bitwise(_cloud(res), _cloud(distributed_runs["one"]))
    assert "job_ranks" not in res.metrics.counters


def test_a_failing_rank_fails_the_call(plane, tmp_path, monkeypatch):
    """Seed points of the wrong shape make every rank raise: the call
    raises `RuntimeError` naming the rank, with its traceback; the job's
    directory is gone, no child is left, and this process joined no
    process group."""
    scene, _, pts = plane
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with _one_thread(), pytest.raises(RuntimeError) as info:
        densify_multihost(scene, _config(PipelineConfig, 1),
                          mesh=pmesh.make_mesh(2, device="cpu"),
                          seed_points=pts[:, :2])
    text = str(info.value)
    assert re.search(r"densify_multihost over 2 ranks: rank [01] failed",
                     text), text
    assert "Traceback" in text and "create_patches_from_points" in text
    assert _running(str(tmp_path)) == []
    assert list(tmp_path.iterdir()) == []
    assert not dist.is_initialized()
    assert pmesh.global_mesh("cpu").backend == "none"


def test_a_job_past_its_time_raises(plane, tmp_path, monkeypatch):
    """A job that outlives `mesh.TIMEOUT_S` raises; its children are
    killed."""
    scene, _, pts = plane
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(pmesh, "TIMEOUT_S", 0.5)
    with _one_thread(), pytest.raises(TimeoutError, match="2 ranks"):
        densify_multihost(scene, _config(PipelineConfig, 1),
                          mesh=pmesh.make_mesh(2, device="cpu"),
                          seed_points=pts)
    assert _running(str(tmp_path)) == []
    assert not dist.is_initialized()


_T = torch.zeros(4)
# The SPMD body: each given an unstarted mesh (its other arguments are
# never read).
BLOCKS = {
    "distributed_refine_step": lambda m: distributed.distributed_refine_step(
        None, None, None, 11, mesh=m),
    "distributed_insert": lambda m: distributed.distributed_insert(
        m, None, None, None, None),
    "viewsharded_insert": lambda m: distributed.viewsharded_insert(
        m, None, None, None, None),
    "shard_state": lambda m: distributed.shard_state(None, m),
    "shard_views": lambda m: distributed.shard_views(m, None),
    "nelder_mead": lambda m: nelder_mead(None, _T[None], _T, mesh=m),
    "densify_clustered": lambda m: densify_clustered(None, mesh=m),
    "shard_patches": lambda m: pmesh.shard_patches(m, _T),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_building_blocks_refuse_an_unstarted_mesh(name):
    with pytest.raises(ValueError, match=re.escape(_ENTRY_POINTS)) as info:
        BLOCKS[name](pmesh.make_mesh(2, device="cpu"))
    assert str(info.value).startswith(name)


def test_make_mesh_inside_a_job(tmp_path):
    """Inside a job `make_mesh` is the job's mesh, and raises for another
    world size."""
    for rank in run_job("mesh", 2, {}, tmp_path):
        assert rank["same"].tolist() == [True, True, True]
        assert "job of 2" in str(rank["raised"])
