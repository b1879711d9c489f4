"""`densify_multihost` of the port on 1 and 2 gloo processes, against
itself and against the JAX package.

The scene is the JAX package's multi-host test scene (5 views of 160 x
120 of the textured plane, 40 seed points, 2 expansion rounds;
`tests/parallel/multihost_worker.py`), at 40 Nelder-Mead iterations in
both packages. Contracts:
  * 2 ranks equal 1 rank: the same count, `vis` equal, positions and
    normals within 1e-5, and the two ranks of a job agree bitwise;
  * the port against the JAX package on its 8-device mesh: counts within
    15% and the plane found (median |z| < 0.05), as `test_torch_pipeline`
    holds the single-host `densify`;
  * a checkpoint written by a 2-rank job resumes in a 1-rank job;
  * the CLI takes the multi-process flags, and rank 0 alone writes.
"""
import dataclasses
import json

import jax.numpy as jnp  # noqa: F401  (keeps jax on the CPU backend here)
import numpy as np
import pytest

from densepoints_tpu.config import PipelineConfig as JaxPipelineConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.io.scene import Scene as JaxScene
from densepoints_tpu.parallel.mesh import make_mesh as jax_make_mesh
from densepoints_tpu.parallel.multihost import (
    densify_multihost as jax_densify_multihost,
)
from densepoints_tpu_torch import cli
from densepoints_tpu_torch.io import read_ply
from tests.synthetic import TexturedPlaneScene
from tests.torch_parallel_util import run_job
from tests.torch_port_util import cuda_device  # noqa: F401  (fixture)

_ITERS = 40
_ROUNDS = 2


def _inputs(**extra):
    return {"max_iterations": np.int64(_ITERS),
            "max_rounds": np.int64(_ROUNDS), **extra}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """1-rank and 2-rank jobs; the 2-rank one writes stage checkpoints."""
    tmp = tmp_path_factory.mktemp("multihost")
    ckpt = tmp / "ckpt"
    return {
        1: run_job("multihost", 1, _inputs(), tmp),
        2: run_job("multihost", 2,
                   _inputs(checkpoint_dir=np.asarray(str(ckpt))), tmp),
        "ckpt": ckpt, "tmp": tmp,
    }


def _assert_same_cloud(a, b, atol=1e-5):
    assert a["position"].shape == b["position"].shape
    np.testing.assert_array_equal(a["vis"], b["vis"])
    np.testing.assert_allclose(a["position"], b["position"], atol=atol,
                               rtol=0)
    np.testing.assert_allclose(a["normal"], b["normal"], atol=atol, rtol=0)


def test_two_ranks_equal_one_rank(runs):
    one, (a, b) = runs[1][0], runs[2]
    assert one["position"].shape[0] >= 50
    for key in ("position", "normal", "vis"):
        np.testing.assert_array_equal(a[key], b[key])
    _assert_same_cloud(a, one)
    # The exit flags, the refine gathers and the win-count votes cross
    # ranks; one rank has nothing to exchange.
    assert a["counter_overhead_collective_calls"] > 0
    assert a["counter_overhead_collective_bytes"] > 0
    assert one["counter_overhead_collective_calls"] == 0


def test_port_matches_jax(runs):
    rng = np.random.default_rng(0)
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    cams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)
    scene = JaxScene(cameras=cams, images=sc.render_all(), colors=None)
    xy = rng.uniform(-0.6, 0.6, (40, 2))
    pts = np.concatenate([xy, np.zeros((40, 1))], 1).astype(np.float32)
    cfg = JaxPipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        optimize=dataclasses.replace(cfg.optimize, max_iterations=_ITERS),
        expand=dataclasses.replace(cfg.expand, max_rounds=_ROUNDS),
    )
    want = jax_densify_multihost(scene, cfg, mesh=jax_make_mesh(8),
                                 seed_points=pts)
    n_jax = want.patches.capacity
    got = runs[2][0]["position"]
    z_jax = np.median(np.abs(np.asarray(want.patches.position)[:, 2]))
    z_port = np.median(np.abs(got[:, 2]))
    print(f"multihost patches: jax {n_jax}, port {len(got)}; median |z|: "
          f"jax {z_jax:.5f}, port {z_port:.5f}")
    assert z_jax < 0.05 and z_port < 0.05
    assert abs(len(got) - n_jax) <= 0.15 * n_jax


def test_two_rank_checkpoint_resumes_on_one_rank(runs):
    """Rank 0 of the 2-rank job wrote the stage files; a 1-rank job resumes
    from `final` (the same cloud, bitwise) and, with `final` gone, from
    `seeds_optimized` (the uninterrupted cloud)."""
    ckpt, tmp = runs["ckpt"], runs["tmp"]
    full = runs[2][0]
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "final.npz", "seeds_optimized.npz"]
    resume = _inputs(checkpoint_dir=np.asarray(str(ckpt)),
                     resume=np.bool_(True))
    final = run_job("multihost", 1, resume, tmp)[0]
    for key in ("position", "normal", "vis"):
        np.testing.assert_array_equal(final[key], full[key])
    (ckpt / "final.npz").unlink()
    resumed = run_job("multihost", 1, resume, tmp)[0]
    assert "counter_seeds_after_refine" in resumed
    _assert_same_cloud(resumed, full)


@pytest.fixture(scope="module")
def plane_scene_json(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("plane_json")
    sc = TexturedPlaneScene(np.random.default_rng(0), num_views=5,
                            width=160, height=120)
    views = []
    for v in range(5):
        Image.fromarray(sc.render(v).clip(0, 255).astype(np.uint8)).save(
            tmp / f"view_{v}.png")
        views.append({"filename": f"view_{v}.png",
                      "projectionMatrix": sc.P[v].tolist()})
    (tmp / "scene.json").write_text(
        json.dumps({"imagesPath": str(tmp), "views": views}))
    (tmp / "settings.json").write_text(json.dumps({
        "matching": {"max_keypoints_per_view": 384},
        "optimize": {"max_iterations": _ITERS},
        "expand": {"max_rounds": 1},
    }))
    return tmp


def test_cli_takes_the_multihost_flags():
    args = cli.build_parser().parse_args(
        ["-i", "s.json", "--distributed", "--coordinator", "127.0.0.1:1",
         "--num-processes", "2", "--process-id", "1", "--partition",
         "clustered", "--halo-threshold", "0.5"])
    assert (args.distributed, args.coordinator, args.num_processes,
            args.process_id, args.partition, args.halo_threshold) == (
        True, "127.0.0.1:1", 2, 1, "clustered", 0.5)
    assert not hasattr(cli, "_NOT_PORTED")


def test_cli_two_ranks_rank_zero_writes(plane_scene_json, tmp_path):
    """`--distributed` over 2 ranks (the view-sharded seed front end, the
    split refine and the view-sharded grids): the PLY of rank 0 only,
    holding the cloud of a 1-rank `--distributed` run."""
    d = plane_scene_json
    argv = ["-i", str(d / "scene.json"), "-s", str(d / "settings.json"),
            "--device", "cpu", "--distributed"]

    def job(world):
        out = tmp_path / f"w{world}"
        out.mkdir()
        run_job("cli", world, {"argv": np.asarray(
            argv + ["-o", str(out / "cloud_{rank}.ply"), "--ascii"])},
            tmp_path)
        return out

    one, two = job(1), job(2)
    assert sorted(p.name for p in two.iterdir()) == ["cloud_0.ply"]
    got = read_ply(two / "cloud_0.ply")["positions"]
    want = read_ply(one / "cloud_0.ply")["positions"]
    assert len(got) >= 20
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.slow
def test_multiscale_two_ranks_equal_one_rank(tmp_path):
    """Two pyramid levels through the multi-rank driver (slow, as the JAX
    package's own multi-scale multihost test is)."""
    one = run_job("multihost", 1, _inputs(levels=np.int64(2)), tmp_path,
                  timeout=600)[0]
    two = run_job("multihost", 2, _inputs(levels=np.int64(2)), tmp_path,
                  timeout=600)
    assert one["position"].shape[0] > 0
    for out in two:
        _assert_same_cloud(out, one)


@pytest.mark.cuda
def test_one_rank_on_nccl(cuda_device, tmp_path):
    """One rank on the card: the backend rule picks NCCL (a GPU of its
    own), and the cloud is the plane's."""
    out = run_job("multihost", 1, _inputs(device=np.asarray("cuda")),
                  tmp_path)[0]
    assert str(out["backend"]) == "nccl"
    assert out["position"].shape[0] >= 50
    assert np.median(np.abs(out["position"][:, 2])) < 0.05


@pytest.mark.cuda
def test_two_ranks_share_one_card_on_gloo(cuda_device, tmp_path):
    """Two ranks on one card: gloo (more ranks than GPUs), K1 on the card
    in both, and the two ranks' clouds equal bitwise."""
    import torch

    if torch.cuda.device_count() != 1:
        pytest.skip("the case of two ranks sharing one card")
    a, b = run_job("multihost", 2, _inputs(device=np.asarray("cuda")),
                   tmp_path)
    assert str(a["backend"]) == "gloo" == str(b["backend"])
    for key in ("position", "normal", "vis"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["position"].shape[0] >= 50
