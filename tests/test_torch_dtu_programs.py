"""The port's DTU-scale program (`densepoints_tpu_torch.scripts.
dtu_scale_run`) against the JAX package, on the CPU at a tiny size.

The JAX programs' `main` is never called here: it writes to fixed /tmp
paths and resumes from them. Their helpers are imported from `scripts/`
and the JAX `densify` is run on the same scene with the same config dict.

Tolerances: the helpers the port copies (`add_nuisances`,
`_tail_forensics`) agree to 1e-12; whole runs agree in final patch count
within 5% and in the median exact distance to the sphere within 10%
(batch shapes round the Nelder-Mead objective, ROADMAP C, so the clouds
are not compared point for point).
"""
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (keeps jax on the CPU backend here)
import numpy as np
import pytest
import torch

from densepoints_tpu.config import load_config as jax_load_config
from densepoints_tpu.core.cameras import Cameras as JaxCameras
from densepoints_tpu.io.scene import Scene as JaxScene
from densepoints_tpu.pmvs.pipeline import densify as jax_densify
from densepoints_tpu_torch.ops import allview_ncc
from densepoints_tpu_torch.scripts import _scene_runs
from densepoints_tpu_torch.scripts import (
    dtu_layout_run,
    dtu_scale_run,
    occlusion_run,
)
from tests import torch_port_util  # noqa: F401  (torch threads)
from tests.synthetic import TexturedSphereScene

ROOT = Path(__file__).resolve().parents[1]
COUNT_RTOL = 0.05  # final patches, port vs JAX
EXACT_MEDIAN_RTOL = 0.10  # median | |p| - r |, port vs JAX

# 9 views of 240 x 180 with the sphere ~90 px across: 2 rounds at
# grid_scale 4 give ~1250 final patches in both packages.
TINY = ("--device cpu --views 9 --width 240 --height 180 --focal 1000 "
        "--kp 512 --nm-iters 30 --expand-nm-iters 20 --max-rounds 2 "
        "--grid-scale 4").split()


def jax_script(name):
    """A module of the JAX package's `scripts/`, under its own name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def exact_median(cloud, radius):
    return float(np.median(np.abs(np.linalg.norm(cloud, axis=1) - radius)))


def test_add_nuisances_matches_jax_script():
    want_fn = jax_script("dtu_layout_run").add_nuisances
    scene = TexturedSphereScene(np.random.default_rng(3), num_views=4,
                                width=96, height=72, focal=200.0,
                                radius=60.0, cam_radius=650.0, tex_size=256,
                                layout="grid")
    images = scene.render_all().astype(np.float32)
    want = want_fn(images.copy(), scene, np.random.default_rng(7), 60.0)
    got = dtu_layout_run.add_nuisances(images.copy(), scene,
                                       np.random.default_rng(7), 60.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert not np.array_equal(got, np.clip(images, 0, 255))


@pytest.mark.parametrize("thr", [0.05, 2.0])
def test_tail_forensics_matches_jax_script(thr):
    want_fn = jax_script("dtu_scale_run")._tail_forensics
    rng = np.random.default_rng(11)
    n, radius = 500, 60.0
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cloud = dirs * (radius + rng.normal(0, 1.0, (n, 1)))
    normals = -dirs + rng.normal(0, 0.3, (n, 3))
    vis = rng.uniform(size=(n, 9)) > 0.4
    acc = np.abs(np.linalg.norm(cloud, axis=1) - radius)
    scene_gen = types.SimpleNamespace(C=rng.normal(0, 650.0, (9, 3)))
    want = want_fn(types.SimpleNamespace(
        normals=normals, patches=types.SimpleNamespace(vis=vis)),
        cloud, acc, radius, scene_gen, thr)
    # The port's result holds its patch state as tensors.
    result = types.SimpleNamespace(
        normals=normals,
        patches=types.SimpleNamespace(vis=torch.as_tensor(vis)))
    got = dtu_scale_run._tail_forensics(result, cloud, acc, radius,
                                        scene_gen, thr)
    assert want["tail"]["count"] and want["inliers"]["count"]
    assert got.keys() == want.keys()
    for side in ("tail", "inliers"):
        assert got[side].keys() == want[side].keys()
        for key, value in want[side].items():
            assert abs(got[side][key] - value) <= 1e-12, (side, key)
    assert dtu_scale_run._tail_forensics(result, cloud[:0], acc[:0], radius,
                                         scene_gen, thr) == {}


@pytest.fixture(scope="module")
def tiny_scene():
    """The program's scene at the tiny size, rendered once."""
    args = dtu_scale_run.parse_args(TINY)
    scene_gen, images = dtu_scale_run.make_scene(args)
    return scene_gen, images


@pytest.fixture()
def cached_scene(tiny_scene, monkeypatch):
    """`make_scene` returns the rendered tiny scene (its texture alone
    takes ~15 s to draw)."""
    scene_gen, images = tiny_scene
    monkeypatch.setattr(dtu_scale_run, "make_scene",
                        lambda args: (scene_gen, images.copy()))
    return tiny_scene


@pytest.fixture(scope="module")
def port_artifact(tiny_scene):
    scene_gen, images = tiny_scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dtu_scale_run, "make_scene",
                   lambda args: (scene_gen, images.copy()))
        plain = allview_ncc.PLAIN_CALLS
        artifact = dtu_scale_run.run(dtu_scale_run.parse_args(TINY))
        assert allview_ncc.PLAIN_CALLS > plain  # CPU tensors: plain path
    return artifact


def test_dtu_scale_run_matches_jax(tiny_scene, port_artifact):
    scene_gen, images = tiny_scene
    args = dtu_scale_run.parse_args(TINY)
    cams = JaxCameras.from_projection_matrices(
        scene_gen.P, widths=args.width, heights=args.height)
    want = jax_densify(JaxScene(cameras=cams, images=images, colors=None),
                       jax_load_config(dtu_scale_run.config_dict(args)))
    n_jax = want.patches.capacity
    n_port = port_artifact["patches"]
    med_jax = exact_median(want.positions, args.radius)
    med_port = port_artifact["quality_mm"]["accuracy_exact_median"]
    print(f"final patches: jax {n_jax}, port {n_port}; exact median: jax "
          f"{med_jax:.4f}, port {med_port:.4f}")
    assert n_jax >= 500
    assert abs(n_port - n_jax) <= COUNT_RTOL * n_jax
    assert abs(med_port - med_jax) <= EXACT_MEDIAN_RTOL * med_jax
    assert port_artifact["counters"]["patches_final"] == n_port
    assert port_artifact["device"] == "cpu"
    assert set(port_artifact["stage_seconds"]) >= {
        "seed", "seed_filter", "seed_optimize", "expand", "filter"}
    assert port_artifact["tail_mm"]["tail"]["count"] + port_artifact[
        "tail_mm"]["inliers"]["count"] == n_port


def test_dtu_scale_run_metrics_match_jax(tiny_scene):
    """The ground truth and the accuracy / completeness the program
    computes equal the JAX program's on one cloud."""
    from densepoints_tpu.utils.metrics import accuracy_completeness

    scene_gen, _ = tiny_scene
    rng = np.random.default_rng(5)
    cloud = rng.standard_normal((300, 3))
    cloud *= 60.0 / np.linalg.norm(cloud, axis=1, keepdims=True)
    cloud[:, 2] = -np.abs(cloud[:, 2])
    cloud += rng.normal(0, 0.5, cloud.shape)
    got, acc = _scene_runs.sphere_quality(cloud, 60.0, scene_gen.C, 2.0)
    # The JAX program's ground truth, verbatim.
    gt_rng = np.random.default_rng(1)
    pts = gt_rng.standard_normal((200_000, 3)).astype(np.float32)
    pts *= 60.0 / np.linalg.norm(pts, axis=1, keepdims=True)
    n_in = -pts / 60.0
    vis_count = np.zeros(len(pts), np.int32)
    for C in scene_gen.C:
        d = pts - C.astype(np.float32)
        cosang = np.sum(d * n_in, axis=1) / np.linalg.norm(d, axis=1)
        vis_count += (np.arccos(np.clip(cosang, -1, 1)) < 0.78)
    want = accuracy_completeness(cloud, pts[vis_count >= 3], threshold=2.0,
                                 max_dist=20.0)
    for field in ("accuracy_mean", "accuracy_median", "completeness_mean",
                  "completeness_median", "accuracy_frac_under",
                  "completeness_frac_under"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(
        acc, np.abs(np.linalg.norm(cloud, axis=1) - 60.0))


def test_work_dir_is_fresh_unless_given(tmp_path):
    with _scene_runs.work_dir("", "probe_") as a:
        assert a.is_dir() and not any(a.iterdir())
        (a / "seeds_optimized.npz").write_bytes(b"")
        with _scene_runs.work_dir("", "probe_") as b:
            assert b != a and not any(b.iterdir())
    assert not a.exists() and not b.exists()
    given = tmp_path / "ckpt"
    with _scene_runs.work_dir(str(given), "probe_") as c:
        assert c == given
        (c / "x").write_bytes(b"")
    assert (given / "x").exists()


def test_runs_in_a_row_do_not_resume_each_other(cached_scene, port_artifact,
                                                tmp_path):
    """Without `--checkpoint-dir` every run starts from the seed stage
    (the JAX program's fixed /tmp directory resumed the previous run);
    with one, the second run resumes from the first's checkpoints."""
    again = dtu_scale_run.run(dtu_scale_run.parse_args(TINY))
    assert "seed" in port_artifact["stage_seconds"]
    assert "seed" in again["stage_seconds"]
    assert again["patches"] == port_artifact["patches"]
    flags = TINY + ["--checkpoint-dir", str(tmp_path)]
    first = dtu_scale_run.run(dtu_scale_run.parse_args(flags))
    assert (tmp_path / "final.npz").exists()
    resumed = dtu_scale_run.run(dtu_scale_run.parse_args(flags))
    assert "seed" in first["stage_seconds"]
    assert "seed" not in resumed["stage_seconds"]
    assert resumed["patches"] == first["patches"]


def test_programs_take_the_device_flag():
    for program in (dtu_scale_run, dtu_layout_run, occlusion_run):
        assert program.parse_args([]).device == "cuda"
        assert program.parse_args([]).checkpoint_dir == ""
        assert program.parse_args([]).out == ""
