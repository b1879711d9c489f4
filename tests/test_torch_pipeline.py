"""End-to-end densify() of the port vs the JAX package on one plane scene.

The clouds are not compared point for point: last-bit float differences
can flip Nelder-Mead accept decisions and so which candidates win a cell.
Both must reconstruct the plane z = 0 (median |z| < 0.05 at scene scale
~5) with final patch counts within 15% of each other. Both runs write
their stage checkpoints; a run of the port resumed from its own
`seeds_optimized` checkpoint equals its uninterrupted run bitwise.
"""
import json
import shutil

import jax.numpy as jnp  # noqa: F401  (keeps jax on the CPU backend here)
import numpy as np
import pytest

from densepoints_tpu.config import ExpandConfig as JaxExpandConfig
from densepoints_tpu.config import MatchingConfig as JaxMatchingConfig
from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.config import PipelineConfig as JaxPipelineConfig
from densepoints_tpu.config import RuntimeConfig as JaxRuntimeConfig
from densepoints_tpu.io import load_scene as jax_load_scene
from densepoints_tpu.pmvs.pipeline import densify as jax_densify
from densepoints_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from densepoints_tpu_torch import cli
from densepoints_tpu_torch.config import (
    BAConfig,
    ExpandConfig,
    MatchingConfig,
    MultiscaleConfig,
    OptimizeConfig,
    PipelineConfig,
    RuntimeConfig,
)
from densepoints_tpu_torch.io import load_scene, read_ply
from densepoints_tpu_torch.ops import allview_ncc
from densepoints_tpu_torch.pmvs.pipeline import densify
from densepoints_tpu_torch.utils.checkpoint import load_checkpoint
from tests.synthetic import TexturedPlaneScene

_STAGES = ("seeds_optimized", "expanded", "final")


@pytest.fixture(scope="module")
def plane_scene(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("plane")
    rng = np.random.default_rng(0)
    scene = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    views = []
    for v in range(5):
        img = scene.render(v).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(tmp / f"view_{v}.png")
        views.append(
            {"filename": f"view_{v}.png", "projectionMatrix": scene.P[v].tolist()}
        )
    path = tmp / "scene.json"
    path.write_text(json.dumps({"imagesPath": str(tmp), "views": views}))
    return path


def _config():
    return PipelineConfig(
        matching=MatchingConfig(max_keypoints_per_view=384),
        optimize=OptimizeConfig(max_iterations=40),
        expand=ExpandConfig(max_rounds=2),
    )


@pytest.fixture(scope="module")
def port_run(plane_scene, tmp_path_factory):
    """The port's densify on the CPU with stage checkpoints; returns
    (result, checkpoint directory)."""
    ckpt = tmp_path_factory.mktemp("port_ckpt")
    plain = allview_ncc.PLAIN_CALLS
    config = _config().replace(runtime=RuntimeConfig(checkpoint_dir=str(ckpt)))
    result = densify(load_scene(plane_scene, device="cpu"), config,
                     device="cpu")
    assert allview_ncc.PLAIN_CALLS > plain  # CPU tensors: the plain path
    return result, ckpt


@pytest.fixture(scope="module")
def port_result(port_run):
    return port_run[0]


@pytest.fixture(scope="module")
def jax_run(plane_scene, tmp_path_factory):
    """The JAX package's densify at the same settings, with checkpoints."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = JaxPipelineConfig(
        matching=JaxMatchingConfig(max_keypoints_per_view=384),
        optimize=JaxOptimizeConfig(max_iterations=40),
        expand=JaxExpandConfig(max_rounds=2),
        runtime=JaxRuntimeConfig(checkpoint_dir=str(ckpt)),
    )
    return jax_densify(jax_load_scene(plane_scene), jcfg), ckpt


def test_densify_matches_jax(jax_run, port_result):
    want = jax_run[0]
    n_jax, n_port = want.patches.capacity, port_result.patches.capacity
    z_jax = np.median(np.abs(want.positions[:, 2]))
    z_port = np.median(np.abs(port_result.positions[:, 2]))
    print(f"final patches: jax {n_jax}, port {n_port}; median |z|: jax "
          f"{z_jax:.5f}, port {z_port:.5f}")
    assert n_port >= 50
    assert z_jax < 0.05 and z_port < 0.05
    assert abs(n_port - n_jax) <= 0.15 * n_jax
    assert set(port_result.metrics.times) >= {
        "seed", "seed_filter", "seed_optimize", "expand", "filter", "color"
    }


def test_checkpoints_match_jax_stage_files(jax_run, port_run):
    """Both packages write the same three stage files, each loading in the
    other package with its stage and patch count."""
    (want, jax_ckpt), (got, port_ckpt) = jax_run, port_run
    names = {f"{stage}.npz" for stage in _STAGES}
    assert {p.name for p in jax_ckpt.iterdir()} == names
    assert {p.name for p in port_ckpt.iterdir()} == names
    for stage in _STAGES:
        state, meta, cams = jax_load_checkpoint(port_ckpt / f"{stage}.npz")
        assert meta["stage"] == stage and cams is not None
        assert state.capacity == meta["capacity"]
        state, meta, cams = load_checkpoint(jax_ckpt / f"{stage}.npz",
                                            device="cpu")
        assert meta["stage"] == stage and cams.device.type == "cpu"
        assert state.capacity == meta["capacity"]
    _, final, _ = load_checkpoint(port_ckpt / "final.npz", device="cpu")
    assert final["capacity"] == got.patches.capacity
    assert jax_load_checkpoint(jax_ckpt / "final.npz")[1]["capacity"] == \
        want.patches.capacity


def test_ply_round_trip(tmp_path, port_result):
    for binary in (True, False):
        out = tmp_path / f"cloud_{binary}.ply"
        port_result.save_ply(out, binary=binary)
        cloud = read_ply(out)
        np.testing.assert_allclose(
            cloud["positions"], port_result.positions, atol=1e-5
        )
        np.testing.assert_allclose(
            cloud["normals"], port_result.normals, atol=1e-5
        )
        np.testing.assert_array_equal(cloud["colors"], port_result.colors)
    assert port_result.colors.max() > 0


def _cli_cloud(tmp_path, plane_scene, flags):
    """Positions of the CLI's cloud of the plane scene at quick settings."""
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({
        "matching": {"max_keypoints_per_view": 256},
        "optimize": {"max_iterations": 30},
        "expand": {"max_rounds": 1},
    }))
    out = tmp_path / f"out{len(list(tmp_path.glob('out*.ply')))}.ply"
    rc = cli.main(["-i", str(plane_scene), "-s", str(settings), "-o",
                   str(out), "--ascii", *flags])
    assert rc == 0
    return read_ply(out)["positions"]


@pytest.mark.parametrize("flags", [
    ["--device", "cpu"],
    ["--platform", "cpu"],
    ["--platform", "cpu", "--device", "cpu", "--resume"],
], ids=["device", "platform", "platform_device_resume"])
def test_cli_main(tmp_path, plane_scene, flags):
    """The JAX CLI's `--platform cpu` is `--device cpu`; `--resume` without
    `--checkpoint-dir` is a plain run (the JAX package resumes only when
    both are set, `densepoints_tpu/pmvs/pipeline.py:161`)."""
    positions = _cli_cloud(tmp_path, plane_scene, flags)
    assert len(positions) > 10
    if flags != ["--device", "cpu"]:
        want = _cli_cloud(tmp_path, plane_scene, ["--device", "cpu"])
        np.testing.assert_array_equal(positions, want)


@pytest.mark.parametrize("flags,match", [
    (["--platform", "tpu"], "--device"),
    (["--platform", "cpu", "--device", "cuda"], "--device cuda"),
    (["--platform", "gpu", "--device", "cpu"], "--device cpu"),
], ids=["tpu", "cpu_vs_cuda", "gpu_vs_cpu"])
def test_cli_platform_refusals(plane_scene, flags, match):
    """A platform the port has no device for, or a --device that
    contradicts --platform, is refused before any work, naming --device."""
    with pytest.raises(ValueError, match=match):
        cli.main(["-i", str(plane_scene), *flags])


def test_cli_resume_flag_sets_runtime_resume(plane_scene, port_result,
                                              monkeypatch, tmp_path):
    from densepoints_tpu_torch.pmvs import pipeline

    assert cli.build_parser().parse_args(["-i", "s.json", "--resume"]).resume
    seen = {}

    def fake_densify(scene, config, device):
        seen.update(config=config, device=device)
        return port_result

    monkeypatch.setattr(pipeline, "densify", fake_densify)
    rc = cli.main(["-i", str(plane_scene), "-o", str(tmp_path / "c.ply"),
                   "--resume", "--platform", "cpu"])
    assert rc == 0
    assert seen["config"].runtime.resume and seen["device"] == "cpu"


def test_resume_without_checkpoint_dir_is_a_plain_run(plane_scene,
                                                      port_result):
    """The JAX package resumes only when `runtime.resume` and
    `runtime.checkpoint_dir` are both set
    (`densepoints_tpu/pmvs/pipeline.py:161`); with `resume` alone it runs a
    plain densify, and so does the port: the same cloud as without it."""
    config = _config().replace(runtime=RuntimeConfig(resume=True))
    result = densify(load_scene(plane_scene, device="cpu"), config,
                     device="cpu")
    np.testing.assert_array_equal(result.positions, port_result.positions)
    np.testing.assert_array_equal(result.normals, port_result.normals)


def test_checkpoint_dir_still_raises(plane_scene, port_run, tmp_path):
    """A run resumed from the `seeds_optimized` checkpoint equals the
    uninterrupted run bitwise on the CPU, and writes the later stages
    itself. (The name is the one of the refusal this test replaced.)"""
    want, ckpt = port_run
    shutil.copy(ckpt / "seeds_optimized.npz", tmp_path)
    config = _config().replace(
        runtime=RuntimeConfig(checkpoint_dir=str(tmp_path), resume=True))
    result = densify(load_scene(plane_scene, device="cpu"), config,
                     device="cpu")
    np.testing.assert_array_equal(result.positions, want.positions)
    np.testing.assert_array_equal(result.normals, want.normals)
    np.testing.assert_array_equal(result.colors, want.colors)
    assert {p.name for p in tmp_path.iterdir()} == {
        f"{stage}.npz" for stage in _STAGES}
    assert "seed" not in result.metrics.times
    assert "expand" in result.metrics.times


_QUICK = {"max_keypoints_per_view": 256}


@pytest.mark.parametrize("change", [
    {"ba": BAConfig(enable=True)},
    {"multiscale": MultiscaleConfig(levels=2)},
    {"matching": MatchingConfig(detector="fast", **_QUICK)},
    {"matching": MatchingConfig(matcher="epipolar", **_QUICK)},
    {"expand": ExpandConfig(prescreen="claim", max_rounds=1)},
], ids=["ba", "multiscale", "fast", "epipolar", "prescreen"])
def test_branches_outside_the_slice_raise(plane_scene, change):
    """Every branch of the JAX package's single-host densify runs in the
    port and reconstructs the plane: bundle adjustment, multi-scale, FAST,
    the other matchers, the pre-screen. (The name is the one of the
    refusals this test replaced.)"""
    config = _config().replace(
        optimize=OptimizeConfig(max_iterations=20),
        expand=ExpandConfig(max_rounds=1),
    ).replace(**change)
    result = densify(load_scene(plane_scene, device="cpu"), config,
                     device="cpu")
    # Descriptor-free matching on 5 close views merges nearly every keypoint
    # into one union-find track (as in the JAX package): a handful of
    # patches. The others give a cloud on the plane z = 0.
    few = change.get("matching", MatchingConfig()).matcher == "epipolar"
    assert result.patches.capacity >= (1 if few else 20)
    assert np.isfinite(result.positions).all()
    if not few:
        assert np.median(np.abs(result.positions[:, 2])) < 0.1
    if "ba" in change:  # exact cameras: BA keeps them exact
        assert result.metrics.counters["ba_rmse_px"] < 0.5
        assert "bundle_adjust" in result.metrics.times
    if "multiscale" in change:
        assert {"multiscale_level_1", "multiscale_level_0"} <= set(
            result.metrics.times)


@pytest.mark.parametrize("change,match", [
    ({"matching": MatchingConfig(detector="orb")}, "unknown detector"),
    ({"matching": MatchingConfig(matcher="flann")}, "unknown matcher"),
    ({"expand": ExpandConfig(prescreen="maybe")}, "unknown prescreen"),
], ids=["detector", "matcher", "prescreen"])
def test_unknown_values_raise_value_error(plane_scene, change, match):
    config = _config().replace(**change)
    with pytest.raises(ValueError, match=match):
        densify(load_scene(plane_scene, device="cpu"), config, device="cpu")


@pytest.mark.parametrize("flags", [
    ["--distributed"], ["--mesh", "m.ply"], ["--partition", "clustered"],
], ids=["distributed", "mesh", "clustered"])
def test_cli_flags_outside_the_slice_raise(plane_scene, tmp_path, flags):
    """The multi-host flags and `--partition clustered` raise, naming
    ROADMAP A.11 (parallel/); `--mesh` writes a mesh of the cloud."""
    if flags[0] != "--mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
            cli.main(["-i", str(plane_scene), *flags])
        return
    mesh = tmp_path / flags[1]
    positions = _cli_cloud(tmp_path, plane_scene,
                           ["--device", "cpu", "--mesh", str(mesh)])
    header = mesh.read_bytes()[:300]
    assert b"element face" in header
    verts = read_ply(mesh)["positions"]
    assert len(verts) > 10 and np.isfinite(verts).all()
    assert np.median(np.abs(verts[:, 2])) < 0.1
    # Inside the cloud's box grown by the grid's 5% pad and a voxel.
    lo, hi = positions.min(0), positions.max(0)
    grow = 0.06 * (hi - lo).max()
    assert ((verts >= lo - grow) & (verts <= hi + grow)).all()


def test_cli_runtime_flags(plane_scene, tmp_path):
    """`--checkpoint-dir`, `--debug-dir` and `--profile-dir` fill their
    directories as the JAX CLI's do (the trace is `torch.profiler`'s Chrome
    trace); `--resume` from the checkpoints gives the same cloud."""
    ckpt, dbg, prof = tmp_path / "ckpt", tmp_path / "dbg", tmp_path / "prof"
    flags = ["--device", "cpu", "--checkpoint-dir", str(ckpt),
             "--debug-dir", str(dbg), "--profile-dir", str(prof)]
    first = _cli_cloud(tmp_path, plane_scene, flags)
    assert {p.name for p in ckpt.iterdir()} == {
        f"{stage}.npz" for stage in _STAGES}
    dumped = {str(p.relative_to(dbg)) for p in dbg.rglob("*.*")}
    assert {"points/seeds.ply", "points/final.ply"} <= dumped
    assert {f"view_{v}.png" for v in range(5)} <= dumped
    trace = json.loads((prof / "densify.pt.trace.json").read_text())
    assert any(str(e.get("name")).startswith("aten::")
               for e in trace["traceEvents"])
    assert len(read_ply(dbg / "points" / "final.ply")["positions"]) == \
        len(first)
    resumed = _cli_cloud(tmp_path, plane_scene,
                         ["--device", "cpu", "--checkpoint-dir", str(ckpt),
                          "--resume"])
    np.testing.assert_array_equal(resumed, first)
