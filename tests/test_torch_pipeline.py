"""End-to-end densify() of the port vs the JAX package on one plane scene.

The clouds are not compared point for point: last-bit float differences
can flip Nelder-Mead accept decisions and so which candidates win a cell.
Both must reconstruct the plane z = 0 (median |z| < 0.05 at scene scale
~5) with final patch counts within 15% of each other.
"""
import json

import jax.numpy as jnp  # noqa: F401  (keeps jax on the CPU backend here)
import numpy as np
import pytest

from densepoints_tpu.config import ExpandConfig as JaxExpandConfig
from densepoints_tpu.config import MatchingConfig as JaxMatchingConfig
from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.config import PipelineConfig as JaxPipelineConfig
from densepoints_tpu.io import load_scene as jax_load_scene
from densepoints_tpu.pmvs.pipeline import densify as jax_densify
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
from tests.synthetic import TexturedPlaneScene


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
def port_result(plane_scene):
    plain = allview_ncc.PLAIN_CALLS
    result = densify(load_scene(plane_scene, device="cpu"), _config(),
                     device="cpu")
    assert allview_ncc.PLAIN_CALLS > plain  # CPU tensors: the plain path
    return result


def test_densify_matches_jax(plane_scene, port_result):
    jcfg = JaxPipelineConfig(
        matching=JaxMatchingConfig(max_keypoints_per_view=384),
        optimize=JaxOptimizeConfig(max_iterations=40),
        expand=JaxExpandConfig(max_rounds=2),
    )
    want = jax_densify(jax_load_scene(plane_scene), jcfg)
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
    out = tmp_path / f"out{'_'.join(flags)}.ply"
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


def test_checkpoint_dir_still_raises(plane_scene):
    config = _config().replace(
        runtime=RuntimeConfig(checkpoint_dir="ckpt", resume=True))
    with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
        densify(load_scene(plane_scene, device="cpu"), config, device="cpu")


_QUICK = {"max_keypoints_per_view": 256}


@pytest.mark.parametrize("change,ported", [
    ({"ba": BAConfig(enable=True)}, False),
    ({"multiscale": MultiscaleConfig(levels=2)}, False),
    ({"matching": MatchingConfig(detector="fast", **_QUICK)}, True),
    ({"matching": MatchingConfig(matcher="epipolar", **_QUICK)}, True),
    ({"expand": ExpandConfig(prescreen="claim", max_rounds=1)}, True),
], ids=["ba", "multiscale", "fast", "epipolar", "prescreen"])
def test_branches_outside_the_slice_raise(plane_scene, change, ported):
    """A branch the port lacks raises and names its ROADMAP item; the
    branches ported since (FAST, the other matchers, the pre-screen) run
    and reconstruct the plane."""
    config = _config().replace(
        optimize=OptimizeConfig(max_iterations=20),
        expand=ExpandConfig(max_rounds=1),
    ).replace(**change)
    scene = load_scene(plane_scene, device="cpu")
    if not ported:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            densify(scene, config, device="cpu")
        return
    result = densify(scene, config, device="cpu")
    # Descriptor-free matching on 5 close views merges nearly every keypoint
    # into one union-find track (as in the JAX package): a handful of
    # patches. The other two give a cloud on the plane z = 0.
    few = change.get("matching", MatchingConfig()).matcher == "epipolar"
    assert result.patches.capacity >= (1 if few else 20)
    assert np.isfinite(result.positions).all()
    if not few:
        assert np.median(np.abs(result.positions[:, 2])) < 0.1


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
def test_cli_flags_outside_the_slice_raise(plane_scene, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["-i", str(plane_scene), *flags])
