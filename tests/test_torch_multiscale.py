"""Multi-scale pyramid and coarse-to-fine densify of the port against the
JAX package: `downsample2` within 1e-6, `scale_cameras` K/E/C within 1e-5
(both decompose the scaled P in float64 on the host, then round to f32),
pyramid shapes, and `densify` with `multiscale.levels = 2` on the 5-view
plane: final patch counts within 15% and both median |z| under 0.05, as the
single-scale comparison in `test_torch_pipeline.py`."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from densepoints_tpu.config import ExpandConfig as JaxExpandConfig
from densepoints_tpu.config import MatchingConfig as JaxMatchingConfig
from densepoints_tpu.config import MultiscaleConfig as JaxMultiscaleConfig
from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.config import PipelineConfig as JaxPipelineConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.io import load_scene as jax_load_scene
from densepoints_tpu.multiscale import pyramid as jax_pyramid
from densepoints_tpu.pmvs.pipeline import densify as jax_densify
from densepoints_tpu_torch.config import (
    ExpandConfig,
    MatchingConfig,
    MultiscaleConfig,
    OptimizeConfig,
    PipelineConfig,
)
from densepoints_tpu_torch.io import load_scene
from densepoints_tpu_torch.multiscale import pyramid
from densepoints_tpu_torch.ops import allview_ncc
from densepoints_tpu_torch.pmvs.pipeline import densify
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import cuda_device  # noqa: F401  (fixture)
from tests.torch_port_util import torch_cameras


def _jax_scene_cameras(rng, width=200, height=160):
    scene = TexturedPlaneScene(rng, num_views=2, width=width, height=height)
    return scene, JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height)


@pytest.mark.parametrize("shape", [(1, 4, 4), (3, 121, 160), (2, 7, 9)])
def test_downsample2_matches_jax(rng, shape):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    got = pyramid.downsample2(torch.as_tensor(img)).numpy()
    want = np.asarray(jax_pyramid.downsample2(jnp.asarray(img)))
    assert got.shape == want.shape == shape[:1] + (shape[1] // 2,
                                                   shape[2] // 2)
    np.testing.assert_allclose(got, want, atol=1e-6 * 255, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 0.25])
def test_scale_cameras_matches_jax(rng, scale):
    scene, jcams = _jax_scene_cameras(rng)
    cams = torch_cameras(jcams)
    got = pyramid.scale_cameras(cams, scale)
    want = jax_pyramid.scale_cameras(jcams, scale)
    assert got.device == cams.device
    for f in ("K", "E", "C"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=1e-5, rtol=1e-5)
    for f in ("width", "height"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    pts = torch.as_tensor(rng.uniform(-0.5, 0.5, (10, 3)).astype(np.float32))
    np.testing.assert_allclose(got.project(pts).numpy(),
                               cams.project(pts).numpy() * scale, atol=0.01)


def test_build_pyramid_levels(rng):
    scene, jcams = _jax_scene_cameras(rng)
    images = torch.as_tensor(scene.render_all())
    pyr = pyramid.build_pyramid(images, torch_cameras(jcams), 3)
    assert len(pyr) == 3
    assert pyr[1][0].shape == (2, 80, 100)
    assert pyr[2][0].shape == (2, 40, 50)
    assert int(pyr[2][1].width[0]) == 50 and int(pyr[2][1].height[0]) == 40
    assert all(c.device == images.device for _, c in pyr)


@pytest.fixture(scope="module")
def plane_scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plane")
    scene = TexturedPlaneScene(np.random.default_rng(0), num_views=5,
                               width=160, height=120)
    views = []
    for v in range(5):
        Image.fromarray(scene.render(v).clip(0, 255).astype(np.uint8)).save(
            tmp / f"view_{v}.png")
        views.append({"filename": f"view_{v}.png",
                      "projectionMatrix": scene.P[v].tolist()})
    path = tmp / "scene.json"
    path.write_text(json.dumps({"imagesPath": str(tmp), "views": views}))
    return path


def test_densify_multiscale_matches_jax(plane_scene):
    config = PipelineConfig(
        matching=MatchingConfig(max_keypoints_per_view=256),
        optimize=OptimizeConfig(max_iterations=25),
        expand=ExpandConfig(max_rounds=1),
        multiscale=MultiscaleConfig(levels=2),
    )
    plain = allview_ncc.PLAIN_CALLS
    got = densify(load_scene(plane_scene, device="cpu"), config,
                  device="cpu")
    assert allview_ncc.PLAIN_CALLS > plain  # CPU tensors: the plain path
    want = jax_densify(jax_load_scene(plane_scene), JaxPipelineConfig(
        matching=JaxMatchingConfig(max_keypoints_per_view=256),
        optimize=JaxOptimizeConfig(max_iterations=25),
        expand=JaxExpandConfig(max_rounds=1),
        multiscale=JaxMultiscaleConfig(levels=2),
    ))
    n_port, n_jax = got.patches.capacity, want.patches.capacity
    z_port = np.median(np.abs(got.positions[:, 2]))
    z_jax = np.median(np.abs(want.positions[:, 2]))
    print(f"multiscale final patches: jax {n_jax}, port {n_port}; median "
          f"|z|: jax {z_jax:.5f}, port {z_port:.5f}")
    assert n_port >= 50
    assert z_port < 0.05 and z_jax < 0.05
    assert abs(n_port - n_jax) <= 0.15 * n_jax
    assert {"expand_multiscale", "multiscale_level_1",
            "multiscale_level_0"} <= set(got.metrics.times)
    assert "expand" not in got.metrics.times


@pytest.mark.cuda
def test_pyramid_on_card(rng, cuda_device):
    """Cameras scaled from CUDA cameras stay on the card (K1 takes no CPU
    cameras), and the pyramid matches the CPU's."""
    scene, jcams = _jax_scene_cameras(rng)
    images = torch.as_tensor(scene.render_all())
    cpu = pyramid.build_pyramid(images, torch_cameras(jcams), 2)
    card = pyramid.build_pyramid(images.to(cuda_device),
                                 torch_cameras(jcams, cuda_device), 2)
    for (ic, cc), (ig, cg) in zip(cpu, card):
        assert ig.device.type == "cuda" and cg.device.type == "cuda"
        torch.testing.assert_close(ig.cpu(), ic, atol=1e-4, rtol=1e-6)
        torch.testing.assert_close(cg.K.cpu(), cc.K, atol=0, rtol=0)
