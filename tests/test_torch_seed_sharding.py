"""The view-sharded seed front end of the port (`pmvs/seed.py
_viewsharded_features`, `generate_seed_points(mesh=)`) on 1 and 2 gloo
processes, against its unsharded front end and the JAX package's.

Each rank detects (and describes) a slice of ceil(V / world) views of the
stack padded with blank views, then one all-gather: keypoints,
descriptors and seed points equal the unsharded ones exactly, in the port
and (keypoints and descriptors) in the JAX package on its 8-device mesh.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from densepoints_tpu.config import MatchingConfig as JaxMatchingConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.parallel.mesh import make_mesh as jax_make_mesh
from densepoints_tpu.pmvs.seed import (
    _viewsharded_features as jax_viewsharded_features,
    generate_seed_points as jax_generate_seed_points,
)
from tests.synthetic import TexturedPlaneScene
from tests.torch_parallel_util import run_job

_CAMS = ("P", "K", "E", "C", "x_axis", "width", "height")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    cams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)
    return cams, sc.render_all().astype(np.float32)


@pytest.mark.parametrize("matcher", ["hamming_knn", "epipolar"])
def test_viewsharded_front_end(scene, tmp_path, matcher):
    cams, images = scene
    inputs = {f"cam_{f}": np.asarray(getattr(cams, f)) for f in _CAMS}
    inputs.update(images=images, max_keypoints=np.int64(256),
                  matcher=np.asarray(matcher))
    cfg = JaxMatchingConfig(max_keypoints_per_view=256, matcher=matcher)
    mesh = jax_make_mesh()
    j_xy, _, j_valid, j_desc, _ = jax_viewsharded_features(
        mesh, jnp.asarray(images), cfg)
    j_points, _, _ = jax_generate_seed_points(jnp.asarray(images), cams, cfg)
    V = images.shape[0]
    for world in (1, 2):
        for rank, out in enumerate(run_job("seed", world, inputs, tmp_path)):
            # Equal slices of ceil(V / world) views per rank.
            assert tuple(out["block_shape"]) == (-(-V // world),
                                                 *images.shape[1:])
            for key in ("xy", "resp", "valid", "points"):
                np.testing.assert_array_equal(out[key], out["ref_" + key])
            np.testing.assert_array_equal(out["valid"], np.asarray(j_valid))
            np.testing.assert_allclose(out["xy"], np.asarray(j_xy), atol=0)
            if matcher == "hamming_knn":
                np.testing.assert_array_equal(out["desc"], out["ref_desc"])
                np.testing.assert_array_equal(out["desc"],
                                              np.asarray(j_desc))
                # Descriptor seeds: the JAX package's points, to DLT's f32.
                assert out["points"].shape == j_points.shape
                np.testing.assert_allclose(out["points"], j_points,
                                           atol=1e-3, rtol=0)
            else:
                assert "desc" not in out and j_desc is None
