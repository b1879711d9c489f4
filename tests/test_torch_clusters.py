"""`parallel/clusters.py` of the port (covisibility, balanced view
clusters, halos) against the JAX package's, and `plan_clusters` as each
rank of a 2-process gloo job makes it.

Host numpy float64 on both sides from the same f32 cameras: equal
exactly (the affinity within 1e-12).
"""
import numpy as np
import pytest

from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.parallel import clusters as jax_clusters
from densepoints_tpu.parallel.clustered import (
    plan_clusters as jax_plan_clusters,
)
from densepoints_tpu_torch.parallel import clusters
from densepoints_tpu_torch.parallel.clustered import plan_clusters
from tests.synthetic import TexturedPlaneScene, TexturedSphereScene
from tests.torch_parallel_util import run_job
from tests.torch_port_util import torch_cameras

_CAMS = ("P", "K", "E", "C", "x_axis", "width", "height")


def _ring(num_views=8):
    sc = TexturedSphereScene(np.random.default_rng(0), num_views=num_views,
                             width=200, height=150, focal=170.0, radius=1.0,
                             cam_radius=4.0)
    return JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)


def _plane():
    sc = TexturedPlaneScene(np.random.default_rng(0), num_views=5,
                            width=160, height=120)
    return JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)


@pytest.fixture(scope="module", params=["ring8", "ring13", "plane5"])
def cams(request):
    jc = {"ring8": lambda: _ring(8), "ring13": lambda: _ring(13),
          "plane5": _plane}[request.param]()
    return jc, torch_cameras(jc)


def test_covisibility_matrix_matches_jax(cams):
    jc, tc = cams
    got = clusters.covisibility_matrix(tc)
    np.testing.assert_allclose(got, jax_clusters.covisibility_matrix(jc),
                               atol=1e-12, rtol=0)
    assert np.allclose(np.diag(got), 1.0)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_cluster_views_matches_jax(cams, k):
    jc, tc = cams
    got = clusters.cluster_views(tc, k)
    np.testing.assert_array_equal(got, jax_clusters.cluster_views(jc, k))
    # No cluster above ceil(V / k) views (the greedy growth's cap; with 13
    # views in 4 clusters it leaves 4, 3, 4, 2 in both packages).
    assert np.bincount(got).max() <= -(-tc.num_views // k)


@pytest.mark.parametrize("threshold", [-1.0, 0.25, 0.62])
def test_cluster_halos_match_jax(cams, threshold):
    jc, tc = cams
    assign = clusters.cluster_views(tc, 3)
    got = clusters.cluster_halos(tc, assign, threshold)
    want = jax_clusters.cluster_halos(jc, assign, threshold)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plan_clusters_clamps_the_process_id():
    """A reference behaviour, kept: a process id past the last cluster
    holds the last cluster's views and owns no member view, in both
    packages."""
    jc = _ring(8)
    tc = torch_cameras(jc)
    for pid in (1, 2, 5):
        got, want = plan_clusters(tc, 2, pid), jax_plan_clusters(jc, 2, pid)
        np.testing.assert_array_equal(got.my_views, want.my_views)
        np.testing.assert_array_equal(got.member_mask, want.member_mask)
        np.testing.assert_array_equal(got.halo_mask, want.halo_mask)
    last = plan_clusters(tc, 2, 1)
    clamped = plan_clusters(tc, 2, 5)
    np.testing.assert_array_equal(clamped.my_views, last.my_views)
    assert last.member_mask.any() and not clamped.member_mask.any()


def test_each_rank_plans_its_cluster(tmp_path):
    jc = _ring(8)
    inputs = {f"cam_{f}": np.asarray(getattr(jc, f)) for f in _CAMS}
    inputs["halo_threshold"] = np.float64(0.62)
    ranks = run_job("plan", 2, inputs, tmp_path, timeout=120)
    for pid, out in enumerate(ranks):
        want = jax_plan_clusters(jc, 2, pid, 0.62)
        np.testing.assert_array_equal(out["assign"], want.assign)
        np.testing.assert_array_equal(out["my_views"], want.my_views)
        np.testing.assert_array_equal(out["member_mask"], want.member_mask)
    assert set(ranks[0]["my_views"]) != set(ranks[1]["my_views"])
    assert not (ranks[0]["member_mask"] & ranks[1]["member_mask"]).any()
