"""The port's alternative seed front end vs the JAX package, module by module.

Tolerances and why:
  * grid cells, the three matchers on identical inputs, one-hop tracks:
    exactly equal (integer work; ties toward the lower index as
    `jnp.argmin` and `jax.lax.top_k` break them);
  * FAST response: equal where both are finite within 1e-3 grey levels (a
    sum of 16 f32 margins in another order), the corner mask >= 99.9% equal;
    FAST keypoints xy / valid >= 99% equal (measured: 1.0);
  * projections, epipolar distances, `triangulate_pair`, homographies (after
    division by H[2, 2], or through `apply_homography`): 1e-4 relative /
    absolute in the units given with each check;
  * `generate_seed_points` per matcher on one plane scene: the same number
    of seed points within 1%, and, when the tracks are equal, >= 99% of
    the points equal at 1e-3 (descriptor-free matches include false ones
    whose rays are near parallel: their f32 DLT lands thousands of units
    away and differs in its leading digits between the packages).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import MatchingConfig as JaxMatchingConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.core import grid as jax_grid
from densepoints_tpu.core.cameras import (
    project_point_all_views as jax_project_all,
)
from densepoints_tpu.core.cameras import project_points as jax_project
from densepoints_tpu.features import detector as jax_detector
from densepoints_tpu.features import matching as jax_matching
from densepoints_tpu.features.descriptors import (
    compute_descriptors as jax_descriptors,
)
from densepoints_tpu.features.tracks import (
    build_tracks_onehop as jax_tracks_onehop,
)
from densepoints_tpu.geometry import fundamental as jax_fundamental
from densepoints_tpu.geometry import homography as jax_homography
from densepoints_tpu.geometry.triangulation import (
    triangulate_pair as jax_triangulate_pair,
)
from densepoints_tpu.pmvs.seed import generate_seed_points as jax_seeds
from densepoints_tpu_torch.config import MatchingConfig
from densepoints_tpu_torch.core import grid
from densepoints_tpu_torch.core.cameras import (
    project_point_all_views,
    project_points,
)
from densepoints_tpu_torch.features import detector, matching
from densepoints_tpu_torch.features.descriptors import brief_pattern
from densepoints_tpu_torch.features.tracks import build_tracks_onehop
from densepoints_tpu_torch.geometry import fundamental, homography
from densepoints_tpu_torch.geometry.triangulation import triangulate_pair
from densepoints_tpu_torch.pmvs.seed import generate_seed_points
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import torch_cameras

t = torch.as_tensor


def _scene(rng, num_views=4):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=200, height=160)
    cams = JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    return scene, cams, scene.render_all()


def test_grid_cells_match(rng):
    assert grid.grid_dims(200, 160, 16) == jax_grid.grid_dims(200, 160, 16)
    assert grid.grid_dims(201, 161, 16) == (13, 11)
    x = rng.uniform(0, 200, 50).astype(np.float32)
    y = rng.uniform(0, 160, 50).astype(np.float32)
    for fn in ("cell_x", "cell_y"):
        np.testing.assert_array_equal(
            getattr(grid, fn)(t(x), 16).numpy(),
            np.asarray(getattr(jax_grid, fn)(x, 16)),
        )
    np.testing.assert_array_equal(
        grid.cell_xy(t(x), t(y), 13, 16).numpy(),
        np.asarray(jax_grid.cell_xy(x, y, 13, 16)),
    )


def test_projections_match(rng):
    scene, _, _ = _scene(rng)
    P = scene.P.astype(np.float32)
    pts = (rng.uniform(-1, 1, (6, 5, 3)) * [1, 1, 0.3]).astype(np.float32)
    want = np.asarray(jax_project(jnp.asarray(P[0]), jnp.asarray(pts)))
    got = project_points(t(P[0]), t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)  # pixels
    want = np.asarray(jax_project_all(jnp.asarray(P), jnp.asarray(pts)))
    got = project_point_all_views(t(P), t(pts)).numpy()
    assert got.shape == (4, 6, 5, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_epipolar_distance_matrix_matches(rng):
    scene, _, _ = _scene(rng, num_views=2)
    F = jax_fundamental.fundamental_matrices_for_pairs(
        scene.P, np.array([[0, 1]]))[0].astype(np.float32)
    p1 = rng.uniform(0, 200, (30, 2)).astype(np.float32)
    p2 = rng.uniform(0, 160, (40, 2)).astype(np.float32)
    want = np.asarray(jax_fundamental.epipolar_distance_matrix(
        jnp.asarray(F), jnp.asarray(p1), jnp.asarray(p2)))
    got = fundamental.epipolar_distance_matrix(t(F), t(p1), t(p2)).numpy()
    assert got.shape == (30, 40)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)  # pixels


def test_triangulate_pair_matches(rng):
    scene, _, _ = _scene(rng, num_views=2)
    P = scene.P.astype(np.float32)
    pts = rng.uniform(-1, 1, (25, 3)) * [1, 1, 0.3]
    ph = np.concatenate([pts, np.ones((25, 1))], 1)
    proj = np.einsum("vij,nj->vni", scene.P, ph)
    obs = (proj[..., :2] / proj[..., 2:]).astype(np.float32)
    want = np.asarray(jax_triangulate_pair(
        jnp.asarray(P[0]), jnp.asarray(obs[0]), jnp.asarray(P[1]),
        jnp.asarray(obs[1])))
    got = triangulate_pair(t(P[0]), t(obs[0]), t(P[1]), t(obs[1])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pts, atol=1e-2)


def test_homography_matches(rng):
    src = np.array([[0, 0], [16, 0], [16, 16], [0, 16]], np.float32)
    src = np.tile(src, (7, 1, 1))
    dst = (src * rng.uniform(2, 4, (7, 1, 1)) + rng.uniform(20, 80, (7, 1, 2))
           + rng.normal(0, 2.0, (7, 4, 2))).astype(np.float32)
    want = np.asarray(jax_homography.homography_from_4pts(
        jnp.asarray(src), jnp.asarray(dst)))
    got = homography.homography_from_4pts(t(src), t(dst))
    np.testing.assert_allclose(got[..., 2, 2].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # The 4 correspondences are met exactly, and both map a grid alike.
    np.testing.assert_allclose(
        homography.apply_homography(got, t(src)).numpy(), dst, atol=1e-2)
    pts = rng.uniform(0, 16, (7, 9, 2)).astype(np.float32)
    np.testing.assert_allclose(
        homography.apply_homography(got, t(pts)).numpy(),
        np.asarray(jax_homography.apply_homography(
            jnp.asarray(want), jnp.asarray(pts))),
        rtol=1e-4, atol=1e-3,  # pixels
    )


def test_plane_homography_matches(rng):
    scene, _, _ = _scene(rng)
    P = scene.P.astype(np.float32)
    origin = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    ex = rng.normal(size=(4, 3)).astype(np.float32)
    ey = rng.normal(size=(4, 3)).astype(np.float32)
    want = np.asarray(jax_homography.plane_homography(
        *(jnp.asarray(a) for a in (P, origin, ex, ey))))
    got = homography.plane_homography(t(P), t(origin), t(ex), t(ey))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    # (s, t) on the plane lands where the projection of the 3-D point does.
    st = rng.uniform(-0.2, 0.2, (4, 5, 2)).astype(np.float32)
    world = (origin[:, None] + st[..., :1] * ex[:, None]
             + st[..., 1:] * ey[:, None])
    np.testing.assert_allclose(
        homography.apply_homography(got, t(st)).numpy(),
        project_points(t(P)[:, None], t(world)).numpy(),
        rtol=1e-3, atol=1e-2,
    )


def test_fast_response_matches(rng):
    _, _, images = _scene(rng, num_views=3)
    want = np.asarray(jax_detector.fast_response(jnp.asarray(images)))
    got = detector.fast_response(t(images)).numpy()
    assert got.shape == want.shape
    corners = np.isfinite(want)
    same_mask = (np.isfinite(got) == corners).mean()
    both = corners & np.isfinite(got)
    print(f"fast_response: corner mask equal {same_mask:.5f}, "
          f"{corners.sum()} corners")
    assert same_mask >= 0.999 and corners.sum() > 500
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5, atol=1e-3)
    assert (got[~np.isfinite(got)] == -np.inf).all()


def test_fast_keypoints_match(rng):
    _, _, images = _scene(rng)
    kw = dict(max_keypoints=384, border=16, method="fast", fast_threshold=10.0)
    jxy, _, jvalid = jax_detector.detect_keypoints(jnp.asarray(images), **kw)
    xy, resp, valid = detector.detect_keypoints(t(images), **kw)
    same_xy = (xy.numpy() == np.asarray(jxy)).all(-1).mean()
    same_valid = (valid.numpy() == np.asarray(jvalid)).mean()
    print(f"FAST keypoints: xy equal {same_xy:.4f}, valid equal "
          f"{same_valid:.4f}, {int(valid.sum())} valid")
    assert same_xy >= 0.99 and same_valid >= 0.99
    assert int(valid.sum()) > 100
    with pytest.raises(ValueError, match="unknown detector"):
        detector.detect_keypoints(t(images), method="orb")


def _front_end(images, k=256):
    jxy, _, jvalid = jax_detector.detect_keypoints(
        jnp.asarray(images), max_keypoints=k, border=16)
    jdesc = jax_descriptors(jnp.asarray(images), jxy,
                            jnp.asarray(brief_pattern()))
    return np.asarray(jxy), np.asarray(jvalid), np.asarray(jdesc)


def test_match_pair_absolute_matches(rng):
    _, _, images = _scene(rng, num_views=2)
    _, valid, desc = _front_end(images)
    jm, jd = jax_matching.match_pair_absolute(
        desc[0], desc[1], valid[0], valid[1], 30.0)
    m, d = matching.match_pair_absolute(
        t(desc[0]), t(desc[1]), t(valid[0]), t(valid[1]), 30.0)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert (np.asarray(jm) >= 0).sum() >= 30
    # Batched over a leading pair axis, as the seed stage calls it.
    mb, _ = matching.match_pair_absolute(
        t(desc[[0, 1]]), t(desc[[1, 0]]), t(valid[[0, 1]]),
        t(valid[[1, 0]]), 30.0)
    np.testing.assert_array_equal(mb[0].numpy(), np.asarray(jm))


def test_match_pair_absolute_takes_the_first_of_equal_minima():
    d = torch.tensor([[1.0, 1, 1, 1]])
    others = torch.tensor([[1.0, 1, 1, -1], [1.0, 1, -1, 1],
                           [-1.0, -1, -1, -1]])
    ones = torch.ones(3, dtype=bool)
    idx, dist = matching.match_pair_absolute(d, others, ones[:1], ones, 2.0)
    assert idx.tolist() == [0] and dist.tolist() == [1.0]
    idx, _ = matching.match_pair_absolute(d, others, ones[:1], ones, 1.0)
    assert idx.tolist() == [-1]  # the cutoff is strict
    valid2 = torch.tensor([False, True, True])
    idx, _ = matching.match_pair_absolute(d, others, ones[:1], valid2, 2.0)
    assert idx.tolist() == [1]


def _epipolar_inputs(rng):
    scene, _, images = _scene(rng, num_views=2)
    xy, valid, _ = _front_end(images)
    F = jax_fundamental.fundamental_matrices_for_pairs(
        scene.P, np.array([[0, 1]]))[0].astype(np.float32)
    return F, xy, valid


def test_direct_epipolar_pair_matches(rng):
    F, xy, valid = _epipolar_inputs(rng)
    jm, jd = jax_matching.direct_epipolar_pair(
        jnp.asarray(F), xy[0], xy[1], valid[0], valid[1], 1.5)
    m, d = matching.direct_epipolar_pair(
        t(F), t(xy[0]), t(xy[1]), t(valid[0]), t(valid[1]), 1.5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-3)
    assert (np.asarray(jm) >= 0).sum() >= 30


def test_direct_epipolar_pair_topk_matches(rng):
    F, xy, valid = _epipolar_inputs(rng)
    jm, jd = jax_matching.direct_epipolar_pair_topk(
        jnp.asarray(F), xy[0], xy[1], valid[0], valid[1], 1.5, 4)
    m, d = matching.direct_epipolar_pair_topk(
        t(F), t(xy[0]), t(xy[1]), t(valid[0]), t(valid[1]), 1.5, 4)
    assert m.shape == (xy.shape[1], 4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-3)
    assert ((np.asarray(jm) >= 0).sum(axis=1) > 1).any()


def test_direct_epipolar_topk_ranks_equal_distances_by_index():
    F = torch.tensor([[0.0, 0, 0], [0, 0, -1], [0, 1, 0]])  # lines y = y1
    xy1 = torch.tensor([[5.0, 3.0]])
    xy2 = torch.tensor([[9.0, 4.0], [1.0, 3.0], [7.0, 2.0], [2.0, 3.0]])
    ones = torch.ones(4, dtype=bool)
    m, d = matching.direct_epipolar_pair_topk(
        F, xy1, xy2, ones[:1], ones, 1.5, 4)
    assert m.tolist() == [[1, 3, 0, 2]] and d.tolist() == [[0.0, 0, 1, 1]]
    m1, _ = matching.direct_epipolar_pair(F, xy1, xy2, ones[:1], ones, 1.5)
    assert m1.tolist() == [1]


def test_build_tracks_onehop_matches(rng):
    V, N, K = 4, 30, 3
    kp = rng.uniform(0, 100, (V, N, 2)).astype(np.float32)
    pairs = np.array([[0, 1], [0, 2], [1, 2], [2, 3], [0, 3]], np.int32)
    matches = np.where(
        rng.uniform(size=(len(pairs), N, K)) < 0.3,
        rng.integers(0, N, (len(pairs), N, K)), -1,
    ).astype(np.int32)
    want = jax_tracks_onehop(V, kp, pairs, matches)
    got = build_tracks_onehop(V, kp, pairs, matches)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert len(got[0]) > 10
    empty = build_tracks_onehop(V, kp, pairs, np.full_like(matches, -1))
    assert [a.shape for a in empty] == [(0, V, 2), (0, V), (0, V)]


@pytest.mark.parametrize(
    "change",
    [{"matcher": "hamming_absolute"}, {"matcher": "epipolar"},
     {"matcher": "epipolar_all"}, {"detector": "fast"}],
    ids=["hamming_absolute", "epipolar", "epipolar_all", "fast"],
)
def test_seed_points_match(rng, change):
    """The whole front end on one scene, per matcher and with FAST."""
    _, cams, images = _scene(rng)
    kw = dict(max_keypoints_per_view=256, **change)
    jpts, jobs, jmask = jax_seeds(
        jnp.asarray(images), cams, JaxMatchingConfig(**kw))
    pts, obs, mask = generate_seed_points(
        t(images), torch_cameras(cams), MatchingConfig(**kw))
    print(f"{change}: seed points jax {len(jpts)}, port {len(pts)}")
    assert len(jpts) > 0
    assert abs(len(pts) - len(jpts)) <= max(1, 0.01 * len(jpts))
    assert obs.shape[1:] == jobs.shape[1:] and mask.dtype == jmask.dtype
    if len(pts) == len(jpts) and (mask == jmask).all():
        close = np.isclose(pts, jpts, rtol=1e-3, atol=1e-3).all(axis=1)
        print(f"{change}: points equal at 1e-3: {close.mean():.4f}")
        assert close.mean() >= 0.99


def test_unknown_matcher_raises(rng):
    _, cams, images = _scene(rng, num_views=2)
    with pytest.raises(ValueError, match="unknown matcher"):
        generate_seed_points(
            t(images), torch_cameras(cams), MatchingConfig(matcher="flann"))
