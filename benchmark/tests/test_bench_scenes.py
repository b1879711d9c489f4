"""The torch renderer against `tests/synthetic.py`'s numpy one at a tiny
size (the harness itself never imports `tests/`)."""
import sys

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.tests.tiny import BENCH

sys.path.insert(0, str(BENCH.parent / "tests"))
import synthetic  # noqa: E402

GEO = scenes.SceneGeometry(views=5, width=64, height=48, focal_px=260.0,
                           radius_mm=60.0, cam_radius_mm=650.0, tex_size=96,
                           yaw_span_rad=1.0, pitch_span_rad=0.5)


def _numpy_scene(rng):
    return synthetic.TexturedSphereScene(
        rng, num_views=GEO.views, width=GEO.width, height=GEO.height,
        focal=GEO.focal_px, radius=GEO.radius_mm,
        cam_radius=GEO.cam_radius_mm, tex_size=GEO.tex_size, layout="grid",
        yaw_span=GEO.yaw_span_rad, pitch_span=GEO.pitch_span_rad)


def test_cameras_match_the_numpy_scene():
    ref = _numpy_scene(np.random.default_rng(0))
    P, K, R, C = scenes.cameras(GEO)
    np.testing.assert_allclose(P, ref.P, rtol=0, atol=1e-9)
    np.testing.assert_allclose(C, ref.C, rtol=0, atol=1e-9)
    np.testing.assert_allclose(K[0], ref.K)
    for v in range(GEO.views):
        np.testing.assert_allclose(K[v] @ np.concatenate(
            [R[v], (-R[v] @ C[v])[:, None]], 1), P[v], atol=1e-9)


def test_texture_matches_smooth_texture_on_the_same_noise():
    rng = np.random.default_rng(3)
    ref = synthetic.smooth_texture(rng, GEO.tex_size)
    rng = np.random.default_rng(3)
    noises = [torch.as_tensor(rng.standard_normal((o, o)))
              for o in scenes.OCTAVES]
    got = scenes.smooth_texture(noises, GEO.tex_size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-4)


@pytest.mark.parametrize("views_per_block", [1, 2, 8])
def test_render_matches_the_numpy_render(views_per_block):
    ref = _numpy_scene(np.random.default_rng(5))
    P, _, _, C = scenes.cameras(GEO)
    texture = torch.as_tensor(ref.texture, dtype=torch.float32)
    got = scenes.render(GEO, P, C, texture, views_per_block).numpy()
    want = ref.render_all()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert (got > 0).mean() > 0.3  # the sphere fills much of each view


def test_scene_seeds_are_distinct_and_repeat():
    seeds = [0, 1, 2**31, 2**31 + 7, 3 * 2**40 + 5, -9]
    drawn = {scenes.scene_seed(s, i) for s in seeds for i in range(4)}
    assert len(drawn) == len(seeds) * 4
    assert all(0 <= d < 2**63 for d in drawn)
    assert scenes.scene_seed(2**33 + 1, 3) == scenes.scene_seed(2**33 + 1, 3)


def test_captures_repeat_from_their_key():
    a = scenes.make_capture(GEO, scenes.scene_seed(2**32 + 11, 1), "cpu")
    b = scenes.make_capture(GEO, scenes.scene_seed(2**32 + 11, 1), "cpu")
    c = scenes.make_capture(GEO, scenes.scene_seed(2**32 + 11, 2), "cpu")
    assert torch.equal(a.images, b.images)
    assert not torch.equal(a.images, c.images)
    assert a.images.dtype == torch.float32
    assert float(a.images.max()) <= 255.0 and float(a.images.min()) >= 0.0


def test_runs_share_a_set_of_captures_in_their_own_order():
    a = scenes.capture_keys(2**31 + 3, 5)
    b = scenes.capture_keys(2**31 + 4, 5)
    assert a == scenes.capture_keys(2**31 + 3, 5)
    assert sorted(a) == sorted(b)  # the shared set
    assert a != b  # in orders of their own
    assert len(set(a)) == 5  # no capture twice in a set
    warm = scenes.scene_seed(2**31 + 3, 0)
    assert warm not in a


def test_hemisphere_cameras_spread_over_a_hemisphere_facing_the_sphere():
    geo = scenes.SceneGeometry(views=40, width=64, height=48, focal_px=90.0,
                               radius_mm=60.0, cam_radius_mm=650.0,
                               tex_size=96, layout="hemisphere")
    P, K, R, C = scenes.cameras(geo)
    np.testing.assert_allclose(np.linalg.norm(C, axis=1), 650.0)
    assert (C[:, 2] < 0).all()  # the half-space the grid faces from
    assert len({tuple(np.round(c, 6)) for c in C}) == geo.views
    np.testing.assert_allclose(R[:, 2], -C / 650.0, atol=1e-12)
    for v in range(geo.views):
        np.testing.assert_allclose(R[v] @ R[v].T, np.eye(3), atol=1e-12)
        o = P[v] @ np.array([0.0, 0.0, 0.0, 1.0])
        np.testing.assert_allclose(o[:2] / o[2], [32.0, 24.0], atol=1e-9)
    # evenly spread: the mean direction points down the hemisphere's axis
    mean = (C / 650.0).mean(axis=0)
    assert abs(mean[0]) < 0.05 and abs(mean[1]) < 0.05 and mean[2] < -0.45
