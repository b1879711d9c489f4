"""The port's seed front end vs the JAX package on identical inputs.

Tolerances and why:
  * detect_keypoints xy/valid and compute_descriptors: >= 99% of entries
    equal. The Harris sums and the bilinear taps round differently in the
    last bit (XLA fuses multiply-adds), which can reorder near-equal
    responses or flip a near-equal BRIEF comparison;
  * match_pair, filter_matches_epipolar and build_tracks: exactly equal
    (integer Hamming distances, ties toward the lower index, as
    jax.lax.top_k breaks them);
  * triangulate: within 1e-3 relative (f32 DLT through eigh).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import MatchingConfig as JaxMatchingConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.features import compute_descriptors as jax_descriptors
from densepoints_tpu.features import detect_keypoints as jax_detect
from densepoints_tpu.features import filter_matches_epipolar as jax_epi
from densepoints_tpu.features import match_pair as jax_match
from densepoints_tpu.features.tracks import build_tracks as jax_tracks
from densepoints_tpu.geometry import fundamental_matrices_for_pairs as jax_fpairs
from densepoints_tpu.geometry import triangulate as jax_triangulate
from densepoints_tpu.pmvs.seed import covisibility_pairs as jax_pairs
from densepoints_tpu.pmvs.seed import create_patches_from_points as jax_patches
from densepoints_tpu.pmvs.seed import generate_seed_points as jax_seeds
from densepoints_tpu_torch.config import MatchingConfig
from densepoints_tpu_torch.features.descriptors import (
    brief_pattern,
    compute_descriptors,
)
from densepoints_tpu_torch.features.detector import detect_keypoints
from densepoints_tpu_torch.features.matching import (
    filter_matches_epipolar,
    hamming_distance_matrix,
    match_pair,
)
from densepoints_tpu_torch.features.tracks import build_tracks
from densepoints_tpu_torch.geometry.fundamental import (
    fundamental_matrices_for_pairs,
)
from densepoints_tpu_torch.geometry.triangulation import triangulate
from densepoints_tpu_torch.pmvs.seed import (
    covisibility_pairs,
    create_patches_from_points,
    generate_seed_points,
)
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import torch_cameras


def _scene(rng, num_views=4):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=200, height=160)
    cams = JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    return scene, cams, scene.render_all()


def _front_end(images, k=384):
    jxy, jresp, jvalid = jax_detect(
        jnp.asarray(images), max_keypoints=k, border=16
    )
    pattern = brief_pattern()
    jdesc = jax_descriptors(jnp.asarray(images), jxy, jnp.asarray(pattern))
    return (np.asarray(jxy), np.asarray(jvalid), np.asarray(jdesc), pattern)


def test_detect_keypoints_match(rng):
    _, _, images = _scene(rng)
    jxy, jvalid, _, _ = _front_end(images)
    xy, _, valid = detect_keypoints(
        torch.as_tensor(images), max_keypoints=384, border=16
    )
    same_xy = (xy.numpy() == jxy).all(-1).mean()
    same_valid = (valid.numpy() == jvalid).mean()
    print(f"detect_keypoints: xy equal {same_xy:.4f}, valid equal "
          f"{same_valid:.4f}")
    assert same_xy >= 0.99 and same_valid >= 0.99
    assert jvalid.sum() > 100


def test_compute_descriptors_match(rng):
    _, _, images = _scene(rng)
    jxy, _, jdesc, pattern = _front_end(images)
    desc = compute_descriptors(
        torch.as_tensor(images), torch.as_tensor(jxy),
        torch.as_tensor(pattern),
    )
    same = (desc.numpy() == jdesc).mean()
    print(f"compute_descriptors: entries equal {same:.5f}")
    assert same >= 0.99


def test_hamming_matrix_basic():
    a = torch.tensor([[1.0, 1, -1, -1], [1, -1, 1, -1]])
    b = torch.tensor([[1.0, 1, -1, -1], [-1, -1, 1, 1]])
    np.testing.assert_allclose(
        hamming_distance_matrix(a, b).numpy(), [[0, 4], [2, 2]]
    )


def test_match_pair_breaks_ties_toward_lower_index():
    d = torch.tensor([[1.0, 1, 1, 1]])
    others = torch.tensor([[1.0, 1, 1, -1], [-1.0, -1, -1, -1],
                           [1.0, 1, -1, 1], [1.0, 1, 1, 1]])
    v1, v2 = torch.ones(1, dtype=bool), torch.ones(4, dtype=bool)
    # Distances 1, 4, 1, 0: best 3, second 0 (tie of 0 and 2 -> lower).
    idx, dist = match_pair(d, others, v1, v2, lowe_ratio=0.7)
    assert idx.tolist() == [3] and dist.tolist() == [0.0]
    v2[3] = False  # now a tie for the best: lower index wins, ratio fails
    idx, _ = match_pair(d, others, v1, v2, lowe_ratio=2.0)
    assert idx.tolist() == [0]


def test_match_and_epipolar_filter_match(rng):
    scene, _, images = _scene(rng, num_views=2)
    jxy, jvalid, jdesc, _ = _front_end(images)
    F = jax_fpairs(scene.P, np.array([[0, 1]]))[0].astype(np.float32)
    jm, jd = jax_match(jdesc[0], jdesc[1], jvalid[0], jvalid[1])
    jm = np.asarray(jax_epi(jnp.asarray(F), jxy[0], jxy[1], jm, 1.5))
    t = torch.as_tensor
    m, d = match_pair(t(jdesc[0]), t(jdesc[1]), t(jvalid[0]), t(jvalid[1]))
    m = filter_matches_epipolar(t(F), t(jxy[0]), t(jxy[1]), m, 1.5)
    np.testing.assert_array_equal(m.numpy(), jm)
    assert (jm >= 0).sum() >= 30


def test_fundamental_and_pairs_match(rng):
    scene, cams, _ = _scene(rng, num_views=6)
    np.testing.assert_array_equal(
        covisibility_pairs(torch_cameras(cams), 2), jax_pairs(cams, 2)
    )
    pairs = jax_pairs(cams, 0)
    np.testing.assert_allclose(
        fundamental_matrices_for_pairs(scene.P, pairs),
        jax_fpairs(scene.P, pairs), atol=1e-12,
    )


def test_build_tracks_match(rng):
    V, N = 4, 30
    kp = rng.uniform(0, 100, (V, N, 2)).astype(np.float32)
    pairs = np.array([[0, 1], [0, 2], [1, 2], [2, 3], [0, 3]], np.int32)
    matches = np.where(
        rng.uniform(size=(len(pairs), N)) < 0.5,
        rng.integers(0, N, (len(pairs), N)), -1,
    ).astype(np.int32)
    want = jax_tracks(V, kp, pairs, matches)
    got = build_tracks(V, kp, pairs, matches)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 5


def test_triangulate_match(rng):
    scene, _, _ = _scene(rng)
    pts = rng.uniform(-1, 1, (40, 3)) * [1, 1, 0.3]
    ph = np.concatenate([pts, np.ones((40, 1))], 1)
    proj = np.einsum("vij,nj->nvi", scene.P, ph)
    obs = (proj[..., :2] / proj[..., 2:]).astype(np.float32)
    obs += rng.normal(0, 0.1, obs.shape).astype(np.float32)
    mask = rng.uniform(size=(40, scene.P.shape[0])) > 0.3
    mask[:, :2] = True
    P = scene.P.astype(np.float32)
    want = np.asarray(jax_triangulate(
        jnp.asarray(P), jnp.asarray(obs), jnp.asarray(mask)
    ))
    got = triangulate(
        torch.as_tensor(P), torch.as_tensor(obs), torch.as_tensor(mask)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, pts, atol=0.1)


@pytest.mark.parametrize("max_pairs", [0, 2])
def test_seed_points_and_patches_match(rng, max_pairs):
    """The whole front end on one scene: same seed points, same patches."""
    _, cams, images = _scene(rng)
    jcfg = JaxMatchingConfig(max_keypoints_per_view=256,
                             max_pairs_per_view=max_pairs)
    cfg = MatchingConfig(max_keypoints_per_view=256,
                         max_pairs_per_view=max_pairs)
    jpts, _, _ = jax_seeds(jnp.asarray(images), cams, jcfg)
    tc = torch_cameras(cams)
    pts, _, _ = generate_seed_points(torch.as_tensor(images), tc, cfg)
    assert abs(len(pts) - len(jpts)) <= 0.01 * len(jpts)
    if len(pts) == len(jpts):
        np.testing.assert_allclose(pts, jpts, rtol=1e-3, atol=1e-3)
    jst = jax_patches(cams, jpts)
    st = create_patches_from_points(tc, jpts)
    np.testing.assert_array_equal(st.ref.numpy(), np.asarray(jst.ref))
    np.testing.assert_array_equal(st.vis.numpy(), np.asarray(jst.vis))
    np.testing.assert_allclose(
        st.normal.numpy(), np.asarray(jst.normal), atol=1e-5
    )
