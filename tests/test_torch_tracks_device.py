"""Track assembly on the match table's device (`build_tracks_device`)
against the JAX package's `build_tracks` and the port's host one.

Every case is exact: obs, mask and kp_index equal bit for bit, with the
same dtypes, shapes and track order (the order matters: the seed patches
are cut at `max_seeds`). Cases: random tables at several densities, a
long chain across views (several propagation rounds), one component
holding two keypoints of a view (its first keypoint wins), `min_views`
1, 2 and 3, an empty table, a table whose components all fall short of
`min_views` (the card's case is `test_torch_tracks_card.py`, which
imports no JAX). The counters `seed_track_nodes` (distinct matched nodes) and
`seed_track_rounds` (>= 1 once a match exists) are held too. The seed
stage end to end: `generate_seed_points` returns the points, obs and mask
that the host assembly of the same matches gives.
"""
import numpy as np
import pytest
import torch

from densepoints_tpu.features.tracks import build_tracks as jax_tracks
from densepoints_tpu_torch.config import MatchingConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.features import tracks
from densepoints_tpu_torch.pmvs import seed
from densepoints_tpu_torch.utils import StageMetrics
from tests.synthetic import TexturedPlaneScene


def _random_table(rng, num_views, N, density, all_pairs=True):
    if all_pairs:
        a, b = np.triu_indices(num_views, k=1)
    else:
        a = np.arange(num_views - 1)
        b = a + 1
    pairs = np.stack([a, b], axis=1).astype(np.int32)
    matches = np.where(rng.uniform(size=(len(pairs), N)) < density,
                       rng.integers(0, N, (len(pairs), N)), -1)
    kp = rng.uniform(0, 640, (num_views, N, 2)).astype(np.float32)
    return kp, pairs, matches.astype(np.int64)


def _matched_nodes(pairs, matches):
    N = matches.shape[1]
    p, i = np.nonzero(matches >= 0)
    ends = np.concatenate([pairs[p, 0] * N + i,
                           pairs[p, 1] * N + matches[p, i]])
    return len(np.unique(ends))


def _assemble(num_views, kp, pairs, matches, min_views, device="cpu"):
    """The device assembly and its counters' change."""
    before = tracks.counts()
    got = tracks.build_tracks_device(
        num_views, torch.as_tensor(kp, device=device), pairs,
        torch.as_tensor(matches, device=device), min_views=min_views)
    metrics = StageMetrics()
    tracks.count_since(metrics, before)
    return [t.cpu().numpy() for t in got], metrics.counters


def _assert_exact(got, *witnesses):
    for want in witnesses:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _check(num_views, kp, pairs, matches, min_views):
    got, counters = _assemble(num_views, kp, pairs, matches, min_views)
    _assert_exact(
        got,
        tracks.build_tracks(num_views, kp, pairs, matches, min_views),
        jax_tracks(num_views, kp, pairs, matches.astype(np.int32),
                   min_views),
    )
    return got, counters


@pytest.mark.parametrize("min_views", [2, 3])
@pytest.mark.parametrize("density", [0.02, 0.2, 0.6, 1.0])
@pytest.mark.parametrize("seed_", [0, 1])
def test_random_tables(min_views, density, seed_):
    rng = np.random.default_rng(100 * seed_ + int(density * 10))
    args = _random_table(rng, 6, 48, density)
    got, counters = _check(6, *args, min_views)
    assert counters["seed_track_nodes"] == _matched_nodes(*args[1:])
    assert counters["seed_track_rounds"] >= 1


@pytest.mark.parametrize("min_views", [2, 3])
def test_long_chain_across_views(min_views):
    """One track through 24 views, linked view to view with the keypoints
    shuffled, so the labels must travel far: several rounds."""
    rng = np.random.default_rng(7)
    V, N = 24, 32
    kp, pairs, matches = _random_table(rng, V, N, 0.0, all_pairs=False)
    chain = rng.integers(0, N, V)
    for p in range(V - 1):
        matches[p, chain[p]] = chain[p + 1]
    got, counters = _check(V, kp, pairs, matches, min_views)
    assert len(got[0]) == 1 and got[1].all()
    assert counters["seed_track_nodes"] == V
    assert counters["seed_track_rounds"] >= 2


@pytest.mark.parametrize("min_views", [2, 3])
def test_two_keypoints_of_a_view_keep_the_first(min_views):
    """(0, 5) ~ (1, 2) ~ (0, 3) ~ (2, 4): view 0 holds keypoints 5 and 3,
    and keypoint 3 (the smaller node) is the track's."""
    V, N = 3, 8
    kp = np.random.default_rng(3).uniform(0, 100, (V, N, 2)).astype(
        np.float32)
    pairs = np.array([[0, 1], [0, 1], [0, 2]], np.int32)
    matches = np.full((3, N), -1, np.int64)
    matches[0, 5] = 2
    matches[1, 3] = 2
    matches[2, 3] = 4
    (obs, mask, kpi), counters = _check(V, kp, pairs, matches, min_views)
    np.testing.assert_array_equal(kpi, [[3, 2, 4]])
    np.testing.assert_array_equal(obs[0, 0], kp[0, 3])
    assert counters["seed_track_nodes"] == 4


def test_min_views_one_keeps_every_node():
    rng = np.random.default_rng(11)
    args = _random_table(rng, 4, 16, 0.3)
    got, counters = _check(4, *args, 1)
    assert len(got[0]) >= 4 * 16 - _matched_nodes(*args[1:])
    assert counters["seed_track_nodes"] == 4 * 16


@pytest.mark.parametrize("shape", [(0, 16), (6, 16)])
@pytest.mark.parametrize("min_views", [2, 3])
def test_empty_table(shape, min_views):
    V = 4
    kp = np.random.default_rng(0).uniform(0, 9, (V, 16, 2)).astype(
        np.float32)
    pairs = np.stack(np.triu_indices(V, k=1), axis=1).astype(
        np.int32)[: shape[0]]
    matches = np.full(shape, -1, np.int64)
    got, counters = _check(V, kp, pairs, matches, min_views)
    assert got[0].shape == (0, V, 2)
    assert counters == {"seed_track_nodes": 0, "seed_track_rounds": 0}


def test_components_all_short_of_min_views():
    """Matched pairs of two views each, disjoint: none reaches three."""
    V, N = 6, 10
    kp = np.random.default_rng(5).uniform(0, 9, (V, N, 2)).astype(
        np.float32)
    pairs = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    matches = np.full((3, N), -1, np.int64)
    matches[:, :4] = np.arange(4)
    got, counters = _check(V, kp, pairs, matches, 3)
    assert got[0].shape == (0, V, 2)
    assert counters["seed_track_nodes"] == 24
    assert counters["seed_track_rounds"] >= 1


@pytest.mark.parametrize("max_pairs", [0, 2])
def test_seed_stage_equals_the_host_path(monkeypatch, max_pairs):
    """`generate_seed_points` on one scene: its tracks are the host
    assembly's (and the JAX package's) of the matches it made, and its
    points those the host tracks triangulate to."""
    scene = TexturedPlaneScene(np.random.default_rng(2), num_views=4,
                               width=200, height=160)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height)
    seen = {}
    real = seed.build_tracks_device

    def record(num_views, xy, pairs, matches, min_views):
        seen.update(V=num_views, xy=xy.numpy(), pairs=pairs.numpy(),
                    matches=matches.numpy(), min_views=min_views)
        return real(num_views, xy, pairs, matches, min_views=min_views)

    monkeypatch.setattr(seed, "build_tracks_device", record)
    cfg = MatchingConfig(max_keypoints_per_view=256,
                         max_pairs_per_view=max_pairs)
    points, obs, mask = seed.generate_seed_points(
        torch.as_tensor(scene.render_all()), cams, cfg)
    args = (seen["V"], seen["xy"], seen["pairs"], seen["matches"],
            seen["min_views"])
    host = tracks.build_tracks(*args)
    want = jax_tracks(*args[:3], seen["matches"].astype(np.int32), 2)
    assert isinstance(obs, np.ndarray) and isinstance(mask, np.ndarray)
    _assert_exact([obs, mask], host[:2], want[:2])
    assert len(points) == len(obs) > 10
    np.testing.assert_array_equal(
        points, tracks.triangulate_tracks(cams.P, host[0], host[1]))
