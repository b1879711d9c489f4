"""Track assembly on a card (`cuda`): `build_tracks_device` on DTU- and
temple-sized match tables equals the host union-find's `build_tracks`
bit for bit, with its counters; the CPU cases, against the JAX package
too, are `test_torch_tracks_device.py`."""
import numpy as np
import pytest
import torch

from densepoints_tpu_torch.features import tracks
from densepoints_tpu_torch.utils import StageMetrics
from tests.torch_port_util import cuda_device  # noqa: F401


def _matched_nodes(pairs, matches):
    N = matches.shape[1]
    p, i = np.nonzero(matches >= 0)
    ends = np.concatenate([pairs[p, 0] * N + i,
                           pairs[p, 1] * N + matches[p, i]])
    return len(np.unique(ends))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(49, 8192, 490), (312, 4096, 1560)])
def test_on_card_equals_the_host_assembly(cuda_device, size):  # noqa: F811
    """DTU- and temple-sized tables on the card: the host union-find's
    tracks, bit for bit."""
    V, N, P = size
    rng = np.random.default_rng(V)
    a = rng.integers(0, V, P)
    b = (a + rng.integers(1, V, P)) % V
    pairs = np.sort(np.stack([a, b], axis=1), axis=1).astype(np.int32)
    matches = np.where(rng.uniform(size=(P, N)) < 0.04,
                       rng.integers(0, N, (P, N)), -1).astype(np.int64)
    kp = rng.uniform(0, 1600, (V, N, 2)).astype(np.float32)
    before = tracks.counts()
    got = tracks.build_tracks_device(
        V, torch.as_tensor(kp, device=cuda_device), pairs,
        torch.as_tensor(matches, device=cuda_device))
    assert all(t.device.type == "cuda" for t in got)
    metrics = StageMetrics()
    tracks.count_since(metrics, before)
    counters = metrics.counters
    for g, w in zip(got, tracks.build_tracks(V, kp, pairs, matches, 2)):
        g = g.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 1000
    assert counters["seed_track_nodes"] == _matched_nodes(pairs, matches)
    assert counters["seed_track_rounds"] >= 1
