"""Covisibility view clustering: the image-partitioning axis.

The replicated multi-rank driver (`parallel/multihost.py`) gives every rank
the whole image stack; for scenes of hundreds of full-resolution views the
image stack is what should be split (`parallel/clustered.py`). This module
is the partitioning:

  * `covisibility_matrix`: pairwise view affinity from camera geometry;
  * `cluster_views`: balanced k-way clustering of views by affinity
    (greedy seeded growth; deterministic);
  * `cluster_halos`: the views each cluster's owner must HOLD: its own
    views plus every view covisible with one of them above a threshold,
    so patches referenced in a cluster score without fetching pixels from
    another rank.

Host numpy (float64) on the port's `Cameras`, the same arithmetic as the
JAX package's `parallel/clusters.py`.
"""
from __future__ import annotations

import numpy as np

from densepoints_tpu_torch.core.cameras import Cameras

__all__ = ["covisibility_matrix", "cluster_views", "cluster_halos"]


def covisibility_matrix(cameras: Cameras) -> np.ndarray:
    """(V, V) affinity in [0, 1] from camera geometry.

    Affinity = viewing-direction alignment (cos of the optical-axis
    angle, clamped at 0) scaled by center proximity relative to the
    median baseline — cheap, scene-independent, and monotone with the
    epipolar matching yield the pair pruner sees.
    """
    C = cameras.C.cpu().numpy().astype(np.float64)  # (V, 3)
    # Optical axes: third row of the rotation (E[:, 2, :3]).
    z = cameras.E.cpu().numpy().astype(np.float64)[:, 2, :3]
    z /= np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1e-12)
    cosang = np.clip(z @ z.T, 0.0, 1.0)
    d = np.linalg.norm(C[:, None, :] - C[None, :, :], axis=-1)
    v = d.shape[0]
    off = d[~np.eye(v, dtype=bool)]
    scale = np.median(off) if off.size else 1.0
    prox = 1.0 / (1.0 + d / max(scale, 1e-12))
    aff = cosang * prox
    np.fill_diagonal(aff, 1.0)
    return aff


def cluster_views(cameras: Cameras, n_clusters: int) -> np.ndarray:
    """(V,) int32 balanced cluster assignment by covisibility.

    Deterministic greedy growth: the `n_clusters` seeds are the mutually
    most-distant cameras (farthest-point traversal from view 0); each
    remaining view joins, in affinity order, the unfilled cluster whose
    CURRENT members it is most covisible with. Cluster sizes differ by
    at most one.
    """
    V = cameras.num_views
    n_clusters = max(1, min(n_clusters, V))
    aff = covisibility_matrix(cameras)
    C = cameras.C.cpu().numpy().astype(np.float64)

    # Farthest-point seeds (deterministic).
    seeds = [0]
    for _ in range(n_clusters - 1):
        d = np.min(
            np.linalg.norm(C[:, None, :] - C[seeds][None, :, :], axis=-1),
            axis=1,
        )
        d[seeds] = -1.0
        seeds.append(int(np.argmax(d)))

    cap = -(-V // n_clusters)  # ceil: max members per cluster
    assign = np.full((V,), -1, np.int32)
    sizes = np.zeros((n_clusters,), np.int32)
    for c, s in enumerate(seeds):
        assign[s] = c
        sizes[c] += 1

    # Greedy: repeatedly take the (view, cluster) pair with the highest
    # mean affinity to the cluster's current members, respecting caps.
    # Incremental per-cluster affinity sums keep each placement O(V * k)
    # (vectorized) instead of recomputing member means — O(V^2 * k) total,
    # required at the module's target of hundreds of views.
    affsum = np.zeros((V, n_clusters), np.float64)  # sum of aff[v, members]
    for c, s in enumerate(seeds):
        affsum[:, c] += aff[:, s]
    unassigned = assign < 0
    while unassigned.any():
        score = affsum / np.maximum(sizes[None, :], 1)
        # Tie-break (score, -c, -v): prefer the LOWER cluster id, then the
        # LOWER view id — matches the previous implementation exactly.
        score[~unassigned, :] = -np.inf
        score[:, sizes >= cap] = -np.inf
        flat = np.argmax(score.T.ravel())  # first max = lowest (c, v)
        c, v = divmod(int(flat), V)
        assign[v] = c
        sizes[c] += 1
        unassigned[v] = False
        affsum[:, c] += aff[:, v]
    return assign


def cluster_halos(
    cameras: Cameras,
    assign: np.ndarray,
    threshold: float = 0.25,
) -> list[np.ndarray]:
    """Per-cluster sorted view ids the owner must hold (members + halo).

    The halo is every non-member view whose covisibility with ANY member
    exceeds `threshold` — the views a member-referenced patch can
    plausibly score against.
    """
    aff = covisibility_matrix(cameras)
    out = []
    n_clusters = int(assign.max()) + 1
    for c in range(n_clusters):
        members = np.nonzero(assign == c)[0]
        halo = np.nonzero(np.max(aff[members], axis=0) > threshold)[0]
        out.append(np.unique(np.concatenate([members, halo])))
    return out
