"""Track assembly from pairwise matches + batched triangulation.

A union-find over (view, keypoint) nodes on the host (cheap integer work,
in the native runtime when it builds, else in Python) produces canonical
multi-view tracks exactly once; observations are padded to (T, V) masked
arrays and triangulated in ONE batched masked DLT on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from densepoints_tpu_torch.geometry.triangulation import triangulate
from densepoints_tpu_torch.native import tracks as native_tracks

__all__ = ["build_tracks", "build_tracks_onehop", "triangulate_tracks"]


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, i):
        root = i
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # Deterministic: the smaller root wins.
            if rb < ra:
                ra, rb = rb, ra
            self.parent[rb] = ra


def build_tracks(
    num_views: int,
    keypoints: np.ndarray,
    pair_list: np.ndarray,
    matches: np.ndarray,
    min_views: int = 2,
):
    """Union-find track building.

    keypoints: (V, N, 2); pair_list: (P, 2) view pairs; matches: (P, N),
    matches[p, i] = keypoint of pair_list[p][1] matched to keypoint i of
    pair_list[p][0], or -1. Returns (obs (T, V, 2) f32, mask (T, V) bool,
    kp_index (T, V) int32), one row per track seen in >= min_views views.
    """
    keypoints = np.asarray(keypoints)
    matches = np.asarray(matches)
    N = keypoints.shape[1]
    if native_tracks.available():
        roots = native_tracks.roots(
            native_tracks.union_matches(num_views, N, pair_list, matches)
        )
    else:
        uf = _UnionFind(num_views * N)
        for p, (a, b) in enumerate(pair_list):
            m = matches[p]
            for i in np.nonzero(m >= 0)[0]:
                uf.union(int(a) * N + int(i), int(b) * N + int(m[i]))
        roots = np.array([uf.find(i) for i in range(num_views * N)])
    order = np.argsort(roots, kind="stable")
    sorted_roots = roots[order]
    boundaries = np.nonzero(
        np.diff(sorted_roots, prepend=sorted_roots[0] - 1)
    )[0]
    obs_rows, mask_rows, idx_rows = [], [], []
    for gi in range(len(boundaries)):
        start = boundaries[gi]
        end = boundaries[gi + 1] if gi + 1 < len(boundaries) else len(order)
        nodes = order[start:end]
        if len(nodes) < min_views:
            continue
        # Keep the first keypoint per view (deterministic by node order).
        seen = {}
        for v, kp in zip(nodes // N, nodes % N):
            seen.setdefault(v, kp)
        if len(seen) < min_views:
            continue
        obs = np.zeros((num_views, 2), np.float32)
        mask = np.zeros((num_views,), bool)
        kpi = np.full((num_views,), -1, np.int32)
        for v, kp in seen.items():
            obs[v] = keypoints[v, kp]
            mask[v] = True
            kpi[v] = kp
        obs_rows.append(obs)
        mask_rows.append(mask)
        idx_rows.append(kpi)
    if not obs_rows:
        return (
            np.zeros((0, num_views, 2), np.float32),
            np.zeros((0, num_views), bool),
            np.zeros((0, num_views), np.int32),
        )
    return np.stack(obs_rows), np.stack(mask_rows), np.stack(idx_rows)


def build_tracks_onehop(
    num_views: int,
    keypoints: np.ndarray,
    pair_list: np.ndarray,
    matches_topk: np.ndarray,
    min_views: int = 2,
):
    """One-hop track assembly: each keypoint with its direct partners across
    every pair it is the left keypoint of, with no transitive merging. With
    all-pairs epipolar matching this yields one (possibly noisy) track per
    matched keypoint.

    matches_topk: (P, N, K), partner keypoint indices in pair_list[p][1]
    for each keypoint of pair_list[p][0], -1 empty. Returns (obs (T, V, 2)
    f32, mask (T, V) bool, kp_index (T, V) int32)."""
    keypoints = np.asarray(keypoints)
    matches_topk = np.asarray(matches_topk)
    V = num_views
    partners: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for p, (a, b) in enumerate(pair_list):
        m = matches_topk[p]  # (N, K)
        for i, kk in zip(*np.nonzero(m >= 0)):
            partners.setdefault((int(a), int(i)), []).append(
                (int(b), int(m[i, kk]))
            )
    obs_rows, mask_rows, idx_rows = [], [], []
    for (a, i), plist in partners.items():
        obs = np.zeros((V, 2), np.float32)
        mask = np.zeros((V,), bool)
        kpi = np.full((V,), -1, np.int32)
        obs[a], mask[a], kpi[a] = keypoints[a, i], True, i
        for b, j in plist:
            if not mask[b]:  # the first partner in a view wins
                obs[b], mask[b], kpi[b] = keypoints[b, j], True, j
        if mask.sum() >= min_views:
            obs_rows.append(obs)
            mask_rows.append(mask)
            idx_rows.append(kpi)
    if not obs_rows:
        return (
            np.zeros((0, V, 2), np.float32),
            np.zeros((0, V), bool),
            np.zeros((0, V), np.int32),
        )
    return np.stack(obs_rows), np.stack(mask_rows), np.stack(idx_rows)


def triangulate_tracks(P_all: torch.Tensor, obs, mask) -> np.ndarray:
    """Batched masked DLT of all tracks on P_all's device: (T, 3) numpy."""
    if obs.shape[0] == 0:
        return np.zeros((0, 3), np.float32)
    dev = P_all.device
    return triangulate(
        P_all.to(torch.float32),
        torch.as_tensor(obs, dtype=torch.float32, device=dev),
        torch.as_tensor(mask, device=dev),
    ).cpu().numpy()
