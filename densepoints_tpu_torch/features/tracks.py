"""Track assembly from pairwise matches + batched triangulation.

`build_tracks_device` assembles the canonical multi-view tracks on the
match table's own device: label propagation (min-hooking and pointer
jumping, Shiloach-Vishkin style) over the matched (view, keypoint) nodes
gives each node its component's smallest node id, then one scatter per
output writes the padded (T, V) observations. It reproduces the host
`build_tracks` (a union-find, in the native runtime when it builds, else
in Python) bit for bit, which stays as its witness; the one-hop assembly
runs on the host. Observations are triangulated in ONE batched masked DLT
on the device. `TRACK_NODES` and `TRACK_ROUNDS` sum the device assembly's
matched nodes and propagation rounds (`counts`, `count_since`).
"""
from __future__ import annotations

import numpy as np
import torch

from densepoints_tpu_torch.geometry.triangulation import triangulate
from densepoints_tpu_torch.native import tracks as native_tracks

__all__ = ["build_tracks", "build_tracks_device", "build_tracks_onehop",
           "triangulate_tracks", "counts", "count_since"]

TRACK_NODES = 0  # matched nodes entering `build_tracks_device`, summed
TRACK_ROUNDS = 0  # its label-propagation rounds, summed


def counts() -> dict:
    """The device assembly's counters, under the names `StageMetrics`
    reports."""
    return {"seed_track_nodes": TRACK_NODES,
            "seed_track_rounds": TRACK_ROUNDS}


def count_since(metrics, before: dict):
    """Set the counts since `before` (a `counts()`) as `metrics`'
    counters."""
    for name, value in counts().items():
        metrics.count(name, value - before[name])


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


def _component_labels(u: torch.Tensor, w: torch.Tensor, n: int):
    """The smallest node of each node's component, over nodes 0..n-1 and
    the edges (u, w): (labels (n,) int64, rounds).

    A label only falls, and only to a node of its own component: each
    round every edge's ends, and the nodes their labels name, take the
    lower of the two ends' labels; then a pointer jump. Once every edge's
    ends agree, a component's label is constant and names one of its
    nodes; its smallest node's label names no smaller one, so the label
    is that node: the union-find's root under "the smaller root wins". A
    round that does not end the loop lowers some label, so the loop ends;
    the test is one element read a round."""
    label = torch.arange(n, device=u.device)
    rounds = 0
    while True:
        rounds += 1
        lu, lw = label[u], label[w]
        low = torch.minimum(lu, lw)
        label.scatter_reduce_(0, torch.cat([u, w, lu, lw]), low.repeat(4),
                              "amin")
        label = label[label]
        if torch.equal(label[u], label[w]):
            return label, rounds


def build_tracks_device(
    num_views: int,
    keypoints: torch.Tensor,
    pair_list,
    matches,
    min_views: int = 2,
):
    """`build_tracks` on the keypoints' device, bit for bit.

    keypoints: (V, N, 2) tensor; pair_list: (P, 2) view pairs; matches:
    (P, N), as `build_tracks` takes them (tensors or arrays; moved to the
    keypoints' device). The nodes some match touches are labelled with
    their component's smallest node id (`_component_labels`); a label's
    first keypoint per view (the smallest) is kept, and a label seen in
    >= min_views views is a track, in label order: the union-find's
    groups in root order. Returns (obs (T, V, 2) f32, mask (T, V) bool,
    kp_index (T, V) int32) on the keypoints' device."""
    global TRACK_NODES, TRACK_ROUNDS
    dev = keypoints.device
    V, N = num_views, keypoints.shape[1]
    pairs = torch.as_tensor(pair_list, device=dev).to(torch.int64)
    pairs = pairs.reshape(-1, 2)  # an empty list may come as (0,)
    matches = torch.as_tensor(matches, device=dev).to(torch.int64)
    p, i = torch.nonzero(matches >= 0, as_tuple=True)
    u = pairs[p, 0] * N + i
    w = pairs[p, 1] * N + matches[p, i]
    if min_views <= 1:  # an unmatched node is a track too
        nodes = torch.arange(V * N, device=dev)
    else:  # only matched nodes can reach min_views: compact them
        nodes, ends = torch.unique(torch.cat([u, w]), return_inverse=True)
        u, w = ends[: len(u)], ends[len(u):]
    label, rounds = (
        _component_labels(u, w, len(nodes)) if len(u)
        else (torch.arange(len(nodes), device=dev), 0)
    )
    TRACK_NODES += len(nodes)
    TRACK_ROUNDS += rounds
    keys, of_node = torch.unique(label * V + nodes // N, return_inverse=True)
    first = torch.full((len(keys),), N, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, of_node, nodes % N, "amin")
    _, of_key, views = torch.unique_consecutive(
        keys // V, return_inverse=True, return_counts=True)
    is_track = views >= min_views
    track = (torch.cumsum(is_track, 0) - 1)[of_key]
    keep = is_track[of_key]
    t, v, kp = track[keep], (keys % V)[keep], first[keep]
    T = int(is_track.sum())
    obs = torch.zeros((T, V, 2), dtype=torch.float32, device=dev)
    mask = torch.zeros((T, V), dtype=torch.bool, device=dev)
    kp_index = torch.full((T, V), -1, dtype=torch.int32, device=dev)
    obs[t, v] = keypoints[v, kp].to(torch.float32)
    mask[t, v] = True
    kp_index[t, v] = kp.to(torch.int32)
    return obs, mask, kp_index


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
    """Batched masked DLT of all tracks on P_all's device: (T, 3) numpy.
    obs and mask already on that device are not copied."""
    if obs.shape[0] == 0:
        return np.zeros((0, 3), np.float32)
    dev = P_all.device
    return triangulate(
        P_all.to(torch.float32),
        torch.as_tensor(obs, dtype=torch.float32, device=dev),
        torch.as_tensor(mask, device=dev),
    ).cpu().numpy()
