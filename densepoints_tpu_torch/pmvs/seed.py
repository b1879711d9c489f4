"""Seed generation: detector -> matcher -> tracks -> triangulation -> patches.

Seed patches take the nearest camera as reference view and the unit ray
from it as normal, then visibility classification; the NCC filter and the
simplex optimization follow in the pipeline. Every numeric stage is a
batched device op, track assembly too (`build_tracks_device`: label propagation
over the match table where the matching left it); only the one-hop
assembly of matcher "epipolar_all" runs on the host.

Profiler spans of `generate_seed_points`: `seed/detect`, `seed/describe`,
`seed/pairs` (the view pairs and their F matrices), `seed/match` (on the
card the Hamming matchers' one launch of M1 for all pairs and one
epipolar filter; else the chunk loop), `seed/tracks` (the matches-per-pair
log, track assembly) and `seed/triangulate` (the DLT, and the points and
tracks to the host).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from densepoints_tpu_torch.config import (
    MatchingConfig,
    OptimizeConfig,
    SeedConfig,
)
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.features.descriptors import (
    brief_pattern,
    compute_descriptors,
)
from densepoints_tpu_torch.features.detector import detect_keypoints
from densepoints_tpu_torch.features.matching import (
    direct_epipolar_pair,
    direct_epipolar_pair_topk,
    filter_matches_epipolar,
    match_pair,
    match_pair_absolute,
)
from densepoints_tpu_torch.features.tracks import (
    build_tracks_device,
    build_tracks_onehop,
    triangulate_tracks,
)
from densepoints_tpu_torch.geometry.fundamental import (
    fundamental_matrices_for_pairs,
)
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.visibility import classify_views
from densepoints_tpu_torch.utils import log

__all__ = [
    "default_pairs",
    "covisibility_pairs",
    "generate_seed_points",
    "create_patches_from_points",
]

_PAIR_CHUNK_BYTES = 2 << 30  # peak per-chunk distance-matrix budget
_HAMMING = ("hamming_knn", "hamming_absolute")


def default_pairs(num_views: int) -> np.ndarray:
    """All unordered view pairs."""
    a, b = np.triu_indices(num_views, k=1)
    return np.stack([a, b], axis=1).astype(np.int32)


def covisibility_pairs(cameras: Cameras, max_pairs_per_view: int) -> np.ndarray:
    """Each view paired with its `max_pairs_per_view` nearest camera
    centres (all pairs when <= 0 or >= V - 1)."""
    C = cameras.C.cpu().numpy().astype(np.float64)
    V = len(C)
    if max_pairs_per_view <= 0 or max_pairs_per_view >= V - 1:
        return default_pairs(V)
    d = np.linalg.norm(C[:, None] - C[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    pairs = set()
    for v in range(V):
        for n in np.argsort(d[v])[:max_pairs_per_view]:
            pairs.add((min(v, int(n)), max(v, int(n))))
    return np.asarray(sorted(pairs), np.int32)


def _pair_chunk(n_keypoints: int) -> int:
    """Pairs per chunk so the (C, N, N) f32 distance block stays under
    the budget (C = 32 at N = 4096)."""
    return max(1, min(32, _PAIR_CHUNK_BYTES // max(4 * n_keypoints**2, 1)))


def _detect(images: torch.Tensor, config: MatchingConfig):
    return detect_keypoints(
        images,
        cell_size=config.keypoint_cell_size,
        max_per_cell=config.max_keypoints_per_cell,
        max_keypoints=config.max_keypoints_per_view,
        k=config.harris_k,
        border=config.descriptor_patch_radius + 1,
        method=config.detector,
        fast_threshold=config.fast_threshold,
    )


def _wants_descriptors(config: MatchingConfig) -> bool:
    return config.matcher in _HAMMING


def _describe(images, xy, config: MatchingConfig):
    pattern = torch.as_tensor(
        brief_pattern(config.descriptor_bits, config.descriptor_patch_radius),
        device=images.device,
    )
    return compute_descriptors(images, xy, pattern)


def _viewsharded_features(mesh, images: torch.Tensor, config: MatchingConfig):
    """Detect (and, for the descriptor matchers, describe) with each rank
    of `mesh` owning a slice of the views.

    The stack is padded with blank views to a multiple of the world size
    and each rank runs the front end on its contiguous slice; one
    `all_gather` of the keypoints and descriptors (small beside the
    images) makes them replicated, so matching and tracks stay those of
    the single-process path. Returns (xy, resp, valid, desc or None,
    [the shape of this rank's slice])."""
    from densepoints_tpu_torch.parallel.mesh import (
        all_gather,
        pad_to_multiple,
        shard_patches,
    )

    V = images.shape[0]
    pad = pad_to_multiple(V, mesh.world_size) - V
    if pad:
        images = torch.cat(
            [images, images.new_zeros((pad,) + tuple(images.shape[1:]))])
    block = shard_patches(mesh, images)
    out = list(_detect(block, config))
    if _wants_descriptors(config):
        out.append(_describe(block, out[0], config))
    out = [all_gather(mesh, t)[:V] for t in out]
    if len(out) == 3:
        out.append(None)
    return (*out, [tuple(block.shape)])


def generate_seed_points(
    images: torch.Tensor,
    cameras: Cameras,
    config: MatchingConfig = MatchingConfig(),
    pairs: np.ndarray | None = None,
    mesh=None,
):
    """Detect, match, track and triangulate -> (S, 3) seed points (host).

    `config.matcher` selects the matching: "hamming_knn" (2-NN + Lowe
    ratio) and "hamming_absolute" (1-NN under an absolute cutoff) match
    BRIEF descriptors and filter along the epipolar line; "epipolar" takes
    the keypoint closest to the line and "epipolar_all" the
    `config.epipolar_topk` closest, consumed by one-hop track assembly.
    With `mesh`, the per-view detection and description split over its
    ranks (`_viewsharded_features`); everything after is unchanged. Given
    a mesh of L > 1 ranks not yet started (`make_mesh` outside a job), the
    call runs as a job of L ranks started for it and returns rank 0's
    result (`parallel/local_job.py`).
    Returns (points, obs, mask); obs/mask are the track observations."""
    if mesh is not None and not mesh.started:
        from densepoints_tpu_torch.parallel import local_job

        return local_job.run("generate_seed_points", mesh, images=images,
                             cameras=cameras, config=config, pairs=pairs)
    matcher = config.matcher
    if matcher not in ("hamming_knn", "hamming_absolute", "epipolar",
                       "epipolar_all"):
        raise ValueError(f"unknown matcher {matcher!r}")
    V = cameras.num_views
    dev = images.device
    desc = None
    # holds a sync: the log's `.tolist()` waits for the detector
    with record_function("seed/detect"):
        if mesh is not None:
            xy, _, valid, desc, _ = _viewsharded_features(mesh, images,
                                                          config)
        else:
            xy, _, valid = _detect(images, config)
        log.info(
            "detected keypoints per view: %s", valid.sum(dim=1).tolist()
        )
    if mesh is None and _wants_descriptors(config):
        with record_function("seed/describe"):
            desc = _describe(images, xy, config)
    if desc is not None:  # +-1 as int8 once: M1's operands
        desc = desc.to(torch.int8)
    # holds a sync: the cameras' `.cpu()` waits for the descriptors
    with record_function("seed/pairs"):
        if pairs is None:
            pairs = covisibility_pairs(cameras, config.max_pairs_per_view)
        F = torch.as_tensor(
            fundamental_matrices_for_pairs(
                cameras.P.cpu().numpy().astype(np.float64), pairs
            ).astype(np.float32),
            device=dev,
        )

    def match_chunk(Fc, a, b):
        if matcher == "hamming_knn":
            m, _ = match_pair(desc, desc, valid, valid, config.lowe_ratio,
                              pairs=(a, b))
        elif matcher == "hamming_absolute":
            m, _ = match_pair_absolute(desc, desc, valid, valid,
                                       config.max_hamming_distance,
                                       pairs=(a, b))
        elif matcher == "epipolar":
            return direct_epipolar_pair(
                Fc, xy[a], xy[b], valid[a], valid[b],
                config.max_epipolar_distance,
            )[0]
        else:
            return direct_epipolar_pair_topk(
                Fc, xy[a], xy[b], valid[a], valid[b],
                config.max_epipolar_distance, config.epipolar_topk,
            )[0]
        return filter_matches_epipolar(
            Fc, xy[a], xy[b], m, config.max_epipolar_distance
        )

    with record_function("seed/match"):
        i1 = torch.as_tensor(pairs[:, 0], dtype=torch.int64, device=dev)
        i2 = torch.as_tensor(pairs[:, 1], dtype=torch.int64, device=dev)
        # M1 keeps the distance matrices out of device memory: one chunk
        chunk = (max(len(pairs), 1) if matcher in _HAMMING
                 and dev.type == "cuda" else _pair_chunk(xy.shape[1]))
        parts = [
            match_chunk(F[lo : lo + chunk], i1[lo : lo + chunk],
                        i2[lo : lo + chunk])
            for lo in range(0, len(pairs), chunk)
        ]
    onehop = matcher == "epipolar_all"
    # holds a sync: the log's `.tolist()` waits for the matching
    with record_function("seed/tracks"):
        if parts:
            matches = torch.cat(parts)
        else:
            tail = (config.epipolar_topk,) if onehop else ()
            matches = torch.full((0, xy.shape[1]) + tail, -1,
                                 dtype=torch.int64, device=dev)
        per_pair = (matches >= 0).flatten(1).sum(dim=1)
        log.info("matches per pair: %s", per_pair.tolist())
        if onehop:
            obs, mask, _ = build_tracks_onehop(
                V, xy.cpu().numpy(), pairs, matches.cpu().numpy(),
                min_views=2)
        else:
            obs, mask, _ = build_tracks_device(
                V, xy, torch.stack([i1, i2], dim=1), matches, min_views=2)
    # holds a sync: the points' `.cpu()` waits for the DLT
    with record_function("seed/triangulate"):
        points = triangulate_tracks(cameras.P, obs, mask)
        if not onehop:
            obs, mask = obs.cpu().numpy(), mask.cpu().numpy()
    log.info("tracks%s: %d -> seed points",
             " (one-hop)" if onehop else "", len(points))
    return points, obs, mask


def create_patches_from_points(
    cameras: Cameras,
    points,
    optimize_config: OptimizeConfig = OptimizeConfig(),
    seed_config: SeedConfig = SeedConfig(),
) -> PatchState:
    """Seed patches from triangulated points, on the cameras' device."""
    points = torch.as_tensor(
        np.asarray(points, np.float32), device=cameras.device
    )[: seed_config.max_seeds]
    d = torch.linalg.norm(points[:, None, :] - cameras.C[None, :, :], dim=-1)
    ref = torch.argmin(d, dim=1)
    rays = points - cameras.C[ref]
    normal = rays / torch.clamp_min(
        torch.linalg.norm(rays, dim=-1, keepdim=True), 1e-12
    )
    vis, cand = classify_views(
        cameras, points, normal, ref,
        optimize_config.visible_angle, optimize_config.candidate_angle,
    )
    return PatchState.create(points, normal, ref, vis, cand)
