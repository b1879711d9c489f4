"""Cluster-partitioned multi-rank densification (per-rank image ownership).

The replicated driver (`parallel/multihost.py`) gives every rank the whole
image stack. For scenes of hundreds of full-resolution views this driver
splits the stack instead:

  * views are clustered by covisibility (`cluster_views`), one cluster per
    RANK; each rank holds ONLY its cluster's images plus the halo, the
    views covisible with a member above `halo_threshold`
    (`cluster_halos`), so a rank's image bytes drop to about |halo| / V of
    the stack;
  * PATCHES belong to the rank that owns their reference view, and every
    view they score against lies in that rank's halo: visibility is
    truncated to the halo (vis &= halo), the covisibility threshold
    bounding photometric support as `MatchingConfig.max_pairs_per_view`
    bounds matching support;
  * every image-touching stage (NCC filter, Nelder-Mead) runs on the rank
    on its halo subset through the single-rank paths: no pixel crosses
    ranks;
  * occupancy grids are REPLICATED and insertion is decided globally:
    each round the ranks exchange their candidates' (cells, alive,
    priority) rows, the only expansion collective, and every rank runs
    the SAME `bulk_try_insert` contest on the priority-sorted global list.
    Canonical priorities (seed index; accepted rank * 4 + direction for
    expansion candidates) make the contest independent of the number of
    ranks.

The contest and the acceptance logic reproduce across rank counts; patch
positions can differ in the last bits where the ranks' batch shapes round
Nelder-Mead's sums differently, so N ranks equal 1 rank at an exact count
and positions within 5e-3.

Two behaviours of the JAX package's driver are kept as they are:
`plan_clusters` clamps a process id past the last cluster to the last
cluster's views (with no member view), and the accepted rank of an
expansion candidate counts within its round, so ranks (and the priorities
made from them) repeat from one round to the next.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from densepoints_tpu_torch.config import PipelineConfig
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.features import matching
from densepoints_tpu_torch.ops import allview_ncc, simplex
from densepoints_tpu_torch.parallel.clusters import (
    cluster_halos,
    cluster_views,
)
from densepoints_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    global_mesh,
    require_started,
)
from densepoints_tpu_torch.pmvs.expand import make_expansion_candidates
from densepoints_tpu_torch.pmvs.filter import run_filters
from densepoints_tpu_torch.pmvs.optimize import (
    filter_by_error,
    optimize_patches,
)
from densepoints_tpu_torch.pmvs.organizer import (
    bulk_try_insert,
    candidate_cells,
    make_grids,
)
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.pipeline import DensifyResult
from densepoints_tpu_torch.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints_tpu_torch.pmvs.visibility import (
    classify_views,
    compute_color,
)
from densepoints_tpu_torch.utils import StageMetrics, log

__all__ = ["densify_clustered", "ClusterPlan", "plan_clusters"]


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The image-ownership layout of one rank.

    assign: (V,) int32 cluster id per view.
    my_views: sorted global view ids this rank HOLDS (members + halo).
    member_mask / halo_mask: (V,) bool.
    """

    assign: np.ndarray
    my_views: np.ndarray
    member_mask: np.ndarray
    halo_mask: np.ndarray

    @property
    def n_held(self) -> int:
        return len(self.my_views)


def plan_clusters(
    cameras: Cameras,
    n_clusters: int,
    pid: int,
    halo_threshold: float = 0.25,
) -> ClusterPlan:
    """The layout of rank `pid`. A `pid` past the last cluster holds the
    last cluster's views and owns no member view (the JAX package's
    clamp)."""
    V = cameras.num_views
    assign = cluster_views(cameras, n_clusters)
    halos = cluster_halos(cameras, assign, halo_threshold)
    my_views = halos[min(pid, len(halos) - 1)]
    member = assign == pid
    halo = np.zeros((V,), bool)
    halo[my_views] = True
    return ClusterPlan(
        assign=assign, my_views=my_views, member_mask=member, halo_mask=halo
    )


def _allgather_concat(mesh: Mesh, arrays: list[torch.Tensor], n_local: int):
    """Gather every rank's rows, concatenated in rank order; returns (list
    of tensors, counts (nproc,) numpy).

    The tensors of one rank share leading dim `n_local`, which may differ
    between ranks: each is padded to the largest, gathered, and unpadded.
    One rank: the identity."""
    if mesh.world_size == 1:
        return list(arrays), np.array([n_local])
    dev = arrays[0].device
    counts = all_gather(
        mesh, torch.tensor([n_local], dtype=torch.int64, device=dev)
    ).cpu().numpy()
    m = int(counts.max())
    out = []
    for a in arrays:
        pad = a.new_zeros((m - a.shape[0],) + tuple(a.shape[1:]))
        stacked = all_gather(mesh, torch.cat([a, pad]))
        out.append(torch.cat(
            [stacked[p * m: p * m + int(counts[p])]
             for p in range(mesh.world_size)]))
    return out, counts


def _gather_state(mesh: Mesh, state: PatchState, prio: np.ndarray):
    """Every rank's PatchState rows, concatenated in canonical priority
    order (independent of the number of ranks). Returns (PatchState,
    prio)."""
    names = [f.name for f in dataclasses.fields(PatchState)]
    leaves = [getattr(state, name) for name in names]
    leaves.append(torch.as_tensor(np.asarray(prio, np.int64),
                                  device=state.position.device))
    gathered, _ = _allgather_concat(mesh, leaves, state.capacity)
    order = torch.argsort(gathered[-1], stable=True)
    g = [a[order] for a in gathered]
    return (PatchState(**dict(zip(names, g[:-1]))),
            g[-1].cpu().numpy())


class _LocalViews:
    """Maps a global-view-space PatchState into the rank's halo-local view
    space (for the image-touching stages) and back."""

    def __init__(self, cameras: Cameras, plan: ClusterPlan):
        dev = cameras.device
        self.ids = torch.as_tensor(plan.my_views, dtype=torch.int64,
                                   device=dev)
        V = cameras.num_views
        inv = np.full((V,), -1, np.int64)
        inv[plan.my_views] = np.arange(len(plan.my_views))
        self.inv = torch.as_tensor(inv, device=dev)
        self.cams = Cameras(**{f.name: getattr(cameras, f.name)[self.ids]
                               for f in dataclasses.fields(Cameras)})
        self.V = V

    def to_local(self, state: PatchState) -> PatchState:
        return dataclasses.replace(
            state,
            ref=self.inv[state.ref],
            vis=state.vis[:, self.ids],
            cand=state.cand[:, self.ids],
        )

    def to_global(self, local: PatchState,
                  template: PatchState) -> PatchState:
        B = local.capacity
        vis = local.vis.new_zeros((B, self.V))
        vis[:, self.ids] = local.vis
        cand = local.cand.new_zeros((B, self.V))
        cand[:, self.ids] = local.cand
        return dataclasses.replace(
            local, ref=template.ref, vis=vis, cand=cand
        )


def _take(state: PatchState, keep: np.ndarray) -> PatchState:
    idx = torch.as_tensor(np.nonzero(keep)[0], device=state.position.device)
    return state.map(lambda a: a[idx])


def densify_clustered(
    scene,
    config: PipelineConfig = PipelineConfig(),
    seed_points: np.ndarray | None = None,
    halo_threshold: float = 0.25,
    image_loader=None,
    n_clusters: int | None = None,
    mesh: Mesh | None = None,
) -> DensifyResult:
    """End-to-end densification with per-rank image ownership.

    Every rank calls this with the same cameras and config; each holds
    only its cluster's images + halo. `image_loader(view_ids) -> (n, H, W)
    float32` lets a caller never build the whole stack; without it the
    subset is sliced from `scene.images`. Returns the SAME full cloud on
    every rank. Without `mesh`, this process's rank (`global_mesh`): one
    cluster per process, as in JAX."""
    if mesh is None:
        mesh = global_mesh()
    require_started(mesh, "densify_clustered")
    pid, nproc, dev = mesh.rank, mesh.world_size, mesh.device
    cameras = scene.cameras.to(dev)
    V = cameras.num_views
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else None
    metrics = StageMetrics(sync=sync)
    nm_before, k1_before = simplex.counts(), allview_ncc.counts()
    match_before = matching.counts()
    plan = plan_clusters(cameras, n_clusters or nproc, pid, halo_threshold)
    lv = _LocalViews(cameras, plan)
    if image_loader is not None:
        images_local = np.asarray(image_loader(plan.my_views))
    else:
        images_local = np.asarray(scene.images)[plan.my_views]
    images_local = torch.as_tensor(images_local, dtype=torch.float32,
                                   device=dev)
    held_bytes = images_local.numel() * images_local.element_size()
    metrics.count("images_held", plan.n_held)
    metrics.count("images_total", V)
    metrics.count("image_bytes_held", held_bytes)
    log.info(
        "clustered densify: rank %d/%d owns %d member views, holds "
        "%d/%d images (%.1f MB)",
        pid, nproc, int(plan.member_mask.sum()), plan.n_held, V,
        held_bytes / 1e6,
    )
    halo = torch.as_tensor(plan.halo_mask, device=dev)

    scale = config.organizer.grid_scale
    grids = make_grids(cameras, scale, config.organizer.max_patches_per_cell)

    # ---- seed stage: partition by reference-view cluster --------------
    with metrics.stage("seed"):
        if seed_points is None:
            # Each rank seeds from ITS halo subset and keeps the points
            # whose reference (nearest camera) it owns.
            pts_l, _, _ = generate_seed_points(images_local, lv.cams,
                                               config.matching)
            seed_points_np = np.asarray(pts_l, np.float32)
        else:
            seed_points_np = np.asarray(seed_points, np.float32)
            if seed_points_np.shape[0] > config.seed.max_seeds:
                seed_points_np = seed_points_np[: config.seed.max_seeds]
        d = np.linalg.norm(
            seed_points_np[:, None, :] - cameras.C.cpu().numpy()[None, :, :],
            axis=-1,
        )
        ref_np = np.argmin(d, axis=1)
        mine = plan.member_mask[ref_np]
        my_points = seed_points_np[mine]
        # Canonical seed priorities: the seed index when seeds are shared
        # input; a rank-offset index for locally generated seeds.
        if seed_points is None:
            my_prio = pid * 10_000_000 + np.nonzero(mine)[0]
        else:
            my_prio = np.nonzero(mine)[0].astype(np.int64)
        state = create_patches_from_points(
            cameras, my_points, config.optimize, config.seed
        )
        # Halo truncation: the clustered visibility semantics.
        state = dataclasses.replace(
            state, vis=state.vis & halo[None, :], cand=state.cand & halo[None, :]
        )

    with metrics.stage("seed_refine"):
        loc = lv.to_local(state)
        if loc.capacity:
            loc = filter_by_error(
                images_local, lv.cams, loc, config.seed.texture_size,
                config.optimize,
            )
        keep = loc.alive.cpu().numpy()
        state = _take(lv.to_global(loc, state), keep)
        my_prio = my_prio[keep]
        loc = lv.to_local(state)
        if state.capacity:
            loc = optimize_patches(
                images_local, lv.cams, loc, config.seed.texture_size,
                config.optimize,
            )
        state = lv.to_global(loc, state)
    log.info("clustered: rank %d refined %d/%d seeds", pid, state.capacity,
             int(mine.sum()))

    expand_opt = config.optimize
    if config.expand.max_iterations > 0:
        expand_opt = dataclasses.replace(
            config.optimize, max_iterations=config.expand.max_iterations
        )

    def global_insert(st: PatchState, prio: np.ndarray, base_total: int):
        """The same insertion on every rank of every rank's candidates.

        Exchanges (cells, alive, prio), the only per-round collective, and
        replays the claim on the priority-sorted list. Returns (my accepted
        mask, my accepted ranks within this round, n accepted in all);
        updates `grids`."""
        nonlocal grids
        cells = candidate_cells(grids, cameras, st.position, st.vis, scale)
        (cells_g, alive_g, prio_g), counts = _allgather_concat(
            mesh,
            [cells, st.alive,
             torch.as_tensor(np.asarray(prio, np.int64), device=dev)],
            st.capacity,
        )
        order = torch.argsort(prio_g, stable=True)
        n_g = len(order)
        if n_g == 0:
            return np.zeros((0,), bool), np.zeros((0,), np.int64), 0
        accepted_sorted, grids = bulk_try_insert(
            grids, cells_g[order], alive_g[order],
            base_total + torch.arange(n_g, device=dev),
            config.organizer.min_grids_to_accept,
        )
        accepted_sorted = accepted_sorted.cpu().numpy()
        order = order.cpu().numpy()
        # Rank of each accepted candidate in the canonical order.
        rank_sorted = np.cumsum(accepted_sorted) - 1
        accepted = np.zeros((n_g,), bool)
        accepted[order] = accepted_sorted
        rank = np.zeros((n_g,), np.int64)
        rank[order] = rank_sorted
        lo = int(np.sum(counts[:pid]))
        return (accepted[lo: lo + st.capacity], rank[lo: lo + st.capacity],
                int(accepted_sorted.sum()))

    with metrics.stage("expand"):
        my_acc, my_rank, total = global_insert(state, my_prio, 0)
        state = _take(state, my_acc)
        rank = my_rank[my_acc]
        log.info(
            "clustered: %d seeds inserted globally (rank %d holds %d)",
            total, pid, state.capacity,
        )
        frontier, f_rank = state, rank
        for round_idx in range(config.expand.max_rounds):
            if total >= config.expand.max_patches:
                break
            expandable = (
                frontier.alive
                & (frontier.num_visible()
                   >= config.expand.min_visible_views_to_expand)
            ).cpu().numpy()
            frontier = _take(frontier, expandable)
            f_rank = f_rank[expandable]
            cand = make_expansion_candidates(cameras, frontier, scale)
            # Canonical candidate priority: accepted rank * 4 + direction
            # (make_expansion_candidates orders [+x | -x | +y | -y] blocks
            # of the local frontier).
            dirs = np.repeat(np.arange(4), len(f_rank))
            cand_prio = np.tile(f_rank, 4) * 4 + dirs
            # Halo truncation is inherited from the parent's vis; refine
            # and filter on this rank against the held images.
            loc = lv.to_local(cand)
            if loc.capacity:
                loc = optimize_patches(
                    images_local, lv.cams, loc, config.expand.texture_size,
                    expand_opt,
                )
            gcand = lv.to_global(loc, cand)
            vis_n, cand_n = classify_views(
                cameras, gcand.position, gcand.normal, gcand.ref,
                config.optimize.visible_angle,
                config.optimize.candidate_angle,
            )
            gcand = dataclasses.replace(
                gcand, vis=vis_n & halo[None, :], cand=cand_n & halo[None, :]
            )
            loc = lv.to_local(gcand)
            if loc.capacity:
                loc = filter_by_error(
                    images_local, lv.cams, loc, config.expand.texture_size,
                    expand_opt,
                )
            gcand = lv.to_global(loc, gcand)
            my_acc, my_rank, n_new = global_insert(gcand, cand_prio, total)
            log.info(
                "clustered round %d: rank %d cand=%d, global accepted=%d",
                round_idx, pid, gcand.capacity, n_new,
            )
            if n_new == 0:
                break
            new_patches = _take(gcand, my_acc)
            state = PatchState.concatenate([state, new_patches])
            rank = np.concatenate([rank, my_rank[my_acc]])
            total += n_new
            frontier, f_rank = new_patches, my_rank[my_acc]
    metrics.count("patches_after_expand", total)

    with metrics.stage("color"):
        # Colours from the held halo views BEFORE the exchange (pixels
        # never cross ranks).
        if scene.colors is not None and state.capacity:
            colors_local = torch.as_tensor(
                np.asarray(scene.colors)[plan.my_views], device=dev)
            state = dataclasses.replace(
                state, color=compute_color(lv.cams, colors_local,
                                           state.position))

    with metrics.stage("filter"):
        # One exchange of the accepted patches (geometry and masks, never
        # pixels), then the same filter stage on every rank.
        full, _ = _gather_state(mesh, state, rank)
        final = run_filters(
            cameras, full, config.filter, config.optimize, scale
        ).compact()
    metrics.count("patches_final", final.capacity)

    simplex.count_since(metrics, nm_before)
    allview_ncc.count_since(metrics, k1_before)
    matching.count_since(metrics, match_before)
    log.info("clustered densify done: %s", metrics.summary())
    return DensifyResult(patches=final, metrics=metrics)
