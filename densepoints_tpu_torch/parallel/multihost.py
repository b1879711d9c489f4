"""Multi-process densification on `torch.distributed` (`densify_multihost`).

One rank per device, every rank running the same program over the same
scene (SPMD):

  * `initialize_multihost` joins the job (`dist.init_process_group` over
    tcp://host:port, with a finite timeout) and picks NCCL or gloo by the
    rule of `parallel/mesh.py`;
  * the patch state is REPLICATED between stages and the per-patch stages
    (the NCC filter, Nelder-Mead, the expansion refine) split it into
    contiguous row blocks, one per rank; one `all_gather` per
    `max_refine_batch` slice makes the result replicated again, and the
    Nelder-Mead exit is one `all_reduce` of a flag per iteration, so every
    rank runs the iterations of the whole batch. A compaction by a
    replicated index vector is then a local gather on every rank: with a
    split state it would be an all-to-all per compaction, which gloo does
    not have;
  * the seed front end is split by view (`pmvs/seed.py
    _viewsharded_features`): each rank detects and describes its slice of
    the views, then one all-gather of keypoints and descriptors;
  * occupancy grids are split by view (`viewsharded_insert`): each rank
    owns a slice of the views' grids, and the >= 2-grids acceptance vote
    is one (P,) int32 `all_reduce(SUM)`.

Determinism: contention is resolved by global candidate ids (scatter-min)
and compactions follow replicated vectors, so the N-rank cloud equals the
1-rank cloud. Images are replicated on every rank: the warp + NCC objective
may touch any view's pixels for any patch in every Nelder-Mead iteration.
`parallel/clustered.py` is the driver that splits the images.

Expansion is `pmvs/expand.py`'s `wavefront`, handed `_ShardedOps`: it opens
the spans and adds to the counters there, so `expand_candidates` and
`expand_accepted` are in the metrics as `densify` reports them.
`rank_threads` is the rank's intra-op thread count, so that a run shows the
threads it ran under.

Without a mesh, `densify_multihost` runs on this process's rank
(`global_mesh`: world size 1 outside a job); `mesh=make_mesh()` outside a
job spans every card, as a job of a rank per card started for the call
(`parallel/local_job.py`).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from densepoints_tpu_torch.config import PipelineConfig
from densepoints_tpu_torch.features import matching
from densepoints_tpu_torch.ops import allview_ncc, simplex
from densepoints_tpu_torch.parallel.distributed import (
    pad_views,
    refine_step_once,
    shard_views,
    viewsharded_insert,
)
from densepoints_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast,
    global_mesh,
    initialize_multihost,
)
from densepoints_tpu_torch.pmvs import expand
from densepoints_tpu_torch.pmvs.expand import make_expansion_candidates
from densepoints_tpu_torch.pmvs.filter import run_filters
from densepoints_tpu_torch.pmvs.optimize import (
    _sliced,
    filter_by_error_once,
    optimize_patches_once,
    zero_pad,
)
from densepoints_tpu_torch.pmvs.organizer import candidate_cells, make_grids
from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.pipeline import DensifyResult
from densepoints_tpu_torch.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints_tpu_torch.pmvs.visibility import compute_color
from densepoints_tpu_torch.utils import StageMetrics, log

__all__ = [
    "initialize_multihost",
    "global_mesh",
    "densify_multihost",
]


class _ShardedOps:
    """The stages of one pyramid level over the mesh, and the wavefront's
    ops there (`pmvs/expand.py`).

    States are replicated and bucket-sized; `refine`, `seed_filter` and
    `seed_optimize` split them over the ranks (`pmvs.optimize._sliced`).
    `compact` pulls the replicated keep vector to the host (timed into
    `overhead`) and gathers its rows into a bucket; `insert` is
    `viewsharded_insert`."""

    def __init__(self, mesh: Mesh, cameras, images, config, spec, Vp,
                 overhead=None):
        self.mesh = mesh
        self.n_dev = mesh.world_size
        self.cams = cameras
        self.images = images
        self.config = config
        self.spec = spec  # the unpadded grid layout (never written)
        self.Vp = Vp
        self.scale = config.organizer.grid_scale
        self.expand_opt = expand.expand_optimize_config(config.expand,
                                                        config.optimize)
        self.overhead = overhead

    def take(self, st: PatchState, idx: np.ndarray, valid: np.ndarray):
        """Rows `idx` of `st`. Lanes that are not `valid` are ZEROED, not
        copies of the gathered row: pad lanes ride in every batch, so they
        must be the same whichever path made the state (a fresh run or a
        resume)."""
        dev = st.position.device
        idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        valid_t = torch.as_tensor(valid, device=dev)
        out = st.map(lambda a: a[idx_t])
        out = out.map(lambda a: torch.where(
            valid_t.reshape((-1,) + (1,) * (a.ndim - 1)), a,
            torch.zeros_like(a)))
        return dataclasses.replace(out, alive=out.alive & valid_t)

    def _run(self, fn, st, texture_size, config):
        return _sliced(fn, self.images, self.cams, st, texture_size, config,
                       self.mesh)

    def seed_filter(self, st, texture_size, config):
        return self._run(filter_by_error_once, st, texture_size, config)

    def seed_optimize(self, st, texture_size, config):
        return self._run(optimize_patches_once, st, texture_size, config)

    def place(self, state: PatchState) -> PatchState:
        """`state` on the mesh's device, padded with zeroed dead lanes to a
        bucket capacity."""
        state = state.map(lambda a: a.to(self.mesh.device))
        return zero_pad(state, simplex.bucket(state.capacity, self.n_dev))

    def compact_to(self, st: PatchState, keep: np.ndarray) -> PatchState:
        """The rows where `keep`, in a bucket of zeroed dead lanes."""
        idx = np.nonzero(keep)[0]
        cap = simplex.bucket(len(idx), self.n_dev)
        valid = np.zeros((cap,), bool)
        valid[: len(idx)] = True
        idx_pad = np.zeros((cap,), np.int64)
        idx_pad[: len(idx)] = idx
        return self.take(st, idx_pad, valid)

    def compact(self, st: PatchState, keep: torch.Tensor):
        keep = self.overhead.pull(st.alive & keep)
        return self.compact_to(st, keep), int(keep.sum())

    def candidates(self, grids_local, frontier: PatchState, n: int):
        return make_expansion_candidates(self.cams, frontier, self.scale), \
            4 * n

    def refine(self, st: PatchState) -> PatchState:
        return self._run(refine_step_once, st,
                         self.config.expand.texture_size, self.expand_opt)

    def cells(self, position, vis):
        """(P, Vp) candidate cells over all views, the padded views -1."""
        cells = candidate_cells(self.spec, self.cams, position, vis,
                                self.scale)
        V = cells.shape[1]
        return torch.nn.functional.pad(cells, (0, self.Vp - V), value=-1)

    def insert(self, grids_local, st: PatchState, first_id: int):
        """(accepted (P,) bool replicated, this rank's new grid slice)."""
        gids = np.arange(first_id, first_id + st.capacity)
        return viewsharded_insert(
            self.mesh, grids_local, self.cells(st.position, st.vis),
            st.alive,
            torch.as_tensor(gids, dtype=torch.int64,
                            device=st.position.device),
            self.config.organizer.min_grids_to_accept,
        )


def _ckpt_stage(ckpt) -> str:
    """Stage name of a checkpoint path ("" if none), from the file name
    (checkpoints are written as `{stage}.npz`)."""
    return "" if ckpt is None else Path(ckpt).stem


class _Overhead:
    """Per-run distribution accounting of the expansion rounds: what the
    host pulls from the device (the small replicated vectors), and what
    the mesh's collectives moved (`MeshTraffic`: the refine all-gathers,
    the win-count all-reduce, and for gloo the device <-> host staging)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.host_bytes = 0
        self.host_sync_s = 0.0
        t = mesh.traffic
        self._start = (t.collective_bytes, t.host_bytes, t.calls, t.seconds)

    def pull(self, tensor):
        """A small replicated vector on the host as numpy, timed."""
        t = time.perf_counter()
        out = tensor.cpu().numpy()
        self.host_sync_s += time.perf_counter() - t
        self.host_bytes += out.nbytes
        return out

    def counters(self) -> dict:
        t = self.mesh.traffic
        now = (t.collective_bytes, t.host_bytes, t.calls, t.seconds)
        d = [b - a for a, b in zip(self._start, now)]
        return {
            "overhead_host_bytes": self.host_bytes + d[1],
            "overhead_host_sync_s": round(self.host_sync_s, 4),
            "overhead_collective_bytes": d[0],
            "overhead_collective_calls": d[2],
            "overhead_collective_s": round(d[3], 4),
        }


def _resume_decision(mesh: Mesh, rt):
    """The checkpoint to resume from, as rank 0 sees it (None: a fresh
    run). Ranks must agree before branching, or their collectives would
    not match: checkpoints are written by rank 0 only, so
    `runtime.checkpoint_dir` must be a filesystem every rank shares."""
    from densepoints_tpu_torch.utils.checkpoint import latest_checkpoint

    ckpt = latest_checkpoint(rt.checkpoint_dir)
    if mesh.world_size == 1:
        return ckpt
    stages = ["", "seeds_optimized", "expanded", "final"]
    stage = _ckpt_stage(ckpt)
    local_code = stages.index(stage) if stage in stages else -1
    code = int(broadcast(
        mesh, torch.tensor([local_code], dtype=torch.int32)).item())
    if code != local_code:
        raise RuntimeError(
            "multihost resume: rank %d sees checkpoint stage %r but rank 0 "
            "decided %r; runtime.checkpoint_dir (%s) must be on a "
            "filesystem shared by every rank"
            % (mesh.rank, stage,
               stages[code] if 0 <= code < len(stages) else code,
               rt.checkpoint_dir)
        )
    return None if code == 0 else ckpt


def densify_multihost(
    scene,
    config: PipelineConfig = PipelineConfig(),
    mesh: Mesh | None = None,
    seed_points: np.ndarray | None = None,
) -> DensifyResult:
    """End-to-end densification over the ranks of `mesh` (default: this
    process's rank, `global_mesh`).

    Every rank calls this with the SAME scene and config and receives the
    SAME result. `seed_points` skips the seed front end (for callers that
    bring their own sparse reconstruction). The seed stage is the
    single-host `densify`'s: create patches -> NCC filter -> compact ->
    optimize. Given a mesh of L > 1 ranks not yet started (`make_mesh`
    outside a job), the call runs as a job of L ranks started for it and
    returns rank 0's result (`parallel/local_job.py`)."""
    if mesh is None:
        mesh = global_mesh()
    if not mesh.started:
        from densepoints_tpu_torch.parallel import local_job

        return local_job.run("densify_multihost", mesh, scene=scene,
                             config=config, seed_points=seed_points)
    dev = mesh.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else None
    metrics = StageMetrics(sync=sync)
    nm_before, k1_before = simplex.counts(), allview_ncc.counts()
    expand_before, match_before = expand.counts(), matching.counts()
    metrics.count("rank_threads", torch.get_num_threads())
    cameras = scene.cameras.to(dev)
    n_dev = mesh.world_size
    rt = config.runtime
    log.info("multihost densify: %d rank(s), backend %s", n_dev,
             mesh.backend)
    # Resume from the newest stage checkpoint: the program is agnostic of
    # the number of ranks, so one checkpoint serves any world size.
    resume_state = resume_stage = None
    if rt.resume and rt.checkpoint_dir:
        from densepoints_tpu_torch.utils.checkpoint import load_checkpoint

        ckpt = _resume_decision(mesh, rt)
        if ckpt is not None:
            resume_state, meta, ckpt_cams = load_checkpoint(ckpt, device=dev)
            resume_stage = meta.get("stage")
            if ckpt_cams is not None:
                cameras = ckpt_cams
            log.info("multihost: resuming from %s (stage %s)", ckpt,
                     resume_stage)

    images = torch.as_tensor(scene.images, dtype=torch.float32, device=dev)

    if resume_stage == "final":
        log.info("multihost: checkpoint already final (%d patches)",
                 resume_state.capacity)
        return DensifyResult(patches=resume_state, metrics=metrics)

    with metrics.stage("seed"):
        if resume_state is not None:
            state_host = resume_state
        else:
            if seed_points is None:
                points, obs, obs_mask = generate_seed_points(
                    images, cameras, config.matching, mesh=mesh,
                )
                if config.ba.enable and len(points) >= 8:
                    from densepoints_tpu_torch.pmvs.pipeline import (
                        _bundle_adjust,
                    )

                    cameras, points, rmse = _bundle_adjust(
                        cameras, points, obs, obs_mask, config.ba, mesh=mesh
                    )
                    metrics.count("ba_rmse_px", rmse)
            else:
                points = seed_points
            state_host = create_patches_from_points(
                cameras, points, config.optimize, config.seed
            )

    scale = config.organizer.grid_scale
    K = config.organizer.max_patches_per_cell

    def level_ops(images_l, cams_l, overhead=None):
        spec = make_grids(cams_l, scale, K)
        gpad = pad_views(spec, n_dev)
        ops_l = _ShardedOps(mesh, cams_l, images_l, config, spec,
                            gpad.cells.shape[0], overhead)
        return ops_l, shard_views(mesh, gpad)

    ops, grids_local = level_ops(images, cameras)

    with metrics.stage("seed_refine"):
        state = ops.place(state_host)
        if resume_stage != "seeds_optimized":
            # Single-host seed semantics: NCC filter -> compact -> optimize.
            state = ops.seed_filter(state, config.seed.texture_size,
                                    config.optimize)
        alive = state.alive.cpu().numpy()
        state = ops.compact_to(state, alive)
        n_seeds = int(alive.sum())
        if resume_stage != "seeds_optimized" and n_seeds:
            state = ops.seed_optimize(state, config.seed.texture_size,
                                      config.optimize)
    metrics.count("seeds_after_refine", n_seeds)
    log.info("multihost: %d seeds after refine", n_seeds)
    if rt.checkpoint_dir and mesh.rank == 0:
        from densepoints_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(
            Path(rt.checkpoint_dir) / "seeds_optimized.npz",
            state, stage="seeds_optimized",
            cameras=cameras,
        )

    # the expansion's distribution overhead, from here on
    overhead = ops.overhead = _Overhead(mesh)

    def carried_over(ops_l, state_host):
        """Patches of a coarser level refined against this level's
        textures (optimize -> filter -> compact)."""
        state = ops_l.place(state_host)
        state = ops_l.seed_optimize(state, config.seed.texture_size,
                                    config.optimize)
        state = ops_l.seed_filter(state, config.seed.texture_size,
                                  config.optimize)
        return ops_l.compact_to(state, state.alive.cpu().numpy())

    # Coarse-to-fine levels, the single-host densify_multiscale's
    # semantics: seed insertion and rounds at the coarsest level, then at
    # each finer level the carried-over patches are refined against its
    # textures and expanded further. levels == 1 is the plain flow.
    levels = max(1, config.multiscale.levels)
    with metrics.stage("expand"):
        if levels > 1:
            from densepoints_tpu_torch.multiscale import build_pyramid

            pyramid = build_pyramid(images, cameras, levels)
            state_host = state
            for li, lvl in enumerate(range(levels - 1, 0, -1)):
                images_l, cams_l = pyramid[lvl]
                ops_l, grids_l = level_ops(images_l, cams_l, overhead)
                state = (carried_over(ops_l, state_host) if li > 0
                         else ops_l.place(state_host))
                log.info("multihost multiscale level %d: %dx%d", lvl,
                         int(cams_l.width[0]), int(cams_l.height[0]))
                full_l, _, _ = expand.wavefront(ops_l, state, grids_l,
                                                config.expand)
                # Per-level filtering, as on a single host.
                state_host = run_filters(
                    cams_l, full_l, config.filter, config.optimize, scale,
                ).compact()
            state = carried_over(ops, state_host)
        full, _, total = expand.wavefront(ops, state, grids_local,
                                          config.expand)
    metrics.count("patches_after_expand", total)
    for name, value in overhead.counters().items():
        metrics.count(name, value)

    with metrics.stage("filter"):
        final = run_filters(
            cameras, full, config.filter, config.optimize, scale,
        ).compact()
    metrics.count("patches_final", final.capacity)

    with metrics.stage("color"):
        if scene.colors is not None and final.capacity:
            colors = torch.as_tensor(scene.colors, device=dev)
            final = dataclasses.replace(
                final, color=compute_color(cameras, colors, final.position))

    if rt.checkpoint_dir and mesh.rank == 0:
        from densepoints_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(Path(rt.checkpoint_dir) / "final.npz", final,
                        stage="final", cameras=cameras)
    if rt.debug_dir and mesh.rank == 0:
        from densepoints_tpu_torch.utils import debug

        debug.dump_cloud(rt.debug_dir, "final", final)

    simplex.count_since(metrics, nm_before)
    allview_ncc.count_since(metrics, k1_before)
    expand.count_since(metrics, expand_before)
    matching.count_since(metrics, match_before)
    log.info("multihost densify done: %s", metrics.summary())
    return DensifyResult(patches=final, metrics=metrics)
