"""Typed configuration tree for the whole pipeline.

The reference scatters options across five partially-dead structs with three
conflicting meanings of "cell_size" (SURVEY.md §5.6): `MatcherOptions`
(matcher.h:14-33, keypoint grid 16 / NCC texture 16 via Seed), `SeedOptions`
(seed.h:12-16), dead `PMVS::Options` (options.h:8-21), `ExpandOptions`
(expand.h:10-14, NCC texture 11) and `PatchOrganizerOptions`
(patch_organizer.h:40-47, occupancy cell 8). Here: one dataclass tree,
JSON-loadable through the CLI `--settings` flag the reference declared but
never wired up (main.cpp:17), with each knob named for what it actually does.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

__all__ = [
    "MatchingConfig",
    "SeedConfig",
    "OptimizeConfig",
    "ExpandConfig",
    "OrganizerConfig",
    "FilterConfig",
    "MultiscaleConfig",
    "BAConfig",
    "SurfaceConfig",
    "ParallelConfig",
    "PipelineConfig",
    "PROFILES",
    "load_config",
]


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Seed matching front-end (reference MatcherOptions, matcher.h:14-33)."""

    detector: str = "harris"  # harris | fast  (reference: ORB | AKAZE)
    matcher: str = "hamming_knn"  # hamming_knn | hamming_absolute |
    #     epipolar (best partner per keypoint) | epipolar_all
    #     (reference all-pairs semantics, matcher.cpp:267-317)
    max_keypoints_per_view: int = 4096
    keypoint_cell_size: int = 16  # grid filter cell (matcher.h cell_size)
    max_keypoints_per_cell: int = 4
    lowe_ratio: float = 0.7  # kNN ratio test (matcher.cpp:218)
    max_hamming_distance: float = 30.0  # FLANN-path cutoff (matcher.cpp:234)
    epipolar_topk: int = 4  # partner cap per keypoint (epipolar_all)
    max_epipolar_distance: float = 1.5  # px (matcher.h:24)
    harris_k: float = 0.04
    fast_threshold: float = 10.0  # FAST-9/16 segment-test margin
    detector_blur_sigma: float = 1.0
    descriptor_bits: int = 256
    descriptor_patch_radius: int = 15
    max_pairs_per_view: int = 0  # 0 = all C(V,2) pairs (reference behavior);
    # > 0 prunes to each view's N nearest cameras (large scenes)


@dataclasses.dataclass(frozen=True)
class SeedConfig:
    """Seed patch creation (reference Seed, seed.cpp:26-144)."""

    texture_size: int = 16  # NCC texture k (the Seed stage inherits the
    # matcher cell_size=16 in the reference, seed.cpp:117,135)
    max_seeds: int = 65536


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    """Photometric (depth, roll, pitch) refinement (optimization*.cpp)."""

    score_threshold: float = 0.6  # NCC accept (optimization.h:16)
    min_visible_views: int = 3  # patch survives with >= this (optimization.h:17)
    max_iterations: int = 500  # DownhillSolver term (optimization_opencv.cpp:64)
    tolerance: float = 1e-4
    init_step_depth: float = 0.02  # initial simplex steps
    init_step_angle: float = 0.2  # (optimization_opencv.cpp:59)
    max_score_views: int = 16  # visible views are compacted to this many
    # slots for texture scoring; work scales with M, not scene size V
    max_refine_batch: int = 8192  # optimize/filter process at most this
    # many patches per device dispatch (the NM init evaluates 4 simplex
    # points per patch, so coordinate tensors scale with 4*B*M*k^2 —
    # unsliced 16k-patch batches exceed HBM at DTU view counts)
    sampling_impl: str = "auto"  # auto == paged (the single production
    # scoring path since round 5; "fused"/"xla" retired, VERDICT r4 #9).
    # auto == paged (the round-4 default): the view-sorted page-resident
    # kernel — ONE all-views pass per evaluation, anchor texture computed
    # once, work scales with sum(vis); XLA equivalent off-TPU. Measured
    # 1.5x the chunked fused kernel at scan shapes and ~2x accepted patch
    # density at better exact accuracy (21-view A/B).
    # fused/xla: the round-3 anchor-pinned chunked scoring (fused = the
    # Pallas DMA/resident warp+NCC kernel on TPU, xla = gather path).
    visible_angle: float = 0.78  # rad, truly-visible cone (patch.h:56)
    candidate_angle: float = 1.04  # rad, potentially-visible cone (patch.h:57)
    depth_sweep_steps: int = 0  # > 1 enables a depth-sweep re-init before
    # Nelder-Mead: the objective is evaluated at this many relative depths
    # spread over +-depth_sweep_span along the reference ray and the best
    # becomes the NM starting point. Kills the "sunk depth" local minima
    # that dominate gross outliers at scan scale (FILTER_SWEEP_r03: 79%
    # of > 5 mm errors were along-ray sinks) at the source instead of
    # post-hoc filtering. 0 = reference behavior (start at 0).
    depth_sweep_span: float = 0.04  # relative depth half-range of the sweep


@dataclasses.dataclass(frozen=True)
class ExpandConfig:
    """Wavefront patch expansion (reference Expand, expand.cpp:34-143)."""

    texture_size: int = 11  # NCC texture during expansion (expand.h:12)
    max_rounds: int = 12  # bulk-synchronous wavefront iterations
    max_patches: int = 1_000_000  # global capacity (reference hard cap 1e7)
    min_visible_views_to_expand: int = 2  # expand.cpp:70
    max_iterations: int = 0  # Nelder-Mead cap for EXPANSION candidates;
    # 0 = inherit optimize.max_iterations. Candidates start one grid cell
    # from a converged parent, so a reduced budget (e.g. 40) converges in
    # practice — the reference's termination criteria (eps 1e-4 OR cap,
    # optimization_opencv.cpp:55-64) are unchanged, only the cap differs
    prescreen: str = "off"  # off | free | claim. Candidates whose
    # projected cells cannot yield >= min_grids_to_accept occupancy wins
    # are dropped BEFORE Nelder-Mead (organizer.prescreen_candidates).
    # Default OFF per the round-5 A/B (PRESCREEN_r05.json): dropping
    # candidates pre-NM does NOT shrink the NM bucket shape (dead lanes
    # are already ~free in the paged kernel), so the screen only loses
    # the candidates that NM would have moved into acceptable cells —
    # off 50.7 / free 43.7 / claim 37.2 patches/s e2e at the bench
    # scene. Kept as a knob for occupancy-saturated regimes.


@dataclasses.dataclass(frozen=True)
class OrganizerConfig:
    """Per-view occupancy grids (patch_organizer.h:40-47)."""

    grid_scale: int = 8  # px per occupancy cell
    max_patches_per_cell: int = 1
    min_grids_to_accept: int = 2  # landed in >= 2 view grids (organizer.cpp:58)


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """PMVS visibility/consistency filtering.

    The reference declares `PMVS::FilterPatches` (pmvs.h:27) but never
    implements it; these are the standard PMVS filter knobs built here.
    """

    enable: bool = True
    depth_consistency: float = 0.01  # relative depth agreement for support
    min_support_cells: int = 1  # neighbor cells that must agree
    occlusion_slack: float = 0.05  # relative depth slack before a patch
    # counts as occluding another
    min_final_visible_views: int = 0  # 0 = reference semantics (>= 3 via
    # the NCC filter). The dense-regime accuracy-tail knob (VERDICT r4
    # #6): the >2 mm population of dense reconstructions is low-view
    # fringe-normal rim patches (DTU_r05_dense tail forensics: 5.4
    # visible views vs 21.2 for inliers); a floor of 8 cut the dense
    # run's exact mean 1.086 -> 0.349 mm while keeping 81% of patches
    # and 99.97% completeness < 2 mm.


@dataclasses.dataclass(frozen=True)
class MultiscaleConfig:
    levels: int = 1  # 1 = no pyramid (reference's dead Options::scale_)
    scale_factor: int = 2


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment (north-star addition; absent in reference)."""

    enable: bool = False
    max_outer_iterations: int = 10
    cg_iterations: int = 50
    damping: float = 1e-4
    robust_delta: float = 2.0  # Huber threshold in px


@dataclasses.dataclass(frozen=True)
class SurfaceConfig:
    """Surface extraction (reference modules/surface is an empty dir)."""

    enable: bool = False
    voxel_resolution: int = 128
    truncation_voxels: float = 3.0
    min_weight: float = 0.0  # voxels with accumulated splat weight below
    # this are treated as unobserved — a density filter that stops
    # isolated floaters from meshing into blobs (DTU-scale clouds: ~2-4;
    # 0 keeps every touched voxel, right for sparse/toy clouds)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh distribution (no analog in the single-process reference)."""

    data_axis: str = "patches"
    num_devices: int = 0  # 0 = all available


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Observability + persistence around the pipeline (SURVEY.md §5).

    The reference's analogs: compile-time DEBUG_PMVS_* artifact dumps
    (CMakeLists.txt:11-14) and nothing at all for checkpoints/profiling.
    """

    checkpoint_dir: str = ""  # stage-boundary PatchState snapshots
    resume: bool = False  # resume from the latest checkpoint in the dir
    debug_dir: str = ""  # stage artifact dumps (clouds, occupancy)
    profile_dir: str = ""  # torch.profiler trace output


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    matching: MatchingConfig = dataclasses.field(default_factory=MatchingConfig)
    seed: SeedConfig = dataclasses.field(default_factory=SeedConfig)
    optimize: OptimizeConfig = dataclasses.field(default_factory=OptimizeConfig)
    expand: ExpandConfig = dataclasses.field(default_factory=ExpandConfig)
    organizer: OrganizerConfig = dataclasses.field(default_factory=OrganizerConfig)
    filter: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    multiscale: MultiscaleConfig = dataclasses.field(default_factory=MultiscaleConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    surface: SurfaceConfig = dataclasses.field(default_factory=SurfaceConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def _from_dict(cls, data: dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"Unknown config key {key!r} for {cls.__name__}")
        ftype = fields[key].type
        if isinstance(value, dict):
            sub_cls = _SECTION_TYPES.get(key)
            if sub_cls is None:
                raise KeyError(f"Unknown config section {key!r}")
            kwargs[key] = _from_dict(sub_cls, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_SECTION_TYPES = {
    "matching": MatchingConfig,
    "seed": SeedConfig,
    "optimize": OptimizeConfig,
    "expand": ExpandConfig,
    "organizer": OrganizerConfig,
    "filter": FilterConfig,
    "multiscale": MultiscaleConfig,
    "ba": BAConfig,
    "surface": SurfaceConfig,
    "parallel": ParallelConfig,
    "runtime": RuntimeConfig,
}


# Named profiles: data-backed presets applied UNDER explicit settings
# (a config {"profile": "scan", ...overrides} starts from the profile and
# the overrides win). "scan" is the DTU-scale preset picked with the
# FILTER_SWEEP_r03 sweep plus the round-4 sunk-depth re-init: exact
# accuracy mean ~halves vs the toy-safe library defaults at a ~1%
# completeness cost (VERDICT r3 weak #5 — the preset used to live only in
# scripts/dtu_scale_run.py).
PROFILES: dict[str, dict] = {
    "default": {},
    "scan": {
        "optimize": {
            "max_score_views": 25,
            "depth_sweep_steps": 9,
        },
        "filter": {
            "min_support_cells": 4,
            "depth_consistency": 0.005,
            "occlusion_slack": 0.02,
        },
        "matching": {"max_pairs_per_view": 10},
    },
}


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path_or_dict) -> PipelineConfig:
    """Load a PipelineConfig from a JSON file path or a plain dict.

    A "profile" key selects a named preset from PROFILES; the remaining
    keys override it.
    """
    if isinstance(path_or_dict, dict):
        data = dict(path_or_dict)
    else:
        with open(path_or_dict) as f:
            data = json.load(f)
    profile = data.pop("profile", None)
    if profile is not None:
        if profile not in PROFILES:
            raise KeyError(
                f"unknown config profile {profile!r} "
                f"(available: {sorted(PROFILES)})"
            )
        data = _deep_merge(PROFILES[profile], data)
    return _from_dict(PipelineConfig, data)
