"""Phase-level profile of ONE expansion round of the port.

    python -m densepoints_tpu_torch.scripts.expand_profile [--out FILE]
        [--device cuda] [--config JSON]

Stands for `scripts/expand_profile.py` of the JAX package, with its scene,
seeds and config: the bench e2e sphere (12 views of 512 x 384, focal 450,
radius 150 at 500, 2048 texture, `default_rng(0)`), 3000 seeds uniform on
the sphere (`default_rng(7)`), the `scan` profile with 4 rounds of 40
Nelder-Mead iterations, 120 seed iterations and grid_scale 4. The seeds are
refined (NCC filter, compaction, Nelder-Mead) and bulk-inserted into fresh
occupancy grids; the accepted ones are the frontier. Then one round of
`pmvs.expand.expand_patches` runs phase by phase, twice (cold, then warm),
each phase between two device synchronisations on the host's clock:
`make_candidates`, `candidate_cells`, `prescreen` (mode `free`),
`compact`, `optimize_nm`, `classify_views`, `filter_by_error`,
`candidate_cells2` and `bulk_try_insert`. Beside each phase's seconds the
record gives the rows it handled and its K1 launches, and the round's
counts: frontier, candidates, kept, optimised alive, filtered alive and
accepted.

Departures from the JAX program:
  * `pad_bucket` and `pad_bucket2` are shape buckets against XLA
    recompiles; eager torch has none (ROADMAP A.12). They stand under
    `absent` with that reason.
  * `--out` has no default and nothing is written without it: the JAX
    program wrote EXPAND_PROFILE_r05.json into the repo's root.
  * `--device` (default cuda) picks the device; `cpu` runs the plain
    scoring paths. The record names the card and its power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from densepoints_tpu_torch.scripts import _rigs, _scene_runs, _timing

PRESCREEN = "free"  # the JAX program's mode
ABSENT = {
    name: "a shape bucket against XLA recompiles (expand._pad_bucket); "
          "eager torch has none (ROADMAP A.12)"
    for name in ("pad_bucket", "pad_bucket2")
}


# The JAX program's scene and config; `--config` overrides them.
CONFIG = {"seeds": 3000, "views": _rigs.SPHERE["num_views"],
          "width": _rigs.SPHERE["width"], "height": _rigs.SPHERE["height"],
          "focal": _rigs.SPHERE["focal"],
          "tex_size": _rigs.SPHERE["tex_size"], "nm_iters": 120,
          "expand_nm_iters": 40}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    _scene_runs.config_option(p, CONFIG)
    return p.parse_args(argv)


def config(c):
    from densepoints_tpu_torch.config import load_config

    return load_config({
        **_rigs.SPHERE_CONFIG,
        "expand": {"max_rounds": 4, "max_iterations": c["expand_nm_iters"]},
        "optimize": {"max_iterations": c["nm_iters"]},
    })


def seed_frontier(images, cams, seeds, cfg):
    """The seeds refined (NCC filter, compaction, Nelder-Mead) and
    bulk-inserted into fresh grids: (frontier, grids)."""
    from densepoints_tpu_torch.pmvs.optimize import (
        filter_by_error,
        optimize_patches,
    )
    from densepoints_tpu_torch.pmvs.organizer import (
        bulk_try_insert,
        candidate_cells,
        make_grids,
    )
    from densepoints_tpu_torch.pmvs.seed import create_patches_from_points

    org = cfg.organizer
    st = create_patches_from_points(cams, seeds, cfg.optimize, cfg.seed)
    st = filter_by_error(images, cams, st, cfg.seed.texture_size,
                         cfg.optimize).compact()
    st = optimize_patches(images, cams, st, cfg.seed.texture_size,
                          cfg.optimize)
    grids = make_grids(cams, org.grid_scale, org.max_patches_per_cell)
    cells = candidate_cells(grids, cams, st.position, st.vis, org.grid_scale)
    acc, grids = bulk_try_insert(
        grids, cells, st.alive,
        torch.arange(st.capacity, device=st.position.device),
        org.min_grids_to_accept,
    )
    return st.masked(acc).compact(), grids


def profile_round(images, cams, frontier, grids, cfg):
    """One expansion round of `frontier` against `grids`, phase by phase.
    Returns (seconds, rows, launches) keyed by phase, and the round's
    counts. `grids` is not changed."""
    from densepoints_tpu_torch.ops import allview_ncc
    from densepoints_tpu_torch.pmvs.expand import make_expansion_candidates
    from densepoints_tpu_torch.pmvs.optimize import (
        filter_by_error,
        optimize_patches,
    )
    from densepoints_tpu_torch.pmvs.organizer import (
        bulk_try_insert,
        candidate_cells,
        prescreen_candidates,
    )
    from densepoints_tpu_torch.pmvs.visibility import classify_views

    device = frontier.position.device
    org, opt = cfg.organizer, cfg.optimize
    expand_opt = dataclasses.replace(
        opt, max_iterations=cfg.expand.max_iterations)
    tex = cfg.expand.texture_size
    seconds, rows, launches = {}, {}, {}

    def phase(name, n_rows, fn):
        start = allview_ncc.KERNEL_LAUNCHES
        out, seconds[name] = _timing.host_seconds(fn, device)
        rows[name] = n_rows
        launches[name] = allview_ncc.KERNEL_LAUNCHES - start
        return out

    F = frontier.capacity
    cand = phase("make_candidates", F, lambda: make_expansion_candidates(
        cams, frontier, org.grid_scale))
    C = cand.capacity
    pre_cells = phase("candidate_cells", C, lambda: candidate_cells(
        grids, cams, cand.position, cand.vis, org.grid_scale))
    keep = phase("prescreen", C, lambda: prescreen_candidates(
        grids, pre_cells, cand.alive, org.min_grids_to_accept, PRESCREEN))
    candc = phase("compact", C,
                  lambda: cand.masked(keep & cand.alive).compact())
    K = candc.capacity
    optd = phase("optimize_nm", K, lambda: optimize_patches(
        images, cams, candc, tex, expand_opt))
    vis_cand = phase("classify_views", K, lambda: classify_views(
        cams, optd.position, optd.normal, optd.ref, opt.visible_angle,
        opt.candidate_angle))
    opt2 = dataclasses.replace(optd, vis=vis_cand[0], cand=vis_cand[1])
    filt = phase("filter_by_error", K, lambda: filter_by_error(
        images, cams, opt2, tex, expand_opt))
    cells2 = phase("candidate_cells2", K, lambda: candidate_cells(
        grids, cams, filt.position, filt.vis, org.grid_scale))
    accepted, _ = phase("bulk_try_insert", K, lambda: bulk_try_insert(
        grids, cells2, filt.alive,
        torch.arange(filt.capacity, device=device),
        org.min_grids_to_accept))
    counts = {
        "frontier": F,
        "candidates": C,
        "valid_cells": int((pre_cells >= 0).sum()),
        "kept": K,
        "optimised_alive": int(optd.alive.sum()),
        "filtered_alive": int(filt.alive.sum()),
        "accepted": int(accepted.sum()),
    }
    return seconds, rows, launches, counts


def run(args) -> dict:
    """The program's run; returns its record."""
    from densepoints_tpu_torch.core.cameras import Cameras

    device = _timing.run_device(args.device)
    c = args.config
    scene_gen, images_np = _rigs.sphere_scene(
        num_views=c["views"], width=c["width"], height=c["height"],
        focal=c["focal"], tex_size=c["tex_size"])
    cams = Cameras.from_projection_matrices(
        scene_gen.P, widths=c["width"], heights=c["height"], device=device)
    images = torch.as_tensor(images_np, device=device)
    seeds = _rigs.sphere_seeds(c["seeds"], _rigs.SPHERE["radius"])
    cfg = config(c)
    counter = _timing.Counts(device)
    (frontier, grids), seed_s = _timing.host_seconds(
        lambda: seed_frontier(images, cams, seeds, cfg), device)
    print(f"frontier: {frontier.capacity}", flush=True)
    runs, launches = {}, {}
    for name in ("cold", "warm"):
        seconds, rows, launches[name], counts = profile_round(
            images, cams, frontier, grids, cfg)
        runs[name] = {**seconds, "TOTAL": sum(seconds.values())}
        print(name, json.dumps(runs[name]), flush=True)
    return {
        "program": "expand_profile",
        "device": _scene_runs.device_label(device),
        "scene": {"views": c["views"], "image": [c["height"], c["width"]],
                  "focal": c["focal"], "seeds": c["seeds"]},
        "config": {"prescreen": PRESCREEN,
                   "seed_nm_iterations": c["nm_iters"],
                   "expand_nm_iterations": c["expand_nm_iters"],
                   "grid_scale": cfg.organizer.grid_scale},
        "seed_refine_seconds": seed_s,
        "cold": runs["cold"],
        "warm": runs["warm"],
        "rows": rows,
        "allview_ncc_launches": launches["warm"],
        "counts": counts,
        "absent": ABSENT,
        **counter.read(),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
