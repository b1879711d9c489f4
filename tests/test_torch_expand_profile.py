"""The port's expansion-round profile (`densepoints_tpu_torch.scripts.
expand_profile`) against the JAX package, on the CPU at a tiny size.

The JAX program's `main` is never called: it writes into the repo's root.
One frontier (the port's seed refine on a small sphere, carried over as
numpy) and one set of grids go through the port's `profile_round` and
through the JAX package's phase functions in the order of
`scripts/expand_profile.py`, `_pad_bucket` included.

Tolerances: candidates, valid candidate cells and pre-screen survivors are
equal exactly (no Nelder-Mead has run yet); after `optimize_nm`,
`filter_by_error` and `bulk_try_insert` the counts agree within 5% (batch
shapes round the Nelder-Mead objective, ROADMAP C).
"""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import load_config as jax_load_config
from densepoints_tpu.core.cameras import Cameras as JaxCameras
from densepoints_tpu.pmvs.expand import (
    _pad_bucket,
    make_expansion_candidates as jax_make_candidates,
)
from densepoints_tpu.pmvs.optimize import (
    filter_by_error as jax_filter_by_error,
    optimize_patches as jax_optimize_patches,
)
from densepoints_tpu.pmvs.organizer import (
    OccupancyGrids as JaxGrids,
    bulk_try_insert as jax_bulk_try_insert,
    candidate_cells as jax_candidate_cells,
    prescreen_candidates as jax_prescreen,
)
from densepoints_tpu.pmvs.patch import PatchState as JaxPatchState
from densepoints_tpu.pmvs.visibility import classify_views as jax_classify
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.interop import patch_state_to_numpy
from densepoints_tpu_torch.scripts import _rigs, expand_profile
from tests import torch_port_util  # noqa: F401  (torch threads)

ROOT = Path(__file__).resolve().parents[1]
COUNT_RTOL = 0.05  # counts after Nelder-Mead, port vs JAX
# The JAX record's phases, less the shape buckets the port has not.
JAX_PHASES = [k for k in json.loads(
    (ROOT / "EXPAND_PROFILE_r05.json").read_text())["warm"]
    if k not in expand_profile.ABSENT and k != "TOTAL"]

# 12 views of 256 x 192 at half the bench focal length: ~200 patches in the
# frontier, ~900 candidates.
TINY_CONFIG = {"seeds": 600, "views": 12, "width": 256, "height": 192,
               "focal": 225, "tex_size": 512, "nm_iters": 20,
               "expand_nm_iters": 15}
TINY = ["--device", "cpu", "--config", json.dumps(TINY_CONFIG)]


@pytest.fixture(scope="module")
def frontier():
    """(args, scene generator, images, port frontier, port grids)."""
    args = expand_profile.parse_args(TINY)
    c = args.config
    sc, images = _rigs.sphere_scene(num_views=c["views"], width=c["width"],
                                    height=c["height"], focal=c["focal"],
                                    tex_size=c["tex_size"])
    cams = Cameras.from_projection_matrices(sc.P, c["width"], c["height"])
    cfg = expand_profile.config(c)
    front, grids = expand_profile.seed_frontier(
        torch.as_tensor(images), cams, _rigs.sphere_seeds(c["seeds"]), cfg)
    assert front.capacity > 100
    return args, sc, images, front, grids


def jax_round(sc, images, front_np, grids_np, args):
    """The round of `scripts/expand_profile.py` on the JAX package; its
    counts under the port's names."""
    cfg = jax_load_config({
        **_rigs.SPHERE_CONFIG,
        "expand": {"max_rounds": 4,
                   "max_iterations": args.config["expand_nm_iters"]},
        "optimize": {"max_iterations": args.config["nm_iters"]},
    })
    cams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)
    dimages = jnp.asarray(images)
    frontier = JaxPatchState(**{k: jnp.asarray(v)
                                for k, v in front_np.items()})
    grids = JaxGrids(cells=jnp.asarray(grids_np[0], jnp.int32),
                     cols=jnp.asarray(grids_np[1], jnp.int32),
                     rows=jnp.asarray(grids_np[2], jnp.int32))
    gs, mg = cfg.organizer.grid_scale, cfg.organizer.min_grids_to_accept
    expand_opt = dataclasses.replace(
        cfg.optimize, max_iterations=cfg.expand.max_iterations)
    cand0 = jax_make_candidates(cams, frontier, gs)
    cand = _pad_bucket(cand0, quantum=cfg.optimize.max_refine_batch)
    pre_cells = jax_candidate_cells(grids, cams, cand.position, cand.vis, gs)
    keep = jax_prescreen(grids, pre_cells, cand.alive, mg,
                         expand_profile.PRESCREEN)
    candc = cand.masked(keep & cand.alive).compact()
    candp = _pad_bucket(candc, quantum=cfg.optimize.max_refine_batch)
    opt = jax_optimize_patches(dimages, cams, candp, cfg.expand.texture_size,
                               expand_opt)
    vis, cnd = jax_classify(cams, opt.position, opt.normal, opt.ref,
                            cfg.optimize.visible_angle,
                            cfg.optimize.candidate_angle)
    opt2 = dataclasses.replace(opt, vis=vis, cand=cnd)
    filt = jax_filter_by_error(dimages, cams, opt2, cfg.expand.texture_size,
                               expand_opt)
    cells2 = jax_candidate_cells(grids, cams, filt.position, filt.vis, gs)
    acc, _ = jax_bulk_try_insert(
        grids, cells2, filt.alive, jnp.arange(filt.capacity, dtype=jnp.int32),
        mg)
    C = cand0.capacity
    return {
        "frontier": frontier.capacity,
        "candidates": C,
        "valid_cells": int((np.asarray(pre_cells)[:C] >= 0).sum()),
        "kept": int(np.asarray(keep & cand.alive).sum()),
        "optimised_alive": int(np.asarray(opt.alive).sum()),
        "filtered_alive": int(np.asarray(filt.alive).sum()),
        "accepted": int(np.asarray(acc).sum()),
    }


def test_round_counts_match_jax(frontier):
    args, sc, images, front, grids = frontier
    cfg = expand_profile.config(args.config)
    seconds, rows, launches, got = expand_profile.profile_round(
        torch.as_tensor(images),
        Cameras.from_projection_matrices(sc.P, sc.width, sc.height),
        front, grids, cfg)
    want = jax_round(sc, images, patch_state_to_numpy(front),
                     (grids.cells.numpy(), grids.cols.numpy(),
                      grids.rows.numpy()), args)
    for key in ("frontier", "candidates", "valid_cells", "kept"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["kept"] < got["candidates"]  # the pre-screen dropped some
    for key in ("optimised_alive", "filtered_alive", "accepted"):
        assert abs(got[key] - want[key]) <= COUNT_RTOL * want[key], (
            key, got[key], want[key])
    assert got["accepted"] > 0
    assert list(seconds) == JAX_PHASES
    assert rows["make_candidates"] == got["frontier"]
    assert rows["optimize_nm"] == got["kept"]
    assert launches == dict.fromkeys(JAX_PHASES, 0)  # CPU


def test_record_names_the_jax_phases(frontier, monkeypatch):
    """The record's phases are the JAX record's less the two shape
    buckets, which stand under `absent`."""
    args, sc, images, front, grids = frontier
    monkeypatch.setattr(_rigs, "sphere_scene", lambda **kw: (sc, images))
    monkeypatch.setattr(expand_profile, "seed_frontier",
                        lambda *a: (front, grids))
    record = expand_profile.run(args)
    assert set(expand_profile.ABSENT) == {"pad_bucket", "pad_bucket2"}
    assert set(record["absent"]) == set(expand_profile.ABSENT)
    for run in ("cold", "warm"):
        assert list(record[run]) == JAX_PHASES + ["TOTAL"]
        assert all(np.isfinite(v) and v >= 0 for v in record[run].values())
    assert record["counts"]["frontier"] == front.capacity
    assert record["launches"] == {"allview_ncc": 0, "slot_ncc": 0}
    assert record["plain_calls"] > 0 and record["device"] == "cpu"
    assert record["max_memory_allocated"] is None


def test_main_writes_only_its_out(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(expand_profile, "run", lambda args: {
        "program": "expand_profile", "counts": {"frontier": 1}})
    monkeypatch.chdir(tmp_path)
    assert expand_profile.main(TINY) == 0
    assert list(tmp_path.iterdir()) == []
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["program"] == "expand_profile"
    out = tmp_path / "profile.json"
    assert expand_profile.main(TINY + ["--out", str(out)]) == 0
    assert list(tmp_path.iterdir()) == [out]
    assert json.loads(out.read_text())["counts"] == printed["counts"]
