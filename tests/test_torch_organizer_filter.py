"""The port's occupancy organizer, filters and one expansion round vs JAX.

Organizer and filters are integer scatter/gather logic over identical
inputs: exactly equal results (the pre-screen included). An expansion round
runs Nelder-Mead, whose accept decisions can flip on last-bit float
differences: the accepted counts must agree within 2%, with and without
the pre-screen.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import ExpandConfig as JaxExpandConfig
from densepoints_tpu.config import FilterConfig as JaxFilterConfig
from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.config import OrganizerConfig as JaxOrganizerConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.pmvs import PatchState as JaxPatchState
from densepoints_tpu.pmvs.expand import expand_patches as jax_expand
from densepoints_tpu.pmvs.filter import run_filters as jax_run_filters
from densepoints_tpu.pmvs.organizer import bulk_try_insert as jax_insert
from densepoints_tpu.pmvs.organizer import candidate_cells as jax_cells
from densepoints_tpu.pmvs.organizer import make_grids as jax_make_grids
from densepoints_tpu.pmvs.organizer import OccupancyGrids as JaxOccupancyGrids
from densepoints_tpu.pmvs.organizer import prescreen_candidates as jax_prescreen
from densepoints_tpu_torch.config import (
    ExpandConfig,
    FilterConfig,
    OptimizeConfig,
    OrganizerConfig,
)
from densepoints_tpu_torch.pmvs.expand import (
    expand_patches,
    make_expansion_candidates,
)
from densepoints_tpu_torch.pmvs.filter import run_filters
from densepoints_tpu_torch.pmvs.organizer import (
    OccupancyGrids,
    bulk_try_insert,
    candidate_cells,
    make_grids,
    prescreen_candidates,
)
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import torch_cameras, torch_state


def _cams(rng, width=160, height=120):
    scene = TexturedPlaneScene(rng, num_views=5, width=width, height=height)
    cams = JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    return cams, scene


def _crowd(rng, n, V, spread=0.3):
    """Patches crowded into few cells, so claims contend."""
    xy = rng.uniform(-spread, spread, (n, 2))
    z = rng.uniform(-0.05, 0.05, (n, 1))
    pos = np.concatenate([xy, z], 1).astype(np.float32)
    vis = rng.uniform(size=(n, V)) > 0.2
    return pos, vis


def test_candidate_cells_match(rng):
    cams, _ = _cams(rng)
    pos, vis = _crowd(rng, 64, cams.num_views, spread=1.5)
    jg = jax_make_grids(cams, 8)
    want = np.asarray(jax_cells(jg, cams, jnp.asarray(pos), jnp.asarray(vis), 8))
    tc = torch_cameras(cams)
    got = candidate_cells(
        make_grids(tc, 8), tc, torch.as_tensor(pos), torch.as_tensor(vis), 8
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == -1).any() and (want >= 0).any()


@pytest.mark.parametrize("K", [1, 2])
def test_bulk_try_insert_matches(rng, K):
    cams, _ = _cams(rng)
    V = cams.num_views
    tc = torch_cameras(cams)
    jg = jax_make_grids(cams, 8, K)
    tg = make_grids(tc, 8, K)
    total = 0
    for batch in range(3):  # later batches meet occupied cells
        pos, vis = _crowd(rng, 48, V)
        alive = rng.uniform(size=48) > 0.1
        cells = np.asarray(
            jax_cells(jg, cams, jnp.asarray(pos), jnp.asarray(vis), 8)
        )
        gids = total + np.arange(48, dtype=np.int32)
        jacc, jg = jax_insert(
            jg, jnp.asarray(cells), jnp.asarray(alive), jnp.asarray(gids)
        )
        tacc, tg = bulk_try_insert(
            tg, torch.as_tensor(cells).long(), torch.as_tensor(alive),
            torch.as_tensor(gids).long(),
        )
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        np.testing.assert_array_equal(tg.cells.numpy(), np.asarray(jg.cells))
        total += 48
    accepted = np.asarray(jacc)
    assert 0 < accepted.sum() < len(accepted)  # contention was real


def test_bulk_try_insert_writes_each_cell_once():
    """A real cell is never written twice: two candidates claiming the
    same cells resolve to the lower index."""
    cells = torch.tensor([[0, 1, -1], [0, 1, 2]])  # 3 views of 1 cell
    grids = OccupancyGrids(
        cells=torch.full((3, 1, 1), -1), cols=torch.ones(3, dtype=int),
        rows=torch.ones(3, dtype=int),
    )
    acc, new = bulk_try_insert(
        grids, cells, torch.tensor([True, True]), torch.tensor([7, 8])
    )
    assert acc.tolist() == [True, False]
    assert new.cells.reshape(-1).tolist() == [7, 7, -1]


def _random_occupancy(K, seed=3, B=40):
    """Partly filled grids of 3 views of 4 x 4 cells and a contended batch."""
    rng = np.random.default_rng(seed)
    shape = (3, 4, 4) if K == 1 else (3, 4, 4, K)
    occupied = rng.choice([-1, -1, -1, 5], size=shape).astype(np.int32)
    if K > 1:  # slots fill in ascending order
        occupied = -np.sort(-occupied, axis=-1)
    cells = np.where(
        rng.uniform(size=(B, 3)) < 0.8, rng.integers(0, 3 * 16, size=(B, 3)),
        -1,
    ).astype(np.int32)
    alive = rng.uniform(size=(B,)) < 0.9
    return occupied, cells, alive


def _grids_pair(occupied):
    jg = JaxOccupancyGrids(
        cells=jnp.asarray(occupied), cols=jnp.full((3,), 4, jnp.int32),
        rows=jnp.full((3,), 4, jnp.int32),
    )
    tg = OccupancyGrids(
        cells=torch.as_tensor(occupied).long(),
        cols=torch.full((3,), 4), rows=torch.full((3,), 4),
    )
    return jg, tg


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("mode", ["free", "claim"])
def test_prescreen_candidates_match(mode, K):
    occupied, cells, alive = _random_occupancy(K)
    jg, tg = _grids_pair(occupied)
    want = np.asarray(jax_prescreen(
        jg, jnp.asarray(cells), jnp.asarray(alive), 2, mode))
    got = prescreen_candidates(
        tg, torch.as_tensor(cells).long(), torch.as_tensor(alive), 2, mode
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < alive.sum()  # the screen dropped something


@pytest.mark.parametrize("K", [1, 2])
def test_prescreen_matches_insert_acceptance(K):
    """"claim" is the `bulk_try_insert` contest without the writes: on the
    same cells it agrees exactly with the acceptance; "free" is a necessary
    condition, so it keeps everything "claim" keeps."""
    occupied, cells, alive = _random_occupancy(K, seed=4)
    _, tg = _grids_pair(occupied)
    c, a = torch.as_tensor(cells).long(), torch.as_tensor(alive)
    keep = prescreen_candidates(tg, c, a, 2, "claim")
    accepted, _ = bulk_try_insert(tg, c, a, torch.arange(len(a)), 2)
    assert torch.equal(keep, accepted)
    free = prescreen_candidates(tg, c, a, 2, "free")
    assert bool(free[keep].all())
    with pytest.raises(ValueError, match="unknown prescreen mode"):
        prescreen_candidates(tg, c, a, 2, "maybe")


FILTER_CONFIGS = [
    {},
    {"min_support_cells": 4, "depth_consistency": 0.005,
     "occlusion_slack": 0.02, "min_final_visible_views": 3},
]


@pytest.mark.parametrize("fcfg", FILTER_CONFIGS, ids=["default", "scan"])
def test_run_filters_match(rng, fcfg):
    cams, _ = _cams(rng)
    V = cams.num_views
    n = 300
    pos, vis = _crowd(rng, n, V, spread=0.8)
    pos[:, 2] = 0.0  # on the plane z = 0 ...
    # ... but a band of floaters in front of the plane occludes part of it.
    pos[:40, 2] = -rng.uniform(0.3, 0.6, 40)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    refs = rng.integers(0, V, n).astype(np.int32)
    vis[np.arange(n), refs] = False
    alive = rng.uniform(size=n) > 0.05
    st = JaxPatchState.create(pos, normal, refs, vis, alive=alive)
    want = jax_run_filters(
        cams, st, JaxFilterConfig(**fcfg), JaxOptimizeConfig(), 8
    )
    got = run_filters(
        torch_cameras(cams), torch_state(st), FilterConfig(**fcfg),
        OptimizeConfig(), 8,
    )
    np.testing.assert_array_equal(got.vis.numpy(), np.asarray(want.vis))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    kept = np.asarray(want.alive)
    assert 0 < kept.sum() < alive.sum()  # the filters removed something
    assert (np.asarray(want.vis) != vis).any()  # occlusion removed views


def test_expansion_candidates_step_one_cell(rng):
    cams, _ = _cams(rng)
    pos = np.array([[0.0, 0.0, 0.0]], np.float32)
    st = JaxPatchState.create(
        pos, np.array([[0.0, 0.0, 1.0]], np.float32), np.zeros(1, np.int32),
        np.ones((1, cams.num_views), bool),
    )
    tc = torch_cameras(cams)
    cand = make_expansion_candidates(tc, torch_state(st), 8)
    assert cand.capacity == 4
    pix0 = tc.project(torch.as_tensor(pos))[0, 0]
    steps = torch.linalg.norm(tc.project(cand.position)[0] - pix0, dim=-1)
    np.testing.assert_allclose(steps.numpy(), 8.0, rtol=0.2)


def _expand_round_accepts_like_jax(rng, prescreen):
    cams, scene = _cams(rng)
    images = scene.render_all()
    V = cams.num_views
    g = np.linspace(-0.5, 0.5, 6)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    n = len(xy)
    pos = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    vis = np.ones((n, V), bool)
    vis[:, 0] = False
    st = JaxPatchState.create(pos, normal, np.zeros(n, np.int32), vis)
    want, _ = jax_expand(
        jnp.asarray(images), cams, st,
        JaxExpandConfig(max_rounds=1, prescreen=prescreen),
        JaxOrganizerConfig(), JaxOptimizeConfig(max_iterations=30),
    )
    got, grids = expand_patches(
        torch.as_tensor(images), torch_cameras(cams), torch_state(st),
        ExpandConfig(max_rounds=1, prescreen=prescreen), OrganizerConfig(),
        OptimizeConfig(max_iterations=30),
    )
    n_jax, n_torch = want.capacity - n, got.capacity - n
    assert n_jax > 10
    assert abs(n_torch - n_jax) <= 0.02 * n_jax + 1e-9, (n_torch, n_jax)
    assert int((grids.cells >= 0).sum()) >= 2 * got.capacity


def test_expand_round_accepts_like_jax(rng):
    _expand_round_accepts_like_jax(rng, "off")


def test_expand_round_with_prescreen_accepts_like_jax(rng):
    _expand_round_accepts_like_jax(rng, "claim")
