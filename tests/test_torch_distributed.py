"""`parallel/distributed.py` of the port against the JAX package.

The JAX side runs in this process on the conftest's 8-device CPU mesh, as
`tests/parallel/test_distributed.py` does; the port's side runs as jobs of
1 and 2 gloo processes (`tests/torch_parallel_worker.py`). Inputs are made
here in numpy from a seed and go to both.

Insertion is integer work decided by global ids: accepted sets and grids
equal exactly, across packages and rank counts. Refinement ends in
Nelder-Mead: positions within 1e-3 of the JAX package (the port's
established tolerance after Nelder-Mead), and 2 ranks equal 1 rank. The
whole `densify_distributed` (parallel/pipeline.py) is held as
`densify_multihost` is in `test_torch_multihost.py`.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from densepoints_tpu.config import MatchingConfig as JaxMatchingConfig
from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.config import OrganizerConfig as JaxOrganizerConfig
from densepoints_tpu.config import PipelineConfig as JaxPipelineConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.io.scene import Scene as JaxScene
from densepoints_tpu.parallel import (
    distributed_insert as jax_distributed_insert,
    distributed_refine_step as jax_distributed_refine_step,
    make_mesh as jax_make_mesh,
    shard_state as jax_shard_state,
)
from densepoints_tpu.parallel.distributed import (
    pad_views as jax_pad_views,
    refine_step_impl as jax_refine_step_impl,
    viewsharded_insert as jax_viewsharded_insert,
)
from densepoints_tpu.parallel.pipeline import (
    densify_distributed as jax_densify_distributed,
)
from densepoints_tpu.pmvs import PatchState as JaxPatchState
from densepoints_tpu.pmvs.organizer import (
    candidate_cells as jax_candidate_cells,
    make_grids as jax_make_grids,
)
from tests.synthetic import TexturedPlaneScene
from tests.torch_parallel_util import run_job

_CAMS = ("P", "K", "E", "C", "x_axis", "width", "height")
_STATE = ("position", "normal", "ref", "vis", "cand", "alive", "color")


def _scene(rng):
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    cams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)
    return cams, sc.render_all().astype(np.float32)


def _patches(cams, n, rng, dead=0.0):
    """Plane patches seen by views 1-4 (view 0 the reference), a share
    `dead` of them not alive."""
    xy = rng.uniform(-0.8, 0.8, (n, 2))
    position = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    vis = np.ones((n, cams.num_views), bool)
    vis[:, 0] = False
    state = JaxPatchState.create(position, normal, np.zeros((n,), np.int32),
                                 vis)
    if dead:
        alive = rng.uniform(size=n) >= dead
        state = JaxPatchState.create(position, normal,
                                     np.zeros((n,), np.int32), vis,
                                     alive=alive)
    return state


def _inputs(cams, state, **extra):
    out = {f"cam_{f}": np.asarray(getattr(cams, f)) for f in _CAMS}
    out.update({f"st_{f}": np.asarray(getattr(state, f)) for f in _STATE})
    out.update(extra)
    return out


@pytest.fixture(scope="module")
def insert_case():
    rng = np.random.default_rng(0)
    cams, _ = _scene(rng)
    state = _patches(cams, 96, rng, dead=0.1)
    return cams, state


@pytest.fixture(scope="module")
def insert_runs(insert_case, tmp_path_factory):
    cams, state = insert_case
    tmp = tmp_path_factory.mktemp("insert")
    inputs = _inputs(cams, state, grid_scale=np.int64(8),
                     min_grids=np.int64(2),
                     ids=np.arange(state.capacity, dtype=np.int64))
    return {world: run_job("insert", world, inputs, tmp)
            for world in (1, 2)}


def test_distributed_insert_matches_jax(insert_case, insert_runs):
    cams, state = insert_case
    mesh = jax_make_mesh()
    ids = jnp.arange(state.capacity, dtype=jnp.int32)
    acc, grids = jax_distributed_insert(
        mesh, jax_make_grids(cams, 8), cams, jax_shard_state(state, mesh),
        ids, JaxOrganizerConfig(grid_scale=8, min_grids_to_accept=2))
    want_acc = np.asarray(acc)[: state.capacity]
    assert 0 < want_acc.sum() < state.capacity  # a contest was decided
    for world, ranks in insert_runs.items():
        for out in ranks:
            assert str(out["backend"]) == "gloo"
            np.testing.assert_array_equal(out["dist_accepted"], want_acc)
            np.testing.assert_array_equal(out["dist_cells"],
                                          np.asarray(grids.cells))


@pytest.mark.parametrize("K", [1, 2])
def test_viewsharded_insert_matches_jax(insert_case, insert_runs, K):
    """Two insertion rounds on view-sharded grids: the second, with other
    ids, against the grids the first filled (full cells reject)."""
    cams, state = insert_case
    mesh = jax_make_mesh()
    grids = jax_make_grids(cams, 8, K)
    V = grids.cells.shape[0]
    gpad = jax_pad_views(grids, mesh.devices.size)
    Vp = gpad.cells.shape[0]
    cells = jax_candidate_cells(grids, cams, state.position, state.vis, 8)
    cells = jnp.pad(cells, ((0, 0), (0, Vp - V)), constant_values=-1)
    ids = jnp.arange(state.capacity, dtype=jnp.int32)
    want = []
    for r in (0, 1):
        acc, gpad = jax_viewsharded_insert(mesh, gpad, cells, state.alive,
                                           ids + 1000 * r, 2)
        want.append((np.asarray(acc), np.asarray(gpad.cells)[:V]))
    assert want[0][0].any()
    if K == 1:  # one slot per cell: every first-round winner is shut out
        assert not (want[0][0] & want[1][0]).any()
    for world, ranks in insert_runs.items():
        for out in ranks:
            for r, (acc, cells_r) in enumerate(want):
                got = out[f"vs_cells_K{K}_r{r}"]
                np.testing.assert_array_equal(out[f"vs_accepted_K{K}_r{r}"],
                                              acc)
                np.testing.assert_array_equal(got[:V], cells_r)
                assert (got[V:] == -1).all()  # padded views stay empty


def test_pad_views_matches_jax(insert_case, insert_runs):
    cams, _ = insert_case
    for world, ranks in insert_runs.items():
        for K in (1, 2):
            want = jax_pad_views(jax_make_grids(cams, 8, K), world)
            got = ranks[0]
            np.testing.assert_array_equal(got[f"pad_cols_K{K}"],
                                          np.asarray(want.cols))
            np.testing.assert_array_equal(got[f"pad_rows_K{K}"],
                                          np.asarray(want.rows))
            assert got[f"vs_cells_K{K}_r0"].shape[0] == want.cells.shape[0]


@pytest.mark.parametrize("max_refine_batch", [0, 6], ids=["whole", "sliced"])
def test_refine_step_matches_jax(tmp_path, max_refine_batch):
    """refine_step_impl / distributed_refine_step of the port on 1 and 2
    ranks against the JAX package's on one device and on the 8-device
    mesh; sliced, the slices are cut over the global batch."""
    rng = np.random.default_rng(1)
    cams, images = _scene(rng)
    state = _patches(cams, 16, rng)
    cfg = JaxOptimizeConfig(max_iterations=25,
                            max_refine_batch=max_refine_batch)
    want = jax_refine_step_impl(jnp.asarray(images), cams, state, 16, cfg)
    mesh = jax_make_mesh()
    want_mesh = jax_distributed_refine_step(
        jnp.asarray(images), cams, jax_shard_state(state, mesh), 16, cfg)
    np.testing.assert_array_equal(np.asarray(want_mesh.alive)[:16],
                                  np.asarray(want.alive))
    inputs = _inputs(cams, state, images=images, texture_size=np.int64(16),
                     max_iterations=np.int64(25),
                     max_refine_batch=np.int64(max_refine_batch))
    runs = {world: run_job("refine", world, inputs, tmp_path)
            for world in (1, 2)}
    for world, ranks in runs.items():
        for out in ranks:
            for key in ("impl_", "step_"):
                np.testing.assert_array_equal(out[key + "alive"],
                                              np.asarray(want.alive))
                np.testing.assert_allclose(out[key + "position"],
                                           np.asarray(want.position),
                                           atol=1e-3, rtol=0)
                np.testing.assert_array_equal(out[key + "vis"],
                                              np.asarray(want.vis))
    one, two = runs[1][0], runs[2]
    for out in two:  # 2 ranks = 1 rank, and the two ranks agree bitwise
        for f in _STATE:
            np.testing.assert_array_equal(out["step_" + f],
                                          two[0]["step_" + f])
            np.testing.assert_array_equal(out["impl_" + f], one["impl_" + f])
            np.testing.assert_array_equal(out["step_" + f], one["step_" + f])


def test_nelder_mead_mesh_exit(tmp_path):
    """Nelder-Mead with a mesh: 2 ranks equal 1 rank, and both ranks make
    as many exit checks as the slowest lane of the whole batch needs, the
    fast rank included (its own lanes converge first)."""
    rng = np.random.default_rng(2)
    B, D = 24, 3
    weights = np.ones((B, D), np.float32)
    weights[B // 2:] = rng.uniform(20.0, 60.0, (B // 2, D))  # slow lanes
    inputs = {
        "x0": rng.uniform(-1, 1, (B, D)).astype(np.float32),
        "centres": rng.uniform(-1, 1, (B, D)).astype(np.float32),
        "weights": weights, "max_iterations": np.int64(400),
    }
    one = run_job("nelder_mead", 1, inputs, tmp_path)[0]
    two = run_job("nelder_mead", 2, inputs, tmp_path)
    for out in two:
        for key in ("x", "f", "iters"):
            np.testing.assert_array_equal(out[key], one[key])
    fast, slow = one["iters"][: B // 2], one["iters"][B // 2:]
    assert fast.max() < slow.max() < 400
    # One exit check per iteration until the whole batch converged.
    assert int(two[0]["exit_checks"]) == int(two[1]["exit_checks"])
    assert int(two[0]["exit_checks"]) == int(slow.max()) + 1


def test_densify_distributed_matches_jax(tmp_path):
    """`densify_distributed` on the JAX package's multi-host plane scene
    (5 views of 160 x 120, its own seeds, 40 Nelder-Mead iterations, one
    expansion round): 2 ranks equal 1 rank, and the port against the JAX
    package on its 8-device mesh within 15% in count, the plane found."""
    inputs = {"max_iterations": np.int64(40), "max_rounds": np.int64(1),
              "max_keypoints": np.int64(384)}
    one = run_job("densify_distributed", 1, inputs, tmp_path)[0]
    two = run_job("densify_distributed", 2, inputs, tmp_path)
    for out in two:
        assert out["position"].shape == one["position"].shape
        np.testing.assert_array_equal(out["vis"], one["vis"])
        np.testing.assert_allclose(out["position"], one["position"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["normal"], one["normal"], atol=1e-5,
                                   rtol=0)
        assert out["counter_seed_refine_patches_per_sec"] > 0
    rng = np.random.default_rng(0)
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    cams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)
    cfg = JaxPipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        matching=JaxMatchingConfig(max_keypoints_per_view=384),
        optimize=dataclasses.replace(cfg.optimize, max_iterations=40),
        expand=dataclasses.replace(cfg.expand, max_rounds=1),
    )
    want = jax_densify_distributed(
        JaxScene(cameras=cams, images=sc.render_all(), colors=None), cfg,
        mesh=jax_make_mesh())
    n_jax, got = want.patches.capacity, one["position"]
    print(f"densify_distributed patches: jax {n_jax}, port {len(got)}")
    assert len(got) >= 50
    assert np.median(np.abs(got[:, 2])) < 0.05
    assert abs(len(got) - n_jax) <= 0.15 * n_jax
