"""`densify_clustered` of the port: 2 gloo processes against 1, and the
port against the JAX package.

The scene is the JAX package's clustered test scene (a sphere ringed by 8
views of 200 x 150, 60 seed points on it; `tests/parallel/
clustered_worker.py`), at 40 Nelder-Mead iterations and 2 expansion
rounds. Contracts, those of the JAX package's driver
(`densepoints_tpu/parallel/clustered.py`, its docstring):
  * with a permissive halo (every view held), 2 ranks equal 1 rank at an
    exact count and positions within 5e-3 (the ranks' batches differ, and
    batch shapes round Nelder-Mead's sums), and both ranks of a job return
    the same cloud bitwise;
  * with a tight halo each rank holds fewer image bytes than the stack,
    and the two ranks hold different views;
  * the port against the JAX package (one process each, in this process):
    counts within 15% and the sphere found (median radial error < 0.05);
  * a reference behaviour kept: an expansion candidate's priority is made
    from the accepted rank of its parent WITHIN the parent's round, so the
    priorities of successive rounds repeat, in both packages.
"""
import dataclasses

import jax.numpy as jnp  # noqa: F401  (keeps jax on the CPU backend here)
import numpy as np
import pytest

from densepoints_tpu.config import PipelineConfig as JaxPipelineConfig
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.io.scene import Scene as JaxScene
from densepoints_tpu.parallel import clustered as jax_clustered
from densepoints_tpu_torch.config import PipelineConfig
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.parallel import clustered
from densepoints_tpu_torch.parallel.mesh import make_mesh
from tests.synthetic import TexturedSphereScene
from tests.torch_parallel_util import run_job
from tests.torch_port_util import torch_cameras

_ITERS = 40
_ROUNDS = 2


def _inputs(halo):
    return {"max_iterations": np.int64(_ITERS),
            "max_rounds": np.int64(_ROUNDS),
            "halo_threshold": np.float64(halo)}


def _match_clouds(a, c, atol):
    """Nearest-neighbour match of two equal-size clouds."""
    pa, pc = a["position"], c["position"]
    assert pa.shape == pc.shape
    d = np.linalg.norm(pa[:, None, :] - pc[None, :, :], axis=-1)
    assert float(d.min(axis=1).max()) < atol


def test_two_ranks_equal_one_rank(tmp_path):
    one = run_job("clustered", 1, _inputs(-1.0), tmp_path)[0]
    a, b = run_job("clustered", 2, _inputs(-1.0), tmp_path)
    for key in ("position", "normal", "vis"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["position"].shape[0] > 0
    _match_clouds(a, one, atol=5e-3)
    assert len(a["views_held"]) == 8 == len(b["views_held"])


def test_tight_halo_holds_fewer_images(tmp_path):
    a, b = run_job("clustered", 2, _inputs(0.62), tmp_path)
    np.testing.assert_array_equal(a["position"], b["position"])
    assert a["position"].shape[0] > 0
    full_bytes = 8 * 200 * 150 * 4
    for part in (a, b):
        assert int(part["counter_image_bytes_held"]) < full_bytes
        assert len(part["views_held"]) < 8
    assert set(a["views_held"].tolist()) != set(b["views_held"].tolist())


def _sphere():
    sc = TexturedSphereScene(np.random.default_rng(0), num_views=8,
                             width=200, height=150, focal=170.0, radius=1.0,
                             cam_radius=4.0)
    g = np.random.default_rng(7)
    pts = g.standard_normal((60, 3)).astype(np.float32)
    pts *= 1.0 / np.linalg.norm(pts, axis=1, keepdims=True)
    return sc, pts


def _recording(module, monkeypatch, calls, prio_at):
    """Wrap `module._allgather_concat` to record the priorities of every
    insertion exchange (three arrays: cells, alive, priorities)."""
    inner = module._allgather_concat

    def record(*args):
        arrays = args[prio_at]
        if len(arrays) == 3:
            calls.append(np.asarray(arrays[2]).copy())
        return inner(*args)

    monkeypatch.setattr(module, "_allgather_concat", record)


@pytest.fixture(scope="module")
def one_process_runs():
    """Both packages' clustered driver in this process (one process, every
    view held), with the priorities of each insertion recorded."""
    sc, pts = _sphere()
    jc = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                             heights=sc.height)
    images = sc.render_all()
    with pytest.MonkeyPatch.context() as mp:
        jax_calls, port_calls = [], []
        _recording(jax_clustered, mp, jax_calls, 0)
        _recording(clustered, mp, port_calls, 1)
        cfg = JaxPipelineConfig()
        cfg = dataclasses.replace(
            cfg,
            optimize=dataclasses.replace(cfg.optimize,
                                         max_iterations=_ITERS),
            expand=dataclasses.replace(cfg.expand, max_rounds=_ROUNDS))
        want = jax_clustered.densify_clustered(
            JaxScene(cameras=jc, images=images, colors=None), cfg,
            seed_points=pts, halo_threshold=-1.0)
        pcfg = PipelineConfig()
        pcfg = dataclasses.replace(
            pcfg,
            optimize=dataclasses.replace(pcfg.optimize,
                                         max_iterations=_ITERS),
            expand=dataclasses.replace(pcfg.expand, max_rounds=_ROUNDS))
        got = clustered.densify_clustered(
            Scene(cameras=torch_cameras(jc), images=images, colors=None),
            pcfg, seed_points=pts, halo_threshold=-1.0,
            mesh=make_mesh(device="cpu"))
    return (np.asarray(want.patches.position), jax_calls,
            got.patches.position.numpy(), port_calls)


def test_port_matches_jax(one_process_runs):
    want, _, got, _ = one_process_runs
    radial = [float(np.median(np.abs(np.linalg.norm(p, axis=1) - 1.0)))
              for p in (want, got)]
    print(f"clustered patches: jax {len(want)}, port {len(got)}; median "
          f"radial error: jax {radial[0]:.5f}, port {radial[1]:.5f}")
    assert len(got) > 0
    assert max(radial) < 0.05
    assert abs(len(got) - len(want)) <= 0.15 * len(want)


def test_round_priorities_repeat(one_process_runs):
    """Seeds, then one exchange per expansion round; the candidate
    priorities of round 2 reuse values of round 1 (accepted ranks count
    within a round), in both packages."""
    _, jax_calls, _, port_calls = one_process_runs
    for calls in (jax_calls, port_calls):
        assert len(calls) == 1 + _ROUNDS
        assert (np.diff(calls[0]) > 0).all()  # seed indices
        assert np.intersect1d(calls[1], calls[2]).size > 0
