"""The port's scaling programs (`densepoints_tpu_torch.scripts.
scaling_overhead`, `scaling_measure` with `scaling_worker`, and
`scaling_bench`) on the CPU, against the JAX package.

The JAX programs' `main` is never called: they write into the working
directory. The JAX side runs in this process on the conftest's CPU mesh;
the port's jobs run as gloo processes of one or two threads each.

Tolerances: the overhead model equals `scripts/scaling_overhead.py:77-92`'s
arithmetic to 1e-12 on fixed counters; `scaling_overhead` and the JAX
`densify_multihost` on one device end with final patch counts within 5%
(batch shapes round the Nelder-Mead objective, ROADMAP C); N = 2 workers
give rank 0 the same final patches as N = 1 (the driver's result does not
depend on the number of ranks); `scaling_bench`'s refined positions agree
within 1e-5 between 1 and 2 ranks and within 1e-3 of the JAX
`distributed_refine_step` (the tolerance of `test_torch_distributed.py`).
"""
import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from densepoints_tpu.config import OptimizeConfig as JaxOptimizeConfig
from densepoints_tpu.config import load_config as jax_load_config
from densepoints_tpu.core.cameras import Cameras as JaxCameras
from densepoints_tpu.io.scene import Scene as JaxScene
from densepoints_tpu.parallel import distributed_refine_step as jax_refine
from densepoints_tpu.parallel.mesh import make_mesh as jax_make_mesh
from densepoints_tpu.parallel.multihost import (
    densify_multihost as jax_densify_multihost,
)
from densepoints_tpu_torch.scripts import (
    _jobs,
    _scene_runs,
    scaling_bench,
    scaling_measure,
    scaling_overhead,
    scaling_worker,
)
from tests import torch_port_util  # noqa: F401  (torch threads)

ROOT = Path(__file__).resolve().parents[1]
MODEL_ATOL = 1e-12  # the overhead model, port vs the JAX arithmetic
COUNT_RTOL = 0.05  # final patches, port vs JAX
RANKS_ATOL = 1e-5  # refined positions, 2 ranks vs 1 rank
JAX_ATOL = 1e-3  # refined positions, port vs JAX

# 5 views of 160 x 120, 2 rounds of 10 Nelder-Mead iterations.
SCENE = {"views": 5, "width": 160, "height": 120}
OVERHEAD_TINY = ["--device", "cpu", "--seeds", "400", "--rounds", "2",
                 "--nm-iters", "10", "--config", json.dumps(SCENE)]
MEASURE_TINY = ["--device", "cpu", "--seeds", "200", "--config", json.dumps(
    {**SCENE, "nprocs": [1, 2], "rounds": 2, "nm_iters": 10,
     "total_threads": 2})]
BENCH_TINY = ["--device", "cpu", "--ranks", "1,2", "--config", json.dumps(
    {"patches": 48, "nm_iters": 5, "threads": 1})]


def jax_script(name):
    """A module of the JAX package's `scripts/`, under its own name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_model(times, counters, rounds, dcn):
    """`scripts/scaling_overhead.py:77-92` on a run's numbers."""
    host_sync = float(counters.get("overhead_host_sync_s", 0.0))
    coll_bytes = int(counters.get("overhead_collective_bytes", 0))
    t_expand = float(times.get("expand", 0.0))
    t_device_round = max(t_expand - host_sync, 1e-9) / max(rounds, 1)
    t_fixed_round = host_sync / max(rounds, 1) + (
        coll_bytes / max(rounds, 1)
    ) / dcn

    def eff(N):
        return t_device_round / (t_device_round + N * t_fixed_round)

    return t_device_round, t_fixed_round, {n: eff(n) for n in (2, 4, 8)}


@pytest.mark.parametrize("times,counters,rounds", [
    ({"expand": 42.596}, {"overhead_host_sync_s": 1.4853,
                          "overhead_collective_bytes": 2744320}, 3),
    ({"expand": 0.7153}, {"overhead_host_sync_s": 0.0022,
                          "overhead_collective_bytes": 0}, 3),
    ({"expand": 0.001}, {"overhead_host_sync_s": 0.5,
                         "overhead_collective_bytes": 10**9}, 1),
    ({}, {}, 0),
])
def test_overhead_model_is_the_jax_arithmetic(times, counters, rounds):
    dcn = jax_script("scaling_overhead").DCN_BYTES_PER_S
    assert dcn == scaling_overhead.LINK_BYTES_PER_S
    t_device, t_fixed, eff = jax_model(times, counters, rounds, dcn)
    got = scaling_overhead.overhead_model(times, counters, rounds, dcn)
    per_round = got["per_round"]
    assert abs(per_round["device_seconds"] - t_device) <= MODEL_ATOL
    assert abs(per_round["fixed_seconds"] - t_fixed) <= MODEL_ATOL
    for n, value in eff.items():
        assert abs(got["predicted_efficiency"][f"{n}_hosts"] - value) \
            <= MODEL_ATOL


def test_scaling_overhead_matches_jax():
    args = scaling_overhead.parse_args(OVERHEAD_TINY)
    record = scaling_overhead.run(args)
    sc = _scene_runs.synthetic().TexturedPlaneScene(
        np.random.default_rng(0), num_views=SCENE["views"],
        width=SCENE["width"], height=SCENE["height"])
    cams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)
    cfg = jax_load_config({"expand": {"max_rounds": args.rounds},
                           "optimize": {"max_iterations": args.nm_iters}})
    want = jax_densify_multihost(
        JaxScene(cameras=cams, images=sc.render_all(), colors=None), cfg,
        mesh=jax_make_mesh(1),
        seed_points=scaling_overhead.grid_seeds(args.seeds))
    final = want.patches.capacity
    assert final > 50
    assert abs(record["patches"] - final) <= COUNT_RTOL * final
    # The JAX counters, and the port's two more: the collectives' calls
    # and seconds (`MeshTraffic`).
    extra = set(record["counters"]) - set(want.metrics.counters)
    assert set(want.metrics.counters) <= set(record["counters"])
    assert extra == {"overhead_collective_calls", "overhead_collective_s"}
    assert record["mesh_ranks"] == 1
    assert record["model"]["link_bytes_per_s"] == 12.5e9
    assert record["model"]["per_round"]["device_seconds"] > 0


def test_scaling_measure_one_and_two_workers(tmp_path):
    args = scaling_measure.parse_args(
        MEASURE_TINY + ["--work-dir", str(tmp_path)])
    record = scaling_measure.run(args)
    one, two = record["measured"]
    assert (one["nproc"], two["nproc"]) == (1, 2)
    for n in (1, 2):
        for rank in range(n):
            worker = json.loads(
                (tmp_path / f"worker_{n}_{rank}.json").read_text())
            assert worker["rank"] == rank and worker["nproc"] == n
            assert worker["threads"] == 2 // n
    assert one["patches_final"] == two["patches_final"] > 20
    assert two["patches_per_rank"] == [two["patches_final"]] * 2
    assert two["counters"]["overhead_collective_calls"] > 0
    assert one["fixed_cost_vs_first_seconds"] == 0.0
    assert record["plain_calls"] > 0 and record["device"] == "cpu"


def test_worker_seeds_are_the_jax_workers():
    """`scripts/scaling_worker.py:54-64`'s sparse seeding."""
    n = 2500
    g = np.linspace(-0.7, 0.7, int(np.ceil(np.sqrt(n))))
    gx, gy = np.meshgrid(g, g)
    step = max(1, gx.size // n)
    want = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], 1)[
        ::step][:n].astype(np.float32)
    np.testing.assert_array_equal(scaling_worker.sparse_seeds(n), want)


def test_grid_seeds_are_the_jax_programs():
    """`scripts/scaling_overhead.py:57-62`'s seed grid."""
    n = 50_000
    side = int(np.ceil(np.sqrt(n)))
    g = np.linspace(-0.75, 0.75, side)
    gx, gy = np.meshgrid(g, g)
    want = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)],
                    1).astype(np.float32)[:n]
    np.testing.assert_array_equal(scaling_overhead.grid_seeds(n), want)


def test_scaling_bench_ranks_agree_and_match_jax(tmp_path):
    args = scaling_bench.parse_args(BENCH_TINY + ["--work-dir", str(tmp_path)])
    record = scaling_bench.run(args)
    assert [r["ranks"] for r in record["measured"]] == [1, 2]
    assert record["scaling_efficiency"] is None  # CPU ranks share threads
    one = np.load(tmp_path / "refined_1.npy")
    two = np.load(tmp_path / "refined_2.npy")
    np.testing.assert_allclose(two, one, rtol=0, atol=RANKS_ATOL)

    images, cams, state = jax_script("scaling_bench")._problem(
        args.config["patches"])
    moved = dataclasses.replace(state, position=state.position + 1e-4)
    want = jax_refine(jnp.asarray(images), cams, moved, 11,
                      JaxOptimizeConfig(
                          max_iterations=args.config["nm_iters"]))
    np.testing.assert_allclose(one, np.asarray(want.position), rtol=0,
                               atol=JAX_ATOL)
    assert not np.array_equal(one, np.asarray(state.position) + 1e-4)


def _running(marker: str) -> list[int]:
    """Pids of live processes whose command line holds `marker`."""
    pids = []
    for proc in Path("/proc").iterdir():
        try:
            cmd = (proc / "cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            continue
        if proc.name.isdigit() and marker.encode() in cmd:
            pids.append(int(proc.name))
    return pids


@pytest.mark.parametrize("case", ["a rank fails", "the job overruns"])
def test_a_failed_job_leaves_no_worker(tmp_path, case):
    """A rank that exits non-zero, or a job past its time limit, fails the
    run with the rank's log, and every process of the job is killed: here
    rank 0 waits for a peer that never joins."""
    marker = json.dumps({"seeds": 4000 + len(case)})

    def rank_args(rank, port):
        if case == "a rank fails" and rank == 1:
            return ["--no-such-flag"]
        # A job of 3 of which 2 start: they wait for a peer that never joins.
        return ["--rank", rank, "--world", 3, "--port", port,
                "--device", "cpu", "--config", marker]

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1/2 failed|outlived"):
        _jobs.run_ranks(scaling_measure.WORKER, 2, rank_args, tmp_path,
                        timeout=10.0)
    assert time.monotonic() - t0 < 60
    assert _running(marker) == []
