"""The port's bench program (`densepoints_tpu_torch.scripts.bench`) against
the root `bench.py` of the JAX package, on the CPU.

  * The rig: the root program's `main` runs with `jax.jit` stubbed out
    (its timed loops never run) up to the construction of its sphere, and
    the arrays it drew from its one generator (refine images, cameras,
    patches, then the sphere's texture and cameras) equal
    `_rigs.bench_rig`'s bitwise.
  * The end-to-end counts: at a tiny `--config`, the port's `run` on the
    CPU against the JAX functions in the root program's own sequence
    (`create_patches_from_points` -> `filter_by_error` -> compaction ->
    `optimize_patches` -> `_densify_from` from `seeds_optimized`) on the
    same numpy inputs, the seeds moved by 1e-4 (the warm run). The
    patches after expansion and the final patches agree within 5%: batch
    shapes round the Nelder-Mead objective (ROADMAP C), so clouds are not
    compared point for point.
  * The record's keys and spreads (min <= median <= max over the runs),
    and `--out` as the only file the program writes.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from densepoints_tpu.config import load_config as jax_load_config
from densepoints_tpu.core.cameras import Cameras as JaxCameras
from densepoints_tpu.io.scene import Scene as JaxScene
from densepoints_tpu.pmvs.optimize import (
    filter_by_error as jax_filter_by_error,
    optimize_patches as jax_optimize_patches,
)
from densepoints_tpu.pmvs.patch import PatchState as JaxPatchState
from densepoints_tpu.pmvs.pipeline import _densify_from as jax_densify_from
from densepoints_tpu.pmvs.seed import (
    create_patches_from_points as jax_create_patches,
)
from densepoints_tpu.utils import StageMetrics as JaxStageMetrics
from densepoints_tpu_torch.scripts import (
    _rigs,
    _scene_runs,
    bench,
    prescreen_ab,
)
from tests import torch_port_util  # noqa: F401  (torch threads)

COUNT_RTOL = 0.05  # patches after expansion and final, port vs JAX
REPO = Path(__file__).resolve().parents[1]

# The refine rig cut to 4 views of 60 x 80 and 32 patches; the sphere at
# 12 views of 256 x 192, half the bench focal length, 1 round: a few
# hundred patches after expansion.
TINY_CONFIG = {"refine_views": 4, "refine_height": 60, "refine_width": 80,
               "refine_patches": 32, "refine_nm_iters": 5, "refine_runs": 3,
               "kernel_reps": 3, "views": 12, "width": 256, "height": 192,
               "focal": 225, "tex_size": 512, "seeds": 500, "max_rounds": 1,
               "nm_iters": 15, "expand_nm_iters": 10, "warm_runs": 2}


class _Stop(Exception):
    """Ends the root program once its inputs are drawn."""


def test_rig_is_bench_py_bitwise():
    import bench as root_bench

    drawn = {}
    jit = jax.jit

    def stub(fn=None, **kw):
        """The root program's two timed loops (`run`, `krun`) record their
        operands and return 0; any other function is jitted."""
        if getattr(fn, "__name__", "") in ("run", "krun"):
            return lambda *a: drawn.setdefault(fn.__name__, a) and 0.0
        return jit(fn, **kw)

    make_cams = JaxCameras.from_projection_matrices.__func__
    make_state = JaxPatchState.create.__func__
    synthetic = _scene_runs.synthetic()
    sphere_class = synthetic.TexturedSphereScene

    def stop(rng, **kw):
        drawn["sphere"] = sphere_class(rng, **kw)
        raise _Stop

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax, "jit", stub)
        m.setattr(JaxCameras, "from_projection_matrices", classmethod(
            lambda cls, P, **kw: drawn.setdefault("P", []).append(
                np.asarray(P)) or make_cams(cls, P, **kw)))
        m.setattr(JaxPatchState, "create", classmethod(
            lambda cls, *a: drawn.setdefault("state", a)
            and make_state(cls, *a)))
        m.setattr(synthetic, "TexturedSphereScene", stop)
        with pytest.raises(_Stop):
            root_bench.main()

    (P, images, pos, nrm, ref, vis), sphere = _rigs.bench_rig()
    assert np.array_equal(np.asarray(drawn["run"][0]), images)
    assert np.array_equal(drawn["P"][0], P)
    for want, got in zip(drawn["state"], (pos, nrm, ref, vis)):
        assert np.array_equal(np.asarray(want), got)
    assert np.array_equal(drawn["sphere"].texture, sphere.texture)
    assert np.array_equal(drawn["sphere"].P, sphere.P)
    # The sphere's texture is not the fresh generator's of `sphere_scene`.
    fresh = _rigs.sphere_generator(np.random.default_rng(0))
    assert not np.array_equal(fresh.texture, sphere.texture)


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    """The port's run at the tiny config through `main`, from an empty
    working directory: (record, the --out path, the working directory)."""
    import contextlib
    import io
    import os

    work = tmp_path_factory.mktemp("cwd")
    out = tmp_path_factory.mktemp("out") / "bench.json"
    root_before = sorted(p.name for p in REPO.iterdir())
    here = os.getcwd()
    os.chdir(work)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            assert bench.main(["--device", "cpu", "--out", str(out),
                               "--config", json.dumps(TINY_CONFIG)]) == 0
    finally:
        os.chdir(here)
    assert sorted(p.name for p in REPO.iterdir()) == root_before
    lines = printed.getvalue().splitlines()
    early = json.loads(next(line for line in lines if "early line" in line))
    last = json.loads(lines[-1])
    assert early["refine_patches_per_sec"] == last["refine_patches_per_sec"]
    return last, out, work


def jax_warm_run(c):
    """The root program's warm run on the port's rig at `c`: (after
    expand, final)."""
    _, sc = _rigs.bench_rig(
        num_views=c["refine_views"], H=c["refine_height"],
        W=c["refine_width"], B=c["refine_patches"],
        sphere=bench.sphere_sizes(c))
    images = sc.render_all()
    cfg = jax_load_config(prescreen_ab.config_dict(c, "off"))
    cams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)
    scene = JaxScene(cameras=cams, images=images, colors=None)
    dimages = jnp.asarray(images)
    seeds = _rigs.sphere_seeds(c["seeds"]) + bench.JITTER
    st = jax_create_patches(cams, seeds, cfg.optimize, cfg.seed)
    st = jax_filter_by_error(dimages, cams, st, cfg.seed.texture_size,
                             cfg.optimize).compact()
    st = jax_optimize_patches(dimages, cams, st, cfg.seed.texture_size,
                              cfg.optimize)
    metrics = JaxStageMetrics()
    res = jax_densify_from(dimages, cams, scene, cfg, metrics, st,
                           "seeds_optimized")
    return {"patches_after_expand":
            int(metrics.counters["patches_after_expand"]),
            "densify_patches_final": res.patches.capacity}


@pytest.fixture(scope="module")
def jax_counts():
    return jax_warm_run(bench.parse_args(
        ["--config", json.dumps(TINY_CONFIG)]).config)


@pytest.mark.parametrize("count", ["patches_after_expand",
                                   "densify_patches_final"])
def test_counts_match_jax(record, jax_counts, count):
    got, want = record[0][count], jax_counts[count]
    assert want > 50
    assert abs(got - want) <= COUNT_RTOL * want, (got, want)


def test_record(record):
    rec = record[0]
    for key in ("refine_patches_per_sec", "refine_seconds",
                "e2e_patches_per_sec", "densify_seconds"):
        s = rec[key]
        assert s["min"] <= s["median"] <= s["max"], (key, s)
        assert s["min"] > 0 and np.isfinite(s["max"])
    assert len(rec["refine_seconds"]["runs"]) == TINY_CONFIG["refine_runs"]
    assert len(rec["densify_seconds"]["runs"]) == TINY_CONFIG["warm_runs"]
    assert rec["patches_final_runs"][0] == rec["densify_patches_final"]
    for key in ("kernel_ms_per_pass", "kernel_ms_per_pass_1call",
                "kernel_slot_scores_per_sec", "kernel_bound_ms",
                "kernel_bound_share", "densify_cold_seconds",
                "median_radial_error"):
        assert np.isfinite(rec[key]) and rec[key] > 0, key
    # 4 views, view 0 never visible: 3 payload slots and an anchor each.
    assert rec["kernel_slots"] == 4 * TINY_CONFIG["refine_patches"]
    assert rec["kernel_bound_by"] in ("bytes", "operations")
    assert rec["median_radial_error"] < 1.5
    assert set(rec["stage_seconds"]) >= {"expand", "filter"}
    assert all(len(v) == TINY_CONFIG["warm_runs"]
               for v in rec["stage_seconds"].values())
    # The CPU: plain scoring calls, no launch, no profiled run.
    assert rec["launches"]["allview_ncc"] == 0 and rec["plain_calls"] > 0
    assert rec["allview_ncc_launches_by_section"] == {
        "refine": 0, "kernel": 0, "e2e": 0}
    assert rec["device"] == "cpu" and "device_busy_share" not in rec


def test_out_is_the_only_file_written(record):
    rec, out, work = record
    assert list(work.iterdir()) == []
    assert list(out.parent.iterdir()) == [out]
    assert json.loads(out.read_text()) == rec


def test_no_record_without_out(monkeypatch, tmp_path, capsys):
    """`emit` without `--out` prints and writes nothing."""
    monkeypatch.chdir(tmp_path)
    _scene_runs.emit({"program": "bench"}, "")
    assert json.loads(capsys.readouterr().out) == {"program": "bench"}
    assert list(tmp_path.iterdir()) == []


def test_config_rejects_unknown_keys():
    with pytest.raises(SystemExit):
        bench.parse_args(["--config", json.dumps({"patches": 1})])

