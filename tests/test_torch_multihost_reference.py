"""The four-card deployment against the plain reference, on the CPU.

`densify_multihost` over a job of 4 gloo ranks (`make_mesh(4)`, the
in-process API) on a seeded capture of the benchmark's tiny cell gives the
cloud of one rank bitwise: the row blocks, each rank's own Nelder-Mead
exit and the grids' vote over ranks change no number. That cloud is judged by the benchmark's
judge (`benchmark/judge.py` on `benchmark/reference.py`, plain torch that
imports neither JAX nor a kernel of the port) under the tiny cell's
limits (`benchmark/tests/tiny.py`), each for a reason: the stated accuracy
of one pixel footprint; completeness 0.5, as at 9 views of 240 x 180 a
sound cloud covers about two thirds of the sphere (0.66 here);
photo_fail_share 1e-3 and refine_gain 0.015, about the temple cell's 1e-3
and 0.016 (this cloud reads 0 and 0.0055); near_miss_share 1e-2, ten
times the cells', as in a cloud of ~1,200 patches one near miss alone is
~1e-3.

The benchmark's four-card cell runs templeFull under the one-card temple
cell's settings and limits, so that the two differ in the cards alone.
"""
import torch

from benchmark import harness, judge, scenes
from benchmark.tests import tiny
from densepoints_tpu_torch.config import load_config
from densepoints_tpu_torch.parallel.mesh import global_mesh, make_mesh
from densepoints_tpu_torch.parallel.multihost import densify_multihost

SEED = 2**31 + 5


def test_four_ranks_give_the_one_rank_cloud_and_it_is_correct(tmp_path):
    bench = tiny.write_bench(tmp_path)
    cell = harness.load_cell("tiny-grid4", bench)
    geo = scenes.SceneGeometry.from_config(cell["scene"])
    key = scenes.capture_keys(SEED, 1)[0]
    scene = harness._scene(scenes.make_capture(geo, key, "cpu"), "cpu")
    config = load_config(cell["pipeline"])

    one = densify_multihost(scene, config, global_mesh("cpu"))
    four = densify_multihost(scene, config, make_mesh(4, device="cpu"))
    assert four.metrics.counters["job_ranks"] == 4
    assert one.patches.capacity == four.patches.capacity > 0
    for name in ("position", "normal", "ref", "vis"):
        assert torch.equal(getattr(one.patches, name),
                           getattr(four.patches, name)), name
    for name in ("expand_candidates", "expand_accepted"):
        assert one.metrics.counters[name] == four.metrics.counters[name]

    p = four.patches
    verdicts = judge.judge_run(cell, geo, [(p.position, p.normal, p.ref,
                                            p.vis)], [scene.images], "cpu")
    checks = judge.checks(cell, verdicts)
    assert {c["name"] for c in checks} == {
        "accuracy_px", "completeness", "photo_fail_share", "near_miss_share",
        "refine_gain"}
    assert all(c["ok"] for c in checks), checks
    assert verdicts[0]["ok"]


def test_the_four_card_cell_is_the_temple_cell_on_four_cards():
    one = harness.load_cell("temple312-grid4")
    four = harness.load_cell("temple312-mesh4")
    assert (one["chips"], four["chips"]) == (1, 4)
    for key in ("scene", "pipeline", "guarantees", "captures", "limits"):
        assert four[key] == one[key], key
    node = harness._json("configs", "temple312-node4", harness.BENCH_DIR)
    temple = harness._json("configs", "temple312", harness.BENCH_DIR)
    assert node["reduced"] == temple["reduced"]
    assert node["assumed"][:4] == temple["assumed"][:4]
