"""A configuration, a traffic mix, a cell and a per-layer metric added by
writing new files only, found by name and run by the harness."""
import json

import pytest

from benchmark import harness
from benchmark.tests import runner, tiny

READER = '''
UNIT = "s"


def read(ctx):
    return ctx.stage_s["seed"] + ctx.stage_s["expand"]
'''


def test_the_repository_cells_load():
    from benchmark import judge

    for cell in ("dtu49-grid4", "temple312-grid4", "dtu49-grid8"):
        spec = harness.load_cell(cell)
        assert spec["chips"] == 1 and spec["captures"] > 0
        assert {"photo_fail_share", "near_miss_share"} <= set(spec["limits"])
        assert set(spec["limits"]) <= set(judge.NUMBERS)
        assert set(spec["limits"]) & {"refine_gain", "normal_gain"}
    g4 = harness.load_cell("dtu49-grid4")["pipeline"]
    g8 = harness.load_cell("dtu49-grid8")["pipeline"]
    assert g4["organizer"]["grid_scale"] == 4
    assert g8["organizer"]["grid_scale"] == 8
    assert g4["expand"] == g8["expand"] == {"max_rounds": 20,
                                            "max_iterations": 40}
    t = harness.load_cell("temple312-grid4")
    assert t["scene"]["views"] == 312 and t["pipeline"]["expand"][
        "max_rounds"] == 12
    assert t["scene"]["layout"] == "hemisphere"


def test_names_are_checked(tmp_path):
    with pytest.raises(ValueError):
        harness.load_cell("../configs/dtu49", tmp_path)
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no-such-cell")


def test_new_files_make_a_new_cell_and_metric(tmp_path):
    bench = tiny.write_bench(tmp_path)
    (bench / "traffic" / "sparse.json").write_text(json.dumps(
        {"pipeline": {"organizer": {"grid_scale": 8},
                      "expand": {"max_rounds": 1}}}))
    (bench / "workloads" / "tiny-sparse.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "sparse", "chips": 1,
         "limits": {"photo_fail_share": 0.001, "near_miss_share": 0.01}}))
    (bench / "metrics" / "seed_and_expand_s.py").write_text(READER)
    spec = harness.load_cell("tiny-sparse", bench)
    assert spec["pipeline"]["organizer"]["grid_scale"] == 8
    assert spec["pipeline"]["expand"]["max_rounds"] == 1
    assert spec["pipeline"]["matching"]["max_keypoints_per_view"] == 512
    assert "seed_and_expand_s" in harness.metric_readers(bench)

    rc, out, err = runner.run_main(bench, [
        "--workload", "tiny-sparse", "--seed", str(2**32 + 3),
        "--seconds", "0", "--trace", "1"])
    assert rc == 0, "\n".join(err[-20:])
    line = runner.last_json(out)
    metrics = line["metrics"]
    assert metrics["seed_and_expand_s"]["unit"] == "s"
    assert metrics["seed_and_expand_s"]["value"] == pytest.approx(
        metrics["seed_s"]["value"] + metrics["expand_s"]["value"])
    # no device operations on the CPU: the trace readers find nothing
    assert "k1_ms" not in metrics and "device_idle_share" not in metrics
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
