"""A cell of several cards on the CPU: one job of 2 gloo ranks, each
calling `densify_multihost`; a rank that fails; the readers of the
collectives' time on a canned trace."""
import json
import os
import time
from pathlib import Path

import pytest

from benchmark import device_trace, harness, ranks, scenes
from benchmark.tests import runner, tiny

SEED = 2**31 + 77


def _cell(bench: Path, name: str, chips: int, pipeline=None) -> str:
    """A cell of `chips` cards beside `tiny-grid4`, on its configuration
    (with `pipeline` merged over its settings, when given)."""
    cell = json.loads((bench / "workloads" / "tiny-grid4.json").read_text())
    cell["chips"] = chips
    if pipeline is not None:
        config = json.loads((bench / "configs" / "tiny.json").read_text())
        config["pipeline"].update(pipeline)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
        cell["config"] = name
    (bench / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return name


def _processes_naming(text: str) -> list:
    """Processes whose command line holds `text`."""
    found = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            cmdline = (entry / "cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            continue
        if text.encode() in cmdline:
            found.append(int(entry.name))
    return found


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.write_bench(tmp_path_factory.mktemp("ranks"))


def test_two_ranks_through_the_command(bench):
    name = _cell(bench, "tiny-mesh2", 2)
    rc, out, err = runner.run_main(bench, [
        "--workload", name, "--seed", str(SEED), "--seconds", "0",
        "--trace", "0"])
    assert rc == 0, "\n".join(err[-30:])
    line = runner.last_json(out)
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["count"] == 2
    assert set(line["metrics"]) == {"setup_s", "scene_s", "patches_per_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    names = list(line["checks"])
    assert [t.split()[1] for t in err[-len(names):]] == names
    assert any("multihost densify: 2 rank(s), backend gloo" in e
               for e in err)


def test_two_ranks_give_the_one_rank_cloud(bench):
    """The 2-rank job's cloud has the patches of `densify_multihost` on
    one rank in this process, on the window's capture."""
    import torch
    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.parallel.mesh import global_mesh
    from densepoints_tpu_torch.parallel.multihost import densify_multihost

    cell = harness.load_cell(_cell(bench, "tiny-mesh2t", 2), bench)
    result, checks, loaded = ranks.run_job(
        cell, SEED, 0, True, "cpu", time.perf_counter(), bench)
    assert result["correct"] is True and loaded == []
    assert result["device"]["count"] == 2
    metrics = result["metrics"]
    assert metrics["collective_s"]["value"] > 0
    assert metrics["seed_optimize_s"]["value"] > 0  # `seed_refine` there
    assert "nccl_ms" not in metrics  # no device operations on the CPU
    [verdict] = result["verdicts"]

    geo = scenes.SceneGeometry.from_config(cell["scene"])
    key = scenes.capture_keys(SEED, cell["captures"])[0]
    scene = harness._scene(scenes.make_capture(geo, key, "cpu"), "cpu")
    with torch.no_grad():
        one = densify_multihost(scene, load_config(cell["pipeline"]),
                                global_mesh("cpu"))
    assert verdict["patches"] == one.patches.capacity > 0


def test_a_failing_rank_fails_the_run(bench):
    name = _cell(bench, "tiny-broken2", 2,
                 pipeline={"profile": "no-such-profile"})
    rc, out, err = runner.run_main(bench, [
        "--workload", name, "--seed", str(SEED), "--seconds", "0",
        "--trace", "0"])
    text = "\n".join(err)
    assert rc != 0
    assert out == []
    assert "ranks: rank " in text and "failed (exit code" in text
    assert "Traceback" in text and "no-such-profile" in text
    assert _processes_naming(str(bench)) == []
    assert _processes_naming(str(Path(ranks.__file__).resolve())) == []


def _trace():
    nccl = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    device_ops = [
        ("void allview_ncc_kernel<4>(Scene, unsigned char const*, float*)",
         1.0, 2.0),
        (nccl, 2.0, 2.25),
        ("ncclDevKernel_AllReduce_Sum_i32_RING_LL(...)", 3.0, 3.1),
        (nccl, 9.9, 10.5),  # runs past the window's end
    ]
    host = [(device_trace.SCENE_SPAN, 0.5, 5.0),
            (device_trace.SCENE_SPAN, 5.0, 10.0)]
    return device_trace.Trace(device_ops, host)


def test_collective_readers():
    readers = harness.metric_readers()
    tr = _trace()
    ctx = harness.ReadContext(2, {}, {"overhead_collective_s": 0.9}, tr,
                              tr.window())
    assert readers["nccl_ms"].UNIT == "ms"
    assert readers["nccl_ms"].read(ctx) == pytest.approx(
        1e3 * (0.25 + 0.1 + 0.1) / 2)
    assert readers["collective_s"].read(ctx) == pytest.approx(0.45)
    # a run on one card: no NCCL kernel, no collective counter
    one = device_trace.Trace(tr.device_ops[:1], tr.host_spans)
    ctx = harness.ReadContext(2, {}, {"k1_rows": 5.0}, one, one.window())
    assert readers["nccl_ms"].read(ctx) is None
    assert readers["collective_s"].read(ctx) is None


def test_a_rank_ends_with_its_parent(tmp_path):
    """A rank told of a parent that is not its own exits at once."""
    import subprocess
    import sys

    work = tmp_path / "work"
    work.mkdir()
    (work / "job.json").write_text(json.dumps({"parent": os.getpid() + 1}))
    proc = subprocess.run(
        [sys.executable, str(Path(ranks.__file__)), str(work),
         "127.0.0.1:1", "2", "1", "cpu"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "is gone" in proc.stderr


@pytest.mark.parametrize("mode, number", [
    # each all-gather keeps rank 0's rows alone: the seed front end sees
    # rank 0's views alone, expansion keeps rank 0's block of each batch
    ("exchange_left_out", "completeness"),
    ("nm_unchanged", "refine_gain"),
    ("half_unscored", "photo_fail_share"),
])
def test_a_fault_on_every_rank_is_not_correct(bench, mode, number):
    from benchmark import control

    cell = harness.load_cell(_cell(bench, f"tiny-mesh2-{mode}", 2), bench)
    result, checks, _ = ranks.run_job(cell, SEED, 0, False, "cpu",
                                      time.perf_counter(), bench, mode=mode)
    assert mode in control.MODES
    assert result["correct"] is False
    assert not next(c for c in checks if c["name"] == number)["ok"]


def _temple_over_four() -> dict:
    """`temple312-grid4` (its capture, settings and limits) over a job of
    four ranks: each rank loads the cell by its name, `run_job` starts
    `chips` of them."""
    return dict(harness.load_cell("temple312-grid4"), chips=4)


@pytest.mark.cuda
def test_control_is_not_correct_over_four_cards():
    """On four cards: `python -m pytest benchmark/tests -m cuda`."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    cell = _temple_over_four()
    result, checks, _ = ranks.run_job(cell, 2**31 + 99, 4, False, "cuda",
                                      time.perf_counter(), mode="control")
    assert result["correct"] is False


@pytest.mark.cuda
def test_four_ranks_give_the_one_rank_cloud_on_the_cards():
    """On four cards, the temple's capture: `densify_multihost` over a job of
    four NCCL ranks gives the cloud of one rank, bitwise; one-card
    `densify`'s patch count beside them."""
    import torch
    from densepoints_tpu_torch.config import load_config
    from densepoints_tpu_torch.parallel.mesh import global_mesh, make_mesh
    from densepoints_tpu_torch.parallel.multihost import densify_multihost
    from densepoints_tpu_torch.pmvs.pipeline import densify

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    cell = _temple_over_four()
    geo = scenes.SceneGeometry.from_config(cell["scene"])
    scene = harness._scene(
        scenes.make_capture(geo, scenes.shared_seed(0), "cuda"), "cuda")
    config = load_config(cell["pipeline"])
    single = densify(scene, config, device="cuda").patches
    one = densify_multihost(scene, config, global_mesh("cuda")).patches
    four = densify_multihost(scene, config, make_mesh(4)).patches
    gap = ((one.position - four.position).abs().max().item()
           if one.capacity == four.capacity else None)
    print(f"[clouds] densify {single.capacity}, densify_multihost 1 rank "
          f"{one.capacity}, 4 ranks {four.capacity}; positions' largest "
          f"gap {gap}")
    assert one.capacity == four.capacity
    for name in ("position", "normal", "ref", "vis"):
        assert torch.equal(getattr(one, name), getattr(four, name)), name
