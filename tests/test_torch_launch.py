"""The port's job set-up over several cards: the rank plan, the CLI's
launcher and its process logic, on the CPU.

  * `plan_ranks` over fake rank tables: each rank's card is its position
    among its host's ranks modulo its process's cards, and the backend is
    NCCL exactly when the chosen cards (by UUID) are distinct;
  * `ranks_per_process`: the cards a process sees (the first
    `parallel.num_devices` of them in a job of one process), or
    `parallel.num_devices` on the CPU, as the JAX side's forced host
    device count; `make_mesh(n)` outside a job spans as many ranks;
  * one `--distributed` process with `parallel.num_devices` 2 on the CPU
    runs 2 gloo ranks and writes the PLY of the hand-started 2-rank job
    of `test_torch_multihost.py`, bitwise;
  * a child that fails makes the parent exit non-zero, with no child left;
    processes that drive unequal numbers of ranks all raise.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from densepoints_tpu_torch import cli
from densepoints_tpu_torch.io import read_ply
from densepoints_tpu_torch.parallel import launch
from densepoints_tpu_torch.parallel.mesh import (
    global_mesh,
    make_mesh,
    plan_ranks,
)
from tests.test_torch_multihost import plane_scene_json  # noqa: F401
from tests.test_torch_scaling_programs import _running
from tests.torch_parallel_util import ONE_THREAD, run_job

ROOT = Path(__file__).resolve().parents[1]


def _table(hosts, uuids, per_process=1):
    return [{"host": h, "uuids": u, "per_process": per_process}
            for h, u in zip(hosts, uuids)]


def _cards(host, n=4):
    return [f"{host}-card{i}" for i in range(n)]


# (table, device type, cards per rank, backend); None: raises.
PLANS = {
    "contiguous 2 hosts x 4 cards": (
        _table(["a"] * 4 + ["b"] * 4, [_cards("a")] * 4 + [_cards("b")] * 4,
               per_process=4),
        "cuda", [0, 1, 2, 3, 0, 1, 2, 3], "nccl"),
    "round-robin 2 hosts x 4 cards": (
        _table(["a", "b"] * 4, [_cards("a"), _cards("b")] * 4),
        "cuda", [0, 0, 1, 1, 2, 2, 3, 3], "nccl"),
    "4 ranks each seeing its own card": (
        _table(["a"] * 4, [[f"a-card{i}"] for i in range(4)]),
        "cuda", [0, 0, 0, 0], "nccl"),
    "2 ranks on one card": (
        _table(["a"] * 2, [["a-card0"]] * 2), "cuda", [0, 0], "gloo"),
    "8 ranks on a host of 4 cards": (
        _table(["a"] * 8, [_cards("a")] * 8),
        "cuda", [0, 1, 2, 3, 0, 1, 2, 3], "gloo"),
    "cpu": (_table(["a"] * 4, [[]] * 4, per_process=2), "cpu",
            [None] * 4, "gloo"),
    "hosts that see unequal L": (
        _table(["a"] * 4, [_cards("a")] * 4, per_process=4)
        + _table(["b"] * 2, [_cards("b", 2)] * 2, per_process=2),
        "cuda", None, None),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_ranks(case):
    table, kind, cards, backend = PLANS[case]
    if cards is None:
        with pytest.raises(ValueError, match="same number of cards"):
            plan_ranks(table, kind)
        return
    assert plan_ranks(table, kind) == (cards, backend)


# (device, cards seen, --num-processes, parallel.num_devices, L)
WIDTHS = [
    ("cuda", 4, None, 0, 4),
    ("cuda", 4, None, 2, 2),
    ("cuda", 4, None, 8, 4),
    ("cuda", 4, 2, 2, 4),
    ("cuda", 1, None, 0, 1),
    ("cpu", 4, None, 0, 1),
    ("cpu", 0, 2, 3, 3),
]


@pytest.mark.parametrize("device,cards,nproc,num_devices,want", WIDTHS)
def test_ranks_per_process(monkeypatch, device, cards, nproc, num_devices,
                           want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv(launch.CHILD_ENV, raising=False)
    assert launch.ranks_per_process(device, nproc, num_devices) == want
    monkeypatch.setenv(launch.CHILD_ENV, str(want))
    assert launch.ranks_per_process(device, nproc, num_devices) == 1


# (device, cards seen, num_devices, L): JAX's `make_mesh(n)` takes
# `devices[:n]`, every device for None or 0; the CPU gives n ranks.
MESHES = [
    ("cuda", 4, None, 4),
    ("cuda", 4, 0, 4),
    ("cuda", 4, 2, 2),
    ("cuda", 4, 8, 4),
    ("cuda", 1, 4, 1),
    ("cuda", 1, None, 1),
    ("cuda", 0, 2, 1),
    ("cpu", 4, None, 1),
    ("cpu", 0, 1, 1),
    ("cpu", 0, 2, 2),
    ("cpu", 4, 3, 3),
]


@pytest.mark.parametrize("device,cards,n,want", MESHES)
def test_make_mesh_outside_a_job(monkeypatch, device, cards, n, want):
    """Outside a job `make_mesh(n)` spans L ranks, by the rule of
    `launch.ranks_per_process`: L = 1 is this process's world-size-1 mesh,
    L > 1 a mesh of L ranks not yet started (backend "local") on the
    first card or the CPU, which the job-level entry points start."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv(launch.CHILD_ENV, raising=False)
    mesh = make_mesh(n, device=device)
    assert mesh.world_size == want and mesh.rank == 0
    if want == 1:
        assert mesh == global_mesh(device) and mesh.backend == "none"
        assert mesh.started
    else:
        assert mesh.backend == "local" and not mesh.started
        assert mesh.device == (torch.device("cuda", 0) if device == "cuda"
                               else torch.device("cpu"))
    assert global_mesh(device).world_size == 1


def test_a_job_of_several_processes_needs_a_coordinator(plane_scene_json):
    d = plane_scene_json
    with pytest.raises(ValueError, match="coordinator"):
        cli.main(["-i", str(d / "scene.json"), "--device", "cpu",
                  "--distributed", "--num-processes", "2"])


def _launched_argv(d, tmp_path, out):
    settings = json.loads((d / "settings.json").read_text())
    settings["parallel"] = {"num_devices": 2}
    path = tmp_path / "settings_two.json"
    path.write_text(json.dumps(settings))
    return ["-i", str(d / "scene.json"), "-s", str(path), "--device", "cpu",
            "--distributed", "-o", str(out), "--ascii"]


def test_one_process_drives_two_cpu_ranks(plane_scene_json, tmp_path,
                                          monkeypatch):
    """`--distributed` with `parallel.num_devices` 2 starts 2 gloo ranks,
    and rank 0 writes the PLY of the hand-started 2-rank job (one thread
    a rank in both), bitwise."""
    d = plane_scene_json
    hand = tmp_path / "hand"
    hand.mkdir()
    run_job("cli", 2, {"argv": np.asarray(
        ["-i", str(d / "scene.json"), "-s", str(d / "settings.json"),
         "--device", "cpu", "--distributed",
         "-o", str(hand / "cloud_{rank}.ply"), "--ascii"])}, tmp_path)
    launched = tmp_path / "launched"
    launched.mkdir()
    for key, value in ONE_THREAD.items():
        monkeypatch.setenv(key, value)
    assert cli.main(_launched_argv(d, tmp_path,
                                   launched / "cloud.ply")) == 0
    assert [p.name for p in launched.iterdir()] == ["cloud.ply"]
    got = (launched / "cloud.ply").read_bytes()
    assert len(read_ply(launched / "cloud.ply")["positions"]) >= 20
    assert got == (hand / "cloud_0.ply").read_bytes()


def test_a_failed_child_stops_the_job(plane_scene_json, tmp_path,
                                      monkeypatch):
    """Rank 0 fails to write its PLY where a directory is, while rank 1
    waits for it: the parent exits non-zero and no child is left
    running."""
    for key, value in ONE_THREAD.items():
        monkeypatch.setenv(key, value)
    marker = f"launch_fails_{os.getpid()}"
    out = tmp_path / marker
    out.mkdir()
    t0 = time.monotonic()
    rc = cli.main(_launched_argv(plane_scene_json, tmp_path, out))
    assert rc != 0
    assert time.monotonic() - t0 < 120
    assert _running(marker) == []


@pytest.mark.parametrize("fail", [True, False], ids=["one fails", "all pass"])
def test_run_processes_kills_the_rest(fail):
    """The first process to exit non-zero stops the job: the others are
    killed (negative codes) and none is left running."""
    marker = f"run_processes_{os.getpid()}_{fail}"
    sleeper = [sys.executable, "-c",
               f"import time; time.sleep(0 if {not fail} else 600)  # "
               + marker]
    failing = [sys.executable, "-c", f"import sys; sys.exit({3 * fail})"]
    t0 = time.monotonic()
    first, codes = launch.run_processes([sleeper, failing], timeout=120)
    assert time.monotonic() - t0 < 60
    if fail:
        assert (first, codes[1]) == (1, 3) and codes[0] < 0
    else:
        assert (first, codes) == (None, [0, 0])
    assert _running(marker) == []


_JOIN = """
import sys
from densepoints_tpu_torch.parallel import mesh
addr, world, rank, width = sys.argv[1], *map(int, sys.argv[2:5])
mesh.initialize_multihost(addr, world, rank, device="cpu",
                          ranks_per_process=width)
"""


def test_unequal_widths_raise_on_every_rank(tmp_path):
    """A process driving 2 ranks (ranks 0 and 1 of 4) and one driving 1
    (rank 1 of 2) in one job: every rank raises, none hangs."""
    addr = launch.loopback_address()
    env = dict(os.environ, **launch.LOOPBACK_ENV,
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JOIN, addr, str(world), str(rank),
         str(width)], env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for world, rank, width in ((4, 0, 2), (4, 1, 2), (2, 1, 1))]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode != 0
        assert "same number of cards" in out, out[-2000:]
