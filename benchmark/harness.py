"""The benchmark of the PyTorch/CUDA port: one cell, one run.

A cell (`workloads/<cell>.json`) names a configuration
(`configs/<name>.json`: the capture's sizes under "scene", the pipeline
settings under "pipeline", the guarantees the cloud is held to), a
traffic mix (`traffic/<name>.json`: overrides of the pipeline settings,
such as the density of the cloud) and the cards it takes (`chips`).
Per-layer metrics are readers (`metrics/<name>.py`, a `read(ctx)` that
returns a number or None). The harness finds all of them by name, so a
cell, a configuration or a metric is added by adding files.

A run: set-up (the program and its kernels, one warm-up call on a scene
of its own, then the cell's `captures` scenes rendered on the device and
handed over as host arrays, as the CLI's loader hands them), then the
window: one call after another, in an order drawn from the seed, starting
a scene while time remains. `captures` is what a window completes today,
so every run does nearly the same work; a window that outruns it starts
the set again and says so on standard error. Then the plain reference
judges every cloud of the window. A one-card cell calls
`densepoints_tpu_torch.pmvs.pipeline.densify` in this process
(`run_cell`); a cell of several cards runs the same steps on every rank
of a job, calling `densepoints_tpu_torch.parallel.multihost
.densify_multihost` (`ranks.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "densepoints_tpu")


def _named(kind: str, name: str, bench_dir: Path, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a {kind} name: {name!r}")
    path = bench_dir / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r} ({path})")
    return path


def _json(kind, name, bench_dir):
    with open(_named(kind, name, bench_dir, ".json")) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v)
                  if isinstance(v, dict) and isinstance(out.get(k), dict)
                  else v)
    return out


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell's files, with the pipeline settings the traffic sets
    merged over the configuration's."""
    cell = _json("workloads", name, bench_dir)
    config = _json("configs", cell["config"], bench_dir)
    traffic = _json("traffic", cell["traffic"], bench_dir)
    return {
        "name": name,
        "chips": int(cell.get("chips", 1)),
        "captures": int(cell.get("captures", 0)),
        "limits": cell.get("limits", {}),
        "scene": config["scene"],
        "guarantees": config["guarantees"],
        "pipeline": _merge(config["pipeline"], traffic.get("pipeline", {})),
    }


def metric_readers(bench_dir: Path = BENCH_DIR) -> dict:
    """{name: module} of every reader under metrics/ (its `UNIT` and
    `read(ctx)`), sorted by name."""
    readers = {}
    for path in sorted((bench_dir / "metrics").glob("*.py")):
        if not NAME.match(path.stem) or path.stem.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"_bench_metric_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        readers[path.stem] = module
    return readers


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of `FORBIDDEN`, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


class ReadContext:
    """What a per-layer reader reads, over the traced window.

    scenes: scenes completed; stage_s: each `StageMetrics` stage's seconds
    summed over them; counters: their counters summed; trace: the
    `device_trace.Trace`; window: its (start, end) in seconds."""

    def __init__(self, scenes, stage_s, counters, trace, window):
        self.scenes = scenes
        self.stage_s = stage_s
        self.counters = counters
        self.trace = trace
        self.window = window

    def device_seconds(self, *names) -> float | None:
        """Device seconds of operations whose name contains one of
        `names`, inside the window; None if there is none."""
        lo, hi = self.window
        found, total = False, 0.0
        for name, s, e in self.trace.device_ops:
            if any(n in name for n in names):
                found = True
                total += max(0.0, min(e, hi) - max(s, lo))
        return total if found else None


def _scene(capture, device):
    from densepoints_tpu_torch.core.cameras import Cameras
    from densepoints_tpu_torch.io.scene import Scene

    V, H, W = capture.images.shape
    cams = Cameras.from_projection_matrices(capture.P, widths=W, heights=H,
                                            device=device)
    return Scene(cameras=cams, images=capture.images.cpu().numpy(),
                 colors=None)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def set_up(cell: dict, seed: int, device, call):
    """Set-up: the kernels build (once per checkout), then the first
    call's one-time work happens in the warm-up, `call(scene, config)` on
    a scene no timed call sees; then the cell's captures are rendered on
    `device` and handed over as host arrays. Returns (geometry, config,
    pool, warm-up seconds)."""
    import torch
    from densepoints_tpu_torch.config import load_config

    from benchmark import scenes

    geo = scenes.SceneGeometry.from_config(cell["scene"])
    config = load_config(cell["pipeline"])
    if torch.device(device).type == "cuda":
        from densepoints_tpu_torch.ops import _build

        _build.build_library()
    warm = scenes.make_capture(geo, scenes.scene_seed(seed, 0), device)
    t_warm = time.perf_counter()
    call(_scene(warm, device), config)
    _sync(device)
    t_warm = time.perf_counter() - t_warm
    del warm
    n_pool = max(1, cell["captures"])
    pool = [_scene(scenes.make_capture(geo, key, device), device)
            for key in scenes.capture_keys(seed, n_pool)]
    _sync(device)
    gc.collect()
    return geo, config, pool, t_warm


@dataclasses.dataclass
class Window:
    """What the measured window gave: each scene's cloud (position,
    normal, ref, vis) and host images, each scene's end (seconds from the
    window's start), the stages' seconds and the counters summed over the
    scenes, the set-up's seconds, and the stopped profiler (None
    untraced)."""

    outputs: list = dataclasses.field(default_factory=list)
    images: list = dataclasses.field(default_factory=list)
    ends: list = dataclasses.field(default_factory=list)
    stage_s: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    prof: object = None


def measure(pool, config, call, seconds: float, trace: bool, device,
            t_process: float, t_warm: float,
            window=contextlib.nullcontext, go=bool) -> Window:
    """The window: `call(scene, config)` on one scene of `pool` after
    another, in the pool's order, starting a scene while time remains;
    `go(more)` has the last word on whether another starts (a job's rank
    0 decides for every rank). Traced under `torch.profiler` when
    `trace`."""
    import torch

    from benchmark import device_trace

    n_pool = len(pool)
    win = Window()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        win.prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        win.prof.start()
    outputs, ends = win.outputs, win.ends
    t_start = time.perf_counter()
    win.setup_s = t_start - t_process
    with window():
        while go(not outputs or time.perf_counter() - t_start < seconds):
            scene = pool[len(outputs) % n_pool]
            with torch.profiler.record_function(device_trace.SCENE_SPAN):
                res = call(scene, config)
                _sync(device)
            ends.append(time.perf_counter() - t_start)
            p = res.patches
            outputs.append((p.position, p.normal, p.ref, p.vis))
            win.images.append(scene.images)
            for k, v in res.metrics.times.items():
                win.stage_s[k] = win.stage_s.get(k, 0.0) + v
            for k, v in res.metrics.counters.items():
                win.counters[k] = win.counters.get(k, 0.0) + float(v)
    print(f"[bench] set-up {win.setup_s:.3f} s (warm-up {t_warm:.3f} s, "
          f"{n_pool} scenes pooled), window {ends[-1]:.3f} s, "
          f"{len(outputs)} scenes", file=sys.stderr, flush=True)
    print("[bench] scene seconds: " + " ".join(
        f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)), file=sys.stderr,
        flush=True)
    if len(outputs) > n_pool:
        print(f"[bench] the window outran the cell's {n_pool} captures: "
              f"{len(outputs) - n_pool} scenes were repeats", file=sys.stderr,
              flush=True)
    if win.prof is not None:
        win.prof.stop()
    return win


def peak_bytes(device) -> int:
    import torch

    return (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)


def release(device):
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def report(cell: dict, geo, win: Window, trace: bool, device, readers,
           peak: int, count: int = 1):
    """The result and the checks of a run whose window gave `win`: the
    end-to-end metrics (untraced) or the per-layer readers' (traced), then
    every cloud judged by the plain reference."""
    import torch

    from benchmark import device_trace, judge

    outputs = win.outputs
    n = len(outputs)
    window_s = win.ends[-1]
    patches = sum(int(o[0].shape[0]) for o in outputs)
    cuda = torch.device(device).type == "cuda"
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": count,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": dev_info}
    if trace:
        tr = device_trace.from_profiler(win.prof)
        win.prof = None
        lo, hi = tr.window()
        ctx = ReadContext(n, win.stage_s, win.counters, tr, (lo, hi))
        for name, reader in (readers or metric_readers()).items():
            value = reader.read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value,
                                           "unit": reader.UNIT}
        dev_info["busy_s"] = device_trace.busy_seconds(tr, lo, hi)
        dev_info["window_s"] = hi - lo
        result["breakdown"] = device_trace.breakdown(tr, lo, hi)
        del tr
    else:
        result["metrics"] = {
            "setup_s": {"value": win.setup_s, "unit": "s"},
            "scene_s": {"value": window_s / n, "unit": "s"},
            "patches_per_s": {"value": patches / window_s,
                              "unit": "patches/s"},
        }

    t_judge = time.perf_counter()
    verdicts = judge.judge_run(cell, geo, outputs, win.images, device)
    print(f"[bench] reference {time.perf_counter() - t_judge:.3f} s",
          file=sys.stderr, flush=True)
    result["failed"] = sum(1 for v in verdicts if not v["ok"])
    result["verdicts"] = verdicts
    checks = judge.checks(cell, verdicts)
    result["correct"] = result["failed"] == 0 and all(
        c["ok"] for c in checks)
    return result, checks


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_process: float, readers=None, window=contextlib.nullcontext):
    """One run of a one-card cell: `densify` in this process; returns
    (result dict, checks list). `window` is a context manager entered
    around the timed window alone (the control and the faults of
    `control.py`: they break the timed path, not the set-up's warm-up).
    A cell of several cards runs as a job of ranks (`ranks.run_job`)."""
    from densepoints_tpu_torch.pmvs.pipeline import densify

    def call(scene, config):
        return densify(scene, config, device=device)

    geo, config, pool, t_warm = set_up(cell, seed, device, call)
    win = measure(pool, config, call, seconds, trace, device, t_process,
                  t_warm, window)
    peak = peak_bytes(device)
    del pool
    release(device)
    return report(cell, geo, win, trace, device, readers, peak)


def emit(result: dict, checks: list) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error; the result as the last line of standard output, its
    `checks` key last."""
    for c in checks:
        print(f"[check] {c['name']} {c['value']!r} {c['op']} {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    result = {k: v for k, v in result.items() if k != "verdicts"}
    result["checks"] = {c["name"]: {"value": c["value"], "op": c["op"],
                                    "limit": c["limit"]} for c in checks}
    print(json.dumps(result), flush=True)
