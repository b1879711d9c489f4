"""What the programs of `densepoints_tpu_torch.scripts` share: the repo's
seeded scene generators, their working directories, the DTU tree the
end-to-end programs write, the analytic-sphere ground truth, the device's
name, the `--config` option of the measurement programs and the way a
record is put out."""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from densepoints_tpu_torch.utils.metrics import accuracy_completeness

REPO = Path(__file__).resolve().parents[2]


def synthetic():
    """`tests/synthetic.py`: the numpy-only scene generators both packages
    render their test and program scenes with."""
    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import synthetic as module

    return module


@contextlib.contextmanager
def work_dir(path: str, prefix: str):
    """`path` (created if missing, kept), or a fresh temporary directory
    removed on exit: a run never finds, and resumes from, another run's
    files unless it is handed their directory."""
    if path:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        yield path
        return
    with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
        yield Path(tmp)


def config_option(parser, defaults: dict) -> None:
    """`--config JSON`: an object whose keys override `defaults`, the
    program's sizes at its JAX program's configuration (smaller ones serve
    runs on the CPU and the workers of a job); `args.config` is the merged
    dict. A key `defaults` lacks is an error."""
    def merged(text):
        given = json.loads(text)
        unknown = sorted(set(given) - set(defaults))
        if unknown:
            raise argparse.ArgumentTypeError(
                f"unknown keys {unknown}; known: {sorted(defaults)}")
        return {**defaults, **given}

    parser.add_argument(
        "--config", type=merged, default=dict(defaults),
        help="JSON object overriding the sizes "
             f"{json.dumps(defaults)}")


def emit(record: dict, out: str = "") -> None:
    """Print `record` as the last line, and write it to `out` if given (a
    program writes nowhere else)."""
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)


def device_label(device: str) -> str:
    """The card's name (`torch.cuda.get_device_name`) and power limit
    (`nvidia-smi`), or the device's type off a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    from densepoints_tpu_torch.scripts import _timing

    power = _timing.card_line().rsplit(",", 1)[-1].strip()
    return f"{torch.cuda.get_device_name(device)}, {power}"


def write_dtu_layout(root: Path, P: np.ndarray, images: np.ndarray) -> None:
    """The DTU tree of a scan, 1-indexed: `Calibration/pos_XXX.txt` (the
    3 x 4 projection matrix) and `Rectified/rect_XXX_max_r5000.png` (the
    image clipped to 8 bits)."""
    from PIL import Image

    calib, rect = root / "Calibration", root / "Rectified"
    calib.mkdir(parents=True, exist_ok=True)
    rect.mkdir(parents=True, exist_ok=True)
    for i in range(len(P)):
        np.savetxt(calib / f"pos_{i + 1:03d}.txt", P[i])
        Image.fromarray(np.clip(images[i], 0, 255).astype(np.uint8)).save(
            rect / f"rect_{i + 1:03d}_max_r5000.png"
        )


def load_dtu_layout(root: Path, device: str):
    """The real-dataset entry path: the DTU tree -> scene JSON -> Scene."""
    from densepoints_tpu_torch.io.datasets import dtu_to_scene_json
    from densepoints_tpu_torch.io.scene import load_scene

    scene_json = dtu_to_scene_json(root / "Calibration", root / "Rectified",
                                   root / "scene.json")
    print(f"wrote DTU layout + {scene_json}", flush=True)
    return load_scene(scene_json, device=device)


def sphere_ground_truth(radius: float, centres: np.ndarray) -> np.ndarray:
    """200,000 uniform samples of the sphere (`default_rng(1)`) kept where
    >= 3 cameras see them inside the 0.78 rad visible cone (the inward
    normal -p / r against the ray from each camera): what a surviving
    patch must satisfy."""
    gt_rng = np.random.default_rng(1)
    pts = gt_rng.standard_normal((200_000, 3)).astype(np.float32)
    pts *= radius / np.linalg.norm(pts, axis=1, keepdims=True)
    n_in = -pts / radius
    vis_count = np.zeros(len(pts), np.int32)
    for C in centres:
        d = pts - C.astype(np.float32)
        cosang = np.sum(d * n_in, axis=1) / np.linalg.norm(d, axis=1)
        vis_count += (np.arccos(np.clip(cosang, -1, 1)) < 0.78)
    return pts[vis_count >= 3]


def sphere_quality(cloud: np.ndarray, radius: float, centres: np.ndarray,
                   threshold: float):
    """(CloudMetrics against `sphere_ground_truth`, the exact distance
    | |p| - r | of every point, [nan] for an empty cloud)."""
    metrics = accuracy_completeness(
        cloud, sphere_ground_truth(radius, centres), threshold=threshold,
        max_dist=20.0,
    )
    acc_exact = (
        np.abs(np.linalg.norm(cloud, axis=1) - radius)
        if len(cloud)
        else np.array([np.nan])
    )
    print(metrics.summary(), flush=True)
    return metrics, acc_exact
