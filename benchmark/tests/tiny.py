"""A cell small enough for the CPU, written as files into a folder laid
out as `benchmark/` is."""
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

SCENE = {"views": 9, "width": 240, "height": 180, "focal_px": 1000.0,
         "radius_mm": 60.0, "cam_radius_mm": 650.0, "tex_size": 1024,
         "yaw_span_rad": 1.0, "pitch_span_rad": 0.5}


def write_bench(root: Path, limits=None, guarantees=None) -> Path:
    """A benchmark folder under `root` with the configuration `tiny`, the
    traffic of `benchmark/traffic`, the cell `tiny-grid4` and the readers
    of `benchmark/metrics`."""
    bench = root / "bench"
    for kind in ("configs", "traffic", "workloads"):
        (bench / kind).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for f in (BENCH / "traffic").glob("*.json"):
        shutil.copy(f, bench / "traffic")
    config = json.loads((BENCH / "configs" / "dtu49.json").read_text())
    config["scene"] = dict(SCENE)
    config["pipeline"]["matching"]["max_keypoints_per_view"] = 512
    config["pipeline"]["optimize"]["max_iterations"] = 30
    config["pipeline"]["expand"].update(max_rounds=2, max_iterations=20)
    # At this size a sound cloud covers about two thirds of the sphere.
    config["guarantees"].update(completeness=0.5, **(guarantees or {}))
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    cell = {"config": "tiny", "traffic": "grid4", "chips": 1, "captures": 2,
            "limits": limits or {"photo_fail_share": 0.001,
                                 "near_miss_share": 0.01,
                                 "refine_gain": 0.015}}
    (bench / "workloads" / "tiny-grid4.json").write_text(json.dumps(cell))
    return bench
