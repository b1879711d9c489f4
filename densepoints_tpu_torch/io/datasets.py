"""Real-dataset adapters -> the scene JSON schema that `io.scene` reads
(`{imagesPath, views: [{filename, projectionMatrix[3][4]}]}`). Host code
(numpy + JSON), a copy of the JAX package's converters writing the same
bytes. Two adapters:

  * DTU: per-view `pos_XXX.txt` calibration files (3x4 projection matrix,
    one row per line) + `rect_XXX_YY_rZZZZ.png` rectified images — the
    layout of the DTU MVS benchmark's `Calibration/cal18` + `Rectified`
    directories.
  * COLMAP: a text (`cameras.txt`/`images.txt`) or binary
    (`cameras.bin`/`images.bin`) model, the interchange format
    Tanks&Temples and most SfM pipelines produce: P = K [R | t] from the
    quaternion/translation per image. Distortion coefficients of
    non-pinhole models are ignored with a warning (densification assumes
    rectified inputs).

Both write a scene JSON next to (or pointing at) the images, so `densify
-i scene.json` runs unchanged on real scans.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

from densepoints_tpu_torch.utils import log

__all__ = ["dtu_to_scene_json", "colmap_to_scene_json"]


def _read_dtu_pos(path: Path) -> np.ndarray:
    vals = np.loadtxt(path, dtype=np.float64)
    if vals.shape == (3, 4):
        return vals
    if vals.size == 12:
        return vals.reshape(3, 4)
    raise ValueError(f"{path}: expected a 3x4 projection matrix, got {vals.shape}")


def dtu_to_scene_json(
    calib_dir,
    images_dir,
    out_path,
    lighting: str = "max",
) -> Path:
    """Convert one DTU scan to a scene JSON.

    calib_dir: directory of pos_XXX.txt projection matrices (1-indexed).
    images_dir: directory of rect_XXX_<lighting>_r5000.png rectified images
      (XXX matches the calibration index; `lighting` picks the exposure
      variant, default the all-lights-on "max" images).
    Returns the written path.
    """
    calib_dir, images_dir = Path(calib_dir), Path(images_dir)
    out_path = Path(out_path)
    pos_files = sorted(calib_dir.glob("pos_*.txt"))
    if not pos_files:
        raise FileNotFoundError(f"no pos_*.txt in {calib_dir}")
    views = []
    for pf in pos_files:
        idx = int(re.search(r"pos_(\d+)", pf.name).group(1))
        P = _read_dtu_pos(pf)
        candidates = sorted(
            images_dir.glob(f"rect_{idx:03d}_{lighting}*.png")
        ) or sorted(images_dir.glob(f"rect_{idx:03d}_*.png"))
        if not candidates:
            log.warning("DTU view %03d: no image found, skipping", idx)
            continue
        views.append(
            {
                "filename": candidates[0].name,
                "projectionMatrix": P.tolist(),
            }
        )
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(
            {"imagesPath": str(images_dir.resolve()), "views": views}, f
        )
    log.info("DTU scan: %d views -> %s", len(views), out_path)
    return out_path


def _qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP qvec (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [
                1 - 2 * y * y - 2 * z * z,
                2 * x * y - 2 * z * w,
                2 * x * z + 2 * y * w,
            ],
            [
                2 * x * y + 2 * z * w,
                1 - 2 * x * x - 2 * z * z,
                2 * y * z - 2 * x * w,
            ],
            [
                2 * x * z - 2 * y * w,
                2 * y * z + 2 * x * w,
                1 - 2 * x * x - 2 * y * y,
            ],
        ]
    )


def _colmap_K(model: str, params: list[float]) -> np.ndarray:
    # Single-focal models: params = f, cx, cy, [distortion...]. RADIAL is
    # f, cx, cy, k1, k2 (single focal) — parsing it as fx,fy,cx,cy would
    # silently emit garbage intrinsics (ADVICE r2, high).
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        f, cx, cy = params[:3]
        fx = fy = f
    elif model in ("PINHOLE", "OPENCV", "FULL_OPENCV"):
        fx, fy, cx, cy = params[:4]
    else:
        raise ValueError(f"unsupported COLMAP camera model {model!r}")
    if model not in ("SIMPLE_PINHOLE", "PINHOLE"):
        n_k = 3 if model in ("SIMPLE_RADIAL", "RADIAL") else 4
        dist = params[n_k:]
        if any(abs(d) > 0 for d in dist):
            log.warning(
                "COLMAP model %s carries nonzero distortion %s — it is "
                "DISCARDED (pinhole approximation); undistort the images "
                "first or expect biased reprojections",
                model,
                dist,
            )
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


# COLMAP model_id -> (name, param count) for the binary format (the
# public read_write_model.py table).
_COLMAP_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read_colmap_binary(sparse_dir: Path):
    """Parse cameras.bin / images.bin (COLMAP's default export format).

    Returns (cameras {id: K}, image rows [(name, qvec, tvec, cam_id)]).
    """
    import struct

    cameras = {}
    with open(sparse_dir / "cameras.bin", "rb") as f:
        (n_cams,) = struct.unpack("<Q", f.read(8))
        for _ in range(n_cams):
            cam_id, model_id, _w, _h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _COLMAP_MODELS[model_id]
            params = list(
                struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            )
            cameras[cam_id] = _colmap_K(name, params)

    rows = []
    with open(sparse_dir / "images.bin", "rb") as f:
        (n_imgs,) = struct.unpack("<Q", f.read(8))
        for _ in range(n_imgs):
            _img_id = struct.unpack("<i", f.read(4))[0]
            q = struct.unpack("<4d", f.read(32))
            t = struct.unpack("<3d", f.read(24))
            (cam_id,) = struct.unpack("<i", f.read(4))
            name_bytes = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00" or not c:
                    break
                name_bytes += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n_pts, 1)  # skip POINTS2D (x, y, point3D_id)
            rows.append(
                (name_bytes.decode(), np.asarray(q), np.asarray(t), cam_id)
            )
    return cameras, rows


def colmap_to_scene_json(sparse_dir, images_dir, out_path) -> Path:
    """Convert a COLMAP model (text OR binary) to scene JSON.

    P = K [R | t] with R from the stored world-to-camera quaternion and
    t the stored translation (COLMAP convention: x_cam = R X + t).
    Binary models (`cameras.bin`/`images.bin` — COLMAP's default export,
    what Tanks&Temples reconstructions ship) are preferred when present;
    text models (`cameras.txt`/`images.txt`) otherwise.
    """
    sparse_dir, images_dir = Path(sparse_dir), Path(images_dir)
    out_path = Path(out_path)

    if (sparse_dir / "cameras.bin").exists():
        cameras, rows = _read_colmap_binary(sparse_dir)
        views = []
        for name, qvec, tvec, cam_id in rows:
            R = _qvec_to_rotmat(qvec)
            P = cameras[cam_id] @ np.concatenate([R, tvec[:, None]], axis=1)
            views.append({"filename": name, "projectionMatrix": P.tolist()})
        views.sort(key=lambda v: v["filename"])
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(
                {"imagesPath": str(images_dir.resolve()), "views": views}, f
            )
        log.info(
            "COLMAP binary model: %d views -> %s", len(views), out_path
        )
        return out_path

    cameras = {}
    with open(sparse_dir / "cameras.txt") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            params = [float(p) for p in parts[4:]]
            cameras[cam_id] = _colmap_K(model, params)

    # images.txt is structurally paired: each image line
    # "ID qw qx qy qz tx ty tz CAM_ID NAME" is followed by exactly one
    # POINTS2D line (possibly empty). Consume them as pairs instead of
    # sniffing whether a field parses as a float — content sniffing
    # silently dropped images whose filename is numeric-like, e.g. "1e5"
    # (ADVICE r2).
    views = []
    with open(sparse_dir / "images.txt") as f:
        lines = [
            ln.strip() for ln in f if not ln.strip().startswith("#")
        ]
    image_lines = []
    expect_image = True
    for ln in lines:
        if expect_image:
            if not ln:
                continue  # stray blank where an image line is expected
            image_lines.append(ln)
            expect_image = False
        else:
            expect_image = True  # the POINTS2D line (even if empty)
    for ln in image_lines:
        parts = ln.split()
        if len(parts) < 10:
            log.warning("images.txt: malformed image line dropped: %r", ln)
            continue
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        R = _qvec_to_rotmat(qvec)
        K = cameras[cam_id]
        P = K @ np.concatenate([R, tvec[:, None]], axis=1)
        views.append(
            {"filename": name, "projectionMatrix": P.tolist()}
        )
    views.sort(key=lambda v: v["filename"])
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(
            {"imagesPath": str(images_dir.resolve()), "views": views}, f
        )
    log.info("COLMAP model: %d views -> %s", len(views), out_path)
    return out_path


def main(argv=None) -> int:
    """`python -m densepoints_tpu_torch.io.datasets dtu|colmap ...`"""
    import argparse

    p = argparse.ArgumentParser(
        prog="densify-convert",
        description="Convert DTU / COLMAP scans to the densify scene JSON",
    )
    sub = p.add_subparsers(dest="format", required=True)
    d = sub.add_parser("dtu", help="DTU calibration + rectified images")
    d.add_argument("--calib", required=True, help="dir of pos_XXX.txt")
    d.add_argument("--images", required=True, help="dir of rect_*.png")
    d.add_argument("-o", "--output", required=True, help="scene JSON path")
    d.add_argument("--lighting", default="max")
    c = sub.add_parser("colmap", help="COLMAP text model")
    c.add_argument("--sparse", required=True, help="dir of cameras/images.txt")
    c.add_argument("--images", required=True, help="image directory")
    c.add_argument("-o", "--output", required=True, help="scene JSON path")
    args = p.parse_args(argv)
    if args.format == "dtu":
        dtu_to_scene_json(args.calib, args.images, args.output, args.lighting)
    else:
        colmap_to_scene_json(args.sparse, args.images, args.output)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
