"""Dataset converters of the port against the JAX package's, on the five
fixtures of the JAX package's own tests (DTU; DTU with a missing image;
COLMAP text with a RADIAL camera and numeric names; COLMAP text; COLMAP
binary): the scene JSON is byte-equal, and the port's `load_scene` reads it
back to the fixture's cameras."""
import json
import struct

import numpy as np
import pytest
from PIL import Image

from densepoints_tpu.io import datasets as jax_datasets
from densepoints_tpu_torch.io import datasets
from densepoints_tpu_torch.io.scene import load_scene
from tests.synthetic import TexturedPlaneScene


def _write_images(scene, images_dir, namer, fmt=None):
    images_dir.mkdir(parents=True, exist_ok=True)
    imgs = scene.render_all()
    for i in range(imgs.shape[0]):
        Image.fromarray(np.clip(imgs[i], 0, 255).astype(np.uint8)).save(
            images_dir / namer(i), format=fmt)


def _qvec_t(scene, i):
    """COLMAP's world-to-camera quaternion (w, x, y, z) and translation."""
    M = np.linalg.inv(scene.K) @ scene.P[i]
    R, t = M[:, :3], M[:, 3]
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return (w, x, y, z), t


def _dtu(tmp_path, rng, missing):
    n = 3 if missing else 4
    scene = TexturedPlaneScene(rng, num_views=n, width=64, height=48)
    calib = tmp_path / "Calibration"
    calib.mkdir()
    for i in range(n):  # 1-indexed, one matrix row per line
        np.savetxt(calib / f"pos_{i + 1:03d}.txt", scene.P[i])
    _write_images(scene, tmp_path / "Rectified",
                  lambda i: f"rect_{i + 1:03d}_max_r5000.png")
    if missing:
        (tmp_path / "Rectified" / "rect_002_max_r5000.png").unlink()
    kept = [0, 2] if missing else list(range(n))
    return ("dtu_to_scene_json", (calib, tmp_path / "Rectified"),
            scene.P[kept])


def _colmap_text(tmp_path, rng, radial):
    n = 2 if radial else 3
    scene = TexturedPlaneScene(rng, num_views=n, width=64, height=48)
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    K = scene.K
    with open(sparse / "cameras.txt", "w") as f:
        f.write("# comment line\n")
        if radial:  # f, cx, cy, k1, k2: one focal
            f.write(f"1 RADIAL 64 48 {K[0, 0]} {K[0, 2]} {K[1, 2]} "
                    "0.001 0.0001\n")
        else:
            f.write(f"1 PINHOLE 64 48 {K[0, 0]} {K[1, 1]} {K[0, 2]} "
                    f"{K[1, 2]}\n")
    names = [f"1e{i}" if radial else f"v{i}.png" for i in range(n)]
    with open(sparse / "images.txt", "w") as f:
        f.write("# images\n")
        for i in range(n):
            (w, x, y, z), t = _qvec_t(scene, i)
            f.write(f"{i + 1} {w} {x} {y} {z} {t[0]} {t[1]} {t[2]} 1 "
                    f"{names[i]}\n")
            # The POINTS2D line: a numeric one after a numeric name.
            f.write("1.0 2.0 3\n" if radial else "\n")
    _write_images(scene, tmp_path / "img", lambda i: names[i],
                  fmt="PNG" if radial else None)
    return "colmap_to_scene_json", (sparse, tmp_path / "img"), scene.P


def _colmap_binary(tmp_path, rng):
    scene = TexturedPlaneScene(rng, num_views=3, width=64, height=48)
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    K = scene.K
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48))  # PINHOLE: fx fy cx cy
        f.write(struct.pack("<4d", K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 3))
        for i in range(3):
            q, t = _qvec_t(scene, i)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *t))
            f.write(struct.pack("<i", 1))
            f.write(f"v{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))  # two POINTS2D entries to skip
            f.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)
    _write_images(scene, tmp_path / "img", lambda i: f"v{i}.png")
    return "colmap_to_scene_json", (sparse, tmp_path / "img"), scene.P


_FIXTURES = {
    "dtu": lambda tmp, rng: _dtu(tmp, rng, missing=False),
    "dtu_missing_image": lambda tmp, rng: _dtu(tmp, rng, missing=True),
    "colmap_radial_numeric_names":
        lambda tmp, rng: _colmap_text(tmp, rng, radial=True),
    "colmap_text": lambda tmp, rng: _colmap_text(tmp, rng, radial=False),
    "colmap_binary": _colmap_binary,
}


@pytest.mark.parametrize("fixture", list(_FIXTURES))
def test_scene_json_matches_jax(tmp_path, rng, fixture):
    convert, args, P = _FIXTURES[fixture](tmp_path, rng)
    out = getattr(datasets, convert)(*args, tmp_path / "port" / "scene.json")
    want = getattr(jax_datasets, convert)(*args, tmp_path / "jax.json")
    assert out == tmp_path / "port" / "scene.json"
    assert out.read_bytes() == want.read_bytes()
    loaded = load_scene(out, device="cpu")
    assert loaded.cameras.num_views == len(P)
    assert loaded.cameras.device.type == "cpu"
    pt = np.array([0.1, -0.2, 0.05, 1.0])
    got = loaded.cameras.P.numpy().astype(np.float64) @ pt
    ref = P @ pt
    np.testing.assert_allclose(got[:, :2] / got[:, 2:],
                               ref[:, :2] / ref[:, 2:], atol=1e-3)


def test_main_converts_dtu(tmp_path, rng):
    """`python -m densepoints_tpu_torch.io.datasets dtu ...` through
    `main`, against the JAX package's `main`."""
    _, (calib, images), _ = _dtu(tmp_path, rng, missing=False)
    argv = ["dtu", "--calib", str(calib), "--images", str(images), "-o"]
    assert datasets.main(argv + [str(tmp_path / "a.json")]) == 0
    assert jax_datasets.main(argv + [str(tmp_path / "b.json")]) == 0
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert len(json.loads((tmp_path / "a.json").read_text())["views"]) == 4
    with pytest.raises(FileNotFoundError):
        datasets.dtu_to_scene_json(tmp_path / "Rectified", images,
                                   tmp_path / "c.json")
