"""Scene file reader.

Schema:
    {"imagesPath": "...",
     "views": [{"filename": "...", "projectionMatrix": [[..4],[..4],[..4]]}]}
Images are decoded on the host with Pillow (imported at first use); the
camera decomposition runs in f64 on load and the cameras are placed on the
requested device.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from densepoints_tpu_torch.core.cameras import Cameras

__all__ = ["SceneSpec", "Scene", "read_scene_json", "load_scene"]


@dataclasses.dataclass
class SceneSpec:
    """Parsed scene file: image paths + raw f64 projection matrices."""

    image_paths: list[Path]
    projection_matrices: np.ndarray  # (V, 3, 4) float64


@dataclasses.dataclass
class Scene:
    """A loaded scene: cameras (on a device) + host image stacks.

    images: (V, H, W) float32 grayscale in [0, 255] (padded to common size).
    colors: (V, H, W, 3) uint8 RGB for point colouring (optional).
    """

    cameras: Cameras
    images: np.ndarray
    colors: np.ndarray | None = None


def read_scene_json(path) -> SceneSpec:
    path = Path(path)
    with open(path) as f:
        data = json.load(f)
    images_path = Path(data["imagesPath"])
    if not images_path.is_absolute():
        images_path = path.parent / images_path
    paths, Ps = [], []
    for view in data["views"]:
        paths.append(images_path / view["filename"])
        P = np.asarray(view["projectionMatrix"], dtype=np.float64)
        if P.shape != (3, 4):
            raise ValueError(f"projectionMatrix must be 3x4, got {P.shape}")
        Ps.append(P)
    return SceneSpec(paths, np.stack(Ps) if Ps else np.zeros((0, 3, 4)))


def _luminance(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma (0.299 R + 0.587 G + 0.114 B)."""
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ).astype(np.float32)


def load_scene(
    path, keep_color: bool = True, drop_missing: bool = True, device="cuda"
) -> Scene:
    """Read a scene JSON and decode its images into padded stacks.

    Views whose image cannot be loaded are dropped (or raise with
    drop_missing=False). Cameras are built on `device`.
    """
    from PIL import Image

    spec = read_scene_json(path)
    loadable, sizes = [], []
    for idx, img_path in enumerate(spec.image_paths):
        try:
            with Image.open(img_path) as im:
                sizes.append((im.height, im.width))
            loadable.append(idx)
        except (FileNotFoundError, OSError):
            if drop_missing:
                continue
            raise
    if not loadable:
        raise ValueError(f"No loadable views in scene {path}")
    H = max(s[0] for s in sizes)
    W = max(s[1] for s in sizes)
    images = np.zeros((len(loadable), H, W), np.float32)
    colstack = (
        np.zeros((len(loadable), H, W, 3), np.uint8) if keep_color else None
    )
    Ps, kept_sizes = [], []
    n = 0
    for idx, size in zip(loadable, sizes):
        try:
            with Image.open(spec.image_paths[idx]) as im:
                rgb = np.asarray(im.convert("RGB"))
        except (FileNotFoundError, OSError):
            if drop_missing:
                continue
            raise
        h, w = min(rgb.shape[0], H), min(rgb.shape[1], W)
        images[n, :h, :w] = _luminance(rgb[:h, :w])
        if colstack is not None:
            colstack[n, :h, :w] = rgb[:h, :w]
        Ps.append(spec.projection_matrices[idx])
        kept_sizes.append(size)
        n += 1
    if n == 0:
        raise ValueError(f"No loadable views in scene {path}")
    cams = Cameras.from_projection_matrices(
        np.stack(Ps),
        widths=[s[1] for s in kept_sizes],
        heights=[s[0] for s in kept_sizes],
        device=device,
    )
    return Scene(
        cams, images[:n], colstack[:n] if colstack is not None else None
    )
