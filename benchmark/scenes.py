"""Synthetic captures of a textured sphere, made on the device from a
seed.

The geometry is that of `tests/synthetic.py::TexturedSphereScene` with
`layout="grid"`: cameras on a yaw x pitch angular grid at `cam_radius`
from a sphere of `radius` at the origin, each looking at the origin with
the world's y axis up, pinhole intrinsics with the principal point at the
image centre. `layout="hemisphere"` spreads them evenly over a
hemisphere of directions instead. A pixel's value is the sphere's texture, looked up by
spherical coordinates at the ray's first hit, or 0 where the ray misses.
The texture is `smooth_texture`'s sum of bilinearly upsampled octaves of
Gaussian noise, scaled to [0, 255]; here the noise comes from a
`torch.Generator` on the device, so every capture has its own texture and
the same cameras. How long a capture takes depends on its texture, so the
runs of a cell share a set of captures (`capture_keys`): each run takes
them in an order drawn from its seed.

Rendering runs in float64 for the rays and float32 for the texture
lookup, a block of views at a time.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["SceneGeometry", "Capture", "scene_seed", "shared_seed",
           "capture_keys", "cameras", "smooth_texture", "render",
           "make_capture"]

OCTAVES = (4, 8, 16, 32, 64, 128, 256)
ORDER_INDEX = 1 << 40  # the run's stream for its order of the shared set


@dataclasses.dataclass(frozen=True)
class SceneGeometry:
    """The sizes of a capture, as a configuration file states them."""

    views: int
    width: int
    height: int
    focal_px: float
    radius_mm: float
    cam_radius_mm: float
    tex_size: int
    layout: str = "grid"  # a key of `LAYOUTS`
    yaw_span_rad: float = 0.0  # the grid's spans
    pitch_span_rad: float = 0.0

    @classmethod
    def from_config(cls, scene: dict) -> "SceneGeometry":
        return cls(**{f.name: scene[f.name] for f in dataclasses.fields(cls)
                      if f.name in scene})

    @property
    def pixel_mm(self) -> float:
        """The footprint of a pixel on the object, in mm."""
        return self.cam_radius_mm / self.focal_px


@dataclasses.dataclass
class Capture:
    """One capture: cameras (float64, host) and images (V, H, W) float32
    in [0, 255] on the device they were rendered on."""

    P: np.ndarray  # (V, 3, 4)
    K: np.ndarray  # (V, 3, 3)
    R: np.ndarray  # (V, 3, 3) world -> camera rows
    C: np.ndarray  # (V, 3) centres
    images: torch.Tensor


def scene_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for scene `index` of a run of `seed` (any
    whole number, negative or past 64 bits included)."""
    words = [int(x) for x in divmod(abs(int(seed)), 1 << 32)]
    ss = np.random.SeedSequence([*words, int(seed < 0), int(index)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def shared_seed(index: int) -> int:
    """A 63-bit generator seed for capture `index` of the set every run
    shares (a stream apart from every run's own)."""
    ss = np.random.SeedSequence([0x53484152, int(index)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def capture_keys(seed: int, shared: int) -> list:
    """The generator seeds of a run's timed captures: the `shared`
    captures every run shares, in an order drawn from `seed`. (The
    warm-up's capture is the run's own, `scene_seed(seed, 0)`.)"""
    order = np.random.default_rng(scene_seed(seed, ORDER_INDEX)).permutation(
        shared)
    return [shared_seed(int(i)) for i in order]


def _grid_centres(geo: SceneGeometry) -> np.ndarray:
    """Centres on a yaw x pitch angular grid facing the sphere from -z."""
    n_yaw = int(math.ceil(math.sqrt(geo.views)))
    n_pitch = int(math.ceil(geo.views / n_yaw))
    yaws = np.linspace(-geo.yaw_span_rad / 2, geo.yaw_span_rad / 2, n_yaw)
    pitches = np.linspace(-geo.pitch_span_rad / 2, geo.pitch_span_rad / 2,
                          n_pitch)
    angles = [(y, p) for p in pitches for y in yaws][: geo.views]
    r = geo.cam_radius_mm
    return np.array([[r * np.sin(a), r * np.sin(t), -r * np.cos(a) * np.cos(t)]
                     for a, t in angles])


def _hemisphere_centres(geo: SceneGeometry) -> np.ndarray:
    """Centres spread evenly over the hemisphere of directions around -z
    (a Fibonacci lattice, equal area per view), from the rim to the
    pole, as a spherical gantry samples the half-space above a table."""
    i = np.arange(geo.views)
    h = (i + 0.5) / geo.views
    azimuth = i * math.pi * (3.0 - math.sqrt(5.0))
    ring = np.sqrt(1.0 - h * h)
    return geo.cam_radius_mm * np.stack(
        [ring * np.cos(azimuth), ring * np.sin(azimuth), -h], axis=1)


LAYOUTS = {"grid": _grid_centres, "hemisphere": _hemisphere_centres}


def cameras(geo: SceneGeometry):
    """(P, K, R, C) of the configuration's layout, float64 on the host:
    every camera looks at the origin with the world's y axis up (the x
    axis where y is within 8 degrees of the optical axis)."""
    K = np.array([[geo.focal_px, 0, geo.width / 2.0],
                  [0, geo.focal_px, geo.height / 2.0], [0, 0, 1.0]])
    Ps, Rs, Cs = [], [], []
    for C in LAYOUTS[geo.layout](geo):
        z = -C / np.linalg.norm(C)
        up = [0.0, 1.0, 0.0] if abs(z[1]) < 0.99 else [1.0, 0.0, 0.0]
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Ps.append(K @ np.concatenate([R, (-R @ C)[:, None]], axis=1))
        Rs.append(R)
        Cs.append(C)
    V = len(Cs)
    return (np.stack(Ps), np.broadcast_to(K, (V, 3, 3)).copy(),
            np.stack(Rs), np.stack(Cs))


def _upsample(noise: torch.Tensor, size: int) -> torch.Tensor:
    """`smooth_texture`'s bilinear upsample of one octave to size x size."""
    octave = noise.shape[0]
    idx = torch.linspace(0, octave - 1, size, dtype=torch.float64,
                         device=noise.device)
    x0 = torch.floor(idx).long()
    x1 = torch.clamp_max(x0 + 1, octave - 1)
    w = idx - x0
    return (noise[x0][:, x0] * torch.outer(1 - w, 1 - w)
            + noise[x0][:, x1] * torch.outer(1 - w, w)
            + noise[x1][:, x0] * torch.outer(w, 1 - w)
            + noise[x1][:, x1] * torch.outer(w, w))


def smooth_texture(noises, size: int) -> torch.Tensor:
    """Smooth texture in [0, 255] (float32) from one (o, o) noise tensor
    per octave of `OCTAVES`, in that order."""
    tex = None
    for noise in noises:
        part = _upsample(noise.double(), size) * (noise.shape[0] ** 0.5)
        tex = part if tex is None else tex + part
    tex -= tex.min()
    tex *= 255.0 / max(float(tex.max()), 1e-9)
    return tex.float()


def octave_noise(generator: torch.Generator, device) -> list:
    return [torch.randn((o, o), generator=generator, dtype=torch.float64,
                        device=device) for o in OCTAVES]


def _tex_at(texture: torch.Tensor, pts: torch.Tensor, radius: float):
    """Bilinear texture value at sphere points (N, 3)."""
    T = texture.shape[0]
    theta = torch.atan2(pts[:, 1], pts[:, 0])
    phi = torch.arccos(torch.clamp(pts[:, 2] / radius, -1, 1))
    u = (theta / (2 * math.pi) + 0.5) * (T - 1.001)
    v = (phi / math.pi) * (T - 1.001)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    du, dv = (u - u0).float(), (v - v0).float()
    u1 = torch.clamp_max(u0 + 1, T - 1)
    v1 = torch.clamp_max(v0 + 1, T - 1)
    return (texture[v0, u0] * (1 - du) * (1 - dv)
            + texture[v0, u1] * du * (1 - dv)
            + texture[v1, u0] * (1 - du) * dv
            + texture[v1, u1] * du * dv)


def render(geo: SceneGeometry, P: np.ndarray, C: np.ndarray,
           texture: torch.Tensor, views_per_block: int = 8) -> torch.Tensor:
    """(V, H, W) float32 images of the textured sphere on `texture`'s
    device: the ray of each pixel against the sphere, first hit."""
    dev = texture.device
    V = P.shape[0]
    Minv = torch.as_tensor(np.linalg.inv(P[:, :, :3]), device=dev)
    Cs = torch.as_tensor(C, device=dev)
    ys, xs = torch.meshgrid(
        torch.arange(geo.height, dtype=torch.float64, device=dev),
        torch.arange(geo.width, dtype=torch.float64, device=dev),
        indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    out = torch.zeros((V, geo.height * geo.width), dtype=torch.float32,
                      device=dev)
    r2 = geo.radius_mm ** 2
    for lo in range(0, V, views_per_block):
        hi = min(lo + views_per_block, V)
        d = torch.einsum("pj,vij->vpi", pix, Minv[lo:hi])
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        c = Cs[lo:hi]
        b = torch.einsum("vpi,vi->vp", d, c)
        disc = b * b - ((c * c).sum(-1) - r2)[:, None]
        hit = disc > 0
        t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        pts = c[:, None, :] + t[..., None] * d
        block = torch.zeros(hit.shape, dtype=torch.float32, device=dev)
        block[hit] = _tex_at(texture, pts[hit], geo.radius_mm)
        out[lo:hi] = block
    return out.reshape(V, geo.height, geo.width)


def make_capture(geo: SceneGeometry, key: int, device) -> Capture:
    """The capture whose texture generator seed is `key` (`scene_seed`,
    `shared_seed`), rendered on `device`."""
    P, K, R, C = cameras(geo)
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    texture = smooth_texture(octave_noise(gen, device), geo.tex_size)
    return Capture(P=P, K=K, R=R, C=C, images=render(geo, P, C, texture))
