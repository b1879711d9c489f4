"""The inputs the measurement programs and `chip_smoke.py` build, in one
place: camera rigs on an arc or a grid around the plane z = 0 with uniform
noise images, plane patches, and the textured sphere of the end-to-end
bench scene. Each is seeded, so a rig is the same numbers on every call;
each that stands for a rig of the JAX package's `scripts/` draws its
generator in the same order, so its arrays equal that rig's bitwise."""
from __future__ import annotations

import numpy as np
import torch


def look_at(C):
    """Rotation (rows x, y, z) of a camera at C looking at the origin."""
    z = -C / np.linalg.norm(C)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def projections(Cs, focal, W, H):
    """(V, 3, 4) f64 projection matrices of pinhole cameras at `Cs`, each
    looking at the origin, with focal length `focal` px and the principal
    point at the image centre."""
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    P = []
    for C in Cs:
        R = look_at(C)
        P.append(K @ np.concatenate([R, (-R @ C)[:, None]], 1))
    return np.stack(P)


def cameras(Cs, focal, W, H, device):
    from densepoints_tpu_torch.core.cameras import Cameras

    return Cameras.from_projection_matrices(projections(Cs, focal, W, H),
                                            W, H, device=device)


def arc_centres(num_views, spread, lift):
    """Camera centres on an arc of `spread` radians per view at distance
    6, each raised by `lift(i)`."""
    Cs = []
    for i in range(num_views):
        ang = (i - (num_views - 1) / 2) * spread
        Cs.append(np.array([6.0 * np.sin(ang), lift(i), -6.0 * np.cos(ang)]))
    return Cs


def plane_patches(xy):
    """(position (B, 3), normal (B, 3)) f32 of plane patches at `xy`."""
    B = xy.shape[0]
    pos = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    return pos, nrm


def _tensors(device, *arrays):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def refine_inputs(device):
    """bench.py's refine shape + mixed, no-visibility and off-frustum rows:
    (cameras, images, position, normal, ref, vis) on `device`."""
    rng = np.random.default_rng(0)
    V, H, W, B = 8, 480, 640, 4096
    cams = cameras(arc_centres(V, 0.12, lambda i: 0.2 * np.sin(2 * i)),
                   500.0, W, H, device)
    images = rng.uniform(0, 255, (V, H, W)).astype(np.float32)
    pos, nrm = plane_patches(rng.uniform(-1.0, 1.0, (B, 2)))
    ref = np.zeros((B,), np.int64)
    vis = np.ones((B, V), bool)
    vis[:, 0] = False
    mixed = slice(0, 256)
    ref[mixed] = rng.integers(0, V, 256)
    vis[mixed] = rng.uniform(size=(256, V)) > 0.3
    vis[np.arange(256), ref[mixed]] = False
    vis[256] = False  # no visible view at all
    pos[257:261] = [50.0, 50.0, 0.0]  # off every frustum
    return (cams, *_tensors(device, images, pos, nrm, ref, vis))


def dtu_inputs(device):
    """49 views of 1600 x 1200 on a 7 x 7 grid, 16384 patches, ~25 visible:
    (cameras, images, position, normal, ref, vis) on `device`. The images
    come from a torch generator on `device`, so they are other numbers on
    another kind of device."""
    rng = np.random.default_rng(1)
    V, H, W, B = 49, 1200, 1600, 16384
    yaws = np.linspace(-0.45, 0.45, 7)
    pitches = np.linspace(-0.225, 0.225, 7)
    Cs = [np.array([6.0 * np.sin(y), 6.0 * np.sin(p),
                    -6.0 * np.cos(y) * np.cos(p)])
          for p in pitches for y in yaws]
    cams = cameras(Cs, 1500.0, W, H, device)
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.rand((V, H, W), generator=gen, device=device) * 255.0
    pos, nrm = plane_patches(rng.uniform(-1.0, 1.0, (B, 2)))
    ref = np.full((B,), 24, np.int64)
    vis = rng.uniform(size=(B, V)) < 0.51
    vis[:, 24] = False
    return (cams, images, *_tensors(device, pos, nrm, ref, vis))


def arc_scene(rng, num_views, H, W, spread=0.12):
    """`scripts/kernel_paged_bench.py::make_scene`: views on an arc at
    focal 0.8 W and uniform noise images, drawn from `rng`. Returns
    (P (V, 3, 4) f64, images (V, H, W) f32)."""
    P = projections(
        arc_centres(num_views, spread, lambda i: 0.25 * np.sin(2.1 * i)),
        0.8 * W, W, H)
    images = rng.uniform(0, 255, (num_views, H, W)).astype(np.float32)
    return P, images


def paged_bench_rig(num_views, H, W, B, vis_frac):
    """The rig of `scripts/kernel_paged_bench.py::bench`: `arc_scene` from
    `default_rng(0)`, B plane patches within +-0.4, reference view 0, each
    view visible with probability `vis_frac`, view 0 never and view 1
    always. Returns numpy (P, images, position, normal, ref (B,) int64,
    vis (B, V) bool)."""
    rng = np.random.default_rng(0)
    P, images = arc_scene(rng, num_views, H, W)
    pos, nrm = plane_patches(rng.uniform(-0.4, 0.4, (B, 2)))
    ref = np.zeros((B,), np.int64)
    vis = rng.uniform(size=(B, num_views)) < vis_frac
    vis[:, 0] = False  # the reference view is excluded
    vis[:, 1] = True  # an anchor exists
    return P, images, pos, nrm, ref, vis


# `scripts/kernel_bench.py`'s window tables (ops/warp_ncc.py WIN_H, WIN_W;
# k = 11 in 128 lanes): the port draws and drops them, so that the patches
# drawn after them are the script's.
_TPU_WIN_H, _TPU_WIN_W, _TPU_LANES = 56, 128, 128


def kernel_bench_rig(num_views=8, H=480, W=640, B=4096, M=8):
    """The rig of `scripts/kernel_bench.py` (`default_rng(0)`): 8 views of
    480 x 640 on an arc at focal 500, uniform noise images, B plane patches
    within +-1, reference view 0, every view but view 0 visible. Returns
    numpy (P, images, position, normal, ref (B,) int64, vis (B, V) bool)."""
    rng = np.random.default_rng(0)
    P = projections(
        arc_centres(num_views, 0.12, lambda i: 0.2 * np.sin(2 * i)),
        500.0, W, H)
    images = rng.uniform(0, 255, (num_views, H, W)).astype(np.float32)
    rng.integers(0, (H - _TPU_WIN_H) // 8, (B, M))
    rng.integers(0, (W - _TPU_WIN_W) // 64, (B, M))
    rng.integers(0, num_views, (B, M))
    rng.uniform(10, 40, (B, M, 2, _TPU_LANES))
    pos, nrm = plane_patches(rng.uniform(-1.0, 1.0, (B, 2)))
    ref = np.zeros((B,), np.int64)
    vis = np.ones((B, num_views), bool)
    vis[:, 0] = False
    return P, images, pos, nrm, ref, vis


def plane_problem(num_patches, num_views=8, H=240, W=320):
    """`scripts/scaling_bench.py::_problem` (`default_rng(0)`): views on
    an arc at focal 300 raised by 0.1 per view, uniform noise images,
    plane patches within +-1, reference view 0, every view but view 0
    visible. Returns numpy (P, images, position, normal, ref (B,) int64,
    vis (B, V) bool)."""
    rng = np.random.default_rng(0)
    P = projections(arc_centres(num_views, 0.12, lambda i: 0.1 * i),
                    300.0, W, H)
    images = rng.uniform(0, 255, (num_views, H, W)).astype(np.float32)
    pos, nrm = plane_patches(rng.uniform(-1.0, 1.0, (num_patches, 2)))
    ref = np.zeros((num_patches,), np.int64)
    vis = np.ones((num_patches, num_views), bool)
    vis[:, 0] = False
    return P, images, pos, nrm, ref, vis


def to_device(device, P, images, pos, nrm, ref, vis):
    """A numpy rig as (cameras, images, position, normal, ref, vis) on
    `device`."""
    V, H, W = images.shape
    from densepoints_tpu_torch.core.cameras import Cameras

    cams = Cameras.from_projection_matrices(P, W, H, device=device)
    return (cams, *_tensors(device, images, pos, nrm, ref, vis))


# The end-to-end bench scene (`bench.py:197-216`) of `scripts/
# expand_profile.py` and `scripts/prescreen_ab.py`, and their config.
SPHERE = {"num_views": 12, "width": 512, "height": 384, "focal": 450.0,
          "radius": 150.0, "cam_radius": 500.0, "tex_size": 2048}
SPHERE_CONFIG = {
    "profile": "scan",
    "expand": {"max_rounds": 4, "max_iterations": 40},
    "optimize": {"max_iterations": 120},
    "organizer": {"grid_scale": 4},
}


def sphere_scene(num_views=12, width=512, height=384, focal=450.0,
                 radius=150.0, cam_radius=500.0, tex_size=2048):
    """The textured sphere (`default_rng(0)`, a grid of cameras over 0.9 x
    0.45 rad): (generator, f32 images (V, H, W))."""
    from densepoints_tpu_torch.scripts import _scene_runs

    sc = _scene_runs.synthetic().TexturedSphereScene(
        np.random.default_rng(0), num_views=num_views, width=width,
        height=height, focal=focal, radius=radius, cam_radius=cam_radius,
        tex_size=tex_size, layout="grid", yaw_span=0.9, pitch_span=0.45,
    )
    return sc, sc.render_all()


def sphere_seeds(n=3000, radius=150.0):
    """`n` points uniform on the sphere (`default_rng(7)`), f32."""
    g = np.random.default_rng(7)
    seeds = g.standard_normal((n, 3)).astype(np.float32)
    seeds *= radius / np.linalg.norm(seeds, axis=1, keepdims=True)
    return seeds
