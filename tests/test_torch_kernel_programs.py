"""The port's kernel-timing programs (`densepoints_tpu_torch.scripts.
kernel_bench`, `kernel_paged_bench`, `kernel_roofline`) and their rigs
(`scripts/_rigs.py`), on the CPU against the JAX package.

The JAX programs' `main` is never called (they time Pallas kernels and
write into the working directory). Their rigs are held bitwise: the
helpers the JAX scripts define are imported from `scripts/`
(`kernel_paged_bench.make_scene`, `scaling_bench._problem`), and the rig
`kernel_bench.py` builds inside its `main` (`:36-103`) is restated here.
The refine and DTU kernel inputs `chip_smoke.py` built before they moved
into `_rigs` are restated too, and held bitwise to the moved ones.

Tolerances: rigs bitwise; the plain all-views scores and the plain chunked
scores within 1e-4 of each other and of the JAX `allview_scores_xla` and
`patch_ncc_scores` (f32 sums in other orders); byte and operation counts
exactly equal to a count by hand (the stack's distinct tap pixels counted
as a set).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.ops.warp_ncc import WIN_H as JAX_WIN_H
from densepoints_tpu.ops.warp_ncc import WIN_W as JAX_WIN_W
from densepoints_tpu.ops.warp_ncc_paged import allview_scores_xla
from densepoints_tpu.pmvs.optimize import _anchor_chunks as jax_chunks
from densepoints_tpu.pmvs.optimize import patch_ncc_scores as jax_patch_ncc
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.ops.allview_ncc import allview_scores_plain
from densepoints_tpu_torch.ops.warp import compact_visible, patch_frames
from densepoints_tpu_torch.ops.warp_ncc import slot_scores_plain
from densepoints_tpu_torch.pmvs.optimize import _anchor_chunks
from densepoints_tpu_torch.scripts import (
    _rigs,
    _timing,
    kernel_bench,
    kernel_paged_bench,
    kernel_roofline,
)
from tests.torch_port_util import cuda_device  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
SCORE_ATOL = 1e-4  # plain all-views vs plain chunked vs JAX XLA, f32
CAM_FIELDS = ("P", "K", "E", "C", "x_axis", "width", "height")


def jax_script(name):
    """A module of the JAX package's `scripts/`, under its own name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same_cameras(got, want):
    """Port cameras equal to other cameras (port or JAX), field by field."""
    for f in CAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)


# --- the kernel inputs as chip_smoke.py built them before the move --------

def _old_look_at(C):
    z = -C / np.linalg.norm(C)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _old_cameras(Cs, focal, W, H, device):
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    P = []
    for C in Cs:
        R = _old_look_at(C)
        P.append(K @ np.concatenate([R, (-R @ C)[:, None]], 1))
    return Cameras.from_projection_matrices(np.stack(P), W, H, device=device)


def _old_refine_inputs(device):
    rng = np.random.default_rng(0)
    V, H, W, B = 8, 480, 640, 4096
    Cs = []
    for i in range(V):
        ang = (i - (V - 1) / 2) * 0.12
        Cs.append(np.array([6.0 * np.sin(ang), 0.2 * np.sin(2 * i),
                            -6.0 * np.cos(ang)]))
    cams = _old_cameras(Cs, 500.0, W, H, device)
    images = rng.uniform(0, 255, (V, H, W)).astype(np.float32)
    xy = rng.uniform(-1.0, 1.0, (B, 2))
    pos = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    ref = np.zeros((B,), np.int64)
    vis = np.ones((B, V), bool)
    vis[:, 0] = False
    mixed = slice(0, 256)
    ref[mixed] = rng.integers(0, V, 256)
    vis[mixed] = rng.uniform(size=(256, V)) > 0.3
    vis[np.arange(256), ref[mixed]] = False
    vis[256] = False
    pos[257:261] = [50.0, 50.0, 0.0]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return cams, t(images), t(pos), t(nrm), t(ref), t(vis)


def _old_dtu_inputs(device):
    rng = np.random.default_rng(1)
    V, H, W, B = 49, 1200, 1600, 16384
    yaws = np.linspace(-0.45, 0.45, 7)
    pitches = np.linspace(-0.225, 0.225, 7)
    Cs = [np.array([6.0 * np.sin(y), 6.0 * np.sin(p),
                    -6.0 * np.cos(y) * np.cos(p)])
          for p in pitches for y in yaws]
    cams = _old_cameras(Cs, 1500.0, W, H, device)
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.rand((V, H, W), generator=gen, device=device) * 255.0
    xy = rng.uniform(-1.0, 1.0, (B, 2))
    pos = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    ref = np.full((B,), 24, np.int64)
    vis = rng.uniform(size=(B, V)) < 0.51
    vis[:, 24] = False
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return cams, images, t(pos), t(nrm), t(ref), t(vis)


@pytest.mark.parametrize("name", ["refine_inputs", "dtu_inputs"])
def test_moved_rigs_are_bitwise_the_old_ones(name):
    old = {"refine_inputs": _old_refine_inputs,
           "dtu_inputs": _old_dtu_inputs}[name]("cpu")
    new = getattr(_rigs, name)("cpu")
    assert_same_cameras(new[0], old[0])
    for got, want in zip(new[1:], old[1:]):
        assert got.dtype == want.dtype and torch.equal(got, want)


# --- the JAX scripts' rigs --------------------------------------------------

@pytest.mark.parametrize("V,H,W,B,vis_frac", [(6, 120, 160, 64, 0.7),
                                              (9, 96, 128, 33, 1.0)])
def test_paged_bench_rig_is_the_jax_scripts(V, H, W, B, vis_frac):
    """`make_scene` of `scripts/kernel_paged_bench.py`, then the draws of
    its `bench` (`:106-116`)."""
    rng = np.random.default_rng(0)
    jax_cams, jax_images = jax_script("kernel_paged_bench").make_scene(
        rng, V, H, W)
    xy = rng.uniform(-0.4, 0.4, (B, 2))
    position = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    vis = rng.uniform(size=(B, V)) < vis_frac
    vis[:, 0] = False
    vis[:, 1] = True
    P, images, pos, nrm, ref, got_vis = _rigs.paged_bench_rig(
        V, H, W, B, vis_frac)
    assert_same_cameras(Cameras.from_projection_matrices(P, W, H), jax_cams)
    for got, want in ((images, jax_images), (pos, position), (nrm, normal),
                      (got_vis, vis), (ref, np.zeros(B, np.int64))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_kernel_bench_rig_is_the_jax_scripts():
    """The draws of `scripts/kernel_bench.py::main` (`:36-103`)."""
    from densepoints_tpu.core.cameras import Cameras as JaxCameras

    rng = np.random.default_rng(0)
    num_views, H, W = 8, 480, 640
    B, M, k = 4096, 8, 11
    S = -(-(k * k) // 128) * 128
    Kmat = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]])
    Ps = []
    for i in range(num_views):
        ang = (i - (num_views - 1) / 2) * 0.12
        C = np.array([6.0 * np.sin(ang), 0.2 * np.sin(2 * i),
                      -6.0 * np.cos(ang)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Ps.append(Kmat @ np.concatenate([R, (-R @ C)[:, None]], 1))
    jax_cams = JaxCameras.from_projection_matrices(np.stack(Ps), widths=W,
                                                   heights=H)
    images = rng.uniform(0, 255, (num_views, H, W)).astype(np.float32)
    rng.integers(0, (H - JAX_WIN_H) // 8, (B, M))
    rng.integers(0, (W - JAX_WIN_W) // 64, (B, M))
    rng.integers(0, num_views, (B, M))
    rng.uniform(10, 40, (B, M, 2, S))
    xy = rng.uniform(-1.0, 1.0, (B, 2))
    position = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    vis = np.ones((B, num_views), bool)
    vis[:, 0] = False
    P, got_images, pos, nrm, ref, got_vis = _rigs.kernel_bench_rig()
    assert_same_cameras(Cameras.from_projection_matrices(P, W, H), jax_cams)
    np.testing.assert_array_equal(got_images, images)
    np.testing.assert_array_equal(pos, position)
    np.testing.assert_array_equal(got_vis, vis)
    assert not ref.any() and (nrm == [0.0, 0.0, 1.0]).all()


def test_plane_problem_is_the_jax_scripts():
    images, jax_cams, state = jax_script("scaling_bench")._problem(96)
    P, got_images, pos, nrm, ref, vis = _rigs.plane_problem(96)
    assert_same_cameras(Cameras.from_projection_matrices(P, 320, 240),
                        jax_cams)
    np.testing.assert_array_equal(got_images, np.asarray(images))
    np.testing.assert_array_equal(pos, np.asarray(state.position))
    np.testing.assert_array_equal(nrm, np.asarray(state.normal))
    np.testing.assert_array_equal(ref, np.asarray(state.ref))
    np.testing.assert_array_equal(vis, np.asarray(state.vis))


# --- the two paths of kernel_paged_bench against the JAX package ----------

def test_paths_agree_with_each_other_and_jax():
    from densepoints_tpu.core.cameras import Cameras as JaxCameras

    k, msv = 11, 4
    P, images, pos, nrm, ref, vis = _rigs.paged_bench_rig(6, 120, 160, 64,
                                                          0.7)
    cams, t_images, t_pos, t_nrm, t_ref, t_vis = _rigs.to_device(
        "cpu", P, images, pos, nrm, ref, vis)
    chunks = _anchor_chunks(t_vis, msv)
    assert len(chunks) == 2
    allview, _, _ = kernel_paged_bench.allview_pass(
        t_images, cams, t_pos, t_nrm, t_ref, t_vis, k)
    chunked = kernel_paged_bench.chunked_pass(
        t_images, cams, t_pos, t_nrm, t_ref, t_vis, chunks, k)
    diff, only_one = kernel_paged_bench.path_difference(allview, chunks,
                                                        chunked)
    assert diff <= SCORE_ATOL and only_one == 0
    assert int((allview != -1).sum()) > 100

    jcams = JaxCameras.from_projection_matrices(P, widths=160, heights=120)
    jargs = (jnp.asarray(images), jcams, jnp.asarray(pos), jnp.asarray(nrm),
             jnp.asarray(ref.astype(np.int32)), jnp.asarray(vis), k)
    want, _, _ = allview_scores_xla(*jargs)
    want = np.asarray(want)
    np.testing.assert_array_equal(allview.numpy() == -1, want == -1)
    np.testing.assert_allclose(allview.numpy(), want, rtol=0,
                               atol=SCORE_ATOL)
    for (ids, ok), scores, (jids, jok) in zip(
            chunks, chunked, jax_chunks(jnp.asarray(vis), msv)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        jscores, _, _ = jax_patch_ncc(*jargs, impl="xla", view_ids=jids,
                                      ok=jok)
        jscores = np.asarray(jscores)
        np.testing.assert_array_equal(scores.numpy() == -1, jscores == -1)
        np.testing.assert_allclose(scores.numpy(), jscores, rtol=0,
                                   atol=SCORE_ATOL)


# --- byte and operation counts by hand --------------------------------------

def _hand_pixels(cams, images, pos, nrm, ref, pairs, k):
    """Distinct pixels of the stack that the bilinear taps of the textures
    `pairs` names read, as a set of (view, row, column): each texel's pixel
    from the plain scoring path's grid and projection, clamped to the view,
    and its four taps."""
    V, H, W = images.shape
    sx, sy = patch_frames(cams, pos, nrm, ref, k)
    coords = 2.0 * torch.arange(k, dtype=pos.dtype) / k - 1.0
    tt, ss = torch.meshgrid(coords, coords, indexing="ij")
    world = (pos[:, None, None, :] + ss[..., None] * sx[:, None, None, :]
             + tt[..., None] * sy[:, None, None, :])
    pix = cams.project(world).numpy()  # (V, B, k, k, 2)
    taps = set()
    for b, v in zip(*np.nonzero(pairs.numpy())):
        for x, y in pix[v, b].reshape(-1, 2):
            x0 = min(max(int(np.floor(min(max(x, 0), W - 1))), 0), W - 2)
            y0 = min(max(int(np.floor(min(max(y, 0), H - 1))), 0), H - 2)
            taps |= {(v, y0 + dy, x0 + dx) for dy in (0, 1) for dx in (0, 1)}
    return len(taps)


def _hand_count(B, V, pixels, textures, k, others_bytes):
    """Bytes and f32 operations of a warp + NCC function, by hand: the
    cameras (K 36, E 48, C 12, x_axis 12, width 4, height 4 bytes per
    view), position and normal (12 each), ref (8) per patch, the
    function's own tables and outputs, and 4 B per distinct pixel its taps
    read; 96 operations per patch, 47 per texel and 54 per texture."""
    nbytes = (pixels * 4 + V * (36 + 48 + 12 + 12 + 4 + 4) + B * 32
              + others_bytes)
    return nbytes, B * 96 + textures * (k * k * 47 + 54)


@pytest.fixture(scope="module")
def tiny():
    """A tiny rig of the paged bench, on the CPU."""
    return _rigs.to_device("cpu", *_rigs.paged_bench_rig(6, 120, 160, 64,
                                                         0.7))


def test_counts_by_hand(tiny):
    cams, images, pos, nrm, ref, vis = tiny
    V, H, W = images.shape
    B, k = pos.shape[0], 11
    scores, anchor, anchor_ok = allview_scores_plain(images, cams, pos, nrm,
                                                     ref, vis, k)
    # Textures: every scored slot and every valid anchor.
    pairs = scores != -1
    pairs[torch.arange(B), anchor] |= anchor_ok
    textures = int((scores != -1).sum()) + int(anchor_ok.sum())
    assert int(pairs.sum()) == textures
    pixels = _hand_pixels(cams, images, pos, nrm, ref, pairs, k)
    # Neighbouring texels share taps: far fewer than 4 per texel.
    assert 0 < pixels < textures * k * k
    # vis B V bool, scores B V f32, anchor B int64, anchor_ok B bool
    want = _hand_count(B, V, pixels, textures, k, B * V * 5 + B * 9)
    out = (scores, anchor, anchor_ok)
    assert _timing.allview_counts(images, cams, pos, nrm, ref, vis, out,
                                  k) == want
    calls = kernel_roofline.kernel_calls(cams, images, pos, nrm, ref, vis,
                                         *compact_visible(vis, 4))
    assert calls["allview_ncc"][1](out) == want

    ids, ok = compact_visible(vis, 4)
    slot = slot_scores_plain(images, cams, pos, nrm, ref, ids, ok, k)
    pairs = torch.zeros((B, V), dtype=torch.bool)
    for b, m in (slot != -1).nonzero().tolist():
        pairs[b, ids[b, m]] = True
    pixels = _hand_pixels(cams, images, pos, nrm, ref, pairs, k)
    # ids B M int32, ok B M bool, scores B M f32
    want = _hand_count(B, V, pixels, int((slot != -1).sum()), k, B * 4 * 9)
    assert _timing.slot_counts(images, cams, pos, nrm, ref, ids, ok, slot,
                               k) == want
    calls = kernel_roofline.kernel_calls(cams, images, pos, nrm, ref, vis,
                                         ids, ok)
    assert calls["slot_ncc"][1](slot) == want


def test_tap_pixels_counts_a_shared_pixel_once(tiny):
    """Two copies of every patch read the pixels of one copy; one patch in
    its reference view (texels 10/11 px apart) reads no more than its
    (k + 1)^2 footprint."""
    cams, images, pos, nrm, ref, vis = tiny
    k = 11
    one = _timing.tap_pixels(images, cams, pos, nrm, ref, vis, k)
    two = _timing.tap_pixels(images, cams, torch.cat([pos, pos]),
                             torch.cat([nrm, nrm]), torch.cat([ref, ref]),
                             torch.cat([vis, vis]), k)
    assert one == two > 0
    single = torch.zeros_like(vis)
    single[0, int(ref[0])] = True  # the reference view: ~1 px per texel
    assert 4 <= _timing.tap_pixels(images, cams, pos, nrm, ref, single,
                                   k) <= (k + 1) ** 2


@pytest.mark.parametrize("program", [kernel_bench, kernel_paged_bench,
                                     kernel_roofline])
def test_kernel_programs_refuse_the_cpu(program):
    with pytest.raises(ValueError, match="CUDA card"):
        program.run(program.parse_args(["--device", "cpu"]))


@pytest.mark.cuda
def test_programs_on_card(cuda_device, monkeypatch):
    """Each kernel program at a tiny shape on the card: finite records, K1
    and K2 launched, no plain call, the two paths agreeing."""
    dev = str(cuda_device)
    rec = kernel_bench.run(kernel_bench.parse_args(
        ["--device", dev, "--config", '{"patches": 64, "reps": 3}']))
    assert rec["launches"]["slot_ncc"] > 0 and rec["plain_calls"] == 0
    assert rec["max_abs_diff_levels"] == 0.0
    monkeypatch.setitem(kernel_paged_bench.SHAPES, "tiny",
                        ("tiny", 6, 120, 160, 64, 0.7))
    rec = kernel_paged_bench.run(kernel_paged_bench.parse_args(
        ["--device", dev, "--shapes", "tiny", "--msv", "4", "--reps", "3"]))
    shape, = rec["shapes"]
    assert shape["max_abs_diff_chunked_vs_allview"] <= SCORE_ATOL
    assert rec["launches"]["allview_ncc"] > 0
    assert rec["launches"]["slot_ncc"] > 0 and rec["plain_calls"] == 0
    monkeypatch.setattr(kernel_roofline, "shape_inputs",
                        lambda name, device: _tiny_roofline_inputs(device))
    rec = kernel_roofline.run(kernel_roofline.parse_args(
        ["--device", dev, "--reps", "3"]))
    assert len(rec["shapes"]) == 4
    assert all(e["bound_share"] > 0 for e in rec["shapes"])
    assert rec["launches"]["allview_ncc"] > 0 and rec["plain_calls"] == 0


def _tiny_roofline_inputs(device):
    cams, images, pos, nrm, ref, vis = _rigs.to_device(
        device, *_rigs.paged_bench_rig(6, 120, 160, 64, 0.7))
    return (cams, images, pos, nrm, ref, vis, *compact_visible(vis, 4))
