"""The port's compacted-slot scoring pass vs the JAX package.

On CPU tensors `patch_ncc_scores(impl="auto")` runs `slot_scores_plain` and
`impl="xla"` runs the gather route with the plain row-wise NCC. Both must
meet JAX `patch_ncc_scores(impl="xla")` at atol 1e-4 (f32 on both sides,
summation order only) with `view_ids`/`ok` and the -1 sentinels equal.
Against the Pallas kernel `patch_ncc_scores_fused` (interpret mode, resident
and streaming variants) the bound is 2e-3 on central-footprint patches: the
TPU kernel samples bf16 images and clamps samples to its window
(tests/ops/test_warp_ncc.py states the same bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.ops import warp_ncc as jax_warp_ncc
from densepoints_tpu.ops.warp import compact_visible as jax_compact
from densepoints_tpu.ops.warp import patch_textures_indexed as jax_indexed
from densepoints_tpu.pmvs.optimize import patch_ncc_scores as jax_scores
from densepoints_tpu_torch.ops import warp_ncc
from densepoints_tpu_torch.ops.warp import (
    compact_visible,
    patch_textures_indexed,
)
from densepoints_tpu_torch.pmvs.optimize import patch_ncc_scores
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import (  # noqa: F401
    awkward_rig,
    cuda_device,
    torch_cameras,
)

XLA_ATOL = 1e-4
FUSED_ATOL = 2e-3


def _setup(rng):
    scene = TexturedPlaneScene(rng, num_views=5, width=200, height=160)
    cams = JaxCameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    return cams, scene.render_all()


def _patches(rng, n, V, mixed=False):
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    position = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    if mixed:
        refs = rng.integers(0, V, (n,)).astype(np.int32)
        vis = rng.uniform(size=(n, V)) > 0.3
        vis[np.arange(n), refs] = False
        vis[0] = False  # a patch with no visible views at all
    else:
        refs = np.zeros((n,), np.int32)
        vis = np.ones((n, V), bool)
        vis[:, 0] = False
    return position, normal, refs, vis


def _jax(fn, cams, images, pos, nrm, refs, vis, k, view_ids=None, ok=None,
         **kw):
    if view_ids is not None:
        kw.update(view_ids=jnp.asarray(view_ids), ok=jnp.asarray(ok))
    out = fn(
        jnp.asarray(images), cams, jnp.asarray(pos), jnp.asarray(nrm),
        jnp.asarray(refs), jnp.asarray(vis), k, **kw,
    )
    return tuple(np.asarray(o) for o in out)


def _targs(cams, images, pos, nrm, refs, vis, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (t(images), torch_cameras(cams, device), t(pos), t(nrm),
            t(refs).long(), t(vis))


def _torch(cams, images, pos, nrm, refs, vis, k, view_ids=None, ok=None,
           **kw):
    if view_ids is not None:
        kw.update(view_ids=torch.as_tensor(view_ids), ok=torch.as_tensor(ok))
    out = patch_ncc_scores(*_targs(cams, images, pos, nrm, refs, vis), k, **kw)
    return tuple(o.numpy() for o in out)


@pytest.mark.parametrize("max_views", [3, 16])
def test_compact_visible_matches(rng, max_views):
    vis = rng.uniform(size=(40, 7)) > 0.4
    vis[0] = False
    vis[1] = True
    jids, jok = jax_compact(jnp.asarray(vis), max_views)
    ids, ok = compact_visible(torch.as_tensor(vis), max_views)
    assert ids.dtype == torch.int32 and ok.dtype == torch.bool
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("k", [11, 16])
def test_patch_textures_indexed_matches(rng, k):
    """Textures within 5e-3 grey levels of [0, 255] (f32 projections differ
    by ~1e-5 px, times texture gradients of ~100 grey levels per px: the
    bound `patch_textures` is held to); `valid` exactly."""
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 16, cams.num_views, mixed=True)
    pos[2] = [50.0, 50.0, 0.0]
    jids, jok = jax_compact(jnp.asarray(vis), 16)
    jtex, jvalid = jax_indexed(
        jnp.asarray(images), cams, jnp.asarray(pos), jnp.asarray(nrm),
        jnp.asarray(refs), jids, jok, k,
    )
    im, tc, p, n, r, _ = _targs(cams, images, pos, nrm, refs, vis)
    tex, valid = patch_textures_indexed(
        im, tc, p, n, r, torch.as_tensor(np.array(jids)),
        torch.as_tensor(np.array(jok)), k,
    )
    assert tex.shape == (16, cams.num_views, k, k)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not valid[2].any() and valid.any()
    np.testing.assert_allclose(tex.numpy(), np.asarray(jtex), atol=5e-3)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("k", [11, 16])
def test_slot_scores_match_xla_contract(rng, k, mixed, impl):
    cams, images = _setup(rng)
    args = (cams, images, *_patches(rng, 12, cams.num_views, mixed), k)
    ref_s, ref_ids, ref_ok = _jax(jax_scores, *args, impl="xla")
    s, ids, ok = _torch(*args, impl=impl)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(s == -1.0, ref_s == -1.0)
    np.testing.assert_allclose(s, ref_s, atol=XLA_ATOL, rtol=0)
    assert (s[ok] != -1.0).any()
    if mixed:  # the row with no visible view
        assert np.all(s[0] == -1.0) and not ok[0].any()


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("k", [11, 16])
def test_slot_scores_match_pallas_kernel(rng, monkeypatch, k, streaming):
    if streaming:  # force the TPU kernel's DMA variant
        monkeypatch.setattr(jax_warp_ncc, "RESIDENT_LIMIT_BYTES", 0)
    cams, images = _setup(rng)
    args = (cams, images, *_patches(rng, 12 if k == 11 else 4,
                                    cams.num_views), k)
    ref_s, ref_ids, ref_ok = _jax(
        jax_warp_ncc.patch_ncc_scores_fused, *args, interpret=True
    )
    s, ids, ok = _torch(*args)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_allclose(s, ref_s, atol=FUSED_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_off_frustum_sentinel(rng, impl):
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 6, cams.num_views)
    pos[1] = [50.0, 50.0, 0.0]
    ref_s, _, _ = _jax(jax_scores, cams, images, pos, nrm, refs, vis, 11,
                       impl="xla")
    s, _, ok = _torch(cams, images, pos, nrm, refs, vis, 11, impl=impl)
    assert np.all(s[1] == -1.0) and ok[1].any()
    np.testing.assert_allclose(s, ref_s, atol=XLA_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_explicit_slots_replace_the_compaction(rng, impl):
    """Explicit view_ids/ok: a chosen subset, ok False slots that carry a
    live view id, and the anchor's id repeated with ok False (the tail of
    an anchor-pinned chunk)."""
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 8, cams.num_views)
    view_ids = np.tile(np.array([1, 3, 4, 2, 1], np.int32), (8, 1))
    ok = np.ones((8, 5), bool)
    ok[:, 3] = False  # a live view, not to be scored
    ok[:, 4] = False  # the anchor's id as padding
    ok[5, 0] = False  # an anchor that is not ok: the whole row is -1
    args = (cams, images, pos, nrm, refs, vis, 11)
    ref_s, ref_ids, ref_ok = _jax(jax_scores, *args, view_ids, ok, impl="xla")
    s, ids, got_ok = _torch(*args, view_ids, ok, impl=impl)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(got_ok, ref_ok)
    np.testing.assert_array_equal(s == -1.0, ref_s == -1.0)
    np.testing.assert_allclose(s, ref_s, atol=XLA_ATOL, rtol=0)
    assert np.all(s[:, 3:] == -1.0) and np.all(s[5] == -1.0)
    assert np.all(s[:5, :3] != -1.0)


def test_flat_anchor_scores_below_one(rng):
    """Slot 0 against itself is variance / max(variance, 0.1): 1 for a
    textured anchor, below 1 for a nearly constant image region."""
    cams, images = _setup(rng)
    flat = (100.0 + 0.2 * rng.uniform(-1, 1, images.shape)).astype(np.float32)
    patches = _patches(rng, 6, cams.num_views)
    ref_s, _, _ = _jax(jax_scores, cams, flat, *patches, 11, impl="xla")
    s, _, ok = _torch(cams, flat, *patches, 11)
    assert ok[:, 0].all() and np.all(s[:, 0] > 0.0) and np.all(s[:, 0] < 0.5)
    np.testing.assert_allclose(s, ref_s, atol=XLA_ATOL, rtol=0)
    textured, _, _ = _torch(cams, images, *patches, 11)
    np.testing.assert_allclose(textured[:, 0], 1.0, atol=1e-5)


def test_impl_dispatch_raises(rng):
    cams, images = _setup(rng)
    args = (cams, images, *_patches(rng, 4, cams.num_views), 11)
    with pytest.raises(ValueError, match="CUDA"):
        _torch(*args, impl="fused")  # the kernel has no CPU mode
    with pytest.raises(ValueError, match="unknown sampling impl"):
        _torch(*args, impl="paged")


def test_cpu_tensors_take_the_plain_path(rng):
    cams, images = _setup(rng)
    args = (cams, images, *_patches(rng, 4, cams.num_views), 11)
    launches, plain = warp_ncc.KERNEL_LAUNCHES, warp_ncc.PLAIN_CALLS
    _torch(*args)
    assert warp_ncc.PLAIN_CALLS == plain + 1
    assert warp_ncc.KERNEL_LAUNCHES == launches


def test_gather_route_counts_in_ncc_not_as_slot_plain(rng):
    """`impl="xla"` is the gather route with `ncc_pairs`: on CPU tensors its
    plain call is counted by `ops.ncc`, never as a plain call of the slot
    kernel, and it equals the slot kernel's plain version bit for bit."""
    from densepoints_tpu_torch.ops import ncc

    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 6, cams.num_views, mixed=True)
    im, tc, p, n, r, v = _targs(cams, images, pos, nrm, refs, vis)
    before = warp_ncc.PLAIN_CALLS, ncc.PLAIN_CALLS
    s, ids, ok = patch_ncc_scores(im, tc, p, n, r, v, 11, impl="xla")
    assert (warp_ncc.PLAIN_CALLS, ncc.PLAIN_CALLS) == (before[0], before[1] + 1)
    want = warp_ncc.slot_scores_plain(im, tc, p, n, r, ids, ok, 11)
    got = warp_ncc.gather_scores(im, tc, p, n, r, ids, ok, 11,
                                 ncc.ncc_pairs_plain)
    assert torch.equal(s, want) and torch.equal(got, want)


def _kernel_args(targs, ids, ok, k):
    """Arguments of `slot_scores_cuda` from `_targs` and a slot table."""
    im, tc, p, n, r, _ = targs
    return [im, tc.K, tc.E, tc.C, tc.x_axis, tc.width, tc.height, p, n, r,
            ids, ok, k]


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 4, cams.num_views)
    targs = _targs(cams, images, pos, nrm, refs, vis)
    ids, ok = compact_visible(targs[5], 16)
    with pytest.raises(ValueError, match="CUDA"):
        warp_ncc.slot_scores_cuda(*_kernel_args(targs, ids, ok, 11))


@pytest.mark.parametrize("case", [
    "page_2_31", "k_zero", "k_too_large", "too_many_slots", "no_slots",
    "normal_batch", "ref_batch",
])
def test_kernel_wrapper_validates_shapes(rng, case):
    """Shapes the kernel does not take raise `ValueError` before any launch
    (so also here, where there is no card): a view of 2^31 pixels or more,
    a texture side outside the range, more slots than a block's shared
    memory holds, a slot table without slots, and position, normal and ref
    of different batch sizes."""
    cams, images = _setup(rng)
    V = cams.num_views
    pos, nrm, refs, vis = _patches(rng, 4, V)
    targs = _targs(cams, images, pos, nrm, refs, vis)
    ids, ok = compact_visible(targs[5], 16)
    args = _kernel_args(targs, ids, ok, 11)
    match = "shared memory"
    if case == "page_2_31":  # a stack with no storage: only its shape counts
        args[0] = torch.empty((V, 2**16, 2**15), device="meta")
        match = "2\\^31"
    elif case == "k_zero":
        args[-1] = 0
    elif case == "k_too_large":
        args[-1] = 60
    elif case == "too_many_slots":
        args[10] = torch.zeros((4, 300), dtype=torch.int32)
        args[11] = torch.ones((4, 300), dtype=torch.bool)
    elif case == "no_slots":
        args[10] = torch.zeros((4, 0), dtype=torch.int32)
        args[11] = torch.ones((4, 0), dtype=torch.bool)
        match = "M >= 1"
    elif case == "normal_batch":
        args[8] = args[8][:3]
        match = "one batch"
    elif case == "ref_batch":
        args[9] = args[9][:2]
        match = "one batch"
    launches = warp_ncc.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match=match):
        warp_ncc.slot_scores_cuda(*args)
    assert warp_ncc.KERNEL_LAUNCHES == launches


def test_plain_version_takes_an_empty_batch(rng):
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 4, cams.num_views)
    im, tc, p, n, r, v = _targs(cams, images, pos[:0], nrm[:0], refs[:0],
                                vis[:0])
    s, ids, ok = patch_ncc_scores(im, tc, p, n, r, v, 11)
    assert s.shape == ids.shape == ok.shape == (0, cams.num_views)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "fused", "xla"])
@pytest.mark.parametrize("k", [11, 16])
def test_kernels_match_plain_on_card(rng, cuda_device, k, impl):
    """On the card: the slot kernel ("auto", "fused") and the gather route
    through the row-wise NCC kernel ("xla") vs the plain version (1e-4)."""
    from densepoints_tpu_torch.ops import ncc

    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 64, cams.num_views, mixed=True)
    pos[1] = [50.0, 50.0, 0.0]
    args = _targs(cams, images, pos, nrm, refs, vis, cuda_device)
    launches = warp_ncc.KERNEL_LAUNCHES, ncc.KERNEL_LAUNCHES
    s, ids, ok = patch_ncc_scores(*args, k, max_score_views=4, impl=impl)
    im, tc, p, n, r, _ = args
    want = warp_ncc.slot_scores_plain(im, tc, p, n, r, ids, ok, k)
    torch.cuda.synchronize()
    now = warp_ncc.KERNEL_LAUNCHES, ncc.KERNEL_LAUNCHES
    assert now == ((launches[0], launches[1] + 1) if impl == "xla"
                   else (launches[0] + 1, launches[1]))
    assert torch.equal(s == -1, want == -1)
    assert float((s - want).abs().max()) <= XLA_ATOL


def _awkward_rig(rng, V, B, device):
    P, images, pos, nrm, refs, vis = awkward_rig(rng, V, B)
    cams = JaxCameras.from_projection_matrices(P, widths=160, heights=120)
    return _targs(cams, images, pos, nrm, refs, vis, device)


@pytest.mark.cuda
@pytest.mark.parametrize("V,B,k,M", [
    (1, 33, 11, 16), (49, 64, 11, 16), (130, 40, 5, 16), (130, 40, 16, 130),
    (8, 64, 1, 8), (8, 64, 5, 8), (8, 64, 7, 8), (8, 64, 16, 8),
    (8, 64, 21, 8), (8, 64, 11, 1), (8, 1, 11, 8), (8, 0, 11, 8),
])
def test_kernel_awkward_shapes_on_card(rng, cuda_device, V, B, k, M):
    """The slot kernel vs plain on the card where its control flow is
    stressed: one view, a table wider than a warp (130 slots), textures
    with fewer texels than lanes (k = 1, 5) and the strided variant
    (k = 21), a table of one slot, batches of 0 and 1, a row with no
    visible view, rows off every frustum."""
    im, tc, p, n, r, v = _awkward_rig(rng, V, B, cuda_device)
    ids, ok = compact_visible(v, M)
    launches = warp_ncc.KERNEL_LAUNCHES
    s = warp_ncc.slot_scores(im, tc, p, n, r, ids, ok, k)
    want = warp_ncc.slot_scores_plain(im, tc, p, n, r, ids, ok, k)
    torch.cuda.synchronize()
    assert warp_ncc.KERNEL_LAUNCHES == launches + (1 if B else 0)
    assert s.shape == (B, min(V, M)) and s.dtype == torch.float32
    assert torch.equal(s == -1, want == -1)
    assert bool(torch.isfinite(s).all()) and bool((s[~ok] == -1).all())
    if B:
        assert float((s - want).abs().max()) <= XLA_ATOL


@pytest.mark.cuda
def test_view_ids_outside_the_stack_are_dead_slots_on_card(rng, cuda_device):
    """A slot whose view id lies outside [0, V) scores -1 as if its ok were
    unset, and the other slots of its row are not disturbed."""
    im, tc, p, n, r, v = _awkward_rig(rng, 8, 64, cuda_device)
    ids, ok = compact_visible(v, 8)
    bad = ids.clone()
    bad[:, 3] = -1
    bad[:, 5] = 8 + 3
    dead = ok.clone()
    dead[:, 3] = False
    dead[:, 5] = False
    s = warp_ncc.slot_scores(im, tc, p, n, r, bad, ok, 11)
    want = warp_ncc.slot_scores_plain(im, tc, p, n, r, ids, dead, 11)
    torch.cuda.synchronize()
    assert bool((s[:, [3, 5]] == -1).all())
    assert torch.equal(s == -1, want == -1)
    assert float((s - want).abs().max()) <= XLA_ATOL


@pytest.mark.cuda
def test_entry_point_launches_only_its_kernel(rng, cuda_device):
    """On CUDA tensors `slot_scores` runs one device kernel, its own."""
    from torch.profiler import ProfilerActivity, profile

    im, tc, p, n, r, v = _awkward_rig(rng, 8, 64, cuda_device)
    ids, ok = compact_visible(v, 8)
    warp_ncc.slot_scores(im, tc, p, n, r, ids, ok, 11)  # build and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warp_ncc.slot_scores(im, tc, p, n, r, ids, ok, 11)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               for _ in range(e.count)]
    assert len(kernels) == 1 and "slot_ncc_kernel" in kernels[0], kernels
