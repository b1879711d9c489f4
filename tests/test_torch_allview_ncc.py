"""The port's all-views warp+NCC scoring pass vs the JAX package.

The plain torch version must meet `allview_scores_xla` (the contract) at
atol 1e-4: both sample in f32 through the decomposed projection, so only
the summation order differs. Against the Pallas kernel `paged_all_scores`
(interpret mode) the bound is 2e-3: the TPU kernel samples bf16 pages
(tests/ops/test_warp_ncc_paged.py uses the same bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.ops.warp import bilinear_sample as jax_bilinear
from densepoints_tpu.ops.warp import patch_frames as jax_frames
from densepoints_tpu.ops.warp import patch_textures as jax_textures
from densepoints_tpu.ops.warp_ncc_paged import (
    allview_scores_xla,
    paged_all_scores,
)
from densepoints_tpu_torch.ops import allview_ncc
from densepoints_tpu_torch.ops.warp import (
    bilinear_sample,
    patch_frames,
    patch_textures,
)
from tests.synthetic import TexturedPlaneScene
from tests.torch_port_util import (  # noqa: F401
    awkward_rig,
    cuda_device,
    torch_cameras,
)

XLA_ATOL = 1e-4
PAGED_ATOL = 2e-3


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


def _jax(fn, cams, images, pos, nrm, refs, vis, k, **kw):
    out = fn(
        jnp.asarray(images), cams, jnp.asarray(pos), jnp.asarray(nrm),
        jnp.asarray(refs), jnp.asarray(vis), k, **kw,
    )
    return tuple(np.asarray(o) for o in out)


def _torch(cams, images, pos, nrm, refs, vis, k):
    out = allview_ncc.allview_scores(
        torch.as_tensor(images), torch_cameras(cams), torch.as_tensor(pos),
        torch.as_tensor(nrm), torch.as_tensor(refs).long(),
        torch.as_tensor(vis), k,
    )
    return tuple(o.numpy() for o in out)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("k", [11, 16])
def test_plain_matches_xla_contract(rng, k, mixed):
    cams, images = _setup(rng)
    args = (cams, images, *_patches(rng, 16, cams.num_views, mixed), k)
    ref_s, ref_a, ref_ok = _jax(allview_scores_xla, *args)
    s, a, ok = _torch(*args)
    np.testing.assert_array_equal(a, ref_a)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(s == -1.0, ref_s == -1.0)
    np.testing.assert_allclose(s, ref_s, atol=XLA_ATOL, rtol=0)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("k", [11, 16])
def test_plain_matches_paged_kernel(rng, k, mixed):
    cams, images = _setup(rng)
    args = (cams, images, *_patches(rng, 16, cams.num_views, mixed), k)
    ref_s, ref_a, ref_ok = _jax(paged_all_scores, *args, interpret=True)
    s, a, ok = _torch(*args)
    np.testing.assert_array_equal(a, ref_a)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_allclose(s, ref_s, atol=PAGED_ATOL, rtol=0)


def test_no_visibility_row_is_all_minus_one(rng):
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 8, cams.num_views, mixed=True)
    s, _, ok = _torch(cams, images, pos, nrm, refs, vis, 11)
    assert not vis[0].any()
    assert np.all(s[0] == -1.0)
    assert not ok[0]


def test_off_frustum_sentinel(rng):
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 16, cams.num_views)
    pos[1] = [50.0, 50.0, 0.0]
    ref_s, _, ref_ok = _jax(
        allview_scores_xla, cams, images, pos, nrm, refs, vis, 11
    )
    s, _, ok = _torch(cams, images, pos, nrm, refs, vis, 11)
    assert np.all(s[1] == -1.0) and not ok[1]
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_allclose(s, ref_s, atol=XLA_ATOL, rtol=0)


def test_anchor_column_is_minus_one(rng):
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 10, cams.num_views, mixed=True)
    s, a, _ = _torch(cams, images, pos, nrm, refs, vis, 11)
    assert np.all(s[np.arange(10), a] == -1.0)
    assert np.all(s[~vis] == -1.0)


@pytest.mark.parametrize("k", [11, 16])
def test_warp_pieces_match(rng, k):
    """patch_frames and patch_textures, the plain path's building blocks:
    frames within 1e-5; textures within 5e-3 grey levels of [0, 255] (f32
    projections differ by ~1e-5 px, times texture gradients of ~100 grey
    levels per px)."""
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 16, cams.num_views, mixed=True)
    tc = torch_cameras(cams)
    jpos, jnrm, jref = jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(refs)
    jsx, jsy = jax_frames(cams, jpos, jnrm, jref, k)
    sx, sy = patch_frames(
        tc, torch.as_tensor(pos), torch.as_tensor(nrm),
        torch.as_tensor(refs).long(), k,
    )
    np.testing.assert_allclose(sx.numpy(), np.asarray(jsx), atol=1e-5)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jsy), atol=1e-5)
    jtex, jvalid = jax_textures(
        jnp.asarray(images), cams, jpos, jnrm, jref, jnp.asarray(vis), k
    )
    tex, valid = patch_textures(
        torch.as_tensor(images), tc, torch.as_tensor(pos),
        torch.as_tensor(nrm), torch.as_tensor(refs).long(),
        torch.as_tensor(vis), k,
    )
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tex.numpy(), np.asarray(jtex), atol=5e-3)


def test_bilinear_sample_matches(rng):
    image = rng.uniform(0, 255, (20, 30)).astype(np.float32)
    xy = rng.uniform(-3, 33, (50, 2)).astype(np.float32)
    got = bilinear_sample(torch.as_tensor(image), torch.as_tensor(xy))
    want = jax_bilinear(jnp.asarray(image), jnp.asarray(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_cpu_tensors_take_the_plain_path(rng):
    cams, images = _setup(rng)
    args = (cams, images, *_patches(rng, 4, cams.num_views), 11)
    launches, plain = allview_ncc.KERNEL_LAUNCHES, allview_ncc.PLAIN_CALLS
    _torch(*args)
    assert allview_ncc.PLAIN_CALLS == plain + 1
    assert allview_ncc.KERNEL_LAUNCHES == launches


def _kernel_args(tc, images, pos, nrm, refs, vis, k, device="cpu"):
    """Arguments of `allview_scores_cuda` from a Cameras and arrays."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return [t(images), tc.K, tc.E, tc.C, tc.x_axis, tc.width, tc.height,
            t(pos), t(nrm), t(refs).long(), t(vis), k]


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 4, cams.num_views)
    with pytest.raises(ValueError, match="CUDA"):
        allview_ncc.allview_scores_cuda(
            *_kernel_args(torch_cameras(cams), images, pos, nrm, refs, vis, 11)
        )


@pytest.mark.parametrize("case", [
    "page_2_31", "k_zero", "k_too_large", "too_many_views", "normal_batch",
    "ref_batch",
])
def test_kernel_wrapper_validates_shapes(rng, case):
    """Shapes the kernel does not take raise `ValueError` before any launch
    (so also here, where there is no card): a view of 2^31 pixels or more
    (offsets inside a view are 32-bit), a texture side outside the range,
    more views than a block's shared memory holds, and position, normal
    and ref of different batch sizes."""
    cams, images = _setup(rng)
    V = cams.num_views
    pos, nrm, refs, vis = _patches(rng, 4, V)
    args = _kernel_args(torch_cameras(cams), images, pos, nrm, refs, vis, 11)
    match = "shared memory"
    if case == "page_2_31":  # a stack with no storage: only its shape counts
        args[0] = torch.empty((V, 2**16, 2**15), device="meta")
        match = "2\\^31"
    elif case == "k_zero":
        args[-1] = 0
    elif case == "k_too_large":
        args[-1] = 60
    elif case == "too_many_views":
        many = 300
        args[0] = torch.empty((many, 16, 16), device="meta")
        args[1] = torch.empty((many, 3, 3), device="meta")
    elif case == "normal_batch":
        args[8] = args[8][:3]
        match = "one batch"
    elif case == "ref_batch":
        args[9] = args[9][:2]
        match = "one batch"
    launches = allview_ncc.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match=match):
        allview_ncc.allview_scores_cuda(*args)
    assert allview_ncc.KERNEL_LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("k", [11, 16])
def test_kernel_matches_plain_on_card(rng, cuda_device, k):
    """The CUDA kernel vs the plain version on the card (f32 both: 1e-4)."""
    cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(rng, 64, cams.num_views, mixed=True)
    pos[1] = [50.0, 50.0, 0.0]
    dev = cuda_device
    args = (
        torch.as_tensor(images, device=dev), torch_cameras(cams, dev),
        torch.as_tensor(pos, device=dev), torch.as_tensor(nrm, device=dev),
        torch.as_tensor(refs, device=dev).long(),
        torch.as_tensor(vis, device=dev), k,
    )
    launches = allview_ncc.KERNEL_LAUNCHES
    s, a, ok = allview_ncc.allview_scores(*args)
    ps, pa, pok = allview_ncc.allview_scores_plain(*args)
    torch.cuda.synchronize()
    assert allview_ncc.KERNEL_LAUNCHES == launches + 1
    assert torch.equal(a, pa) and torch.equal(ok, pok)
    assert torch.equal(s == -1, ps == -1)
    assert float((s - ps).abs().max()) <= XLA_ATOL


def _awkward_rig(rng, V, B, device):
    P, images, pos, nrm, refs, vis = awkward_rig(rng, V, B)
    cams = JaxCameras.from_projection_matrices(P, widths=160, heights=120)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (t(images), torch_cameras(cams, device), t(pos), t(nrm),
            t(refs).long(), t(vis))


@pytest.mark.cuda
@pytest.mark.parametrize("V,B,k", [
    (1, 33, 11), (49, 64, 11), (130, 40, 5), (130, 40, 16), (8, 64, 1),
    (8, 64, 5), (8, 64, 7), (8, 64, 11), (8, 64, 16), (8, 64, 21),
    (8, 1, 11), (8, 0, 11),
])
def test_kernel_awkward_shapes_on_card(rng, cuda_device, V, B, k):
    """Kernel vs plain on the card where the kernel's control flow is
    stressed: one view, more views than a warp has lanes, textures with
    fewer texels than lanes (k = 1, 5), two texels per lane (k = 7) and the
    strided variant (k = 21),
    batches of 0 and 1, a row with no visible view, rows off every frustum.
    Scores within 1e-4, equal anchors, equal sentinel placement."""
    args = (*_awkward_rig(rng, V, B, cuda_device), k)
    launches = allview_ncc.KERNEL_LAUNCHES
    s, a, ok = allview_ncc.allview_scores(*args)
    ps, pa, pok = allview_ncc.allview_scores_plain(*args)
    torch.cuda.synchronize()
    assert allview_ncc.KERNEL_LAUNCHES == launches + (1 if B else 0)
    assert s.shape == (B, V) and s.dtype == torch.float32
    assert torch.equal(a, pa) and torch.equal(ok, pok)
    assert torch.equal(s == -1, ps == -1)
    assert bool(torch.isfinite(s).all())
    if B:
        assert float((s - ps).abs().max()) <= XLA_ATOL
    if B > 8:
        assert bool((s[2] == -1).all()) and bool((s[4:8] == -1).all())


@pytest.mark.cuda
def test_entry_point_launches_only_its_kernel(rng, cuda_device):
    """On CUDA tensors `allview_scores` runs one device kernel, its own:
    the patch frames are computed inside it, no torch op comes before."""
    from torch.profiler import ProfilerActivity, profile

    args = (*_awkward_rig(rng, 8, 64, cuda_device), 11)
    allview_ncc.allview_scores(*args)  # build and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        allview_ncc.allview_scores(*args)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               for _ in range(e.count)]
    assert len(kernels) == 1 and "allview_ncc_kernel" in kernels[0], kernels
