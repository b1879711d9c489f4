"""The port's row-wise NCC (`ops.ncc.ncc_pairs`) and patch scores vs JAX.

On CPU tensors `ncc_pairs` runs its plain version. It must meet
`densepoints_tpu.core.scores.ncc_score` and the Pallas kernel
`ncc_pairs_pallas` (interpret mode) at atol 1e-5: f32 on every side, only
the summation order differs. `ssd_score`, `sad_score` and
`ncc_score_by_channel` meet their JAX counterparts at 1e-5 relative (SSD of
grey levels reaches ~1e4, so the bound is relative there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.core import scores as jax_scores
from densepoints_tpu.ops.ncc import ncc_pairs_pallas
from densepoints_tpu_torch.core import scores
from densepoints_tpu_torch.ops import ncc
from tests.torch_port_util import cuda_device  # noqa: F401

ATOL = 1e-5
# Each register tier of the CUDA kernel's group body (G = 8 lanes a row
# holding C = 1 ... 8 elements each up to L = 64, G = 16 with C = 5 ... 8 up
# to 128, G = 32 with C = 5 ... 8 up to 256; ragged and full last chunks)
# and its strided body above 256.
LENGTHS = [1, 12, 17, 31, 32, 33, 45, 50, 64, 65, 90, 100, 121, 129, 170,
           200, 255, 256, 257, 300]


def _pairs(rng, N, L, masked):
    a = rng.uniform(0, 255, (N, L)).astype(np.float32)
    b = (0.6 * a + 0.4 * rng.uniform(0, 255, (N, L))).astype(np.float32)
    if N < 4:
        mask = rng.uniform(size=(N, L)) > 0.3 if masked else None
        return a, b, mask
    b[1] = rng.uniform(0, 255, L)  # an uncorrelated row
    a[2] = 7.0  # a flat row: the 0.1 clamp decides
    mask = None
    if masked:
        mask = rng.uniform(size=(N, L)) > 0.3
        mask[0] = False  # an empty mask: the -1 sentinel
        mask[3] = False
        mask[3, L // 2] = True  # a single entry
    return a, b, mask


def _torch(fn, a, b, mask):
    t = torch.as_tensor
    return fn(t(a), t(b), None if mask is None else t(mask)).numpy()


def _jax(fn, a, b, mask, **kw):
    j = jnp.asarray
    return np.asarray(fn(j(a), j(b), None if mask is None else j(mask), **kw))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L", LENGTHS)
def test_ncc_pairs_matches_ncc_score(rng, L, masked):
    a, b, mask = _pairs(rng, 40, L, masked)
    got = _torch(ncc.ncc_pairs, a, b, mask)
    want = _jax(jax_scores.ncc_score, a, b, mask)
    assert got.dtype == np.float32 and got.shape == (40,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if masked:
        assert got[0] == -1.0 and got[3] != -1.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L", LENGTHS)
def test_ncc_pairs_matches_pallas_kernel(rng, L, masked):
    a, b, mask = _pairs(rng, 40, L, masked)
    got = _torch(ncc.ncc_pairs, a, b, mask)
    want = _jax(ncc_pairs_pallas, a, b, mask, interpret=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got == -1.0, want == -1.0)


def _bright_flat_pairs(rng, N, L):
    """Rows of mean ~200 and spread ~2: variances ~1.3, above the 0.1
    clamp, where a one-pass sum of squares (~1e7 at L = 256, an f32 ulp of
    ~1) would lose them; the statistics are taken in two passes."""
    a = (200.0 + rng.uniform(-2, 2, (N, L))).astype(np.float32)
    b = (200.0 + 0.5 * (a - 200.0) + rng.uniform(-1, 1, (N, L))).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("masked", [False, True])
def test_ncc_pairs_two_pass_on_bright_flat_rows(rng, masked):
    a, b = _bright_flat_pairs(rng, 40, 256)
    mask = rng.uniform(size=a.shape) > 0.3 if masked else None
    got = _torch(ncc.ncc_pairs, a, b, mask)
    want = _jax(jax_scores.ncc_score, a, b, mask)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got > 0.3).all()  # correlated, and not flattened by the clamp


def test_ncc_pairs_golden_value():
    A = np.array([[1, 2, 3, -1, -2, -3, 1, 2, 3]], np.float32)
    B = np.array([[2, 0, 5, -4, 5, -2, -1, 0, -3]], np.float32)
    got = _torch(ncc.ncc_pairs, A, B, None)
    np.testing.assert_allclose(got[0], 0.1005653, rtol=1e-5)


def test_ncc_pairs_casts_to_f32(rng):
    a, b, mask = _pairs(rng, 8, 121, True)
    got = _torch(ncc.ncc_pairs, a.astype(np.float64), b.astype(np.float64),
                 mask)
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, _jax(jax_scores.ncc_score, a, b, mask), atol=ATOL, rtol=0
    )


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["ssd_score", "sad_score"])
def test_difference_scores_match(rng, name, masked):
    a, b, mask = _pairs(rng, 20, 121, masked)
    got = _torch(getattr(scores, name), a, b, mask)
    want = _jax(getattr(jax_scores, name), a, b, mask)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    if masked:
        assert got[0] == -1.0


@pytest.mark.parametrize("masked", [False, True])
def test_ncc_score_by_channel_matches(rng, masked):
    a = rng.uniform(0, 255, (12, 49, 3)).astype(np.float32)
    b = (0.5 * a + 0.5 * rng.uniform(0, 255, a.shape)).astype(np.float32)
    mask = rng.uniform(size=(12, 49)) > 0.3 if masked else None
    got = _torch(scores.ncc_score_by_channel, a, b, mask)
    want = _jax(jax_scores.ncc_score_by_channel, a, b, mask)
    assert scores.NCC_CHANNEL_MIN_DENOM == jax_scores.NCC_CHANNEL_MIN_DENOM
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_path(rng):
    a, b, mask = _pairs(rng, 8, 121, True)
    launches, plain = ncc.KERNEL_LAUNCHES, ncc.PLAIN_CALLS
    _torch(ncc.ncc_pairs, a, b, mask)
    assert ncc.PLAIN_CALLS == plain + 1
    assert ncc.KERNEL_LAUNCHES == launches


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    a, b, _ = _pairs(rng, 8, 121, False)
    with pytest.raises(ValueError, match="CUDA"):
        ncc.ncc_pairs_cuda(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", [1, 3001, 20001])
@pytest.mark.parametrize("L", LENGTHS)
def test_kernel_matches_plain_on_card(rng, cuda_device, L, N, masked):
    """The CUDA kernel vs the plain version on the card (f32 both: 1e-5),
    with equal -1 placement; N = 20001 is more rows than one wave of warps,
    so each warp walks several."""
    a, b, mask = _pairs(rng, N, L, masked)
    if N > 8:
        a[4:8], b[4:8] = _bright_flat_pairs(rng, 4, L)
    t = lambda x: None if x is None else torch.as_tensor(  # noqa: E731
        x, dtype=torch.float32, device=cuda_device)
    want = ncc.ncc_pairs_plain(t(a), t(b), t(mask))
    launches = ncc.KERNEL_LAUNCHES
    got = ncc.ncc_pairs(t(a), t(b), t(mask))
    assert ncc.KERNEL_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(got == -1, want == -1)
    assert float((got - want).abs().max()) <= ATOL
