"""The timer and the bounds of the port's measurement programs
(`densepoints_tpu_torch/scripts/_timing.py`).

The bounds and the number of rotated input sets are arithmetic on shapes
and a given L2 size, and run here. The timer needs a card: its tests are
marked `cuda`; they hold a back-to-back reading (10 calls queued behind a device-side sleep)
below the reading of one call between two events, for a kernel of about
0.01 ms, shorter than the host's time to launch it, and check that a list
of calls is taken in turn.
"""
import pytest
import torch

from densepoints_tpu_torch.scripts import _timing
from tests.torch_port_util import cuda_device  # noqa: F401


def test_bound_is_the_larger_of_bytes_and_operations():
    ms, by = _timing.bound(_timing.HBM_BYTES_PER_S / 1e3, 1.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = _timing.bound(1.0, 2 * _timing.F32_FLOPS_PER_S / 1e3)
    assert ms == pytest.approx(2.0) and by == "operations"


def test_nbytes_counts_every_element_once():
    assert _timing.nbytes(torch.zeros(3, 4), torch.zeros(5, dtype=torch.int64),
                          torch.zeros(2, dtype=torch.bool)) == 48 + 40 + 2


@pytest.mark.parametrize("texels,windows,image_bytes", [
    (10, 1000, 160),  # 16 B (4 taps) a texel
    (10**6, 1000, 40_000),  # no more than the image once
    (10**6, 2, 2 * 4_000),  # no more than the windows it touches
])
def test_window_bound_reads_the_image_no_more_than_it_must(
        texels, windows, image_bytes):
    image = torch.zeros(100, 100)  # 40,000 B
    out = torch.zeros(7)  # 28 B, moved once
    ms, by = _timing.window_bound([image], windows, 4_000, texels, (out,), 0)
    want = image_bytes + 8 * texels + 28  # and 8 B of coordinates a texel
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * want / _timing.HBM_BYTES_PER_S)


H100_L2 = 50 * 2**20  # the L2 an H100 SXM reports
A100_L2 = 40 * 2**20  # an A100's


@pytest.mark.parametrize("set_bytes,l2,sets", [
    (31_719_424, H100_L2, 4),  # (32768, 121) pairs: 127 MB in 4 sets
    (10_000_000, H100_L2, 11),  # 110 MB in 11 sets
    (537_919_488, H100_L2, 4),  # (262144, 256) pairs: one set exceeds L2
    (10_000_000, A100_L2, 9),  # a smaller L2 takes fewer sets
    (31_719_424, 4 * H100_L2, 14),  # a larger one more
])
def test_rotation_takes_turns_over_more_than_twice_the_l2(set_bytes, l2,
                                                          sets):
    assert _timing.rotation(set_bytes, l2) == sets
    assert sets * set_bytes > 2 * l2 and sets >= 4


def test_timing_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA card"):
        _timing.cuda_device("cpu")


@pytest.mark.cuda
def test_rotated_calls_take_turns(cuda_device):
    """A list of calls is taken in turn, across timings too."""
    seen = []
    fns = [lambda i=i: seen.append(i) for i in range(3)]
    _timing.time_ms(fns, reps=2, warm=1, batch=4)
    assert seen == [i % 3 for i in range(9)]


@pytest.mark.cuda
def test_back_to_back_reads_below_one_call(cuda_device):
    x = torch.ones(1 << 21, device=cuda_device)  # 8 MB in and out: ~0.005 ms
    fn = lambda: x.mul_(1.0)  # noqa: E731
    one = _timing.time_ms(fn, reps=50, batch=1)
    b2b = _timing.time_ms(fn, reps=50, batch=10)
    print(f"one call between events {one:.4f} ms, back to back {b2b:.4f} ms")
    assert 0 < b2b < one
