"""M1 (`csrc/hamming_topk.cu`) on a card (`cuda`): its ranked partners are
bitwise the plain version's, `_ranked_hamming`, which runs here on the
same card as the chain M1 replaced (an f32 GEMM, exact on +-1 with TF32
off, then the N x M passes and `torch.topk`); and `generate_seed_points`
on a rendered `dtu49` and `temple312` capture gives bitwise the points and
observations of that chain, with M1 launched once and `seed_match_pairs`
the pair count. The CPU cases, against a twin of M1's merge, are
`test_torch_hamming_topk.py`."""
import numpy as np
import pytest
import torch

from densepoints_tpu_torch.features import matching
from densepoints_tpu_torch.pmvs import seed
from tests.torch_port_util import cuda_device  # noqa: F401


def _plain(desc1, desc2, valid2, k, pairs):
    """The replaced chain on the card, pair chunks as the seed stage cut
    them."""
    assert not torch.backends.cuda.matmul.allow_tf32
    a, b = pairs
    chunk = seed._pair_chunk(desc1.shape[1])
    parts = [matching._ranked_hamming(
        desc1[a[lo:lo + chunk]].float(), desc2[b[lo:lo + chunk]].float(),
        valid2[b[lo:lo + chunk]], k) for lo in range(0, len(a), chunk)]
    return tuple(torch.cat(t) for t in zip(*parts))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _pm1(gen, shape, device):
    bits = torch.randint(0, 2, shape, generator=gen, device=device)
    return (2 * bits - 1).to(torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,D,k", [
    (4096, 4096, 256, 2), (8192, 8192, 256, 2), (8192, 8192, 256, 1),
    (300, 200, 64, 2), (130, 129, 512, 2), (77, 3, 200, 1), (5, 2, 16, 2),
    (1000, 1030, 1024, 2), (300, 257, 600, 1)])
def test_random_descriptors_bitwise(cuda_device, N, M, D, k):  # noqa: F811
    """Random +-1 descriptors with near copies (ties at equal distance)
    and invalid candidates, over a stack of 3 views and 4 pairs."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(N + M + D + k)
    q = _pm1(gen, (3, N, D), cuda_device)
    c = _pm1(gen, (3, M, D), cuda_device)
    rows = min(N, M)
    q[:, :rows] = c[:, :rows]  # exact partners, and equal distances
    flip = torch.rand((3, rows, D), generator=gen, device=cuda_device) < 0.05
    q[:, :rows] = torch.where(flip, -q[:, :rows], q[:, :rows])
    valid = torch.rand((3, M), generator=gen, device=cuda_device) < 0.9
    pairs = (torch.tensor([0, 1, 2, 2], device=cuda_device),
             torch.tensor([1, 2, 0, 2], device=cuda_device))
    before = matching.KERNEL_LAUNCHES, matching.MATCH_PAIRS
    got = matching.ranked_hamming(q, c, valid, k, pairs=pairs)
    assert (matching.KERNEL_LAUNCHES, matching.MATCH_PAIRS) == (
        before[0] + 1, before[1] + 4)
    want = _plain(q, c, valid, k, pairs)
    torch.cuda.synchronize()
    _same(got, want)
    # batched over a leading axis, f32 operands
    got = matching.ranked_hamming(q[:2].float(), c[1:].float(), valid[1:], k)
    _same(got, matching._ranked_hamming(q[:2].float(), c[1:].float(),
                                        valid[1:], k))


def _capture_config(cell):
    from benchmark import harness, scenes
    from densepoints_tpu_torch.config import load_config

    spec = harness.load_cell(cell)
    geo = scenes.SceneGeometry.from_config(spec["scene"])
    return geo, load_config(spec["pipeline"]).matching


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dtu49-grid8", "temple312-grid4"])
def test_rendered_capture_bitwise(cuda_device, cell, monkeypatch):  # noqa: F811
    """One rendered capture of the cell: M1 against the chain over the
    covisibility pairs, then the seed stage with each."""
    from benchmark import scenes
    from densepoints_tpu_torch.core.cameras import Cameras

    geo, config = _capture_config(cell)
    cap = scenes.make_capture(geo, scenes.shared_seed(0), cuda_device)
    V, H, W = cap.images.shape
    cams = Cameras.from_projection_matrices(cap.P, widths=W, heights=H,
                                            device=cuda_device)
    xy, _, valid = seed._detect(cap.images, config)
    desc = seed._describe(cap.images, xy, config).to(torch.int8)
    pairs_np = seed.covisibility_pairs(cams, config.max_pairs_per_view)
    pairs = tuple(torch.as_tensor(pairs_np[:, i], dtype=torch.int64,
                                  device=cuda_device) for i in (0, 1))
    for k in (1, 2):
        got = matching.ranked_hamming(desc, desc, valid, k, pairs=pairs)
        _same(got, _plain(desc, desc, valid, k, pairs))

    before = matching.KERNEL_LAUNCHES, matching.MATCH_PAIRS
    got = seed.generate_seed_points(cap.images, cams, config)
    assert (matching.KERNEL_LAUNCHES, matching.MATCH_PAIRS) == (
        before[0] + 1, before[1] + len(pairs_np))
    # the chain, in the seed stage's chunks of pairs
    monkeypatch.setattr(matching, "ranked_hamming", _plain)
    want = seed.generate_seed_points(cap.images, cams, config)
    assert matching.KERNEL_LAUNCHES == before[0] + 1
    assert len(got[0]) > 1000
    for g, w in zip(got, want):
        g, w = np.asarray(g.cpu() if torch.is_tensor(g) else g), np.asarray(
            w.cpu() if torch.is_tensor(w) else w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
