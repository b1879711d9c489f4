"""The contract of M1 (`csrc/hamming_topk.cu`), the ranked Hamming matcher,
on the CPU.

M1 runs only on a card (`test_torch_hamming_card.py` holds it there
against the plain version). Here the plain version, `_ranked_hamming`,
is held against `m1_twin`, a test-only copy of M1's arithmetic and merge
order in torch: the keys 2 x key = C_j - s M with C_j = D M + 2 j (an
invalid candidate's descriptor as zeros and (D + 2) M more, 2^32 - 1
past M) in uint32 (s summed over slices of 256 bits, as M1 sums a wider row),
each row's k smallest kept by eight owners of a
tile's columns (2 column warps x the 4 threads of a quad) across the
tiles of 128 candidates, then merged as the kernel merges them: within
the quad by offsets 1 and 2, then the two column warps. Keys are unique,
so any merge order gives the plain version's answer; the twin shows that
the kernel's order and its key arithmetic do, bitwise. Also held: the
pair-indexed path (`ranked_hamming(..., pairs=...)`, `match_pair`,
`match_pair_absolute`) against the per-pair calls, and the CUDA wrapper's
refusals, on meta tensors (they come before any launch).
"""
import numpy as np
import pytest
import torch

from densepoints_tpu_torch.features import matching

BN = 128  # candidates a tile
SLICE = 256  # bits of a row a step takes, at most
NONE = 2**32 - 1


def _push(lst, key):
    if len(lst) == 1:
        return [torch.minimum(lst[0], key)]
    hi = torch.maximum(lst[0], key)
    return [torch.minimum(lst[0], key), torch.minimum(lst[1], hi)]


def _merge(lst, other):
    if len(lst) == 1:
        return [torch.minimum(lst[0], other[0])]
    hi = torch.maximum(lst[0], other[0])
    return [torch.minimum(lst[0], other[0]),
            torch.minimum(hi, torch.minimum(lst[1], other[1]))]


def m1_twin(desc1, desc2, valid2, k):
    """M1's keys and merges for one pair: desc1 (N, D), desc2 (M, D) +-1,
    valid2 (M,) bool -> (idx (N, k) int64, dist (N, k) f32)."""
    N, D = desc1.shape
    M = desc2.shape[0]
    matching._check_key(D, M)
    cols = -(-M // BN) * BN
    c = torch.zeros((cols, D), dtype=torch.int64)
    c[:M] = torch.where(valid2[:, None], desc2.to(torch.int64), 0)
    # (N, cols), exact: the products of each slice of 256 bits, summed
    s = sum(desc1[:, lo:lo + SLICE].to(torch.int64)
            @ c[:, lo:lo + SLICE].T for lo in range(0, D, SLICE))
    j = torch.arange(cols)
    ok = torch.zeros(cols, dtype=torch.bool)
    ok[:M] = valid2
    C = torch.where(j >= M, NONE,
                    D * M + 2 * j + torch.where(ok, 0, (D + 2) * M))
    key2 = (C - s * M) % 2**32
    # owner of a column of a tile: column warp * 4 + thread of the quad
    local = j % BN
    owner = (local // 64) * 4 + (local % 8) // 2
    lists = [[torch.full((N,), NONE, dtype=torch.int64)] * k
             for _ in range(8)]
    for col in range(cols):
        lists[owner[col]] = _push(lists[owner[col]], key2[:, col])
    for wc in (0, 1):
        for off in (1, 2):
            quad = lists[4 * wc: 4 * wc + 4]
            lists[4 * wc: 4 * wc + 4] = [_merge(quad[t], quad[t ^ off])
                                         for t in range(4)]
    keys = torch.stack(_merge(lists[0], lists[4]), dim=-1) >> 1
    d = keys // M
    dist = torch.where(d > D, matching._BIG, d.to(torch.float32))
    return keys - d * M, dist


def _pm1(rng, *shape):
    return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape),
                           dtype=torch.float32)


def _near(rng, base, flips):
    """Copies of the rows of `base` with `flips` random signs turned."""
    out = base.clone()
    for r in range(out.shape[0]):
        cols = rng.choice(out.shape[1], flips, replace=False)
        out[r, cols] *= -1
    return out


def _case(name, rng):
    if name.startswith("ties"):
        # equal distances across tile boundaries: candidates copied into
        # other tiles and to both sides of a boundary
        desc2 = _pm1(rng, 300, 256)
        for src, dst in ((2, 130), (2, 260), (128, 127), (40, 168),
                         (40, 296)):
            desc2[dst] = desc2[src]
        desc1 = _near(rng, desc2[[2, 128, 40, 127, 7, 260]], 3)
        valid2 = torch.ones(300, dtype=torch.bool)
        valid2[7] = False
    elif name.startswith("all-invalid"):
        desc1, desc2 = _pm1(rng, 70, 64), _pm1(rng, 140, 64)
        valid2 = torch.zeros(140, dtype=torch.bool)
    elif name.startswith("ragged"):  # M not a multiple of the tile
        desc2 = _pm1(rng, 200, 256)
        desc1 = torch.cat([_near(rng, desc2[:50], 20), _pm1(rng, 100, 256)])
        valid2 = torch.as_tensor(rng.uniform(size=200) < 0.9)
    elif name.startswith("below-a-tile"):  # N and M below one tile
        desc1, desc2 = _pm1(rng, 5, 64), _pm1(rng, 3, 64)
        valid2 = torch.tensor([True, False, True])
    elif name.startswith("one-candidate"):
        desc1, desc2 = _pm1(rng, 9, 64), _pm1(rng, 1, 64)
        valid2 = torch.ones(1, dtype=torch.bool)
    else:  # "D<bits>": random descriptors, some near copies
        D = int(name[1:].split("-")[0])
        desc2 = _pm1(rng, 260, D)
        desc1 = torch.cat([_near(rng, desc2[::9], D // 8),
                           _pm1(rng, 40, D)])
        valid2 = torch.as_tensor(rng.uniform(size=260) < 0.95)
    return desc1, desc2, valid2


CASES = [("ties-k2", 2), ("ties-k1", 1), ("all-invalid-k2", 2),
         ("all-invalid-k1", 1), ("ragged-k2", 2), ("ragged-k1", 1),
         ("below-a-tile-k2", 2), ("one-candidate-k1", 1), ("D64-k2", 2),
         ("D256-k2", 2), ("D512-k2", 2), ("D512-k1", 1), ("D600-k1", 1),
         ("D1024-k2", 2), ("overflow", 2)]


@pytest.mark.parametrize("name,k", CASES, ids=[c[0] for c in CASES])
def test_plain_equals_the_tiled_twin(name, k):
    """`_ranked_hamming` and M1's twin agree bitwise; the overflow check
    raises in both."""
    if name == "overflow":
        D = 256
        M = 2**31 // (D + 2) + 1
        desc1 = torch.empty((4, D), device="meta")
        desc2 = torch.empty((M, D), device="meta")
        valid2 = torch.empty((M,), dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match="overflow the int32 key"):
            matching._ranked_hamming(desc1, desc2, valid2, k)
        with pytest.raises(ValueError, match="overflow the int32 key"):
            m1_twin(desc1, desc2, valid2, k)
        with pytest.raises(ValueError, match="overflow the int32 key"):
            matching.hamming_topk_cuda(desc1, desc2, valid2, k)
        # one candidate fewer fits
        matching._check_key(D, M - 1)
        return
    desc1, desc2, valid2 = _case(name, np.random.default_rng(len(name)))
    want_idx, want_dist = matching._ranked_hamming(desc1, desc2, valid2, k)
    idx, dist = m1_twin(desc1, desc2, valid2, k)
    assert idx.dtype == want_idx.dtype and dist.dtype == want_dist.dtype
    assert torch.equal(idx, want_idx)
    assert torch.equal(dist, want_dist)
    if name.startswith("ties"):
        # the ties are real: equal distances among the ranked partners
        assert (want_dist[:, 0] == want_dist[:, -1]).any() or k == 1
    if name.startswith("all-invalid"):
        assert (want_dist == matching._BIG).all()
        assert torch.equal(want_idx[:, 0], torch.zeros(desc1.shape[0],
                                                       dtype=torch.int64))


@pytest.mark.parametrize("k", [1, 2])
def test_pairs_equal_the_per_pair_calls(k):
    """`ranked_hamming` over view stacks and pair lists, int8 or f32, and
    the matchers given `pairs`, equal the per-pair calls."""
    rng = np.random.default_rng(3 + k)
    V, N, D = 4, 50, 128
    desc = _pm1(rng, V, N, D)
    valid = torch.as_tensor(rng.uniform(size=(V, N)) < 0.9)
    a, b = torch.tensor([0, 0, 2, 3, 1]), torch.tensor([1, 3, 1, 0, 1])
    for stack in (desc, desc.to(torch.int8)):
        idx, dist = matching.ranked_hamming(stack, stack, valid, k,
                                            pairs=(a, b))
        assert idx.shape == (5, N, k)
        for p in range(5):
            wi, wd = matching._ranked_hamming(desc[a[p]], desc[b[p]],
                                              valid[b[p]], k)
            assert torch.equal(idx[p], wi) and torch.equal(dist[p], wd)
    match = (matching.match_pair if k == 2
             else matching.match_pair_absolute)
    m, d = match(desc.to(torch.int8), desc.to(torch.int8), valid, valid,
                 pairs=(a, b))
    wm, wd = match(desc[a], desc[b], valid[a], valid[b])
    assert torch.equal(m, wm) and torch.equal(d, wd)


@pytest.mark.parametrize("what", ["k3", "too-few", "pairs", "bits",
                                  "device"])
def test_cuda_wrapper_refuses_before_launch(what):
    """What M1 does not take raises `ValueError` before any launch (meta
    tensors reach no kernel); a stack of 2 views and pair lists of unequal
    lengths is refused too."""
    N, M, D, k = 16, 32, 256, 2
    if what == "k3":
        k = 3
    elif what == "too-few":
        M = 1
    lead, pairs = (), None
    if what == "pairs":
        lead = (2,)
        pairs = (torch.arange(3, device="meta"),
                 torch.arange(2, device="meta"))
    desc1 = torch.empty((*lead, N, D), device="meta")
    desc2 = torch.empty((*lead, M, D if what != "bits" else D + 32),
                        device="meta")
    valid2 = torch.empty((*lead, M), dtype=torch.bool,
                         device="cpu" if what == "device" else "meta")
    with pytest.raises(ValueError):
        matching.hamming_topk_cuda(desc1, desc2, valid2, k, pairs)
