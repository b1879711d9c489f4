"""The all-views pass (K1) against the anchor-pinned chunked pass (K2), on a
CUDA card.

    python -m densepoints_tpu_torch.scripts.kernel_paged_bench [--out FILE]
        [--device cuda] [--shapes dtu,bench,expand] [--paths allview,chunked]
        [--msv 16]

Stands for `scripts/kernel_paged_bench.py` of the JAX package. Its unit of
work is the one a filter pass or a Nelder-Mead objective evaluation does:
score every visible view of B patches against the patch's anchor (its
first visible view). Two paths do it:
  * `allview`: one launch of K1, `ops.allview_ncc.allview_scores` (the
    counterpart of the TPU `paged_all_scores`);
  * `chunked`: the visible views cut into anchor-pinned chunks of `--msv`
    slots once (`pmvs.optimize._anchor_chunks`), then one launch of K2 per
    chunk through `pmvs.optimize.patch_ncc_scores`.
The rig is the JAX script's (`_rigs.paged_bench_rig`: views on an arc,
`default_rng(0)` noise images, plane patches, view 0 the reference and
never visible, view 1 always) at its three shapes, k = 11:
  dtu_b512          49 views of 1200 x 1600, B = 512, every view visible;
  bench_b4096       8 views of 480 x 640, B = 4096, every view visible;
  expand_b4096_v50  49 views of 1200 x 1600, B = 4096, each view visible
                    with probability 0.5.
Per shape and path the record gives the ms of one pass, back to back and,
where the image stack is larger than the card's L2 cache, rotated over
copies of the stack (`_timing.time_ms`, `_timing.rotation`), the real
visible slots and ns per slot, the bound of the work (K1's bytes and
operations on this run's data, `_timing.allview_counts`: of the stack the
distinct pixels its taps read), and the largest score difference between
the two paths on the slots both score.

Departures from the JAX program: pages, plans and the harness floor are
TPU mechanics and absent; the bound is the H100's (no MXU peak);
`--out` has no default (the JAX default wrote /tmp/KERNEL_PAGED.json);
`--device` must name a CUDA card (ValueError otherwise).
"""
from __future__ import annotations

import argparse
import sys

from densepoints_tpu_torch.scripts import _rigs, _scene_runs, _timing

K = 11
SHAPES = {
    # key: (name, views, H, W, B, visible fraction)
    "dtu": ("dtu_b512", 49, 1200, 1600, 512, 1.0),
    "bench": ("bench_b4096", 8, 480, 640, 4096, 1.0),
    "expand": ("expand_b4096_v50", 49, 1200, 1600, 4096, 0.5),
}
PATHS = ("allview", "chunked")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    p.add_argument("--shapes", default="dtu,bench,expand")
    p.add_argument("--paths", default=",".join(PATHS))
    p.add_argument("--msv", type=int, default=16, help="chunk width M")
    p.add_argument("--reps", type=int, default=20)
    return p.parse_args(argv)


def allview_pass(images, cams, pos, nrm, ref, vis, k=K):
    """(scores (B, V), anchor, anchor_ok) of the all-views pass."""
    from densepoints_tpu_torch.ops.allview_ncc import allview_scores

    return allview_scores(images, cams, pos, nrm, ref, vis, k)


def chunked_pass(images, cams, pos, nrm, ref, vis, chunks, k=K):
    """[scores (B, M)] of the chunked pass, one per chunk of `chunks`."""
    from densepoints_tpu_torch.pmvs.optimize import patch_ncc_scores

    return [patch_ncc_scores(images, cams, pos, nrm, ref, vis, k,
                             view_ids=ids, ok=ok)[0]
            for ids, ok in chunks]


def path_difference(allview, chunks, chunk_scores):
    """(largest |chunked - all-views| over the payload slots both paths
    score, number of payload slots that only one path scores)."""
    import torch

    worst, only_one = 0.0, 0
    for (ids, ok), s in zip(chunks, chunk_scores):
        a = torch.gather(allview, 1, ids[:, 1:].long())
        c = s[:, 1:]
        mine = ok[:, 1:]
        both = mine & (a != -1) & (c != -1)
        only_one += int((mine & ((a != -1) != (c != -1))).sum())
        if bool(both.any()):
            worst = max(worst, float((a - c)[both].abs().max()))
    return worst, only_one


def bench_shape(key, device, paths, msv, reps):
    """The record of one shape."""
    import torch

    from densepoints_tpu_torch.pmvs.optimize import _anchor_chunks

    name, V, H, W, B, vis_frac = SHAPES[key]
    cams, images, pos, nrm, ref, vis = _rigs.to_device(
        device, *_rigs.paged_bench_rig(V, H, W, B, vis_frac))
    n_slots = int(vis.sum())
    chunks = _anchor_chunks(vis, msv)
    scores, anchor, anchor_ok = allview_pass(images, cams, pos, nrm, ref,
                                             vis)
    chunk_scores = chunked_pass(images, cams, pos, nrm, ref, vis, chunks)
    torch.cuda.synchronize(device)
    diff, only_one = path_difference(scores, chunks, chunk_scores)
    nbytes, flops = _timing.allview_counts(
        images, cams, pos, nrm, ref, vis, (scores, anchor, anchor_ok), K)
    bound_ms, bound_by = _timing.bound(nbytes, flops)
    stack = _timing.nbytes(images)
    l2 = _timing.l2_bytes(device)
    stacks = [images]
    if stack > l2:
        stacks += [images.clone()
                   for _ in range(_timing.rotation(stack, l2) - 1)]
    calls = {
        "allview": lambda im: lambda: allview_pass(im, cams, pos, nrm, ref,
                                                   vis),
        "chunked": lambda im: lambda: chunked_pass(im, cams, pos, nrm, ref,
                                                   vis, chunks),
    }
    out = {
        "shape": name, "views": V, "image": [H, W], "B": B, "texture": K,
        "visible_fraction": vis_frac, "visible_slots": n_slots,
        "chunks": len(chunks), "chunk_width": chunks[0][0].shape[1],
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by, "stack_bytes": stack,
        "max_abs_diff_chunked_vs_allview": diff,
        "slots_scored_by_one_path": only_one,
    }
    for path in paths:
        ms = _timing.time_ms(calls[path](images), reps)
        entry = {"ms": ms, "ns_per_slot": 1e6 * ms / n_slots,
                 "bound_share": bound_ms / ms, "ms_rotated": None,
                 "ns_per_slot_rotated": None}
        if len(stacks) > 1:
            entry["ms_rotated"] = _timing.time_ms(
                [calls[path](im) for im in stacks], reps)
            entry["ns_per_slot_rotated"] = (1e6 * entry["ms_rotated"]
                                            / n_slots)
        out[path] = entry
    del stacks
    torch.cuda.empty_cache()
    return out


def run(args) -> dict:
    """The program's run; returns its record."""
    device = _timing.cuda_device(args.device)
    counter = _timing.Counts(device)
    paths = args.paths.split(",")
    shapes = [bench_shape(key, device, paths, args.msv, args.reps)
              for key in args.shapes.split(",")]
    return {
        "program": "kernel_paged_bench",
        "device": _scene_runs.device_label(device),
        "msv": args.msv,
        "shapes": shapes,
        "absent": {"pages, plans, harness floor": "TPU mechanics: K1 takes "
                   "position, normal and reference view, and no torch op "
                   "runs before its launch"},
        **counter.read(),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
