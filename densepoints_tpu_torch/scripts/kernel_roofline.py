"""The warp + NCC kernels (K2, K1) against their bounds on a CUDA card.

    python -m densepoints_tpu_torch.scripts.kernel_roofline [--out FILE]
        [--device cuda]

Stands for `scripts/kernel_roofline.py` of the JAX package. It times the
slot kernel K2 (`ops.warp_ncc.slot_scores_cuda`) at the JAX program's two
shapes, and the all-views kernel K1 (`ops.allview_ncc.allview_scores_cuda`)
at the same two:
  bench  8 views of 480 x 640, B = 4096, M = 8, k = 11: `_rigs.refine_inputs`
         (bench.py's refine shape, with mixed-visibility, no-view and
         off-frustum rows); K2 on the visible views compacted to 8 slots;
  dtu    49 views of 1600 x 1200, B = 512, M = 16, k = 11: the first 512
         patches of `_rigs.dtu_inputs` (~25 visible views each); K2 on their
         first anchor-pinned chunk of 16 slots, K1 on all 49 views.
Each time is taken back to back (`_timing.time_ms`) and, where the image
stack is larger than the card's L2 cache (dtu), also rotated over copies of
the stack, so that every call reads device memory. Beside it: the bytes and
f32 operations the kernel needs on this run's data, the bound
(`_timing.bound`: bytes over 3.35 TB/s against operations over 67 TFLOP/s),
what bounds it, and the share `bound_ms / ms`.

Departures from the JAX program: the v5e peaks, the MXU / VPU model and
the `fori_loop` protocol are gone (the bound is the H100's, CUDA events
time the card). `bench_resident` and `bench_streaming` are one shape
here: the port's kernels have no resident / streaming split (ROADMAP
A.12). `--out` has no default (the JAX default wrote KERNEL_r03.json into
the working directory); `--device` must name a CUDA card (ValueError
otherwise).
"""
from __future__ import annotations

import argparse
import sys

from densepoints_tpu_torch.scripts import _rigs, _scene_runs, _timing

K = 11
DTU_PATCHES, DTU_SLOTS = 512, 16


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="",
                   help="also write the record to this JSON file")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=20)
    return p.parse_args(argv)


def kernel_calls(cams, images, pos, nrm, ref, vis, ids, ok, k=K):
    """{kernel: (call(images), its counts(outputs))} of K1 and K2 on one
    input set; a call takes the image stack, so that it can be rotated."""
    from densepoints_tpu_torch.ops import allview_ncc, warp_ncc

    cam_args = (cams.K.contiguous(), cams.E.contiguous(),
                cams.C.contiguous(), cams.x_axis.contiguous(), cams.width,
                cams.height)
    patch = (pos.contiguous(), nrm.contiguous(), ref.contiguous())

    def k1(im):
        return allview_ncc.allview_scores_cuda(im, *cam_args, *patch,
                                               vis.contiguous(), k)

    def k1_counts(out):
        return _timing.allview_counts(images, cams, pos, nrm, ref, vis, out,
                                      k)

    def k2(im):
        return warp_ncc.slot_scores_cuda(im, *cam_args, *patch,
                                         ids.contiguous(), ok.contiguous(), k)

    def k2_counts(scores):
        return _timing.slot_counts(images, cams, pos, nrm, ref, ids, ok,
                                   scores, k)

    return {"slot_ncc": (k2, k2_counts), "allview_ncc": (k1, k1_counts)}


def shape_inputs(name, device):
    """(cameras, images, position, normal, ref, vis, slot ids, slot ok) of
    shape `name`."""
    from densepoints_tpu_torch.ops.warp import compact_visible
    from densepoints_tpu_torch.pmvs.optimize import _anchor_chunks

    if name == "bench":
        cams, images, pos, nrm, ref, vis = _rigs.refine_inputs(device)
        ids, ok = compact_visible(vis, 8)
        return cams, images, pos, nrm, ref, vis, ids, ok
    cams, images, pos, nrm, ref, vis = _rigs.dtu_inputs(device)
    pos, nrm, ref, vis = (a[:DTU_PATCHES].contiguous()
                          for a in (pos, nrm, ref, vis))
    ids, ok = _anchor_chunks(vis, DTU_SLOTS)[0]
    return cams, images, pos, nrm, ref, vis, ids, ok


def bench_shape(name, device, reps):
    import torch

    cams, images, pos, nrm, ref, vis, ids, ok = shape_inputs(name, device)
    stack = _timing.nbytes(images)
    l2 = _timing.l2_bytes(device)
    stacks = [images]
    if stack > l2:
        stacks += [images.clone()
                   for _ in range(_timing.rotation(stack, l2) - 1)]
    entries = []
    for kernel, (call, counts) in kernel_calls(cams, images, pos, nrm, ref,
                                               vis, ids, ok).items():
        out = call(images)
        torch.cuda.synchronize(device)
        nbytes, flops = counts(out)
        bound_ms, bound_by = _timing.bound(nbytes, flops)
        ms = _timing.time_ms(lambda: call(images), reps)
        entry = {
            "kernel": kernel, "shape": name, "views": images.shape[0],
            "image": list(images.shape[1:]), "B": pos.shape[0],
            "M": ids.shape[1] if kernel == "slot_ncc" else vis.shape[1],
            "texture": K, "ms": ms, "ms_rotated": None,
            "bytes": nbytes, "flops": flops,
            "achieved_gbps": nbytes / ms * 1e-6,
            "achieved_tflops": flops / ms * 1e-9,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bound_share_rotated": None,
        }
        if len(stacks) > 1:
            rotated = _timing.time_ms(
                [lambda im=im: call(im) for im in stacks], reps)
            entry["ms_rotated"] = rotated
            entry["bound_share_rotated"] = bound_ms / rotated
        entries.append(entry)
    del stacks
    torch.cuda.empty_cache()
    return entries


def run(args) -> dict:
    """The program's run; returns its record."""
    device = _timing.cuda_device(args.device)
    counter = _timing.Counts(device)
    entries = [e for name in ("bench", "dtu")
               for e in bench_shape(name, device, args.reps)]
    return {
        "program": "kernel_roofline",
        "device": _scene_runs.device_label(device),
        "peaks": {"hbm_bytes_per_s": _timing.HBM_BYTES_PER_S,
                  "f32_flops_per_s": _timing.F32_FLOPS_PER_S},
        "shapes": entries,
        "absent": {"bench_resident / bench_streaming": "one shape: the "
                   "port's kernels have no resident / streaming split "
                   "(ROADMAP A.12)"},
        **counter.read(),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    _scene_runs.emit(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
