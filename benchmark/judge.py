"""Whether a run's clouds are correct: every cloud of the window against
the plain reference (`reference.py`), each number beside its limit.

The configuration states the guarantees (`guarantees` in its file): DTU's
accuracy (median distance to the surface, at most `accuracy_px` pixel
footprints) and completeness (at least `completeness` of the visible
surface within `completeness_mm`), and PMVS's photometric acceptance at
`score_threshold`, with the seeds' and the expansion's texture sizes
(`texture_sizes`, in that order) and the visible cone (`visible_angle`).
Further numbers, each over all clouds of the run, may have limits of the
cell's own (`limits` in its file), set between what sound runs read and
what a broken run reads (`NUMBERS`):
  * `photo_fail_share`, the share of patches whose photometric
    consistency (`reference.best_payload_ncc`) lies below the threshold
    by more than `PHOTO_FAIL_GAP`: patches kept that fail PMVS's
    acceptance outright;
  * `near_miss_share`, the share of anchored patches with a view kept
    just below the threshold (`reference.near_misses`, band
    `NEAR_MISS_BAND`): what an acceptance computed in a lower precision
    leaves behind;
  * `refine_gain` and `normal_gain`, the worst cloud's median, over
    `REFINE_SAMPLE` patches drawn from a fixed seed, of how much PMVS's
    objective falls next to each patch's pose
    (`reference.refinement_gains`): Nelder-Mead's claim that it left each
    pose at a minimum, its position and normal, or its normal alone.
"""
from __future__ import annotations

import torch

from benchmark import reference

NEAR_MISS_BAND = (1e-4, 1e-3)
PHOTO_FAIL_GAP = 0.01
REFINE_SAMPLE = 4096  # patches a cloud whose refinement gain is read
REFINE_DEPTH_PX = 0.5
REFINE_ANGLE = 0.1  # radians


def judge_run(cell, geo, outputs, images, device):
    """One verdict per cloud."""
    from benchmark import scenes

    g = cell["guarantees"]
    thr = g["score_threshold"]
    k_seed, k_expand = g["texture_sizes"]
    _, K, R, C = scenes.cameras(geo)
    cams = reference.RefCameras(K, R, C, geo.width, geo.height, device)
    truth = reference.sphere_truth(geo.radius_mm, C, g["visible_angle"],
                                   device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    verdicts = []
    for (position, normal, ref, vis), host in zip(outputs, images):
        stack = torch.as_tensor(host, device=device)
        position, normal, ref = position.float(), normal.float(), ref.long()
        n = int(position.shape[0])
        scores, payload = reference.payload_scores(
            stack, cams, position, normal, ref, vis, k_expand)
        best = reference.best_payload_ncc(
            stack, cams, position, normal, ref, vis, (k_seed, k_expand), thr,
            means={k_expand: reference.masked_mean(scores, payload)})
        anchored = (reference.geometric_anchor(
            cams, position, normal, ref, g["visible_angle"])
            == torch.argmax(vis.to(torch.uint8), dim=1))
        pick = torch.randperm(n, generator=gen)[:REFINE_SAMPLE].to(device)
        gains = [reference.refinement_gains(
            stack, cams, position[pick], normal[pick], ref[pick], vis[pick],
            k, REFINE_DEPTH_PX, REFINE_ANGLE, geo.pixel_mm)
            for k in (k_seed, k_expand)]
        v = {
            "patches": n,
            "accuracy_px": reference.accuracy_px(position, geo.radius_mm,
                                                 geo.pixel_mm),
            "completeness": reference.completeness(position, truth,
                                                   g["completeness_mm"]),
            "photo_fails": int((thr - best > PHOTO_FAIL_GAP).sum()),
            "anchored": int(anchored.sum()),
            "near_misses": reference.near_misses(scores, payload, anchored,
                                                 thr, NEAR_MISS_BAND),
            "refine_gain": _q(torch.minimum(gains[0][0], gains[1][0]), 0.5),
            "normal_gain": _q(torch.minimum(gains[0][1], gains[1][1]), 0.5),
        }
        v["ok"] = (v["accuracy_px"] <= g["accuracy_px"]
                   and v["completeness"] >= g["completeness"])
        verdicts.append(v)
        del stack, scores, payload
    return verdicts


def _q(x, q):
    """The `q` quantile of `x` (the worst reading for an empty cloud)."""
    return float(torch.quantile(x.float(), q)) if x.numel() else 1e9


def _share(verdicts, part, whole):
    return (sum(v[part] for v in verdicts)
            / max(sum(v[whole] for v in verdicts), 1))


# The numbers a cell may hold to a limit of its own (`limits` in its file),
# each over all clouds of the run: a share over them, or the worst cloud's.
NUMBERS = {
    "photo_fail_share": lambda vs: _share(vs, "photo_fails", "patches"),
    "near_miss_share": lambda vs: _share(vs, "near_misses", "anchored"),
    "refine_gain": lambda vs: max(v["refine_gain"] for v in vs),
    "normal_gain": lambda vs: max(v["normal_gain"] for v in vs),
}


def checks(cell, verdicts) -> list:
    """The run's numbers beside their limits: the stated guarantees at the
    worst cloud, then each number the cell gives a limit."""
    g, lim = cell["guarantees"], cell["limits"]
    rows = [
        ("accuracy_px", max(v["accuracy_px"] for v in verdicts), "<=",
         g["accuracy_px"]),
        ("completeness", min(v["completeness"] for v in verdicts), ">=",
         g["completeness"]),
    ] + [(name, NUMBERS[name](verdicts), "<=", lim[name])
         for name in NUMBERS if name in lim]
    out = []
    for name, value, op, limit in rows:
        ok = value <= limit if op == "<=" else value >= limit
        out.append({"name": name, "value": value, "op": op, "limit": limit,
                    "ok": bool(ok)})
    return out
