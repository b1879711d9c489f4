"""The plain reference that decides whether a run's clouds are correct.

Plain PyTorch; it imports nothing of the program and takes nothing the
program made. It is handed the capture the benchmark rendered (its images,
and the cameras as the scene was built: K, R, C in float64) and the cloud
the program returned, and judges the cloud by what it claims:

  * accuracy: the median distance of the patches' positions to the
    analytic sphere, | |p| - r |, in pixel footprints (DTU's accuracy);
  * completeness: the share of samples of the visible sphere that have a
    patch within `completeness_mm` (DTU's completeness);
  * photometric consistency: PMVS keeps a patch only if the texture of
    its plane, sampled in each of its visible views, matches the texture
    in its anchor view. Every patch the pipeline returns was accepted in
    one of two ways: an expanded patch had each visible view's NCC at or
    above `score_threshold` at its final pose (texture 11); a seed was
    NCC-filtered and then refined by Nelder-Mead, which never ends worse
    than it started, so its mean (texture 16) is at or above the
    threshold. Both imply: the mean NCC over the payload views is at
    least the threshold at one of the two texture sizes, against the
    anchor, or against the view the occlusion filter removed where it
    removed the anchor (`removed_anchor_ncc`). It holds positions, normals
    and visibility sets to the images, through the scoring kernel, the
    refinement and the filters (`judge.py` compares the share of patches
    that fail it, and the share with a view kept just below the
    threshold, `near_misses`);
  * refinement: Nelder-Mead leaves each pose at a minimum of PMVS's
    objective, so the objective falls little at the poses next to it
    (`refinement_gains`).

The texture of a patch follows the pipeline's definition: a k x k grid on
the patch plane, texel (r, c) at p + (2c/k - 1) sx + (2r/k - 1) sy with
sx = s x_ref, sy = s (n x x_ref), x_ref the reference camera's x axis and
s = (k // 2) / (pixels per unit of x_ref at p in the reference view);
projected K R (X - C), sampled bilinearly with clamp to the edge; a view is
valid only if the four corners p +- sx +- sy lie strictly inside it; NCC
with population statistics and the denominator clamped at 0.1; an invalid
view scores -1. The anchor is the first visible view.

`dtype` selects the precision of the sampled texels and the NCC (the
geometry stays float32): float32 for the judge, bfloat16 for the control.
"""
from __future__ import annotations

import numpy as np
import torch

NCC_MIN_DENOM = 0.1
EMPTY_ACCURACY_PX = 1e9  # an empty cloud's accuracy: fails any limit
TRUTH_SAMPLES = 200_000
TRUTH_MIN_VIEWS = 3


class RefCameras:
    """K, R, C of every view as float32 tensors on `device`."""

    def __init__(self, K, R, C, width, height, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.K = torch.as_tensor(np.asarray(K), **f32)
        self.R = torch.as_tensor(np.asarray(R), **f32)
        self.C = torch.as_tensor(np.asarray(C), **f32)
        self.width, self.height = int(width), int(height)

    def project(self, ids, pts):
        """Pixels of `pts` (..., n, 3) in views `ids` (...,): (..., n, 2)."""
        rel = pts - self.C[ids][..., None, :]
        cam = torch.einsum("...ij,...nj->...ni", self.R[ids], rel)
        hom = torch.einsum("...ij,...nj->...ni", self.K[ids], cam)
        return hom[..., :2] / hom[..., 2:3]


def _frames(cams: RefCameras, position, normal, ref, k):
    x_axis = cams.R[ref][:, 0, :]
    y_axis = torch.linalg.cross(normal, x_axis)
    pair = torch.stack([position, position + x_axis], dim=1)  # (B, 2, 3)
    pix = cams.project(ref, pair)
    dx = torch.linalg.norm(pix[:, 1] - pix[:, 0], dim=-1)
    scale = (k // 2) / torch.clamp_min(dx, 1e-12)
    return scale[:, None] * x_axis, scale[:, None] * y_axis


def _bilinear(images, ids, xy, dtype):
    """Taps of images (V, H, W) in views ids (B, S) at xy (B, S, n, 2)."""
    V, H, W = images.shape
    x = xy[..., 0].clamp(0.0, W - 1.0)
    y = xy[..., 1].clamp(0.0, H - 1.0)
    x0 = torch.floor(x).long().clamp(0, W - 2)
    y0 = torch.floor(y).long().clamp(0, H - 2)
    fx = (x - x0).to(dtype)
    fy = (y - y0).to(dtype)
    flat = images.reshape(-1)
    base = ids[..., None].long() * (H * W) + y0 * W + x0
    return (flat[base] * (1 - fx) * (1 - fy) + flat[base + 1] * fx * (1 - fy)
            + flat[base + W] * (1 - fx) * fy
            + flat[base + W + 1] * fx * fy)


def slot_ncc(images, cams: RefCameras, position, normal, ref, slots, ok, k,
             dtype=torch.float32):
    """NCC of slots 1.. against slot 0 (the anchor) for every patch.

    slots (B, S) view ids, slot 0 the anchor; ok (B, S) which slots are
    real. Returns ((B, S) scores, -1 where a slot or its anchor is invalid
    or not real, slot 0 itself -1; (B, S) validity of each slot's warp)."""
    sx, sy = _frames(cams, position, normal, ref, k)
    coords = 2.0 * torch.arange(k, dtype=torch.float32,
                                device=position.device) / k - 1.0
    tt, ss = torch.meshgrid(coords, coords, indexing="ij")
    world = (position[:, None, None, :] + ss[..., None] * sx[:, None, None, :]
             + tt[..., None] * sy[:, None, None, :]).reshape(-1, k * k, 3)
    corners = position[:, None, :] + torch.stack(
        [-sx - sy, sx - sy, sx + sy, -sx + sy], dim=1)
    B, S = slots.shape
    ids = slots.long()
    pc = cams.project(ids, corners[:, None].expand(B, S, 4, 3))
    inside = ((pc[..., 0] > 0) & (pc[..., 0] < cams.width)
              & (pc[..., 1] > 0) & (pc[..., 1] < cams.height)).all(-1)
    valid = inside & ok
    pix = cams.project(ids, world[:, None].expand(B, S, k * k, 3))
    tex = _bilinear(images.to(dtype), ids, pix, dtype)  # (B, S, k*k)
    centred = tex - tex.mean(dim=-1, keepdim=True)
    sigma = torch.sqrt((centred * centred).mean(dim=-1))
    cov = (centred * centred[:, :1]).mean(dim=-1)
    den = torch.clamp_min(sigma * sigma[:, :1], NCC_MIN_DENOM)
    score = (cov / den).float()
    good = valid & valid[:, :1]
    good[:, 0] = False
    return torch.where(good, score, -1.0), valid


def _slots(vis):
    """(slots (B, S), ok (B, S)): the visible views in ascending order,
    the anchor (first visible view) in slot 0."""
    n = vis.sum(dim=1)
    S = max(int(n.max()) if len(n) else 1, 1)
    order = torch.argsort((~vis).to(torch.uint8), dim=1, stable=True)[:, :S]
    return order, torch.gather(vis, 1, order)


def _blocks(vis, k, budget=1 << 26):
    """Row blocks of at most `budget` texels."""
    S = max(int(vis.sum(dim=1).max()) if vis.shape[0] else 1, 1)
    rows = max(1, budget // (S * k * k))
    for lo in range(0, vis.shape[0], rows):
        yield slice(lo, lo + rows)


def mean_payload_ncc(images, cams, position, normal, ref, vis, k,
                     dtype=torch.float32):
    """(B,) mean NCC over each patch's payload views (-1 where none)."""
    return masked_mean(*payload_scores(images, cams, position, normal, ref,
                                       vis, k, dtype))


def masked_mean(scores, payload):
    n = payload.sum(dim=1)
    mean = torch.where(payload, scores, 0.0).sum(dim=1) / n.clamp_min(1)
    return torch.where(n > 0, mean, -1.0)


def geometric_anchor(cams, position, normal, ref, visible_angle, block=4096):
    """(B,) the first view, other than the reference view, in which the
    patch lies strictly inside the image and within `visible_angle` of
    its normal (-1 where there is none): the anchor the NCC filter took
    for a patch whose views were classified at this pose."""
    V = cams.C.shape[0]
    out = torch.full((position.shape[0],), -1, dtype=torch.long,
                     device=position.device)
    views = torch.arange(V, device=position.device)
    for lo in range(0, position.shape[0], block):
        p, n, r = (position[lo:lo + block], normal[lo:lo + block],
                   ref[lo:lo + block])
        ids = views[None, :].expand(p.shape[0], V)
        pix = cams.project(ids, p[:, None, None, :].expand(-1, V, 1, 3))[
            :, :, 0]
        inside = ((pix[..., 0] > 0) & (pix[..., 0] < cams.width)
                  & (pix[..., 1] > 0) & (pix[..., 1] < cams.height))
        rays = p[:, None, :] - cams.C[None]
        cos = (n[:, None, :] * rays).sum(-1) / torch.clamp_min(
            torch.linalg.norm(rays, dim=-1), 1e-12)
        seen = (inside & (torch.arccos(cos.clamp(-1.0, 1.0)) < visible_angle)
                & (views[None, :] != r[:, None]))
        first = torch.argmax(seen.to(torch.uint8), dim=1)
        out[lo:lo + block] = torch.where(seen.any(dim=1), first, -1)
    return out


def payload_scores(images, cams, position, normal, ref, vis, k,
                   dtype=torch.float32):
    """(B, S) NCC of each patch's payload views (slots 1..) against its
    first visible view, and (B, S) which slots are payload views."""
    outs, oks = [], []
    S = max(int(vis.sum(dim=1).max()) if vis.shape[0] else 1, 1)
    for blk in _blocks(vis, k):
        slots, ok = _slots(vis[blk])
        sc, _ = slot_ncc(images, cams, position[blk], normal[blk], ref[blk],
                         slots, ok, k, dtype)
        payload = ok.clone()
        payload[:, 0] = False
        pad = S - sc.shape[1]
        outs.append(torch.nn.functional.pad(sc, (0, pad), value=-1.0))
        oks.append(torch.nn.functional.pad(payload, (0, pad), value=False))
    if not outs:
        return (torch.zeros((0, S), device=position.device),
                torch.zeros((0, S), dtype=torch.bool, device=position.device))
    return torch.cat(outs), torch.cat(oks)


def all_view_scores(images, cams, position, normal, ref, vis, k,
                    dtype=torch.float32):
    """(scores (B, V), anchor (B,), anchor_ok (B,)) in the layout of the
    pipeline's scoring pass: NCC of each visible non-anchor view against
    the anchor, -1 elsewhere. The control puts this, in bfloat16, in the
    place of the pipeline's scoring kernel."""
    B, V = vis.shape
    scores = torch.full((B, V), -1.0, device=position.device)
    anchor_ok = torch.zeros((B,), dtype=torch.bool, device=position.device)
    for blk in _blocks(vis, k):
        slots, ok = _slots(vis[blk])
        sc, valid = slot_ncc(images, cams, position[blk], normal[blk],
                             ref[blk], slots, ok, k, dtype)
        rows = scores[blk]
        rows.scatter_(1, slots, torch.where(ok, sc, rows.gather(1, slots)))
        scores[blk] = rows
        anchor_ok[blk] = valid[:, 0]
    anchor = torch.argmax(vis.to(torch.uint8), dim=1)
    return scores, anchor, anchor_ok


def sphere_truth(radius, C, visible_angle, device):
    """Samples of the sphere seen by >= 3 cameras inside the visible cone
    (the inward normal against the ray from the camera), from a fixed
    seed: what a complete cloud covers."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    pts = torch.randn((TRUTH_SAMPLES, 3), generator=gen, device=device)
    pts = pts * (radius / torch.linalg.norm(pts, dim=1, keepdim=True))
    inward = -pts / radius
    count = torch.zeros(len(pts), dtype=torch.int32, device=device)
    for c in torch.as_tensor(np.asarray(C), dtype=torch.float32,
                             device=device):
        d = pts - c
        cos = (d * inward).sum(1) / torch.linalg.norm(d, dim=1)
        count += (torch.arccos(torch.clamp(cos, -1, 1))
                  < visible_angle).int()
    return pts[count >= TRUTH_MIN_VIEWS]


def completeness(position, truth, threshold_mm, block=2048):
    """Share of `truth` with a patch within `threshold_mm`."""
    if position.shape[0] == 0:
        return 0.0
    near = 0
    for lo in range(0, truth.shape[0], block):
        d = torch.cdist(truth[lo:lo + block], position)
        near += int((d.min(dim=1).values <= threshold_mm).sum())
    return near / truth.shape[0]


def accuracy_px(position, radius, pixel_mm):
    """Median | |p| - r | in pixel footprints."""
    if position.shape[0] == 0:
        return EMPTY_ACCURACY_PX
    err = (torch.linalg.norm(position, dim=1) - radius).abs()
    return float(err.median()) / pixel_mm


def removed_anchor_ncc(images, cams, position, normal, ref, vis, k,
                       dtype=torch.float32):
    """(B,) for each patch, the best mean NCC of all its visible views
    against a view before its first visible one (-1 where there is none).

    The occlusion filter runs after the NCC filter and may remove a
    patch's anchor; the first remaining view then stands in its place,
    and the texture the views were scored against is that of a view no
    longer listed. Such a patch is judged against each view that could
    have been its anchor."""
    B, V = vis.shape
    first = torch.argmax(vis.to(torch.uint8), dim=1)
    rows = torch.repeat_interleave(torch.arange(B, device=vis.device),
                                   first)
    out = torch.full((B,), -1.0, device=position.device)
    if rows.numel() == 0:
        return out
    starts = torch.cumsum(first, 0) - first
    anchors = (torch.arange(rows.numel(), device=vis.device)
               - starts[rows])
    for blk in _blocks(vis[rows], k):
        r = rows[blk]
        slots, ok = _slots(vis[r])
        slots = torch.cat([anchors[blk][:, None], slots], dim=1)
        ok = torch.cat([torch.ones_like(ok[:, :1]), ok], dim=1)
        sc, _ = slot_ncc(images, cams, position[r], normal[r], ref[r],
                         slots, ok, k, dtype)
        payload = ok.clone()
        payload[:, 0] = False
        mean = (torch.where(payload, sc, 0.0).sum(dim=1)
                / payload.sum(dim=1).clamp_min(1))
        out.scatter_reduce_(0, r, mean, reduce="amax")
    return out


def best_payload_ncc(images, cams, position, normal, ref, vis,
                     texture_sizes, threshold, means=None):
    """(B,) each patch's mean payload NCC at the better of
    `texture_sizes` (`means` gives those already computed, by size); for
    a patch below `threshold`, the better of that and
    `removed_anchor_ncc`."""
    means = dict(means or {})
    for k in texture_sizes:
        if k not in means:
            means[k] = mean_payload_ncc(images, cams, position, normal, ref,
                                        vis, k)
    best = torch.stack([means[k] for k in texture_sizes]).max(dim=0).values
    low = torch.nonzero(best < threshold).flatten()
    for k in texture_sizes:
        if low.numel():
            alt = removed_anchor_ncc(images, cams, position[low],
                                     normal[low], ref[low], vis[low], k)
            best[low] = torch.maximum(best[low], alt)
    return best


def near_misses(scores, payload, anchored, threshold, band):
    """How many `anchored` patches have their lowest payload score in
    [threshold - band[1], threshold - band[0]): views kept just below the
    threshold, where an acceptance computed in a lower precision puts
    them. `anchored` marks the patches whose first visible view is their
    `geometric_anchor`, whose every payload view was scored against it at
    this pose."""
    low = torch.where(payload, scores, float("inf")).min(dim=1).values
    near = ((low >= threshold - band[1]) & (low < threshold - band[0])
            & anchored)
    return int(near.sum())


def objective(images, cams, position, normal, ref, vis, k):
    """(B,) PMVS's photometric objective: the mean of 1 - NCC over the
    payload views against the first visible view, 2 where there is none."""
    scores, payload = payload_scores(images, cams, position, normal, ref,
                                     vis, k)
    n = payload.sum(dim=1)
    err = torch.where(payload, 1.0 - scores, 0.0).sum(dim=1)
    return torch.where(n > 0, err / n.clamp_min(1), 2.0)


def _turn(v, axis, angle):
    """`v` (B, 3) turned by `angle` about the unit `axis` (B, 3)."""
    c, s = np.cos(angle), np.sin(angle)
    return (v * c + torch.linalg.cross(axis, v) * s
            + axis * (axis * v).sum(dim=1, keepdim=True) * (1 - c))


def refinement_gains(images, cams, position, normal, ref, vis, k, depth_px,
                     angle, pixel_mm):
    """((B,), (B,)): how much the objective at texture `k` falls at the
    best of the poses next to each patch's own, (pose) over six: its
    position moved `depth_px` pixel footprints either way along the
    reference ray, or its normal turned by `angle` either way about the
    reference camera's x or y axis; (normal) over the four turns alone. A
    pose that Nelder-Mead refined gains little; one it left as it
    started gains more."""
    f0 = objective(images, cams, position, normal, ref, vis, k)
    moved, turned = f0, f0
    ray = position - cams.C[ref]
    step = depth_px * pixel_mm / torch.linalg.norm(ray, dim=1, keepdim=True)
    for sign in (1.0, -1.0):
        moved = torch.minimum(moved, objective(
            images, cams, position + sign * step * ray, normal, ref, vis, k))
    for axis in (cams.R[ref][:, 0, :], cams.R[ref][:, 1, :]):
        for sign in (1.0, -1.0):
            turned = torch.minimum(turned, objective(
                images, cams, position, _turn(normal, axis, sign * angle),
                ref, vis, k))
    return f0 - torch.minimum(moved, turned), f0 - turned
