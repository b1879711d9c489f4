"""The bound arithmetic for a later roofline share of the scoring kernel
(K1), copied from the program's measurement programs
(`densepoints_tpu_torch/scripts/_timing.py`). No reader runs it yet: the
program does not yet report the work of each K1 launch inside `densify`
(its launches are replayed in CUDA graphs), so a `k1_roofline` metric
waits for that count.

The least time is the larger of the bytes over the memory rate and the
f32 operations over the peak rate (NVIDIA's data sheet for the H100 SXM,
at its 700 W power limit).
"""
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# f32 operations a warp + NCC function needs, whatever a kernel body
# spends. Per warped texel: the projection is affine in the texel's
# (column, row) before the division, so 6 fused multiply-adds (12) and 2
# divisions (14 in all); clamps and floors 10; bilinear weights and taps
# 15; mean / variance / covariance sums 8.
TEXEL_FLOPS = 47
# Per texture: three 3 x 3 products with the view's K R (45), one
# subtraction of the centre (3) and two scalings by 2 / k (6).
TEXTURE_FLOPS = 54
# Per patch, the frame (sx, sy): a cross product (9), p + x_axis (3), two
# decomposed projections of 35, their difference and its norm (6), the
# clamp and the division of the scale (2) and two scalings (6).
PATCH_FLOPS = 96


def bound(nbytes: float, flops: float):
    """(bound_s, bound_by): the least time the card could take."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / F32_FLOPS_PER_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def warp_counts(pixel_bytes, other_bytes, patches, textures, k, pixels):
    """(bytes, f32 operations) of a warp + NCC function that framed
    `patches` patches and sampled `textures` k x k textures whose taps
    read `pixels` distinct pixels of `pixel_bytes` each, every other input
    and output (`other_bytes`) moved once."""
    flops = (patches * PATCH_FLOPS
             + textures * (k * k * TEXEL_FLOPS + TEXTURE_FLOPS))
    return pixels * pixel_bytes + other_bytes, flops
