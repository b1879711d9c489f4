"""Share of its roofline, in %, that the all-views warp + NCC kernel (K1,
`csrc/allview_ncc.cu`) reaches over the traced window: the least time the
H100 could take for the work the program counted (`k1_rows`,
`k1_textures`, `k1_texels`, `k1_bytes`, counted at the contract in
`ops/allview_ncc.py`, replays inside CUDA graphs included), bounded by
`roofline.bound`, over K1's device seconds, every instance by name.

What it leaves out, in both directions:
  * no image pixel is counted (`densify` does not count the distinct
    pixels the taps read), so where the bytes bound it, it reads low;
  * every visible (row, view) pair is counted, those whose warp falls
    outside the view too, so it reads high by their share.
"""
UNIT = "%"
KERNEL = "allview_ncc_kernel"
COUNTERS = ("k1_rows", "k1_textures", "k1_texels", "k1_bytes")


def read(ctx):
    from benchmark import roofline

    if any(ctx.counters.get(name) is None for name in COUNTERS):
        return None
    s = ctx.device_seconds(KERNEL)
    if not s:
        return None
    c = ctx.counters
    bound_s, _ = roofline.bound(
        c["k1_bytes"],
        c["k1_rows"] * roofline.PATCH_FLOPS
        + c["k1_textures"] * roofline.TEXTURE_FLOPS
        + c["k1_texels"] * roofline.TEXEL_FLOPS)
    return 100.0 * bound_s / s
