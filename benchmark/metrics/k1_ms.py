"""Device milliseconds per scene of the all-views warp + NCC kernel (K1,
`csrc/allview_ncc.cu`), every instance by name, those replayed inside CUDA
graphs included."""
UNIT = "ms"
KERNEL = "allview_ncc_kernel"


def read(ctx):
    s = ctx.device_seconds(KERNEL)
    return None if s is None else 1e3 * s / ctx.scenes
