"""Device milliseconds per scene of the ranked Hamming matcher (M1,
`csrc/hamming_topk.cu`), every instance by name."""
UNIT = "ms"
KERNEL = "hamming_topk_kernel"


def read(ctx):
    s = ctx.device_seconds(KERNEL)
    return None if s is None else 1e3 * s / ctx.scenes
