"""Device milliseconds per scene of the Nelder-Mead step kernels (N1-N3,
`csrc/nm_step.cu`: `nm_reflect`, `nm_contract`, `nm_accept`), every
instance by name, those replayed inside CUDA graphs included."""
UNIT = "ms"
KERNELS = ("nm_reflect_kernel", "nm_contract_kernel", "nm_accept_kernel")


def read(ctx):
    s = ctx.device_seconds(*KERNELS)
    return None if s is None else 1e3 * s / ctx.scenes
