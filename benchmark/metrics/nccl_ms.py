"""Device milliseconds per scene of NCCL's kernels (every operation whose
name contains `nccl`: the collectives of `densify_multihost` over the
job's NCCL group) on rank 0's card, inside the traced window. Only rank 0
is traced, so the other ranks' kernels are not seen. A collective's
kernel runs until every rank has reached it, so its time holds rank 0's
wait for the slowest rank."""
UNIT = "ms"
KERNEL = "nccl"


def read(ctx):
    s = ctx.device_seconds(KERNEL)
    return None if s is None else 1e3 * s / ctx.scenes
