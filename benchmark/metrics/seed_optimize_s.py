"""Seconds per scene of the seeds' refinement (`pmvs.optimize`,
`ops.simplex`, `ops.nm_step`): the program's `seed_filter` and
`seed_optimize` stage spans."""
UNIT = "s"


def read(ctx):
    parts = [ctx.stage_s.get(k) for k in ("seed_filter", "seed_optimize")]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts) / ctx.scenes
