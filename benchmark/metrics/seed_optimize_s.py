"""Seconds per scene of the seeds' refinement (`pmvs.optimize`,
`ops.simplex`, `ops.nm_step`): the program's `seed_filter` and
`seed_optimize` stage spans (`densify`), or its `seed_refine` span, which
holds both (`densify_multihost`; rank 0's on several cards)."""
UNIT = "s"


def read(ctx):
    parts = [ctx.stage_s.get(k) for k in ("seed_filter", "seed_optimize",
                                      "seed_refine")]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts) / ctx.scenes
