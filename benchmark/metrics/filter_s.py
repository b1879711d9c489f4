"""Seconds per scene of the filters and colouring (`pmvs.filter`,
`pmvs.visibility`): the program's `filter` and `color` stage spans."""
UNIT = "s"


def read(ctx):
    parts = [ctx.stage_s.get(k) for k in ("filter", "color")]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts) / ctx.scenes
