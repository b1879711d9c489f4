"""Seconds per scene of the seed front end (`features`, `geometry`,
`pmvs.seed`): the program's `seed` stage span."""
UNIT = "s"


def read(ctx):
    s = ctx.stage_s.get("seed")
    return None if s is None else s / ctx.scenes
