"""Seconds per scene of expansion (`pmvs.expand`, `pmvs.organizer`, and
the refinement and scoring inside it): the program's `expand` stage
span."""
UNIT = "s"


def read(ctx):
    s = ctx.stage_s.get("expand")
    return None if s is None else s / ctx.scenes
