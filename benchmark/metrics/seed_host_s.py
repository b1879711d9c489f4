"""Seconds per scene in which the device sat idle inside the program's
`seed/*` spans (`pmvs/seed.py`: detect, describe, pairs, match, tracks,
triangulate): the card waiting on the seed front end's host work."""
UNIT = "s"


def read(ctx):
    from benchmark import program_spans

    s = program_spans.idle_inside(ctx.trace,
                                  lambda name: name.startswith("seed/"),
                                  *ctx.window)
    return None if s is None else s / ctx.scenes
