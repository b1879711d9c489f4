"""Seconds per scene in which the device sat idle inside the program's
`expand/round` spans (`pmvs/expand.py`): the card waiting on expansion's
host loop between and around its solves."""
UNIT = "s"


def read(ctx):
    from benchmark import program_spans

    s = program_spans.idle_inside(ctx.trace,
                                  lambda name: name == "expand/round",
                                  *ctx.window)
    return None if s is None else s / ctx.scenes
