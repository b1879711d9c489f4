"""Seconds per scene spent capturing Nelder-Mead's blocks as CUDA graphs:
the program's `nm/capture` spans (`ops/simplex.py`), summed."""
UNIT = "s"


def read(ctx):
    lo, hi = ctx.window
    spans = [(s, e) for name, s, e in ctx.trace.host_spans
             if name == "nm/capture"]
    if not spans:
        return None
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in spans) / ctx.scenes
