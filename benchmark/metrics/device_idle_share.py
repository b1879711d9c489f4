"""Share of the traced window in which no operation ran on the device:
1 - (union of the device operations' intervals) / window. A union, not a
sum: the solver's side stream overlaps the main stream."""
UNIT = "fraction"


def read(ctx):
    from benchmark import device_trace

    lo, hi = ctx.window
    if hi <= lo or not ctx.trace.device_ops:
        return None
    return 1.0 - device_trace.busy_seconds(ctx.trace, lo, hi) / (hi - lo)
