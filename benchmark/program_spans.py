"""What the per-layer readers take from the program's own profiler spans
(named `layer/part` inside `densepoints_tpu_torch`): their union, and the
device's idle seconds inside it. An instant that several spans hold (nested
or overlapping) counts once."""
from __future__ import annotations

from benchmark import device_trace


def union(trace: device_trace.Trace, match, lo, hi):
    """The union of the host spans whose name `match`es, clipped to
    [lo, hi], as sorted disjoint [start, end] intervals."""
    return device_trace.merged(
        ((s, e) for name, s, e in trace.host_spans if match(name)), lo, hi)


def idle_inside(trace: device_trace.Trace, match, lo, hi):
    """Seconds of [lo, hi] inside the union of the spans that `match`, in
    which no operation ran on the device; None if the trace has no device
    operation or no such span."""
    inside = union(trace, match, lo, hi)
    if not trace.device_ops or not inside:
        return None
    busy = device_trace.merged(((s, e) for _, s, e in trace.device_ops),
                               lo, hi)
    overlap, j = 0.0, 0
    for start, end in inside:
        while j < len(busy) and busy[j][1] <= start:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < end:
            overlap += min(end, busy[k][1]) - max(start, busy[k][0])
            k += 1
    return sum(e - s for s, e in inside) - overlap
