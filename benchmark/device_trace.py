"""Reduction of a `torch.profiler` trace of the measured window to what
the per-layer readers and the result line take: the device operations
(kernels, copies and sets, with those replayed inside CUDA graphs) and the
host's spans, on one clock, in seconds.

Busy time is the union of the device operations' intervals: since the
solver runs on a side stream, operations of two streams overlap, and a
sum of their durations would count the overlap twice.
"""
from __future__ import annotations

import dataclasses

SCENE_SPAN = "bench/scene"
STAGE_PREFIX = "stage/"
TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    """Device operations and host spans as (name, start_s, end_s)."""

    device_ops: list
    host_spans: list

    def window(self):
        """(start, end) of the scenes' spans: the traced window."""
        scenes = [s for s in self.host_spans if s[0] == SCENE_SPAN]
        if not scenes:
            return None
        return min(s[1] for s in scenes), max(s[2] for s in scenes)


def from_profiler(prof) -> Trace:
    """The raw events of a stopped `torch.profiler.profile`, read without
    building the profiler's own event tree."""
    from torch.autograd import DeviceType

    device_ops, host_spans = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            # a host span's copy on the device's timeline is no operation
            if not ev.is_user_annotation():
                device_ops.append((ev.name(), start, end))
        else:
            host_spans.append((ev.name(), start, end))
    return Trace(device_ops, host_spans)


def merged(intervals, lo, hi):
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def busy_seconds(trace: Trace, lo, hi) -> float:
    return sum(e - s for s, e in merged(
        ((s, e) for _, s, e in trace.device_ops), lo, hi))


def idle_gaps(trace: Trace, lo, hi):
    """(start, end) of every stretch of [lo, hi] with no device operation,
    longest first."""
    busy = merged(((s, e) for _, s, e in trace.device_ops), lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return sorted(gaps, key=lambda g: g[0] - g[1])


def gap_label(trace: Trace, start, end) -> str:
    """What the host was doing across a gap: the stage span and the other
    host span that overlap it most (the innermost of equals)."""
    def overlap(s):
        return min(s[2], end) - max(s[1], start), s[1]

    best = {}
    for s in trace.host_spans:
        if s[0] == SCENE_SPAN or overlap(s)[0] <= 0:
            continue
        kind = "stage" if s[0].startswith(STAGE_PREFIX) else "op"
        if kind not in best or overlap(s) > overlap(best[kind]):
            best[kind] = s
    return " > ".join(best[k][0] for k in ("stage", "op") if k in best) \
        or "host"


def device_op_seconds(trace: Trace, lo, hi) -> dict:
    """Device seconds by operation name inside [lo, hi]."""
    by_name = {}
    for name, s, e in trace.device_ops:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d
    return by_name


def breakdown(trace: Trace, lo, hi) -> dict:
    """The `TOP` device operations by time and the `TOP` longest idle
    gaps, each labelled by what the host was doing."""
    ops = sorted(device_op_seconds(trace, lo, hi).items(),
                 key=lambda kv: -kv[1])[:TOP]
    gaps = idle_gaps(trace, lo, hi)[:TOP]
    return {
        "device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
        "idle_gaps": [[gap_label(trace, s, e)[:NAME_CHARS], e - s]
                      for s, e in gaps],
    }
