"""The traced stretch of a ``--trace 1`` run: torch.profiler (CPU and CUDA)
events reduced to plain lists that the metric readers and the breakdown
read, and the interval arithmetic they share.

A trace is a dict of (name, start_us, end_us) lists: ``kernels`` (device
kernels), ``copies`` (device memcpy and memset), ``ranges`` (the host's
``record_function`` ranges, the program's ``enc/...`` and ``dec/...``
among them) and ``window`` (start_us, end_us) of the stretch.  Events
stay in memory; nothing is written to disk.
"""

from __future__ import annotations

import contextlib

WINDOW_RANGE = "bench/traced-stretch"


def union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def clip(spans, window):
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def busy_us(trace) -> float:
    """Device time in the window: the union over every stream of kernels
    and copies."""
    spans = [(a, b) for _, a, b in trace["kernels"] + trace["copies"]]
    return union_us(clip(spans, trace["window"]))


def gaps(trace):
    """The device's idle intervals inside the window."""
    spans = sorted(clip([(a, b) for _, a, b in
                         trace["kernels"] + trace["copies"]],
                        trace["window"]))
    lo, hi = trace["window"]
    out, cur = [], lo
    for a, b in spans:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def breakdown(trace, n: int = 10) -> dict:
    """{"device_ops": the n kernel (or copy) names with the most device
    time, [name, seconds]; "idle_gaps": the device's idle time by the
    host range it fell in (the innermost ``record_function`` range over
    the gap's middle, or "no host range"), the n largest, [name,
    seconds]}."""
    ops = {}
    for name, a, b in trace["kernels"] + trace["copies"]:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    idle = {}
    ranges = [r for r in trace["ranges"] if r[0] != WINDOW_RANGE]
    for a, b in gaps(trace):
        mid = (a + b) / 2
        inside = [r for r in ranges if r[1] <= mid <= r[2]]
        label = (min(inside, key=lambda r: r[2] - r[1])[0] if inside
                 else "no host range")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:n]]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def from_profiler(prof) -> dict:
    """A trace from a finished torch.profiler.profile."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, copies, ranges, window = [], [], [], None
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if e.is_user_annotation:
                continue
            (copies if e.name.startswith(("Memcpy", "Memset"))
             else kernels).append(span)
        elif e.is_user_annotation:
            ranges.append(span)
            if e.name == WINDOW_RANGE:
                window = span[1:]
    if window is None:
        raise RuntimeError("the traced stretch's range is not in the trace")
    return {"kernels": kernels, "copies": copies, "ranges": ranges,
            "window": window}


@contextlib.contextmanager
def traced(sync):
    """Trace the block: CPU and CUDA activities, the block inside the
    stretch's range, the device synchronised at both ends.  Yields a dict
    whose "trace" is filled in when the block ends."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_RANGE):
            yield out
            sync()
    out["trace"] = from_profiler(prof)
