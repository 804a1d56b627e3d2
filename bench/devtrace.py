"""What a ``torch.profiler`` trace of a stretch of the window says.

The arithmetic of the bring-up's profiling of the captured sweeps (device
time from the device's events, host calls that put work on the device),
taken over a stretch of many calls rather than one, with the device's busy
time as the union of its events' intervals.  The stretch is the span of the
units of work (:func:`unit`) that the device's events cover wholly, so a
trace whose device events start late or stop early counts what it saw.
"""

from __future__ import annotations

import bisect
from contextlib import contextmanager

#: host calls that put work on the device, as the profiler names them (a
#: graph replay is one)
ENQUEUES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
            "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperative")
#: idle gaps attributed to a host operation one by one, longest first; the
#: rest are summed under one entry
GAPS_NAMED = 500
TOP = 10
#: the host range around one unit of traced work (a solve and its
#: synchronize)
UNIT = "bench.unit"


@contextmanager
def profiled():
    """``torch.profiler`` over the host and the device; yields the profile."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def unit():
    """Marks one unit of traced work; its device work must be synchronized
    inside the mark."""
    from torch.profiler import record_function
    return record_function(UNIT)


def warm(device) -> None:
    """Start and stop the profiler once on a trivial device operation: its
    first start in a process initialises the device tracer, which takes
    seconds and belongs in set-up, not in the traced stretch."""
    import torch
    with profiled():
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged (start, end) intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(host, starts, t: float) -> str:
    """The shortest host event that covers time ``t``."""
    best, best_len = None, float("inf")
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host[max(0, i - 4000):i]):
        if b >= t and b - a < best_len:
            best, best_len = name, b - a
    return best or "no host operation (Python between calls)"


def summarize(events, window_s: float) -> dict:
    """Over the stretch: the units of work in it, busy seconds (union of
    device events), the idle share, host enqueue calls by name,
    device-to-device copy seconds, the device operations that took most
    time, and the idle gaps between device work summed by the host
    operation that ran meanwhile.  ``events`` are the profile's
    ``events()``.  The stretch runs from the first unit that starts after
    the device's first event to the last that ends before its last event;
    without units it is the whole ``window_s``."""
    from torch.autograd import DeviceType
    dev, host, marks = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a unit's mark is mirrored on the device as an annotation that
            # spans its work, gaps included: not an operation
            if a < b and e.name != UNIT:
                dev.append((a, b, e.name))
        elif e.device_type == DeviceType.CPU:
            (marks if e.name == UNIT else host).append((a, b, e.name))
    units = 0
    lo, hi = -float("inf"), float("inf")
    if marks:
        d0 = min((a for a, _, _ in dev), default=0.0)
        d1 = max((b for _, b, _ in dev), default=0.0)
        inside = sorted((a, b) for a, b, _ in marks if a >= d0 and b <= d1)
        units = len(inside)
        lo, hi = (inside[0][0], inside[-1][1]) if inside else (0.0, 0.0)
        window_s = (hi - lo) / 1e6
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev
           if min(b, hi) > max(a, lo)]
    calls: dict[str, int] = {}
    for a, _, name in host:
        if name.startswith(ENQUEUES) and lo <= a <= hi:
            calls[name] = calls.get(name, 0) + 1
    busy = union((a, b) for a, b, _ in dev)
    busy_us = sum(b - a for a, b in busy)
    by_name: dict[str, float] = {}
    d2d_us = 0.0
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if "DtoD" in name:
            d2d_us += b - a
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])
    host.sort()
    starts = [a for a, _, _ in host]
    idle: dict[str, float] = {}
    for k, (a, b) in enumerate(gaps):
        name = _innermost(host, starts, (a + b) / 2) if k < GAPS_NAMED \
            else f"shorter gaps (beyond the {GAPS_NAMED} longest)"
        idle[name] = idle.get(name, 0.0) + (b - a)

    def top(d):
        return [[n[:160], us / 1e6] for n, us in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(units=units, busy_s=busy_us / 1e6, window_s=window_s,
                idle_share=max(0.0, 1.0 - busy_us / 1e6 / window_s)
                if busy_us > 0 else None,
                launches=sum(calls.values()), host_calls=calls,
                d2d_s=d2d_us / 1e6, device_events=len(dev),
                device_ops=top(by_name), idle_gaps=top(idle))
