"""Readers of the port's own spans: the ``tn.*`` ranges that
``tntorch_tpu_torch.utils.trace_annotation`` records while the profiler
runs, on the same clock as the device's kernels.

A span is a ``user_annotation`` event that ends inside the traced window,
clipped to the window's start: a span still open as the window closes
belongs to a call after the window's last (the training driver closes the
window inside the next step, whose spans enclose the window's own closing
synchronize). Spans of one name on one thread are merged (nested or
repeated calls count once: the outermost on each thread). A ``tn.wait:*`` span marks
a place where the port blocks on the card on purpose (a flag's or a loss's
read, a copy from pageable memory); the host time of a layer leaves those
out. Every reader returns None where the trace has none of the spans it
reads (a run without a trace, or a program without the spans)."""

from __future__ import annotations

import bisect
import re

from portbench.tracing import LAUNCH_CATS

PORT = "tn."
WAIT = "tn.wait:"
# CUDA runtime and driver calls that block the host until the card has
# finished earlier work (a synchronous copy waits for its stream), by name
# without the API version and per-thread-stream suffixes
SYNCS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpy",
    "cuMemcpyHtoD", "cuMemcpyDtoH", "cuMemcpyDtoD", "cuMemcpy2D", "cuMemcpy3D",
})
_SUFFIX = re.compile(r"(_v\d+)?(_ptsz|_ptds)?$")


def is_sync(name: str) -> bool:
    return _SUFFIX.sub("", name) in SYNCS


def _merge(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """Seconds that two unions of disjoint sorted intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class _Union:
    """A thread's union of spans, for testing where a time lies."""

    def __init__(self, intervals):
        self.intervals = intervals
        self.starts = [s for s, _ in intervals]

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.intervals[i][1]


def spans(trace, select) -> dict:
    """The union a thread of the spans whose name ``select`` accepts that
    end inside the window, clipped to its start: {thread: [[start, end],
    ...]}."""
    lo, hi = trace.window
    found = {}
    for s, e, name, cat, thread in trace.host:
        if cat == "user_annotation" and select(name) and lo < e <= hi:
            found.setdefault(thread, []).append((max(s, lo), e))
    return {thread: _merge(ivs) for thread, ivs in found.items()}


def _port_spans(trace) -> dict:
    """Every thread's union of ``tn.*`` spans, as `_Union`s."""
    found = spans(trace, lambda n: n.startswith(PORT))
    return {thread: _Union(ivs) for thread, ivs in found.items()}


def host_s(trace, name: str, thread=None):
    """Host seconds inside the spans named ``name`` (on ``thread`` only,
    where given), less the ``tn.wait:*`` spans inside them; None where the
    window has no such span."""
    if trace is None:
        return None
    inside = spans(trace, lambda n: n == name)
    if thread is not None:
        inside = {t: ivs for t, ivs in inside.items() if t == thread}
    if not inside:
        return None
    waits = spans(trace, lambda n: n.startswith(WAIT))
    return sum(_length(ivs) - _overlap(ivs, waits.get(t, [])) for t, ivs in inside.items())


def syncs(trace):
    """The synchronising runtime and driver calls of the window that start
    inside a ``tn.*`` span of their thread; None where the window has no
    such span."""
    if trace is None:
        return None
    inside = _port_spans(trace)
    if not inside:
        return None
    return sum(1 for s, _, name, cat, thread in trace.host
               if cat in LAUNCH_CATS and is_sync(name) and thread in inside
               and s in inside[thread])


def launches(trace):
    """The runtime and driver calls inside a ``tn.*`` span of their thread
    that launched a kernel, copy or memset of the window, matched by
    correlation id; None where the window has no such span."""
    if trace is None:
        return None
    inside = _port_spans(trace)
    if not inside:
        return None
    issued = set()
    for *_, corr in trace.device:
        launch = trace.launches.get(corr)
        if launch is not None and launch[1] in inside and launch[0] in inside[launch[1]]:
            issued.add(corr)
    return len(issued)


def per_call(run, value, scale=1.0):
    """``value`` times ``scale`` over the window's calls; None where there
    is no value or no call."""
    if value is None or not run.window.calls:
        return None
    return scale * value / run.window.calls
