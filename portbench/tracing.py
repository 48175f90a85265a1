"""Spans that the benchmark puts around the port's entry points, the
profiler over a traced window, and the reading of its trace.

A span wraps a module attribute that the port calls through its module
(``"tntorch_tpu_torch.ops.gram_kernels:gram_edge"``): each call runs inside
a profiler range ``pb:<attr>:<n>`` and its arguments' shapes are kept, so
that a reader counts the call's work from the shapes and its device time
from the kernels and copies launched inside the range, whatever their
names. Spans are installed only in traced runs, and record only while
the window is open.

The trace is read from the profiler's Chrome trace (``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events on the device; the CUDA runtime
and driver calls that launched them, matched by their correlation ids; the
host's ranges and operators by time on their thread)."""

from __future__ import annotations

import bisect
import functools
import importlib
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "pb:window"
PREFIX = "pb:"


def _describe(x):
    """Shape and dtype of a tensor argument (a list of them for a list)."""
    import torch

    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).split(".")[-1])
    if isinstance(x, (list, tuple)) and x and all(isinstance(t, torch.Tensor) for t in x):
        return [_describe(t) for t in x]
    return None


@dataclass
class SpanCall:
    """One call of a wrapped entry point: its arguments as (shape, dtype),
    and the device seconds of what it launched (set from the trace)."""
    attr: str
    n: int
    args: list
    device_s: float = 0.0

    @property
    def range_name(self) -> str:
        return f"{PREFIX}{self.attr}:{self.n}"


class Spans:
    """Wraps each target ``"module:attr"`` in a recording profiler range."""

    def __init__(self, targets):
        self.targets = sorted(set(targets))
        self.calls: list[SpanCall] = []
        self.active = False  # spans record only while the window is open
        self._saved = []

    def install(self):
        from torch.profiler import record_function

        for target in self.targets:
            module_name, attr = target.split(":")
            module = importlib.import_module(module_name)
            original = getattr(module, attr)

            def wrapper(*args, _original=original, _attr=attr, **kwargs):
                if not self.active:
                    return _original(*args, **kwargs)
                call = SpanCall(_attr, len(self.calls), [_describe(a) for a in args])
                self.calls.append(call)
                with record_function(call.range_name):
                    return _original(*args, **kwargs)

            functools.update_wrapper(wrapper, original)
            self._saved.append((module, attr, original))
            setattr(module, attr, wrapper)

    def remove(self):
        for module, attr, original in reversed(self._saved):
            setattr(module, attr, original)
        self._saved.clear()

    def of(self, attr: str) -> list:
        return [c for c in self.calls if c.attr == attr]


@dataclass
class Trace:
    """The events of one traced window, in seconds on the trace's clock."""
    device: list = field(default_factory=list)   # (start, end, name, correlation)
    launches: dict = field(default_factory=dict)  # correlation -> (start, thread)
    host: list = field(default_factory=list)     # (start, end, name, cat, thread)
    window: tuple = (0.0, 0.0)
    window_thread: object = None

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_events(json.load(f)["traceEvents"])

    @classmethod
    def from_events(cls, events):
        t = cls()
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            start = float(e["ts"]) * 1e-6
            end = start + float(e.get("dur", 0.0)) * 1e-6
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                t.device.append((start, end, name, args.get("correlation")))
            elif cat in HOST_CATS:
                thread = (e.get("pid"), e.get("tid"))
                if cat in LAUNCH_CATS and "correlation" in args:
                    t.launches[args["correlation"]] = (start, thread)
                if name == WINDOW and cat == "user_annotation":
                    t.window, t.window_thread = (start, end), thread
                t.host.append((start, end, name, cat, thread))
        lo, hi = t.window
        t.device = sorted((max(s, lo), min(e, hi), n, c) for s, e, n, c in t.device
                          if e > lo and s < hi)
        return t

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the device's kernels and copies in the window."""
        merged = []
        for s, e, *_ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_s(self) -> float:
        """Summed device time of every kernel and copy in the window."""
        return sum(e - s for s, e, *_ in self.device)

    def device_s_by_range(self, select) -> dict:
        """Device seconds of the kernels and copies launched inside each host
        range whose name ``select`` accepts, by range name. Ranges of one name
        are summed; ranges nested in another selected range count for the
        outer one."""
        ranges = {}
        for s, e, name, cat, thread in self.host:
            if cat == "user_annotation" and select(name):
                ranges.setdefault(thread, []).append((s, e, name))
        outer = {}
        for thread, rs in ranges.items():
            rs.sort()
            kept = []
            for r in rs:
                if kept and r[1] <= kept[-1][1]:
                    continue
                kept.append(r)
            outer[thread] = ([r[0] for r in kept], kept)
        out = {}
        for s, e, _, corr in self.device:
            launch = self.launches.get(corr)
            if launch is None or launch[1] not in outer:
                continue
            starts, kept = outer[launch[1]]
            i = bisect.bisect_right(starts, launch[0]) - 1
            if i >= 0 and launch[0] <= kept[i][1]:
                out[kept[i][2]] = out.get(kept[i][2], 0.0) + (e - s)
        return out

    def attribute(self, spans: Spans):
        """Sets each span call's device seconds from the trace."""
        by_name = self.device_s_by_range(lambda n: n.startswith(PREFIX) and n != WINDOW)
        for call in spans.calls:
            call.device_s = by_name.get(call.range_name, 0.0)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing: the deepest range or
        operator open on the window's thread, or where that thread is in no
        range but the window, on another thread (autograd's backward runs on
        its own)."""
        ops = {}
        for s, e, name, _ in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s)
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        mids = [((a + b) / 2, b - a) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        times = [m for m, _ in mids]
        threads = {thread for *_, thread in self.host} - {self.window_thread}
        others = [self._host_at(times, thread) for thread in sorted(threads, key=str)]
        labels = self._host_at(times, self.window_thread)
        gaps = {}
        for i, (_, length) in enumerate(mids):
            label = labels[i]
            if label == WINDOW:
                label = next((o[i] for o in others if o[i] is not None), WINDOW)
            if label is None:
                label = "outside the window"
            elif label == WINDOW:
                label = "pb:window (the benchmark's loop, Python)"
            elif label.startswith(PREFIX):
                label = label.rsplit(":", 1)[0]
            gaps[label] = gaps.get(label, 0.0) + length

        def best(d):
            ranked = sorted(d.items(), key=lambda kv: -kv[1])[:top]
            return [[name[:120], sec] for name, sec in ranked]

        return {"device_ops": best(ops), "idle_gaps": best(gaps)}

    def _host_at(self, times, thread) -> list:
        """The name of the deepest host event of ``thread`` open at each of the
        (ascending) ``times``, None where there is none."""
        events = sorted((s, -e, name) for s, e, name, _, t in self.host if t == thread)
        labels, stack, i = [], [], 0
        for t in times:
            while i < len(events) and events[i][0] <= t:
                while stack and -stack[-1][1] < events[i][0]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and -stack[-1][1] < t:
                stack.pop()
            labels.append(stack[-1][2] if stack else None)
        return labels
