"""Drivers of the traffic kinds. A traffic mix (``traffic/<mix>.json``)
names its ``kind``; ``drivers/<kind>.py`` defines ``Driver``, which makes
the cell's inputs from the seed, warms up, runs the measured window as one
caller in a closed loop, and checks what the window's calls returned
against the plain reference.

A driver's interface:

- ``Driver(config, mix, seed, device)``;
- ``setup()``: inputs on the device and every shape of the window warmed up;
- ``window(seconds, hooks, sync) -> Window``: ``hooks.open()`` as the
  window opens and ``hooks.close(sync)`` as it closes;
- ``release()``: drops the program's state, keeping what the check needs;
- ``check() -> {name: (value, limit)}``: each number compared, and its
  limit from the mix; the run is correct where every value is within its
  limit;
- ``control(precision) -> {name: value}``: the same numbers with the plain
  reference, computed in ``precision``, in the program's place.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    """What one measured window did: its seconds, its calls and the work they
    completed (in the unit of the cell's rate), each call's seconds, and the
    calls that raised."""
    seconds: float
    calls: int
    work: float
    latencies: list = field(default_factory=list)
    failed: int = 0


class Reservoir:
    """A sample of k of the window's results, drawn from the seed
    (reservoir sampling: each call's result is kept with equal chance,
    however many calls the window makes)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, index, value):
        if len(self.items) < self.k:
            self.items.append((index, value))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = (index, value)
        self.seen += 1


def closed_loop(call, seconds: float, work_per_call: float, sync, hooks, keep=None) -> Window:
    """One caller issuing ``call(i)`` back to back until ``seconds`` have
    passed; a call ends when ``sync()`` returns after it. The window ends
    with the last call, which started before the deadline; ``hooks`` opens
    and closes it."""
    import sys
    import traceback

    latencies, failed = [], 0
    hooks.open()
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            out = call(i)
            sync()
        except Exception:  # a failed call counts as failed; the window goes on
            if failed == 0:
                traceback.print_exc(file=sys.stderr)
            failed += 1
            out = None
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if keep is not None and out is not None:
            keep.offer(i, out)
        i += 1
        if t1 >= deadline:
            break
    hooks.close(sync)
    return Window(seconds=t1 - start, calls=i, work=(i - failed) * work_per_call,
                  latencies=latencies, failed=failed)


def worst(values) -> float:
    """The largest of the tensors' entries, NaN counted as infinite; infinite
    where there is none."""
    import torch

    values = [torch.nan_to_num(v.double(), nan=float("inf")).max() for v in values if v.numel()]
    return float(max(values)) if values else float("inf")


def sync_for(device):
    import torch

    if str(device).startswith("cuda"):
        return torch.cuda.synchronize
    return lambda: None


def generator(seed: int, device, stream: int):
    """A torch generator on ``device`` for one of the run's input streams."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g
