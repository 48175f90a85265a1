"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and builds the result line.

Everything a cell needs is named in ``BENCHMARK.json`` and found by that
name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``drivers/<kind>.py`` (the mix's ``kind``) and ``metrics/<metric>.py``. A
later cell, configuration, mix or metric is new files and new entries; no
file here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no run may import: the JAX package and JAX
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tntorch_tpu"})
# A traced run profiles at most this many seconds of its window
TRACE_SECONDS = 5.0


def forbidden_modules(names) -> list:
    """The forbidden top-level names among module ``names``, compared whole:
    ``tntorch_tpu_torch`` is not ``tntorch_tpu``."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


class Benchmark:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, path=ROOT / "BENCHMARK.json"):
        self.path = Path(path)
        self.root = self.path.parent
        self.spec = json.loads(self.path.read_text())
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in {self.path.name}")
        return self.cells[name]

    def config_of(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return json.loads((self.root / entry["file"]).read_text())

    def mix_of(self, cell: dict) -> dict:
        return json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def metrics_of(self, cell: dict, kind: str) -> list:
        """The cell's end-to-end (``kind='end_to_end'``) or per-layer metrics:
        those without a ``workloads`` list, and those whose list holds it."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_class(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}").Driver


@dataclass
class Run:
    """What a metric's reader reads: the window, and in a traced run the
    trace and the spans."""
    cell: dict
    config: dict
    mix: dict
    window: object
    setup_s: float
    trace: object = None
    spans: object = None


class Hooks:
    """Opens and closes the measured window for a driver: the time it opens,
    and in a traced run the spans and the profiler around it."""

    def __init__(self, spans=None):
        self.spans = spans
        self.opened_at = None
        self.trace = None
        self._prof = None
        self._range = None

    def open(self):
        if self.spans is not None:
            from torch.profiler import ProfilerActivity, profile, record_function

            from portbench.tracing import WINDOW

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.start()
            self.spans.active = True
            self._range = record_function(WINDOW)
            self._range.__enter__()
        self.opened_at = time.perf_counter()

    def close(self, sync):
        sync()
        if self.spans is not None:
            import os
            import tempfile

            from portbench.tracing import Trace

            self._range.__exit__(None, None, None)
            self.spans.active = False
            self._prof.stop()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                self.trace = Trace.load(path)
            self._prof = None


def run_cell(bench: Benchmark, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides=None, process_age=None):
    """One run of cell ``name``: returns (result dict, checks). ``overrides``
    replaces entries of the configuration and the mix (the tests' small
    sizes); ``process_age()`` gives the seconds since the process started."""
    from portbench.drivers import sync_for
    from portbench.reference.precision import full_precision_matmuls
    from portbench.tracing import Spans

    cell = bench.cell(name)
    config, mix = bench.config_of(cell), bench.mix_of(cell)
    for key, value in (overrides or {}).items():
        (config if key in config else mix)[key] = value
    driver = driver_class(mix["kind"])(config, mix, seed, device)
    kind = "per_layer" if trace else "end_to_end"
    metrics = bench.metrics_of(cell, kind)
    readers = {m["name"]: load_module(metric_path(m["name"])) for m in metrics}

    driver.setup()
    spans = None
    if trace:
        targets = {t for r in readers.values() for t in getattr(r, "SPANS", ())}
        spans = Spans(targets)
        spans.install()
    hooks = Hooks(spans)
    sync = sync_for(device)
    window = driver.window(min(seconds, TRACE_SECONDS) if trace else seconds, hooks, sync)
    if spans is not None:
        spans.remove()
        hooks.trace.attribute(spans)
    setup_s = (process_age() - (time.perf_counter() - hooks.opened_at)) if process_age else None

    import torch

    on_card = str(device).startswith("cuda")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release()
    full_precision_matmuls()
    checks = driver.check()

    run = Run(cell, config, mix, window, setup_s, hooks.trace, spans)
    values = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = window.failed == 0 and all(v <= lim for v, lim in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": window.calls,
        "failed": window.failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        result["device"]["busy_s"] = hooks.trace.busy_s
        result["device"]["window_s"] = hooks.trace.window_s
        result["breakdown"] = hooks.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def p95(values) -> float:
    """The 95th percentile (inclusive quantiles)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def print_result(result: dict, out=sys.stdout, err=sys.stderr):
    """The checks as the last lines on standard error, and the result as the
    last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
