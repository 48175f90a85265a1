"""Runs one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's inputs on the card from the seed, warms up, measures one
caller's closed loop for ``--seconds`` (with ``--trace 1``: profiles at
most the first 5 seconds of it instead, with spans around the port's entry
points), checks what the window's calls returned against the plain
reference, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s``
and ``window_s``), with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared beside its limit. An earlier line names the card,
its power limit and the host's CPU.

Exits non-zero, printing no result, without a CUDA card, where the
package under test is missing, or where the process has imported JAX or
the JAX package. The caches of the build stay inside the checkout."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def process_age_s():
    """Seconds since this process started, by the kernel's clock ticks."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


_AGE0, _T0 = process_age_s(), time.perf_counter()


def age():
    return _AGE0 + (time.perf_counter() - _T0)


def _cache_dirs():
    """Fixed cache directories inside the checkout, for every compiler cache
    that the port or torch may fill."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def machine_line(torch) -> str:
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = [f"nvidia-smi failed: {exc}"]
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    cpu = fields.get("model name", "unknown")
    if cpu == "unknown":  # a virtual machine may hide the name: its family and model
        cpu = (f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} "
               f"model {fields.get('model', '?')}")
    return (f"card: {torch.cuda.get_device_name(0)}; nvidia-smi name, power limit: "
            f"{' | '.join(smi)}; host CPU: {cpu} ({os.cpu_count()} cores)")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from portbench.bench import Benchmark, forbidden_modules, print_result, run_cell

    bench = Benchmark()
    try:
        cell = bench.cell(args.workload)
    except KeyError as exc:
        print(f"portbench: {exc.args[0]}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    print(machine_line(torch), flush=True)
    result, _ = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", process_age=age)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
