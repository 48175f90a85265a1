"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process: the program's numbers on many seeds (each after a
window at the cell's load), the control's (the plain reference computed in
the precision below the configuration's, in the program's place, after
such a window), and for a training cell the readings of a planted fault (half of
the samples left out of each step, the mean taken over the rest).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--seconds 2] [--faults]

Prints one JSON line per reading and, last, each number's largest program
reading and smallest control reading. The benchmark's own runs never run
this."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--faults", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.bench import Benchmark, Hooks, driver_class
    from portbench.drivers import sync_for
    from portbench.reference.precision import BELOW, full_precision_matmuls

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    bench = Benchmark()
    cell = bench.cell(args.workload)
    config, mix = bench.config_of(cell), bench.mix_of(cell)
    Driver = driver_class(mix["kind"])
    full_precision_matmuls()
    program, control = {}, {}

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def after_window(seed):
        d = Driver(config, mix, seed, "cuda")
        d.setup()
        d.window(args.seconds, Hooks(), sync_for("cuda"))
        d.release()
        return d

    for seed in seeds(args.seeds):
        d = after_window(seed)
        readings = {k: v for k, (v, _) in d.check().items()}
        print(json.dumps({"seed": seed, "side": "program", **readings}), flush=True)
        for k, v in readings.items():
            program[k] = max(program.get(k, 0.0), v)
        del d
    below = BELOW[mix["dtype"]]
    for seed in seeds(args.control_seeds):
        d = after_window(seed)  # a training control steps from the window's last state
        readings = d.control(below)
        print(json.dumps({"seed": seed, "side": f"control {below}", **readings}), flush=True)
        for k, v in readings.items():
            control[k] = min(control.get(k, float("inf")), v)
        if args.faults and hasattr(d, "half_batch_fault"):
            print(json.dumps({"seed": seed, "side": "fault half batch", **d.half_batch_fault()}),
                  flush=True)
        del d
    print(json.dumps({"program_max": program, "control_min": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
