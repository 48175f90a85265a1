"""The harness on the CPU: every cell resolves to its files by name, the
benchmark file keeps the contract's characters, the cells run correct at
small sizes (the plain references agree with the port's CPU path), the
controls fail there, the import check and the refusal without a card, and
the reading of a profiler trace."""

import json
import re

import pytest
import torch

from portbench.bench import (HERE, Benchmark, Hooks, driver_class, forbidden_modules, metric_path,
                             run_cell)
from portbench.drivers import sync_for

BENCH = Benchmark()
CELLS = sorted(BENCH.cells)
# Each cell at a size a test run holds: its configuration's and mix's keys
SMALL = {
    "round": {"mode_size": 8, "rank": 8, "batch": 4, "rmax": 4, "points": 256},
    "eval": {"mode_size": 16, "rank": 8, "points": 4096},
    "train": {"mode_size": 32, "rank": 16, "samples": 16384},
}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def small(cell):
    return SMALL[BENCH.mix_of(BENCH.cell(cell))["kind"]]


def small_driver(cell, seed):
    c = BENCH.cell(cell)
    config, mix = BENCH.config_of(c), BENCH.mix_of(c)
    for key, value in small(cell).items():
        (config if key in config else mix)[key] = value
    return driver_class(mix["kind"])(config, mix, seed, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = BENCH.cell(cell)
    config = BENCH.config_of(c)
    assert config["name"] == c["config"]
    mix = BENCH.mix_of(c)
    assert hasattr(driver_class(mix["kind"]), "check")
    assert mix["limits"] and all(v > 0 for v in mix["limits"].values())
    for kind in ("end_to_end", "per_layer"):
        metrics = BENCH.metrics_of(c, kind)
        assert metrics
        for m in metrics:
            assert metric_path(m["name"]).exists(), m["name"]
    names = {m["name"] for m in BENCH.metrics_of(c, "end_to_end")}
    assert "setup_s" in names and len(names) >= 2
    for m in BENCH.metrics_of(c, "per_layer"):
        assert m["moves"] in names  # the cell reports what its per-layer metrics move


def test_benchmark_file_keeps_the_contract():
    spec = BENCH.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and spec["command"][1] == "portbench/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (HERE.parent / c["file"]).exists()
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in BENCH.configs
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
        names.append(m["name"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for text in [c["why"] for c in spec["configs"] + spec["workloads"]] + \
            [m["layer"] for m in spec["per_layer"]] + [c["source"] for c in spec["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(spec)) < 64 * 1024


def test_the_import_check_compares_whole_top_level_names():
    assert forbidden_modules(["jax.numpy", "tntorch_tpu.ops", "numpy", "flax"]) == [
        "flax", "jax", "tntorch_tpu"]
    assert forbidden_modules(["tntorch_tpu_torch", "tntorch_tpu_torch.ops.tt_eval",
                              "jaxtyping", "portbench.bench"]) == []


def test_a_run_without_a_card_fails(capsys, monkeypatch):
    from portbench.run import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.delenv(var, raising=False)  # main() sets them; restored after the test
    rc = main(["--workload", CELLS[0], "--seed", "3000000000", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA card" in out.err


@pytest.mark.parametrize("cell", CELLS)
def test_small_runs_are_correct_against_the_plain_reference(cell):
    result, checks = run_cell(BENCH, cell, 3_000_000_017, 0.2, False, device="cpu",
                              overrides=small(cell))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    rate = [m["name"] for m in BENCH.metrics_of(BENCH.cell(cell), "end_to_end")
            if m["name"] not in ("setup_s", "latency_p95_ms")]
    assert set(rate) <= set(result["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_at_a_small_size(cell):
    """The control (the reference one precision below the configuration's, in
    the program's place) fails one of the cell's numbers, on three seeds."""
    from portbench.reference.precision import BELOW

    for seed in (11, 12, 13):
        d = small_driver(cell, seed)
        d.setup()
        d.window(0.2, Hooks(), sync_for("cpu"))  # a training control steps from its end
        d.release()
        readings = d.control(BELOW[d.mix["dtype"]])
        assert any(readings[k] > lim for k, lim in d.mix["limits"].items()), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_at_the_cells_size(cell, card):
    from portbench.reference.precision import BELOW

    c = BENCH.cell(cell)
    config, mix = BENCH.config_of(c), BENCH.mix_of(c)
    for seed in (3_000_000_101, 3_000_000_102, 3_000_000_103):
        d = driver_class(mix["kind"])(config, mix, seed, card)
        d.setup()
        d.window(2.0, Hooks(), sync_for(card))
        d.release()
        readings = d.control(BELOW[mix["dtype"]])
        assert any(readings[k] > lim for k, lim in mix["limits"].items()), readings
        del d


def test_the_reference_sweep_is_the_ports_in_float64():
    import tntorch_tpu_torch as tn
    from portbench.reference.precision import Precision
    from portbench.reference.rounding import round_randgram

    g = torch.Generator().manual_seed(5)
    ranks = [1, 8, 8, 8, 1]
    cores = [torch.randn((3, ranks[k], 6, ranks[k + 1]), generator=g, dtype=torch.float64)
             for k in range(4)]
    t = tn.Tensor([c.clone() for c in cores], batch=True)
    t.round_tt(rmax=4, algorithm="randgram")
    want = round_randgram(cores, 4, "float64", Precision("float64"))
    for a, b in zip(t.cores, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _event(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            "args": args}


def test_the_trace_attributes_device_time_by_launching_range():
    from portbench.tracing import SpanCall, Spans, Trace

    events = [
        _event("user_annotation", "pb:window", 0, 100),
        _event("user_annotation", "pb:gram_edge:0", 10, 20),
        _event("cpu_op", "aten::mm", 40, 20),
        _event("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=1),
        _event("cuda_runtime", "cudaLaunchKernel", 42, 2, correlation=2),
        _event("cuda_runtime", "cudaMemcpyAsync", 60, 2, correlation=3),
        _event("kernel", "gram", 20, 30, tid=7, pid=0, correlation=1),
        _event("kernel", "gemm", 55, 5, tid=7, pid=0, correlation=2),
        _event("gpu_memcpy", "Memcpy DtoH", 70, 10, tid=7, pid=0, correlation=3),
        _event("gpu_user_annotation", "pb:gram_edge:0", 20, 30, tid=7, pid=0),
        _event("cpu_op", "autograd::engine", 85, 15, tid=2),
    ]
    t = Trace.from_events(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6) and t.device_s() == pytest.approx(45e-6)
    spans = Spans([])
    spans.calls.append(SpanCall("gram_edge", 0, []))
    t.attribute(spans)
    assert spans.calls[0].device_s == pytest.approx(30e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["gram", pytest.approx(30e-6)]
    # idle: 0-20 (in the span, before its kernel), 50-55 (in aten::mm), 60-70 (in the
    # window alone), 80-100 (in the window, and in autograd's thread at its middle)
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps["pb:gram_edge"] == pytest.approx(20e-6)
    assert gaps["aten::mm"] == pytest.approx(5e-6)
    assert gaps["pb:window (the benchmark's loop, Python)"] == pytest.approx(10e-6)
    assert gaps["autograd::engine"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(55e-6)
