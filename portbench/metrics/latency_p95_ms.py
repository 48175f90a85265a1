"""The 95th percentile of every call of the window, in milliseconds: one
round_tt, one tt_eval, or one training step (entry to entry of the loss)."""

from portbench.bench import p95


def read(run):
    lat = run.window.latencies
    return 1e3 * p95(lat) if lat else None
