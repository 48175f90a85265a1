"""Readers of the metrics, one file a metric: ``metrics/<name>.py`` defines
``read(run)``, which returns the metric's value or None where the run has
nothing to read, and may list in ``SPANS`` the port's entry points
("module:attr") whose calls its traced runs wrap. The helpers here are
shared by readers of one quantity in different cells."""

from __future__ import annotations

from portbench.workmodel.counts import bound_s, gram_work, tt_eval_work

GRAM = "tntorch_tpu_torch.ops.gram_kernels"
TT_EVAL = "tntorch_tpu_torch.ops.tt_eval"
GRAM_SPANS = (f"{GRAM}:gram_edge", f"{GRAM}:wgram", f"{GRAM}:proj2")


def rate(run):
    """The window's work over its seconds."""
    return run.window.work / run.window.seconds if run.window.seconds > 0 else None


def idle_share_pct(run):
    """The share of the traced window in which no kernel or copy ran."""
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(calls, work):
    """The least time of the calls' work over the device time they launched:
    ``work(call)`` gives (flops, bytes, dtype) from its arguments."""
    least = device = 0.0
    for call in calls:
        flops, nbytes, dtype = work(call)
        least += bound_s(flops, nbytes, dtype)
        device += call.device_s
    return 100.0 * least / device if calls and device > 0 else None


def gram_call_work(call):
    shapes = [a[0] for a in call.args if a is not None]
    dtype = call.args[0][1]
    return (*gram_work(call.attr, shapes, dtype), dtype)


def tt_eval_call_work(call, backward):
    cores, x = call.args[0], call.args[1]
    return (*tt_eval_work([c[0] for c in cores], x[0], cores[0][1], x[1], backward),
            cores[0][1])
