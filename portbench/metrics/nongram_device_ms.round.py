"""Device milliseconds a round_tt call spends outside the Gram entry points:
CholeskyQR, the small products, the first and last cores, copies."""

from portbench.metrics import GRAM_SPANS

SPANS = GRAM_SPANS


def read(run):
    if run.trace is None or not run.trace.device or run.spans is None or not run.window.calls:
        return None
    gram = sum(c.device_s for c in run.spans.calls
               if c.attr in ("gram_edge", "wgram", "proj2"))
    return 1e3 * (run.trace.device_s() - gram) / run.window.calls
