"""The Gram kernels' share of their roofline: the least time that the work
of every gram_edge, wgram and proj2 call of the traced window needs (the
larger of its FLOPs over the dtype's peak and its bytes over HBM's rate),
over the device time of all that those calls launched."""

from portbench.metrics import GRAM_SPANS, gram_call_work, roofline_pct

SPANS = GRAM_SPANS


def read(run):
    if run.spans is None:
        return None
    calls = [c for c in run.spans.calls if c.attr in ("gram_edge", "wgram", "proj2")]
    return roofline_pct(calls, gram_call_work)
