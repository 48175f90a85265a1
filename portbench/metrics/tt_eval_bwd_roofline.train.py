"""The backward evaluation's share of its roofline: the least time that the
work of every tt_eval_backward_kernel call of the traced window needs, over
the device time of all that those calls launched."""

from portbench.metrics import TT_EVAL, roofline_pct, tt_eval_call_work

SPANS = (f"{TT_EVAL}:tt_eval_backward_kernel",)


def read(run):
    if run.spans is None:
        return None
    calls = run.spans.of("tt_eval_backward_kernel")
    return roofline_pct(calls, lambda c: tt_eval_call_work(c, backward=True))
