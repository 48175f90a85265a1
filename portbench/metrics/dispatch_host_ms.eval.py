"""Host milliseconds a ``tn.tt_eval`` call spends in the port's Python and
launches: the ``tn.tt_eval`` spans (outermost a thread), less the
``tn.wait:*`` spans inside them (the dims copy, the flag's read)."""

from portbench.portspans import host_s, per_call


def read(run):
    return per_call(run, host_s(run.trace, "tn.tt_eval"), 1e3)
