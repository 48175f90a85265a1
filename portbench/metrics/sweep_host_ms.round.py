"""Host milliseconds a ``round_tt`` call spends in the port's Python and
launches: the ``tn.round_tt`` spans, less the ``tn.wait:*`` spans inside
them (the sketches' copies)."""

from portbench.portspans import host_s, per_call


def read(run):
    return per_call(run, host_s(run.trace, "tn.round_tt"), 1e3)
