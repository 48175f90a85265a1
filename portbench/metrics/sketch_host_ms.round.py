"""Host milliseconds a ``round_tt`` call spends drawing the randomized
edges' sketches on the CPU: the ``tn.round_tt:sketch`` spans, less the
``tn.wait:sketch_copy`` spans inside them."""

from portbench.portspans import host_s, per_call


def read(run):
    return per_call(run, host_s(run.trace, "tn.round_tt:sketch"), 1e3)
