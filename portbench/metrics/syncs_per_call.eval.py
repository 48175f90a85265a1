"""Host-device synchronisations a ``tn.tt_eval`` call makes inside the
port's spans: stream, device and event synchronizes and synchronous copies
(`portbench.portspans.SYNCS`)."""

from portbench.portspans import per_call, syncs


def read(run):
    return per_call(run, syncs(run.trace))
