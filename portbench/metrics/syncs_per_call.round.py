"""Host-device synchronisations a ``round_tt`` call makes inside the port's
spans: stream, device and event synchronizes and synchronous copies."""

from portbench.portspans import per_call, syncs


def read(run):
    return per_call(run, syncs(run.trace))
