"""Host-device synchronisations a training step makes inside the port's
spans, on every thread (the backward runs on autograd's): stream, device
and event synchronizes and synchronous copies."""

from portbench.portspans import per_call, syncs


def read(run):
    return per_call(run, syncs(run.trace))
