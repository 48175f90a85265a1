"""Kernels, copies and memsets a ``tn.tt_eval`` call launches from inside
the port's spans: the CUDA runtime and driver calls of a ``tn.*`` span
matched by correlation id to the window's device events."""

from portbench.portspans import launches, per_call


def read(run):
    return per_call(run, launches(run.trace))
