"""Host milliseconds a training step spends in ``t[X]``'s evaluation
(``Tensor._evaluate``: the coordinates, ``tn.tt_eval``, the returned
``Tensor`` and its ``np.arange``): the ``tn.getitem`` spans, less the
``tn.wait:*`` spans inside them."""

from portbench.portspans import host_s, per_call


def read(run):
    return per_call(run, host_s(run.trace, "tn.getitem"), 1e3)
