"""Host milliseconds of a training step on the window's thread: the
``tn.optimize:step`` spans, less the ``tn.wait:*`` spans inside them (the
loss's read, the forward's dims copy and flag). The backward's own thread
is not counted; the window's thread waits for it inside the step."""

from portbench.portspans import host_s, per_call


def read(run):
    t = run.trace
    return per_call(run, host_s(t, "tn.optimize:step", t.window_thread if t else None), 1e3)
