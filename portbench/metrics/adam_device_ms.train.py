"""Device milliseconds a training step spends in the optimizer's update:
the kernels launched inside torch's own ``Optimizer.step#Adam.step``
profiler range, over the window's steps."""


def read(run):
    if run.trace is None or not run.window.calls:
        return None
    by_range = run.trace.device_s_by_range(lambda n: n.startswith("Optimizer.step#"))
    if not by_range:
        return None
    return 1e3 * sum(by_range.values()) / run.window.calls
