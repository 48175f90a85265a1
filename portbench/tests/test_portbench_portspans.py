"""The readers of the port's own spans (`portbench/portspans.py` and the
nine metrics on it), on synthetic profiler events: host time inside a span
counted once a thread, its waits left out, clipped to the window; launches
matched by correlation; synchronisations by name and thread; nothing where
the run has no trace or no such span."""

import pytest

from portbench.bench import Run, load_module, metric_path
from portbench.drivers import Window
from portbench.portspans import is_sync
from portbench.tracing import Trace

HOST_MS = ("dispatch_host_ms.eval", "step_host_ms.train", "getitem_host_ms.train",
           "sweep_host_ms.round", "sketch_host_ms.round")
COUNTS = ("launches_per_call.eval", "syncs_per_call.eval", "syncs_per_call.train",
          "syncs_per_call.round")


def _event(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            "args": args}


def _read(metric, events, calls=2):
    run = Run({}, {}, {}, Window(seconds=1.0, calls=calls, work=calls), 0.0,
              None if events is None else Trace.from_events(events))
    return load_module(metric_path(metric)).read(run)


WINDOW = _event("user_annotation", "pb:window", 0, 100)


def test_nested_and_repeated_spans_count_once_a_thread():
    events = [WINDOW,
              _event("user_annotation", "tn.tt_eval", 10, 20),
              _event("user_annotation", "tn.tt_eval", 15, 5),  # nested: inside the first
              _event("user_annotation", "tn.tt_eval:launch", 18, 4),
              _event("user_annotation", "tn.tt_eval", 40, 10)]
    # (20 + 10) us over 2 calls, in ms
    assert _read("dispatch_host_ms.eval", events) == pytest.approx(15e-3)


def test_waits_inside_the_span_are_left_out():
    events = [WINDOW,
              _event("user_annotation", "tn.round_tt", 10, 40),
              _event("user_annotation", "tn.round_tt:sketch", 20, 10),
              _event("user_annotation", "tn.wait:sketch_copy", 24, 6),
              _event("user_annotation", "tn.round_tt:sketch", 35, 5),
              _event("user_annotation", "tn.wait:sketch_copy", 38, 2),
              _event("user_annotation", "tn.wait:flag", 60, 5)]  # outside every span read
    assert _read("sweep_host_ms.round", events) == pytest.approx((40 - 8) * 1e-3 / 2)
    assert _read("sketch_host_ms.round", events) == pytest.approx((15 - 8) * 1e-3 / 2)


def test_a_wait_on_another_thread_is_not_left_out():
    events = [WINDOW,
              _event("user_annotation", "tn.getitem", 10, 20),
              _event("user_annotation", "tn.wait:flag", 15, 10, tid=2)]
    assert _read("getitem_host_ms.train", events, calls=1) == pytest.approx(20e-3)


def test_spans_on_autograds_thread_count_but_the_step_reads_the_windows_thread():
    events = [WINDOW,
              _event("user_annotation", "tn.optimize:step", 10, 50),
              _event("user_annotation", "tn.wait:loss_read", 50, 10),
              # autograd's device thread: the backward's spans and its dims copy
              _event("user_annotation", "tn.tt_eval_backward", 30, 10, tid=2),
              _event("user_annotation", "tn.wait:dims_copy", 31, 2, tid=2),
              _event("cuda_runtime", "cudaStreamSynchronize", 32, 1, tid=2),
              _event("cuda_runtime", "cudaStreamSynchronize", 55, 1),
              _event("user_annotation", "tn.getitem", 12, 8, tid=2)]
    # the step on the window's thread alone: 50 - 10 us
    assert _read("step_host_ms.train", events, calls=1) == pytest.approx(40e-3)
    assert _read("getitem_host_ms.train", events, calls=1) == pytest.approx(8e-3)
    assert _read("syncs_per_call.train", events, calls=1) == 2


def test_spans_are_clipped_to_the_window_and_spans_open_at_its_close_left_out():
    events = [_event("user_annotation", "pb:window", 100, 100),
              _event("user_annotation", "tn.optimize:step", 50, 70),  # began before: 20 us in
              _event("user_annotation", "tn.optimize:step", 130, 40),
              _event("user_annotation", "tn.wait:loss_read", 160, 10),
              # the next step, open as the window closes (its loss closes the window and
              # synchronizes), and one after the window
              _event("user_annotation", "tn.optimize:step", 180, 60),
              _event("user_annotation", "tn.optimize:step", 250, 10),
              _event("cuda_runtime", "cudaStreamSynchronize", 90, 1),  # in a step, before
              _event("cuda_runtime", "cudaStreamSynchronize", 110, 1),
              _event("cuda_runtime", "cudaStreamSynchronize", 165, 1),
              _event("cuda_runtime", "cudaDeviceSynchronize", 195, 1),
              _event("cuda_runtime", "cudaStreamSynchronize", 255, 1)]  # in a step, after
    assert _read("step_host_ms.train", events, calls=2) == pytest.approx((20 + 30) * 1e-3 / 2)
    assert _read("syncs_per_call.train", events, calls=2) == 1


def test_launches_are_matched_by_correlation():
    events = [WINDOW,
              _event("user_annotation", "tn.tt_eval", 10, 40),
              _event("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
              _event("cuda_runtime", "cudaMemcpyAsync", 20, 2, correlation=2),
              _event("cuda_runtime", "cudaMemsetAsync", 30, 2, correlation=3),
              _event("cuda_driver", "cuLaunchKernel", 35, 2, correlation=4),
              _event("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=5),  # outside tn.*
              _event("cuda_runtime", "cudaLaunchKernel", 40, 2, correlation=6, tid=2),
              _event("cuda_runtime", "cudaGetDevice", 41, 1),  # launches nothing
              _event("kernel", "k1", 15, 10, tid=7, pid=0, correlation=1),
              _event("gpu_memcpy", "Memcpy HtoD", 25, 2, tid=7, pid=0, correlation=2),
              _event("gpu_memset", "Memset", 32, 1, tid=7, pid=0, correlation=3),
              _event("kernel", "k4", 38, 5, tid=7, pid=0, correlation=4),
              _event("kernel", "k5", 62, 5, tid=7, pid=0, correlation=5),
              _event("kernel", "k6", 45, 5, tid=7, pid=0, correlation=6)]
    assert _read("launches_per_call.eval", events) == pytest.approx(4 / 2)


def test_a_launch_whose_work_ran_after_the_window_is_not_counted():
    events = [WINDOW,
              _event("user_annotation", "tn.tt_eval", 90, 10),
              _event("cuda_runtime", "cudaLaunchKernel", 92, 2, correlation=1),
              _event("cuda_runtime", "cudaLaunchKernel", 95, 2, correlation=2),
              _event("kernel", "k1", 96, 2, tid=7, pid=0, correlation=1),
              _event("kernel", "k2", 101, 2, tid=7, pid=0, correlation=2)]
    assert _read("launches_per_call.eval", events, calls=1) == 1


def test_syncs_are_counted_by_name_and_thread():
    events = [WINDOW,
              _event("user_annotation", "tn.round_tt", 10, 40),
              _event("user_annotation", "tn.wait:sketch_copy", 20, 5),
              _event("cuda_runtime", "cudaMemcpyAsync", 21, 1),
              _event("cuda_runtime", "cudaStreamSynchronize", 22, 2),
              _event("cuda_runtime", "cudaMemcpy", 30, 1),
              _event("cuda_driver", "cuCtxSynchronize", 32, 1),
              _event("cuda_runtime", "cudaEventSynchronize_ptsz", 34, 1),
              _event("cuda_runtime", "cudaLaunchKernel", 36, 1),
              _event("cuda_runtime", "cudaDeviceSynchronize", 40, 1, tid=3),  # not in tn.*
              _event("cuda_runtime", "cudaDeviceSynchronize", 70, 1)]  # the caller's own
    assert _read("syncs_per_call.round", events, calls=1) == 4
    assert _read("syncs_per_call.eval", events, calls=4) == 1


@pytest.mark.parametrize("name,sync", [
    ("cudaStreamSynchronize", True), ("cudaMemcpy", True), ("cudaMemcpy_ptds", True),
    ("cuMemcpyDtoH_v2", True), ("cuStreamSynchronize", True), ("cudaMemcpyAsync", False),
    ("cuMemcpyDtoHAsync_v2", False), ("cudaStreamWaitEvent", False),
    ("cudaLaunchKernel", False)])
def test_which_calls_synchronise(name, sync):
    assert is_sync(name) == sync


@pytest.mark.parametrize("metric", HOST_MS + COUNTS)
def test_nothing_is_read_without_a_trace_or_without_the_spans(metric):
    assert _read(metric, None) is None
    no_spans = [WINDOW, _event("user_annotation", "pb:tt_eval_kernel:0", 10, 20),
                _event("cuda_runtime", "cudaStreamSynchronize", 15, 1),
                _event("cuda_runtime", "cudaLaunchKernel", 16, 1, correlation=1),
                _event("kernel", "k", 17, 5, tid=7, pid=0, correlation=1)]
    assert _read(metric, no_spans) is None
    assert _read(metric, no_spans + [_event("user_annotation", "tn.other", 50, 5)],
                 calls=0) is None
