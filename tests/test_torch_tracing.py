"""The port's spans (`tntorch_tpu_torch.utils.trace_annotation`): with no
profiler running a span is one shared null context and no
``record_function`` is made; under ``torch.profiler`` the documented spans
of the evaluation, training and rounding paths appear with their
documented nesting, and the spans taken out never do. The ``cuda`` test
runs the card's paths: the dispatch's and the backward's spans (the latter
on autograd's device thread), and every host-device synchronisation inside
a ``tn.*`` span inside a ``tn.wait:*`` span. A synchronisation is what
``portbench.portspans.is_sync`` names, the one definition the
``syncs_per_call.*`` metrics count by.

This file imports no JAX: on the card, run it with
``python -m pytest tests/test_torch_tracing.py -m cuda --noconftest``."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.portspans import is_sync
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import utils
from tntorch_tpu_torch.ops import tt_eval as te

REMOVED = ("tn.shift_mode", "tn.round_tucker:batch_kernel", "tn.round_tucker:eps_kernel",
           "tn.round_tt:eps_sweep", "tn.round_tt:gram_to_svd_route")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _tt(shape, rank, device="cpu", dtype=torch.float64, batch=(), seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    ranks = [1] + [rank] * (len(shape) - 1) + [1]
    return [torch.randn(batch + (ranks[k], s, ranks[k + 1]), generator=g, device=device,
                        dtype=dtype) / ranks[k] ** 0.5 for k, s in enumerate(shape)]


def _coords(shape, P, device="cpu", seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.stack([torch.randint(0, s, (P,), generator=g, device=device) for s in shape], 1)


def _eval(device="cpu", shape=(5, 6, 7, 4), rank=3, P=50):
    cores, X = _tt(shape, rank, device), _coords(shape, P, device)
    return lambda: tn.tt_eval(cores, X)


def _getitem(device="cpu", shape=(5, 6, 7, 4), rank=3, P=50):
    t, X = tn.Tensor(_tt(shape, rank, device)), _coords(shape, P, device)
    return lambda: t[X].full()


def _optimize(device="cpu", shape=(5, 6, 7, 4), rank=3, P=50, dtype=torch.float64):
    X = _coords(shape, P, device)
    y = torch.randn(P, generator=torch.Generator(device=device).manual_seed(2), device=device,
                    dtype=dtype)

    def run():  # two steps: max_iter + 1
        t = tn.Tensor(_tt(shape, rank, device, dtype), requires_grad=True)
        tn.optimize([t], lambda t: ((t[X].full() - y) ** 2).mean(), tol=None, max_iter=1,
                    verbose=False)
    return run


def _round(device="cpu", shape=(6, 5, 7, 4), rank=8, B=3, rmax=4):
    cores = _tt(shape, rank, device, batch=(B,))

    def run():
        t = tn.Tensor([c.clone() for c in cores], batch=True)
        t.round_tt(rmax=rmax, algorithm="randgram")
        return t.cores
    return run


PATHS = {"tt_eval": _eval, "getitem": _getitem, "optimize": _optimize, "round_tt": _round}
# Each path's spans on the CPU: name -> (its parent span, its count)
NESTING = {
    "tt_eval": {"tn.tt_eval": (None, 1)},
    "getitem": {"tn.getitem": (None, 1), "tn.tt_eval": ("tn.getitem", 1)},
    "optimize": {"tn.optimize:step": (None, 2), "tn.optimize:loss": ("tn.optimize:step", 2),
                 "tn.optimize:backward": ("tn.optimize:step", 2),
                 "tn.optimize:update": ("tn.optimize:step", 2),
                 "tn.wait:loss_read": ("tn.optimize:step", 2),
                 "tn.getitem": ("tn.optimize:loss", 2), "tn.tt_eval": ("tn.getitem", 2)},
    "round_tt": {"tn.round_tt": (None, 1), "tn.round_tt:gram": ("tn.round_tt", 1),
                 "tn.round_tt:right_grams": ("tn.round_tt:gram", 1),
                 "tn.round_tt:edge": ("tn.round_tt:gram", 3),
                 "tn.round_tt:sketch": ("tn.round_tt:edge", 3),
                 "tn.wait:sketch_copy": ("tn.round_tt:sketch", 3)},
}


def _profiled(run, tmp_path, cuda=False):
    """The complete events of ``run()``'s profile: (start, end, name, cat,
    thread), in microseconds."""
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=activities) as prof:
        run()
        if cuda:
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""),
             e.get("cat", ""), (e.get("pid"), e.get("tid")))
            for e in events if e.get("ph") == "X"]


def _spans(events):
    return [e for e in events if e[3] == "user_annotation" and e[2].startswith("tn.")]


def _inside(t, thread, spans):
    """Whether time ``t`` on ``thread`` lies in one of ``spans``."""
    return any(s <= t <= e and th == thread for s, e, _, _, th in spans)


def test_no_profiler_gives_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert utils.trace_annotation("tn.tt_eval") is utils.trace_annotation("tn.round_tt")
    with utils.trace_annotation("tn.tt_eval") as entered:
        assert entered is None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_span_makes_a_record_function_without_a_profiler(path, monkeypatch):
    made = []

    def counted(name):
        made.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    PATHS[path]()()
    assert made == []


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_appear_with_their_nesting(path, tmp_path):
    spans = _spans(_profiled(PATHS[path](), tmp_path))
    want = NESTING[path]
    assert sorted({n for _, _, n, _, _ in spans}) == sorted(want)
    for name, (parent, count) in want.items():
        mine = [s for s in spans if s[2] == name]
        assert len(mine) == count, (name, len(mine))
        if parent is not None:
            outer = [s for s in spans if s[2] == parent]
            for s, e, _, _, thread in mine:
                assert any(ps <= s and e <= pe and pt == thread for ps, pe, _, _, pt in outer), (
                    f"{name} outside {parent}")


def _tucker_batch():
    t = tn.Tensor(_tt((5, 6, 4), 3, batch=(2,)), batch=True)
    t.round_tucker(rmax=2)


def _tucker():
    tn.Tensor(_tt((5, 6, 4), 3)).round_tucker(1e-3)


def _shift():
    tn.shift_mode(tn.Tensor(_tt((5, 6, 4), 3)), 0, 2)


def _eps_sweep():
    tn.Tensor(_tt((5, 6, 4), 3)).round_tt(1e-3)


def _gram_to_svd():  # float32 'gram' under the 'highest' policy takes the SVD sweep
    tn.Tensor(_tt((5, 6, 4), 3, dtype=torch.float32)).round_tt(rmax=2, algorithm="gram")


REMOVED_PATHS = {"round_tucker batch": _tucker_batch, "round_tucker": _tucker,
                 "shift_mode": _shift, "round_tt eps": _eps_sweep,
                 "round_tt gram f32": _gram_to_svd}


@pytest.mark.parametrize("path", sorted(REMOVED_PATHS))
def test_the_removed_spans_never_appear(path, tmp_path):
    names = {n for _, _, n, _, _ in _spans(_profiled(REMOVED_PATHS[path], tmp_path))}
    assert not names & set(REMOVED), names
    assert ("tn.round_tt" in names) == path.startswith("round_tt")


@pytest.mark.cuda
def test_on_the_card_the_dispatch_spans_record_and_every_sync_is_a_wait(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    shape, rank, P = (64, 64, 64, 64), 64, 1 << 17
    assert te._grouped((1,) + (rank,) * 3 + (1,), shape, P, 4)
    runs = [
        _eval("cuda", shape, rank, P),  # the grouped forward
        _eval("cuda", shape, 8, 4096),  # the per-sample forward
        _optimize("cuda", shape, rank, P, torch.float32),  # both grouped kernels
        _optimize("cuda", shape, 8, 4096, torch.float32),  # both per-sample kernels
        _round("cuda", (32, 32, 32, 32), 16, 8, 8),
    ]

    def all_runs():
        for run in runs:
            run()

    all_runs()  # warm: the build, the caches, the allocator
    torch.cuda.synchronize()
    events = _profiled(all_runs, tmp_path, cuda=True)
    spans = _spans(events)
    names = {n for _, _, n, _, _ in spans}
    for name in ("tn.tt_eval", "tn.tt_eval:operands", "tn.tt_eval:launch", "tn.wait:flag",
                 "tn.wait:dims_copy", "tn.tt_eval_backward", "tn.tt_eval_backward:operands",
                 "tn.tt_eval_backward:launch", "tn.optimize:step", "tn.wait:loss_read",
                 "tn.round_tt:sketch", "tn.wait:sketch_copy"):
        assert name in names, name
    # The backward runs on autograd's device thread, and its spans record there
    main = {th for _, _, n, _, th in spans if n == "tn.optimize:step"}
    assert {th for _, _, n, _, th in spans if n == "tn.tt_eval_backward"} - main
    waits = [s for s in spans if s[2].startswith("tn.wait:")]
    syncs = [e for e in events if e[3] in ("cuda_runtime", "cuda_driver") and is_sync(e[2])]
    assert syncs
    for s, _, name, _, thread in syncs:
        if _inside(s, thread, spans):
            assert _inside(s, thread, waits), f"{name} at {s} outside every tn.wait:* span"
    for s, e, name, _, thread in waits:  # each wait holds a synchronisation
        assert any(s <= t <= e and th == thread for t, _, _, _, th in syncs), name
