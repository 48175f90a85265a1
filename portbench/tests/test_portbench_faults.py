"""A run with the timed path broken underneath comes out not correct: each
cell at a small size on the CPU, past the look for a card, with one fault
planted in the port for each fault the cell can have (one card: no
exchange between cards to leave out)."""

import functools

import pytest
import torch

from portbench.bench import run_cell
from portbench.tests.test_portbench_harness import BENCH, small

ROUND = ["round.randgram-b128-f64"]


def run(cell):
    result, checks = run_cell(BENCH, cell, 3_000_000_023, 0.2, False, device="cpu",
                              overrides=small(cell))
    return result


def wrap(monkeypatch, module, attr, make):
    """Replaces ``module.attr`` by ``make(original)``."""
    import importlib

    mod = importlib.import_module(module)
    original = getattr(mod, attr)
    monkeypatch.setattr(mod, attr, functools.wraps(original)(make(original)))


@pytest.mark.parametrize("cell", ROUND)
def test_round_state_left_unchanged(cell, monkeypatch):
    import tntorch_tpu_torch as tn

    monkeypatch.setattr(tn.Tensor, "round_tt", lambda self, *a, **k: None)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", ROUND)
def test_round_half_the_batch_left_out(cell, monkeypatch):
    def make(original):
        def half(cores, rmax, *a, **k):
            B = cores[0].shape[0]
            out = original([c[:B // 2] for c in cores], rmax, *a, **k)
            return [torch.cat([c, c[:B - B // 2]]) for c in out]
        return half

    wrap(monkeypatch, "tntorch_tpu_torch.ops.rounding", "round_tt_gram_batched", make)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", ROUND)
@pytest.mark.parametrize("members", [slice(None), slice(-1, None)], ids=["every", "one"])
def test_round_answers_altered_where_produced(cell, members, monkeypatch):
    """Every member of each call altered, or one with the rest as the sweep
    made them."""
    def make(original):
        def altered(*a, **k):
            out = original(*a, **k)
            last = out[-1].clone()
            last[members] *= 1.01
            return out[:-1] + [last]
        return altered

    wrap(monkeypatch, "tntorch_tpu_torch.ops.rounding", "round_tt_gram_batched", make)
    assert not run(cell)["correct"]


def test_eval_half_the_batch_left_out(monkeypatch):
    def make(original):
        def half(cores, X, *a, **k):
            B = X.shape[0]
            out = original(cores, X[:B // 2].contiguous(), *a, **k)
            return torch.cat([out, torch.zeros(B - B // 2, dtype=out.dtype)])
        return half

    wrap(monkeypatch, "tntorch_tpu_torch.ops.tt_eval", "tt_eval_kernel", make)
    assert not run("eval.uniform-1m-f32")["correct"]


@pytest.mark.parametrize("cell", ["eval.uniform-1m-f32", "train.mse-1m-f32"])
def test_a_value_altered_where_produced(cell, monkeypatch):
    def make(original):
        def altered(*a, **k):
            out = original(*a, **k).clone()
            out[0] += 1.0
            return out
        return altered

    wrap(monkeypatch, "tntorch_tpu_torch.ops.tt_eval", "tt_eval_kernel", make)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("after", [0, 5], ids=["from_the_start", "once_warm"])
def test_train_state_left_unchanged(after, monkeypatch):
    """Adam's steps after the first ``after`` return the state unchanged."""
    original = torch.optim.Adam.step
    taken = []

    def step(self, closure=None):
        taken.append(1)
        return original(self, closure) if len(taken) <= after else None

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    assert not run("train.mse-1m-f32")["correct"]


def test_train_half_the_batch_left_out(monkeypatch):
    """The gradient of half of the samples, the mean taken over them."""
    def make(original):
        def half(cores, X, g, *a, **k):
            g = g.clone()
            g[: g.shape[0] // 2] *= 2
            g[g.shape[0] // 2:] = 0
            return original(cores, X, g, *a, **k)
        return half

    wrap(monkeypatch, "tntorch_tpu_torch.ops.tt_eval", "tt_eval_backward_kernel", make)
    assert not run("train.mse-1m-f32")["correct"]
