"""The bf16 Gram rounding of the port (tntorch_tpu_torch/ops/rounding.py,
``round_tt_gram_bf16``, reached by ``set_policy('bf16')``) against the JAX
package's ``_round_tt_gram_bf16_jit`` (vmapped for a batch), on the CPU.

Both packages round the cores to bfloat16 and multiply the upcast operands
in float32. The inputs are bfloat16-representable, so the first products
are exact on both sides; then each package sums in its own order, and a
bfloat16 re-rounding of T = C G or of a new core can flip a tie where two
sums differ in their last bit. So the dense reconstructions are held to
2e-2 relative of JAX's (bfloat16 keeps 8 bits: 2^-8 = 3.9e-3 per
rounding, a few roundings deep), and each error against the unrounded
tensor to 1.1x JAX's. The randomized edges take JAX's sketch, patched into
the port's ``_sketch`` as tests/test_torch_rounding.py does.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu.ops import rounding as jr
from tntorch_tpu_torch import tensor as ttensor
from tntorch_tpu_torch.ops import rounding as tr

SHAPE, RANKS, RMAX = (8, 9, 10, 8), (10, 12, 10), 5
CLOSE, ERROR_FACTOR = 2e-2, 1.1


@pytest.fixture(autouse=True)
def _one_thread_jax_sketch(monkeypatch):
    torch.set_num_threads(1)  # six test workers share the cores

    own = tr._sketch

    def jax_sketch(n, r, dtype, device):
        if dtype.is_complex:
            return own(n, r, dtype, device)
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), n), r)
        jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
        return torch.from_numpy(np.array(jax.random.normal(key, (n, r), dtype=jdt))).to(device)

    monkeypatch.setattr(tr, "_sketch", jax_sketch)


@pytest.fixture
def bf16_policy():
    tn.set_policy("bf16")
    jtn.set_policy("bf16")
    yield
    tn.set_policy("highest")
    jtn.set_policy("highest")


def _cores(seed, batch=0):
    """Random TT cores in float64 whose values are bfloat16 numbers."""
    rng = np.random.default_rng(seed)
    ranks = [1] + list(RANKS) + [1]
    b = (batch,) if batch else ()
    cores = [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) / np.sqrt(ranks[n])
             for n, s in enumerate(SHAPE)]
    return [torch.from_numpy(c).to(torch.bfloat16).double().numpy() for c in cores]


def _full(cores, batch):
    t = tn.Tensor([torch.as_tensor(np.array(c)) for c in cores], batch=batch)
    return t.full().numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check(got, want, cores, batch):
    dense, d_got, d_want = (_full(c, batch) for c in (cores, got, want))
    assert _rel(d_got, d_want) <= CLOSE
    assert _rel(d_got, dense) <= ERROR_FACTOR * _rel(d_want, dense)


@pytest.mark.parametrize("solver", ["eigh", "rand"])
@pytest.mark.parametrize("batch", [0, 3], ids=["single", "batch3"])
def test_bf16_body_matches_jax(solver, batch):
    cores = _cores(1 + batch, batch)
    if batch:
        got = tr.round_tt_gram_bf16([torch.from_numpy(c) for c in cores], RMAX, solver)
        want = jax.vmap(lambda *cs: tuple(jr.round_tt_gram(cs, RMAX, precision="bf16",
                                                           edge_solver=solver)))(
            *[jnp.asarray(c) for c in cores])
    else:
        got = tr.round_tt_gram([torch.from_numpy(c) for c in cores], RMAX, precision="bf16",
                               edge_solver=solver)
        want = jr.round_tt_gram(tuple(jnp.asarray(c) for c in cores), RMAX, precision="bf16",
                                edge_solver=solver)
    assert [c.dtype for c in got] == [torch.float64] * len(SHAPE)
    assert [tuple(c.shape) for c in got] == [tuple(np.shape(c)) for c in want]
    _check(got, want, cores, bool(batch))


@pytest.mark.parametrize("batch", [0, 3], ids=["single", "batch3"])
def test_bf16_policy_routes_round_tt(batch, bf16_policy, monkeypatch):
    cores = _cores(10 + batch, batch)
    calls = []
    body = tr.round_tt_gram_bf16

    def spy(*args, **kwargs):
        calls.append(args[2] if len(args) > 2 else kwargs.get("edge_solver"))
        return body(*args, **kwargs)

    monkeypatch.setattr(tr, "round_tt_gram_bf16", spy)
    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=bool(batch))
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=bool(batch))
    t.round_tt(rmax=RMAX, algorithm="gram")
    jt.round_tt(rmax=RMAX, algorithm="gram")
    assert calls == ["rand"]  # the performance policies take randomized edges
    assert t.dtype == torch.float64
    _check(t.cores, jt.cores, cores, bool(batch))


def test_float32_warns_once_and_complex_keeps_its_dtype(bf16_policy, monkeypatch, caplog):
    monkeypatch.setattr(ttensor, "_f32_gram_warned", False)
    cores = [torch.from_numpy(c).float() for c in _cores(20, 2)]
    with caplog.at_level(logging.WARNING, logger="tntorch_tpu_torch"):
        for _ in range(2):
            t = tn.Tensor(list(cores), batch=True)
            t.round_tt(rmax=RMAX, algorithm="randgram")
            assert t.dtype == torch.float32
    assert sum("float32 cores" in r.getMessage() for r in caplog.records) == 1
    # complex cores have no bfloat16 form: the policy's 'rand' edges in
    # their own dtype, as the JAX package routes them
    rng = np.random.default_rng(21)
    cc = [torch.from_numpy(c + 1j * rng.standard_normal(c.shape)) for c in _cores(22)]
    got = tr.round_tt_gram(cc, RMAX, precision="bf16")
    want = tr.round_tt_gram(cc, RMAX, precision="highest", edge_solver="rand")
    assert all(g.dtype == torch.complex128 and torch.equal(g, w) for g, w in zip(got, want))
