"""Propositional logic, weighted automata and mask-Tensor keys in the port
(tntorch_tpu_torch/logic.py, automata.py, Tensor.__getitem__) against the
JAX package, in float64 on the CPU: formulas and automata entry by entry,
predicates and symbol lists equal, accepted strings equal, and tensors
indexed by a mask to 1e-12."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop

KW = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _dense(x):
    if hasattr(x, "cores"):
        x = x.full()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-12):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1)


# name: formula of (symbols, package); the same in both packages
FORMULAS = {
    "x_or_not_x": lambda s, p: s[0] | ~s[0],
    "x_and_not_x": lambda s, p: s[0] & ~s[0],
    "x_and_y": lambda s, p: s[0] & s[1],
    "xor": lambda s, p: s[1] ^ s[3],
    "de_morgan": lambda s, p: ~(~s[0] & ~s[2]),
    "one_of": lambda s, p: p.one(4, which=[1, 2], **({} if p is jtn else KW)),
    "all_but_x": lambda s, p: p.all(4, which=[1, 2, 3], **({} if p is jtn else KW)) & ~s[0],
    "only_y": lambda s, p: p.only(s[1] | (s[1] & s[2] & ~s[2])),
}


@pytest.fixture(scope="module")
def jax_formulas():
    s = jtn.symbols(4)
    return {name: f(s, jtn) for name, f in FORMULAS.items()}


@pytest.mark.parametrize("name", FORMULAS)
def test_formulas_and_predicates_match_jax(name, jax_formulas):
    t = FORMULAS[name](tn.symbols(4, **KW), tn)
    jt = jax_formulas[name]
    _close(t, jt)
    assert tn.is_tautology(t) == jtn.is_tautology(jt)
    assert tn.is_contradiction(t) == jtn.is_contradiction(jt)
    assert tn.is_satisfiable(t) == jtn.is_satisfiable(jt)
    assert tn.relevant_symbols(t) == jtn.relevant_symbols(jt)
    assert tn.irrelevant_symbols(t) == jtn.irrelevant_symbols(jt)
    _close(tn.only(t), jtn.only(jt))
    for other in ("x_and_y", "de_morgan"):
        u, ju = FORMULAS[other](tn.symbols(4, **KW), tn), jax_formulas[other]
        assert tn.implies(t, u) == jtn.implies(jt, ju)
        assert tn.equiv(t, u) == jtn.equiv(jt, ju)


def test_constructors_match_jax():
    for name in ("true", "false", "all", "none", "any", "one"):
        _close(getattr(tn, name)(3, **KW), getattr(jtn, name)(3))
    for name in ("all", "none", "any", "one"):
        _close(getattr(tn, name)(4, which=[0, 2], **KW), getattr(jtn, name)(4, which=[0, 2]))
    for name in ("presence", "absence"):
        _close(getattr(tn, name)(4, [1, 3], **KW), getattr(jtn, name)(4, [1, 3]))
    assert len(tn.symbols(5, **KW)) == 5
    x, y, z = tn.symbols(3, **KW)
    assert tn.equiv(x | y, ~(~x & ~y)) and tn.implies(x & y, x) and not tn.implies(x, x & y)
    assert float(tn.sum(tn.any(3, **KW))) == 7 and float(tn.sum(tn.only(x))) == 1
    # the constructors land on the card by default, as the package's data does
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tn.true(3)


@pytest.mark.parametrize("N", [2, 3, 5])
def test_automata_match_jax(N):
    for w in range(N + 1):
        _close(tn.weight_mask(N, w, **KW), jtn.weight_mask(N, w))
    _close(tn.weight_mask(N, [0, N], **KW), jtn.weight_mask(N, [0, N]))
    _close(tn.weight_one_hot(N, **KW).cores[-1], jtn.weight_one_hot(N).cores[-1])
    _close(tn.weight_one_hot(N, **KW), jtn.weight_one_hot(N))
    for nsymbols in (2, 3):
        _close(tn.weight(N, nsymbols, **KW), jtn.weight(N, nsymbols))
        _close(tn.length(N, nsymbols, **KW), jtn.length(N, nsymbols))
        _close(tn.weight_mask(N, 2, nsymbols=nsymbols, **KW),
               jtn.weight_mask(N, 2, nsymbols=nsymbols))
    x = tn.weight(N, 3, **KW).numpy()
    for s in itertools.product(range(3), repeat=N):
        assert x[s] == sum(s)


def test_accepted_inputs_match_jax():
    for N, w in ((3, 1), (4, 2), (5, 0), (5, 3)):
        got = tn.accepted_inputs(tn.weight_mask(N, w, **KW))
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtn.accepted_inputs(
            jtn.weight_mask(N, w))))
    # a string s appears t[s] times
    t = tn.weight_mask(3, 1, **KW) * 2 + tn.all(3, **KW)
    np.testing.assert_array_equal(tn.accepted_inputs(t).numpy(), np.asarray(
        jtn.accepted_inputs(jtn.weight_mask(3, 1) * 2 + jtn.all(3))))
    f = ~tn.symbols(4, **KW)[2] & tn.symbols(4, **KW)[0]
    jf = ~jtn.symbols(4)[2] & jtn.symbols(4)[0]
    np.testing.assert_array_equal(tn.accepted_inputs(f).numpy(),
                                  np.asarray(jtn.accepted_inputs(jf)))
    # a batch: one array per sample
    singles = [tn.weight_mask(4, 1, **KW), tn.weight_mask(4, 2, **KW)]
    out = tn.accepted_inputs(tn.stack(singles))
    assert isinstance(out, list) and len(out) == 2
    for b, single in enumerate(singles):
        np.testing.assert_array_equal(out[b].numpy(), tn.accepted_inputs(single).numpy())


def _tt_pair(seed, shape=(5, 4, 6, 3), batch=0):
    rng = np.random.default_rng(seed)
    ranks = [1, 3, 3, 3, 1]
    b = (batch,) if batch else ()
    cores = [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]
    return (interop.tensor_from_arrays(cores, batch=bool(batch), device="cpu"),
            jtn.Tensor([jnp.asarray(c) for c in cores], batch=bool(batch)))


def test_mask_tensor_keys_match_jax():
    """A mask with one accepted string indexes by ``idxs``: on a tensor's
    default annotations symbol 1 is every coordinate but 0; on an ANOVA
    tensor it picks a term."""
    t, jt = _tt_pair(1)
    s, js = tn.symbols(4, **KW), jtn.symbols(4)
    keys = [(lambda s, p: s[0] & ~s[1] & s[2] & ~s[3]),
            (lambda s, p: p.none(4, **({} if p is jtn else KW))),
            (lambda s, p: p.all(4, **({} if p is jtn else KW)))]
    for key in keys:
        _close(t[key(s, tn)], jt[key(js, jtn)])
    a, ja = tn.anova_decomposition(t), jtn.anova_decomposition(jt)
    for key in keys:
        _close(a[key(s, tn)], ja[key(js, jtn)])
    # a batch keeps every sample (the JAX package fails here: it reads the
    # batch axis as a mode), as each sample alone gives
    b, _ = _tt_pair(2, batch=3)
    got = b[keys[0](s, tn)]
    for i in range(3):
        _close(got[i], b[i][keys[0](s, tn)])
    with pytest.raises(ValueError, match="exactly 1 accepting string"):
        t[s[0]]
    with pytest.raises(ValueError, match="Batch mask"):
        t[tn.stack([keys[1](s, tn)] * 2)]
