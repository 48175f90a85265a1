"""The port's tools (tntorch_tpu_torch/tools.py), ``Tensor.set_factors`` and
the partial ``dot`` against the JAX package's (tntorch_tpu/tools.py), on the
same NumPy cores in float64 on the CPU.

Dense reconstructions are compared, never cores, within 1e-10 relative (in
norm): the algebra is the same, and only the order of the sums differs.
``generate_basis`` is computed by both in NumPy/SciPy: equal to 1e-14.

Two draws cannot be the JAX package's: ``sample``'s uniforms and ``hash``'s
weights. The tests patch JAX's numbers into the port's helpers
(`_sample_uniforms`, `_hash_weights`) and ask for JAX's rows exactly and
JAX's hash within 1e-12; the port's own draws are held to what they are
for: a hash that does not depend on the representation (1e-12 relative),
and samples whose marginals match the tensor's PMF (5 sigma).

``shift_mode`` runs one eager loop of SVD swaps in the port; it is held to
the JAX package's jitted one-program path (non-batch) and to its eager
loop (batch), ranks equal and values within 1e-10. ``convolve`` is held,
as in tests/test_tools.py, to ``scipy.signal.convolve`` within 1e-6 in
all three modes (three TT-crosses at eps 1e-9 on complex tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import tools

TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    yield
    torch.set_num_threads(threads)


def _arrays(seed, shape=(4, 5, 6), rank=2, tucker=None, batch=None):
    """Random cores and factors (``tucker``: the factors' rank, on every
    other mode), as NumPy."""
    rng = np.random.default_rng(seed)
    N = len(shape)
    b = () if batch is None else (batch,)
    ranks = [1] + [rank] * (N - 1) + [1]
    inner = [s if tucker is None or n % 2 else tucker for n, s in enumerate(shape)]
    cores = [rng.standard_normal(b + (ranks[n], inner[n], ranks[n + 1])) for n in range(N)]
    Us = [None if inner[n] == s else rng.standard_normal(b + (s, inner[n]))
          for n, s in enumerate(shape)]
    return cores, Us


def _pair(seed, batch=None, **kw):
    cores, Us = _arrays(seed, batch=batch, **kw)
    b = batch is not None
    t = tn.Tensor([torch.from_numpy(c) for c in cores],
                  Us=[None if U is None else torch.from_numpy(U) for U in Us], batch=b)
    jt = jtn.Tensor([jnp.asarray(c) for c in cores],
                    Us=[None if U is None else jnp.asarray(U) for U in Us], batch=b)
    return t, jt


def _dense(x):
    if isinstance(x, tn.Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, "cores") else x)


def _close(got, want, tol=TOL):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


TOOL_CASES = {
    "cat_mode_1": (dict(tucker=3), lambda m, t: m.cat([t, m.flip(t, 1)], dim=1)),
    "cat_three_negative_dim": (dict(batch=2), lambda m, t: m.cat(t, t, t, dim=-1)),
    "transpose": (dict(tucker=3), lambda m, t: m.transpose(t)),
    "transpose_batch": (dict(batch=3), lambda m, t: m.transpose(t)),
    "flip": (dict(tucker=3), lambda m, t: m.flip(t, [0, 2])),
    "flip_batch": (dict(batch=2), lambda m, t: m.flip(t, -1)),
    "unbind": (dict(tucker=3), lambda m, t: m.unbind(t, 2)[4]),
    "unbind_batch": (dict(batch=2), lambda m, t: m.unbind(t, 1)[3]),
    "pad": (dict(tucker=3), lambda m, t: m.pad(t, [6, 8], dim=[0, 1], fill_value=2.0)),
    "pad_batch": (dict(batch=2), lambda m, t: m.pad(t, 9, dim=-1, fill_value=-1.0)),
    "pad_every_mode": (dict(), lambda m, t: m.pad(t, 7, fill_value=0.5)),
    "partial_dot_both_sides": (dict(tucker=3), lambda m, t: m.dot(t, m.flip(t, 0), k=1)),
    "partial_dot_batch": (dict(batch=2), lambda m, t: m.dot(t, t, k=2)),
    "partial_dot_left_only": (dict(), lambda m, t: m.dot(t, m.unbind(t, 2)[0], k=2)),
}


@pytest.mark.parametrize("case", sorted(TOOL_CASES))
def test_plain_tools_match_jax(case):
    kw, op = TOOL_CASES[case]
    t, jt = _pair(sorted(TOOL_CASES).index(case), **kw)
    got, want = op(tn, t), op(jtn, jt)
    assert got.batch == want.batch
    _close(got, want)


def test_transpose_keeps_idxs_and_dot_leaves_both_trails():
    t, jt = _pair(40, tucker=3)
    t.idxs = [np.arange(4) + 10, np.arange(5) + 20, np.arange(6) + 30]
    jt.idxs = list(t.idxs)
    got, want = tn.transpose(t), jtn.transpose(jt)
    assert all(np.array_equal(a, b) for a, b in zip(got.idxs, want.idxs))
    assert got.Us[0] is t.Us[2] and got.shape == (6, 5, 4)
    # the partial dot leaving modes on both sides: t1's trail reversed, then t2's
    d = tn.dot(t, t, k=1).numpy()
    x = t.numpy()
    _close(d, np.einsum("iab,icd->bacd", x, x))


@pytest.mark.parametrize("batch", [None, 3])
def test_unfoldings_match_jax(batch):
    rng = np.random.default_rng(41)
    x = rng.standard_normal((3, 4, 5, 6))
    for n in range(3):
        _close(tn.unfolding(torch.from_numpy(x), n, batch=batch is not None),
               jtn.unfolding(jnp.asarray(x), n, batch=batch is not None))
    core = rng.standard_normal((2, 3, 4, 5))
    for fn in ("left_unfolding", "right_unfolding"):
        _close(getattr(tn, fn)(torch.from_numpy(core), batch=True),
               getattr(jtn, fn)(jnp.asarray(core), batch=True))
        _close(getattr(tn, fn)(torch.from_numpy(core[0])), getattr(jtn, fn)(jnp.asarray(core[0])))


@pytest.mark.parametrize("batch", [None, 2])
def test_mask_matches_jax(batch):
    t, jt = _pair(42, batch=batch, shape=(4, 5, 3))
    # the mask: built by the JAX package (set entries of a zeros tensor),
    # carried across as arrays
    jm = jtn.zeros(4, 5, 3)
    jm[1, 2, 0] = 1.0
    jm[3, :, 2] = 2.0
    m = tn.Tensor([torch.from_numpy(np.asarray(c)) for c in jm.cores],
                  Us=[None if U is None else torch.from_numpy(np.asarray(U)) for U in jm.Us])
    _close(tn.mask(t, m), jtn.mask(jt, jm))
    # idxs-aligned: t's annotations pick the mask's entries (clamped past its end)
    off = [np.arange(batch)] if batch else []
    for tt in (t, jt):
        tt.idxs = off + [np.array([3, 2, 1, 0]), np.array([0, 1, 2, 3, 9]), np.arange(3)]
    _close(tn.mask(t, m), jtn.mask(jt, jm))


@pytest.mark.parametrize("name", ["dct", "legendre", "chebyshev", "hermite", "identity"])
def test_generate_basis_and_set_factors_match_jax(name):
    for orthonormal in (False, True):
        got = tn.generate_basis(name, (8, 5), orthonormal=orthonormal, device="cpu",
                                dtype=torch.float64)
        want = np.asarray(jtn.generate_basis(name, (8, 5), orthonormal=orthonormal))
        assert got.shape == (8, 5) and np.abs(got.numpy() - want).max() <= 1e-14
    t, jt = _pair(43, shape=(6, 5, 4), rank=2)
    t.requires_grad = jt.requires_grad = True
    t.set_factors(name, dim=[0, 2])
    jt.set_factors(name, dim=[0, 2])
    _close(t, jt)
    assert t.frozen_Us == jt.frozen_Us == {0, 2}
    assert tn.dof(t) == jtn.dof(jt)
    t.set_factors(name, dim=[2], requires_grad=True)  # a factor already there keeps its shape
    assert t.frozen_Us == {0} and t.Us[2].shape == (4, 4)


def test_set_factors_on_a_batch_and_optimize_leaves_frozen_factors_alone():
    t = tn.rand([3, 6, 5], ranks_tt=2, ranks_tucker=3, batch=True, device="cpu",
                dtype=torch.float64, requires_grad=True, generator=torch.Generator().manual_seed(0))
    t.set_factors("legendre", dim=[0])
    U0 = t.Us[0].clone()
    assert t.Us[0].shape == (3, 6, 3)
    assert torch.equal(t.Us[0][1], tn.generate_basis("legendre", (6, 3), device="cpu",
                                                      dtype=torch.float64))
    tn.optimize([t], lambda t: (t.full() ** 2).mean(), max_iter=3, tol=None, verbose=False)
    assert torch.equal(t.Us[0], U0) and not t.Us[0].requires_grad


def _jax_uniforms(seed, N, P):
    keys = jax.random.split(jax.random.key(seed), N)
    return [torch.from_numpy(np.asarray(jax.random.uniform(keys[mu], (P, 1),
                                                           dtype=jnp.float64)))
            for mu in range(N)]


def test_sample_with_jax_uniforms_gives_jax_rows(monkeypatch):
    t, jt = _pair(44, tucker=3, shape=(5, 6, 7))
    P = 400
    monkeypatch.setattr(tools, "_sample_uniforms",
                        lambda N, P, dtype, device, seed=None: _jax_uniforms(seed, N, P))
    got = tn.sample(t, P=P, seed=3)
    want = np.asarray(jtn.sample(jt, P=P, seed=3))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def test_sample_own_draws_follow_the_pmf():
    probs = np.array([0.1, 0.6, 0.3])
    x = np.einsum("i,j,k->ijk", probs, probs[::-1], probs)
    t = tn.Tensor(torch.from_numpy(x))
    P = 20000
    Xs = tn.sample(t, P=P, seed=0).numpy()
    assert np.array_equal(Xs, tn.sample(t, P=P, seed=0).numpy())  # seeded
    for col, p in enumerate((probs, probs[::-1], probs)):
        emp = np.bincount(Xs[:, col], minlength=3) / P
        assert np.all(np.abs(emp - p) <= 5 * np.sqrt(p * (1 - p) / P))


def _jax_weights(shape):
    key, out = jax.random.key(0), []
    for sh in shape:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.asarray(jax.random.uniform(sub, (sh, 1),
                                                                  dtype=jnp.float64))))
    return out


@pytest.mark.parametrize("batch", [None, 2])
def test_hash_with_jax_weights_and_its_own(monkeypatch, batch):
    t, jt = _pair(45, batch=batch, tucker=3)
    own = tn.hash(t)
    # representation independence: a rounded copy, and the TT without factors
    r = t.clone()
    r.round_tt(1e-14)
    for other in (r, t.tt()):
        assert np.allclose(tn.hash(other).numpy(), own.numpy(), rtol=1e-12, atol=0)
    monkeypatch.setattr(tools, "_hash_weights", _jax_weights)
    got, want = tn.hash(t).numpy(), np.asarray(jtn.hash(jt))
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_reduce_matches_jax():
    import operator

    pairs = [_pair(50 + i, shape=(4, 5), rank=2) for i in range(9)]
    got = tn.reduce([p[0] for p in pairs], operator.add, eps=1e-12)
    want = jtn.reduce([p[1] for p in pairs], operator.add, eps=1e-12)
    assert list(got.ranks_tt) == list(want.ranks_tt)
    _close(got, want)


SHIFT_CASES = [(0, 3, 1e-10), (1, 2, "same"), (3, -2, 1e-3), (2, -2, "same")]


@pytest.mark.parametrize("n,shift,eps", SHIFT_CASES)
def test_shift_mode_matches_jax_jitted_path(n, shift, eps):
    x = np.random.default_rng(17).standard_normal((5, 6, 7, 8))
    t = tn.Tensor(torch.from_numpy(x), ranks_tt=6)
    jt = jtn.Tensor(jnp.asarray(x), ranks_tt=6)
    assert tn.shift_mode(t, n, shift, eps=eps) is t
    jtn.shift_mode(jt, n, shift, eps=eps)
    assert list(t.ranks_tt) == list(jt.ranks_tt)
    _close(t, jt)


@pytest.mark.parametrize("layout", ["batch", "tucker"])
def test_shift_mode_matches_jax_on_batch_and_tucker(layout):
    kw = dict(batch=2) if layout == "batch" else dict(tucker=3)
    t, jt = _pair(46, shape=(4, 5, 6, 3), rank=3, **kw)
    shifted = {}
    for eps in (1e-12, "same"):
        a, ja = t.clone(), jt.clone()
        tn.shift_mode(a, 0, 2, eps=eps)
        jtn.shift_mode(ja, 0, 2, eps=eps)
        assert list(a.ranks_tt) == list(ja.ranks_tt)
        _close(a, ja)
        shifted[eps] = a
    perm = (0, 2, 3, 1, 4) if layout == "batch" else (1, 2, 0, 3)
    _close(shifted[1e-12], np.transpose(t.numpy(), perm))  # eps 1e-12 moves the mode exactly
    with pytest.raises(ValueError):
        tn.shift_mode(t, 0, 1, eps="lossy")


def test_convolve_matches_scipy():
    from scipy.signal import convolve as spconv

    g = torch.Generator().manual_seed(0)
    a = tn.rand([8, 9], ranks_tt=2, dtype=torch.float64, device="cpu", generator=g)
    b = tn.rand([4, 5], ranks_tt=2, dtype=torch.float64, device="cpu", generator=g)
    for mode in ("full", "same", "valid"):
        c = tn.convolve(a, b, mode=mode, eps=1e-9, verbose=False, seed=0)
        assert c.dtype == torch.complex128
        gt = spconv(a.numpy(), b.numpy(), mode=mode)
        assert c.shape == gt.shape
        assert np.linalg.norm(c.numpy() - gt) / np.linalg.norm(gt) <= 1e-6, mode
