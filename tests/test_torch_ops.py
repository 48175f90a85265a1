"""The port's elementwise family (tntorch_tpu_torch/ops/__init__.py) and
``Tensor`` ``/`` and ``**`` against the JAX package and the dense truth, in
float64 on the CPU.

- The 20 unary ops, seeded (``tn.exp(t, seed=0)``), against the JAX
  package's on a 4 x 5 x 4 grid with ``eps=1e-12``: both crosses reach the
  grid's full ranks, where the interpolation is exact whatever rows the
  pivoting picks, so ranks, sample counts and iterations must be equal and
  the reconstructions within 1e-8 (measured ~6e-16). At ranks short of
  full, the pivots past the function's numerical rank are roundoff and the
  two packages' runs drift apart by up to the budget eps (ROADMAP queue 3).
- Every op, and ``/``, ``**``, ``cumprod``, the binary family, ``skew`` and
  ``kurtosis`` (which draw no seed, in either package), against the same
  function of the dense tensor on a 5 x 6 x 4 x 5 grid: relative error
  <= 1e-4, the JAX package's own limit (tests/test_cross.py:44-59).
- ``cumsum`` is exact: against the JAX package's to 1e-12, on TT and Tucker
  modes and a batch.

The inputs map into every op's domain: values in [0.15, 0.85].

Every cross here takes both packages' default ``fuse="auto"``, which on the
CPU is the eager sweep in each; the fused sweep that "auto" runs on the
card is held to the JAX package's fused chunks in test_torch_cross_fused.py
(and ``tn.exp`` on the card by chip_smoke.py's phase 18).
"""

import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as st
import torch

import jax.numpy as jnp

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn

TRUTH_TOL = 1e-4  # the JAX package's own limit for cross-based ops
JAX_TOL = 1e-8
EXACT_TOL = 1e-12

UNARY = {
    "abs": np.abs, "acos": np.arccos, "asin": np.arcsin, "atan": np.arctan, "cos": np.cos,
    "cosh": np.cosh, "erf": sp.erf, "erfinv": sp.erfinv, "exp": np.exp, "log": np.log,
    "log10": np.log10, "log2": np.log2, "reciprocal": lambda x: 1 / x,
    "rsqrt": lambda x: 1 / np.sqrt(x), "sigmoid": sp.expit, "sin": np.sin, "sinh": np.sinh,
    "sqrt": np.sqrt, "tan": np.tan, "tanh": np.tanh,
}


@pytest.fixture(autouse=True)
def _one_thread_float64():
    # The JAX side runs float64 (tests/conftest.py: jax_enable_x64)
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _cores(seed, shape, rank=2, batch=None):
    rng = np.random.default_rng(seed)
    ranks = [1] + [rank] * (len(shape) - 1) + [1]
    b = () if batch is None else (batch,)
    return [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _pair(cores, batch=False):
    """The same values in [0.15, 0.85] in both packages: 0.5 + 0.35 t / max|t|."""
    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=batch)
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=batch)
    scale = 0.35 / np.abs(t.numpy()).max()
    return 0.5 + scale * t, 0.5 + scale * jt


_SMALL = _cores(3, (4, 5, 4))
_GRID = _cores(4, (5, 6, 4, 5))


@pytest.fixture(scope="module")
def jax_unary():
    _, jt = _pair(_SMALL)
    return {name: getattr(jtn, name)(jt, seed=0, eps=1e-12, return_info=True)
            for name in UNARY}


@pytest.mark.parametrize("name", UNARY)
def test_seeded_unary_op_matches_jax(name, jax_unary):
    t, _ = _pair(_SMALL)
    got, info = getattr(tn, name)(t, seed=0, eps=1e-12, return_info=True)
    want, jinfo = jax_unary[name]
    assert [int(r) for r in info["Rs"]] == [int(r) for r in jinfo["Rs"]]
    assert info["nsamples"] == jinfo["nsamples"]
    assert len(info["val_epss"]) == len(jinfo["val_epss"])
    a, b = got.numpy(), np.asarray(want.full())
    assert np.linalg.norm(a - b) <= JAX_TOL * np.linalg.norm(b)


def _rel(got, want):
    got = got.numpy() if isinstance(got, tn.Tensor) else np.asarray(got)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("name", UNARY)
def test_unary_op_against_dense(name):
    t, _ = _pair(_GRID)
    out = getattr(tn, name)(t)
    assert out.device.type == "cpu" and not out.batch
    assert _rel(out, UNARY[name](t.numpy())) <= TRUTH_TOL


def _binary_cases():
    t, _ = _pair(_GRID)
    t2, _ = _pair(_cores(5, (5, 6, 4, 5)))
    x, y = t.numpy(), t2.numpy()
    return {
        "div_tensor": (lambda: t / t2, x / y),
        "rdiv_scalar": (lambda: 2.0 / t, 2.0 / x),
        "pow_scalar": (lambda: t ** 2, x ** 2),
        "rpow_scalar": (lambda: 2.0 ** t, 2.0 ** x),
        "pow_tensor": (lambda: t ** t2, x ** y),
        "add": (lambda: tn.add(t, t2), x + y),
        "atan2": (lambda: tn.atan2(t, t2), np.arctan2(x, y)),
        "div": (lambda: tn.div(t, t2), x / y),
        "mul": (lambda: tn.mul(t, t2), x * y),
        "pow": (lambda: tn.pow(t, t2), x ** y),
        "cumprod_mode_1": (lambda: tn.cumprod(t, 1), np.cumprod(x, 1)),
        "cumprod_modes_0_3": (lambda: tn.cumprod(t, [0, 3]), np.cumprod(np.cumprod(x, 0), 3)),
    }


@pytest.mark.parametrize("case", list(_binary_cases()))
def test_binary_ops_and_operators_against_dense(case):
    compute, want = _binary_cases()[case]
    assert _rel(compute(), want) <= TRUTH_TOL


def test_skew_and_kurtosis_against_dense():
    t, _ = _pair(_GRID)
    x = t.numpy().ravel()
    for got, want in ((tn.skew(t), st.skew(x)), (tn.kurtosis(t), st.kurtosis(x)),
                      (tn.kurtosis(t, fisher=False), st.kurtosis(x, fisher=False))):
        assert abs(float(got) - want) <= TRUTH_TOL * abs(want)


def test_batch_op_runs_per_sample():
    t, _ = _pair(_cores(6, (4, 5, 4), batch=2), batch=True)
    out = tn.exp(t)
    assert out.batch and out.shape == t.shape
    assert _rel(out, np.exp(t.numpy())) <= TRUTH_TOL


@pytest.mark.parametrize("dim", [None, 1, [0, 2]])
def test_cumsum_matches_jax(dim):
    rng = np.random.default_rng(7)
    cores = _cores(8, (4, 5, 6), rank=3)
    cores[1] = rng.standard_normal((3, 2, 3))
    Us = [None, rng.standard_normal((5, 2)), None]  # a Tucker mode
    t = tn.Tensor([torch.from_numpy(c) for c in cores], Us=[None if U is None else
                                                           torch.from_numpy(U) for U in Us])
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], Us=[None if U is None else jnp.asarray(U)
                                                        for U in Us])
    got, want = tn.cumsum(t, dim), jtn.cumsum(jt, dim)
    assert got.Us[1] is not None  # the factor took the sum
    assert np.abs(got.numpy() - np.asarray(want.full())).max() <= EXACT_TOL
    x = t.numpy()
    for n in range(3) if dim is None else np.atleast_1d(dim):
        x = np.cumsum(x, n)
    assert np.abs(got.numpy() - x).max() <= EXACT_TOL
    assert np.abs(t.numpy() - np.asarray(jt.full())).max() <= EXACT_TOL  # input left alone


def test_cumsum_of_a_batch_matches_jax():
    cores = _cores(9, (4, 5, 3), batch=3)
    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=True)
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=True)
    got, want = tn.cumsum(t, 2), jtn.cumsum(jt, 2)
    assert np.abs(got.numpy() - np.asarray(want.full())).max() <= EXACT_TOL
