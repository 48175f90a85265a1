"""ANOVA and Sobol indices in the port (tntorch_tpu_torch/anova.py) against
the JAX package (tntorch_tpu/anova.py), on the same NumPy cores in float64
on the CPU, to 1e-10 relative: a 4-mode TT, the same with Tucker factors,
a hybrid CP-TT and a batch of 3, with uniform and given marginals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop

TOL = 1e-10
SHAPE = (5, 6, 4, 5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _pair(kind, seed=0):
    rng = np.random.default_rng(seed)
    b = (3,) if kind == "batch" else ()
    ranks = [1, 3, 3, 3, 1]
    cores = [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(SHAPE)]
    Us = None
    if kind == "tucker":
        Us = [rng.standard_normal((s + 1, s)) if n % 2 == 0 else None
              for n, s in enumerate(SHAPE)]
    if kind == "cp":
        cores[1] = rng.standard_normal((SHAPE[1], 3))
    t = interop.tensor_from_arrays(cores, Us=Us, batch=bool(b), device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores],
                    Us=None if Us is None else [None if U is None else jnp.asarray(U)
                                                for U in Us], batch=bool(b))
    return t, jt


def _dense(x):
    if hasattr(x, "cores"):
        x = x.full()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * max(np.linalg.norm(want), 1e-300)


KINDS = ["tt", "tucker", "cp", "batch"]


def _marginals(t, given):
    if not given:
        return None, None
    off = 1 if t.batch else 0
    rng = np.random.default_rng(5)
    m = [rng.random(s) + 0.1 for s in t.shape[off:]]
    return [torch.from_numpy(x) for x in m], [jnp.asarray(x) for x in m]


# The same formulas in both packages: each a function of the symbol list
# and the package
MASKS = (lambda s, p: p.only(s[0]), lambda s, p: p.only(s[1] | s[2]), lambda s, p: s[0],
         lambda s, p: s[1] & ~s[3], lambda s, p: s[0] | s[1] | s[2] | s[3])


def _symbols(package, t):
    if package is tn:
        return tn.symbols(t.dim(), device="cpu", dtype=t.dtype)
    return jtn.symbols(t.dim())


@pytest.mark.parametrize("given", [False, True], ids=["uniform", "marginals"])
@pytest.mark.parametrize("kind", KINDS)
def test_anova_decomposition_and_undo_match_jax(kind, given):
    t, jt = _pair(kind)
    m, jm = _marginals(t, given)
    a, ja = tn.anova_decomposition(t, marginals=m), jtn.anova_decomposition(jt, marginals=jm)
    assert a.shape == tuple(ja.shape)
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(a.idxs, ja.idxs))
    _close(a, ja)
    _close(tn.undo_anova_decomposition(a), t)
    _close(tn.undo_anova_decomposition(a), jtn.undo_anova_decomposition(ja))


@pytest.mark.parametrize("keepdim", [True, False], ids=["keepdim", "dropdim"])
@pytest.mark.parametrize("kind", KINDS)
def test_truncate_anova_matches_jax(kind, keepdim):
    t, jt = _pair(kind, seed=1)
    s, js = _symbols(tn, t), _symbols(jtn, jt)
    for f in (lambda s, p: p.only(s[0] | s[2]), lambda s, p: p.only(s[1])):
        got = tn.truncate_anova(t, f(s, tn), keepdim=keepdim)
        want = jtn.truncate_anova(jt, f(js, jtn), keepdim=keepdim)
        _close(got, want)


# Each kind once, half of them with given marginals (a JAX run compiles per
# shape and op: every case costs seconds)
CASES = pytest.mark.parametrize("kind, given", [("tt", False), ("tucker", True), ("cp", False),
                                                ("batch", True)])


@CASES
def test_sobol_indices_match_jax(kind, given):
    t, jt = _pair(kind, seed=2)
    m, jm = _marginals(t, given)
    s, js = _symbols(tn, t), _symbols(jtn, jt)
    for f in MASKS:
        got = tn.sobol(t, f(s, tn), marginals=m)
        want = jtn.sobol(jt, f(js, jtn), marginals=jm)
        _close(got, want)
    _close(tn.sobol(t, s[0], marginals=m, normalize=False),
           jtn.sobol(jt, js[0], marginals=jm, normalize=False))


@CASES
def test_mean_dimension_and_distribution_match_jax(kind, given):
    t, jt = _pair(kind, seed=3)
    m, jm = _marginals(t, given)
    s, js = _symbols(tn, t), _symbols(jtn, jt)
    _close(tn.mean_dimension(t, marginals=m), jtn.mean_dimension(jt, marginals=jm))
    _close(tn.mean_dimension(t, mask=s[0] | s[1], marginals=m),
           jtn.mean_dimension(jt, mask=js[0] | js[1], marginals=jm))
    _close(tn.dimension_distribution(t, marginals=m),
           jtn.dimension_distribution(jt, marginals=jm))
    _close(tn.dimension_distribution(t, mask=s[2], order=3, marginals=m),
           jtn.dimension_distribution(jt, mask=js[2], order=3, marginals=jm))


def test_batch_sobol_is_per_sample():
    """Each sample of a batch gives what the sample alone gives (the JAX
    package's own check, tests/test_batch_lift.py)."""
    t, _ = _pair("batch", seed=4)
    s = tn.symbols(4, device="cpu", dtype=t.dtype)
    sb = tn.sobol(t, tn.only(s[0]))
    md = tn.mean_dimension(t)
    dd = tn.dimension_distribution(t)
    for b in range(3):
        _close(sb[b], tn.sobol(t[b], tn.only(s[0])))
        _close(md[b], tn.mean_dimension(t[b]))
        _close(dd[b], tn.dimension_distribution(t[b]))


def test_sobol_of_an_additive_function_is_exact():
    """x + 2y + z/2 on a grid: the first-order indices are 1 : 4 : 1/4 over
    their sum, the mean dimension 1 (tests/test_anova.py's check)."""
    x = torch.linspace(0, 1, 8, dtype=torch.float64)
    ones = torch.ones(8, dtype=torch.float64)
    xs = [tn.Tensor([(x if m == n else ones)[None, :, None] for m in range(3)])
          for n in range(3)]
    t = xs[0] + 2 * xs[1] + 0.5 * xs[2]
    s = tn.symbols(3, device="cpu", dtype=torch.float64)
    got = [float(tn.sobol(t, tn.only(x))) for x in s]
    assert np.allclose(got, np.array([1, 4, 0.25]) / 5.25, rtol=0, atol=1e-12)
    assert abs(float(tn.mean_dimension(t)) - 1) < 1e-12
    assert abs(float(tn.dimension_distribution(t)[0]) - 1) < 1e-12
