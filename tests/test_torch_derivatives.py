"""Finite-difference calculus in the port (tntorch_tpu_torch/derivatives.py)
against the JAX package (tntorch_tpu/derivatives.py), on the same NumPy
cores in float64 on the CPU, to 1e-10 relative: 8^3 fields as TTs, with a
Tucker factor, a CP factor and in a batch of 2; every function with
``bounds`` and ``periodic``; central differences against NumPy's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop

TOL = 1e-10
SHAPE = (8, 8, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _pair(kind, seed=0):
    rng = np.random.default_rng(seed)
    b = (2,) if kind == "batch" else ()
    ranks = [1, 3, 3, 1]
    cores = [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(SHAPE)]
    Us = None
    if kind == "tucker":
        cores[1] = rng.standard_normal((3, 5, 3))
        Us = [None, rng.standard_normal((8, 5)), None]
    if kind == "cp":
        cores[1] = rng.standard_normal((8, 3))
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
KIND = pytest.mark.parametrize("kind", KINDS)


@KIND
def test_partial_matches_jax(kind):
    t, jt = _pair(kind)
    for kw in (dict(dim=0), dict(dim=1, order=2), dict(dim=-1, bounds=[0.0, 2.0]),
               dict(dim=[0, 2], bounds=[[0, 1], [-1, 3]]), dict(dim=1, periodic=True),
               dict(dim=[1, 2], order=2, periodic=[True, False])):
        _close(tn.partial(t, **kw), jtn.partial(jt, **kw))
    with pytest.raises(ValueError, match="one bounds pair per dim"):
        tn.partial(t, [0, 1], bounds=[[0, 1]])


@KIND
def test_gradient_divergence_curl_laplacian_match_jax(kind):
    t, jt = _pair(kind, seed=1)
    for kw in (dict(), dict(bounds=[0, 1]), dict(bounds=[[0, 1], [0, 2], [-1, 1]])):
        g, jg = tn.gradient(t, **kw), jtn.gradient(jt, **kw)
        assert len(g) == len(jg) == 3
        for x, y in zip(g, jg):
            _close(x, y)
    _close(tn.gradient(t, dim=1), jtn.gradient(jt, dim=1))
    g, jg = tn.gradient(t), jtn.gradient(jt)
    # a field that is not a gradient, so that its curl is not roundoff
    (u, ju), (v, jv) = _pair(kind, seed=10), _pair(kind, seed=11)
    for kw in (dict(), dict(bounds=[0, 2]), dict(bounds=[[0, 1], [0, 2], [0, 3]])):
        div, jdiv = tn.divergence(g, **kw), jtn.divergence(jg, **kw)
        assert div.ranks_tt.tolist() == jdiv.ranks_tt.tolist()
        _close(div, jdiv)
        for x, y in zip(tn.curl([t, u, v], **kw), jtn.curl([jt, ju, jv], **kw)):
            _close(x, y)
        _close(tn.laplacian(t, **kw), jtn.laplacian(jt, **kw))
    # the differences commute: div grad is the Laplacian, curl grad vanishes
    _close(tn.divergence(g), tn.laplacian(t), 1e-13)
    for c in tn.curl(g):
        assert float(tn.norm(c).max()) <= 1e-8 * float(tn.norm(t).max())


def _central(x, axis, step):
    """Central differences with linear extrapolation at both ends, in NumPy
    (tests/test_derivatives.py's reference)."""
    xp = np.concatenate([np.take(x, [0], axis), x, np.take(x, [-1], axis)], axis)
    first = np.take(xp, [0], axis) - (np.take(xp, [2], axis) - np.take(xp, [1], axis))
    last = np.take(xp, [-1], axis) + (np.take(xp, [-2], axis) - np.take(xp, [-3], axis))
    xp = np.concatenate([first, np.take(xp, range(1, xp.shape[axis] - 1), axis), last], axis)
    return (np.take(xp, range(2, xp.shape[axis]), axis)
            - np.take(xp, range(0, xp.shape[axis] - 2), axis)) / step


def test_derivatives_match_numpy_differences():
    t, _ = _pair("batch", seed=2)
    x = _dense(t)
    step = SHAPE[0] / (SHAPE[0] + 1) * 2
    g = tn.gradient(t)
    for n in range(3):
        _close(g[n], _central(x, n + 1, step))
    lap = sum(_central(_central(x, n + 1, step), n + 1, step) for n in range(3))
    _close(tn.laplacian(t), lap)
    _close(tn.partial(t, 0, periodic=True),
           (np.roll(x, -1, axis=1) - np.roll(x, 1, axis=1)) / step)


@KIND
def test_partialset_matches_jax(kind):
    t, jt = _pair(kind, seed=3)
    for kw in (dict(), dict(order=[1, 2]), dict(order=2, bounds=[[0, 1]] * 3)):
        got, want = tn.partialset(t, **kw), jtn.partialset(jt, **kw)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(got.idxs, want.idxs))
        _close(got, want)
    mask = tn.absence(3, [2], device="cpu", dtype=torch.float64)
    _close(tn.partialset(t, mask=mask), jtn.partialset(jt, mask=jtn.absence(3, [2])))


@KIND
def test_active_subspace_and_dgsm_match_jax(kind):
    t, jt = _pair(kind, seed=4)
    m = [np.linspace(1, 2, s) for s in SHAPE]
    for kw, jkw in ((dict(), dict()), (dict(bounds=[[0, 1]] * 3, marginals=m),
                                       dict(bounds=[[0, 1]] * 3,
                                            marginals=[jnp.asarray(x) for x in m]))):
        w, v = tn.active_subspace(t, **kw)
        jw, jv = jtn.active_subspace(jt, **jkw)
        _close(w, jw)
        # eigenvectors up to sign: their projectors
        v, jv = _dense(v), np.asarray(jv)
        for k in range(3):
            p = v[..., :, k:k + 1] * v[..., None, :, k]
            jp = jv[..., :, k:k + 1] * jv[..., None, :, k]
            _close(p, jp, 1e-8)
        _close(tn.dgsm(t, **kw), jtn.dgsm(jt, **jkw))


def test_curl_rejects_fields_that_are_not_3d():
    fields = [tn.randn(4, 4, 4, 4, ranks_tt=2, device="cpu") for _ in range(3)]
    with pytest.raises(ValueError, match="3-D vector field"):
        tn.curl(fields)
    with pytest.raises(ValueError, match="3-D vector field"):
        tn.curl(fields[:2])
    with pytest.raises(ValueError, match="N tensors"):
        tn.divergence(fields)


def test_gradients_flow_through_partial():
    """The updates are out of place, so autograd reaches the cores: the
    gradient of sum(partial(t, 0)) by the cores against a finite difference
    in one core entry."""
    t, _ = _pair("tt", seed=5)
    t = tn.Tensor([c.clone() for c in t.cores], requires_grad=True)
    loss = tn.sum(tn.partial(t, 0, order=2) * tn.partial(t, 1))
    loss.backward()
    grad = t.cores[0].grad[0, 3, 1]
    h = 1e-6
    plus = [c.detach().clone() for c in t.cores]
    plus[0][0, 3, 1] += h
    minus = [c.detach().clone() for c in t.cores]
    minus[0][0, 3, 1] -= h

    def f(cores):
        u = tn.Tensor(cores)
        return float(tn.sum(tn.partial(u, 0, order=2) * tn.partial(u, 1)))

    assert abs(float(grad) - (f(plus) - f(minus)) / (2 * h)) <= 1e-6 * max(abs(float(grad)), 1)
