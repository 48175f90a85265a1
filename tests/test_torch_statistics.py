"""The port's ttm, squeeze/unsqueeze (tntorch_tpu_torch/tools.py), its
statistics (metrics.py: sum, mean, var, std, rmse, r_squared) and the
Tensor conveniences against the JAX package's, on the same NumPy inputs in
float64, batch and not, with and without Tucker factors. Values agree to
1e-10 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop

TOL = 1e-10
SHAPE = (6, 7, 8, 5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _pair(seed, batch=0, tucker=False, shape=SHAPE, ranks=(3, 4, 3)):
    """The same tensor in both packages: a TT, or with factors on modes 0, 3."""
    rng = np.random.default_rng(seed)
    ranks = [1, *ranks, 1]
    b = (batch,) if batch else ()
    S = [4, None, None, 3] if tucker else [None] * len(shape)
    inner = [s if r is None else r for s, r in zip(shape, S)]
    cores = [rng.standard_normal(b + (ranks[n], inner[n], ranks[n + 1])) + 0.5
             for n in range(len(shape))]
    Us = [None if r is None else rng.standard_normal(b + (s, r)) for s, r in zip(shape, S)]
    t = interop.tensor_from_arrays(cores, Us=Us, batch=bool(batch), device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores],
                    Us=[None if U is None else jnp.asarray(U) for U in Us], batch=bool(batch))
    return t, jt


def _np(x):
    if isinstance(x, (tn.Tensor, jtn.Tensor)):
        return np.asarray(x.numpy())
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


CASES = pytest.mark.parametrize("batch,tucker", [(0, False), (0, True), (3, False), (3, True)],
                                ids=["tt", "tucker", "batch-tt", "batch-tucker"])


@CASES
def test_ttm_matches_jax(batch, tucker):
    t, jt = _pair(1, batch, tucker)
    rng = np.random.default_rng(1)
    # in a batch a matrix is one per sample (B, J, I): a 2-D factor there
    # is one vector per sample
    b = (batch,) if batch else ()
    M0, M2 = rng.standard_normal(b + (4, 6)), rng.standard_normal(b + (8, 3))
    v = rng.standard_normal(7)
    for U, dim, kw in (([M0], [0], {}), ([M0, v], [0, 1], {}), (M2, 2, dict(transpose=True)),
                       ([v], [-3], {})):
        jU = [jnp.asarray(u) for u in U] if isinstance(U, list) else jnp.asarray(U)
        got, want = tn.ttm(t, U, dim, **kw), jtn.ttm(jt, jU, dim, **kw)
        assert got.shape == tuple(want.shape)
        assert [x is None for x in got.Us] == [x is None for x in want.Us]
        _close(got, want)
    if batch:  # one weight vector per sample
        W = rng.standard_normal((batch, 5))
        _close(tn.ttm(t, [W], [3]), jtn.ttm(jt, [jnp.asarray(W)], [3]))
    # numpy factors join the tensor's device; torch ones work too
    _close(tn.ttm(t, torch.from_numpy(M0), 0), jtn.ttm(jt, jnp.asarray(M0), 0))


@CASES
def test_squeeze_and_unsqueeze_match_jax(batch, tucker):
    t, jt = _pair(2, batch, tucker)
    for dims in ([0], [2, 4], [1, 2]):
        got, want = tn.unsqueeze(t, dims), jtn.unsqueeze(jt, dims)
        assert got.shape == tuple(want.shape)
        _close(got, want)
        _close(tn.squeeze(got), jtn.squeeze(want))
        _close(tn.squeeze(got, dim=dims[-1]), jtn.squeeze(want, dim=dims[-1]))
    with pytest.raises(ValueError, match="not all 1"):
        tn.squeeze(t, dim=0)


@CASES
def test_sum_mean_var_std_match_jax(batch, tucker):
    t, jt = _pair(3, batch, tucker)
    _close(tn.sum(t), jtn.sum(jt))
    _close(t.mean(), jt.mean())
    _close(t.var(), jt.var())
    _close(t.std(), jt.std())
    for dim in ([1, 3], 2, [-1]):
        _close(tn.sum(t, dim=dim), jtn.sum(jt, dim=dim))
        _close(tn.mean(t, dim=dim), jtn.mean(jt, dim=dim))
        _close(tn.sum(t, dim=dim, keepdim=True), jtn.sum(jt, dim=dim, keepdim=True))
    # against the dense tensor
    dense = t.numpy()
    axes = tuple(range(1 if batch else 0, dense.ndim))
    _close(tn.sum(t), dense.sum(axis=axes))
    _close(t.var(), dense.var(axis=axes))
    _close(tn.mean(t, dim=[1, 3]), dense.mean(axis=(2, 4) if batch else (1, 3)))
    assert (tn.sum(t).shape == (batch,)) if batch else (tn.sum(t).ndim == 0)


@CASES
def test_marginals_match_jax(batch, tucker):
    t, jt = _pair(4, batch, tucker)
    rng = np.random.default_rng(4)
    margs = [rng.uniform(0.1, 1, s) for s in SHAPE]
    jmargs = [jnp.asarray(m) for m in margs]
    _close(tn.mean(t, marginals=margs), jtn.mean(jt, marginals=jmargs))
    _close(tn.mean(t, dim=[0, 2], marginals=margs[:1]), jtn.mean(jt, dim=[0, 2],
                                                                  marginals=jmargs[:1]))
    _close(tn.var(t, marginals=margs), jtn.var(jt, marginals=jmargs))
    _close(t.var(marginals=margs), jtn.var(jt, marginals=jmargs))
    if batch:  # per-sample marginals, (B, I)
        pm = [rng.uniform(0.1, 1, (batch, s)) for s in SHAPE]
        _close(tn.mean(t, marginals=pm), jtn.mean(jt, marginals=[jnp.asarray(m) for m in pm]))
    # the expectation under product weights, densely
    w = [m / m.sum() for m in margs]
    dense = t.numpy()
    want = np.einsum("...ijkl,i,j,k,l->...", dense, *w)
    _close(tn.mean(t, marginals=margs), want)
    with pytest.raises(ValueError, match="one marginal per mode"):
        tn.var(t, marginals=margs[:2])


@CASES
def test_rmse_and_r_squared_match_jax(batch, tucker):
    a, ja = _pair(5, batch, tucker)
    b, jb = _pair(6, batch, tucker)
    b, jb = a + 0.1 * b, ja + 0.1 * jb
    for f, jf in ((tn.rmse, jtn.rmse), (tn.r_squared, jtn.r_squared)):
        _close(f(a, b), jf(ja, jb))
        _close(f(a, b.full()), jf(ja, jb.full()))  # one side dense
        _close(f(a.full(), b.full()), jf(ja.full(), jb.full()))


def test_boolean_operators_match_jax():
    rng = np.random.default_rng(7)
    masks = [(rng.uniform(size=(4, 5, 3)) > 0.5).astype(np.float64) for _ in range(2)]
    x, y = (tn.Tensor(torch.from_numpy(m)) for m in masks)
    jx, jy = (jtn.Tensor(jnp.asarray(m)) for m in masks)
    a, b = masks
    for got, want, dense in ((~x, ~jx, 1 - a), (x & y, jx & jy, a * b),
                             (x | y, jx | jy, np.maximum(a, b)),
                             (x ^ y, jx ^ jy, (a != b).astype(float))):
        _close(got, want)
        _close(got, dense)


def test_tensor_conveniences_match_jax():
    t, jt = _pair(8, 0, True)
    bt, jbt = _pair(8, 3, True)
    assert t.numel() == jt.numel() and bt.numel() == jbt.numel()
    assert t.numcoef() == jt.numcoef() and bt.numcoef() == jbt.numcoef()
    assert t.size() == tuple(jt.size()) and bt.b() == jbt.b() == 3
    with pytest.raises(ValueError):
        t.b()
    dense = t.torch()
    assert isinstance(dense, torch.Tensor) and dense.device == t.device
    _close(dense, jt.full())
    moved = t.clone().to("cpu")
    assert moved.Us[0].device.type == "cpu"
    _close(moved, t)
    for name in ("sum", "mean", "var", "std"):
        _close(getattr(bt, name)(), getattr(jbt, name)())


def test_tools_outside_the_slice_raise():
    # The tools this test once held to their stubs are ported: each now runs
    # and meets the JAX package's (tests/test_torch_tools.py holds them to
    # it at large); what raises is the misuse that raises there too
    t, jt = _pair(9, tucker=True)
    calls = {"cat": lambda m, x: m.cat([x, x], dim=1), "transpose": lambda m, x: m.transpose(x),
             "flip": lambda m, x: m.flip(x, 2), "unbind": lambda m, x: m.unbind(x, 0)[1],
             "mask": lambda m, x: m.mask(x, x), "pad": lambda m, x: m.pad(x, 9, dim=2),
             "shift_mode": lambda m, x: m.shift_mode(x.clone(), 1, 2, eps=1e-12)}
    for name, call in calls.items():
        _close(call(tn.tools, t), call(jtn.tools, jt))
    with pytest.raises(ValueError):
        tn.tools.cat([t, tn.tools.pad(t, 9, dim=2)], dim=1)
    with pytest.raises(ValueError):
        tn.tools.shift_mode(t.clone(), 1, 1, eps="lossy")


@pytest.mark.cuda
def test_statistics_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t, jt = _pair(10, 0, True)
    g = t.clone().to("cuda")
    rng = np.random.default_rng(10)
    margs = [rng.uniform(0.1, 1, s) for s in SHAPE]  # numpy: joins the card
    assert tn.mean(g, marginals=margs).device.type == "cuda"
    _close(tn.var(g).cpu(), jt.var())
    _close(tn.sum(g, dim=[1, 2]).numpy(), jtn.sum(jt, dim=[1, 2]).numpy())
