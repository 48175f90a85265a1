"""The port's decomposition of dense data (tntorch_tpu_torch/ops/
decomposition.py, Tensor(data, ranks_tt=, ranks_tucker=, eps=)) and the
BASELINE configurations 1 and 2 at a reduced size, against the dense
tensor and against the JAX package's, on the same NumPy inputs in float64.

'gram' TT-SVD is deterministic: the same ranks and values to 1e-10
relative. 'randomized' draws a Gaussian sketch per unfolding; the port
cannot replay JAX's keys, so the JAX draws are monkeypatched in for parity,
and the port's own sketch is held to the Gram error. Its parity tolerance
is 1e-8: the power iteration and the eigh of B B^T square the spectrum, so
roundoff moves the rank-r subspace by ~1e-16 (s_1/s_r)^2; on the Hilbert
tensor at ranks [2, 5, 3] the JAX package's own result moves by 2.6e-10
when the input is perturbed by 1e-16 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu.ops import decomposition as jdec
from tntorch_tpu_torch import interop
from tntorch_tpu_torch.ops import decomposition as dec

TOL = 1e-10
RAND_TOL = 1e-8  # see the module docstring


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def _hilbert(n, N=4, batch=0):
    """1 / (i + j + k + l + 1), BASELINE config 2's tensor; a batch scales
    each sample's offset."""
    grid = np.indices((n,) * N).sum(axis=0)
    if batch:
        return np.stack([1.0 / (grid + 1 + s) for s in range(batch)])
    return 1.0 / (grid + 1.0)


def _jax_keys(key, N):
    """The per-unfolding subkeys of the JAX package's randomized TT-SVD."""
    subs = []
    for _ in range(N - 1):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _jax_omega(monkeypatch, key, N):
    subs = _jax_keys(key, N)

    def omega(k, n, p, dtype, device, generator):
        draw = jax.random.normal(subs[k], (n, p), dtype=jnp.float64)
        return torch.from_numpy(np.array(draw)).to(device=device, dtype=dtype)

    monkeypatch.setattr(dec, "_omega", omega)


def test_cap_ranks_matches_jax():
    for shape, r in (((6, 7, 8, 5), 3), ((2, 3, 40, 2), 100), ((4, 4, 4), [2, 20]),
                     ((10,), [])):
        assert dec._cap_ranks(shape, r) == jdec._cap_ranks(shape, r)


@pytest.mark.parametrize("shape", [(10, 10, 10, 10), (3, 40, 5, 2)], ids=["cube", "ragged"])
def test_gram_tt_svd_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = _hilbert(10) if shape[0] == 10 else rng.standard_normal(shape)
    for r in (2, 4, [3, 6, 2]):
        got = dec.tt_svd_gram(torch.from_numpy(x), r)
        want = jdec.tt_svd_gram(jnp.asarray(x), r)
        assert [tuple(c.shape) for c in got] == [tuple(c.shape) for c in want]
        _close(tn.tt_full(got), jtn.tt_full(want))
        t = tn.Tensor(torch.from_numpy(x), ranks_tt=r, algorithm="gram")
        jt = jtn.Tensor(jnp.asarray(x), ranks_tt=r, algorithm="gram")
        assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
        _close(t.full(), jt.full())


def test_batch_gram_tt_svd_matches_jax():
    x = _hilbert(6, batch=3)
    for alg in ("gram", "randomized"):  # a batch takes the Gram kernel for both
        t = tn.Tensor(torch.from_numpy(x), ranks_tt=3, algorithm=alg, batch=True)
        jt = jtn.Tensor(jnp.asarray(x), ranks_tt=3, algorithm=alg, batch=True)
        assert t.ranks_tt.tolist() == jt.ranks_tt.tolist() and t.shape == tuple(jt.shape)
        _close(t.full(), jt.full())
    one = tn.Tensor(torch.from_numpy(x[1]), ranks_tt=3, algorithm="gram")
    _close(t.full()[1], one.full(), tol=1e-12)


def test_randomized_tt_svd_with_jax_draws(monkeypatch):
    x = _hilbert(10)
    key = jax.random.key(5)
    _jax_omega(monkeypatch, key, 4)
    for r in (3, [2, 5, 3]):
        got = dec.tt_svd_randomized(torch.from_numpy(x), r)
        want = jdec.tt_svd_randomized(jnp.asarray(x), r, key=key)
        assert [tuple(c.shape) for c in got] == [tuple(c.shape) for c in want]
        _close(tn.tt_full(got), jtn.tt_full(want), tol=RAND_TOL)
    # Tensor(algorithm='randomized') draws the JAX package's global stream
    jtn.utils.seed(9)
    _jax_omega(monkeypatch, jax.random.split(jax.random.key(9))[1], 4)
    t = tn.Tensor(torch.from_numpy(x), ranks_tt=4, algorithm="randomized")
    jt = jtn.Tensor(jnp.asarray(x), ranks_tt=4, algorithm="randomized")
    _close(t.full(), jt.full(), tol=RAND_TOL)


def test_randomized_tt_svd_own_sketch():
    x = _hilbert(10)
    gram = tn.relative_error(x, tn.Tensor(torch.from_numpy(x), ranks_tt=4, algorithm="gram"))
    own = tn.Tensor(torch.from_numpy(x), ranks_tt=4, algorithm="randomized")
    err = tn.relative_error(torch.from_numpy(x), own)
    assert float(err) <= 1.1 * float(gram)
    again = tn.Tensor(torch.from_numpy(x), ranks_tt=4, algorithm="randomized")
    assert all(torch.equal(a, b) for a, b in zip(own.cores, again.cores))  # seeded by shape
    g = torch.Generator().manual_seed(0)
    mine = dec.tt_svd_randomized(torch.from_numpy(x), 4, generator=g)
    assert float(tn.relative_error(torch.from_numpy(x), tn.Tensor(mine))) <= 1.1 * float(gram)


def test_config1_reduced():
    # BASELINE config 1 at 8^4, rank 3: mean, norm, indexing and round(1e-6)
    # against the dense tensor and the JAX package, from the same cores
    rng = np.random.default_rng(2)
    ranks = [1, 3, 3, 3, 1]
    cores = [rng.standard_normal((ranks[n], 8, ranks[n + 1])) for n in range(4)]
    t = interop.tensor_from_arrays(cores, device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores])
    dense = t.numpy()
    for got, want, ref in ((t.mean(), jt.mean(), dense.mean()), (t.norm(), jt.norm(),
                                                                 np.linalg.norm(dense)),
                           (tn.sum(t, dim=[1, 3]).full(), jtn.sum(jt, dim=[1, 3]).full(),
                            dense.sum(axis=(1, 3))),
                           (t.var(), jt.var(), dense.var()), (t.std(), jt.std(), dense.std()),
                           (t[3, :, 5, 2:7].full(), jt[3, :, 5, 2:7].full(), dense[3, :, 5, 2:7])):
        _close(got, want)
        _close(got, ref, tol=1e-12)
    X = rng.integers(0, 8, (64, 4))
    _close(t[X].full(), dense[tuple(X.T)], tol=1e-12)
    r, jr = t.clone(), jt.clone()
    r.round(1e-6)
    jr.round(1e-6)
    assert r.ranks_tt.tolist() == jr.ranks_tt.tolist()
    assert r.ranks_tucker.tolist() == jr.ranks_tucker.tolist()
    assert float(tn.relative_error(torch.from_numpy(dense), r)) <= 1e-6
    _close(r.full(), jr.full())
    # and through the port's own randn, against its own dense tensor
    g = tn.randn(8, 8, 8, 8, ranks_tt=3, device="cpu", dtype=torch.float64,
                 generator=torch.Generator().manual_seed(0))
    gd = g.full()
    assert abs(float(g.mean()) - float(gd.mean())) <= 1e-12 * float(gd.abs().max())
    g.round(1e-6)
    assert float(tn.relative_error(gd, g)) <= 1e-6


def test_config2_reduced():
    # BASELINE config 2 at 10^4: TT-SVD + TT-Tucker of the Hilbert tensor to
    # eps=1e-9, against the dense tensor and the JAX package
    x = _hilbert(10)
    t = tn.Tensor(torch.from_numpy(x), eps=1e-9)
    jt = jtn.Tensor(jnp.asarray(x), eps=1e-9)
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
    assert t.ranks_tucker.tolist() == jt.ranks_tucker.tolist()
    assert any(U is not None for U in t.Us) and t.numcoef() == jt.numcoef() < x.size
    assert float(tn.relative_error(torch.from_numpy(x), t)) <= 1e-9
    _close(t.full(), jt.full())
    for kw in (dict(ranks_tt=5, ranks_tucker=5), dict(ranks_tucker=6, algorithm="eig")):
        a = tn.Tensor(torch.from_numpy(x), **kw)
        ja = jtn.Tensor(jnp.asarray(x), **kw)
        assert a.ranks_tt.tolist() == ja.ranks_tt.tolist()
        assert a.ranks_tucker.tolist() == ja.ranks_tucker.tolist()
        _close(a.full(), ja.full(), tol=1e-9)


@pytest.mark.cuda
def test_decomposition_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _hilbert(10)
    g = tn.Tensor(x, eps=1e-9)  # numpy without a device: the card
    c = tn.Tensor(torch.from_numpy(x), eps=1e-9)
    assert g.device.type == "cuda" and g.ranks_tt.tolist() == c.ranks_tt.tolist()
    _close(g.full().cpu(), c.full(), tol=1e-9)
    for alg in ("gram", "randomized"):
        a = tn.Tensor(x, ranks_tt=4, algorithm=alg)
        b = tn.Tensor(torch.from_numpy(x), ranks_tt=4, algorithm=alg)
        _close(a.full().cpu(), b.full(), tol=1e-9)
