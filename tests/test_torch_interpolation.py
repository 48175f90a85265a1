"""The port's completion and interpolation (tntorch_tpu_torch/interpolation.py)
against the JAX package's (tntorch_tpu/interpolation.py), on the same NumPy
inputs in float64 on the CPU: BASELINE config 4's ALS and sparse TT-SVD at a
reduced size, LARS and PCE.

Tolerances (relative, dense reconstructions in norm, never cores):
- ALS from a carried ``x0``, 3 sweeps: 1e-8 (each sweep solves ridge
  regularized normal equations whose roundoff the next sweep carries);
- sparse TT-SVD on the dense path, ranks equal: 1e-10; on the sketched
  path with the JAX package's Gaussian draw patched into `_sketch_omega`:
  ranks equal, 1e-10; with the port's own draw, against the dense path:
  ranks equal, 1e-8 (the JAX package's own limit, tests/test_interpolation.py);
- the feature helpers, ``gram_schmidt``, ``lars_path`` (against JAX's
  device loop and against both host oracles) and ``PCEInterpolator``'s
  ``predict`` and ``to_tensor``: 1e-10.
Coordinates are unique: the JAX package resolves duplicates arbitrarily.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
import torch_parallel_ranks as ranks

INTERP = importlib.import_module("tntorch_tpu_torch.interpolation")
JINTERP = importlib.import_module("tntorch_tpu.interpolation")
TOL, ALS_TOL, SKETCH_TOL = 1e-10, 1e-8, 1e-8


@pytest.fixture(autouse=True)
def _one_thread_float64():
    # The JAX side runs in float64 (tests/conftest.py); the port's helpers
    # cast to torch's default dtype, set to float64 here and restored after
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _rel(got, want):
    got = got.numpy() if isinstance(got, (tn.Tensor, torch.Tensor)) else np.asarray(got)
    want = np.asarray(want.numpy() if hasattr(want, "cores") else want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tt_arrays(seed, shape, rank):
    rng = np.random.default_rng(seed)
    ranks = [1] + [rank] * (len(shape) - 1) + [1]
    return [rng.uniform(0, 1, (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _completion(seed, shape=(6, 5, 7), rank=2, P=300):
    """Ground-truth cores, sampled coordinates (every slice sampled) and
    their values."""
    cores = _tt_arrays(seed, shape, rank)
    gt = tn.Tensor([torch.from_numpy(c) for c in cores]).numpy()
    rng = np.random.default_rng(seed + 1)
    X = np.stack([rng.integers(0, s, P) for s in shape], axis=1)
    return cores, X, gt[tuple(X.T)], gt


def test_als_completion_matches_jax_from_a_carried_start():
    _, X, y, gt = _completion(0)
    x0 = _tt_arrays(7, gt.shape, 2)
    t0 = tn.Tensor([torch.from_numpy(c) for c in x0])
    t, eps = tn.als_completion(X, torch.from_numpy(y), ranks_tt=2, x0=t0, niter=3,
                               verbose=False, _return_eps=True)
    jt, jeps = jtn.als_completion(X, jnp.asarray(y), ranks_tt=2,
                                  x0=jtn.Tensor([jnp.asarray(c) for c in x0]), niter=3,
                                  verbose=False, _return_eps=True)
    assert t is t0  # the start is completed in place, as in the JAX package
    assert _rel(t, jt) <= ALS_TOL
    assert abs(eps - jeps) <= ALS_TOL * max(jeps, 1e-300) + 1e-14


def test_als_completion_recovers_a_low_rank_tensor_with_restarts():
    _, X, y, gt = _completion(1, shape=(6, 6, 6), P=500)
    g = torch.Generator().manual_seed(3)
    t = tn.als_completion(X, y, ranks_tt=2, shape=[6, 6, 6], verbose=False, restarts=3,
                          device="cpu", generator=g)
    assert t.device.type == "cpu" and t.dtype == torch.float64
    assert _rel(t, gt) <= 1e-6
    # constant data, rank 1 (tests/test_interpolation.py's reference oracle)
    t = tn.als_completion(X[:200], np.ones(200), ranks_tt=1, shape=[6, 6, 6], verbose=False,
                          device="cpu", generator=g)
    assert np.abs(t.numpy() - 1).max() <= 1e-6
    with pytest.raises(ValueError, match="every tensor slice"):
        tn.als_completion(X[:3], y[:3], ranks_tt=1, shape=[6, 6, 6], verbose=False, device="cpu")
    # mesh= passes through the restarts; on one rank it changes no value (on
    # four: tests/test_torch_parallel_paths.py)
    kw = dict(ranks_tt=2, shape=[6, 6, 6], verbose=False, restarts=2, device="cpu")
    want = tn.als_completion(X, y, generator=torch.Generator().manual_seed(4), **kw)
    with ranks.solo_mesh() as mesh:
        got = tn.als_completion(X, y, generator=torch.Generator().manual_seed(4), mesh=mesh, **kw)
    assert np.array_equal(got.numpy(), want.numpy())


def _unique_samples(seed, shape, P):
    rng = np.random.default_rng(seed)
    return np.unique(np.stack([rng.integers(0, s, P) for s in shape], axis=1), axis=0)


def test_sparse_tt_svd_dense_path_matches_jax():
    X = _unique_samples(2, (6, 6, 6), 300)
    y = np.random.default_rng(3).standard_normal(len(X))
    t = tn.sparse_tt_svd(X, torch.from_numpy(y), eps=1e-12, shape=[6, 6, 6])
    jt = jtn.sparse_tt_svd(X, jnp.asarray(y), eps=1e-12, shape=[6, 6, 6])
    assert list(t.ranks_tt) == list(jt.ranks_tt)
    assert _rel(t, jt) <= TOL
    dense = np.zeros((6, 6, 6))
    dense[tuple(X.T)] = y
    assert _rel(t, dense) <= 1e-8
    # a planted low-rank tensor, every entry sampled: its ranks come back
    cores, _, _, gt = _completion(4, shape=(6, 5, 7), rank=2)
    Xf = np.stack(np.meshgrid(*map(np.arange, gt.shape), indexing="ij"), -1).reshape(-1, 3)
    t = tn.sparse_tt_svd(Xf, torch.from_numpy(gt.reshape(-1)), eps=1e-8)
    assert list(t.ranks_tt) == [1, 2, 2, 1] and _rel(t, gt) <= 1e-8


def _sliced_samples():
    """tests/test_interpolation.py's sketched case, smaller: complete slices
    of a planted rank-3 40 x 12 x 12 tensor, so the zero-filled tensor stays
    low-rank."""
    cores, _, _, gt = _completion(5, shape=(40, 12, 12), rank=3)
    S = np.sort(np.random.default_rng(7).choice(40, 15, replace=False))
    i2, i3 = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    cols = np.stack([i2.ravel(), i3.ravel()], axis=1)
    X = np.concatenate([np.repeat(S, 144)[:, None], np.tile(cols, (len(S), 1))], axis=1)
    return X, gt[tuple(X.T)]


def test_sparse_tt_svd_sketched_path(monkeypatch):
    X, y = _sliced_samples()
    dense = tn.sparse_tt_svd(X, torch.from_numpy(y), eps=1e-6, shape=[40, 12, 12])
    for module in (INTERP, JINTERP):
        monkeypatch.setattr(module, "_SPARSE_DENSE_ROWS_MAX", 8)
    own = tn.sparse_tt_svd(X, torch.from_numpy(y), eps=1e-6, shape=[40, 12, 12])
    assert list(own.ranks_tt) == list(dense.ranks_tt)
    assert _rel(own, dense) <= SKETCH_TOL
    key = jax.random.key(0)
    monkeypatch.setattr(INTERP, "_sketch_omega", lambda _key, mode, ncols, k, dtype, device:
                        torch.from_numpy(np.asarray(jax.random.normal(
                            jax.random.fold_in(key, mode), (ncols, k), dtype=jnp.float64))))
    got = tn.sparse_tt_svd(X, torch.from_numpy(y), eps=1e-6, shape=[40, 12, 12])
    want = jtn.sparse_tt_svd(X, jnp.asarray(y), eps=1e-6, shape=[40, 12, 12])
    assert list(got.ranks_tt) == list(want.ranks_tt)
    assert _rel(got, want) <= TOL


def test_feature_helpers_match_jax():
    rng = np.random.default_rng(8)
    X = rng.uniform(-5, 5, (50, 3))
    bbox = tn.get_bounding_box(X)
    assert bbox == jtn.get_bounding_box(jnp.asarray(X))
    domain = [np.linspace(-5, 5, 16)] * 3
    for kw in (dict(bbox=bbox, I=16), dict(domain=domain), dict()):
        got = tn.features2indices(X, device="cpu", **kw)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), np.asarray(jtn.features2indices(X, **kw)))
    assert INTERP.discretize is tn.features2indices
    Xi = tn.features2indices(X, bbox=bbox, I=16, device="cpu")
    for kw in (dict(bbox=bbox, I=16), dict(domain=domain)):
        assert _rel(tn.indices2features(Xi, device="cpu", **kw),
                    jtn.indices2features(Xi.numpy(), **kw)) <= TOL
    for got, want in zip(tn.empirical_marginals(X, domain, device="cpu"),
                         jtn.empirical_marginals(jnp.asarray(X), domain)):
        assert _rel(got, want) <= TOL
    x = rng.uniform(0, 1, 200)
    Psi = tn.gram_schmidt(torch.from_numpy(x), 4)
    assert _rel(Psi, jtn.gram_schmidt(jnp.asarray(x), 4)) <= TOL
    B = (x[:, None] ** np.arange(4)) @ Psi.numpy()
    assert np.abs(B.T @ B / len(x) - np.eye(4)).max() <= 1e-10


@pytest.mark.parametrize("P,M,noise,maxnz", [(100, 20, 0.0, 10), (100, 20, 0.1, None),
                                             (30, 60, 0.0, None)])
def test_lars_path_matches_jax_and_the_host_oracles(P, M, noise, maxnz):
    rng = np.random.default_rng(P + M)
    X = rng.standard_normal((P, M))
    beta = np.zeros(M)
    beta[rng.choice(M, 5, replace=False)] = rng.standard_normal(5)
    y = X @ beta + noise * rng.standard_normal(P)
    got = tn.lars_path(torch.from_numpy(X), torch.from_numpy(y), max_nonzero=maxnz)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    for want in (jtn.lars_path(jnp.asarray(X), jnp.asarray(y), max_nonzero=maxnz),
                 JINTERP._lars_path_host(jnp.asarray(X), jnp.asarray(y), max_nonzero=maxnz),
                 INTERP._lars_path_host(X, y, max_nonzero=maxnz)):
        assert got.shape == np.asarray(want).shape
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_pce_interpolator_matches_jax():
    rng = np.random.default_rng(9)
    P, N = 80, 3
    X = rng.integers(0, 16, (P, N)).astype(np.float64)
    y = (X ** 2) @ rng.uniform(size=N) + rng.standard_normal(P)
    pce, jpce = tn.PCEInterpolator(device="cpu"), jtn.PCEInterpolator()
    pce.fit(X, y, p=3, verbose=False)
    jpce.fit(jnp.asarray(X), jnp.asarray(y), p=3, verbose=False)
    assert np.array_equal(pce.coords, jpce.coords)
    Xt = rng.uniform(0, 15, (20, N))
    assert _rel(pce.predict(Xt), jpce.predict(jnp.asarray(Xt))) <= TOL
    t = pce.to_tensor(domain=8, eps=1e-6, verbose=False)
    jt = jpce.to_tensor(domain=8, eps=1e-6, verbose=False)
    assert list(t.ranks_tt) == list(jt.ranks_tt)
    assert _rel(t, jt) <= TOL
