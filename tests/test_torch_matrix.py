"""TT and CP matrices in the port (tntorch_tpu_torch/models/matrix.py)
against the JAX package (tntorch_tpu/models/matrix.py), on the same NumPy
matrices in float64 on the CPU, to 1e-10 relative (1e-8 where CP-ALS
runs): construction, ``full``, ``trace``, ``flatten``, the products, and a
Kronecker TT-matrix's determinant, inverse and Cholesky factor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn

TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _dense(x):
    if hasattr(x, "cores") and hasattr(x, "full"):
        x = x.full()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * max(np.linalg.norm(want), 1e-300)


@pytest.mark.parametrize("batch", [False, True], ids=["single", "batch2"])
def test_ttmatrix_matches_jax(batch):
    rng = np.random.default_rng(0)
    M = rng.standard_normal((2, 24, 15) if batch else (24, 15))
    for ranks in ([30], [4]):  # exact, then truncated
        m = tn.TTMatrix(torch.from_numpy(M), ranks=ranks, input_dims=[6, 4], output_dims=[5, 3])
        jm = jtn.TTMatrix(jnp.asarray(M), ranks=ranks, input_dims=[6, 4], output_dims=[5, 3])
        assert m.batch == jm.batch and m.ranks.tolist() == np.asarray(jm.ranks).tolist()
        assert [tuple(c.shape) for c in m.cores] == [tuple(c.shape) for c in jm.cores]
        _close(m.full(), jm.full())
        _close(m.flatten(), jm.flatten())
    _close(tn.TTMatrix(torch.from_numpy(M), [30], [6, 4], [5, 3]).full(), M)
    S = rng.standard_normal((2, 24, 24) if batch else (24, 24))
    m = tn.TTMatrix(torch.from_numpy(S), [24], [6, 4], [6, 4])
    jm = jtn.TTMatrix(jnp.asarray(S), [24], [6, 4], [6, 4])
    _close(m.trace(), jm.trace())
    _close(m.trace(), np.trace(S, axis1=-2, axis2=-1))
    m2 = tn.TTMatrix([c.clone() for c in m.cores], None, [6, 4], [6, 4])
    _close(m2.full(), S)
    with pytest.raises(ValueError, match="ranks"):
        tn.TTMatrix(torch.from_numpy(S), 24, [6, 4], [6, 4])


def test_tt_multiply_matches_jax():
    rng = np.random.default_rng(1)
    M = rng.standard_normal((24, 15))
    m = tn.TTMatrix(torch.from_numpy(M), [30], [6, 4], [5, 3])
    jm = jtn.TTMatrix(jnp.asarray(M), [30], [6, 4], [5, 3])
    for v in (rng.standard_normal((7, 24)), rng.standard_normal((2, 6, 4))):
        got = tn.tt_multiply(m, torch.from_numpy(v))
        _close(got, jtn.tt_multiply(jm, jnp.asarray(v)))
        _close(got, v.reshape(-1, 24) @ M)
    # a TT vector's values, as the phase on the card applies them
    x = tn.randn(6, 4, ranks_tt=2, device="cpu", dtype=torch.float64)
    _close(tn.tt_multiply(m, x.full()[None]), x.full().reshape(1, 24).numpy() @ M)


def _kron(seed, dims):
    rng = np.random.default_rng(seed)
    blocks = []
    for d in dims:
        A = rng.standard_normal((d, d))
        blocks.append(A @ A.T + d * np.eye(d))
    K = blocks[0]
    for B in blocks[1:]:
        K = np.kron(K, B)
    return K


def test_kronecker_operations_match_jax():
    K = _kron(2, (3, 4, 2))
    m = tn.TTMatrix(torch.from_numpy(K), [1, 1], [3, 4, 2], [3, 4, 2])
    jm = jtn.TTMatrix(jnp.asarray(K), [1, 1], [3, 4, 2], [3, 4, 2])
    _close(m.determinant(), jm.determinant())
    _close(m.determinant(), np.linalg.det(K), 1e-8)
    s, ld = m.slog_determinant()
    js, jld = jm.slog_determinant()
    assert float(s) == float(js) == np.linalg.slogdet(K)[0]
    _close(ld, jld)
    _close(ld, np.linalg.slogdet(K)[1])
    _close(m.inv().full(), jm.inv().full())
    _close(m.inv().full(), np.linalg.inv(K), 1e-8)
    L = _dense(m.cholesky().full())
    _close(L, np.asarray(jm.cholesky().full()))
    _close(L @ L.T, K)
    # a batch: every sample's blocks
    Kb = np.stack([K, _kron(3, (3, 4, 2))])
    mb = tn.TTMatrix(torch.from_numpy(Kb), [1, 1], [3, 4, 2], [3, 4, 2])
    _close(mb.slog_determinant()[1], np.linalg.slogdet(Kb)[1])
    _close(mb.inv().full(), np.linalg.inv(Kb), 1e-8)


def test_kronecker_operations_refuse_what_they_cannot_do():
    K = np.kron(-np.eye(2) * 2.0, np.eye(2))
    m = tn.TTMatrix(torch.from_numpy(K), [1], [2, 2], [2, 2])
    with pytest.raises(ValueError, match="SPD"):
        m.cholesky()
    S = np.random.default_rng(4).standard_normal((4, 4))
    with pytest.raises(ValueError, match="Kronecker product"):
        tn.TTMatrix(torch.from_numpy(S), [4], [2, 2], [2, 2]).determinant()
    with pytest.raises(ValueError, match="square"):
        tn.TTMatrix(torch.from_numpy(np.ones((4, 6))), [1], [2, 2], [2, 3]).inv()


def test_cpmatrix_matches_jax():
    """CP-ALS from the HOSVD start, whose signs do not matter (ALS is
    equivariant under them): the JAX package's matrix to 1e-8, at a rank
    within every mode's size, so no random columns are drawn."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((24, 24))
    m = tn.CPMatrix(torch.from_numpy(M), rank=9, input_dims=[6, 4], output_dims=[6, 4])
    jm = jtn.CPMatrix(jnp.asarray(M), rank=9, input_dims=[6, 4], output_dims=[6, 4])
    assert [tuple(c.shape) for c in m.cores] == [(6, 6, 9), (4, 4, 9)]
    _close(m.full(), jm.full(), 1e-8)
    v = rng.standard_normal((3, 24))
    got = tn.cp_multiply(m, torch.from_numpy(v))
    _close(got, jtn.cp_multiply(jm, jnp.asarray(v)), 1e-8)
    _close(got, v @ m.numpy())
    # an exact Kronecker sum of rank 2 is recovered
    A, B, C, D = (rng.standard_normal((4, 4)) for _ in range(4))
    exact = tn.CPMatrix(torch.from_numpy(np.kron(A, B) + np.kron(C, D)), rank=2,
                        input_dims=[4, 4], output_dims=[4, 4])
    _close(exact.full(), np.kron(A, B) + np.kron(C, D), 1e-8)
    with pytest.raises(ValueError, match="rank must be an int"):
        tn.CPMatrix(torch.from_numpy(M), rank=2.0, input_dims=[6, 4], output_dims=[6, 4])
