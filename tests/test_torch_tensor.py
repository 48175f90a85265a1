"""The port's slice as a whole: build a TT from numpy cores, do arithmetic,
round it, measure it, through tntorch_tpu_torch's public API and through
tntorch_tpu's, on the same inputs. Dense reconstructions are compared, never
cores (a rounded TT is defined up to a gauge). f64 throughout: the two
packages differ by roundoff, so values agree to 1e-10 relative."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop
from tntorch_tpu_torch.ops import rounding as tr

TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _cores(seed, batch, ranks=(3, 4, 3), shape=(6, 7, 8, 9)):
    rng = np.random.default_rng(seed)
    ranks = [1, *ranks, 1]
    b = (batch,) if batch else ()
    return [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _pair(seed, batch, **kw):
    """The same TT in both packages."""
    cores = _cores(seed, batch, **kw)
    return interop.tensor_from_arrays(cores, batch=bool(batch), device="cpu"), jtn.Tensor(
        [jnp.asarray(c) for c in cores], batch=bool(batch))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def _jax_sketch(n, r, dtype, device):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), n), r)
    return torch.from_numpy(np.array(jax.random.normal(key, (n, r), dtype=jnp.float64))).to(
        device=device, dtype=dtype)


BATCH = pytest.mark.parametrize("batch", [0, 3], ids=["single", "batch3"])


@BATCH
def test_arithmetic_matches_jax(batch):
    a, ja = _pair(1, batch)
    b, jb = _pair(2, batch)
    for got, want in [
        (a + 0.01 * b, ja + 0.01 * jb),
        (a - b, ja - jb),
        (-a, -ja),
        (a * b, ja * jb),
        (2.5 * a + 1.0, 2.5 * ja + 1.0),
        (3.0 - a, 3.0 - ja),
        (a / 4.0, ja / 4.0),
    ]:
        assert got.ranks_tt.tolist() == want.ranks_tt.tolist()
        _close(got.full().numpy(), want.full())


def test_per_sample_scalars_match_jax():
    a, ja = _pair(3, 2)
    s = np.array([1.5, -2.0])
    _close((a * s).full().numpy(), (ja * jnp.asarray(s)).full())
    _close((a + s).full().numpy(), (ja + jnp.asarray(s)).full())


def test_broadcast_by_repeat_matches_jax():
    a, ja = _pair(4, 0, shape=(2, 3, 4), ranks=(2, 2))
    b, jb = _pair(5, 0, shape=(4, 3, 8), ranks=(2, 2))
    _close((a + b).full().numpy(), (ja + jb).full())
    _close((a * b).full().numpy(), (ja * jb).full())


@BATCH
@pytest.mark.parametrize("algorithm", ["gram", "randgram"])
def test_round_tt_gram_matches_jax(batch, algorithm, monkeypatch):
    # randgram draws JAX's own sketch here (see test_torch_rounding for the
    # port's own); its power iterations amplify roundoff: 1e-8
    monkeypatch.setattr(tr, "_sketch", _jax_sketch)
    a, ja = _pair(6, batch, ranks=(5, 6, 5))
    b, jb = _pair(7, batch, ranks=(5, 6, 5))
    t, jt = a + 0.01 * b, ja + 0.01 * jb
    t.round_tt(rmax=4, algorithm=algorithm)
    jt.round_tt(rmax=4, algorithm=algorithm)
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist() == [1, 4, 4, 4, 1]
    _close(t.full().numpy(), jt.full(), tol=TOL if algorithm == "gram" else 1e-8)


@BATCH
@pytest.mark.parametrize("algorithm", ["svd", "eig"])
def test_round_tt_eps_matches_jax(batch, algorithm):
    # t + t has exactly redundant directions: both packages drop them. A
    # batch has no error budget (rank min(rmax, rows, cols), so roundoff
    # directions stay): rmax caps it at the true ranks
    a, ja = _pair(8, batch)
    t, jt = a + a, ja + ja
    rmax = [3, 4, 3] if batch else None
    t.round_tt(1e-10, rmax=rmax, algorithm=algorithm)
    jt.round_tt(1e-10, rmax=rmax, algorithm=algorithm)
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist() == [1, 3, 4, 3, 1]
    _close(t.full().numpy(), jt.full())


@BATCH
def test_round_tt_verbose_branch_matches_jax(batch):
    a, ja = _pair(9, batch)
    t, jt = a + a, ja + ja
    t.round_tt(1e-10, rmax=3, verbose=True)
    jt.round_tt(1e-10, rmax=3, verbose=True)
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
    _close(t.full().numpy(), jt.full())


def test_f32_gram_under_highest_routes_to_svd():
    cores = [c.astype(np.float32) for c in _cores(10, 0, ranks=(5, 6, 5))]
    t = interop.tensor_from_arrays(cores, device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores])
    t.round_tt(rmax=3, algorithm="gram")
    jt.round_tt(rmax=3, algorithm="gram")
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
    _close(t.full().numpy(), jt.full(), tol=1e-5)  # f32 SVD sweeps


@BATCH
def test_metrics_match_jax(batch):
    a, ja = _pair(11, batch)
    b, jb = _pair(12, batch)
    for got, want in [
        (tn.dot(a, b), jtn.dot(ja, jb)),
        (a.dot(b), ja.dot(jb)),
        (tn.norm(a), jtn.norm(ja)),
        (a.normsq(), ja.normsq()),
        (tn.dist(a, b), jtn.dist(ja, jb)),
        (tn.relative_error(a, a + 0.01 * b), jtn.relative_error(ja, ja + 0.01 * jb)),
        (tn.relative_error(a.full(), b), jtn.relative_error(ja.full(), jb)),
    ]:
        _close(got.numpy(), want)


def test_partial_dot_matches_jax():
    a, ja = _pair(13, 0)
    b, jb = _pair(14, 0, shape=(6, 7), ranks=(2,))
    _close(tn.dot(a, b).full().numpy(), jtn.dot(ja, jb).full())
    _close(tn.dot(b, a).full().numpy(), jtn.dot(jb, ja).full())


def test_complex_norm_matches_jax():
    rng = np.random.default_rng(15)
    cores = [rng.standard_normal(s) + 1j * rng.standard_normal(s)
             for s in [(1, 4, 2), (2, 5, 2), (2, 6, 1)]]
    t = interop.tensor_from_arrays(cores, device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores])
    _close(tn.norm(t).numpy(), jtn.norm(jt))
    _close(tn.dist(t, 2 * t).numpy(), jtn.dist(jt, 2 * jt))


@BATCH
def test_dense_construction_and_orthogonalize_match_jax(batch):
    rng = np.random.default_rng(16)
    x = rng.standard_normal(((batch,) if batch else ()) + (3, 4, 5))
    t = tn.Tensor(torch.from_numpy(x), batch=bool(batch))
    jt = jtn.Tensor(jnp.asarray(x), batch=bool(batch))
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
    _close(t.full().numpy(), x)
    t.orthogonalize(1)
    jt.orthogonalize(1)
    _close(t.full().numpy(), jt.full())
    Q = t.cores[0].reshape(((batch,) if batch else ()) + (-1, t.cores[0].shape[-1]))
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype)
    assert torch.allclose(Q.mT @ Q, eye.expand(Q.shape[:-2] + eye.shape), atol=1e-12)


@BATCH
def test_shape_ranks_and_repr_match_jax(batch):
    a, ja = _pair(17, batch)
    assert a.shape == tuple(ja.shape)
    assert a.dim() == ja.dim()
    assert a.ranks_tt.tolist() == ja.ranks_tt.tolist()
    assert repr(a) == repr(ja)


def test_interop_round_trip_and_device():
    cores = _cores(18, 2)
    t = interop.tensor_from_arrays(cores, batch=True, device="cpu")
    back = interop.tensor_to_arrays(t)
    assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(back, cores))
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=True)
    t2 = interop.tensor_from_arrays(jt.cores, batch=True, device="cpu")  # JAX arrays cross too
    _close(t2.full().numpy(), jt.full())


def test_functional_round_tt_leaves_input():
    a, _ = _pair(19, 0)
    t = a + a
    r = tn.round_tt(t, eps=1e-10)
    assert t.ranks_tt.tolist() == [1, 6, 8, 6, 1]
    assert r.ranks_tt.tolist() == [1, 3, 4, 3, 1]


def test_entry_points_outside_the_slice_raise():
    a, _ = _pair(20, 0)
    def setitem():
        a[0, 0, 0, 0] = 1.0

    for call in (lambda: tn.cross(), lambda: tn.randn(3, 3, ranks_cp=2, device="cpu"),
                 lambda: tn.round(a), lambda: tn.Tensor(np.ones((3, 3)), ranks_tt=2),
                 lambda: a[a], setitem,
                 lambda: tn.Tensor([np.ones((3, 2)), np.ones((3, 2))], device="cpu"),
                 lambda: a.round_tucker()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_policy_pins_full_float32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        seen = []
        tn.utils.policy_precision(lambda: seen.append(torch.get_float32_matmul_precision()))()
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    tn.set_policy("high")
    try:
        assert tn.get_policy() == "high"
        assert tr.resolve_edge_solver(None, tn.utils.resolve_precision()) == "rand"
    finally:
        tn.set_policy("highest")
    with pytest.raises(ValueError):
        tn.set_policy("tf32")


def test_package_never_imports_jax():
    code = "import tntorch_tpu_torch, sys; assert 'jax' not in sys.modules"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
