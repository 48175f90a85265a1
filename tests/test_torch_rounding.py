"""The port's rounding sweeps (tntorch_tpu_torch/ops/rounding.py) against
the JAX package's (tntorch_tpu/ops/rounding.py), on the same numpy inputs.

Rounded TTs are defined up to a gauge (eigh signs and orders differ between
the frameworks), so the tests compare dense reconstructions, never cores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu.ops import rounding as jr
from tntorch_tpu_torch.ops import gram_kernels as gk
from tntorch_tpu_torch.ops import rounding as tr


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _tt(shape, ranks, seed, batch=None, scale=1.0):
    """Random TT cores (numpy, f64): one TT, or `batch` TTs stacked."""
    rng = np.random.default_rng(seed)
    ranks = [1] + list(ranks) + [1]
    b = () if batch is None else (batch,)
    return [scale * rng.standard_normal(b + (ranks[n], s, ranks[n + 1]))
            for n, s in enumerate(shape)]


def _jax_full(cores):
    return np.asarray(jr.tt_full(tuple(jnp.asarray(c) for c in cores)))


def _port_full(cores):
    return tr.tt_full([torch.as_tensor(c) for c in cores]).numpy()


def _batch_full(cores, full):
    return np.stack([full([c[b] for c in cores]) for b in range(cores[0].shape[0])])


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_sketch(n, r, dtype, device):
    """The JAX package's default sketch of _subspace_topr, as a torch tensor."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), n), r)
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    return torch.from_numpy(np.array(jax.random.normal(key, (n, r), dtype=jdt))).to(device)


def _torch(cores):
    return [torch.from_numpy(np.array(c)) for c in cores]


# f64 throughout unless stated: the two sides differ by roundoff only, so
# dense reconstructions agree to 1e-10 relative (well above f64 roundoff of
# these sweeps, far below any truncation error).
F64_TOL = 1e-10


@pytest.mark.parametrize("fn", ["round_tt_gram", "round_tt_fixed"])
def test_fixed_rank_sweeps_match_jax(fn):
    cores = _tt((9, 10, 11, 12), (6, 7, 6), seed=1)
    want = _jax_full(getattr(jr, fn)(tuple(jnp.asarray(c) for c in cores), 4))
    got = getattr(tr, fn)(_torch(cores), 4)
    assert [tuple(c.shape) for c in got] == [(1, 9, 4), (4, 10, 4), (4, 11, 4), (4, 12, 1)]
    assert _rel(_port_full(got), want) <= F64_TOL


@pytest.mark.parametrize("policy", ["highest", "high"])  # Householder QR / CholeskyQR2
@pytest.mark.parametrize("algorithm", ["svd", "eig"])
@pytest.mark.parametrize("case", ["t+t", "t+1e-6*u"])
def test_round_tt_eps_matches_jax(case, algorithm, policy):
    # Inputs with a clear spectral gap, so both sides pick identical ranks:
    # t+t has exactly redundant directions; 1e-6*u sits far below eps=1e-3
    a = jtn.Tensor([jnp.asarray(c) for c in _tt((8, 9, 10, 11), (3, 4, 3), seed=2)])
    u = jtn.Tensor([jnp.asarray(c) for c in _tt((8, 9, 10, 11), (2, 2, 2), seed=3)])
    t, eps = (a + a, 1e-10) if case == "t+t" else (a + 1e-6 * u, 1e-3)
    cores = [np.asarray(c) for c in t.cores]
    jtn.set_policy(policy)
    tn.set_policy(policy)
    try:
        want, wreached = jr.round_tt_eps(tuple(jnp.asarray(c) for c in cores), eps, None,
                                         algorithm=algorithm, return_reached=True)
        got, reached = tr.round_tt_eps(_torch(cores), eps, None, algorithm=algorithm,
                                       return_reached=True)
    finally:
        jtn.set_policy("highest")
        tn.set_policy("highest")
    assert [tuple(c.shape) for c in got] == [c.shape for c in want]
    assert [c.shape[-1] for c in got][:-1] == [3, 4, 3]
    assert _rel(_port_full(got), _jax_full(want)) <= F64_TOL
    assert abs(float(reached) - float(wreached)) <= 1e-8


@pytest.mark.parametrize("algorithm", ["svd", "eig"])
def test_round_tt_batch_matches_jax(algorithm):
    # The batch rule: no error budget, rank min(rmax, rows, cols) per edge
    cores = _tt((6, 7, 8, 9), (5, 6, 5), seed=4, batch=3)
    want, wreached = jr.round_tt_batch(tuple(jnp.asarray(c) for c in cores), 3, algorithm,
                                       return_reached=True)
    got, reached = tr.round_tt_batch(_torch(cores), 3, algorithm, return_reached=True)
    assert [tuple(c.shape) for c in got] == [c.shape for c in want]
    assert _rel(_batch_full([c.numpy() for c in got], _port_full),
                _batch_full([np.asarray(c) for c in want], _jax_full)) <= F64_TOL
    np.testing.assert_allclose(reached.numpy(), np.asarray(wreached), rtol=1e-8)


def test_gram_batched_eigh_matches_jax_push_sweep_f64():
    # The port runs the no-push sweep on real input (deferred interface
    # transforms, wgram/proj2); JAX's einsum push sweep is the same math
    cores = _tt((12, 12, 12, 12), (8, 8, 8), seed=22, batch=3)
    want = jr.round_tt_gram_batched(tuple(jnp.asarray(c) for c in cores), 4, "eigh", False)
    got = tr.round_tt_gram_batched(_torch(cores), 4, "eigh")
    assert [tuple(c.shape) for c in got] == [c.shape for c in want]
    assert _rel(_batch_full([c.numpy() for c in got], _port_full),
                _batch_full([np.asarray(c) for c in want], _jax_full)) <= F64_TOL


def test_gram_batched_eigh_matches_jax_nopush_pallas_f32():
    # JAX's own no-push sweep on its Pallas kernels (interpret mode), f32,
    # at the shape its tests use (B=2, N=4, I=16, R=128 -> 64). f32 Gram
    # sweeps at a rank-64 cut agree to ~1e-5; 1e-4 as JAX's push-vs-no-push
    # test allows
    rng = np.random.default_rng(24)
    ranks = [1, 128, 128, 128, 1]
    cores = [(rng.standard_normal((2, ranks[n], 16, ranks[n + 1])) / 12.0).astype(np.float32)
             for n in range(4)]
    want = jr.round_tt_gram_batched(tuple(jnp.asarray(c) for c in cores), 64, "eigh", True,
                                    "highest", True)
    got = tr.round_tt_gram_batched(_torch(cores), 64, "eigh")
    assert [tuple(c.shape) for c in got] == [c.shape for c in want]
    d_got = _batch_full([c.numpy().astype(np.float64) for c in got], _port_full)
    d_want = _batch_full([np.asarray(c, dtype=np.float64) for c in want], _jax_full)
    assert _rel(d_got, d_want) <= 1e-4


def test_rand_edges_match_jax_with_its_sketch(monkeypatch):
    # With JAX's own Gaussian sketch the randomized edges are the same
    # arithmetic, single TT and batch. The q=2 power iterations apply A^5
    # to the sketch, which amplifies f64 roundoff by the spectrum's spread:
    # 1e-8 relative (measured ~2e-10)
    monkeypatch.setattr(tr, "_sketch", _jax_sketch)
    cores = _tt((10, 11, 12, 13), (12, 12, 12), seed=6)
    want = jr.round_tt_gram(tuple(jnp.asarray(c) for c in cores), 6, edge_solver="rand")
    got = tr.round_tt_gram(_torch(cores), 6, edge_solver="rand")
    assert _rel(_port_full(got), _jax_full(want)) <= 1e-8

    bcores = _tt((10, 11, 12, 13), (12, 12, 12), seed=7, batch=2)
    want = jr.round_tt_gram_batched(tuple(jnp.asarray(c) for c in bcores), 6, "rand", False)
    got = tr.round_tt_gram_batched(_torch(bcores), 6, "rand")
    assert _rel(_batch_full([c.numpy() for c in got], _port_full),
                _batch_full([np.asarray(c) for c in want], _jax_full)) <= 1e-8


def test_own_sketch_is_quasi_optimal():
    # The port's sketch is not JAX's: hold the randomized truncation to the
    # JAX package's quasi-optimality bound, within 1.1x the eigh error
    cores = _tt((10, 11, 12, 13), (16, 16, 16), seed=2)
    t = tn.interop.tensor_from_arrays(cores, device="cpu")
    dense = t.numpy()
    opt = tn.round_tt(t, rmax=8, algorithm="gram")
    rand = tn.round_tt(t, rmax=8, algorithm="randgram")
    assert rand.ranks_tt.tolist() == [1, 8, 8, 8, 1]
    e_opt, e_rand = _rel(opt.numpy(), dense), _rel(rand.numpy(), dense)
    assert e_rand <= 1.1 * e_opt + 1e-12, (e_rand, e_opt)


def test_sketch_is_identical_across_dtypes_and_shapes_differ():
    a = tr._sketch(16, 4, torch.float64, "cpu")
    b = tr._sketch(16, 4, torch.float32, "cpu")
    assert torch.equal(a.float(), b)
    assert not torch.equal(a, tr._sketch(16, 5, torch.float64, "cpu")[:, :4])


def test_real_batch_runs_the_kernel_wrappers(monkeypatch):
    # N=4: the right-Gram chain is 3 gram_edge calls, the no-push left sweep
    # 2 wgram and 2 proj2 calls, the main path's launch pattern on the card
    calls = {"gram_edge": 0, "wgram": 0, "proj2": 0}

    def spy(name):
        plain = getattr(gk, name)

        def f(*args):
            calls[name] += 1
            return plain(*args)

        return f

    for name in calls:
        monkeypatch.setattr(gk, name, spy(name))
    cores = _tt((8, 8, 8, 8), (6, 6, 6), seed=8, batch=2)
    tr.round_tt_gram_batched(_torch(cores), 3, "rand")
    assert calls == {"gram_edge": 3, "wgram": 2, "proj2": 2}


def test_complex_batch_takes_the_einsum_branch(monkeypatch):
    def refuse(*args):
        raise AssertionError("complex input reached a real-only kernel wrapper")

    for name in ("gram_edge", "wgram", "proj2"):
        monkeypatch.setattr(gk, name, refuse)
    rng = np.random.default_rng(7)
    cores = [rng.standard_normal(s) + 1j * rng.standard_normal(s)
             for s in [(2, 1, 8, 4), (2, 4, 8, 4), (2, 4, 8, 1)]]
    want = jr.round_tt_gram_batched(tuple(jnp.asarray(c) for c in cores), 2, "eigh", False)
    got = tr.round_tt_gram_batched(_torch(cores), 2, "eigh")
    assert _rel(_batch_full([c.numpy() for c in got], _port_full),
                _batch_full([np.asarray(c) for c in want], _jax_full)) <= F64_TOL


def test_bf16_gram_is_not_ported():
    cores = _torch(_tt((4, 4, 4), (2, 2), seed=9))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.round_tt_gram(cores, 2, precision="bf16")
