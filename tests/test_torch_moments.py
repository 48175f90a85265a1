"""The port's moments and Hadamard sums (tntorch_tpu_torch/metrics.py:
``raw_moment``, ``normalized_moment``, ``hadamard_sum``) against the JAX
package's, in float64 on the CPU, to 1e-10 relative: the exact
contraction on plain, Tucker and batch tensors and with marginals, and the
rounded chain with 'eig' (both packages round the same chains; the error
budgets are the callers'). A JAX rounding compiles per shape, so the
rounded chain meets JAX on plain tensors; on a batch, and with 'svd', it
meets the port's own per-sample results, the exact contraction and the
dense sum.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn

TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread_float64():
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _pair(seed, shape=(4, 5, 3), rank=2, batch=None, tucker=False):
    rng = np.random.default_rng(seed)
    ranks = [1] + [rank] * (len(shape) - 1) + [1]
    b = () if batch is None else (batch,)
    inner = [2 if tucker and n == 1 else s for n, s in enumerate(shape)]
    cores = [rng.standard_normal(b + (ranks[n], inner[n], ranks[n + 1]))
             for n in range(len(shape))]
    Us = [rng.standard_normal(b + (s, 2)) if tucker and n == 1 else None
          for n, s in enumerate(shape)]
    t = tn.Tensor([torch.from_numpy(c) for c in cores],
                  Us=[None if U is None else torch.from_numpy(U) for U in Us], batch=b != ())
    jt = jtn.Tensor([jnp.asarray(c) for c in cores],
                    Us=[None if U is None else jnp.asarray(U) for U in Us], batch=b != ())
    return t, jt


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-300)


_MARGINALS = [np.arange(1.0, 5), np.ones(5), np.array([1.0, 2, 1])]
CASES = {
    "hadamard_exact": lambda p, ts: p.hadamard_sum(ts),
    "hadamard_eig": lambda p, ts: p.hadamard_sum(ts, algorithm="eig"),
    "raw_moment_3": lambda p, ts: p.raw_moment(ts[0], 3),
    "raw_moment_exact": lambda p, ts: p.raw_moment(ts[0], 2, algorithm="exact"),
    "normalized_moment_exact": lambda p, ts: p.normalized_moment(ts[0], 4, algorithm="exact"),
    "raw_moment_marginals": lambda p, ts: p.raw_moment(ts[0], 3, marginals=_MARGINALS,
                                                       algorithm="exact"),
}
KINDS = {"hadamard_exact": ("plain", "tucker", "batch"), "raw_moment_exact": ("batch",)}


@pytest.mark.parametrize("case,kind", [(c, k) for c in CASES for k in KINDS.get(c, ("plain",))])
def test_moments_match_jax(case, kind):
    kw = dict(tucker=kind == "tucker", batch=2 if kind == "batch" else None)
    pairs = [_pair(seed, **kw) for seed in (1, 2, 3)]
    got = CASES[case](tn, [p[0] for p in pairs])
    want = CASES[case](jtn, [p[1] for p in pairs])
    assert isinstance(got, torch.Tensor) and got.shape == ((2,) if kind == "batch" else ())
    _close(got, want)


def test_rounded_moments_meet_the_exact_ones():
    t = _pair(8, tucker=True)[0]
    for k, eps in ((3, 1e-6), (4, 1e-12)):
        exact = tn.normalized_moment(t, k, algorithm="exact")
        for algorithm in ("eig", "svd"):
            got = tn.normalized_moment(t, k, eps=eps, algorithm=algorithm)
            assert abs(float(got) - float(exact)) <= 10 * eps * abs(float(exact))
    tb = _pair(9, batch=2)[0]
    _close(tn.raw_moment(tb, 3, marginals=_MARGINALS), tn.raw_moment(tb, 3, marginals=_MARGINALS,
                                                                     algorithm="exact"))


@pytest.mark.parametrize("algorithm", ["eig", "svd"])
def test_rounded_batch_is_its_samples(algorithm):
    ts = [_pair(seed, batch=2)[0] for seed in (1, 2, 3)]
    got = tn.hadamard_sum(ts, algorithm=algorithm, eps=1e-12)
    assert got.shape == (2,)
    for b in range(2):
        _close(got[b], tn.hadamard_sum([t[b] for t in ts], algorithm=algorithm, eps=1e-12))
    _close(got, tn.hadamard_sum(ts))  # and the exact contraction


def test_hadamard_sum_is_the_dense_sum():
    ts = [_pair(seed)[0] for seed in (4, 5, 6)]
    dense = np.prod([t.numpy() for t in ts], axis=0).sum()
    for algorithm in ("exact", "eig", "svd"):
        _close(tn.hadamard_sum(ts, algorithm=algorithm, eps=1e-12), dense)
    one_mode = [tn.Tensor([torch.arange(1.0, 4)[None, :, None]])] * 2
    _close(tn.hadamard_sum(one_mode, algorithm="eig"), 14.0)
    with pytest.raises(ValueError, match="equal shapes"):
        tn.hadamard_sum([ts[0], _pair(7, shape=(4, 5, 4))[0]])
