"""The port's learners (tntorch_tpu_torch/models/learners.py) and gradient
completion (`optimize`: exponential machines, BASELINE config 4) against the
JAX package's, at a reduced size, in float64 on the CPU.

The initial tensor and the bootstrap rows cannot be the JAX package's own
draws (``key=`` seeds torch generators here): the tests carry JAX's initial
tensor (``_make_tensor``) and rows (``_member_rows``) into the port's
learner. From there both run Adam (lr 1e-3, the default of either
package), and ``losses_`` over 30 steps agree within 1e-8 relative, as do
the predictions (the two Adams round differently; tests/test_torch_autodiff.py
sees 1e-10 over similar runs). `_batch_gather` on carried tensors and rows:
1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
import torch_parallel_ranks as ranks
from tntorch_tpu.models.learners import _batch_gather as jax_batch_gather
from tntorch_tpu_torch.models.learners import _batch_gather

TOL, LOSS_TOL = 1e-10, 1e-8
STEPS = 30


@pytest.fixture(autouse=True)
def _one_thread_float64():
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)  # the JAX side runs float64 (tests/conftest.py)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _carry(jt, **kw):
    """The port's Tensor of the JAX package's ``jt``: same arrays, flags and
    frozen factors."""
    t = tn.Tensor([torch.from_numpy(np.array(c)) for c in jt.cores],
                  Us=[None if U is None else torch.from_numpy(np.array(U)) for U in jt.Us],
                  batch=jt.batch, requires_grad=jt.requires_grad, **kw)
    t.frozen_Us = set(jt.frozen_Us)
    return t


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("tucker", [None, 3])
def test_batch_gather_matches_jax(tucker):
    jt = jtn.rand([3, 6, 5, 4], ranks_tt=2, ranks_tucker=tucker, batch=True,
                  key=jax.random.key(1))
    t = _carry(jt)
    rng = np.random.default_rng(0)
    rows = np.stack([rng.integers(0, s, (3, 40)) for s in (6, 5, 4)], axis=-1)  # (B, P, N)
    for idx in (rows, rows[0], rows[..., :2]):
        assert _rel(_batch_gather(t, torch.from_numpy(idx)),
                    jax_batch_gather(jt, jnp.asarray(idx))) <= TOL


def _smooth(P, N, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (P, N))
    return X, np.sin(2 * X[:, 0]) + X[:, 1] * X[:, -1]


def _spirals(P, seed):
    """examples/classification.py's two interleaved spirals."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(2, 10, P)[:, None]
    c0 = np.concatenate([r * np.cos(r), r * np.sin(r)], axis=1)
    c0 += rng.standard_normal(c0.shape) / 1.5
    X = np.concatenate([c0, -c0])
    return X, np.concatenate([np.zeros(P), np.ones(P)])


CASES = {
    "regressor_dct": ("TTRegressor", dict(ranks_tucker=3), "smooth"),
    "regressor_tt_kernel_path": ("TTRegressor", dict(ranks_tucker=None), "smooth"),
    "regressor_bagging": ("TTRegressor", dict(ranks_tucker=3, n_estimators=3), "smooth"),
    "classifier_dct": ("TTClassifier", dict(ranks_tucker=3), "spirals"),
    "classifier_bagging": ("TTClassifier", dict(ranks_tucker=None, n_estimators=2), "spirals"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_learner_matches_jax_from_a_carried_tensor_and_rows(case):
    cls, kw, data = CASES[case]
    X, y = _smooth(120, 3, 1) if data == "smooth" else _spirals(60, 2)
    common = dict(nticks=12, ranks_tt=3, max_iter=STEPS - 1, tol=0.0, **kw)
    jlearner = getattr(jtn, cls)(key=jax.random.key(3), **common)
    learner = getattr(tn, cls)(key=3, device="cpu", **common)
    # carry the JAX package's draws into the port's learner
    jmake, jrows = jlearner._make_tensor, jlearner._member_rows
    made = {}

    def make(shape):
        made["jax"] = jmake(shape)
        return _carry(made["jax"])

    learner._make_tensor = make
    learner._member_rows = lambda P: torch.from_numpy(np.array(jrows(P)))
    learner.fit(X, y)
    jlearner.fit(X, y)
    assert len(learner.losses_) == len(jlearner.losses_) == STEPS
    assert _rel(learner.losses_, jlearner.losses_) <= LOSS_TOL
    assert learner.losses_[-1] < learner.losses_[0]
    Xt = X[::3] * 0.9
    if cls == "TTRegressor":
        assert _rel(learner.predict(Xt), jlearner.predict(Xt)) <= LOSS_TOL
        assert abs(learner.score(X, y) - jlearner.score(X, y)) <= LOSS_TOL
    else:
        assert _rel(learner.predict_proba(Xt), jlearner.predict_proba(Xt)) <= LOSS_TOL
        assert np.array_equal(learner.predict(Xt), jlearner.predict(Xt))
    assert learner.tensor_.frozen_Us == made["jax"].frozen_Us


def test_learners_own_draws_and_errors():
    X, y = _smooth(100, 2, 4)
    fits = [tn.TTRegressor(nticks=8, ranks_tt=2, ranks_tucker=2, max_iter=5, key=key,
                           device="cpu").fit(X, y) for key in (5, 5, 6)]
    assert fits[0].losses_ == fits[1].losses_ != fits[2].losses_  # an int key seeds the draws
    g = torch.Generator().manual_seed(5)
    ens = tn.TTRegressor(nticks=8, ranks_tt=2, n_estimators=2, max_iter=5, key=g, device="cpu")
    ens.fit(X, y)
    assert ens.tensor_.batch and ens.tensor_.device.type == "cpu"
    with pytest.raises(ValueError, match="before predict"):
        tn.TTClassifier(device="cpu").predict_proba(X)
    with pytest.raises(ValueError, match="2 classes"):
        tn.TTClassifier(device="cpu").fit(X, np.zeros(len(X)))
    # mesh= on one rank changes no value (on four:
    # tests/test_torch_parallel_paths.py); a mesh without 'dp' is refused, as
    # in the JAX package
    with ranks.solo_mesh() as mesh:
        on_mesh = tn.TTRegressor(nticks=8, ranks_tt=2, ranks_tucker=2, max_iter=5, key=5,
                                 device="cpu", mesh=mesh).fit(X, y)
        with pytest.raises(ValueError, match="'dp' axis"):
            tn.TTRegressor(mesh=tn.parallel.make_mesh((1,), ("tp",), device="cpu"))
    assert on_mesh.losses_ == fits[0].losses_
    assert np.array_equal(on_mesh.predict(X).numpy(), fits[0].predict(X).numpy())
    assert tn.models.TTRegressor is tn.TTRegressor
    # the operators of models/matrix.py are ported (tests/test_torch_matrix.py)
    assert tn.models.TTMatrix is tn.models.matrix.TTMatrix is tn.TTMatrix


def test_exponential_machines_match_jax():
    """examples/exponential_machines.py, reduced: w[x] over 6 binary
    features, rank 3, cores x 0.3, Adam lr 1e-2, 30 steps."""
    rng = np.random.default_rng(0)
    N, P = 6, 200
    Xb = rng.integers(0, 2, (P, N))
    y = 1.5 * Xb[:, 0] - 2.0 * Xb[:, 1] + 0.8 * Xb[:, 2] * Xb[:, 3] + 0.1 * rng.standard_normal(P)
    jw = jtn.rand([2] * N, ranks_tt=3, requires_grad=True, key=jax.random.key(0))
    jw.cores = [c * 0.3 for c in jw.cores]
    w = _carry(jw)
    jX, jy, yt = jnp.asarray(Xb), jnp.asarray(y), torch.from_numpy(y)
    jhist = jtn.optimize([jw], lambda w: jnp.mean((w[jX].full() - jy) ** 2), tol=None,
                         max_iter=STEPS - 1, optimizer=optax.adam(1e-2), verbose=False)
    hist = tn.optimize([w], lambda w: torch.mean((w[Xb].full() - yt) ** 2), tol=None,
                       max_iter=STEPS - 1, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
                       verbose=False, block_iters=10)
    assert _rel(hist, jhist) <= LOSS_TOL and hist[-1] < hist[0]
    assert _rel(w.numpy(), jw.numpy()) <= LOSS_TOL
