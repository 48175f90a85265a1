"""The port's training (tntorch_tpu_torch/autodiff.py: optimize, dof) and
random constructors (create.py: rand, randn) against the JAX package's.

optimize: the same numpy cores and completion data, f64, torch.optim.Adam
against optax.adam at the same learning rate. The two Adams are the same
formula; roundoff differs, so the loss histories agree to 1e-10 relative
and the trained TTs' dense values to 1e-9 relative over ~30 steps."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch.ops import tt_eval as te

LOSS_TOL, CORE_TOL = 1e-10, 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _completion(seed, shape=(8, 9, 7), rank=3, P=60, batch=0):
    """Initial cores, observed coordinates and values, as numpy."""
    rng = np.random.default_rng(seed)
    ranks = [1] + [rank] * (len(shape) - 1) + [1]
    b = (batch,) if batch else ()
    cores = [rng.uniform(0, 1, b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]
    X = np.stack([rng.integers(0, s, P) for s in shape], axis=1)
    return cores, X, rng.standard_normal(b + (P,))


def _both(cores, X, y, lr=None, **kw):
    """optimize() in both packages from the same cores (Adam, the default
    learning rate 1e-3 unless ``lr``); returns the two trained tensors and
    loss histories."""
    t = tn.Tensor([torch.from_numpy(c) for c in cores], requires_grad=True)
    yt = torch.from_numpy(y)
    opt = None if lr is None else (lambda ps: torch.optim.Adam(ps, lr=lr))
    hist = tn.optimize([t], lambda t: torch.mean((t[X].full() - yt) ** 2), optimizer=opt,
                       verbose=False, **kw)
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], requires_grad=True)
    jX, jy = jnp.asarray(X), jnp.asarray(y)
    jhist = jtn.optimize([jt], lambda t: jnp.mean((t[jX].full() - jy) ** 2),
                         optimizer=optax.adam(lr or 1e-3), verbose=False, **kw)
    return t, jt, hist, jhist


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_optimize_matches_jax_adam():
    cores, X, y = _completion(1)
    t, jt, hist, jhist = _both(cores, X, y, tol=None, max_iter=29)
    assert len(hist) == len(jhist) == 30  # tol=None: max_iter + 1 steps
    assert hist[-1] < hist[0]
    assert _rel(hist, jhist) <= LOSS_TOL
    assert _rel(t.numpy(), np.asarray(jt.full())) <= CORE_TOL
    assert all(c.is_leaf and c.requires_grad for c in t.cores)


def test_optimize_stops_where_jax_stops():
    # Adam at lr 0.05 on a small problem converges under tol=1e-3 within
    # max_iter: the same stopping step in both packages
    cores, X, y = _completion(2, shape=(4, 5), rank=2, P=15)
    t, jt, hist, jhist = _both(cores, X, y, tol=1e-3, max_iter=500, lr=0.05)
    assert len(hist) == len(jhist) < 501
    assert _rel(hist, jhist) <= 1e-8


def test_block_iters_runs_whole_blocks_and_matches_jax():
    cores, X, y = _completion(3)
    t, jt, hist, jhist = _both(cores, X, y, tol=None, max_iter=20, block_iters=8)
    assert len(hist) == len(jhist) == 24  # three blocks of 8
    assert _rel(hist, jhist) <= LOSS_TOL
    # the same steps as one at a time
    single, *_ = _both(cores, X, y, tol=None, max_iter=23)
    assert _rel(t.numpy(), single.numpy()) <= 1e-12


def test_batch_tensors_train_like_jax():
    cores, X, y = _completion(4, batch=2)
    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=True, requires_grad=True)
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=True, requires_grad=True)
    Xs = (slice(None),) + tuple(X.T)
    yt, jy = torch.from_numpy(y), jnp.asarray(y)
    hist = tn.optimize([t], lambda t: torch.mean((t[Xs].full() - yt) ** 2), tol=None,
                       max_iter=15, verbose=False)
    jhist = jtn.optimize([jt], lambda t: jnp.mean((t[Xs].full() - jy) ** 2), tol=None,
                         max_iter=15, verbose=False, optimizer=optax.adam(1e-3))
    assert _rel(hist, jhist) <= LOSS_TOL
    assert _rel(t.numpy(), np.asarray(jt.full())) <= CORE_TOL


def test_optimize_runs_tteval_every_step(monkeypatch):
    # t[X] of every mode evaluates through TTEval: one forward and one
    # backward wrapper call per step (plain versions here, on the CPU)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = te.tt_eval_kernel, te.tt_eval_backward_kernel

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(te, "tt_eval_kernel", count("fwd", fwd))
    monkeypatch.setattr(te, "tt_eval_backward_kernel", count("bwd", bwd))
    cores, X, y = _completion(5)
    t = tn.Tensor([torch.from_numpy(c) for c in cores], requires_grad=True)
    yt = torch.from_numpy(y)
    tn.optimize([t], lambda t: torch.mean((t[X].full() - yt) ** 2), tol=None, max_iter=4,
                verbose=False)
    assert calls == {"fwd": 5, "bwd": 5}


def test_dof_and_errors_match_jax():
    cores, X, y = _completion(6)
    t = tn.Tensor([torch.from_numpy(c) for c in cores], requires_grad=True)
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], requires_grad=True)
    assert tn.dof(t) == jtn.dof(jt) == sum(c.size for c in cores)
    frozen = tn.Tensor([torch.from_numpy(c) for c in cores])
    assert tn.dof(frozen) == jtn.dof(jtn.Tensor([jnp.asarray(c) for c in cores])) == 0
    with pytest.raises(ValueError, match="no parameters to optimize"):
        tn.optimize([frozen], lambda t: t.norm(), verbose=False)
    # mesh= runs (ROADMAP queue 1 item 12's ported part): on a one-rank
    # process group it gives the history without a mesh
    # (tests/test_torch_parallel.py holds it to JAX on 4 ranks)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = tn.parallel.make_mesh((1, 1), device="cpu")
        runs = [tn.optimize([tn.Tensor([torch.from_numpy(c) for c in cores], requires_grad=True)],
                            lambda t: torch.mean((t[X].full() - torch.from_numpy(y)) ** 2),
                            tol=None, max_iter=2, verbose=False, mesh=m) for m in (None, mesh)]
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(runs[1], runs[0], rtol=LOSS_TOL)
    with pytest.raises(ValueError, match="only train tn.Tensor inputs"):
        tn.optimize([torch.ones(3, requires_grad=True)], lambda x: x.sum(), verbose=False)
    # optimize writes the trained cores into the Tensor, not into shared storage
    src = [torch.from_numpy(c.copy()) for c in cores]
    u = tn.Tensor(src, requires_grad=True)
    v = u.clone()
    tn.optimize([v], lambda t: torch.mean((t[X].full() - torch.from_numpy(y)) ** 2),
                tol=None, max_iter=2, verbose=False)
    assert all(torch.equal(a, torch.from_numpy(c)) for a, c in zip(src, cores))
    assert all(torch.equal(a.detach(), torch.from_numpy(c)) for a, c in zip(u.cores, cores))
    assert not torch.equal(v.cores[0].detach(), u.cores[0].detach())


@pytest.mark.parametrize("fn, mean, var", [("rand", 0.5, 1 / 12), ("randn", 0.0, 1.0)])
def test_rand_and_randn(fn, mean, var):
    make = getattr(tn, fn)
    t = make([30, 40, 50], ranks_tt=[6, 7], device="cpu", generator=torch.Generator().manual_seed(0))
    j = getattr(jtn, fn)([30, 40, 50], ranks_tt=[6, 7])
    assert t.shape == tuple(j.shape) and t.ranks_tt.tolist() == j.ranks_tt.tolist() == [1, 6, 7, 1]
    assert t.device.type == "cpu" and t.dtype == torch.get_default_dtype()
    x = torch.cat([c.reshape(-1) for c in t.cores])
    assert abs(float(x.mean()) - mean) < 0.02 and abs(float(x.var()) - var) < 0.05 * max(var, 0.1)
    again = make([30, 40, 50], ranks_tt=[6, 7], device="cpu",
                 generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(t.cores, again.cores))
    # full ranks by default, batch, dtype and requires_grad as in the JAX package
    full = make([3, 4, 5], device="cpu", dtype=torch.float32, requires_grad=True)
    assert full.ranks_tt.tolist() == jtn.rand([3, 4, 5]).ranks_tt.tolist()
    assert full.dtype == torch.float32 and full.requires_grad and full.cores[0].is_leaf
    b = make([2, 3, 4, 5], batch=True, ranks_tt=2, device="cpu")
    jb = jtn.rand([2, 3, 4, 5], batch=True, ranks_tt=2)
    assert b.shape == tuple(jb.shape) and b.ranks_tt.tolist() == jb.ranks_tt.tolist()
    # CP ranks give CP factors, as in the JAX package
    cp = make([3, 4], ranks_cp=2, device="cpu")
    assert [tuple(c.shape) for c in cp.cores] == [(3, 2), (4, 2)]
    assert cp.ranks_tt.tolist() == getattr(jtn, fn)([3, 4], ranks_cp=2).ranks_tt.tolist()


def test_parallel_ports_only_tt_batch_forward():
    # every name of tntorch_tpu.parallel now resolves in the port, none a stub
    assert tn.parallel.tt_batch_forward is te.tt_batch_forward
    names = [n for n in dir(jtn.parallel) if not n.startswith("_")
             and not isinstance(getattr(jtn.parallel, n), type(jtn))]
    assert "make_mesh" in names and set(names) <= set(tn.parallel.__all__)
    for name in names:
        assert callable(getattr(tn.parallel, name)), name
    # the mesh= paths are all ported: no stub class is left
    assert not hasattr(tn.parallel, "ParallelNotPorted")
    assert not hasattr(tn.parallel, "__wrapped__")
