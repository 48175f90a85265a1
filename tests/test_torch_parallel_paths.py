"""The port's ``mesh=`` paths (``cross``, the batched minimize,
``als_completion``, ``TTRegressor``/``TTClassifier``) and its sharded
checkpoint (``save_orbax_sharded``/``load_orbax_sharded``) against the
JAX package's and the port's single process, on the CPU in float64.

As in tests/test_torch_parallel.py, one module-scoped group of 4 gloo
ranks (`parallel.launch.Group`) runs every port-side case, its rank side in
tests/torch_parallel_ranks.py; the JAX side runs in this process on meshes
of ``jax.devices()[:4]``, on the same NumPy inputs. Tolerances:
- cross: the rank schedule, sample count and index sets equal, ``full()``
  within 1e-10 relative in norm (tests/test_torch_cross.py), every rank's
  run equal to rank 0's bitwise (the same values in the same order);
- the batched minimize and ALS: the single process's results bitwise (the
  same operations on the same values), JAX's ALS within 1e-10; the
  one-stream minimize's ranks run their samples as the single process's
  one stream runs them, so bitwise too;
- the fused cross with a mesh: the single process's fused run's ranks,
  samples and index sets on every rank, ``full()`` within 1e-10;
- the learners: predictions within rtol 1e-6 and atol 1e-9 of the single
  process (tests/test_parallel.py:294-321), the 30 losses within 1e-8 of
  JAX's ``mesh=`` fit (tests/test_torch_learners.py: the two Adams round
  differently), from JAX's carried initial tensor and bootstrap rows.

JAX's calls stay on one shape each (a JAX run compiles per shape and mesh).
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
import torch_parallel_ranks as ranks
from tntorch_tpu_torch.parallel import launch

CROSS = importlib.import_module("tntorch_tpu_torch.cross")  # tn.cross is the function
TOL = 1e-10
PRED_RTOL, PRED_ATOL = 1e-6, 1e-9
LOSS_TOL = 1e-8
STEPS = 30


@pytest.fixture(scope="module")
def group():
    with launch.Group(4, "gloo", device="cpu", timeout=300) as g:
        yield g


@pytest.fixture(autouse=True)
def _one_thread_float64():
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)  # the JAX side runs float64 (tests/conftest.py)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _jax_mesh(shape, names=("dp", "tp")):
    return jtn.parallel.make_mesh(shape, names, devices=jax.devices()[:4])


# The Hilbert tensor 1/sum(x) on a 12^4 grid without ties
# (tests/test_torch_cross.py): every fiber of 12 points divides by 4
_AXES = [np.sort(np.random.default_rng(5).uniform(1, 12, 12)) for _ in range(4)]
_FIXED = dict(ranks_tt=4, max_iter=2, seed=0)  # within the numerical rank
_ADAPTIVE = dict(eps=1e-6, seed=0, record_samples=True)


def _port_cross(kw):
    return tn.cross(function=ranks.hilbert, domain=_AXES, device="cpu", verbose=False,
                    return_info=True, **kw)


def _same_sets(info, sets):
    for key in ("lsets", "rsets", "left_locals"):
        assert len(info[key]) == len(sets[key])
        for a, b in zip(info[key], sets[key]):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=key)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_cross_mesh_matches_jax_and_one_process(group):
    jt, jinfo = jtn.cross(function=ranks.hilbert, domain=[jnp.asarray(a) for a in _AXES],
                          verbose=False, return_info=True, mesh=_jax_mesh((4,), ("dp",)),
                          suppress_warnings=True, **_FIXED)
    for kw in (_FIXED, _ADAPTIVE):
        outs = group.run(ranks.cross, (4,), _AXES, kw)
        t, info = _port_cross(kw)
        full, Rs, nsamples, sets, samples, calls = outs[0]
        for other in outs[1:]:  # every rank picked the same pivots
            assert np.array_equal(other[0], full) and other[1:3] == (Rs, nsamples)
            for key in sets:
                assert all(np.array_equal(a, b) for a, b in zip(other[3][key], sets[key]))
        assert Rs == [int(r) for r in info["Rs"]] and nsamples == info["nsamples"]
        _same_sets(info, sets)
        assert _rel(full, t.numpy()) <= TOL
        # one all-gather a sweep step, of its whole fibers' values
        steps = (2 * len(_AXES) - 1) * len(info["val_epss"])
        assert [name for name, _ in calls] == ["all_gather"] * steps
        if kw is _FIXED:
            assert Rs == [int(r) for r in jinfo["Rs"]] and nsamples == jinfo["nsamples"]
            _same_sets(jinfo, sets)
            assert _rel(full, np.asarray(jt.full())) <= TOL
        else:  # record_samples keeps the gathered values
            np.testing.assert_array_equal(samples, info["sample_values"])


def test_batched_minimize_shards_the_batch(group):
    cores = [np.random.default_rng(5).standard_normal((8,) + s)
             for s in ((1, 6, 2), (2, 6, 2), (2, 6, 1))]
    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=True)
    want = tn.minimum(t, seed=0).numpy()
    dense = t.numpy().reshape(8, -1)
    outs = group.run(ranks.minimize, (4,), cores, dict(seed=0))
    for m, a, calls, logged in outs:
        np.testing.assert_array_equal(m, want)
        assert a == [np.unravel_index(int(k), (6, 6, 6)) for k in dense.argmin(1)]
        # each rank runs two samples; one all-gather of the minima, one of the argmins
        assert [name for name, _ in calls] == ["all_gather", "all_gather"] and not logged
    np.testing.assert_allclose(want, dense.min(1), rtol=1e-12)
    # a batch that the axis does not divide: the JAX package's warning, unsharded
    two = [c[:2] for c in cores]
    for m, _, calls, logged in group.run(ranks.minimize, (4,), two, dict(seed=0)):
        np.testing.assert_array_equal(m, want[:2])
        assert not calls and logged and "mesh= ignored (batch size 2" in logged[0]


def _chunk_runs(kept, max_iter):
    """The iterations a fused run ran, speculative ones included, to keep
    ``kept``: chunks of 6, then 4 (cross._CHUNK_DEPTH_FIRST, _NEXT)."""
    ran = 0
    while ran < kept:
        ran += min(6 if ran == 0 else 4, max_iter - ran)
    return ran


def test_one_stream_minimize_shards_the_batch(group):
    # the one stream on each rank's two samples: bitwise the single
    # process's one stream; one all-gather of each chunk's read, then one
    # of the minima and one of the argmins
    cores = [np.random.default_rng(5).standard_normal((8,) + s)
             for s in ((1, 6, 2), (2, 6, 2), (2, 6, 1))]
    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=True)
    want = tn.minimum(t, seed=0, fuse=True).numpy()
    single = dict(CROSS._BATCHED_MIN_STATS)
    want_arg = tn.argmin(t, seed=0, fuse=True)
    assert single == {"onestream": True, "chunks": 2, "mesh_sharded": False}
    dense = t.numpy().reshape(8, -1)
    np.testing.assert_allclose(want, dense.min(1), rtol=0, atol=1e-10)
    for m, a, calls, arg_calls, logged, stats in group.run(ranks.minimize_one_stream, (4,),
                                                           cores, dict(seed=0)):
        np.testing.assert_array_equal(m, want)
        assert a == want_arg and not logged
        assert stats == dict(single, mesh_sharded=True)
        for c in (calls, arg_calls):
            assert [name for name, _ in c] == ["all_gather"] * (stats["chunks"] + 2)
    # a batch that the axis does not divide: the JAX package's warning, then
    # the one stream unsharded on every rank
    two = [c[:2] for c in cores]
    want2 = tn.minimum(tn.Tensor([torch.from_numpy(c) for c in two], batch=True), seed=0,
                       fuse=True).numpy()
    for m, _, calls, arg_calls, logged, stats in group.run(ranks.minimize_one_stream, (4,), two,
                                                           dict(seed=0)):
        np.testing.assert_array_equal(m, want2)
        assert not calls and not arg_calls
        assert stats["onestream"] and not stats["mesh_sharded"]
        assert len(logged) == 2 and "one-stream path unsharded" in logged[0]
        assert "mesh= ignored (batch size 2 is not divisible by mesh axis size 4)" in logged[0]


@pytest.mark.parametrize("kw", [_FIXED, dict(eps=1e-6, seed=0)], ids=["fixed", "adaptive"])
def test_fused_cross_mesh_matches_one_process(group, kw):
    t, info = _port_cross(dict(kw, fuse=True))
    assert info["fused"]
    runs = _chunk_runs(len(info["val_epss"]), kw.get("max_iter", 25))
    for full, Rs, nsamples, sets, calls, fused, kept in group.run(ranks.fused_cross, (4,), _AXES,
                                                                  kw):
        assert fused and kept == len(info["val_epss"])
        assert Rs == [int(r) for r in info["Rs"]] and nsamples == info["nsamples"]
        _same_sets(info, sets)
        assert _rel(full, t.numpy()) <= TOL
        # one all-gather a sweep step of every iteration run, speculative ones too
        assert [name for name, _ in calls] == ["all_gather"] * ((2 * len(_AXES) - 1) * runs)


def test_host_sweep_drops_the_mesh(group):
    want = tn.cross(function=ranks.hilbert, domain=_AXES, device="cpu", verbose=False,
                    fuse="host", seed=0).numpy()
    for full, logged in group.run(ranks.host_cross, _AXES):
        np.testing.assert_array_equal(full, want)
        assert logged[0].startswith("cross(mesh=...) with a host-locked function")
        assert logged[0].endswith("the fiber sharding request is dropped.")


def test_als_mesh_matches_jax(group):
    # tests/test_parallel.py:212-231 at 4 devices, from one carried x0
    rng = np.random.default_rng(2)
    N, I, R, P, niter = 3, 12, 3, 1500, 6
    X = rng.integers(0, I, (P, N))
    X[:I] = np.arange(I)[:, None]
    gt = jtn.rand([I] * N, ranks_tt=R, key=jax.random.key(0))
    y = np.asarray(gt.numpy())[tuple(X.T)]
    x0 = [rng.uniform(0, 1, ((1 if n == 0 else R), I, (1 if n == N - 1 else R)))
          for n in range(N)]
    want = jtn.als_completion(X, jnp.asarray(y), ranks_tt=R, shape=[I] * N, niter=niter,
                              verbose=False, x0=jtn.Tensor([jnp.asarray(c) for c in x0]),
                              mesh=_jax_mesh((4, 1))).numpy()
    one = tn.als_completion(X, torch.from_numpy(y), ranks_tt=R, shape=[I] * N, niter=niter,
                            verbose=False, x0=tn.Tensor([torch.from_numpy(c) for c in x0]))
    outs = group.run(ranks.als, (4, 1), X, y, x0, R, I, niter)
    for full, eps, calls in outs:
        np.testing.assert_array_equal(full, one.numpy())
        assert eps == outs[0][1]
        names = [name for name, _ in calls]
        # x0 from rank 0; per sweep one all-gather a core solve and one all-reduce
        assert names == ["broadcast"] * N + (["all_gather"] * (2 * N - 2)
                                              + ["all_reduce"]) * niter
    assert _rel(outs[0][0], np.asarray(want)) <= TOL
    assert _rel(outs[0][0], np.asarray(gt.numpy())) < 1e-2


def _smooth(P, N, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (P, N))
    return X, np.sin(2 * X[:, 0]) + X[:, 1] * X[:, -1]


def _spirals(P, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(2, 10, P)[:, None]
    c0 = np.concatenate([r * np.cos(r), r * np.sin(r)], axis=1)
    c0 += rng.standard_normal(c0.shape) / 1.5
    return np.concatenate([c0, -c0]), np.concatenate([np.zeros(P), np.ones(P)])


# name: (class, keywords, data, against JAX's mesh fit); every ensemble's
# 4 members and every single model's 120 samples divide by dp=4
LEARNERS = {
    "regressor_dct": ("TTRegressor", dict(ranks_tucker=3), "smooth", True),
    "regressor_bagging_tt_kernel_path": ("TTRegressor", dict(ranks_tucker=None, n_estimators=4),
                                         "smooth", False),
    "classifier_dct": ("TTClassifier", dict(ranks_tucker=3), "spirals", False),
    "classifier_bagging": ("TTClassifier", dict(ranks_tucker=3, n_estimators=4), "spirals",
                           True),
}


def _carry(jt):
    return ([np.array(c) for c in jt.cores], [None if U is None else np.array(U) for U in jt.Us],
            sorted(jt.frozen_Us), jt.batch)


@pytest.mark.parametrize("case", sorted(LEARNERS))
def test_learner_mesh_matches_one_process_and_jax(group, case):
    cls, kw, data, with_jax = LEARNERS[case]
    X, y = _smooth(120, 3, 1) if data == "smooth" else _spirals(60, 2)
    common = dict(nticks=12, ranks_tt=3, max_iter=STEPS - 1, tol=0.0, **kw)
    jlearner = getattr(jtn, cls)(key=jax.random.key(3), mesh=_jax_mesh((4, 1)), **common)
    jmake, jrows = jlearner._make_tensor, jlearner._member_rows
    shape = [12] * X.shape[1] + ([2] if cls == "TTClassifier" else [])
    carried = _carry(jmake(shape))
    rows = np.array(jrows(len(y))) if kw.get("n_estimators", 1) > 1 else None
    Xt = X[::3] * 0.9

    def make(_):
        cores, Us, frozen, batch = carried
        t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=batch, requires_grad=True,
                      Us=[None if U is None else torch.from_numpy(U) for U in Us])
        t.frozen_Us = set(frozen)
        return t

    one = getattr(tn, cls)(key=3, device="cpu", **common)
    one._make_tensor = make
    if rows is not None:
        one._member_rows = lambda P: torch.from_numpy(rows)
    one.fit(X, y)
    want = (one.predict_proba(Xt) if cls == "TTClassifier" else one.predict(Xt)).numpy()
    outs = group.run(ranks.learner, (4, 1), cls, common, X, y, carried, rows, Xt)
    n_params = len(carried[0]) + sum(U is not None and m not in carried[2]
                                     for m, U in enumerate(carried[1]))
    for losses, pred, calls, leaves in outs:
        assert losses == outs[0][0] and len(losses) == STEPS and losses[-1] < losses[0]
        np.testing.assert_allclose(pred, want, rtol=PRED_RTOL, atol=PRED_ATOL)
        assert all(leaves)  # each rank keeps the whole model as plain tensors
        # the rows' two broadcasts, the parameters' replication, then per
        # step one all-reduce a gradient and one of the loss
        names = [name for name, _ in calls]
        assert names == ["broadcast"] * (2 + n_params) + ["all_reduce"] * (n_params + 1) * STEPS
    np.testing.assert_allclose(outs[0][0], one.losses_, rtol=LOSS_TOL)
    if with_jax:  # its own draws: the carried tensor and rows
        jlearner.fit(X, y)
        got = np.asarray(outs[0][0])
        assert float(np.abs(got - jlearner.losses_).max() / np.abs(got).max()) <= LOSS_TOL


def test_learner_mesh_needs_a_dp_axis(group):
    for message in group.run(ranks.learner_without_dp):
        assert message.startswith("Learner mesh must have a 'dp' axis")


def test_orbax_sharded_restores_the_placements(group, tmp_path):
    """tests/test_parallel.py:269-290 at 4 devices: a dp-sharded batch TT
    with a Tucker factor, saved by each rank's shards, restores onto the
    mesh with its placements and without a mesh, and its sidecar is the
    JAX package's for the same layout."""
    rng = np.random.default_rng(1)
    cores = [rng.standard_normal(s) for s in ((8, 1, 5, 3), (8, 3, 4, 3), (8, 3, 6, 1))]
    Us = [None, rng.standard_normal((8, 7, 4)), None]
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=True,
                    Us=[None if U is None else jnp.asarray(U) for U in Us])
    jt.frozen_Us = {1}
    jtn.save_orbax_sharded(jtn.parallel.shard_batch(jt, _jax_mesh((4, 1))), tmp_path / "jax")
    outs = group.run(ranks.orbax, (4, 1), cores, Us, str(tmp_path / "port"))
    with open(tmp_path / "jax.specs.json") as a, open(tmp_path / "port.specs.json") as b:
        assert json.load(b) == json.load(a)
    for rank, (where, local, whole, Us_back, flat, frozen, batch, saved) in enumerate(outs):
        assert where == [[Shard(0), Replicate()]] * 3 and frozen == {1} and batch
        for a, b, c, d, e in zip(local, saved, whole, cores, flat):
            assert np.array_equal(a, b) and a.shape[0] == 2  # the rank's own shard
            assert np.array_equal(c, d) and np.array_equal(e, d)
        assert Us_back[0] is None and np.array_equal(Us_back[1], Us[1])
    with pytest.raises(ValueError, match="neither package loads the other's"):
        tn.load_orbax_sharded(tmp_path / "jax", device="cpu")
