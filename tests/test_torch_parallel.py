"""The port's parallel layer (tntorch_tpu_torch/parallel) against the JAX
package's (tntorch_tpu/parallel), on the CPU in float64.

The port runs one process per rank: one module-scoped group of 4 gloo
ranks (`parallel.launch.Group`) runs every port-side case, its rank side
in tests/torch_parallel_ranks.py. The JAX side runs in this process on
meshes of ``jax.devices()[:4]`` (the conftest's virtual devices), the
same mesh shapes, on the same NumPy inputs. Meshes (4, 1), (2, 2) and
(1, 4) of ('dp', 'tp'). Tolerances: 1e-12 relative on dense results and
values (roundoff of float64 sums in another order and of the Gram
sweeps' eigh on well-separated spectra); loss histories and trained cores
as tests/test_torch_autodiff.py holds Adam (1e-10, 1e-9). The collectives
are counted on every rank by `parallel.counting_collectives`, with the
data placed beforehand.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
import torch_parallel_ranks as ranks
from tntorch_tpu.ops import rounding as jr
from tntorch_tpu.parallel import mesh as jmesh
from tntorch_tpu_torch import parallel as par
from tntorch_tpu_torch.parallel import launch

MESHES = [(4, 1), (2, 2), (1, 4)]
TOL = 1e-12
LOSS_TOL, CORE_TOL = 1e-10, 1e-9  # tests/test_torch_autodiff.py


@pytest.fixture(scope="module")
def group():
    with launch.Group(4, "gloo", device="cpu", timeout=300) as g:
        yield g


def _jax_mesh(shape):
    return jtn.parallel.make_mesh(shape, ("dp", "tp"), devices=jax.devices()[:4])


def _tt(shape, ranks_, seed, batch=None):
    rng = np.random.default_rng(seed)
    r = [1] + list(ranks_) + [1]
    b = () if batch is None else (batch,)
    return [rng.standard_normal(b + (r[n], s, r[n + 1])) for n, s in enumerate(shape)]


def _full(cores):
    return np.asarray(jr.tt_full(tuple(jnp.asarray(c) for c in cores)))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _shards(x):
    """The JAX array's shard on each device id."""
    return {s.device.id: np.asarray(s.data) for s in x.addressable_shards}


def test_exports_and_rank_specs():
    names = [n for n in dir(jtn.parallel) if not n.startswith("_")
             and not isinstance(getattr(jtn.parallel, n), type(jtn))]
    assert set(names) <= set(par.__all__)
    for name in names:
        assert callable(getattr(par, name)), name
    # rank_specs is pure: JAX's PartitionSpecs as placements over the mesh dims
    rng = np.random.default_rng(0)
    names2 = ("dp", "tp")
    for N in (1, 2, 3, 4, 5):
        for batch in (False, True):
            b = (3,) if batch else ()
            tt = [rng.standard_normal(b + (2, 3, 2)) for _ in range(N)]
            cp = [rng.standard_normal(b + (3, 2)) for _ in range(N)]
            mixed = [tt[0], *cp[1:]]
            for cores in (tt, cp, mixed):
                want = [par.placements(tuple(s), names2)
                        for s in jmesh.rank_specs(cores, "tp", batch=batch)]
                assert par.rank_specs(cores, "tp", batch, names2) == want


@pytest.mark.parametrize("shape, dcn", [((1, 2), (2, 1)), ((2, 1), (1, 2)), ((1, 1), (2, 2)),
                                        ((2, 2), None), ((4, 1), None)])
def test_mesh_order_matches_jax(group, shape, dcn):
    want = _jax_mesh(shape) if dcn is None else jtn.parallel.make_mesh(
        shape, ("dp", "tp"), devices=jax.devices()[:4], dcn_shape=dcn)
    ids = np.vectorize(lambda d: d.id)(want.devices).tolist()
    assert all(got == ids for got in group.run(ranks.mesh_layout, shape, dcn))


@pytest.mark.parametrize("shape", MESHES)
def test_placements_match_jax(group, shape):
    # every placement function: each rank's shard is JAX's shard on the
    # device at the same mesh position, and the gathered whole is the input
    cores = _tt((4, 6, 4), (4, 4), 1, batch=8)
    Us = [np.random.default_rng(2).standard_normal((8, 5, 6)) if n == 1 else None
          for n in range(3)]
    array = np.random.default_rng(3).standard_normal((8, 8))
    jm = _jax_mesh(shape)
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], Us=[None if U is None else jnp.asarray(U)
                                                         for U in Us], batch=True)
    placed = {"replicate": jtn.parallel.replicate(jt, jm),
              "shard_ranks": jtn.parallel.shard_ranks(jt, jm),
              "shard_batch": jtn.parallel.shard_batch(jt, jm)}
    jarr = {"shard_array": jtn.parallel.shard_array(array, jm),
            "place": jax.device_put(jnp.asarray(array), jax.sharding.NamedSharding(
                jm, jax.sharding.PartitionSpec(None, "tp")))}
    dense = jt.numpy()
    for out in group.run(ranks.placements, shape, cores, True, Us, array):
        r = out["rank"]
        for name, p in placed.items():
            local, whole, factors = out[name]
            for c, lc, wc in zip(p.cores, local, whole):
                np.testing.assert_array_equal(lc, _shards(c)[r])
                np.testing.assert_array_equal(wc, np.asarray(c))
            if name == "shard_batch":  # the factors shard with the batch
                np.testing.assert_array_equal(factors[1][0], _shards(p.Us[1])[r])
                np.testing.assert_array_equal(factors[1][1], Us[1])
        for name, x in jarr.items():
            np.testing.assert_array_equal(out[name][0], _shards(x)[r])
            np.testing.assert_array_equal(out[name][1], array)
        a, row, scalar = out["replicate_pytree"]
        np.testing.assert_array_equal(a, array)
        np.testing.assert_array_equal(row, array[0])
        assert scalar == 3.0
        np.testing.assert_allclose(out["numpy"], dense, rtol=0, atol=TOL * np.abs(dense).max())


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_dot_and_norm_match_jax(group, shape):
    N, I, R = 4, 8, 4
    c1, c2 = _tt((I,) * N, (R,) * (N - 1), 4), _tt((I,) * N, (R,) * (N - 1), 5)
    jm = _jax_mesh(shape)
    ja = jtn.parallel.shard_ranks(jtn.Tensor([jnp.asarray(c) for c in c1]), jm)
    jb = jtn.parallel.shard_ranks(jtn.Tensor([jnp.asarray(c) for c in c2]), jm)
    want_dot = float(jtn.parallel.sharded_dot(ja, jb))
    want_norm = float(jtn.parallel.sharded_norm(ja))
    for how in ("ranks", "replicate"):
        for d, n, calls in group.run(ranks.dot, shape, c1, c2, False, how):
            assert abs(float(d) - want_dot) <= TOL * abs(want_dot)
            assert abs(float(n) - want_norm) <= TOL * want_norm
            # at most 2N collectives, none moving more than one core
            assert len(calls) <= 2 * N and all(size <= R * I * R for _, size in calls), calls
            assert how == "ranks" or not calls
    # batch tensors: each rank dots its samples; no collective
    b1, b2 = _tt((5, 5, 5), (3, 3), 6, batch=8), _tt((5, 5, 5), (3, 3), 7, batch=8)
    want = np.asarray(jtn.dot(jtn.Tensor([jnp.asarray(c) for c in b1], batch=True),
                              jtn.Tensor([jnp.asarray(c) for c in b2], batch=True)))
    for d, _, calls in group.run(ranks.dot, shape, b1, b2, True, "batch"):
        np.testing.assert_allclose(d, want, rtol=TOL)
        assert not calls


@functools.lru_cache(maxsize=1)
def _jax_forwards():
    """The forward cases (N = 4, 5, and an odd edge, 3, that tp does not
    divide: it stays replicated) and both JAX forwards of each on the (2, 2)
    mesh, where the alternating layout splits the even edges (each JAX
    program compiles in seconds; its values do not depend on the mesh)."""
    jm = _jax_mesh((2, 2))
    rng = np.random.default_rng(8)
    cases = [_tt((8,) * N, (4,) * (N - 1), 9 + N) for N in (4, 5)]
    cases.append([rng.standard_normal(s) for s in [(1, 5, 8), (8, 5, 3), (3, 5, 8), (8, 5, 1)]])
    out = []
    for cores in cases:
        X = rng.integers(0, cores[0].shape[1], (64, len(cores)))
        jc, jX = [jnp.asarray(c) for c in cores], jnp.asarray(X)
        out.append((cores, X, {how: np.asarray(getattr(jtn.parallel, how)(jc, jX, jm))
                               for how in ("tt_forward_sharded", "tt_forward_shard_map")}))
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_forwards_match_jax(group, shape):
    for cores, X, wants in _jax_forwards():
        for how, want in wants.items():
            for y, where, calls in group.run(ranks.forward, shape, cores, X, how):
                np.testing.assert_allclose(y, want, rtol=0, atol=TOL * np.abs(want).max())
                assert where == [Shard(0), Replicate()]
                # at tp > 1 the alternating layout: one all-reduce after each
                # odd core; at tp = 1 none
                reduces = [c for c in calls if c[0] == "all_reduce"]
                assert len(reduces) == (len(cores) // 2 if shape[1] > 1 else 0), calls


@pytest.mark.parametrize("case", ["8^4 tp=4", "6x10x7 tp=2", "per-edge ranks", "rand"])
def test_round_tt_gram_sharded_matches_jax(group, case):
    rng = np.random.default_rng(3)
    sketches = {}
    if case == "8^4 tp=4":
        shape, cores, rmax, solver = (1, 4), _tt((8, 8, 8, 8), (6, 6, 6), 3), 3, "eigh"
    elif case == "6x10x7 tp=2":  # modes that tp does not divide
        shape, cores, rmax, solver = (2, 2), _tt((6, 10, 7), (6, 6), 13), 3, "eigh"
    elif case == "per-edge ranks":
        shape, cores, rmax, solver = (1, 4), _tt((8, 8, 8), (5, 5), 4), (2, 3), "eigh"
    else:
        # rank 3 at a doubled representation (a + a), JAX's sketch patched
        # into the ranks (a monkeypatch does not cross a spawn)
        a = [rng.standard_normal(s) for s in [(1, 8, 3), (3, 8, 3), (3, 8, 1)]]
        ja = jtn.Tensor([jnp.asarray(c) for c in a])
        cores = [np.asarray(c) for c in (ja + ja).cores]
        shape, rmax, solver = (2, 2), 3, "rand"
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), 6), 3)
        sketches = {(6, 3): np.array(jax.random.normal(key, (6, 3), dtype=jnp.float64))}
    want = jtn.parallel.round_tt_gram_sharded([jnp.asarray(c) for c in cores], rmax,
                                              _jax_mesh(shape), axis="tp", edge_solver=solver)
    dense = _full([np.asarray(c) for c in want])
    N, R = len(cores), max(c.shape[-1] for c in cores)
    for out, where, calls in group.run(ranks.round_gram, shape, cores, rmax, solver, sketches):
        assert [c.shape for c in out] == [c.shape for c in want]
        assert _rel(_full(out), dense) <= TOL
        assert all(w == [Replicate(), Shard(1)] for w in where)
        # 2(N-1) all-reduces of Gram matrices at most R x R, nothing else
        assert {c[0] for c in calls} == {"all_reduce"} and len(calls) == 2 * (N - 1), calls
        assert all(size <= R * R for _, size in calls), calls
    if case == "rand":  # and the rounding recovers the rank-3 tensor
        assert _rel(dense, 2 * _full(a)) <= 1e-9


def test_round_tt_batch_sharded_matches_jax(group):
    cores = _tt((6, 6, 6), (5, 5), 5, batch=16)
    want = jtn.parallel.round_tt_batch_sharded([jnp.asarray(c) for c in cores], 3,
                                               _jax_mesh((4, 1)), axis="dp")
    want_dense = [_full([np.asarray(c[b]) for c in want]) for b in range(16)]
    for out, calls in group.run(ranks.round_batch, (4, 1), cores, 3):
        assert [c.shape for c in out] == [c.shape for c in want]
        for b in range(16):
            assert _rel(_full([c[b] for c in out]), want_dense[b]) <= TOL
        assert not calls  # no communication


def test_optimize_mesh_matches_jax(group):
    # the JAX test's problem: dp-sharded data, replicated cores, 30 Adam
    # steps at 1e-2, from the same cores
    rng = np.random.default_rng(0)
    N, I, R, B, steps = 3, 6, 4, 64, 30
    X = rng.integers(0, I, (B, N)).astype(np.int32)
    y = rng.standard_normal(B)
    cores = [rng.uniform(0, 1, s) for s in [(1, I, R), (R, I, R), (R, I, 1)]]
    jm = _jax_mesh((4, 1))
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], requires_grad=True)
    Xs, ys = jtn.parallel.shard_array(X, jm), jtn.parallel.shard_array(y, jm)
    want = jtn.optimize(jt, lambda t: jnp.mean((jtn.parallel.tt_batch_forward(list(t.cores), Xs)
                                                 - ys) ** 2),
                        optimizer=optax.adam(1e-2), max_iter=steps - 1, tol=None,
                        verbose=False, mesh=jm)
    want_full = np.asarray(jt.full())
    for shape in MESHES:
        for hist, trained, where in group.run(ranks.optimize, shape, cores, X, y, steps, 1e-2):
            assert len(hist) == steps
            np.testing.assert_allclose(hist, want, rtol=LOSS_TOL)
            assert _rel(_full(trained), want_full) <= CORE_TOL
            assert all(w == [Replicate(), Replicate()] for w in where)


def test_launch_surfaces_failures():
    # a rank's exception, with its traceback; the other rank is killed
    with pytest.raises(launch.RankError, match="rank 1 raised(.|\n)*rank one fails"):
        launch.run(ranks.fail_on_rank_one, 2, "gloo", device="cpu", timeout=120)
    # a call past its time limit kills the ranks
    with launch.Group(1, "gloo", device="cpu", timeout=120) as g:
        with pytest.raises(TimeoutError, match="did not answer within"):
            g.run(ranks.sleep, 60, timeout=1.0)
        with pytest.raises(RuntimeError, match="closed"):
            g.run(ranks.sleep, 0)
    # the backend and the device are the caller's: no silent switch
    with pytest.raises(RuntimeError, match="nccl"):
        launch.Group(2, "nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            launch.Group(2, "gloo")
