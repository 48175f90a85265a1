"""The port's fused cross tier (tntorch_tpu_torch/cross.py, ``fuse=True``:
speculative chunks of iterations with one read back per chunk) against the
JAX package's fused chunks (tntorch_tpu/cross.py, ``fuse=True``), on the
same NumPy inputs and seeds, in float64 on the CPU.

Both packages stage a chunk's rank increases ahead in one draw order, so a
fused run must give the JAX package's fused run: its rank schedule ``Rs``,
sample count, number of iterations (``val_epss``, float32 in both, as the
chunk packs them) and index sets, and a ``full()`` within 1e-10 (relative,
in norm). The three JAX runs, each compiled once in a module fixture:

- a domain cross of the Hilbert tensor 1/sum(x) on a 12^4 grid without
  ties, kickrank 1 up to rmax 3, eps 1e-12 (never met) over 8 iterations:
  a first chunk of 6 with two rank increases inside it and a cap after
  them, then a chunk of 2 after an increase between chunks;
- a tensors cross of x**2 of a rank-2 TT (rank 3), converged in the first
  chunk's second iteration;
- the minimizing cross of a separable function on 16^4 at rmax 3 over 10
  iterations (chunks of 6 and 4).

Index sets are compared where the data decides every pivot: ranks within
the function's numerical rank, or capped below it (rmax 3 here; at rmax 4
the minimizing runs' left index sets already differ, decided by the last
bits of two LAPACK builds, while ranks, samples, minima and argmins agree).

A fused run equals the port's own eager run up to convergence: the eager
loop draws the same rows in the same order, only later.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn

CROSS = importlib.import_module("tntorch_tpu_torch.cross")  # tn.cross is the function
TOL = 1e-10
MIN_TOL = 1e-12

_RNG = np.random.default_rng(5)
_HILBERT_AXES = [np.sort(_RNG.uniform(1, 12, 12)) for _ in range(4)]
_A = (lambda rng: [rng.standard_normal(s) for s in ((1, 6, 2), (2, 5, 2), (2, 7, 2),
                                                    (2, 6, 1))])(np.random.default_rng(1))
_SHIFTS = (0.3, -0.1, 0.7, -0.5)
_GRID = np.linspace(-1, 1, 16)


@pytest.fixture(autouse=True)
def _one_thread_float64():
    # meshgrid casts to torch's default dtype: float64, as the JAX side runs
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _hilbert(*xs):
    return 1 / sum(xs)


def _separable(*xs):
    return sum((x - s) ** 2 for x, s in zip(xs, _SHIFTS))


# name: (the port's function, the JAX package's, inputs, keywords); the
# inputs are ("domain", axes), ("tensors", core lists) or ("grid", axis, N),
# the meshgrid tensors of one axis
CASES = {
    "domain": (_hilbert, _hilbert, ("domain", _HILBERT_AXES),
               dict(eps=1e-12, kickrank=1, rmax=3, max_iter=8, seed=0)),
    "tensors": (lambda x: x ** 2, lambda x: x ** 2, ("tensors", [_A]),
                dict(eps=1e-10, kickrank=2, seed=0)),
    "minimize": (_separable, _separable, ("grid", _GRID, 4),
                 dict(rmax=3, max_iter=10, seed=0, _minimize=True)),
}


def _run(package, function, inputs, kw, **extra):
    if inputs[0] == "domain":
        args = (dict(domain=inputs[1], device="cpu") if package is tn
                else dict(domain=[jnp.asarray(a) for a in inputs[1]]))
    elif inputs[0] == "tensors":
        args = dict(tensors=[tn.Tensor([torch.from_numpy(c) for c in cores]) if package is tn
                             else jtn.Tensor([jnp.asarray(c) for c in cores])
                             for cores in inputs[1]])
    else:
        axis, N = inputs[1], inputs[2]
        args = dict(tensors=tn.meshgrid([torch.from_numpy(axis)] * N, device="cpu")
                    if package is tn else jtn.meshgrid([jnp.asarray(axis)] * N))
    kw = dict(kw, **extra)
    kw.setdefault("fuse", True)
    return package.cross(function=function, verbose=False, return_info=True,
                         suppress_warnings=True, **args, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    with np.errstate(all="ignore"):
        return {name: _run(jtn, fj, inputs, kw) for name, (_, fj, inputs, kw) in CASES.items()}


def _same_sets(info, jinfo):
    for key in ("lsets", "rsets", "left_locals"):
        assert len(info[key]) == len(jinfo[key])
        for a, b in zip(info[key], jinfo[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_fused_cross_matches_jax_fused(case, jax_runs):
    ft, _, inputs, kw = CASES[case]
    (t, info), (jt, jinfo) = _run(tn, ft, inputs, kw), jax_runs[case]
    assert info["fused"] and jinfo["fused"]
    assert (info["callback"], info["host_pinned"], info["host_sweep"], info["compile_time"]) \
        == (False, False, False, 0)
    assert [int(r) for r in info["Rs"]] == [int(r) for r in jinfo["Rs"]]
    assert info["nsamples"] == jinfo["nsamples"]
    # both float32, from the same sweep; an exact interpolation's error is
    # roundoff, which two LAPACK builds give differently
    assert len(info["val_epss"]) == len(jinfo["val_epss"])
    np.testing.assert_allclose(info["val_epss"], jinfo["val_epss"], rtol=1e-6, atol=1e-12)
    _same_sets(info, jinfo)
    if kw.get("_minimize"):
        assert abs(info["min"] - jinfo["min"]) <= MIN_TOL
        assert info["argmin"] == tuple(int(x) for x in jinfo["argmin"])
        return
    got, want = t.numpy(), np.asarray(jt.full())
    assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want)


def test_fused_runs_the_chunks_it_should(jax_runs, monkeypatch):
    # The domain case: 8 iterations as chunks of 6 and 2, one packed read
    # each (the sweep's only `.tolist()`)
    reads = []
    tolist = torch.Tensor.tolist

    def counted(self):
        reads.append(tuple(self.shape))
        return tolist(self)

    ft, _, inputs, kw = CASES["domain"]
    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    _, info = _run(tn, ft, inputs, kw)
    monkeypatch.undo()
    assert len(info["val_epss"]) == 8
    assert [s[0] for s in reads] == [CROSS._CHUNK_DEPTH_FIRST, 2]


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_fused_equals_eager_up_to_convergence(case):
    # The eager sweep draws the same rows in the same order; only its
    # validation errors stay float64 (the fused chunk reads them as float32)
    ft, _, inputs, kw = CASES[case]
    (t, info), (te, einfo) = _run(tn, ft, inputs, kw), _run(tn, ft, inputs, kw, fuse=False)
    assert info["fused"] and not einfo["fused"]
    assert [int(r) for r in info["Rs"]] == [int(r) for r in einfo["Rs"]]
    assert info["nsamples"] == einfo["nsamples"]
    np.testing.assert_allclose(info["val_epss"], einfo["val_epss"], rtol=1e-6, atol=1e-12)
    _same_sets(info, einfo)
    if kw.get("_minimize"):
        assert (info["min"], info["argmin"]) == (einfo["min"], einfo["argmin"])
    else:
        # where the ranks stop growing inside a chunk, the fused sweep
        # carries its right interfaces and the eager one rebuilds them (as
        # in the JAX package): the same values up to roundoff
        got, want = t.numpy(), te.numpy()
        assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want)


@pytest.mark.parametrize("fmt", ["tt", "tucker", "cp", "cp_tucker"])
def test_fused_matches_eager_across_formats(fmt):
    # The JAX package's test_fused_matches_eager_across_formats, on the port
    kw = dict(tt=dict(ranks_tt=3), tucker=dict(ranks_tt=3, ranks_tucker=2),
              cp=dict(ranks_cp=3), cp_tucker=dict(ranks_cp=3, ranks_tucker=2))[fmt]
    torch.manual_seed(44)
    t = tn.randn(6, 7, 8, device="cpu", **kw)
    gt = t.numpy() * 2 + 1
    for seed in range(2):
        runs = [CROSS.cross(lambda x: x * 2 + 1, tensors=[t], verbose=False, seed=seed,
                            fuse=fuse, return_info=True) for fuse in (False, True)]
        for r, info in runs:
            assert np.linalg.norm(r.numpy() - gt) / np.linalg.norm(gt) <= 1e-6
        assert [int(r) for r in runs[0][1]["Rs"]] == [int(r) for r in runs[1][1]["Rs"]]


def test_fused_matrix_function_matches_eager():
    d = [torch.linspace(1, 16, 16, dtype=torch.float64)] * 4
    gt = 1.0 / sum(torch.meshgrid(*d, indexing="ij"))
    for fuse in (False, True):
        h = tn.cross(function=lambda M: 1.0 / M.sum(1), domain=d, function_arg="matrix",
                     eps=1e-6, verbose=False, seed=0, fuse=fuse)
        assert float(tn.relative_error(tn.Tensor(gt), h)) <= 1e-6


def _counting(f, bad_from, calls):
    """``f`` that returns NaN everywhere from its call number ``bad_from``
    (0-based) on; ``calls`` counts its calls."""
    def g(*xs):
        calls.append(1)
        out = f(*xs)
        return out * np.nan if len(calls) > bad_from else out

    return g


def test_nan_past_the_converged_iteration_is_ignored():
    # 1/sum(x) on 12^4 at eps 1e-6 converges in the first chunk's third
    # iteration: one call for the validation targets, then 7 per iteration
    # (2N - 1). NaN from the fourth iteration on reaches only speculative
    # iterations, which the chunk's selection drops.
    kw = dict(domain=_HILBERT_AXES, device="cpu", eps=1e-6, seed=0, verbose=False,
              return_info=True, fuse=True)
    t, info = tn.cross(function=_hilbert, **kw)
    assert len(info["val_epss"]) == 3
    calls = []
    t2, info2 = tn.cross(function=_counting(_hilbert, 1 + 7 * 3, calls), **kw)
    assert len(calls) == 1 + 7 * CROSS._CHUNK_DEPTH_FIRST  # the chunk ran in full
    assert (info2["Rs"] == info["Rs"]).all() and info2["val_epss"] == info["val_epss"]
    assert torch.equal(t2.full(), t.full())


def test_nan_before_the_converged_iteration_raises_jax_message():
    calls = []
    f = _counting(_hilbert, 1 + 7, calls)  # the second iteration's first step
    with pytest.raises(ValueError) as raised:
        tn.cross(function=f, domain=_HILBERT_AXES, device="cpu", eps=1e-6, seed=0,
                 verbose=False, fuse=True)
    assert str(raised.value) == ("Invalid return value (NaN/Inf) from function {} during "
                                 "cross-approximation".format(f))


def test_select_converged_matches_jax():
    jcross = importlib.import_module("tntorch_tpu.cross")
    epss = np.array([[0.3, 1e-3, 1e-7, np.nan], [0.2, 1e-7, 1e-8, 1.0]])
    finites = np.array([[True, True, True, False], [True, True, True, True]])
    # eps 1e-6 is met at iteration 2, before the NaN; 1e-9 is not, and
    # iteration 3 of sample 0 is not finite; so is iteration 1 then
    assert CROSS._select_converged(epss, finites, 1e-6, ("f", "x")) \
        == jcross._select_converged(epss, finites, 1e-6, ("f", "x")) == (2, True)
    assert CROSS._select_converged(epss, finites, 0.5, ("f", "x")) == (0, True)
    for sel in (CROSS._select_converged, jcross._select_converged):
        with pytest.raises(ValueError, match=r"Invalid return value \(NaN/Inf\) from function f"):
            sel(epss, finites, 1e-9, ("f", "x"))
        finites[0, 1] = False
        with pytest.raises(ValueError, match=r"during x"):
            sel(epss, finites, 1e-6, ("f", "x"))
        finites[0, 1] = True


def test_stage_chunk_draws_as_jax():
    jcross = importlib.import_module("tntorch_tpu.cross")
    Is, Rs = [6, 5, 7, 6], np.array([1, 1, 1, 1, 1])
    for kickrank in (2, None):
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        sched, extras = CROSS._stage_chunk(Rs, Is, 4, a, 5, kickrank, "cpu")
        jsched, jextras = jcross._stage_chunk(Rs, Is, 4, b, 5, kickrank)
        assert [list(s) for s in sched] == [list(s) for s in jsched]
        for e, je in zip(extras, jextras):
            assert len(e) == len(je) == len(Is) - 1
            for x, jx in zip(e, je):
                np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        assert a.integers(1 << 30) == b.integers(1 << 30)  # the streams stay in step


def test_auto_is_eager_on_the_cpu_and_mesh_keeps_the_eager_sweep():
    kw = dict(domain=_HILBERT_AXES, device="cpu", eps=1e-6, seed=0, verbose=False,
              return_info=True)
    assert not tn.cross(function=_hilbert, **kw)[1]["fused"]
    assert not tn.cross(function=_hilbert, record_samples=True, fuse=True, **kw)[1]["fused"]
    # a mesh now fuses too (each step's fibers sharded inside the chunk), as
    # in the JAX package, and gives the unsharded fused run
    with torch_parallel_ranks.solo_mesh() as mesh:
        t, info = tn.cross(function=_hilbert, mesh=mesh, fuse=True, **kw)
    t1, info1 = tn.cross(function=_hilbert, fuse=True, **kw)
    assert info["fused"] and info1["fused"]
    assert torch.equal(t.full(), t1.full()) and info["nsamples"] == info1["nsamples"]


@pytest.mark.cuda
def test_fused_chunk_reads_once_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the maxvol kernels have no CPU mode)")
    import warnings

    tn.cross(function=_hilbert, domain=_HILBERT_AXES, device="cuda", eps=1e-12, kickrank=1,
             rmax=3, max_iter=8, seed=0, verbose=False)  # build and warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, info = tn.cross(function=_hilbert, domain=[torch.from_numpy(a).cuda()
                                                          for a in _HILBERT_AXES],
                               eps=1e-12, kickrank=1, rmax=3, max_iter=8, seed=0,
                               verbose=False, return_info=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    assert info["fused"] and len(info["val_epss"]) == 8
    assert syncs == 2  # one packed read per chunk (6 + 2 iterations)
