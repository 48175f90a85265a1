"""The port's TT-cross (tntorch_tpu_torch/cross.py) against the JAX
package's eager sweep (tntorch_tpu/cross.py; on the CPU its default), on
the same NumPy inputs and seeds, in float64 on 4-D grids.

Both packages draw from ``np.random.default_rng(seed)`` in one order, so a
run must give the JAX package's rank schedule ``Rs``, sample count, number
of iterations and index sets (``lsets``, ``rsets``, ``left_locals``), and a
``full()`` within 1e-10 (relative, in norm) of the JAX package's.

Index sets are compared where the data decides every pivot: at ranks no
larger than the function's rank (sum of sines: 2; x^2 of a rank-2 TT: 3;
x*y of two: 4), or, for the Hilbert tensor 1/sum(x), within its numerical
rank at these sizes and on a grid without ties. Beyond the rank, a
pivot's column of Q is roundoff, and which row wins is decided by the last
bits of two LAPACK builds (on the CPU the ranks then agree and the
index sets do not); on a uniform grid, the symmetric Hilbert tensor has
fibers of equal value, whose order is decided the same way.

JAX results are computed once per module: a JAX cross compiles per shape.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch.ops import tt_eval as te

CROSS = importlib.import_module("tntorch_tpu_torch.cross")  # tn.cross is the function
TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread_float64():
    # The JAX side runs float64 (tests/conftest.py: jax_enable_x64), where
    # its meshgrid casts the domain to float64; torch's default dtype is
    # float32, so the port's meshgrid would cast to float32. The tests set
    # torch's default to float64 and restore it after, and the thread count
    # too.
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _tt(seed, batch=None, shape=(6, 5, 7, 6), rank=2):
    rng = np.random.default_rng(seed)
    ranks = [1] + [rank] * (len(shape) - 1) + [1]
    b = () if batch is None else (batch,)
    return [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _pair(cores, batch=False):
    return (tn.Tensor([torch.from_numpy(c) for c in cores], batch=batch),
            jtn.Tensor([jnp.asarray(c) for c in cores], batch=batch))


# A Hilbert tensor's grid without ties: other sorted random coordinates on
# each mode
_RNG = np.random.default_rng(5)
_HILBERT_AXES = [np.sort(_RNG.uniform(1, 12, 12)) for _ in range(4)]
_SINES_AXES = [np.linspace(0, 2 * np.pi, 16)] * 4
_A, _B = _tt(1), _tt(2)
_AB = _tt(3, batch=2)


def _hilbert(*xs):
    return 1 / sum(xs)


# name: (the port's function, the JAX package's, inputs, keywords); the
# inputs are ("domain", axes) or ("tensors", list of core lists, batch)
CASES = {
    "hilbert_domain": (_hilbert, _hilbert, ("domain", _HILBERT_AXES),
                       dict(eps=1e-6, seed=0)),
    "sines_domain": (lambda *xs: sum(torch.sin(x) for x in xs),
                     lambda *xs: sum(jnp.sin(x) for x in xs), ("domain", _SINES_AXES),
                     dict(eps=1e-10, seed=1, kickrank=1)),
    "square_tensors": (lambda x: x ** 2, lambda x: x ** 2, ("tensors", [_A], False),
                       dict(eps=1e-10, seed=0, kickrank=2)),
    "product_tensors": (lambda x, y: x * y, lambda x, y: x * y, ("tensors", [_A, _B], False),
                        dict(eps=1e-10, seed=0)),
    "fixed_ranks": (_hilbert, _hilbert, ("domain", _HILBERT_AXES),
                    dict(ranks_tt=4, max_iter=3, seed=0)),
    "batch": (lambda x: x ** 2, lambda x: x ** 2, ("tensors", [_AB], True),
              dict(eps=1e-10, seed=0, kickrank=2)),
}
# The port's matrix mode is held to the JAX package's run of the same
# function on vectors: its matrix mode only stacks them (the same seed, the
# same run), which saves one JAX cross
MATRIX = (lambda X: X[:, 0] * X[:, 1], "product_tensors")


def _run(package, function, inputs, kw, **extra):
    if inputs[0] == "domain":
        domain = inputs[1] if package is tn else [jnp.asarray(a) for a in inputs[1]]
        args = dict(domain=domain, device="cpu") if package is tn else dict(domain=domain)
    else:
        args = dict(tensors=[_pair(c, inputs[2])[0 if package is tn else 1] for c in inputs[1]])
    return package.cross(function=function, verbose=False, return_info=True, **args, **kw,
                         **extra)


@pytest.fixture(scope="module")
def jax_runs():
    with np.errstate(all="ignore"):
        return {name: _run(jtn, fj, inputs, kw)
                for name, (_, fj, inputs, kw) in CASES.items()}


def _same_run(got, want):
    t, info = got
    jt, jinfo = want
    assert [int(r) for r in info["Rs"]] == [int(r) for r in jinfo["Rs"]]
    assert info["nsamples"] == jinfo["nsamples"]
    assert len(info["val_epss"]) == len(jinfo["val_epss"])
    for key in ("lsets", "rsets", "left_locals"):
        assert len(info[key]) == len(jinfo[key])
        for a, b in zip(info[key], jinfo[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)
    assert (info["fused"], info["callback"], info["host_pinned"], info["host_sweep"],
            info["compile_time"]) == (False, False, False, False, 0)
    got_full, want_full = t.numpy(), np.asarray(jt.full())
    assert got_full.shape == want_full.shape
    assert np.linalg.norm(got_full - want_full) <= TOL * np.linalg.norm(want_full)


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_cross_matches_jax(case, jax_runs):
    ft, _, inputs, kw = CASES[case]
    got, want = _run(tn, ft, inputs, kw), jax_runs[case]
    if case == "batch":
        (t, infos), (jt, jinfos) = got, want
        assert t.batch and len(infos) == len(jinfos) == 2
        for b in range(2):
            _same_run((t[b], infos[b]), (jt[b], jinfos[b]))
        return
    assert got[0].device.type == "cpu" and got[0].dtype == torch.float64
    _same_run(got, want)


def test_matrix_argument_matches_jax(jax_runs):
    ft, case = MATRIX
    _same_run(_run(tn, ft, CASES[case][2], CASES[case][3], function_arg="matrix"),
              jax_runs[case])


def test_validation_goes_through_tt_eval(monkeypatch):
    # the inputs once, then the approximation once per iteration; every
    # point lies in range, so no call reads the out-of-range flag back
    calls = []
    tt_eval = te.tt_eval

    def counted(cores, X, **kw):
        calls.append(kw)
        return tt_eval(cores, X, **kw)

    monkeypatch.setattr(CROSS, "tt_eval", counted)
    ft, _, inputs, kw = CASES["hilbert_domain"]
    _, info = _run(tn, ft, inputs, kw)
    assert calls == [dict(checked=True)] * (4 + len(info["val_epss"]))


def test_tensors_of_other_shapes_raise():
    a, b = tn.rand((3, 4), device="cpu"), tn.rand((3, 5), device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        tn.cross(function=lambda x, y: x * y, tensors=[a, b], verbose=False)


def test_non_finite_values_raise():
    with pytest.raises(ValueError, match="NaN/Inf"):
        tn.cross(function=lambda *xs: 1 / sum(xs), domain=[np.arange(4.0)] * 3,
                 device="cpu", verbose=False)


def test_domain_without_a_device_goes_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no card")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tn.cross(function=lambda x, y: x + y, domain=[np.arange(4.0)] * 2, verbose=False)


@pytest.mark.cuda
def test_cross_on_cuda_runs_the_evaluation_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ft, _, inputs, kw = CASES["hilbert_domain"]
    cpu = _run(tn, ft, inputs, kw)
    te.reset_launches()
    t, info = tn.cross(function=ft, domain=inputs[1], verbose=False, return_info=True, **kw)
    assert t.device.type == "cuda"
    assert te.tt_eval_kernel.launches == 4 + len(info["val_epss"])
    assert [int(r) for r in info["Rs"]] == [int(r) for r in cpu[1]["Rs"]]
    assert info["nsamples"] == cpu[1]["nsamples"]
