"""The port's minimizing cross (``tn.minimum``, ``argmin``, ``maximum``,
``argmax``, ``cross(_minimize=True)``), ``cross(record_samples=True)``,
``cross_forward`` and ``Tensor(idxs=)`` against the JAX package and the
dense truth, in float64 on the CPU.

- The minimizing sweep of tests/test_cross.py:61-68's case (a 6 x 6 x 6
  rank-2 TT): the same minimum and maximum as the JAX package's to 1e-12
  relative, its argmin and argmax (the optimum is unique), and the dense
  ones.
- The separable 5-D function of tests/test_cross.py:116-140 on 32^5: the
  dense optimum within 1e-10 on the device path and on the
  ``record_samples`` host path, with the coordinates found.
- ``record_samples``: one column per input tensor, the values f of the
  positions, and, at ranks within the function's rank (where the data
  decides every pivot), the JAX package's samples to roundoff (1e-12 of
  the largest; the interfaces' einsums sum in another order); with
  ``_minimize`` (the host path) the device path's minimum and argmin.
- ``cross_forward`` on the JAX package's recorded index sets (carried by
  `interop.cross_info_from_arrays`): the JAX package's output to 1e-10 and
  the gradient of ``normsq`` to 1e-8 (``jax.grad`` against autograd).

JAX results are computed once per module, all on one 6 x 6 x 6 grid: a
JAX cross compiles per shape.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop

MIN_TOL = 1e-12  # the same run in both packages: roundoff only
SAMPLE_TOL = 1e-12
OPT_TOL = 1e-10  # the JAX package's own limit (tests/test_cross.py:116-140)
FORWARD_TOL, GRAD_TOL = 1e-10, 1e-8


@pytest.fixture(autouse=True)
def _one_thread_float64():
    # The JAX side runs float64 (tests/conftest.py: jax_enable_x64), and
    # meshgrid casts to each package's default dtype
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _cores(seed, shape, rank=2, batch=None):
    rng = np.random.default_rng(seed)
    ranks = [1] + [rank] * (len(shape) - 1) + [1]
    b = () if batch is None else (batch,)
    return [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _pair(cores, batch=False):
    return (tn.Tensor([torch.from_numpy(c) for c in cores], batch=batch),
            jtn.Tensor([jnp.asarray(c) for c in cores], batch=batch))


_MINMAX = _cores(5, (6, 6, 6))
_SQUARE = _cores(1, (6, 6, 6))
# x**2 of a rank-2 TT (rank 3) crossed at rank 3: within its rank, the
# data decides every pivot
_RECORD = dict(ranks_tt=3, max_iter=3, seed=0)


def _square(x):
    return x ** 2


@pytest.fixture(scope="module")
def jax_runs():
    _, jt = _pair(_MINMAX)
    _, jsq = _pair(_SQUARE)
    runs = {name: getattr(jtn, name)(jt, verbose=False, seed=0)
            for name in ("minimum", "argmin", "maximum", "argmax")}
    runs["record"] = jtn.cross(function=_square, tensors=[jsq], verbose=False,
                               return_info=True, record_samples=True, **_RECORD)

    def loss(cores):
        out = jtn.cross_forward(runs["record"][1], _square, tensors=[jtn.Tensor(cores)])
        return jtn.normsq(out), out.full()

    # one compiled program for the forward and the gradient
    (_, runs["forward"]), runs["grad"] = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        [jnp.asarray(c) for c in _SQUARE])
    return runs


def test_min_max_match_jax_and_dense(jax_runs):
    t, _ = _pair(_MINMAX)
    x = t.numpy()
    for name, dense in (("minimum", x.min()), ("maximum", x.max())):
        got, want = getattr(tn, name)(t, verbose=False, seed=0), jax_runs[name]
        assert isinstance(got, float)
        assert abs(got - float(want)) <= MIN_TOL * abs(float(want))
        assert abs(got - dense) <= MIN_TOL * abs(dense)
    for name, dense in (("argmin", x.argmin()), ("argmax", x.argmax())):
        got = getattr(tn, name)(t, verbose=False, seed=0)
        assert got == tuple(int(i) for i in jax_runs[name])
        assert got == np.unravel_index(dense, x.shape)


def test_minimize_info_holds_the_run():
    t, _ = _pair(_MINMAX)
    _, info = tn.cross(tensors=[t], verbose=False, seed=0, rmax=10, max_iter=10,
                       return_info=True, _minimize=True)
    assert len(info["val_epss"]) == 10  # the transformed sweep never meets eps
    assert [int(r) for r in info["Rs"]] == [1, 6, 6, 1]
    assert info["argmin"] == np.unravel_index(t.numpy().argmin(), t.shape)


def _separable():
    doms = [np.linspace(-1, 1, 32)] * 5
    shifts = [0.3, -0.1, 0.0, 0.7, -0.5]

    def f(*xs):
        return sum((x - s) ** 2 for x, s in zip(xs, shifts))

    dense_min = sum(((doms[0] - s) ** 2).min() for s in shifts)
    return doms, f, dense_min


def test_minimize_32pow5_device_and_host_paths():
    doms, f, dense_min = _separable()
    tensors = tn.meshgrid(doms, device="cpu")
    m = tn.minimum(function=f, tensors=tensors, verbose=False, seed=0)
    assert abs(m - dense_min) <= OPT_TOL
    am = tn.argmin(function=f, tensors=tensors, verbose=False, seed=0)
    g = torch.from_numpy(doms[0])
    assert abs(float(f(*[g[c] for c in am])) - dense_min) <= OPT_TOL
    _, info = tn.cross(function=f, tensors=tensors, rmax=10, max_iter=10, verbose=False, seed=0,
                       return_info=True, record_samples=True, _minimize=True)
    assert abs(info["min"] - dense_min) <= OPT_TOL
    assert abs(float(f(*[g[c] for c in info["argmin"]])) - dense_min) <= OPT_TOL


def test_batch_min_max_run_per_sample():
    cores = _cores(6, (6, 6, 6), batch=2)
    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=True)
    x = t.numpy()
    m, M = tn.minimum(t, verbose=False, seed=0), tn.maximum(t, verbose=False, seed=0)
    assert m.shape == (2,) and m.dtype == torch.float64
    np.testing.assert_allclose(m.numpy(), x.reshape(2, -1).min(1), rtol=MIN_TOL)
    np.testing.assert_allclose(M.numpy(), x.reshape(2, -1).max(1), rtol=MIN_TOL)
    assert tn.argmin(t, verbose=False, seed=0) == [
        np.unravel_index(x[b].argmin(), x.shape[1:]) for b in range(2)]
    assert tn.argmax(t, verbose=False, seed=0) == [
        np.unravel_index(x[b].argmax(), x.shape[1:]) for b in range(2)]
    with pytest.raises(ValueError, match="_minimize"):
        tn.cross(tensors=[t], verbose=False, _minimize=True)


def test_record_samples_match_jax(jax_runs):
    t, _ = _pair(_SQUARE)
    _, info = tn.cross(function=_square, tensors=[t], verbose=False, return_info=True,
                       record_samples=True, **_RECORD)
    want = jax_runs["record"][1]
    assert info["nsamples"] == want["nsamples"]
    assert info["sample_positions"].shape == (info["nsamples"], 1)
    for key in ("sample_positions", "sample_values"):
        np.testing.assert_allclose(info[key], want[key], rtol=0,
                                   atol=SAMPLE_TOL * np.abs(want[key]).max())
    # two inputs: one column each, the values f of the positions
    s, _ = _pair(_cores(2, (6, 6, 6)))
    _, info = tn.cross(function=lambda x, y: x * y, tensors=[t, s], verbose=False, seed=0,
                       return_info=True, record_samples=True)
    pos = info["sample_positions"]
    assert pos.shape == (info["nsamples"], 2)
    np.testing.assert_array_equal(info["sample_values"], pos[:, 0] * pos[:, 1])


def test_record_samples_minimize_finds_the_device_paths_optimum():
    t, _ = _pair(_MINMAX)
    runs = [tn.cross(tensors=[t], verbose=False, seed=0, rmax=10, max_iter=10, return_info=True,
                     record_samples=record, _minimize=True)[1] for record in (False, True)]
    assert abs(runs[1]["min"] - runs[0]["min"]) <= MIN_TOL * abs(runs[0]["min"])
    assert runs[1]["argmin"] == runs[0]["argmin"]
    assert runs[1]["nsamples"] == runs[0]["nsamples"] == len(runs[1]["sample_values"])


@pytest.mark.parametrize("record", [False, True])
def test_nan_guard_names_the_point(record):
    doms = [np.linspace(0, 1, 8)] * 3

    def f(x, y, z):
        return torch.where(x > 0.5, torch.nan, x + y + z)

    with pytest.raises(ValueError, match=r"Invalid return value for function .*: f\(0\.5"):
        tn.cross(function=f, tensors=tn.meshgrid(doms, device="cpu"), verbose=False, seed=0,
                 rmax=4, max_iter=3, _minimize=True, record_samples=record)


def test_cross_forward_matches_jax(jax_runs):
    jt2, jinfo = jax_runs["record"]
    info = interop.cross_info_from_arrays(jinfo, device="cpu")
    t = tn.Tensor([torch.from_numpy(c) for c in _SQUARE], requires_grad=True)
    out = tn.cross_forward(info, _square, tensors=[t])
    want = np.asarray(jax_runs["forward"])
    assert np.linalg.norm(out.numpy() - want) <= FORWARD_TOL * np.linalg.norm(want)
    assert np.linalg.norm(out.numpy() - np.asarray(jt2.full())) <= 1e-5 * np.linalg.norm(want)
    tn.normsq(out).backward()
    for c, g in zip(t.cores, jax_runs["grad"]):
        g = np.asarray(g)
        assert np.abs(c.grad.numpy() - g).max() <= GRAD_TOL * np.abs(g).max()


def test_cross_forward_replays_the_ports_own_run():
    t, _ = _pair(_SQUARE)
    t2, info = tn.cross(lambda x: x ** 2, tensors=[t], verbose=False, return_info=True, seed=1)
    t3, info = tn.cross_forward(info, lambda x: x ** 2, tensors=[t], return_info=True)
    assert float(tn.relative_error(t2, t3)) <= 1e-5  # tests/test_cross.py:36-41
    assert info["Xs"].shape == (sum(int(np.prod(s)) for s in info["shapes"]), 1)


def test_index_sets_follow_jax():
    cores = _cores(10, (3, 4, 5))
    t, jt = _pair(cores)
    assert [i.tolist() for i in t.idxs] == [i.tolist() for i in jt.idxs]
    tb = tn.Tensor([torch.from_numpy(c) for c in _cores(11, (3, 4, 5), batch=2)], batch=True)
    assert [i.tolist() for i in tb.idxs] == [[0, 1], [0, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3, 4]]
    given = [np.array([2, 0, 1]), torch.tensor([5, 6, 7, 8]), None]
    t = tn.Tensor(list(t.cores), idxs=given)
    jt = jtn.Tensor(list(jt.cores), idxs=[given[0], given[1].numpy(), None])
    for got, want in ((t, jt), (t.clone(), jt.clone()),
                      (t.decompress_tucker_factors(), jt.decompress_tucker_factors()),
                      (t.repeat(1, 1, 1, 2), jt.repeat(1, 1, 1, 2))):
        assert len(got.idxs) == len(want.idxs)
        for a, b in zip(got.idxs, want.idxs):
            assert (a is None and b is None) or (isinstance(a, np.ndarray)
                                                 and a.tolist() == b.tolist())
