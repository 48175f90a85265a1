"""The port's NumPy host sweep, ``cross(fuse="host")``
(tntorch_tpu_torch/cross_host.py), against the JAX package's
(tntorch_tpu/cross_host.py), on the same NumPy function, grid and seed in
float64: a reduced BASELINE config 3 (the sum of sines, on 16^6 here), in
both ``function_arg`` modes and with ``record_samples``, in two modes:

- ``native``: both sweeps pivot on their host maxvol libraries, the C++
  swap loop on C = Q inv(Q[rows]) (the port's csrc/maxvol_host.cpp, the JAX
  package's csrc/maxvol.cpp), as users run them;
- ``plain``: the port's NumPy loop (`maxvol._maxvol_plain`, patched into
  ``cross_host._host_maxvol``) against the JAX package with its library
  patched out (``tntorch_tpu._native.get_lib`` -> None), so that both pivot
  with NumPy.

In each mode both sweeps run the same NumPy, SciPy and C++ calls on
bitwise equal inputs (meshgrid cores are ones and grid values). So the
rank schedule ``Rs``, the sample count, the iterations, the index sets
(``lsets``, ``rsets``, ``left_locals``) and the recorded samples are
equal, even past the function's rank of 2, and ``full()`` is within 1e-10
of JAX's. JAX results are computed once per module.
"""

import importlib
import logging

import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn

HOST = importlib.import_module("tntorch_tpu_torch.cross_host")
TOL = 1e-10
AXES = [np.linspace(0, 2 * np.pi, 16)] * 6


@pytest.fixture(autouse=True)
def _one_thread_float64():
    # The JAX side runs float64 (jax_enable_x64), where its meshgrid casts
    # the domain to float64; torch's meshgrid casts to torch's default,
    # which the tests set to float64 and restore after
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _sines(*xs):
    return sum(np.sin(x) for x in xs)


def _sines_matrix(X):
    return np.sin(X).sum(axis=1)


# name: (function, keywords)
CASES = {
    "vectors_record_samples": (_sines, dict(record_samples=True)),
    "matrix": (_sines_matrix, dict(function_arg="matrix")),
}


MODES = ["native", "plain"]
NATIVE = importlib.import_module("tntorch_tpu_torch._native")


def _run(package, case, **extra):
    function, kw = CASES[case]
    return package.cross(function=function, domain=AXES, fuse="host", seed=3, eps=1e-6,
                         verbose=False, return_info=True, **kw, **extra)


@pytest.fixture(scope="module")
def jax_runs():
    native = importlib.import_module("tntorch_tpu._native")
    assert native.get_lib() is not None
    runs = {("native", case): _run(jtn, case) for case in CASES}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "get_lib", lambda: None)
        runs.update({("plain", case): _run(jtn, case) for case in CASES})
    return runs


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_host_sweep_matches_jax(mode, case, jax_runs, monkeypatch):
    jt, jinfo = jax_runs[mode, case]
    if mode == "plain":
        monkeypatch.setattr(HOST, "_host_maxvol", importlib.import_module(
            "tntorch_tpu_torch.maxvol")._maxvol_plain)
    NATIVE.reset_calls()
    t, info = _run(tn, case, device="cpu")
    # the pivots ran where the mode says: on the library, or on NumPy only
    assert (sum(NATIVE.calls.values()) > 0) == (mode == "native")
    assert jinfo["host_sweep"] and info["host_sweep"] and not info["fused"]
    assert t.device.type == "cpu" and t.dtype == torch.float64
    assert [int(r) for r in info["Rs"]] == [int(r) for r in jinfo["Rs"]]
    assert info["nsamples"] == jinfo["nsamples"]
    assert len(info["val_epss"]) == len(jinfo["val_epss"]) and info["val_eps"] < 1e-6
    for key in ("lsets", "rsets", "left_locals"):
        for a, b in zip(info[key], jinfo[key]):
            if b is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if "record_samples" in CASES[case][1]:
        for key in ("sample_positions", "sample_values"):
            np.testing.assert_array_equal(info[key], np.asarray(jinfo[key]))
        assert info["sample_values"].size == info["nsamples"]
    got, want = t.numpy(), np.asarray(jt.numpy())
    assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want)


def test_host_sweep_transfers_and_other_paths(caplog):
    # one read down and one copy up, the cores viewed in one buffer
    a = tn.Tensor([torch.randn(1, 4, 2), torch.randn(2, 5, 1)])
    b = tn.Tensor([torch.randn(1, 4, 3), torch.randn(3, 5, 1)])
    down = HOST.download_cores([a, b])
    for cs, t in zip(down, (a, b)):
        assert all(np.array_equal(c, tc.numpy()) for c, tc in zip(cs, t.cores))
    up = HOST.upload_cores(down[0] + down[1], device="cpu")
    assert len({c.untyped_storage().data_ptr() for c in up}) == 1
    assert all(torch.equal(u, torch.from_numpy(c)) for u, c in zip(up, down[0] + down[1]))
    # the minimizing mode has no host sweep (the JAX package drops the
    # request there); mesh= logs the JAX package's warning and is dropped
    # before the sweep reads it (on ranks: tests/test_torch_parallel_paths.py)
    with pytest.raises(NotImplementedError, match="fuse='host'"):
        tn.cross(function=_sines, domain=AXES[:3], fuse="host", _minimize=True, device="cpu",
                 verbose=False)
    kw = dict(function=_sines, domain=AXES[:3], fuse="host", device="cpu", verbose=False, seed=0)
    with caplog.at_level(logging.WARNING, logger="tntorch_tpu_torch"):
        got = tn.cross(mesh="mesh", **kw)
    assert [r.getMessage() for r in caplog.records] == [
        "cross(mesh=...) with a host-locked function on a backend without host callbacks: "
        "the sweep runs on the host (NumPy); the fiber sharding request is dropped."]
    assert np.array_equal(got.numpy(), tn.cross(**kw).numpy())
    # a NaN names its point, as the eager sweep's message does
    with pytest.raises(ValueError, match="Invalid return value for function"):
        tn.cross(function=lambda *x: np.where(x[0] > 1.0, x[0], np.nan), domain=AXES[:3],
                 fuse="host", device="cpu", verbose=False)
