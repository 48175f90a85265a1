"""The port's one-stream batched minimize (``tn.minimum``, ``argmin``,
``maximum``, ``argmax`` of a batch with ``fuse=True``: every sample's
minimizing cross as one stream of chunks) against the JAX package's vmapped
one-stream path on the same NumPy inputs and seed, in float64 on the CPU.

- 3 rank-3 TTs on 8^3 (tests/test_cross.py:471-505's case, the cores drawn
  with NumPy): minima within 1e-12 of the JAX package's, absolute (the same
  run in both packages: roundoff only) and within 1e-10 of the dense minima (the
  JAX package's own limit), argmins equal, ``_BATCHED_MIN_STATS`` and the
  chunk count equal to the JAX package's; a ``function=`` case alike.
- The fallbacks to one cross per sample, each warning exactly where the
  JAX package warns (an unsupported keyword, a function that
  ``torch.func.vmap`` cannot map) and silent where it is silent
  (``fuse=False`` and "host", "auto" on the CPU, one mode), with
  ``suppress_warnings`` silencing the warnings; the vmap probe.
- The batch's validation values by one `tt_eval` on the batch laid out as
  one TT (`cross._batched_rows`, `_batched_values`): bitwise those of B
  separate `tt_eval_plain` calls.

The JAX package's vmapped chunk compiles once per shape and function:
its runs stay on one shape, each once, in a module fixture (~70 s).
"""

import importlib
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch.ops import tt_eval as te

CROSS = importlib.import_module("tntorch_tpu_torch.cross")  # tn.cross is the function
JCROSS = importlib.import_module("tntorch_tpu.cross")
# The same run in both packages: roundoff only, absolute (the atan
# transform's round trip tan(pi/2 - (pi/2 - atan(y))) errs by ~1e-16 at
# any value, so a minimum near 0 has no relative digits to compare)
MIN_TOL = 1e-12
DENSE_TOL = 1e-10  # the JAX package's own limit (tests/test_cross.py:471-505)
NAMES = ("minimum", "argmin", "maximum", "argmax")

_CORES = (lambda rng: [rng.standard_normal((3,) + s)
                       for s in ((1, 8, 3), (3, 8, 3), (3, 8, 1))])(np.random.default_rng(40))


def _square_shift(x):
    return (x - 1.2) ** 2


@pytest.fixture(autouse=True)
def _one_thread_float64():
    prev, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    torch.set_num_threads(threads)


def _port(cores=_CORES):
    return tn.Tensor([torch.from_numpy(c) for c in cores], batch=True)


@pytest.fixture(scope="module")
def jax_runs():
    bt = jtn.Tensor([jnp.asarray(c) for c in _CORES], batch=True)
    runs = {}
    for name, kw in [(n, {}) for n in NAMES] + [("function", dict(function=_square_shift))]:
        jfn = getattr(jtn, "minimum" if name == "function" else name)
        out = jfn(bt, fuse=True, seed=0, verbose=False, **kw)
        runs[name] = (out, dict(JCROSS._BATCHED_MIN_STATS))
    return runs


def _dense(f=lambda x: x):
    return f(_port().numpy().reshape(3, -1))


@pytest.mark.parametrize("name", NAMES + ("function",))
def test_one_stream_matches_jax_and_dense(name, jax_runs):
    want, jstats = jax_runs[name]
    kw = dict(function=_square_shift) if name == "function" else {}
    CROSS._BATCHED_MIN_STATS.update(onestream=False, chunks=0, mesh_sharded=True)
    got = getattr(tn, "minimum" if name == "function" else name)(_port(), fuse=True, seed=0,
                                                                  **kw)
    assert CROSS._BATCHED_MIN_STATS == jstats
    assert jstats["onestream"] and not jstats["mesh_sharded"]
    dense = _dense(_square_shift if name == "function" else lambda x: x)
    if name.startswith("arg"):
        assert got == [tuple(int(i) for i in a) for a in want]
        pick = dense.argmin(1) if name == "argmin" else dense.argmax(1)
        assert got == [np.unravel_index(k, (8, 8, 8)) for k in pick]
    else:
        assert isinstance(got, torch.Tensor) and got.shape == (3,) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MIN_TOL)
        opt = dense.max(1) if name == "maximum" else dense.min(1)
        np.testing.assert_allclose(got.numpy(), opt, rtol=0, atol=DENSE_TOL)


def test_one_stream_equals_its_loop_within_roundoff():
    # the per-sample loop (fuse=False) draws every sample's cross with the
    # seed alone, the one stream once for the batch: both find the optima
    one, loop = (tn.minimum(_port(), fuse=f, seed=0) for f in (True, False))
    np.testing.assert_allclose(one.numpy(), loop.numpy(), rtol=0, atol=DENSE_TOL)


def _logged(caplog, call):
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=tn.utils.logger.name):
        out = call()
    return out, [r.getMessage() for r in caplog.records
                 if "batched ensemble minimize: falling back" in r.getMessage()]


def _data_dependent(x):
    return x if bool(x.sum() > -1e9) else -x  # a read of a value: vmap cannot map it


@pytest.mark.parametrize("case", ["kwarg", "function", "fuse_false", "fuse_host", "auto_on_cpu",
                                  "one_mode"])
@pytest.mark.parametrize("suppress", [False, True])
def test_fallbacks_warn_where_jax_warns(case, suppress, caplog):
    t, kw, warns = _port(), dict(fuse=True, seed=0), False
    if case == "kwarg":  # record_samples: the JAX package's own example
        kw.update(record_samples=True)
        warns = "unsupported kwargs: ['record_samples']"
    elif case == "function":
        kw.update(function=_data_dependent)
        warns = "torch.func.vmap"
    elif case == "fuse_false":
        kw.update(fuse=False)
    elif case == "fuse_host":
        kw.update(fuse="host")
    elif case == "auto_on_cpu":
        kw.pop("fuse")
    else:
        t = _port([_CORES[0][:, :, :, :1]])
    if suppress:
        kw.update(suppress_warnings=True)
    CROSS._BATCHED_MIN_STATS["onestream"] = False
    if case == "fuse_host":  # the loop's crosses have no minimizing host sweep
        with pytest.raises(NotImplementedError):
            _logged(caplog, lambda: tn.minimum(t, **kw))
        assert not CROSS._BATCHED_MIN_STATS["onestream"]
        return
    got, logged = _logged(caplog, lambda: tn.minimum(t, **kw))
    assert not CROSS._BATCHED_MIN_STATS["onestream"]  # one cross per sample ran
    assert len(logged) == (1 if warns and not suppress else 0)
    if logged:
        assert warns in logged[0]
    dense = t.numpy().reshape(t.shape[0], -1)
    np.testing.assert_allclose(got.numpy(), dense.min(1), rtol=0, atol=DENSE_TOL)


def test_vmap_probe():
    probe = CROSS._maps_over_batch
    for f, K, ok in ((lambda x: x, 1, True), (_square_shift, 1, True),
                     (lambda x, y: 1 / (x + y), 2, True), (_data_dependent, 1, False),
                     (lambda x: torch.from_numpy(np.asarray(x)), 1, False),
                     (lambda x: x.item(), 1, False)):
        assert probe(f, K, torch.float64, torch.device("cpu")) is ok


def test_batched_validation_rows_match_separate_evaluations():
    rng = np.random.default_rng(3)
    B, Is, ranks = 4, (5, 7, 3, 6), (1, 2, 4, 3, 1)
    cores = [torch.from_numpy(rng.standard_normal((B, ranks[n], I, ranks[n + 1])))
             for n, I in enumerate(Is)]
    X = np.stack([rng.integers(0, I, 50) for I in Is], axis=1)
    rows = CROSS._batched_rows(X, B, Is)
    assert rows.shape == (B * 50, 4)
    for b in range(B):
        np.testing.assert_array_equal(rows[b * 50:(b + 1) * 50], X + b * np.array(Is))
    got = CROSS._batched_values(cores, torch.from_numpy(rows))
    want = torch.stack([te.tt_eval_plain([c[b] for c in cores], torch.from_numpy(X))
                        for b in range(B)])
    assert got.shape == (B, 50)
    assert torch.equal(got, want)
