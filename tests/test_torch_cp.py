"""CP tensors in the port (tntorch_tpu_torch/tensor.py, create.py, metrics.py,
tools.py, cross.py) against the JAX package, on the same NumPy inputs in
float64 on the CPU.

A core list may mix CP factors (I, R) with TT cores (R, I, R'); both
packages keep the layout through ``+``, ``*``, slicing and the tools, so
ranks and dense values are compared (contractions to 1e-12). CP-ALS is
compared in its parts: the HOSVD start by subspace projectors (``eigh``
fixes each column up to its sign, which torch and LAPACK via JAX choose
independently; ALS is equivariant under column signs), three sweeps from
the JAX package's start (1e-10), and the whole decomposition (1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu import tensor as jtensor
from tntorch_tpu_torch import interop
from tntorch_tpu_torch import tensor as ttensor

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _cores(seed, kinds, batch=0, shape=(4, 5, 6), R=3):
    """Cores of the layout ``kinds`` ('cp' or 'tt' per mode)."""
    rng = np.random.default_rng(seed)
    b = (batch,) if batch else ()
    cores = []
    for n, (kind, size) in enumerate(zip(kinds, shape)):
        if kind == "cp":
            cores.append(rng.standard_normal(b + (size, R)))
        else:
            rl = 1 if n == 0 else R
            rr = 1 if n == len(shape) - 1 else R
            cores.append(rng.standard_normal(b + (rl, size, rr)))
    return cores


def _pair(cores, batch=0, Us=None):
    t = interop.tensor_from_arrays(cores, Us=Us, batch=bool(batch), device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores],
                    Us=None if Us is None else [None if U is None else jnp.asarray(U)
                                                for U in Us], batch=bool(batch))
    return t, jt


def _dense(x):
    if hasattr(x, "cores"):
        x = x.full()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * max(np.linalg.norm(want), 1e-300)


LAYOUTS = {"cp": ["cp"] * 3, "cp_tt_cp": ["cp", "tt", "cp"], "tt_cp_tt": ["tt", "cp", "tt"],
           "tt_tt_cp": ["tt", "tt", "cp"]}
BATCH = pytest.mark.parametrize("batch", [0, 2], ids=["single", "batch2"])


@BATCH
@pytest.mark.parametrize("layout", LAYOUTS, ids=list(LAYOUTS))
def test_arithmetic_dot_and_full_match_jax(layout, batch):
    a, ja = _pair(_cores(1, LAYOUTS[layout], batch), batch)
    b, jb = _pair(_cores(2, ["cp"] * 3, batch), batch)
    c, jc = _pair(_cores(3, ["tt"] * 3, batch), batch)
    assert a.ranks_tt.tolist() == ja.ranks_tt.tolist()
    assert repr(a) == repr(ja)
    _close(a, ja)
    for got, want in [(a + b, ja + jb), (a * b, ja * jb), (a + c, ja + jc), (a * c, ja * jc),
                      (a - b, ja - jb), (a + 1.5, ja + 1.5), (2.5 * a, 2.5 * ja), (-a, -ja)]:
        assert got.ranks_tt.tolist() == want.ranks_tt.tolist()
        assert [x.ndim for x in got.cores] == [x.ndim for x in want.cores]
        _close(got, want)
    for x, jx in ((b, jb), (c, jc)):
        _close(tn.dot(a, x), jtn.dot(ja, jx))
        _close(tn.dot(x, a), jtn.dot(jx, ja))
    _close(tn.norm(a), jtn.norm(ja))
    _close(tn.dot(a, c, k=2), jtn.dot(ja, jc, k=2))
    if batch:  # one scalar per sample
        s = np.array([0.5, -2.0])
        _close(a * torch.from_numpy(s), ja * jnp.asarray(s))


@BATCH
@pytest.mark.parametrize("layout", LAYOUTS, ids=list(LAYOUTS))
def test_slicing_matches_jax(layout, batch):
    a, ja = _pair(_cores(4, LAYOUTS[layout], batch), batch)
    lead = (slice(None),) * (1 if batch else 0)
    for key in [(1,), (slice(1, 3), 2), (Ellipsis, 0), (2, 3, 1), ([0, 2, 1], [1, 1, 0]),
                (slice(None), [0, 1], [2, 3]), (None, 1), (slice(None, None, -1), 0)]:
        got, want = a[lead + key], ja[lead + key]
        _close(got, want)
    if batch:
        _close(a[1, 2], ja[1, 2])


@pytest.mark.parametrize("layout", LAYOUTS, ids=list(LAYOUTS))
def test_evaluation_converts_to_tt_and_goes_through_tt_eval(layout, monkeypatch):
    from tntorch_tpu_torch.ops import tt_eval as te

    a, ja = _pair(_cores(5, LAYOUTS[layout]))
    X = np.random.default_rng(6).integers(0, 4, (64, 3))
    calls = []
    real = te.tt_eval
    monkeypatch.setattr(te, "tt_eval", lambda cores, X, **kw: calls.append(
        [c.ndim for c in cores]) or real(cores, X, **kw))
    got = a[X]
    assert calls == [[3, 3, 3]]  # the TT view's cores
    _close(got.full().reshape(-1), ja[X].full().reshape(-1))
    _close(a[[X[:, 0], X[:, 1], X[:, 2]]].full().reshape(-1), ja[X].full().reshape(-1))


def test_tt_view_and_cp_to_tt_match_jax():
    for layout in LAYOUTS.values():
        a, ja = _pair(_cores(7, layout))
        t, jt = a.tt(), ja.tt()
        assert [tuple(c.shape) for c in t.cores] == [tuple(c.shape) for c in jt.cores]
        _close(t, jt)
        assert [c.ndim for c in a.cores] == [2 if k == "cp" else 3 for k in layout]  # a copy
        factor = a.cores[1] if layout[1] == "cp" else torch.from_numpy(_cores(8, ["cp"] * 3)[1])
        _close(a._cp_to_tt(factor), ja._cp_to_tt(jnp.asarray(factor.numpy())))


def test_cp_with_tucker_factors_matches_jax():
    rng = np.random.default_rng(9)
    cores = [rng.standard_normal((2, 3)), rng.standard_normal((3, 4, 3)),
             rng.standard_normal((3, 3))]
    Us = [rng.standard_normal((5, 2)), None, rng.standard_normal((6, 3))]
    a, ja = _pair(cores, Us=Us)
    b, jb = _pair(_cores(10, ["cp"] * 3, shape=(5, 4, 6)), Us=None)
    _close(a, ja)
    assert repr(a) == repr(ja)
    for got, want in [(a + b, ja + jb), (a * b, ja * jb), (a + a, ja + ja), (a * a, ja * ja)]:
        _close(got, want)
    _close(tn.dot(a, b), jtn.dot(ja, jb))
    _close(tn.dot(a, a), jtn.dot(ja, ja))
    for key in [(1,), (slice(1, 3), 2), (2, 3, 1), ([0, 2], [1, 3], [4, 5])]:
        _close(a[key], ja[key])
    _close(a.decompress_tucker_factors(), ja.decompress_tucker_factors())
    t = a.clone()
    t.factor_orthogonalize(0)
    _close(t, ja)


@pytest.mark.parametrize("name", ["transpose", "flip", "cat", "pad", "mask", "ttm", "sum",
                                  "mean", "hadamard_sum", "unbind", "round_tt", "interop"])
def test_tools_and_metrics_on_cp_match_jax(name):
    a, ja = _pair(_cores(11, ["cp", "tt", "cp"]))
    b, jb = _pair(_cores(12, ["cp"] * 3))
    if name == "transpose":
        got, want = tn.transpose(a), jtn.transpose(ja)
        assert [x.ndim for x in got.cores] == [x.ndim for x in want.cores]
    elif name == "flip":
        got, want = tn.flip(a, [0, 1]), jtn.flip(ja, [0, 1])
    elif name == "cat":
        got, want = tn.cat([a, b], dim=1), jtn.cat([ja, jb], dim=1)
    elif name == "pad":
        got, want = tn.pad(a, [6, 7], dim=[0, 2]), jtn.pad(ja, [6, 7], dim=[0, 2])
    elif name == "mask":
        m, jm = _pair(_cores(13, ["cp"] * 3))
        got, want = tn.mask(a, m), jtn.mask(ja, jm)
    elif name == "ttm":
        U = np.random.default_rng(14).standard_normal((3, 4))
        got, want = tn.ttm(a, torch.from_numpy(U), 0), jtn.ttm(ja, jnp.asarray(U), 0)
    elif name == "sum":
        got, want = tn.sum(a), jtn.sum(ja)
    elif name == "mean":
        got, want = tn.mean(b, dim=[0, 2]), jtn.mean(jb, dim=[0, 2])
    elif name == "hadamard_sum":
        got, want = tn.hadamard_sum([a, b, a]), jtn.hadamard_sum([ja, jb, ja])
    elif name == "unbind":
        for got, want in zip(tn.unbind(a, 1), jtn.unbind(ja, 1)):
            _close(got, want)
        return
    elif name == "round_tt":  # rounding converts to the TT view first
        got, want = tn.round_tt(a + a, eps=1e-10), jtn.round_tt(ja + ja, eps=1e-10)
        assert got.ranks_tt.tolist() == want.ranks_tt.tolist()
    else:
        arrays = interop.tensor_to_arrays(a)
        assert [x.shape for x in arrays] == [tuple(np.shape(c)) for c in ja.cores]
        got, want = interop.tensor_from_arrays(arrays, device="cpu"), ja
    _close(got, want)


def _draws_from(arrays):
    """A draw function for `create._create` that hands out ``arrays`` (the
    JAX package's cores, in its order) and checks each shape."""
    queue = list(arrays)

    def draw(shape, generator=None, dtype=None, device=None):
        x = queue.pop(0)
        assert tuple(shape) == x.shape
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    return draw


@pytest.mark.parametrize("ranks", [dict(ranks_cp=3), dict(ranks_cp=[2, None, None],
                                                            ranks_tt=[None, 4]),
                                   dict(ranks_cp=3, ranks_tucker=[2, None, 3])],
                         ids=["cp", "hybrid", "cp_tucker"])
def test_randn_ranks_cp_carries_jax_numbers(ranks):
    from tntorch_tpu_torch.create import _create

    for batch in (False, True):
        shape = (2, 5, 6, 7) if batch else (5, 6, 7)
        jt = jtn.randn(shape, batch=batch, key=jax.random.key(15), **ranks)
        drawn = [np.array(x) for pair in zip(jt.Us, jt.cores) for x in pair if x is not None]
        t = _create(_draws_from(drawn), shape, batch=batch, device="cpu",
                    dtype=torch.float64, **ranks)
        assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
        assert [tuple(c.shape) for c in t.cores] == [tuple(c.shape) for c in jt.cores]
        _close(t, jt, 1e-14)
    own = tn.randn(5, 6, 7, ranks_cp=3, device="cpu")
    assert [tuple(c.shape) for c in own.cores] == [(5, 3), (6, 3), (7, 3)]
    with pytest.raises(ValueError, match="incompatible"):
        tn.randn(5, 6, ranks_cp=2, ranks_tt=2, device="cpu")


def _planted(seed, shape=(8, 9, 10), R=3, batch=0, noise=0.1):
    rng = np.random.default_rng(seed)
    b = (batch,) if batch else ()
    factors = [rng.standard_normal(b + (s, R)) for s in shape]
    x = np.einsum("...ir,...jr,...kr->...ijk", *factors)
    return x + noise * rng.standard_normal(x.shape) * np.sqrt(R)


@BATCH
def test_hosvd_factors_match_jax_by_projectors(batch):
    x = _planted(16, batch=batch)
    for R in (3, 12):  # 12 > 8: mode 0 keeps 8 columns
        want = jtensor._cp_hosvd_factors(jnp.asarray(x), R, bool(batch))
        got = ttensor._cp_hosvd_factors(torch.from_numpy(x), R, bool(batch))
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape
            proj = g @ np.swapaxes(g, -1, -2) - w @ np.swapaxes(w, -1, -2)
            assert np.abs(proj).max() <= 1e-10


@BATCH
def test_als_sweeps_from_jax_start_match_jax(batch):
    x = _planted(17, batch=batch)
    start = jtensor._cp_hosvd_factors(jnp.asarray(x), 3, bool(batch))
    red = tuple(range(1, x.ndim)) if batch else None
    jc, normsq = start, jnp.sum(jnp.asarray(x) ** 2, axis=red)
    pc = tuple(torch.from_numpy(np.array(f)) for f in start)
    pn = torch.from_numpy(np.array(normsq))
    for _ in range(3):
        jc, jrel = jtensor._cp_als_iter(jnp.asarray(x), jc, normsq, bool(batch))
        pc, prel = ttensor._cp_als_iter(torch.from_numpy(x), pc, pn, bool(batch))
        assert abs(float(prel) - float(jrel)) <= 1e-10 * float(jrel)
        _close(tn.Tensor(list(pc), batch=bool(batch)),
               jtn.Tensor(list(jc), batch=bool(batch)), 1e-10)


def test_cp_als_end_to_end_matches_jax():
    x = _planted(18)
    t = tn.Tensor(torch.from_numpy(x), ranks_cp=3)
    jt = jtn.Tensor(jnp.asarray(x), ranks_cp=3)
    assert [c.shape for c in t.cores] == [tuple(c.shape) for c in jt.cores]
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist() == [3, 3, 3, 3]
    _close(t, jt, 1e-8)
    xb = _planted(19, batch=2)
    tb = tn.Tensor(torch.from_numpy(xb), ranks_cp=3, batch=True)
    jtb = jtn.Tensor(jnp.asarray(xb), ranks_cp=3, batch=True)
    _close(tb, jtb, 1e-8)
    with pytest.raises(ValueError, match="CP-TT"):
        tn.Tensor(torch.from_numpy(x), ranks_cp=3, ranks_tt=2)
    with pytest.raises(ValueError, match="not both"):
        tn.Tensor(torch.from_numpy(x), ranks_cp=3, eps=1e-3)


def _patch_draws(monkeypatch, seed):
    """The same standard-normal numbers for both packages' random CP
    factors, drawn once per shape from NumPy: the port's
    `_cp_random_factors` and the JAX package's ``jax.random.normal``."""
    rng = np.random.default_rng(seed)
    drawn = {}

    def draws(shape):
        if shape not in drawn:
            drawn[shape] = rng.standard_normal(shape)
        return drawn[shape]

    monkeypatch.setattr(ttensor, "_cp_random_factors", lambda shapes, R, like: [
        torch.from_numpy(draws(tuple(s) + (R,))) for s in shapes])
    monkeypatch.setattr(jtensor.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(draws(tuple(shape))))


def test_cp_als_pads_with_the_random_helper(monkeypatch):
    """R > I_n: the HOSVD keeps I_n columns and `_cp_random_factors` draws
    the rest; with the same draws in both, the two decompositions agree."""
    _patch_draws(monkeypatch, 21)
    x = _planted(20, shape=(3, 4, 5), R=2)
    t = tn.Tensor(torch.from_numpy(x), ranks_cp=5, max_iter=10)
    jt = jtn.Tensor(jnp.asarray(x), ranks_cp=5, max_iter=10)
    assert [tuple(c.shape) for c in t.cores] == [(3, 5), (4, 5), (5, 5)]
    _close(t, jt, 1e-8)


def test_cp_on_a_tucker_core(monkeypatch):
    """``ranks_cp`` with ``ranks_tucker``: CP-ALS of the Tucker core from a
    random start, the factors kept. With the same draws in both packages,
    and Tucker cores that agree (the CPU's LAPACK picks the same singular
    vector signs for both), the decompositions agree."""
    _patch_draws(monkeypatch, 3)
    x = _planted(22)
    core = tn.Tensor(torch.from_numpy(x), ranks_tucker=4).tucker_core()
    _close(core, jtn.Tensor(jnp.asarray(x), ranks_tucker=4).tucker_core(), 1e-12)
    t = tn.Tensor(torch.from_numpy(x), ranks_cp=3, ranks_tucker=4, max_iter=50)
    jt = jtn.Tensor(jnp.asarray(x), ranks_cp=3, ranks_tucker=4, max_iter=50)
    assert repr(t) == repr(jt)
    assert [tuple(U.shape) for U in t.Us] == [(8, 4), (9, 4), (10, 4)]
    _close(t, jt, 1e-8)
    assert float(tn.relative_error(torch.from_numpy(x), t)) < 0.1  # the planted noise: ~7%


def test_cross_of_a_cp_tensor_matches_jax():
    """The port's cross takes the CP tensor's TT view; the JAX package
    contracts the CP factors as they are. The values at every sample agree
    to roundoff, so the runs pick the same pivots (ranks within the
    function's: x^2 of a rank-2 CP tensor has rank 3)."""
    a, ja = _pair(_cores(23, ["cp"] * 3, shape=(6, 7, 8), R=2))
    kw = dict(function=lambda x: x ** 2, eps=1e-10, seed=0, kickrank=2, verbose=False,
              return_info=True)
    t, info = tn.cross(tensors=[a], **kw)
    jt, jinfo = jtn.cross(tensors=[ja], **kw)
    assert [int(r) for r in info["Rs"]] == [int(r) for r in jinfo["Rs"]]
    assert info["nsamples"] == jinfo["nsamples"]
    for key in ("lsets", "rsets", "left_locals"):
        for x, y in zip(info[key], jinfo[key]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=key)
    _close(t, jt, 1e-10)
    _close(t, _dense(a) ** 2, 1e-10)
    # the elementwise family rides the same path
    _close(tn.exp(a * 0.1, eps=1e-10), np.exp(0.1 * _dense(a)), 1e-8)


@pytest.mark.cuda
def test_cp_evaluation_and_field_rounding_launch_the_kernels_on_cuda():
    """On the card, ``t[X]`` of a CP tensor runs the ``tt_eval`` kernel and
    rounding a batch of divergences runs the three Gram kernels, each
    against the same call on the CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tntorch_tpu_torch.ops import gram_kernels as gk
    from tntorch_tpu_torch.ops import tt_eval as te

    a, _ = _pair(_cores(30, ["cp"] * 3, shape=(16, 17, 18), R=4))
    X = np.random.default_rng(31).integers(0, 16, (5000, 3))
    te.reset_launches()
    got = a.to("cuda")[X].full().cpu()
    assert te.tt_eval_kernel.launches == 1
    _close(got, a.to("cpu")[X].full(), 1e-12)
    phi = tn.randn(4, 16, 16, 16, ranks_tt=4, batch=True, device="cpu", dtype=torch.float64,
                   generator=torch.Generator().manual_seed(32))
    div = tn.divergence(tn.gradient(phi))
    gk.reset_launches()
    tn.set_policy("highest")
    on_card = tn.round_tt(div.clone().to("cuda"), rmax=4, algorithm="gram")
    assert [k.launches for k in gk.KERNELS] == [1, 1, 1]
    _close(tn.Tensor([c.cpu() for c in on_card.cores], batch=True),
           tn.round_tt(div, rmax=4, algorithm="gram"), 1e-8)
