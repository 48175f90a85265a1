"""The port's Tucker factors, Tucker rounding, round() and dense
decomposition (tntorch_tpu_torch/tensor.py, ops/rounding.py) against the
JAX package's, on the same NumPy inputs in float64.

Dense reconstructions, ranks and reached errors are compared, never cores
or factors (they are defined up to a gauge); values agree to 1e-10
relative. Test spectra sit well away from the eps thresholds, so both
packages choose the same ranks; batch parity caps ranks with rmax, since
the two frameworks' eigensolvers may decide exact-zero spectra apart."""

import os
import re

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop
from tntorch_tpu_torch.ops import tt_eval as te

TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (6, 7, 8, 5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _arrays(seed, batch=0, ranks=(3, 4, 3), S=(4, 5, None, 3), shape=SHAPE):
    """TT cores over the Tucker ranks S (None: no factor) and the factors."""
    rng = np.random.default_rng(seed)
    ranks = [1, *ranks, 1]
    b = (batch,) if batch else ()
    inner = [s if r is None else r for s, r in zip(shape, S)]
    cores = [rng.standard_normal(b + (ranks[n], inner[n], ranks[n + 1]))
             for n in range(len(shape))]
    Us = [None if r is None else rng.standard_normal(b + (s, r)) for s, r in zip(shape, S)]
    return cores, Us


def _pair(seed, batch=0, **kw):
    """The same Tucker tensor in both packages."""
    cores, Us = _arrays(seed, batch, **kw)
    t = interop.tensor_from_arrays(cores, Us=Us, batch=bool(batch), device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores],
                    Us=[None if U is None else jnp.asarray(U) for U in Us], batch=bool(batch))
    return t, jt


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


BATCH = pytest.mark.parametrize("batch", [0, 3], ids=["single", "batch3"])


@BATCH
def test_factors_through_arithmetic_and_full(batch):
    a, ja = _pair(1, batch)
    b, jb = _pair(2, batch, S=(4, None, 3, 2))
    assert a.shape == tuple(ja.shape) and repr(a) == repr(ja)
    _close(a.numpy(), ja.numpy())
    for f in (lambda x, y: x + y, lambda x, y: x - 2 * y, lambda x, y: x * y,
              lambda x, y: x * x, lambda x, y: 3 + x):
        got, want = f(a, b), f(ja, jb)
        assert got.ranks_tucker.tolist() == want.ranks_tucker.tolist()
        assert [U is None for U in got.Us] == [U is None for U in want.Us]
        _close(got.numpy(), want.numpy())
    # a product of small Tucker ranks keeps its factors (2*2 < 6), as in the
    # JAX package; larger ones multiply them in
    s, js = _pair(2, batch, S=(2, 2, None, 3))
    assert (s * s).ranks_tucker.tolist() == (js * js).ranks_tucker.tolist() == [4, 4, 8, 5]
    assert [U is None for U in (s * s).Us] == [False, False, True, True]
    _close((s * s).numpy(), (js * js).numpy())


@BATCH
def test_factors_through_dot_clone_repeat(batch):
    a, ja = _pair(3, batch)
    b, jb = _pair(4, batch, S=(None, 5, 2, 3))
    _close(tn.dot(a, b).numpy(), jtn.dot(ja, jb))
    _close(tn.norm(a).numpy(), jtn.norm(ja))
    _close(tn.relative_error(a, b).numpy(), jtn.relative_error(ja, jb))
    _close(tn.dist(a, b.full()).numpy(), jtn.dist(ja, jb.full()))
    c = a.clone()
    c.frozen_Us = {0}
    c2 = c.clone()
    assert c2.Us[0] is c.Us[0] and c2.frozen_Us == {0} and c2.frozen_Us is not c.frozen_Us
    _close(a.repeat(1, 2, 1, 3).numpy(), ja.repeat(1, 2, 1, 3).numpy())
    _close((a + b.repeat(1, 1, 1, 1)).numpy(), (ja + jb).numpy())


@BATCH
def test_repeat_appends_trailing_modes(batch):
    # more counts than modes: each extra count appends a mode of that size
    a, ja = _pair(7, batch)
    got, want = a.repeat(2, 1, 1, 3, 4), ja.repeat(2, 1, 1, 3, 4)
    off = (batch,) if batch else ()
    assert got.shape == tuple(want.shape) == off + (12, 7, 8, 15, 4)
    assert tuple(got.cores[-1].shape) == off + (1, 4, 1)
    _close(got.numpy(), want.numpy())
    with pytest.raises(ValueError):
        a.repeat(2, 1, 1)


@pytest.mark.parametrize("key", [
    (3, slice(None), 5, slice(1, 4)), (slice(None, None, -2), 1), (Ellipsis, 2),
    (0, None, slice(2, 6), 1), ([0, 2, 5], [1, 1, 3], slice(None), 2),
    (slice(None), [1, 4], [0, 7], slice(None)),
], ids=["int-slice", "neg-step", "ellipsis", "none", "arrays-first", "arrays-middle"])
def test_factors_through_indexing(key):
    a, ja = _pair(5)
    got, want = a[key], ja[key]
    _close(got.numpy() if isinstance(got, tn.Tensor) else got.numpy(),
           want.numpy() if isinstance(want, jtn.Tensor) else want)


def test_batch_indexing_with_factors():
    a, ja = _pair(6, 3)
    for key in ((1, 2, slice(None), 4), (slice(None), 3, [0, 6], [1, 1], 0),
                (2,), (slice(0, 2), Ellipsis, 1)):
        got, want = a[key], ja[key]
        _close(got.numpy() if isinstance(got, tn.Tensor) else got.numpy(),
               want.numpy() if isinstance(want, jtn.Tensor) else want)


def test_all_mode_coordinates_on_a_tucker_tensor_skip_tt_eval(monkeypatch):
    # The compressed cores' middle axis is S, not I: tt_eval there would
    # index the wrong axis. The Tucker branch of get_key takes the key.
    def refuse(*args, **kwargs):
        raise AssertionError("a Tucker tensor reached tt_eval")

    monkeypatch.setattr(te, "tt_eval", refuse)
    a, ja = _pair(7)
    X = np.random.default_rng(7).integers(0, 5, (40, 4))
    _close(a[X].numpy(), ja[X].numpy())
    _close(a[torch.from_numpy(X)].numpy(), ja[X].numpy())
    _close(a[tuple(X.T)].numpy(), ja[tuple(X.T)].numpy())
    assert a[X].numpy().shape == (40,)


def test_factor_orthogonalize_and_decompression():
    a, ja = _pair(8)
    dense = a.numpy()
    for n in range(4):
        a.factor_orthogonalize(n)
        ja.factor_orthogonalize(n)
    for U in a.Us:
        if U is not None:
            _close(U.T @ U, np.eye(U.shape[1]))
    _close(a.numpy(), dense)
    _close(a.numpy(), ja.numpy())
    _close(a.tucker_core().numpy(), ja.tucker_core())
    part = a.decompress_tucker_factors(dim=[0, 3])
    assert [U is None for U in part.Us] == [True, False, True, True]
    _close(part.numpy(), dense)
    assert all(U is None for U in a.tt().Us)


def _tt(seed, batch=0, ranks=(3, 4, 3), shape=SHAPE, decay=None):
    """A plain TT in both packages; ``decay`` scales the middle index of each
    core geometrically, so the Tucker spectra fall off well apart from the
    eps thresholds."""
    rng = np.random.default_rng(seed)
    ranks = [1, *ranks, 1]
    b = (batch,) if batch else ()
    cores = [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]
    if decay:
        cores = [c * decay ** np.arange(c.shape[-2])[:, None] for c in cores]
    t = interop.tensor_from_arrays(cores, batch=bool(batch), device="cpu")
    return t, jtn.Tensor([jnp.asarray(c) for c in cores], batch=bool(batch))


@pytest.mark.parametrize("algorithm", ["svd", "eig"])
@pytest.mark.parametrize("path", ["kernel", "eager"])
def test_round_tucker_paths_match_jax(algorithm, path):
    t, jt = _tt(9, decay=0.05)
    if path == "eager":  # factors present: the eager sweep, in both packages
        t, jt = _pair(9, S=(5, 6, None, 4))
    for kw in (dict(eps=1e-3), dict(eps=1e-12, rmax=[3, 4, 5, 2]), dict(eps=1e-3, dim=[1])):
        a, ja = t.clone(), jt.clone()
        a.round_tucker(algorithm=algorithm, **kw)
        ja.round_tucker(algorithm=algorithm, **kw)
        assert a.ranks_tucker.tolist() == ja.ranks_tucker.tolist(), kw
        assert a.ranks_tt.tolist() == ja.ranks_tt.tolist()
        _close(a.numpy(), ja.numpy(), tol=1e-9)


def test_dim_on_both_kinds_of_path():
    # The jitted fast paths truncate every mode (dim only sets the eps
    # split), the eager path honors dim: the port follows each
    t, jt = _tt(10, decay=0.05)
    a, ja = t.clone(), jt.clone()
    a.round_tucker(eps=1e-3, dim=[1])
    ja.round_tucker(eps=1e-3, dim=[1])
    assert a.ranks_tucker.tolist() == ja.ranks_tucker.tolist()
    assert all(r < s for r, s in zip(a.ranks_tucker, SHAPE))  # every mode truncated
    e, je = _pair(10, S=(6, 7, None, 5))
    e.round_tucker(eps=1e-1, dim=[1])
    je.round_tucker(eps=1e-1, dim=[1])
    assert e.ranks_tucker.tolist() == je.ranks_tucker.tolist()
    assert e.ranks_tucker[0] == 6 and e.ranks_tucker[1] < 7  # only mode 1 truncated
    _close(e.numpy(), je.numpy(), tol=1e-9)


@pytest.mark.parametrize("algorithm", ["svd", "eig"])
def test_batch_round_tucker_matches_jax_and_the_loop(algorithm):
    t, jt = _tt(11, batch=3)
    rmax = [4, 3, 5, 2]
    a, ja = t.clone(), jt.clone()
    a.round_tucker(rmax=rmax, algorithm=algorithm)
    ja.round_tucker(rmax=rmax, algorithm=algorithm)
    # mode 0's Tucker rank is at most its core's R_l R_r = 3
    assert a.ranks_tucker.tolist() == ja.ranks_tucker.tolist() == [3, 3, 5, 2]
    assert all(U.shape[0] == 3 for U in a.Us)
    _close(a.numpy(), ja.numpy(), tol=1e-9)
    for s in range(3):  # one body over the batch: each sample as alone with eps=0
        one = tn.Tensor([c[s] for c in t.cores])
        one.round_tucker(eps=0.0, rmax=rmax, algorithm=algorithm)
        _close(a[s].numpy(), one.numpy(), tol=1e-12)
    d, jd = t.clone(), jt.clone()  # dim=[1] truncates every mode here too
    d.round_tucker(rmax=rmax, dim=[1], algorithm=algorithm)
    jd.round_tucker(rmax=rmax, dim=[1], algorithm=algorithm)
    assert d.ranks_tucker.tolist() == jd.ranks_tucker.tolist() == [3, 3, 5, 2]


@BATCH
def test_batch_eager_round_tucker_with_factors(batch):
    t, jt = _pair(12, batch, S=(5, 6, None, 4))
    t.round_tucker(rmax=[3, 4, 5, 2])
    jt.round_tucker(rmax=[3, 4, 5, 2])
    assert t.ranks_tucker.tolist() == jt.ranks_tucker.tolist() == [3, 4, 5, 2]
    _close(t.numpy(), jt.numpy(), tol=1e-9)


@pytest.mark.parametrize("algorithm", ["svd", "eig"])
def test_round_budget_reached_error_and_ranks(algorithm):
    # A TT plus 1e-6 of another: the TT stage cuts ranks (reached ~2e-4 of
    # the 1e-3 budget), the Tucker stage takes the rest
    t, jt = _tt(13, ranks=(4, 5, 4), decay=0.3)
    n, jn = _tt(113, ranks=(4, 5, 4))
    t, jt = t + 1e-6 * n, jt + 1e-6 * jn
    a, ja = t.clone(), jt.clone()
    a.round(1e-3, algorithm=algorithm)
    ja.round(1e-3, algorithm=algorithm)
    _close(a._round_reached_dev.numpy(), ja._round_reached_dev, tol=1e-8)
    assert 1e-4 < float(a._round_reached_dev) < 1e-3
    assert a.ranks_tt.tolist() == ja.ranks_tt.tolist()
    assert a.ranks_tucker.tolist() == ja.ranks_tucker.tolist()
    assert a.ranks_tucker.tolist() != t.ranks_tucker.tolist()  # the Tucker stage ran
    _close(a.numpy(), ja.numpy(), tol=1e-9)
    assert a.ranks_tt.tolist() == [1, 3, 5, 4, 1] and float(tn.relative_error(t, a)) <= 1e-3
    # functional forms, and the copy path (gram: no reached error reported)
    _close(tn.round(t, eps=1e-3, algorithm=algorithm).numpy(), a.numpy(), tol=1e-12)
    g, jg = t.clone(), jt.clone()
    g.round(1e-3, rmax=5, algorithm="gram")
    jg.round(1e-3, rmax=5, algorithm="gram")
    assert g._round_reached_dev is None
    assert g.ranks_tucker.tolist() == jg.ranks_tucker.tolist()
    _close(g.numpy(), jg.numpy(), tol=1e-9)


def test_round_tt_with_factors_takes_the_eager_sweep():
    for alg in ("svd", "gram"):
        t, jt = _pair(14, S=(5, 6, None, 4))
        t, jt = t + t, jt + jt
        t.round_tt(eps=1e-10, rmax=[3, 4, 3], algorithm=alg)
        jt.round_tt(eps=1e-10, rmax=[3, 4, 3], algorithm=alg)
        assert t._round_reached_dev is None and t.Us[0] is not None
        assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
        _close(t.numpy(), jt.numpy(), tol=1e-9)


@BATCH
def test_decomposing_dense_data(batch):
    rng = np.random.default_rng(15)
    b = (batch,) if batch else ()
    x = np.einsum("...i,...j,...k,...l->...ijkl", *[rng.standard_normal(b + (s,))
                                                   for s in SHAPE])
    x = x + 1e-2 * rng.standard_normal(x.shape)
    kws = [dict(ranks_tt=3), dict(ranks_tucker=4), dict(ranks_tt=2, ranks_tucker=3),
           dict(ranks_tt=3, ranks_tucker=[4, 5, 6, 3], algorithm="eig")]
    if not batch:
        kws.append(dict(eps=1e-1))
    for kw in kws:
        t = tn.Tensor(torch.from_numpy(x), batch=bool(batch), **kw)
        jt = jtn.Tensor(jnp.asarray(x), batch=bool(batch), **kw)
        assert t.ranks_tt.tolist() == jt.ranks_tt.tolist(), kw
        assert t.ranks_tucker.tolist() == jt.ranks_tucker.tolist(), kw
        _close(t.numpy(), jt.numpy(), tol=1e-9)
    with pytest.raises(ValueError, match="eps or ranks"):
        tn.Tensor(torch.from_numpy(x), eps=1e-3, ranks_tt=2)


def test_rand_with_tucker_ranks_and_the_setters():
    g = torch.Generator().manual_seed(3)
    t = tn.randn([6, 7, 8], ranks_tt=3, ranks_tucker=[4, None, 5], device="cpu", generator=g)
    jt = jtn.randn([6, 7, 8], ranks_tt=3, ranks_tucker=[4, None, 5])
    assert t.shape == tuple(jt.shape) and t.ranks_tucker.tolist() == jt.ranks_tucker.tolist()
    assert [U is None for U in t.Us] == [U is None for U in jt.Us]
    again = tn.randn([6, 7, 8], ranks_tt=3, ranks_tucker=[4, None, 5], device="cpu",
                     generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(again.cores + [again.Us[0], again.Us[2]],
                                                  t.cores + [t.Us[0], t.Us[2]]))
    full = tn.rand([2, 6, 7], batch=True, ranks_tucker=3, device="cpu")
    jfull = jtn.rand([2, 6, 7], batch=True, ranks_tucker=3)
    assert full.ranks_tt.tolist() == jfull.ranks_tt.tolist() and full.Us[1].shape == (2, 7, 3)
    hybrid = tn.rand([3, 4, 5], ranks_cp=[2, None, None], ranks_tt=[None, 3], device="cpu")
    jhybrid = jtn.rand([3, 4, 5], ranks_cp=[2, None, None], ranks_tt=[None, 3])
    assert [c.shape for c in hybrid.cores] == [tuple(c.shape) for c in jhybrid.cores]
    a, ja = _tt(16, ranks=(5, 5, 5))
    a.ranks_tt, ja.ranks_tt = 2, 2
    a.ranks_tucker, ja.ranks_tucker = 3, 3
    assert a.ranks_tt.tolist() == ja.ranks_tt.tolist() == [1, 2, 2, 2, 1]
    assert a.ranks_tucker.tolist() == ja.ranks_tucker.tolist() == [2, 3, 3, 2]
    _close(a.numpy(), ja.numpy(), tol=1e-9)


def _fit(pkg, cores, Us, X, y, frozen=(), steps=25):
    if pkg is tn:
        t = interop.tensor_from_arrays(cores, Us=Us, device="cpu")
        t.requires_grad, t.frozen_Us = True, set(frozen)
        yt = torch.from_numpy(y)
        hist = tn.optimize([t], lambda t: torch.mean((t[X].full() - yt) ** 2), tol=None,
                           max_iter=steps - 1, verbose=False,
                           optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2))
        return t, hist
    t = jtn.Tensor([jnp.asarray(c) for c in cores],
                   Us=[None if U is None else jnp.asarray(U) for U in Us], requires_grad=True)
    t.frozen_Us = set(frozen)
    jy = jnp.asarray(y)
    hist = jtn.optimize([t], lambda t: jnp.mean((t[X].full() - jy) ** 2), tol=None,
                        max_iter=steps - 1, verbose=False, optimizer=optax.adam(1e-2))
    return t, hist


@pytest.mark.parametrize("frozen", [(), (1,)], ids=["all", "frozen1"])
def test_training_over_factors_matches_jax_adam(frozen):
    cores, Us = _arrays(17, ranks=(2, 2, 2), S=(3, 4, None, 2))
    rng = np.random.default_rng(17)
    X = np.stack([rng.integers(0, s, 50) for s in SHAPE], axis=1)
    y = rng.standard_normal(50)
    t, hist = _fit(tn, cores, Us, X, y, frozen)
    jt, jhist = _fit(jtn, cores, Us, X, y, frozen)
    assert hist[-1] < hist[0]
    _close(hist, jhist, tol=1e-10)
    _close(t.numpy(), jt.numpy(), tol=1e-9)
    assert tn.dof(t) == jtn.dof(jt)
    # the factors trained, except the frozen one, which is the caller's
    for m, U in enumerate(t.Us):
        if U is not None:
            moved = not np.allclose(U.detach().numpy(), Us[m])
            assert moved == (m not in frozen)


def test_tensor_from_arrays_carries_a_jax_tucker_tensor():
    jt = jtn.randn([6, 7, 8], ranks_tt=3, ranks_tucker=[4, None, 5])
    t = interop.tensor_from_arrays(jt.cores, Us=jt.Us, device="cpu")
    assert t.Us[1] is None and t.Us[0].dtype == torch.from_numpy(np.asarray(jt.Us[0])).dtype
    _close(t.numpy(), jt.numpy())
    with pytest.raises(ValueError, match="Tucker factor 0"):
        interop.tensor_from_arrays(jt.cores, Us=[np.ones((6, 3)), None, None], device="cpu")


def test_cited_roadmap_items_exist():
    # Every "queue 1 item N" the port cites names an item of ROADMAP's queue 1
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    queue1 = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    labels = {int(n) for head in re.findall(r"\*\*Items? ([\d, and]+)", queue1)
              for n in re.findall(r"\d+", head)}
    cited = set()
    for d, _, files in os.walk(os.path.join(ROOT, "tntorch_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(d, name)) as f:
                    cited |= {int(n) for n in re.findall(r"queue 1 item (\d+)", f.read())}
    assert cited and cited <= labels, sorted(cited - labels)


@pytest.mark.cuda
def test_tucker_round_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t, _ = _tt(18, decay=0.05)
    g = t.clone().to("cuda")
    g.round(1e-3)
    t.round(1e-3)
    assert g.Us[0].device.type == "cuda"
    assert g.ranks_tucker.tolist() == t.ranks_tucker.tolist()
    _close(g.numpy(), t.numpy(), tol=1e-9)
