"""The port's TT evaluation (tntorch_tpu_torch/ops/tt_eval.py) against the
JAX package's: the Pallas kernel in interpret mode (f32), ``tt_batch_forward``
and ``tn.tt_eval`` (f64), and the gradient against ``jax.grad``.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are compared with those versions on the card (chip_smoke.py, and
the `cuda`-marked test below)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu.ops.pallas_tt import pallas_tt_eval
from tntorch_tpu.parallel.mesh import tt_batch_forward as jax_tt_batch_forward
from tntorch_tpu_torch.ops import tt_eval as te


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _problem(ranks, dims, B, seed, negative=False, dtype=np.float64):
    """Cores (R_k, I_k, R_{k+1}), coordinates (B, N) and weights (B,), as numpy."""
    rng = np.random.default_rng(seed)
    cores = [(rng.standard_normal((ranks[k], I, ranks[k + 1])) / np.sqrt(ranks[k])).astype(dtype)
             for k, I in enumerate(dims)]
    X = np.stack([rng.integers(-I if negative else 0, I, B) for I in dims], axis=1)
    return cores, X, rng.standard_normal(B).astype(dtype)


def _torch(cores):
    return [torch.from_numpy(c) for c in cores]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


SHAPES = {
    "tt": ([1, 4, 5, 1], [6, 7, 8], 50, False),
    "boundary_ranks": ([2, 5, 3, 7, 3], [9, 4, 11, 5], 40, False),
    "negative": ([2, 5, 3, 7, 3], [9, 4, 11, 5], 40, True),
    "one_mode": ([1, 1], [13], 7, True),
}


def test_plain_version_matches_pallas_interpret_f32():
    # The Pallas kernel's gates: R_0 = R_N = 1, B a multiple of 128, f32.
    # Both sides sum short chains in f32: within 1e-5 of max|ref|
    cores, X, _ = _problem([1, 8, 6, 1], [16, 12, 10], 256, seed=1, dtype=np.float32)
    want = np.asarray(pallas_tt_eval(tuple(jnp.asarray(c) for c in cores),
                                     jnp.asarray(X, jnp.int32), interpret=True))
    got = te.tt_eval_plain(_torch(cores), torch.from_numpy(X)).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
def test_tt_eval_matches_jax_f64(shape):
    # f64: only summation order differs, within 1e-12 relative
    ranks, dims, B, negative = SHAPES[shape]
    cores, X, _ = _problem(ranks, dims, B, seed=2, negative=negative)
    jc, jX = [jnp.asarray(c) for c in cores], jnp.asarray(X)
    want = np.asarray(jax_tt_batch_forward(jc, jX))
    assert _rel(np.asarray(jtn.tt_eval(jc, jX)), want) <= 1e-12
    for got in (tn.tt_eval(_torch(cores), X), tn.parallel.tt_batch_forward(_torch(cores), X),
                tn.tt_eval(_torch(cores), torch.from_numpy(X).int(), use_kernel=False),
                te.tt_eval_kernel(_torch(cores), torch.from_numpy(X))):
        assert _rel(got.numpy(), want) <= 1e-12


def test_use_pallas_is_the_reference_name_of_use_kernel(monkeypatch):
    cores, X, _ = _problem([1, 4, 5, 1], [6, 7, 8], 50, seed=5)
    want = np.asarray(jtn.tt_eval([jnp.asarray(c) for c in cores], jnp.asarray(X),
                                  use_pallas=False))

    def refuse(*args):
        raise AssertionError("took TTEval")

    monkeypatch.setattr(te.TTEval, "apply", refuse)
    assert _rel(tn.tt_eval(_torch(cores), X, use_pallas=False).numpy(), want) <= 1e-12
    with pytest.raises(AssertionError, match="took TTEval"):
        tn.tt_eval(_torch(cores), X, use_pallas=None)


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
def test_gradient_matches_jax_grad_f64(shape):
    # d/dC sum_b w_b f_b: TTEval's plain backward (index_add_ of the outer
    # products) against jax.grad of tt_batch_forward, within 1e-12 relative
    ranks, dims, B, negative = SHAPES[shape]
    cores, X, w = _problem(ranks, dims, B, seed=3, negative=negative)
    jX, jw = jnp.asarray(X), jnp.asarray(w)
    want = jax.grad(lambda cs: jnp.sum(jw * jax_tt_batch_forward(cs, jX)))(
        [jnp.asarray(c) for c in cores])
    params = [c.requires_grad_() for c in _torch(cores)]
    (torch.from_numpy(w) * tn.tt_eval(params, X)).sum().backward()
    for p, g in zip(params, want):
        assert _rel(p.grad.numpy(), np.asarray(g)) <= 1e-12
    direct = te.tt_eval_backward_plain(_torch(cores), torch.from_numpy(X), torch.from_numpy(w))
    for d, g in zip(direct, want):
        assert _rel(d.numpy(), np.asarray(g)) <= 1e-12


def test_tteval_passes_gradcheck():
    cores, X, _ = _problem([2, 3, 2, 2], [4, 3, 5], 9, seed=4, negative=True)
    params = tuple(c.requires_grad_() for c in _torch(cores))
    assert torch.autograd.gradcheck(lambda *cs: te.TTEval.apply(torch.from_numpy(X), *cs), params)


def test_checked_evaluation_is_the_same_function():
    # checked=True (coordinates known to be in range) only drops the flag
    # read on the card: values within 1e-12 of the JAX package's, and the
    # same gradient
    cores, X, _ = _problem([2, 3, 2, 2], [4, 3, 5], 9, seed=4)
    want = np.asarray(jax_tt_batch_forward([jnp.asarray(c) for c in cores], jnp.asarray(X)))
    assert _rel(tn.tt_eval(_torch(cores), X, checked=True).detach().numpy(), want) <= 1e-12
    params = tuple(c.requires_grad_() for c in _torch(cores))
    assert torch.autograd.gradcheck(
        lambda *cs: te.CheckedTTEval.apply(torch.from_numpy(X), *cs), params)


def test_complex_cores_take_the_plain_chain():
    rng = np.random.default_rng(5)
    cores = [rng.standard_normal(s) + 1j * rng.standard_normal(s)
             for s in [(1, 4, 3), (3, 5, 2), (2, 6, 1)]]
    X = np.stack([rng.integers(0, I, 12) for I in (4, 5, 6)], axis=1)
    want = np.asarray(jtn.tt_eval([jnp.asarray(c) for c in cores], jnp.asarray(X)))
    before = [k.launches for k in te.KERNELS]
    assert _rel(tn.tt_eval(_torch(cores), X).numpy(), want) <= 1e-12
    assert [k.launches for k in te.KERNELS] == before


def test_out_of_range_coordinates_raise():
    cores, X, _ = _problem([1, 2, 1], [3, 4], 5, seed=6)
    for bad in ([[0, 4]], [[-4, 0]], [[3, 0]]):
        with pytest.raises(IndexError):
            tn.tt_eval(_torch(cores), np.array(bad))
    with pytest.raises(ValueError, match="shape"):
        tn.tt_eval(_torch(cores), np.zeros((3, 3), np.int64))
    with pytest.raises(TypeError, match="integers"):
        tn.tt_eval(_torch(cores), np.zeros((3, 2)))


def test_empty_batch_and_index_dtypes():
    cores, X, _ = _problem([1, 3, 1], [5, 6], 11, seed=7)
    want = te.tt_eval_plain(_torch(cores), torch.from_numpy(X))
    for Xi in (X.astype(np.int32), X.astype(np.int16), X.astype(np.uint8)):
        assert torch.equal(tn.tt_eval(_torch(cores), Xi), want)
    assert tn.tt_eval(_torch(cores), np.zeros((0, 2), np.int64)).shape == (0,)


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    cores, X, g = _problem([1, 3, 2, 1], [5, 6, 7], 13, seed=8)
    cs, Xt, gt = _torch(cores), torch.from_numpy(X), torch.from_numpy(g)
    te.reset_launches()
    assert torch.equal(te.tt_eval_kernel(cs, Xt), te.tt_eval_plain(cs, Xt))
    for a, b in zip(te.tt_eval_backward_kernel(cs, Xt, gt), te.tt_eval_backward_plain(cs, Xt, gt)):
        assert torch.equal(a, b)
    assert [k.launches for k in te.KERNELS] == [0, 0]


def test_wrappers_refuse_other_devices_instead_of_falling_back():
    cores = [torch.zeros((1, 3, 1), device="meta")]
    X = torch.zeros((2, 1), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        te.tt_eval_kernel(cores, X)
    with pytest.raises(ValueError, match="different devices"):
        te.tt_eval_backward_kernel(cores, torch.zeros((2, 1), dtype=torch.int64),
                                   torch.zeros(2, device="meta"))


def test_plain_backward_chunks_large_batches(monkeypatch):
    # The plain backward scatters in slices of _CHUNK elements; slicing
    # changes nothing but the order of the index_add_ calls
    cores, X, g = _problem([1, 3, 2, 1], [5, 6, 7], 40, seed=9)
    args = (_torch(cores), torch.from_numpy(X), torch.from_numpy(g))
    whole = te.tt_eval_backward_plain(*args)
    monkeypatch.setattr(te, "_CHUNK", 7)
    for a, b in zip(te.tt_eval_backward_plain(*args), whole):
        assert torch.allclose(a, b, rtol=1e-13, atol=1e-15)


def _grouped_emulation(cores, X):
    """The grouped kernels' arithmetic on the CPU, from `_group_operands`:
    rows in sorted order, one slice per run of equal coordinates, rows back
    to their samples, the last mode a dot with C_{N-1}[:, x, 0]."""
    Xw, flag, sorts, first, last = te._group_operands(cores, X)
    v = None
    for k, (keys, perm) in enumerate(sorts, start=1):
        rows = first[Xw[perm, 0].long()] if k == 1 else v[perm]  # in sorted order
        y = torch.empty((len(perm), cores[k].shape[2]), dtype=rows.dtype)
        for i in torch.unique_consecutive(keys).tolist():
            run = keys == i
            y[perm[run]] = rows[run] @ cores[k][:, i, :]
        v = y
    return (v * last[Xw[:, -1].long()]).sum(1), flag


@pytest.mark.parametrize("shape", ["boundary_ranks", "negative"])
def test_grouping_bookkeeping_matches_jax_f64(shape):
    # Wrapped coordinates, sorted keys and their permutation compose to the
    # values of tt_batch_forward (1e-12); no coordinate is out of range
    ranks, dims, B, negative = SHAPES[shape]
    cores, X, _ = _problem(ranks, dims, B, seed=11, negative=negative)
    want = np.asarray(jax_tt_batch_forward([jnp.asarray(c) for c in cores], jnp.asarray(X)))
    Xt = torch.from_numpy(X)
    got, flag = _grouped_emulation(_torch(cores), Xt)
    assert _rel(got.numpy(), want) <= 1e-12 and not bool(flag)
    Xw, _, sorts, first, last = te._group_operands(_torch(cores), Xt)
    assert Xw.dtype == torch.int32 and torch.equal(Xw.long(), Xt % torch.tensor(dims))
    for k, (keys, perm) in enumerate(sorts, start=1):
        assert torch.equal(keys, Xw[perm, k]) and bool((keys[1:] >= keys[:-1]).all())
        inverse = torch.empty_like(perm)
        inverse[perm] = torch.arange(B)
        assert torch.equal(keys[inverse], Xw[:, k])
    assert first.shape == (dims[0], ranks[1]) and last.shape == (dims[-1], ranks[-2])


@pytest.mark.parametrize("itype", [torch.int32, torch.int64])
def test_grouping_flags_out_of_range_coordinates(itype):
    # Flagged, and wrapped into range like the rest, so no launch reads out
    # of bounds before the wrapper raises
    cores, X, _ = _problem([1, 3, 2, 1], [5, 6, 7], 6, seed=12, negative=True)
    X[1, 1], X[4, 0], X[5, 2] = 6, -6, 9
    Xt = torch.from_numpy(X).to(itype)
    Xw, flag, sorts, _, _ = te._group_operands(_torch(cores), Xt)
    assert bool(flag)
    ok = torch.ones_like(Xt, dtype=torch.bool)
    ok[1, 1] = ok[4, 0] = ok[5, 2] = False
    assert torch.equal(Xw[ok].long(), (Xt % torch.tensor([5, 6, 7]))[ok].long())
    assert bool(((Xw >= 0) & (Xw < torch.tensor([5, 6, 7]))).all())
    keys, perm = sorts[0]
    assert torch.equal(keys, torch.sort(Xw[:, 1]).values)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_grouped_predicate_limits(itemsize):
    G = te._GROUP_MIN
    design, training = ([1, 64, 64, 64, 1], [1024] * 4), ([1, 16, 16, 1], [256] * 3)
    assert te._grouped(*design, 1 << 20, itemsize)
    # samples per slice: B >= G * I_k
    assert te._grouped(*design, G * 1024, itemsize) and not te._grouped(*design, G * 1024 - 1, itemsize)
    assert not te._grouped(*training, 8192, itemsize)  # B/I = 32: the training step
    assert not te._grouped([1, 64, 1], [1024, 1024], 1 << 24, itemsize)  # N <= 2
    assert not te._grouped([1, 64, 1], [1 << 20], 1 << 24, itemsize)
    ranks, dims, B, _ = SHAPES["boundary_ranks"]
    assert not te._grouped(ranks, dims, B, itemsize)  # ragged shapes: few samples per slice
    assert not te._grouped(ranks, [37] * 4, 1000, itemsize)
    # bytes of middle slices: 2 * 16 * 16 * itemsize a sample at rank 16
    small, need = ([1, 16, 16, 16, 1], [256] * 4), te._GROUP_MIN_BYTES // (512 * itemsize)
    assert te._grouped(*small, need, itemsize) and not te._grouped(*small, need - 1, itemsize)
    assert not te._grouped(*small, 256 * 256, itemsize)  # B/I = 256 at rank 16
    # Shared memory: the largest middle rank that fits, and one more
    fits = max(r for r in range(1, 1024) if te._grouped_smem(r, itemsize) <= te._SMEM)
    assert fits == {4: 294, 8: 147}[itemsize]
    for r, want in ((fits, True), (fits + 1, False)):
        assert te._grouped([1, 8, r, 8, 1], [4] * 4, 1 << 24, itemsize) is want
    assert te._grouped([1, 8, 8, r, 1], [4] * 4, 1 << 24, itemsize)  # R_{k+1} is not limited


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    grouped = te._grouped
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-12)):
        for ranks, dims, B, negative in SHAPES.values():
            cores, X, g = _problem(ranks, dims, B, seed=10, negative=negative, dtype=dtype)
            cs = [c.cuda() for c in _torch(cores)]
            Xt, gt = torch.from_numpy(X).cuda(), torch.from_numpy(g).cuda()
            want = te.tt_eval_plain(cs, Xt).cpu()
            # Both forward kernels: the grouped one forced where N >= 3
            for force in (False, True)[:1 + (len(dims) >= 3)]:
                te._grouped = lambda *a: force  # noqa: B023
                try:
                    before = [k.launches for k in te.KERNELS] + [te.tt_eval_kernel.grouped]
                    got = te.tt_eval_kernel(cs, Xt)
                    again = te.tt_eval_kernel(cs, Xt)
                    torch.cuda.synchronize()
                finally:
                    te._grouped = grouped
                assert te.tt_eval_kernel.launches == before[0] + 2
                assert te.tt_eval_kernel.grouped == before[2] + 2 * force
                assert _rel(got.cpu(), want) <= tol and torch.equal(got, again)
            before = [k.launches for k in te.KERNELS]
            grads = te.tt_eval_backward_kernel(cs, Xt, gt)
            torch.cuda.synchronize()
            assert [k.launches for k in te.KERNELS] == [before[0], before[1] + 1]
            for a, b in zip(grads, te.tt_eval_backward_plain(cs, Xt, gt)):
                assert _rel(a.cpu(), b.cpu()) <= tol
    with pytest.raises(IndexError):
        cores, X, _ = _problem([1, 3, 2, 1], [5, 6, 7], 4, seed=13)
        X[2, 1] = 6
        te._grouped = lambda *a: True
        try:
            te.tt_eval_kernel([c.cuda() for c in _torch(cores)], torch.from_numpy(X).cuda())
        finally:
            te._grouped = grouped
