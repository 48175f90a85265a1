"""The port's grouped TT-evaluation backward (tntorch_tpu_torch/ops/tt_eval.py:
`_tt_eval_backward_grouped`) against ``jax.grad`` of the JAX package's
``tt_batch_forward``.

The CUDA kernels cannot run here, so a plain-PyTorch emulation follows the
grouped path step by step: the same bookkeeping functions (`_group_operands`
with stable sorts of every mode, `_run_bounds`, `_slice_plan`), the
interfaces in both directions one slice per run of sorted samples, and each
gradient slice summed segment by segment in sorted order, with partial slots
added in block order. The kernels themselves are compared with the plain
version on the card (chip_smoke.py, and the `cuda`-marked test below)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntorch_tpu.parallel.mesh import tt_batch_forward as jax_tt_batch_forward
from tntorch_tpu_torch.ops import tt_eval as te


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _problem(ranks, dims, B, seed, negative=False, skew=None, empty=None, dtype=np.float64):
    """Cores (R_k, I_k, R_{k+1}), coordinates (B, N) and weights (B,), as
    numpy. ``skew=k``: ~90% of the samples share one coordinate of mode k;
    ``empty=k``: coordinate 1 of mode k is never used."""
    rng = np.random.default_rng(seed)
    cores = [(rng.standard_normal((ranks[k], I, ranks[k + 1])) / np.sqrt(ranks[k])).astype(dtype)
             for k, I in enumerate(dims)]
    X = np.stack([rng.integers(-I if negative else 0, I, B) for I in dims], axis=1)
    if skew is not None:
        X[rng.random(B) < 0.9, skew] = 2
    if empty is not None:
        X[X[:, empty] % dims[empty] == 1, empty] = 0
    return cores, X, rng.standard_normal(B).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _jax_grads(cores, X, w):
    jX, jw = jnp.asarray(X), jnp.asarray(w)
    return jax.grad(lambda cs: jnp.sum(jw * jax_tt_batch_forward(cs, jX)))(
        [jnp.asarray(c) for c in cores])


def _interface(core, keys, perm, rows):
    """One grouped interface launch: y_b = rows_b core[:, x_b, :], one slice
    per run of equal sorted keys, each row back to its sample."""
    y = torch.empty((len(perm), core.shape[2]), dtype=core.dtype)
    ordered = rows[perm]
    for i in torch.unique_consecutive(keys).tolist():
        run = keys == i
        y[perm[run]] = ordered[run] @ core[:, i, :]
    return y


def _reduce(A, C, keys, perm, I, P):
    """One slice reduction: slice i = sum over its run of A_b (outer) C_b,
    walked as `_slice_plan` says. Returns (I, rows, cols)."""
    B = len(perm)
    segments, slots = te._slice_plan(te._run_bounds(keys, I), B, P)
    out = torch.zeros((I, A.shape[1], C.shape[1]), dtype=A.dtype)
    part = {}
    for segs in segments:
        for i, start, end, slot in segs:
            b = perm[start:end]
            acc = A[b].T @ C[b]
            if slot is None:
                out[i] = acc
            else:
                part[slot] = acc
    for i, own in enumerate(slots):
        if own:  # the sum pass: from zero, in block order
            out[i] = sum(part[s] for s in own)
    return out


def _backward_emulation(cores, X, g, P=None):
    """The grouped backward's arithmetic on the CPU."""
    B, N = X.shape
    ranks = [cores[0].shape[0]] + [c.shape[2] for c in cores]
    dims = [c.shape[1] for c in cores]
    P = te._slice_block(B) if P is None else P
    Xw, flag, sorts, first, last = te._group_operands(cores, X, range(N))
    assert not bool(flag)
    lefts = [torch.ones((B, ranks[0]), dtype=g.dtype)]
    if N > 1:
        lefts.append(first[Xw[:, 0].long()])
    for k in range(1, N - 1):
        lefts.append(_interface(cores[k], *sorts[k], lefts[k]))
    rights = {N - 1: last[Xw[:, N - 1].long()]} if N > 1 else {}
    for k in range(N - 2, 0, -1):
        rights[k] = _interface(cores[k].permute(2, 1, 0), *sorts[k], rights[k + 1])
    grads = []
    for k in range(N):
        keys, perm = sorts[k]
        if k < N - 1:
            out = _reduce(g[:, None] * lefts[k], rights[k + 1], keys, perm, dims[k], P)
            grads.append(out.permute(1, 0, 2))
        else:  # one row g_b (Rt_N = e_0): column 0 of the last core
            out = _reduce(g[:, None], lefts[k], keys, perm, dims[k], P)
            d = torch.zeros_like(cores[k])
            d[:, :, 0] = out[:, 0, :].T
            grads.append(d)
    return grads


SHAPES = {
    "ragged_r0_rn": dict(ranks=[2, 5, 3, 7, 3], dims=[9, 4, 11, 5], B=60),
    "negative": dict(ranks=[2, 5, 3, 7, 3], dims=[9, 4, 11, 5], B=60, negative=True),
    "three_modes": dict(ranks=[1, 4, 5, 1], dims=[6, 7, 8], B=50),
    "five_modes": dict(ranks=[1, 3, 4, 2, 5, 1], dims=[5, 3, 6, 4, 7], B=70, negative=True),
    "skewed": dict(ranks=[1, 4, 3, 5, 1], dims=[6, 8, 5, 7], B=200, skew=1),
    "one_sample": dict(ranks=[2, 3, 4, 3], dims=[5, 6, 7], B=1, negative=True),
    "empty_slice": dict(ranks=[1, 3, 4, 2, 1], dims=[5, 6, 7, 4], B=80, empty=2),
    "two_modes": dict(ranks=[2, 4, 3], dims=[7, 5], B=30, negative=True),
    "one_mode": dict(ranks=[3, 2], dims=[6], B=20),
}


@pytest.mark.parametrize("P", [None, 8], ids=["default_block", "block_8"])
@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
def test_grouped_backward_emulation_matches_jax_grad_f64(shape, P):
    # f64: only summation order differs from jax.grad, within 1e-12
    # relative; P=8 splits every run longer than 8 positions into partials
    spec = dict(SHAPES[shape])
    ranks, dims, B = spec.pop("ranks"), spec.pop("dims"), spec.pop("B")
    cores, X, w = _problem(ranks, dims, B, seed=21, **spec)
    want = _jax_grads(cores, X, w)
    got = _backward_emulation([torch.from_numpy(c) for c in cores], torch.from_numpy(X),
                              torch.from_numpy(w), P)
    for d, j in zip(got, want):
        assert _rel(d.numpy(), np.asarray(j)) <= 1e-12


PLAN_CASES = {
    "uniform": ([0, 3, 7, 12, 20, 21, 30], 30, 8),
    "skewed": ([0, 1, 95, 97, 100], 100, 8),
    "empty_slices": ([0, 0, 5, 5, 5, 16, 16], 16, 4),
    "one_block": ([0, 2, 3, 3, 6], 6, 8),
    "one_sample": ([0, 0, 1, 1], 1, 128),
    "runs_on_block_edges": ([0, 8, 16, 24], 24, 8),
}


@pytest.mark.parametrize("case", PLAN_CASES, ids=list(PLAN_CASES))
def test_slice_plan_covers_every_position_once_in_order(case):
    bounds, B, P = PLAN_CASES[case]
    segments, slots = te._slice_plan(bounds, B, P)
    assert len(segments) == -(-B // P)
    walked = [(start, end) for segs in segments for _, start, end, _ in segs]
    assert [p for s, e in walked for p in range(s, e)] == list(range(B))  # once, in order
    used = []
    for x, segs in enumerate(segments):
        for i, start, end, slot in segs:
            lo, hi = bounds[i], bounds[i + 1]
            # a segment lies in its run and in its block: no block takes more than P
            assert lo <= start < end <= hi and x * P <= start and end <= min(B, (x + 1) * P)
            whole = lo >= x * P and hi <= (x + 1) * P
            assert (slot is None) == whole
            if slot is not None:  # the kernel's rule, and its sum pass's
                assert slot == 2 * x + (lo > x * P)
                used.append(slot)
    assert len(used) == len(set(used))
    for i, own in enumerate(slots):
        lo, hi = bounds[i], bounds[i + 1]
        if hi > lo and lo // P != (hi - 1) // P:  # a run split across blocks
            assert own == [2 * x + (lo > x * P) for x in range(lo // P, (hi - 1) // P + 1)]
        else:
            assert own == []


def test_slice_block_is_whole_tiles_and_fills_the_card():
    for B in (1, 127, 8192, 1 << 16, 1 << 20, 1 << 26):
        P = te._slice_block(B)
        assert P % te._SLICE_TILE == 0 and te._SLICE_TILE <= P <= 8 * te._SLICE_TILE
    assert te._slice_block(1 << 20) == 1024 and -(-(1 << 20) // 1024) == 1024  # design: 1024 blocks
    assert te._slice_block(8192) == 128


@pytest.mark.parametrize("itype", [torch.int32, torch.int64])
def test_backward_sorts_are_stable_and_bound_the_runs(itype):
    # Every mode sorted, each permutation increasing within equal keys, so
    # a slice's sum runs in increasing b and is bitwise reproducible
    cores, X, _ = _problem([1, 3, 2, 4, 1], [5, 3, 6, 4], 300, seed=22, negative=True, skew=2)
    Xt = torch.from_numpy(X).to(itype)
    N = X.shape[1]
    Xw, _, sorts, _, _ = te._group_operands([torch.from_numpy(c) for c in cores], Xt, range(N))
    assert len(sorts) == N
    for k, (keys, perm) in enumerate(sorts):
        I = cores[k].shape[1]
        assert torch.equal(keys, Xw[perm, k])
        same = keys[1:] == keys[:-1]
        assert bool((perm[1:][same] > perm[:-1][same]).all())
        bounds = te._run_bounds(keys, I)
        assert bounds.dtype == torch.int64 and bounds.shape == (I + 1,)
        counts = torch.bincount(Xw[:, k].long(), minlength=I)
        assert torch.equal(bounds, torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)]))


def test_backward_bookkeeping_skips_the_check_when_told():
    cores, X, _ = _problem([1, 3, 2, 1], [5, 6, 7], 6, seed=23)
    X[1, 1] = 6  # out of range
    Xt = torch.from_numpy(X)
    cs = [torch.from_numpy(c) for c in cores]
    assert bool(te._group_operands(cs, Xt, range(3))[1])
    Xw, flag, _, _, _ = te._group_operands(cs, Xt, range(3), check=False)
    assert flag is None and bool(((Xw >= 0) & (Xw < torch.tensor([5, 6, 7]))).all())


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_grouped_backward_predicate_limits(itemsize):
    G = te._BWD_MIN
    design, training = ([1, 64, 64, 64, 1], [1024] * 4), ([1, 16, 16, 1], [256] * 3)
    assert te._grouped_backward(*design, 1 << 20, itemsize)
    # samples per slice of every middle mode: B >= G * I_k
    assert te._grouped_backward(*design, G * 1024, itemsize)
    assert not te._grouped_backward(*design, G * 1024 - 1, itemsize)
    assert not te._grouped_backward(*training, 8192, itemsize)  # B/I = 32: the training step
    assert not te._grouped_backward([1, 64, 1], [1024, 1024], 1 << 24, itemsize)  # N <= 2
    assert not te._grouped_backward([3, 2], [6], 1 << 24, itemsize)
    assert not te._grouped_backward(SHAPES["ragged_r0_rn"]["ranks"], [37] * 4, 1000, itemsize)
    # bytes of middle slices: 2 * 64 * 64 * itemsize a sample at the design ranks
    need = te._BWD_MIN_BYTES // (2 * 64 * 64 * itemsize)
    big = ([1, 64, 64, 64, 1], [4] * 4)
    assert te._grouped_backward(*big, need, itemsize)
    assert not te._grouped_backward(*big, need - 1, itemsize)
    # Shared memory of the interface launches: R_k (left sweep) and R_{k+1}
    # (right sweep, on the transposed core) both limited
    fits = max(r for r in range(1, 1024) if te._grouped_smem(r, itemsize) <= te._SMEM)
    assert fits == {4: 294, 8: 147}[itemsize]
    for r, want in ((fits, True), (fits + 1, False)):
        assert te._grouped_backward([1, 8, r, 8, 1], [4] * 4, 1 << 24, itemsize) is want
        assert te._grouped_backward([1, 8, 8, r, 1], [4] * 4, 1 << 24, itemsize) is want
    # R_0 and R_N are not limited: the first and last modes need no interface launch
    assert te._grouped_backward([fits + 1, 8, 8, 8, fits + 1], [4] * 4, 1 << 24, itemsize)


def test_tteval_backward_passes_checked_and_direct_calls_do_not(monkeypatch):
    # TTEval's forward raised on any out-of-range coordinate of the X its
    # backward gets, so the backward tells the kernel not to read the flag
    # again; a direct call keeps the check
    assert inspect.signature(te.tt_eval_backward_kernel).parameters["checked"].default is False
    seen = []
    kernel = te.tt_eval_backward_kernel

    def spy(cores, X, g, checked=False):
        seen.append(checked)
        return kernel(cores, X, g, checked)

    monkeypatch.setattr(te, "tt_eval_backward_kernel", spy)
    cores, X, w = _problem([1, 3, 2, 1], [5, 6, 7], 9, seed=24)
    params = [torch.from_numpy(c).requires_grad_() for c in cores]
    (torch.from_numpy(w) * te.tt_eval(params, X)).sum().backward()
    assert seen == [True]
    te.tt_eval_backward_kernel(params, torch.from_numpy(X), torch.from_numpy(w))
    assert seen == [True, False]
    want = _jax_grads(cores, X, w)
    for p, j in zip(params, want):
        assert _rel(p.grad.numpy(), np.asarray(j)) <= 1e-12


@pytest.mark.cuda
def test_both_backward_paths_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    choice = te._grouped_backward
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-12)):
        for name, spec in SHAPES.items():
            spec = dict(spec)
            ranks, dims, B = spec.pop("ranks"), spec.pop("dims"), spec.pop("B")
            cores, X, g = _problem(ranks, dims, B, seed=25, dtype=dtype, **spec)
            cs = [torch.from_numpy(c).cuda() for c in cores]
            Xt, gt = torch.from_numpy(X).cuda(), torch.from_numpy(g).cuda()
            want = te.tt_eval_backward_plain(cs, Xt, gt)
            for grouped in (False, True):
                te._grouped_backward = lambda *a: grouped  # noqa: B023
                try:
                    before = te.tt_eval_backward_kernel.grouped
                    got = te.tt_eval_backward_kernel(cs, Xt, gt)
                    again = te.tt_eval_backward_kernel(cs, Xt, gt)
                    torch.cuda.synchronize()
                finally:
                    te._grouped_backward = choice
                assert te.tt_eval_backward_kernel.grouped == before + 2 * grouped
                for a, a2, b in zip(got, again, want):
                    assert _rel(a.cpu(), b.cpu()) <= tol, name
                    if grouped:
                        assert torch.equal(a, a2), name
