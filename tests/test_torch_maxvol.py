"""The port's maxvol (tntorch_tpu_torch/maxvol.py) against the JAX package's
(tntorch_tpu/maxvol.py), and the two tools cross approximation builds on,
``meshgrid`` and ``stack``, on the same NumPy inputs in float64.

Pivot rows must be equal. The coefficient matrices C agree to 1e-12 (both
host maxvols run their C++ swap loops on C = A @ inv(A[rows]), bitwise equal
where both take them, tests/test_torch_native.py; the device maxvols reach
C by other sequences of solves and rank-1 updates, which differ by roundoff
only)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn

JM = importlib.import_module("tntorch_tpu.maxvol")
TM = importlib.import_module("tntorch_tpu_torch.maxvol")
TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


@pytest.fixture
def float64_default():
    # The JAX package's tests run under jax_enable_x64, where its
    # default_dtype() is float64; torch's default is float32. Both meshgrids
    # cast the axes to their package's default, so the test sets torch's to
    # float64 for the comparison and restores it after.
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _rows_and_C(got, want):
    rows, C = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in got)
    wrows, wC = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(rows, wrows)
    assert C.shape == wC.shape
    assert np.abs(C - wC).max() <= TOL * max(np.abs(wC).max(), 1.0)


def _matrix(n, r, seed=0):
    """A tall matrix with columns of unequal scale, so that the LU start is
    not already maximal and the swap loop has work."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, r)) * np.geomspace(1, 1e3, r)


HOST = {"default": {}, "top_k_index": dict(top_k_index=50),
        "few_iterations": dict(tol=1.01, max_iters=5)}


@pytest.mark.parametrize("kw", HOST, ids=list(HOST))
def test_host_maxvol_matches_jax(kw):
    A = _matrix(200, 12)
    _rows_and_C(tn.maxvol(A, **HOST[kw]), jtn.maxvol(A, **HOST[kw]))
    assert tn.py_maxvol is tn.maxvol and tn.py_rect_maxvol is tn.rect_maxvol


RECT = {"default": {}, "maxK": dict(maxK=20), "minK": dict(minK=15, maxK=30),
        "min_add_K": dict(min_add_K=3), "top_k_index": dict(top_k_index=60),
        "tol_without_identity": dict(tol=1.5, identity_submatrix=False)}


@pytest.mark.parametrize("kw", RECT, ids=list(RECT))
def test_host_rect_maxvol_matches_jax(kw):
    A = _matrix(200, 12, seed=1)
    _rows_and_C(tn.rect_maxvol(A, **RECT[kw]), jtn.rect_maxvol(A, **RECT[kw]))


def test_no_more_rows_than_columns_is_the_identity():
    A = _matrix(5, 12)[:, :7]
    for fn, jfn in ((tn.maxvol, jtn.maxvol), (tn.rect_maxvol, jtn.rect_maxvol)):
        _rows_and_C(fn(A), jfn(A))
    rows, C = TM.maxvol_device(torch.from_numpy(A))
    assert rows.tolist() == list(range(5)) and torch.equal(C, torch.eye(5, dtype=C.dtype))


def test_warm_start_leaves_the_callers_rows_alone():
    A = _matrix(200, 12, seed=2)
    init = np.random.default_rng(3).choice(200, 12, replace=False).astype(np.int64)
    mine, theirs = init.copy(), init.copy()
    got, want = tn.maxvol(A, init_rows=mine), jtn.maxvol(A, init_rows=theirs)
    _rows_and_C(got, want)
    # the warm start was used: a cold start ends elsewhere on this matrix
    assert not np.array_equal(got[0], tn.maxvol(A)[0])
    np.testing.assert_array_equal(mine, init)
    # the JAX package's native swap loop writes the caller's array
    # (ROADMAP.md, known faults in the reference)
    assert importlib.import_module("tntorch_tpu._native").get_lib() is not None
    assert not np.array_equal(theirs, init)


# (n, r): the last shapes are past the LU tournament's block of
# max(r, 2**20 // r) rows, where the pivots come from the blocks' winners
DEVICE = {"small": (40, 5), "medium": (300, 20), "tall_tournament": (40000, 64),
          "tall_narrow": (5000, 7)}


@pytest.mark.parametrize("shape", DEVICE, ids=list(DEVICE))
def test_device_maxvol_matches_jax(shape):
    n, r = DEVICE[shape]
    A = _matrix(n, r, seed=4)
    Q = np.linalg.qr(A)[0] if n > 1000 else A
    np.testing.assert_array_equal(TM._device_lu_pivots(torch.from_numpy(Q)).numpy(),
                                  np.asarray(JM._device_lu_pivots(jnp.asarray(Q))))
    _rows_and_C(TM.maxvol_device(torch.from_numpy(Q)), JM.maxvol_device(jnp.asarray(Q)))


@pytest.mark.parametrize("shape", ["medium", "tall_tournament"])
def test_device_rect_maxvol_matches_jax(shape):
    n, r = DEVICE[shape]
    Q = np.linalg.qr(_matrix(n, r, seed=5))[0]
    for kw in (dict(maxK=r + 10), dict(minK=r + 3, maxK=r + 6, identity_submatrix=False)):
        _rows_and_C(TM.rect_maxvol_device(torch.from_numpy(Q), **kw),
                    JM.rect_maxvol_device(jnp.asarray(Q), **kw))


@pytest.mark.parametrize("block", [1, 3, 100])
def test_blocks_of_guarded_swaps_equal_one_swap_per_check(block, monkeypatch):
    # A guarded swap after convergence changes nothing, so any number of
    # them between two host checks gives the while loop's result, bitwise;
    # max_iters=9 also cuts a block short
    A = torch.from_numpy(_matrix(300, 20, seed=6))
    for max_iters in (100, 9):
        monkeypatch.setattr(TM, "_BLOCK", 1)
        rows1, C1 = TM.maxvol_device(A, max_iters=max_iters)
        monkeypatch.setattr(TM, "_BLOCK", block)
        rows, C = TM.maxvol_device(A, max_iters=max_iters)
        assert torch.equal(rows, rows1) and torch.equal(C, C1)
        _rows_and_C((rows, C), JM.maxvol_device(jnp.asarray(A.numpy()), 1.05, max_iters))


def test_meshgrid_matches_jax(float64_default):
    axes = [np.linspace(0, 1, 5), np.arange(3.0), np.geomspace(1, 8, 4)]
    for got, want in zip(tn.meshgrid(axes, device="cpu"), jtn.meshgrid(axes)):
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.full()))
    for got, want in zip(tn.meshgrid(3, 4, 2, device="cpu"), jtn.meshgrid(3, 4, 2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.full()))


def test_meshgrid_casts_to_the_default_dtype():
    # as the JAX package does: float32 unless the caller sets float64
    assert tn.meshgrid([np.arange(3.0)] * 2, device="cpu")[0].dtype == torch.get_default_dtype()


def test_stack_matches_jax():
    rng = np.random.default_rng(7)
    samples = [[rng.standard_normal((r0, 4, r1)) for r0, r1 in zip(ranks[:-1], ranks[1:])]
               for ranks in ([1, 2, 3, 1], [1, 3, 1, 1], [1, 1, 2, 1])]
    got = tn.stack([tn.Tensor([torch.from_numpy(c) for c in cs]) for cs in samples])
    want = jtn.stack([jtn.Tensor([jnp.asarray(c) for c in cs]) for cs in samples])
    assert got.batch and got.ranks_tt.tolist() == list(want.ranks_tt) == [1, 3, 3, 1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want.full()), rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        tn.stack([got])


# ---------------------------------------------------------------------------
# The device maxvol's two kernels (ops/maxvol_kernels.py), by their plain
# versions here; on the card, by the cuda-marked test below
# ---------------------------------------------------------------------------

MK = importlib.import_module("tntorch_tpu_torch.ops.maxvol_kernels")


@pytest.mark.parametrize("shape", DEVICE, ids=list(DEVICE))
def test_plain_lu_rows_match_jax_permutation(shape):
    # LAPACK's successive swaps composed into rows are jax.lax.linalg.lu's
    # permutation, whole, and the tournament's pivots are JAX's
    import jax

    n, r = DEVICE[shape]
    A = _matrix(min(n, 5000), r, seed=8)
    piv = torch.linalg.lu_factor_ex(torch.from_numpy(A))[1]
    perm = np.asarray(jax.lax.linalg.lu(jnp.asarray(A))[2])
    full = MK.lu_rows(piv[None], A.shape[0], A.shape[0])
    assert full.dtype == torch.int64 and full.shape == (1, A.shape[0])
    np.testing.assert_array_equal(full[0].numpy(), perm)
    np.testing.assert_array_equal(MK.lu_rows_plain(piv[None], A.shape[0], r)[0].numpy(), perm[:r])
    Q = np.linalg.qr(_matrix(n, r, seed=4))[0]
    np.testing.assert_array_equal(TM._device_lu_pivots(torch.from_numpy(Q)).numpy(),
                                  np.asarray(JM._device_lu_pivots(jnp.asarray(Q))))


def test_plain_lu_rows_of_a_batch():
    rng = np.random.default_rng(9)
    A = rng.standard_normal((5, 30, 4))
    piv = torch.linalg.lu_factor_ex(torch.from_numpy(A))[1]
    rows = MK.lu_rows(piv, 30, 4)
    for b in range(5):
        want = MK.lu_rows(torch.linalg.lu_factor_ex(torch.from_numpy(A[b]))[1][None], 30, 4)
        assert torch.equal(rows[b], want[0])


@pytest.mark.parametrize("shape", DEVICE, ids=list(DEVICE))
def test_plain_swap_loop_matches_jax_while_loop(shape):
    # From the LU start, the plain swap loop gives the JAX package's rows,
    # and C within 1e-12, the 40000 x 64 tournament case included
    n, r = DEVICE[shape]
    A = _matrix(n, r, seed=4)
    Q = torch.from_numpy(np.linalg.qr(A)[0] if n > 1000 else A)
    idx = TM._device_lu_pivots(Q)
    C = torch.linalg.solve(Q[idx].T, Q.T).T.contiguous()
    for max_iters in (100, 3):
        got = MK.maxvol_swaps_plain(C, idx, 1.05, max_iters)
        assert torch.equal(idx, TM._device_lu_pivots(Q))  # the inputs are not written
        _rows_and_C(got[::-1], JM.maxvol_device(jnp.asarray(Q.numpy()), 1.05, max_iters))
        # the wrapper takes the plain version on the CPU
        wrapped = MK.maxvol_swaps(C, idx, 1.05, max_iters)
        assert torch.equal(wrapped[0], got[0]) and torch.equal(wrapped[1], got[1])


def test_swap_routes_and_grid_plan():
    # config 3's and the tutorials' Q, (R I) x R at I = 32, take the
    # cluster; phase 10c's 25600 x 100 the resident grid, one CTA per SM
    assert MK._swap_plan(64, 2, 8) == MK._swap_plan(96, 3, 4) == ("cluster", 1)
    assert MK._swap_plan(1024, 46, 4) == ("cluster", 12)  # one CTA per 4096 entries
    assert MK._swap_plan(25600, 100, 4) == MK._swap_plan(25600, 100, 8) == ("resident", 132)
    assert MK._swap_plan(25600, 100, 4, sms=114) == ("resident", 114)
    for item in (4, 8):
        # a cluster CTA's rows at r = 100 (its inbox: 2 row copies per CTA),
        # a grid CTA's (the pivot row)
        crows, grows = MK._cta_rows(100, item, 32), MK._cta_rows(100, item, 1)
        for rows, extra in ((crows, 32), (grows, 1)):
            assert MK._cta_bytes(rows, 100, item, extra) <= MK._SMEM_BYTES \
                < MK._cta_bytes(rows + 1, 100, item, extra)
        last = min(MK._MAX_CLUSTER * crows, MK._CLUSTER_MAX_BYTES // (100 * item))
        assert MK._swap_plan(last, 100, item)[0] == "cluster"
        assert MK._swap_plan(last + 1, 100, item)[0] == "resident"
        # the resident grid holds ~29 MB on 132 SMs, then C streams
        assert MK._swap_plan(132 * grows, 100, item) == ("resident", 132)
        assert MK._swap_plan(132 * grows + 1, 100, item) == ("streamed", 132)
        assert 29e6 < 132 * grows * 100 * item < 31e6
    assert MK._swap_plan(2048, 100, 4) == ("cluster", 16)
    assert MK._swap_plan(4096, 100, 4)[0] == "resident"  # 1.6 MB: past the timed crossover


PLANS = [(64, 2, 8), (17, 5, 4), (300, 20, 4), (1024, 46, 4), (1024, 52, 4), (2000, 7, 4),
         (9200, 100, 4), (4577, 100, 8), (25600, 100, 8), (40000, 64, 4), (75901, 100, 4),
         (133, 1, 4), (5, 1, 8), (1, 1, 4)]


@pytest.mark.parametrize("shape", PLANS, ids=["x".join(map(str, p)) for p in PLANS])
def test_swap_plan_gives_every_cta_rows(shape):
    n, r, item = shape
    route, ctas = MK._swap_plan(n, r, item)
    per = -(-n // ctas)
    assert 1 <= ctas <= min(n, MK._MAX_CLUSTER if route == "cluster" else MK._SMS)
    assert (ctas - 1) * per < n <= ctas * per  # every CTA owns rows
    extra = 2 * ctas if route == "cluster" else 1
    assert (route == "streamed") == (MK._cta_bytes(per, r, item, extra) > MK._SMEM_BYTES)
    if route == "cluster":  # at least a CTA per _CLUSTER_ENTRIES entries, up to 16
        assert ctas >= MK._even(n, min(n, MK._MAX_CLUSTER, -(-n * r // MK._CLUSTER_ENTRIES)))


def _traced_rows(p, n, k):
    """lu_rows_kernel's composition (csrc/maxvol_device.cu) in NumPy: each
    of the first min(npiv, k) positions traced back through the swaps
    (0-based targets ``p``; one out of range is no swap), last to first;
    beyond npiv the identity, then each position a swap touched, traced
    the same way. No n-entry permutation is built."""
    npiv = len(p)
    o = np.where((p >= 0) & (p < n), p, np.arange(npiv))

    def trace(x):
        for t in range(npiv - 1, -1, -1):
            x = o[t] if x == t else (t if x == o[t] else x)
        return x

    rows = np.arange(k)
    rows[:min(npiv, k)] = [trace(x) for x in range(min(npiv, k))]
    for x in o:
        if npiv <= x < k:
            rows[x] = trace(x)
    return rows


def _pivots(kind, n, npiv, rng):
    s = np.arange(npiv)
    if kind == "lapack":  # o_s >= s, as getrf gives them
        return rng.integers(s, n)
    if kind == "no_swaps":
        return s.copy()
    if kind == "repeated_targets":
        return np.where(rng.random(npiv) < 0.5, n - 1, rng.integers(s, n))
    if kind == "some_equal":
        return np.where(rng.random(npiv) < 0.3, s, rng.integers(s, n))
    return rng.integers(0, n, npiv)  # "any": targets below s too


TRACED = [(kind, n, npiv, k) for kind in ("lapack", "no_swaps", "repeated_targets", "some_equal",
                                          "any")
          for n, npiv, k in ((50, 10, 10), (300, 100, 300), (64, 64, 64), (40, 12, 5),
                             (1000, 30, 200))]


@pytest.mark.parametrize("case", TRACED, ids=["-".join(map(str, c)) for c in TRACED])
def test_traced_lu_rows_match_the_plain_composition(case):
    kind, n, npiv, k = case
    rng = np.random.default_rng(n * 7 + npiv + k)
    for _ in range(3):
        p = _pivots(kind, n, npiv, rng)
        want = MK.lu_rows_plain(torch.from_numpy(p + 1).to(torch.int32)[None], n, k)[0]
        np.testing.assert_array_equal(_traced_rows(p, n, k), want.numpy())


def test_traced_lu_rows_of_real_pivots_and_the_tournament():
    # getrf's pivots of a tall block (k = r = npiv), and the tournament's
    # last LU, m r x r with k = n = m r > npiv (maxvol.py:_device_lu_pivots)
    rng = np.random.default_rng(10)
    for n, r, k in ((400, 20, 20), (300, 100, 300), (96, 32, 96)):
        piv = torch.linalg.lu_factor_ex(torch.from_numpy(rng.standard_normal((n, r))))[1]
        want = MK.lu_rows_plain(piv[None], n, k)[0].numpy()
        np.testing.assert_array_equal(_traced_rows(piv.numpy().astype(np.int64) - 1, n, k), want)


def test_kernel_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        MK.lu_rows(torch.ones(2, 3, dtype=torch.int32), 2, 1)  # more pivots than rows
    with pytest.raises(ValueError):
        MK.maxvol_swaps(torch.zeros(5, 2), torch.zeros(3, dtype=torch.int64), 1.05, 10)
    C = torch.zeros(5, 2)
    with pytest.raises(ValueError):
        MK.maxvol_swaps(C, torch.zeros(2, dtype=torch.int64, device="meta"), 1.05, 10)


@pytest.mark.cuda
def test_maxvol_kernels_match_plain_versions_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import warnings

    def swaps(plan, *args):
        # MK.maxvol_swaps on the (route, CTAs) ``plan`` forces, or on its own
        with monkeypatch.context() as m:
            if plan:
                m.setattr(MK, "_swap_plan", lambda *shape: plan)
            return MK.maxvol_swaps(*args)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # planned shapes: one-CTA and multi-CTA clusters, the resident grid;
    # then each route's last shape at r = 100 and the next route's first
    cases = [(n, r, None) for n, r in ((64, 2), (96, 3), (640, 20), (300, 20), (2000, 7),
                                       (25600, 100))]
    for item in (4, 8):
        crows, grows = MK._cta_rows(100, item, 32), MK._cta_rows(100, item, 1)
        for last in (min(16 * crows, MK._CLUSTER_MAX_BYTES // (100 * item)), sms * grows):
            cases += [(last, 100, None), (last + 1, 100, None)]
    # each route forced, with CTAs left without rows
    cases += [(64, 2, ("cluster", 1)), (17, 5, ("cluster", 16)), (300, 20, ("resident", sms)),
              (2000, 7, ("streamed", sms)), (9200, 100, ("resident", sms))]
    for dtype in (torch.float64, torch.float32):
        for n, r, plan in cases:
            Q = torch.linalg.qr(torch.from_numpy(_matrix(n, r, seed=n)))[0].to(dtype).cuda()
            piv = TM._lu_pivots(Q)
            before = MK.lu_rows.launches
            rows = MK.lu_rows(piv[None], n, n)
            assert MK.lu_rows.launches == before + 1
            assert torch.equal(rows.cpu(), MK.lu_rows_plain(piv[None], n, n).cpu())
            idx = rows[0, :r].contiguous()
            C = torch.linalg.solve(Q[idx].T, Q.T).T.contiguous()
            want_C, want_idx = MK.maxvol_swaps_plain(C.clone(), idx.clone(), 1.05, 100)
            before = MK.maxvol_swaps.launches
            got_C, got_idx = swaps(plan, C.clone(), idx.clone(), 1.05, 100)
            torch.cuda.synchronize()
            assert MK.maxvol_swaps.launches == before + 1
            assert torch.equal(got_idx, want_idx), (n, r, dtype, plan)
            assert torch.equal(got_C, want_C), (n, r, dtype, plan)  # bitwise
    # ties go to the lowest row-major index, and a NaN ends the loop, on every route
    for plan in (None, ("cluster", 3), ("resident", 40), ("streamed", 40)):
        C = torch.zeros((40, 3), dtype=torch.float64, device="cuda")
        C[9, 0] = C[3, 1] = C[7, 2] = -5.0
        idx = torch.arange(3, device="cuda")
        got = swaps(plan, C.clone(), idx.clone(), 1.05, 1)[1]
        assert got.tolist() == [0, 3, 2]
        assert torch.equal(got, MK.maxvol_swaps_plain(C.clone(), idx.clone(), 1.05, 1)[1])
        C = torch.full((40, 3), 2.0, dtype=torch.float64, device="cuda")
        C[5, 1], C[30, 2] = float("nan"), float("inf")
        got = swaps(plan, C.clone(), idx.clone(), 1.05, 10)
        assert torch.equal(got[1], idx) and torch.isnan(got[0][5, 1])
    # maxvol_device reads nothing back from the card
    Q = torch.linalg.qr(torch.from_numpy(_matrix(40000, 64, seed=4)))[0].cuda()
    TM.maxvol_device(Q)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rows, C = TM.maxvol_device(Q)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    _rows_and_C((rows, C), TM.maxvol_device(Q.cpu()))


def _batch(B, n, r, seed):
    """B orthonormal n x r matrices, as the batched minimize's QR gives
    them, and their LU start (rows, C) as `maxvol_device` begins."""
    Q = torch.stack([torch.linalg.qr(torch.from_numpy(_matrix(n, r, seed=seed + b)))[0]
                     for b in range(B)])
    idx = TM._device_lu_pivots(Q)
    return Q, idx, torch.linalg.solve(TM._rows_of(Q, idx).mT, Q.mT).mT.contiguous()


@pytest.mark.parametrize("B", [1, 3, 32])
def test_batched_plain_swap_loop_is_the_per_matrix_loop(B):
    # (320, 10): the minimize's Q at rmax 10 and I = 32; 10 and 100 swaps
    _, idx, C = _batch(B, 320, 10, seed=7)
    for iters in (10, 100):
        got_C, got_idx = MK.maxvol_swaps_plain(C, idx, 1.05, iters)
        assert got_C.shape == C.shape and got_idx.shape == idx.shape
        for b in range(B):
            want_C, want_idx = MK.maxvol_swaps_plain(C[b], idx[b], 1.05, iters)
            assert torch.equal(got_C[b], want_C) and torch.equal(got_idx[b], want_idx)
        wrapped = MK.maxvol_swaps(C, idx, 1.05, iters)  # the plain loop on the CPU
        assert torch.equal(wrapped[0], got_C) and torch.equal(wrapped[1], got_idx)
    empty = torch.zeros((0, 320, 10), dtype=C.dtype)
    assert MK.maxvol_swaps_plain(empty, torch.zeros((0, 10), dtype=torch.int64), 1.05, 10)[0] \
        is empty


@pytest.mark.parametrize("shape", [(3, 320, 10), (2, 40000, 64), (4, 7, 10)],
                         ids=["minimize", "tall_tournament", "wide"])
def test_batched_device_maxvol_is_the_per_matrix_maxvol(shape):
    # one LU call, one lu_rows call (two past the tournament's block), one
    # solve and one swap call for the batch: each matrix's rows and C
    # bitwise as maxvol_device gives them alone
    B, n, r = shape
    Q = torch.stack([torch.from_numpy(_matrix(n, r, seed=b)) for b in range(B)])
    if n > r:
        Q = torch.linalg.qr(Q)[0]
    for iters in (10, 100):
        rows, C = TM._maxvol_device_batched(Q, 1.05, iters)
        assert rows.shape == (B, min(n, r)) and C.shape == (B, n, min(n, r))
        for b in range(B):
            want_rows, want_C = TM.maxvol_device(Q[b], 1.05, iters)
            assert torch.equal(rows[b], want_rows) and torch.equal(C[b], want_C)


def test_batched_swap_wrapper_checks_its_inputs():
    C = torch.zeros(3, 5, 2)
    for idx in (torch.zeros(3, 3, dtype=torch.int64), torch.zeros(2, 2, dtype=torch.int64),
                torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError):
            MK.maxvol_swaps(C, idx, 1.05, 10)


@pytest.mark.cuda
def test_batched_swap_kernel_matches_plain_versions_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    # the minimize's Qs at rmax 10 (I = 32, I = 256) take the cluster: one
    # launch for the batch; past the cluster's last shape the resident
    # grid: one launch a matrix; each matrix bitwise the plain loop's
    crows = MK._cta_rows(100, 8, 32)
    last = min(16 * crows, MK._CLUSTER_MAX_BYTES // (100 * 8))
    for B in (1, 3, 32):
        for n, r, dtype in ((320, 10, torch.float64), (2560, 10, torch.float32),
                            (last, 100, torch.float64), (last + 1, 100, torch.float64)):
            _, idx, C = _batch(B, n, r, seed=n)
            C, idx = C.to(dtype).cuda(), idx.cuda()
            want_C, want_idx = MK.maxvol_swaps_plain(C.clone(), idx.clone(), 1.05, 10)
            route = MK._swap_plan(n, r, C.element_size(),
                                  torch.cuda.get_device_properties(0).multi_processor_count)[0]
            before = MK.maxvol_swaps.launches
            got_C, got_idx = MK.maxvol_swaps(C.clone(), idx.clone(), 1.05, 10)
            torch.cuda.synchronize()
            assert MK.maxvol_swaps.launches - before == (1 if route == "cluster" else B)
            assert torch.equal(got_idx, want_idx), (B, n, r, dtype)
            assert torch.equal(got_C, want_C), (B, n, r, dtype)  # bitwise
