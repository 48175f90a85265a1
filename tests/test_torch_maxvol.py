"""The port's maxvol (tntorch_tpu_torch/maxvol.py) against the JAX package's
(tntorch_tpu/maxvol.py), and the two tools cross approximation builds on,
``meshgrid`` and ``stack``, on the same NumPy inputs in float64.

Pivot rows must be equal. The coefficient matrices C agree to 1e-12: the
two packages reach them by other sequences of solves and rank-1 updates
(the JAX package's host maxvol runs its native C++ swap loop on C = A @
inv(A[rows]); the port's runs NumPy's on a solve), which differ by
roundoff only."""

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
    # config 3's and the tutorials' Q, (R I) x R at I = 32, stay resident up
    # to R ~ 20 in float64; phase 10c's 25600 x 100 takes the grid kernel
    assert MK._swap_route(64, 2, 8) == MK._swap_route(32 * 20, 20, 8) == "resident"
    assert MK._swap_route(32 * 24, 24, 4) == "resident"
    assert MK._swap_route(25600, 100, 4) == MK._swap_route(25600, 100, 8) == "grid"
    for n, r, wave in ((25600, 100, 1056), (2000, 7, 132), (130, 400, 264), (5, 1, 8)):
        blocks = MK._grid_blocks(n, r, wave)
        per = -(-n // blocks)
        assert 1 <= blocks <= min(wave, n)
        assert (blocks - 1) * per < n <= blocks * per  # every block owns rows
    assert MK._grid_blocks(25600, 100, 1056) == 625


def test_kernel_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        MK.lu_rows(torch.ones(2, 3, dtype=torch.int32), 2, 1)  # more pivots than rows
    with pytest.raises(ValueError):
        MK.maxvol_swaps(torch.zeros(5, 2), torch.zeros(3, dtype=torch.int64), 1.05, 10)
    C = torch.zeros(5, 2)
    with pytest.raises(ValueError):
        MK.maxvol_swaps(C, torch.zeros(2, dtype=torch.int64, device="meta"), 1.05, 10)


@pytest.mark.cuda
def test_maxvol_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import warnings

    # resident shapes, one at the resident limit, and grid ones (f32, f64)
    shapes = [(64, 2), (96, 3), (640, 20), (300, 20), (2000, 7), (25600, 100)]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        for n, r in shapes:
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
            got_C, got_idx = MK.maxvol_swaps(C.clone(), idx.clone(), 1.05, 100)
            torch.cuda.synchronize()
            assert MK.maxvol_swaps.launches == before + 1
            assert torch.equal(got_idx, want_idx), (n, r, dtype)
            assert float((got_C - want_C).abs().max()) <= tol, (n, r, dtype)
    # ties go to the lowest row-major index, and a NaN ends the loop
    C = torch.zeros((40, 3), dtype=torch.float64, device="cuda")
    C[9, 0] = C[3, 1] = C[7, 2] = -5.0
    idx = torch.arange(3, device="cuda")
    got = MK.maxvol_swaps(C.clone(), idx.clone(), 1.05, 1)[1]
    assert got.tolist() == [0, 3, 2]
    assert torch.equal(got, MK.maxvol_swaps_plain(C.clone(), idx.clone(), 1.05, 1)[1])
    C = torch.full((40, 3), 2.0, dtype=torch.float64, device="cuda")
    C[5, 1] = float("nan")
    got = MK.maxvol_swaps(C.clone(), idx.clone(), 1.05, 10)
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
