"""Quasi-max-volume pivot selection for cross approximation.

Counterpart of ``tntorch_tpu/maxvol.py`` (maxvol: Goreinov et al., "How to
find a good submatrix", 2010; rectangular maxvol: Mikhalev & Oseledets,
2018), in two parts:

- the host API, `maxvol` and `rect_maxvol` (and their ``py_*`` aliases), on
  NumPy matrices, dispatched as the JAX package dispatches them. Real
  floating input with every row a candidate takes the host library
  (``csrc/maxvol_host.cpp``, loaded by `_native`): `maxvol` computes
  C = A inv(A[rows]) with BLAS, from the warm rows (``init_rows=``) or the
  LU start, and runs the C++ swap loop on it; `rect_maxvol` (without
  ``min_add_K``) runs wholly in C++. Complex input, ``top_k_index`` and
  ``min_add_K`` take the NumPy loops, `_maxvol_plain` and the growth of
  `_rect_maxvol_plain`, as in the JAX package. The library is built at
  first use; a failed build raises, with no fallback to NumPy. The
  caller's ``init_rows`` is never written. The host cross sweep
  (`cross_host`) and the host pivots of the minimizing cross pivot here.
- the device path, `maxvol_device` and `rect_maxvol_device`, in torch on the
  input's device: the pivots that cross approximation uses. The initial rows
  are the pivots of a partially pivoted LU (``torch.linalg.lu_factor_ex``
  under cuSOLVER, with the JAX package's tournament over blocks for tall
  matrices, so the same rows win); `ops.maxvol_kernels.lu_rows` composes
  LAPACK's successive swaps into rows, where the JAX package's LU returns a
  permutation, and the tournament keeps its first r real rows by a stable
  device argsort. Then `ops.maxvol_kernels.maxvol_swaps` runs the guarded
  swap loop, the JAX package's ``lax.while_loop``. On the card both are
  hand-written kernels and `maxvol_device` reads nothing back from the
  card; on the CPU their plain versions run (the swap loop in blocks of
  `_BLOCK` guarded iterations between host checks of ``max|C| > tol``).
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import scipy.linalg
import torch

from tntorch_tpu_torch import _native
from tntorch_tpu_torch.ops.maxvol_kernels import lu_rows, maxvol_swaps
from tntorch_tpu_torch.utils import asarray, policy_precision, trace_annotation

# Guarded swap iterations between two host checks of max|C| > tol in the
# plain swap loop (`maxvol_swaps` on CPU tensors)
_BLOCK = 4


# ---------------------------------------------------------------------------
# Host (NumPy)
# ---------------------------------------------------------------------------

def _initial_pivots(A: np.ndarray, top: int) -> np.ndarray:
    """Row order of a partially pivoted LU of A's first ``top`` rows (the
    first r entries are its pivots)."""
    N, r = A.shape
    # LAPACK's ipiv: successive row swaps
    _, piv = scipy.linalg.lu_factor(np.asfortranarray(A[:top]), check_finite=False)
    index = np.arange(N)
    for i in range(r):
        index[i], index[piv[i]] = index[piv[i]], index[i]
    return index


def _coefficients(A: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """C = A @ inv(A[rows]), by a solve with A[rows]^T."""
    with warnings.catch_warnings():
        # A near-singular start is what the swaps repair
        warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
        return scipy.linalg.solve(A[rows].T, A.T, check_finite=False).T


def maxvol(A, tol: float = 1.05, max_iters: int = 100, top_k_index: int = -1,
           init_rows=None):
    """Select r rows of A (N x r) whose submatrix has quasi-maximal volume.

    Returns (row indices [r], C = A @ inv(A[rows]) [N x r]).

    Real floating input with ``top_k_index`` -1 (or at least N) runs the
    host library's swap loop on C = A @ inv(A[rows]) from BLAS; other input
    takes the NumPy loop, `_maxvol_plain`.

    :param top_k_index: only the first ``top_k_index`` rows may be picked;
        -1 means all rows.
    :param init_rows: optional warm start, r distinct rows among the
        candidates (for example the pivots of a previous call on a similar
        matrix). It is copied, never written. A singular or otherwise
        unusable warm block falls back to the LU start.
    """
    A = np.asarray(A)
    tol = max(tol, 1.0)
    N, r = A.shape
    if N <= r:
        return np.arange(N, dtype=np.int64), np.eye(N, dtype=A.dtype)
    top = N if top_k_index == -1 or top_k_index > N else max(top_k_index, r)
    if A.dtype.kind == "f" and top == N:
        starts = []
        if init_rows is not None and len(init_rows) == r and int(np.max(init_rows)) < N:
            starts.append(np.array(init_rows, dtype=np.int64))  # a copy
        starts.append(None)  # the LU start, always valid
        for warm in starts:
            rows = warm if warm is not None else _initial_pivots(A, top)[:r].copy()
            try:
                with warnings.catch_warnings():
                    # A near-singular start is what the swaps repair
                    warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
                    C = A @ scipy.linalg.inv(A[rows], check_finite=False)
            except scipy.linalg.LinAlgError:
                continue  # an exactly singular block: the next start
            if warm is not None and not np.all(np.isfinite(C)):
                continue  # stale warm rows: the LU start
            C = np.ascontiguousarray(C)
            return _native.native_maxvol_iterate(C, rows, tol, max_iters), C
    return _maxvol_plain(A, tol, max_iters, top_k_index, init_rows)


def _maxvol_plain(A, tol: float = 1.05, max_iters: int = 100, top_k_index: int = -1,
                  init_rows=None):
    """`maxvol` in NumPy: the warm rows or the LU start, C by a solve, then
    the swap loop, one argmax and one rank-1 update of C a swap."""
    A = np.asarray(A)
    tol = max(tol, 1.0)
    N, r = A.shape
    if N <= r:
        return np.arange(N, dtype=np.int64), np.eye(N, dtype=A.dtype)
    top = N if top_k_index == -1 or top_k_index > N else max(top_k_index, r)

    C = None
    if init_rows is not None:
        rows = np.array(init_rows, dtype=np.int64)  # a copy
        if rows.shape == (r,) and rows.min() >= 0 and rows.max() < top:
            try:
                C = _coefficients(A, rows)
            except scipy.linalg.LinAlgError:
                C = None
            if C is not None and not np.all(np.isfinite(C)):
                C = None
    if C is None:
        rows = _initial_pivots(A, top)[:r].copy()
        C = _coefficients(A, rows)

    for _ in range(max_iters):
        flat = np.argmax(np.abs(C[:top]))
        i, j = divmod(flat, r)
        if abs(C[i, j]) <= tol:
            break
        # Swap row i into pivot slot j; rank-1 update of C
        rows[j] = i
        col = C[:, j].copy()
        row = C[i, :].copy()
        row[j] -= 1.0
        C -= np.outer(col / C[i, j], row)
    return rows, C


def rect_maxvol(A, tol: float = 1.0, maxK: int = None, min_add_K: int = None,
                minK: int = None, start_maxvol_iters: int = 10,
                identity_submatrix: bool = True, top_k_index: int = -1):
    """Greedy rectangular maxvol: start from the square maxvol pivots and add
    the row of largest coefficient norm while it exceeds ``tol`` (within the
    bounds on K). Returns (row indices [K], C [N x K]).

    Real floating input without ``min_add_K`` and with ``top_k_index`` -1
    (or at least N) runs wholly in the host library; other input grows the
    rows in NumPy from `maxvol`'s.

    :param top_k_index: only the first ``top_k_index`` rows may be picked;
        -1 means all rows."""
    A = np.asarray(A)
    N, r = A.shape
    if N <= r:
        return np.arange(N, dtype=np.int64), np.eye(N, dtype=A.dtype)
    top = N if top_k_index == -1 or top_k_index > N else max(top_k_index, r)
    if A.dtype.kind == "f" and min_add_K is None and top == N:
        out = _native.native_rect_maxvol(A, tol, maxK, minK, start_maxvol_iters,
                                         identity_submatrix)
        if out is not None:  # None: an exactly singular start, as NumPy meets it
            return out
    return _rect_grow(maxvol, A, tol, maxK, min_add_K, minK, start_maxvol_iters,
                      identity_submatrix, top_k_index)


def _rect_maxvol_plain(A, tol: float = 1.0, maxK: int = None, min_add_K: int = None,
                       minK: int = None, start_maxvol_iters: int = 10,
                       identity_submatrix: bool = True, top_k_index: int = -1):
    """`rect_maxvol` in NumPy, from `_maxvol_plain`'s rows."""
    return _rect_grow(_maxvol_plain, np.asarray(A), tol, maxK, min_add_K, minK,
                      start_maxvol_iters, identity_submatrix, top_k_index)


def _rect_grow(square, A, tol, maxK, min_add_K, minK, start_maxvol_iters,
               identity_submatrix, top_k_index):
    """Rectangular maxvol's growth in NumPy from the square rows of
    ``square`` (`maxvol` or `_maxvol_plain`)."""
    tol2 = tol**2
    N, r = A.shape
    if N <= r:
        return np.arange(N, dtype=np.int64), np.eye(N, dtype=A.dtype)
    top = N if top_k_index == -1 or top_k_index > N else max(top_k_index, r)
    maxK = N if maxK is None or maxK > N else max(maxK, r)
    minK = r if minK is None or minK < r else min(minK, N)
    if min_add_K is not None:
        minK = max(minK, r + min_add_K)
    minK = min(minK, maxK)

    index = np.zeros(N, dtype=np.int64)
    chosen = np.ones(top)
    tmp_index, C = square(A, 1.05, start_maxvol_iters, top_k_index=top)
    index[:r] = tmp_index
    chosen[tmp_index] = 0

    row_norm_sqr = np.einsum("ij,ij->i", C[:top], C[:top].conj()).real * chosen
    i = int(np.argmax(row_norm_sqr))
    K = r
    while (row_norm_sqr[i] > tol2 and K < maxK) or K < minK:
        index[K] = i
        chosen[i] = 0
        c = C[i].copy()
        v = C.dot(c.conj())
        l = 1.0 / (1 + v[i])
        C = C - l * np.outer(v, c)
        C = np.hstack([C, l * v.reshape(-1, 1)])
        row_norm_sqr = (row_norm_sqr - (l * v[:top] * v[:top].conj()).real) * chosen
        i = int(np.argmax(row_norm_sqr))
        K += 1

    if identity_submatrix:
        C[index[:K]] = np.eye(K, dtype=C.dtype)
    return index[:K].copy(), C


# The reference tntorch's names
py_maxvol = maxvol
py_rect_maxvol = rect_maxvol


# ---------------------------------------------------------------------------
# Device (torch)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _cusolver(device):
    """On the card, LU by cuSOLVER's getrf: torch's default sends a tall
    matrix to MAGMA's batched LU, which is built for small matrices (several
    times slower here, and it prints a warning per call)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _lu_pivots(mats: torch.Tensor) -> torch.Tensor:
    """LAPACK's pivots (int32, 1-based successive swaps) of a partially
    pivoted LU of each (n x r) matrix of ``mats`` (n x r, or a batch), with
    no check of the factorization's info (a check reads back from the
    card)."""
    with _cusolver(mats.device):
        return torch.linalg.lu_factor_ex(mats)[1]


def _device_lu_pivots(A: torch.Tensor) -> torch.Tensor:
    """The first r LU row pivots of a tall A (n x r), on A's device; of
    each matrix of a batch A (B x n x r) as (B x r).

    Above ``chunk`` rows, tournament pivoting (CALU, Grigori-Demmel-Xiang)
    as the JAX package does it: LU each block of ``chunk`` rows (the last
    padded with zero rows, which never win first), then LU the blocks'
    winners, and keep the first r winners that are real rows (a stable
    argsort of ``row >= n``). A batch takes one LU call and one `lu_rows`
    launch where one matrix takes one."""
    if A.ndim == 2:
        return _device_lu_pivots(A[None])[0]
    B, n, r = A.shape
    chunk = max(r, (1 << 20) // max(r, 1))
    if n <= chunk:
        return lu_rows(_lu_pivots(A), n, r)
    m = -(-n // chunk)
    Ap = torch.cat([A, A.new_zeros(B, m * chunk - n, r)], dim=1)
    rows = lu_rows(_lu_pivots(Ap.reshape(B * m, chunk, r)), chunk, r).reshape(B, m, r)
    cand = (rows + torch.arange(m, device=A.device)[:, None] * chunk).reshape(B, m * r)
    piv = cand.gather(1, lu_rows(_lu_pivots(_rows_of(Ap, cand)), m * r, m * r))
    piv = piv.gather(1, torch.argsort((piv >= n).to(torch.int32), dim=1, stable=True))
    return piv[:, :r].contiguous()


def _rows_of(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[b, rows[b]]`` for each b: x (B, n, ...) at the rows (B, k) of
    each batch entry, as (B, k, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], rows]


@policy_precision
def maxvol_device(A, tol: float = 1.05, max_iters: int = 100):
    """Maxvol on A's device: LU pivots, then at most ``max_iters`` swaps.
    Returns (row indices [r] int64, C = A @ inv(A[rows]) [n x r]) on that
    device. On the card it reads nothing back: the pivots' rows
    (`lu_rows`) and the swap loop (`maxvol_swaps`) are kernels, and the LU
    and the solve skip their info checks."""
    idx, C = _maxvol_device_batched(asarray(A)[None], tol, max_iters)
    return idx[0], C[0]


def _maxvol_device_batched(A: torch.Tensor, tol: float, max_iters: int):
    """`maxvol_device` of each matrix of a batch A (B x n x r): (rows [B x
    r] int64, C [B x n x r]), each matrix's as `maxvol_device` gives it
    alone. One batched LU, one `lu_rows` launch (a tournament takes two),
    one batched solve and one `maxvol_swaps` call for the batch; on the
    card it reads nothing back."""
    B, n, r = A.shape
    if n <= r:
        return (torch.arange(n, device=A.device).expand(B, n),
                torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n))
    with trace_annotation("tn.maxvol:lu"):
        idx = _device_lu_pivots(A)
    with trace_annotation("tn.maxvol:solve"), _cusolver(A.device):
        # as jnp.linalg.solve(S.T, A.T).T, without solve's check (a host sync)
        C = torch.linalg.solve_ex(_rows_of(A, idx).mT, A.mT)[0].mT.contiguous()
    with trace_annotation("tn.maxvol:swaps"):
        C, idx = maxvol_swaps(C, idx, tol, max_iters, _BLOCK)
    return idx, C


@policy_precision
def rect_maxvol_device(A, tol: float = 1.0, maxK: int = None, minK: int = None,
                       start_maxvol_iters: int = 10, identity_submatrix: bool = True):
    """Rectangular maxvol on A's device: `maxvol_device`'s pivots (no read
    back), then rows added as in `rect_maxvol`, with C held at ``maxK``
    columns as the JAX package holds it. Returns (row indices [K], C
    [n x K]); the host reads the stopping test once per added row."""
    A = asarray(A)
    n, r = A.shape
    if n <= r:
        return (torch.arange(n, device=A.device),
                torch.eye(n, dtype=A.dtype, device=A.device))
    maxK = n if maxK is None or maxK > n else max(maxK, r)
    minK = r if minK is None or minK < r else min(minK, n)
    minK = min(minK, maxK)
    tol2 = tol * tol

    idx_sq, C0 = maxvol_device(A, 1.05, start_maxvol_iters)
    index = torch.zeros(maxK, dtype=torch.int64, device=A.device)
    index[:r] = idx_sq
    real = A.real.dtype if A.is_complex() else A.dtype
    chosen = torch.ones(n, dtype=real, device=A.device)
    chosen[idx_sq] = 0.0
    C = torch.zeros((n, maxK), dtype=A.dtype, device=A.device)
    C[:, :r] = C0
    rns = torch.einsum("ij,ij->i", C0, C0.conj()).real * chosen
    K = r
    while K < minK or (K < maxK and bool(rns.max() > tol2)):
        i = rns.argmax().reshape(1)  # one-element indices: no read back
        index[K:K + 1] = i
        chosen.index_fill_(0, i, 0.0)
        c = C.index_select(0, i)[0]  # zero beyond column K, so the products stay exact
        v = C @ c.conj()
        l = 1.0 / (1.0 + v.gather(0, i))
        C = C - l * torch.outer(v, c)
        C[:, K] = l * v
        rns = (rns - (l * v * v.conj()).real) * chosen
        K += 1
    index, C = index[:K], C[:, :K]
    if identity_submatrix:
        C[index] = torch.eye(K, dtype=C.dtype, device=C.device)
    return index, C
