"""The host maxvol library (``csrc/maxvol_host.cpp``) over ctypes.

Counterpart of ``tntorch_tpu/_native``: `native_maxvol`,
`native_maxvol_iterate` and `native_rect_maxvol` on the port's own library,
which `_build` compiles with the host C++ compiler into
``tntorch_tpu_torch/_build/`` at first use. There is no fallback: where the
compiler is missing or fails, the first call raises `RuntimeError` (the
JAX package's loader returns None there and runs NumPy instead).

float32 matrices stay float32 (the ``*_f32`` entry points); any other dtype
is pivoted in float64. One difference from the JAX package's loader, on
purpose: `native_maxvol_iterate` swaps in a copy of the rows it is given and
returns it, where the JAX package writes the caller's array.

`calls` counts the calls of each entry point that reached the library.
"""

from __future__ import annotations

import ctypes

import numpy as np

calls = {"maxvol": 0, "maxvol_iterate": 0, "rect_maxvol": 0}


def reset_calls():
    for name in calls:
        calls[name] = 0


def _lib():
    from tntorch_tpu_torch._build import library

    return library("maxvol_host")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _float32(A: np.ndarray) -> bool:
    return A.dtype == np.float32


def native_maxvol(A: np.ndarray, tol: float, max_iters: int):
    """maxvol in C++ alone (its own LU start, solve and swap loop): (rows
    [r] int64, C = A inv(A[rows]) [n x r]); None when the LU start's block
    is exactly singular."""
    f32 = _float32(A)
    A = np.ascontiguousarray(A, dtype=np.float32 if f32 else np.float64)
    n, r = A.shape
    if n <= r:
        return np.arange(n, dtype=np.int64), np.eye(n, dtype=A.dtype)
    index = np.zeros(r, dtype=np.int64)
    C = np.zeros((n, r), dtype=A.dtype)
    lib = _lib()
    fn = lib.tnt_maxvol_f32 if f32 else lib.tnt_maxvol
    calls["maxvol"] += 1
    if fn(_ptr(A), n, r, float(tol), int(max_iters), _ptr(index), _ptr(C)) != 0:
        return None
    return index, C


def native_maxvol_iterate(C: np.ndarray, index, tol: float, max_iters: int) -> np.ndarray:
    """The swap loop on C = A inv(A[index]) (C-contiguous float32 or
    float64, updated in place) for at most ``max_iters`` swaps, until max
    |C| <= tol. Returns the rows after the swaps: a copy of ``index``,
    which stays as it was."""
    rows = np.array(index, dtype=np.int64)  # a copy
    if not (C.ndim == 2 and C.flags.c_contiguous and C.dtype in (np.float32, np.float64)
            and rows.shape == (C.shape[1],)):
        raise ValueError("native_maxvol_iterate takes a C-contiguous float32 or float64 C "
                         "(n x r) and r rows")
    n, r = C.shape
    lib = _lib()
    fn = lib.tnt_maxvol_iterate_f32 if _float32(C) else lib.tnt_maxvol_iterate
    calls["maxvol_iterate"] += 1
    fn(_ptr(C), n, r, float(tol), int(max_iters), _ptr(rows))
    return rows


def native_rect_maxvol(A: np.ndarray, tol: float, maxK, minK, start_maxvol_iters: int,
                       identity_submatrix: bool):
    """Rectangular maxvol in C++: (rows [K] int64, C [n x K]); None when the
    square start's block is exactly singular."""
    f32 = _float32(A)
    A = np.ascontiguousarray(A, dtype=np.float32 if f32 else np.float64)
    n, r = A.shape
    if n <= r:
        return np.arange(n, dtype=np.int64), np.eye(n, dtype=A.dtype)
    maxK = n if maxK is None else int(maxK)
    minK = r if minK is None else int(minK)
    maxK = min(max(maxK, r), n)
    index = np.zeros(maxK, dtype=np.int64)
    C = np.zeros((n, maxK), dtype=A.dtype)
    K = np.zeros(1, dtype=np.int64)
    lib = _lib()
    fn = lib.tnt_rect_maxvol_f32 if f32 else lib.tnt_rect_maxvol
    calls["rect_maxvol"] += 1
    if fn(_ptr(A), n, r, float(tol), maxK, minK, int(start_maxvol_iters),
          1 if identity_submatrix else 0, _ptr(index), _ptr(C), _ptr(K)) != 0:
        return None
    K = int(K[0])
    return index[:K].copy(), C[:, :K].copy()
