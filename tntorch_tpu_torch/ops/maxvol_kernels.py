"""The two steps of the device maxvol that the JAX package leaves to XLA,
each as a hand-written CUDA kernel for Hopper (``csrc/maxvol_device.cu``)
with its plain PyTorch version beside it.

Neither replaces a Pallas kernel: each replaces an XLA construct of
``tntorch_tpu/maxvol.py``, so that `maxvol.maxvol_device` reads nothing back
from the card:

- ``lu_rows`` <- the permutation output of ``jax.lax.linalg.lu`` in
  ``_device_lu_pivots`` (maxvol.py:185-216): the first k rows of each
  block's row permutation, composed from the LAPACK pivots (r successive
  swaps, int32, 1-based) that ``torch.linalg.lu_factor_ex`` returns;
- ``maxvol_swaps`` <- the ``lax.while_loop`` of ``_maxvol_device_body``
  (maxvol.py:242-263): while ``it < max_iters`` and ``max|C| > tol``, the
  row of the largest |C[i, j]| swapped into pivot slot j and C updated by
  rank 1, in one launch. It has two kernels, chosen by a pure function of
  the shape and dtype, `_swap_route`: one CTA with C resident in shared
  memory, or a grid-synchronised cooperative launch over row ranges of C
  in device memory (csrc/maxvol_device.cu says how each works).

What bounds them on an H100: ``lu_rows`` is a few microseconds of launch;
``maxvol_swaps`` reads and writes C once per iteration (2 n r itemsize
bytes), where the plain version launches ~10 small kernels per iteration
and reads a flag back every ``block`` iterations.

Each wrapper takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it checks device, dtype, shape and contiguity,
launches its kernel on the current stream and raises on any failure: it
never falls back. Complex C takes the plain swap loop on every device, by
dtype (the kernels are written for float32 and float64), as the port
routes complex input elsewhere. Each wrapper counts its launches in a
plain integer attribute (``lu_rows.launches``), which only a launch of the
kernel raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tntorch_tpu_torch.ops.gram_kernels import _on_cpu, _ptr

_DTYPES = {torch.float32: 0, torch.float64: 1}
# The resident swap kernel's shared memory: C (n x r), row i (r) and a tile
# of column-j quotients (csrc/maxvol_device.cu: kTile), at most what a block
# may use less a margin for its static reductions
_TILE = 1024
_RESIDENT_BYTES = 200 * 1024
# Entries of C per block of the grid-synchronised kernel, at least
_GRID_ENTRIES = 4096


def lu_rows_plain(piv: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The first ``k`` rows of the row permutation of n rows that LAPACK's
    pivots ``piv`` (batch x npiv, 1-based successive swaps) describe, as
    (batch x k) int64 on ``piv``'s device: each swap applied to arange(n) in
    order, on the host."""
    p = piv.cpu().numpy().astype(np.int64) - 1
    order = np.tile(np.arange(n), (p.shape[0], 1))
    for b in range(p.shape[0]):
        for s, o in enumerate(p[b]):
            order[b, s], order[b, o] = order[b, o], order[b, s]
    return torch.from_numpy(order[:, :k].copy()).to(piv.device)


def _swap(C: torch.Tensor, idx: torch.Tensor, tol: float, eye: torch.Tensor):
    """One guarded maxvol iteration: where max|C| > tol, swap the row of the
    largest |C[i, j]| into pivot slot j and update C by rank 1; elsewhere
    return C and idx as they are. The JAX package's loop body, op by op
    (``eye``, the r x r identity, gives row i minus 1 at j). Every index
    stays a one-element tensor: a 0-d tensor index would be read back to the
    host."""
    r = C.shape[1]
    flat = C.abs().argmax().reshape(1)
    i, j = flat // r, flat % r
    piv = C.reshape(-1).gather(0, flat)
    ok = piv.abs() > tol
    row = C.index_select(0, i)[0] - eye.index_select(0, j)[0]
    col = C.index_select(1, j)[:, 0]
    C = torch.where(ok, C - torch.outer(col / piv, row), C)
    idx = torch.where(ok, idx.scatter(0, j, i), idx)
    return C, idx


def maxvol_swaps_plain(C: torch.Tensor, idx: torch.Tensor, tol: float, max_iters: int,
                       block: int = 4):
    """The swap loop in torch ops: guarded iterations (`_swap`) in blocks of
    ``block``, with a host check of ``max|C| > tol`` after each block (a
    guarded iteration after convergence changes nothing, so this is the
    while loop's result). Returns new (C, idx)."""
    eye = torch.eye(C.shape[1], dtype=C.dtype, device=C.device)
    done = 0
    while done < max_iters:
        step = min(block, max_iters - done)
        for _ in range(step):
            C, idx = _swap(C, idx, tol, eye)
        done += step
        if not bool(C.abs().max() > tol):
            break
    return C, idx


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _swap_route(n: int, r: int, itemsize: int) -> str:
    """Which swap kernel takes C (n x r) of this item size: "resident" when
    C, row i and a tile of quotients fit one block's shared memory, else
    "grid"."""
    return "resident" if (n * r + r + _TILE) * itemsize <= _RESIDENT_BYTES else "grid"


def _launch(fn, *args):
    from tntorch_tpu_torch._build import library

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library("maxvol_device"), fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _grid_wave(code: int, r: int, device_index: int) -> int:
    """Blocks of the grid-synchronised kernel that the card holds at once
    (occupancy x SMs): the most a cooperative launch may take."""
    from tntorch_tpu_torch._build import library

    per_sm = library("maxvol_device").tnt_maxvol_grid_occupancy(code, r)
    if per_sm <= 0:
        raise RuntimeError(f"tnt_maxvol_grid_occupancy: CUDA error {-per_sm}" if per_sm else
                           "tnt_maxvol_grid_occupancy: the kernel fits no SM")
    return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def _grid_blocks(n: int, r: int, wave: int) -> int:
    """Blocks of a grid launch on C (n x r): one per _GRID_ENTRIES entries,
    at most a wave and at most n, each owning ceil(n / blocks) rows."""
    blocks = max(1, min(wave, n, -(-n * r // _GRID_ENTRIES)))
    return -(-n // -(-n // blocks))  # no block left without rows


def lu_rows(piv: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The first ``k`` rows (batch x k, int64) of each row permutation of
    ``n`` rows given by LAPACK's pivots ``piv`` (batch x npiv, int32,
    1-based). On the card it runs ``lu_rows_kernel``."""
    if piv.ndim != 2 or not 0 <= k <= n or piv.shape[1] > n:
        raise ValueError(f"lu_rows: pivots of shape {tuple(piv.shape)} for {n} rows, k={k}")
    if _on_cpu(piv):
        return lu_rows_plain(piv, n, k)
    if piv.dtype != torch.int32 or not piv.is_contiguous():
        raise TypeError(f"lu_rows: pivots must be contiguous int32, got {piv.dtype}")
    batch = piv.shape[0]
    with torch.cuda.device(piv.device):
        rows = torch.empty((batch, k), dtype=torch.int64, device=piv.device)
        if batch and k:
            scratch = torch.empty((batch, n), dtype=torch.int32, device=piv.device)
            _launch("tnt_lu_rows", _ptr(piv), batch, piv.shape[1], n, k, _ptr(scratch),
                    _ptr(rows))
            lu_rows.launches += 1
    return rows


def maxvol_swaps(C: torch.Tensor, idx: torch.Tensor, tol: float, max_iters: int,
                 block: int = 4):
    """The guarded swap loop of maxvol on C (n x r) and the pivot rows idx
    (r, int64): while fewer than ``max_iters`` iterations ran and ``max|C|
    > tol``, swap the row of the largest |C[i, j]| into slot j and update C
    by rank 1. Returns (C, idx). On the card one launch of the kernel
    `_swap_route` picks, which updates C and idx in place and reads nothing
    back; on the CPU, and for complex C, `maxvol_swaps_plain` (``block``:
    its guarded iterations per host check)."""
    n, r = C.shape
    if tuple(idx.shape) != (r,):
        raise ValueError(f"maxvol_swaps: idx of shape {tuple(idx.shape)} for {r} columns")
    if _on_cpu(C, idx) or C.is_complex():
        return maxvol_swaps_plain(C, idx, tol, max_iters, block)
    if C.dtype not in _DTYPES:
        raise TypeError(f"maxvol_swaps: kernel takes float32 or float64, got {C.dtype}")
    if idx.dtype != torch.int64 or not (C.is_contiguous() and idx.is_contiguous()):
        raise ValueError("maxvol_swaps: C and an int64 idx must be contiguous")
    if n == 0 or r == 0 or max_iters <= 0:
        return C, idx
    code = _DTYPES[C.dtype]
    with torch.cuda.device(C.device):
        if _swap_route(n, r, C.element_size()) == "resident":
            _launch("tnt_maxvol_swaps", code, 0, _ptr(C), _ptr(idx), n, r, float(tol),
                    int(max_iters), 0, _ptr(None), _ptr(None), _ptr(None))
        else:
            blocks = _grid_blocks(n, r, _grid_wave(code, r, C.device.index))
            cand_v = torch.empty(2 * blocks, dtype=C.dtype, device=C.device)
            cand_i = torch.empty(2 * blocks, dtype=torch.int64, device=C.device)
            cand_rows = torch.empty((2 * blocks, r), dtype=C.dtype, device=C.device)
            _launch("tnt_maxvol_swaps", code, 1, _ptr(C), _ptr(idx), n, r, float(tol),
                    int(max_iters), blocks, _ptr(cand_v), _ptr(cand_i), _ptr(cand_rows))
    maxvol_swaps.launches += 1
    return C, idx


lu_rows.launches = 0
maxvol_swaps.launches = 0

KERNELS = (lu_rows, maxvol_swaps)
PLAIN = {lu_rows: lu_rows_plain, maxvol_swaps: maxvol_swaps_plain}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
