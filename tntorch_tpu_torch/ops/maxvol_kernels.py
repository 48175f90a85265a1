"""The two steps of the device maxvol that the JAX package leaves to XLA,
each as a hand-written CUDA kernel for Hopper (``csrc/maxvol_device.cu``)
with its plain PyTorch version beside it.

Neither replaces a Pallas kernel: each replaces an XLA construct of
``tntorch_tpu/maxvol.py``, so that `maxvol.maxvol_device` reads nothing back
from the card:

- ``lu_rows`` <- the permutation output of ``jax.lax.linalg.lu`` in
  ``_device_lu_pivots`` (maxvol.py:185-216): the first k rows of each
  block's row permutation, composed from the LAPACK pivots (npiv successive
  swaps, int32, 1-based) that ``torch.linalg.lu_factor_ex`` returns. One
  CTA per permutation traces each output position back through the swaps;
  beyond npiv only the positions the swaps touched are traced. No scratch.
- ``maxvol_swaps`` <- the ``lax.while_loop`` of ``_maxvol_device_body``
  (maxvol.py:242-263): while ``it < max_iters`` and ``max|C| > tol``, the
  row of the largest |C[i, j]| swapped into pivot slot j and C updated by
  rank 1, in one launch. `_swap_plan`, a pure function of the shape, the
  item size and the card's SMs, picks one of three routes: a thread block
  cluster of 1-16 CTAs with C in their shared memory (to 1 MiB), a
  cooperative grid of one CTA per SM with C in their shared memory (to ~29
  MB on 132 SMs), or the same grid with C streamed through L2 beyond that
  (csrc/maxvol_device.cu says how each works). It also takes a batch of
  matrices of one shape: on the cluster route one launch, a cluster a
  matrix; on the grid routes one launch a matrix, in stream order.

What bounds them on an H100: ``lu_rows`` is launch latency (npiv^2
compare-selects spread over a block; the call's host work, a few tens of
microseconds, outweighs its kernel); ``maxvol_swaps`` is the swaps times
one exchange across the CTAs that hold C and one pass over a CTA's share
of C, where the plain version launches ~10 small kernels per iteration
and reads a flag back every ``block`` iterations.

Each wrapper takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it checks device, dtype, shape and contiguity,
launches its kernel on the current stream and raises on any failure,
a refused cluster or cooperative launch included: it never falls back.
Complex C takes the plain swap loop on every device, by dtype (the kernels
are written for float32 and float64), as the port routes complex input
elsewhere. Each wrapper counts its launches in a plain integer attribute
(``lu_rows.launches``), which only a launch of the kernel raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tntorch_tpu_torch.ops.gram_kernels import _on_cpu, _ptr

_DTYPES = {torch.float32: 0, torch.float64: 1}
_ROUTES = {"cluster": 0, "resident": 1, "streamed": 2}
# Dynamic shared memory a swap CTA may take (csrc/maxvol_device.cu:
# swap_smem): the H100's 227 KB a block less 2 KB for the static part (the
# reductions, the cluster's inbox of candidates)
_SMEM_BYTES = 225 * 1024
# CTAs of a cluster: at most 16, the non-portable size Hopper allows
_MAX_CLUSTER = 16
# Entries of C a cluster CTA takes at least, while the cluster can grow
_CLUSTER_ENTRIES = 4096
# The largest C (bytes) on the cluster route; beyond it the grid routes.
# Timed in turns on an H100 (`python3 chip_smoke.py --only 18x`, r = 100,
# two runs): the cluster is ahead up to 1.00 MiB in float32 and 1.25 MiB in
# float64, the resident grid from 1.25 and 1.54 MiB on, so the limit sits
# at the last size where both dtypes favour the cluster, below what 16 CTAs
# could hold
_CLUSTER_MAX_BYTES = 1 << 20
# SMs of the card the plan is made for when none is given (H100 SXM)
_SMS = 132


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
    while loop's result). A batch (C: B x n x r, idx: B x r) runs the loop
    on each matrix in turn. Returns new (C, idx)."""
    if C.ndim == 3:
        if not C.shape[0]:
            return C, idx
        outs = [maxvol_swaps_plain(c, i, tol, max_iters, block) for c, i in zip(C, idx)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
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

def _cta_bytes(rows: int, r: int, itemsize: int, extra: int) -> int:
    """Dynamic shared memory of a swap CTA holding ``rows`` rows of C (r
    columns) at an odd row stride, and ``extra`` rows of r + 1 more: the
    2 x CTAs row copies of a cluster's inbox, the pivot row on a grid."""
    return (rows * (r | 1) + extra * (r + 1)) * itemsize


def _cta_rows(r: int, itemsize: int, extra: int) -> int:
    """The most rows of C a swap CTA holds in shared memory."""
    return max(0, (_SMEM_BYTES // itemsize - extra * (r + 1)) // (r | 1))


def _even(n: int, ctas: int) -> int:
    """``ctas`` CTAs, fewer if ceil(n / ctas) rows each leaves some empty."""
    return -(-n // -(-n // ctas))


def _swap_plan(n: int, r: int, itemsize: int, sms: int = _SMS) -> tuple:
    """The swap kernel's route and CTAs for C (n x r) of this item size on
    a card of ``sms`` SMs: ("cluster", 1-16) while C fits the shared memory
    of 16 CTAs and is at most _CLUSTER_MAX_BYTES, one CTA per
    _CLUSTER_ENTRIES entries (at least as many as C needs); else
    ("resident", blocks) while C fits the shared memory of one CTA per SM;
    else ("streamed", blocks). Every CTA owns ceil(n / CTAs) rows, the last
    what is left."""
    cluster = lambda k: -(-n // k) <= _cta_rows(r, itemsize, 2 * k)  # noqa: E731
    if n * r * itemsize <= _CLUSTER_MAX_BYTES and cluster(min(n, _MAX_CLUSTER)):
        least = next(k for k in range(1, _MAX_CLUSTER + 1) if cluster(k))
        return "cluster", _even(n, min(n, _MAX_CLUSTER, max(least, -(-n * r // _CLUSTER_ENTRIES))))
    blocks = _even(n, min(n, sms))
    return ("resident" if -(-n // blocks) <= _cta_rows(r, itemsize, 1) else "streamed"), blocks


def _launch(fn, *args):
    from tntorch_tpu_torch._build import library

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library("maxvol_device"), fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")


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
            _launch("tnt_lu_rows", _ptr(piv), batch, piv.shape[1], n, k, _ptr(rows))
            lu_rows.launches += 1
    return rows


def maxvol_swaps(C: torch.Tensor, idx: torch.Tensor, tol: float, max_iters: int,
                 block: int = 4):
    """The guarded swap loop of maxvol on C (n x r) and the pivot rows idx
    (r, int64): while fewer than ``max_iters`` iterations ran and ``max|C|
    > tol``, swap the row of the largest |C[i, j]| into slot j and update C
    by rank 1. A batch, C (B x n x r) and idx (B x r), runs the loop on
    each matrix. Returns (C, idx). On the card the kernel `_swap_plan`
    picks for one n x r matrix updates C and idx in place and reads
    nothing back: one launch for the batch on the cluster route, one a
    matrix on the grid routes, each counted; on the CPU, and for complex
    C, `maxvol_swaps_plain` (``block``: its guarded iterations per host
    check)."""
    batch = C.shape[0] if C.ndim == 3 else None
    n, r = C.shape[-2:]
    if C.ndim not in (2, 3) or tuple(idx.shape) != C.shape[:-2] + (r,):
        raise ValueError(f"maxvol_swaps: idx of shape {tuple(idx.shape)} for C of shape "
                         f"{tuple(C.shape)}")
    if _on_cpu(C, idx) or C.is_complex():
        return maxvol_swaps_plain(C, idx, tol, max_iters, block)
    if C.dtype not in _DTYPES:
        raise TypeError(f"maxvol_swaps: kernel takes float32 or float64, got {C.dtype}")
    if idx.dtype != torch.int64 or not (C.is_contiguous() and idx.is_contiguous()):
        raise ValueError("maxvol_swaps: C and an int64 idx must be contiguous")
    if n == 0 or r == 0 or max_iters <= 0 or batch == 0:
        return C, idx
    with torch.cuda.device(C.device):
        sms = torch.cuda.get_device_properties(C.device).multi_processor_count
        route, ctas = _swap_plan(n, r, C.element_size(), sms)
        scratch = [None] * 2
        if route != "cluster":  # the grid's candidates and their row copies
            scratch = [torch.empty((2 * ctas, 2), dtype=torch.int64, device=C.device),
                       torch.empty((2 * ctas, r + 1), dtype=C.dtype, device=C.device)]
        _launch("tnt_maxvol_swaps", _DTYPES[C.dtype], _ROUTES[route], _ptr(C), _ptr(idx),
                batch or 1, n, r, float(tol), int(max_iters), ctas, *map(_ptr, scratch))
    maxvol_swaps.launches += 1 if route == "cluster" else batch or 1
    return C, idx


lu_rows.launches = 0
maxvol_swaps.launches = 0

KERNELS = (lu_rows, maxvol_swaps)
PLAIN = {lu_rows: lu_rows_plain, maxvol_swaps: maxvol_swaps_plain}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
