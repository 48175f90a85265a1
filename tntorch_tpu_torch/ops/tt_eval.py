"""Evaluation of a TT at integer coordinates, and its gradient, each as
hand-written CUDA kernels for Hopper (``csrc/tt_eval.cu``) with their plain
PyTorch versions beside them.

Counterpart of ``tntorch_tpu/ops/pallas_tt.py`` (``pallas_tt_eval`` and its
dispatcher ``tt_eval``) and of ``tntorch_tpu/parallel/mesh.py``'s
``tt_batch_forward``:

- ``tt_eval_kernel`` <- ``pallas_tt_eval``: the value of the TT with cores
  C_k (R_k, I_k, R_{k+1}) at each row of X (B, N): ``v <- ones(R_0)``,
  ``v <- v C_k[:, X[b,k], :]`` per mode, column 0 of the last interface.
  On the card it takes one of two kernels, chosen by the pure predicate
  `_grouped`:

  - *grouped* (N >= 3, at least ``_GROUP_MIN`` samples per slice of every
    middle mode, and at least ``_GROUP_MIN_BYTES`` of middle slices for the
    per-sample kernel to gather): the wrapper wraps and checks the
    coordinates and sorts each middle mode's with ``torch.sort``
    (`_group_operands`), then launches ``tt_eval_grouped_kernel`` once per
    middle mode. A block loads each slice ``C_k[:, i, :]`` once for the run
    of samples that share coordinate i in its tile and applies it to all of
    them, so each mode is a grouped product of FP32 FMAs; interfaces pass
    through device memory between modes. Mode 0 is a lookup in ``C_0.sum(0)`` and
    the last mode a dot in the last launch's epilogue. Bitwise
    reproducible: each value is summed in a fixed order whatever the sort.
  - *per sample* (every other shape, the training step's among them): one
    warp per sample gathers its own slices, in one launch.
- ``tt_eval_backward_kernel``: the cores' gradient of ``sum_b g_b
  value_b``, ``dC_k[:, i, :] = sum_{b: x_bk = i} g_b L_k[b] (outer)
  Rt_{k+1}[b]``. It has no Pallas counterpart (JAX differentiates
  ``tt_batch_forward`` in XLA); the training path needs it because its
  forward runs in a kernel. On the card it takes one of two paths, chosen
  by the pure predicate `_grouped_backward`:

  - *grouped* (N >= 3, at least ``_BWD_MIN`` samples per slice of every
    middle mode and ``_BWD_MIN_BYTES`` of middle slices, from the
    crossover on the card): stable sorts of every mode and their run
    bounds (`_group_operands`, `_run_bounds`); the left and right
    interfaces by the grouped forward kernel; then one
    ``slice_grad_kernel`` launch per mode that sums each slice over its run
    of sorted samples and writes it once, as `_slice_plan` lays out. No
    atomics, every entry summed in a fixed order: bitwise reproducible.
    Bounded by the interface launches and the FP32 FMAs of the middle
    reductions.
  - *per sample* (every other shape, the training step's among them): one
    warp per sample recomputes its interfaces and ``atomicAdd``s its outer
    products into the slices, in one launch. The atomics bound it where
    many samples share a slice, and their order varies: not bitwise
    reproducible.

`TTEval` joins the two as a ``torch.autograd.Function`` that saves only the
cores and X: the backward recomputes the interfaces. What bounds the kernels
on the card, and how they are laid out, is in the source's note.

Each wrapper takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it checks device, dtype (float32 or float64
cores, int32 or int64 coordinates), shapes and contiguity, launches its
kernels on the current stream, and raises on any failure: it never falls
back, neither to the plain version nor to the other kernel. Negative
coordinates wrap as in NumPy; an out-of-range one raises ``IndexError``
(the wrapper reads one flag back from the card per call). `TTEval`'s
backward passes ``checked=True``, since its forward already raised on the
same X: it reads no flag, so a training step reads the flag once (in its
forward), not twice. Each wrapper counts its calls that launched in a
plain integer attribute (``tt_eval_kernel.launches``), which only a launch
raises; ``.grouped`` counts those that took the grouped path.
"""

from __future__ import annotations

import bisect
import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from tntorch_tpu_torch.ops.gram_kernels import _on_cpu

MAX_MODES = 128  # csrc/tt_eval.cu: MAX_MODES, the modes one launch takes
_SMEM = 227 * 1024  # shared memory one block may use on Hopper
_DTYPES = {torch.float32: 0, torch.float64: 1}
_ITYPES = {torch.int32: 0, torch.int64: 1}
# The grouped kernel (csrc/tt_eval.cu: GT, GCOLS, GPAD, grouped_smem): sorted
# positions per block, output columns per pass, pad of a transposed row
_GROUP_TILE, _GROUP_COLS, _GROUP_PAD = 128, 64, 4
# From the crossover measured on the card (PERF.md): the grouped kernel serves
# a call when every middle mode has at least _GROUP_MIN samples per slice
# (B >= G * I_k) and the slices the per-sample kernel would gather come to at
# least _GROUP_MIN_BYTES, against which the grouped call's fixed cost (sorts
# and bookkeeping, ~0.3-0.5 ms) is small
_GROUP_MIN, _GROUP_MIN_BYTES = 64, 1 << 30
# The grouped backward's reduction (csrc/tt_eval.cu: slice_grad_kernel)
# takes P sorted positions a block, 1 to 8 steps of _SLICE_TILE (SMAXP =
# 1024 at most). From the crossover of whole calls on the card (PERF.md):
# the grouped backward serves a call when every middle mode has at least
# _BWD_MIN samples per slice and the middle slices of all samples come to at
# least _BWD_MIN_BYTES, against which its fixed cost (sorts, bookkeeping
# and ~30 launches, ~0.7-1 ms) is small
_SLICE_TILE = 128
_BWD_MIN, _BWD_MIN_BYTES = 64, 1 << 30
# The plain backward scatters its outer products in slices of at most this
# many elements, so that large batches stay within device memory
_CHUNK = 1 << 26


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _slice(core, x):
    """C[:, x_b, :] for every sample: (R, B, R')."""
    return core[:, x, :]


def tt_eval_plain(cores, X):
    """The gather-and-einsum chain of ``tt_batch_forward``: (B,) values."""
    c0 = cores[0]
    v = torch.ones((X.shape[0], c0.shape[0]), dtype=c0.dtype, device=c0.device)
    for k, core in enumerate(cores):
        v = torch.einsum("br,rbs->bs", v, _slice(core, X[:, k]))
    return v[:, 0]


def tt_eval_backward_plain(cores, X, g):
    """Gradient of ``sum_b g_b tt_eval(cores, X)_b`` with respect to every
    core: ``dC_k[:, x_bk, :] += g_b L_k[b] (outer) Rt_{k+1}[b]``, the outer
    products scatter-added with ``index_add_``."""
    B = X.shape[0]
    c0 = cores[0]
    lefts = [torch.ones((B, c0.shape[0]), dtype=c0.dtype, device=c0.device)]
    for k in range(len(cores) - 1):
        lefts.append(torch.einsum("br,rbs->bs", lefts[-1], _slice(cores[k], X[:, k])))
    grads = [torch.zeros_like(c) for c in cores]
    right = torch.zeros((B, cores[-1].shape[-1]), dtype=c0.dtype, device=c0.device)
    right[:, 0] = 1  # Rt_N = e_0: the value is column 0 of the last interface
    for k in reversed(range(len(cores))):
        Rl, I, Rr = cores[k].shape
        x = torch.where(X[:, k] < 0, X[:, k] + I, X[:, k])  # wraps negative coordinates
        gl = g[:, None] * lefts[k]
        step = max(1, _CHUNK // (Rl * Rr))
        for b0 in range(0, B, step):
            part = slice(b0, b0 + step)
            outer = gl[part, :, None] * right[part, None, :]  # (b, Rl, Rr)
            grads[k].index_add_(1, x[part], outer.permute(1, 0, 2))
        if k:
            right = torch.einsum("rbs,bs->br", _slice(cores[k], X[:, k]), right)
    return grads


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(name, cores, X, backward):
    """Validate the operands of a launch; returns (dtype code, index code,
    ranks, mode sizes)."""
    dtype = cores[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: kernel takes float32 or float64 cores, got {dtype}")
    if X.dtype not in _ITYPES:
        raise TypeError(f"{name}: kernel takes int32 or int64 coordinates, got {X.dtype}")
    N = len(cores)
    if not 1 <= N <= MAX_MODES:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_MODES} modes, got {N}")
    if X.ndim != 2 or X.shape[1] != N or not X.is_contiguous():
        raise ValueError(f"{name}: X must be a contiguous (B, {N}) array, got {tuple(X.shape)}")
    ranks, dims = [cores[0].shape[0]], []
    for k, c in enumerate(cores):
        if c.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {c.dtype}")
        if c.ndim != 3 or c.shape[0] != ranks[-1] or 0 in c.shape:
            raise ValueError(f"{name}: core {k} of shape {tuple(c.shape)} does not chain")
        if not c.is_contiguous():
            raise ValueError(f"{name}: cores must be contiguous")
        dims.append(c.shape[1])
        ranks.append(c.shape[2])
    per_warp = (2 * max(ranks) + (sum(ranks[:-1]) if backward else 0)) * cores[0].element_size()
    if per_warp > _SMEM:
        raise ValueError(f"{name}: one sample's interfaces ({per_warp} bytes) exceed "
                         f"a block's shared memory ({_SMEM} bytes)")
    return _DTYPES[dtype], _ITYPES[X.dtype], ranks, dims


def _launch(fn, *args):
    from tntorch_tpu_torch._build import library

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library("tt_eval"), fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _raise_if_flagged(flag, name):
    if int(flag.item()):
        raise IndexError(f"{name}: a coordinate is out of range for its mode "
                         "(mode k takes -I_k .. I_k - 1)")


def _grouped_smem(Rl, itemsize):
    """Shared memory of one grouped block (csrc/tt_eval.cu: grouped_smem):
    the tile's positions and keys, its input rows and one slice's columns."""
    return _GROUP_TILE * (8 + 4) + Rl * (_GROUP_TILE + _GROUP_PAD + _GROUP_COLS) * itemsize


def _grouped(ranks, dims, B, itemsize):
    """Whether `tt_eval_kernel` takes the grouped kernel: N >= 3; every
    middle mode k has a block that fits shared memory and at least
    ``_GROUP_MIN`` samples per slice (B >= _GROUP_MIN * I_k); and the
    middle slices of all samples come to ``_GROUP_MIN_BYTES`` or more."""
    mids = range(1, len(dims) - 1)
    return (len(dims) >= 3
            and B * sum(ranks[k] * ranks[k + 1] for k in mids) * itemsize >= _GROUP_MIN_BYTES
            and all(_grouped_smem(ranks[k], itemsize) <= _SMEM and B >= _GROUP_MIN * dims[k]
                    for k in mids))


def _group_operands(cores, X, modes=None, check=True):
    """The grouped paths' bookkeeping, in PyTorch on X's device: X (B, N)
    with coordinates wrapped into [0, I_k), as int32 (NumPy's wrap of
    negative ones; an out-of-range one lands somewhere in range, so no
    launch reads out of bounds); a flag (0-d) set when any was out of range,
    or None without `check`; for each mode k in `modes` (default the middle
    ones, 1..N-2) its sorted coordinates and the permutation that sorts
    them, by a stable sort (equal keys keep increasing b); C_0 summed over
    R_0, (I_0, R_1), the interface after mode 0 by coordinate; and
    C_{N-1}[:, :, 0] transposed, (I_{N-1}, R_{N-1})."""
    dims = [c.shape[1] for c in cores]
    modes = range(1, len(cores) - 1) if modes is None else modes
    hi = torch.tensor(dims, dtype=X.dtype).to(X.device)
    flag = ((X < -hi) | (X >= hi)).any() if check else None
    Xw = torch.remainder(X, hi).to(torch.int32)  # wraps, and keeps every key in range
    sorts = [torch.sort(Xw[:, k], stable=True) for k in modes]
    first = cores[0].sum(0)
    last = cores[-1][:, :, 0].t().contiguous()
    return Xw, flag, sorts, first, last


def _run_bounds(keys, I):
    """Where the run of each slice 0..I-1 starts in the sorted keys, and
    where the last ends: (I + 1,) int64, on the keys' device."""
    return torch.searchsorted(keys, torch.arange(I + 1, dtype=keys.dtype, device=keys.device))


def _slice_block(B):
    """Sorted positions per block of the grouped backward's reduction: 1 to
    8 steps of _SLICE_TILE, so that a batch of B samples gives ~512 blocks
    or more where it can."""
    return _SLICE_TILE * max(1, min(8, B // (_SLICE_TILE * 512)))


def _slice_plan(bounds, B, P):
    """The plan of the grouped backward's reduction (csrc/tt_eval.cu:
    slice_grad_kernel and its sum pass), in Python. Block x takes sorted
    positions [x P, min(B, (x + 1) P)) and, in order, the segment of each
    run of equal keys (one slice) that meets them. A segment that is its
    whole run goes straight into the slice (slot None); any other into
    partial slot 2x when its run began before the block (its first
    segment), else 2x + 1 (its last). The sum pass gives slice i the sum of
    its slots in block order (zeros for an empty slice). Returns
    (segments, slots): segments[x] lists (i, start, end, slot), slots[i]
    the slots of slice i."""
    bounds = [int(b) for b in bounds]
    segments, slots = [], [[] for _ in range(len(bounds) - 1)]
    for x in range(-(-B // P)):
        pb, pe = x * P, min(B, (x + 1) * P)
        segs, p = [], pb
        while p < pe:
            i = bisect.bisect_right(bounds, p) - 1  # the slice whose run holds p
            lo, hi = bounds[i], bounds[i + 1]
            slot = None if lo >= pb and hi <= pe else 2 * x + (lo > pb)
            segs.append((i, p, min(hi, pe), slot))
            if slot is not None:
                slots[i].append(slot)
            p = min(hi, pe)
        segments.append(segs)
    return segments, slots


def _grouped_backward(ranks, dims, B, itemsize):
    """Whether `tt_eval_backward_kernel` takes the grouped path: N >= 3;
    every middle mode k has grouped interface blocks that fit shared memory
    in both directions (R_k for the left sweep, R_{k+1} for the right) and
    at least ``_BWD_MIN`` samples per slice (B >= _BWD_MIN * I_k); and the
    middle slices of all samples come to ``_BWD_MIN_BYTES`` or more."""
    mids = range(1, len(dims) - 1)
    return (len(dims) >= 3
            and B * sum(ranks[k] * ranks[k + 1] for k in mids) * itemsize >= _BWD_MIN_BYTES
            and all(max(_grouped_smem(ranks[k], itemsize),
                        _grouped_smem(ranks[k + 1], itemsize)) <= _SMEM
                    and B >= _BWD_MIN * dims[k] for k in mids))


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _tt_eval_grouped(dcode, cores, X, ranks, out):
    """One grouped launch per middle mode; returns the out-of-range flag."""
    B, N = X.shape
    Xw, flag, sorts, first, last = _group_operands(cores, X)
    src, src_idx = first, _col(Xw, 0)  # mode 0's rows, looked up by coordinate
    for k in range(1, N - 2):
        src, src_idx = _interface(dcode, cores[k], *sorts[k - 1], src, src_idx, N), _ptr(None)
    keys, perm = sorts[-1]  # mode N-2, its epilogue dotted with C_{N-1}[:, x, 0]
    core = cores[N - 2]
    _launch("tnt_tt_eval_grouped", dcode, _ptr(core), ranks[N - 2], core.shape[1], ranks[N - 1],
            _ptr(keys), _ptr(perm), B, _ptr(src), src_idx, _ptr(None), _ptr(last),
            _col(Xw, N - 1), N, _ptr(out))
    return flag


def _col(Xw, k):
    """Column k of the wrapped coordinates (B, N) as a strided int32 pointer."""
    return ctypes.c_void_p(Xw.data_ptr() + k * Xw.element_size())


def _interface(dcode, core, keys, perm, src, src_idx, N):
    """Rows y_b = x_b core[:, x_bk, :] (B, R') of one mode for every sample,
    from rows x_b of src (or src[src_idx[b]]), by one grouped launch."""
    Rl, I, Rr = core.shape
    dst = torch.empty((len(perm), Rr), dtype=core.dtype, device=core.device)
    _launch("tnt_tt_eval_grouped", dcode, _ptr(core), Rl, I, Rr, _ptr(keys), _ptr(perm),
            len(perm), _ptr(src), src_idx, _ptr(dst), _ptr(None), _ptr(None), N, _ptr(None))
    return dst


def _tt_eval_backward_grouped(dcode, cores, X, g, ranks, check):
    """The grouped backward: stable sorts and run bounds of every mode; the
    left interfaces L_2..L_{N-1} and the right ones Rt_{N-2}..Rt_1 by the
    grouped forward kernel (the latter on each middle core transposed);
    then one slice reduction per mode. Returns the gradients and the
    out-of-range flag (None without `check`)."""
    B, N = X.shape
    dims = [c.shape[1] for c in cores]
    Xw, flag, sorts, first, last = _group_operands(cores, X, range(N), check)
    none = _ptr(None)
    # L_k for k = 0..N-1 as (table, index): ones, then C_0's sum by x_0
    lefts = [(None, none)] + [(first, _col(Xw, 0))] * (N > 1)
    for k in range(1, N - 1):
        lefts.append((_interface(dcode, cores[k], *sorts[k], *lefts[k], N), none))
    # Rt_k for k = 1..N: e_0 (no table), then C_{N-1}[:, :, 0] by x_{N-1}
    rights = {N: (None, none)}
    if N > 1:
        rights[N - 1] = (last, _col(Xw, N - 1))
    for k in range(N - 2, 0, -1):
        core_t = cores[k].permute(2, 1, 0).contiguous()  # (R_{k+1}, I_k, R_k)
        rights[k] = (_interface(dcode, core_t, *sorts[k], *rights[k + 1], N), none)
    flat = torch.empty(sum(c.numel() for c in cores), dtype=g.dtype, device=g.device)
    grads = [d.view(c.shape) for d, c in zip(torch.split(flat, [c.numel() for c in cores]), cores)]
    if ranks[N] > 1:
        grads[-1].zero_()  # the last mode's reduction writes column 0 only
    P = _slice_block(B)
    entries = max([ranks[k] * ranks[k + 1] for k in range(N - 1)] + [ranks[N - 1]])
    part = torch.empty(2 * -(-B // P) * entries, dtype=g.dtype, device=g.device)
    for k in range(N):
        keys, perm = sorts[k]
        I, Rr = dims[k], ranks[k + 1]
        if k < N - 1:  # rows g_b L_k[b], columns Rt_{k+1}[b]: dC_k[r, i, c]
            rows, cols, (A, aidx), (C, cidx) = ranks[k], Rr, lefts[k], rights[k + 1]
            strides = (Rr, I * Rr, 1)
        else:  # one row g_b (Rt_N = e_0), columns L_{N-1}[b]: dC_{N-1}[c, i, 0]
            rows, cols, (A, aidx), (C, cidx) = 1, ranks[k], (None, none), lefts[k]
            strides = (Rr, 1, I * Rr)
        bounds = _run_bounds(keys, I)
        _launch("tnt_tt_eval_slice_grad", dcode, I, rows, cols, _ptr(bounds), _ptr(keys),
                _ptr(perm), _ptr(g), B, P, _ptr(A), aidx, _ptr(C), cidx, N, _ptr(grads[k]),
                *strides, _ptr(part))
    return grads, flag


def tt_eval_kernel(cores, X):
    """Values (B,) of the TT ``cores`` at the rows of X (B, N)."""
    cores = list(cores)
    if _on_cpu(*cores, X):
        return tt_eval_plain(cores, X)
    dcode, icode, ranks, dims = _check("tt_eval", cores, X, backward=False)
    B, N = X.shape
    out = torch.empty(B, dtype=cores[0].dtype, device=X.device)
    if B == 0:
        return out
    with torch.cuda.device(X.device):
        if _grouped(ranks, dims, B, cores[0].element_size()):
            flag = _tt_eval_grouped(dcode, cores, X, ranks, out)
            tt_eval_kernel.grouped += 1
        else:
            flag = torch.zeros(1, dtype=torch.int32, device=X.device)
            _launch("tnt_tt_eval", dcode, icode, N,
                    _array(ctypes.c_void_p, [c.data_ptr() for c in cores]),
                    _array(ctypes.c_int, ranks), _array(ctypes.c_int, dims),
                    ctypes.c_void_p(X.data_ptr()), B, ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(flag.data_ptr()))
    tt_eval_kernel.launches += 1
    _raise_if_flagged(flag, "tt_eval")
    return out


def tt_eval_backward_kernel(cores, X, g, checked=False):
    """Gradients of ``sum_b g_b tt_eval(cores, X)_b``, one per core.
    ``checked=True`` says that X's coordinates are known to be in range (the
    forward already raised on the same X): on the card the call then reads
    no flag back, so it does not wait for the card. The kernels still guard
    every load."""
    cores = list(cores)
    if _on_cpu(*cores, X, g):
        return tt_eval_backward_plain(cores, X, g)
    dcode, icode, ranks, dims = _check("tt_eval_backward", cores, X, backward=True)
    B, N = X.shape
    if g.dtype != cores[0].dtype or tuple(g.shape) != (B,) or not g.is_contiguous():
        raise ValueError(f"tt_eval_backward: g must be a contiguous ({B},) {cores[0].dtype} array")
    if B == 0:
        return [torch.zeros_like(c) for c in cores]
    with torch.cuda.device(X.device):
        if _grouped_backward(ranks, dims, B, cores[0].element_size()):
            grads, flag = _tt_eval_backward_grouped(dcode, cores, X, g, ranks, not checked)
            tt_eval_backward_kernel.grouped += 1
        else:
            flat = torch.zeros(sum(c.numel() for c in cores), dtype=g.dtype, device=g.device)
            grads = [d.view(c.shape)
                     for d, c in zip(torch.split(flat, [c.numel() for c in cores]), cores)]
            flag = torch.zeros(1, dtype=torch.int32, device=X.device)
            _launch("tnt_tt_eval_backward", dcode, icode, N,
                    _array(ctypes.c_void_p, [c.data_ptr() for c in cores]),
                    _array(ctypes.c_void_p, [d.data_ptr() for d in grads]),
                    _array(ctypes.c_int, ranks), _array(ctypes.c_int, dims),
                    ctypes.c_void_p(X.data_ptr()), ctypes.c_void_p(g.data_ptr()), B,
                    ctypes.c_void_p(flag.data_ptr()))
    tt_eval_backward_kernel.launches += 1
    if not checked:
        _raise_if_flagged(flag, "tt_eval_backward")
    return grads


tt_eval_kernel.launches = 0
tt_eval_kernel.grouped = 0
tt_eval_backward_kernel.launches = 0
tt_eval_backward_kernel.grouped = 0

KERNELS = (tt_eval_kernel, tt_eval_backward_kernel)
PLAIN = {tt_eval_kernel: tt_eval_plain, tt_eval_backward_kernel: tt_eval_backward_plain}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = k.grouped = 0


# ---------------------------------------------------------------------------
# Autograd and dispatch
# ---------------------------------------------------------------------------

class TTEval(torch.autograd.Function):
    """``TTEval.apply(X, *cores)``: `tt_eval_kernel` forward,
    `tt_eval_backward_kernel` backward. Saves only X and the cores."""

    @staticmethod
    def forward(ctx, X, *cores):
        X = X.contiguous()
        cores = [c.contiguous() for c in cores]
        ctx.save_for_backward(X, *cores)
        return tt_eval_kernel(cores, X)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        X, *cores = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        if not any(needs):
            return (None,) * (1 + len(cores))
        # checked: the forward raised on any out-of-range coordinate of X
        grads = tt_eval_backward_kernel(cores, X, g.contiguous(), True)
        return (None, *(d if need else None for d, need in zip(grads, needs)))


def _as_coords(X, cores):
    """X as a (B, N) int32/int64 tensor on the cores' device."""
    device = cores[0].device
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.asarray(X))
    if X.dtype not in _ITYPES:
        if X.dtype.is_floating_point or X.dtype.is_complex or X.dtype == torch.bool:
            raise TypeError(f"coordinates must be integers, got {X.dtype}")
        X = X.long()
    if X.ndim != 2 or X.shape[1] != len(cores):
        raise ValueError(f"X must have shape (B, {len(cores)}), got {tuple(X.shape)}")
    return X.to(device)


def tt_eval(cores, X, use_kernel=None):
    """Evaluate a TT (list of cores (R_k, I_k, R_{k+1})) at the B integer
    coordinate rows of X (B, N); returns (B,) values, column 0 of the last
    interface (as the JAX package's ``tt_eval``/``tt_batch_forward``).

    Real cores go through `TTEval`: on the card the forward and backward
    kernels run (float32 and float64; other dtypes raise), on the CPU their
    plain versions. Complex cores take the plain gather-and-einsum chain,
    as the JAX dispatcher takes its XLA chain for non-float32 input.
    ``use_kernel=False`` (the counterpart of ``use_pallas=False``) takes
    that chain for any input. Differentiable with respect to the cores."""
    cores = list(cores)
    X = _as_coords(X, cores)
    if use_kernel is False or cores[0].is_complex():
        return tt_eval_plain(cores, X)
    return TTEval.apply(X, *cores)


def tt_batch_forward(cores, X):
    """Evaluate a TT at a batch of integer index vectors (the compressed
    fancy-indexing forward pass), through `tt_eval`'s dispatcher."""
    return tt_eval(cores, X)
