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
  - *per sample* (every other shape: the training step's, ``cp[X]``,
    completion, the cross validations): ``tt_eval_kernel`` in one launch, as
    the pure `_per_sample_plan` lays it out. Each sample has a lane group of
    W lanes sized to its ranks (8 samples a warp at ranks 3-4, 2 at rank
    16); up to rank 32 a lane keeps its column of the running interface in
    a register and each mode is a chain of shuffle-FMAs over coalesced
    loads of the slice's rows; above, one warp a sample keeps it in shared
    memory. Coordinates are loaded W modes at a time by neighbouring lanes
    and handed out by shuffle; cores that fit ``_HELD_BYTES`` are staged in
    shared memory once a block where ``_STAGE_MIN`` samples or more share
    each staged element; the grid is persistent. Bounded by each mode's
    instructions (its setup, then a shuffle-FMA a row) at small ranks, by
    the L2 gathers of R x R slices at large ones. Bitwise reproducible.
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
  - *per sample* (every other shape, the training step's among them): the
    forward's lane groups (with up to 4 interface columns a lane in
    registers, to rank 128) recompute each sample's left interfaces into
    shared memory, then sweep right to left, adding each outer product into
    the gradient by atomics. A core whose gradient fits ``_HELD_BYTES`` and
    has at least ``_PRIV_MIN`` samples per slice is privatized: each block
    sums into a copy in shared memory and adds it once to the gradient, so
    samples that share a slice no longer serialize on global atomics. Each
    row's instructions and the atomics left bound it, and the atomics'
    order varies: not bitwise reproducible.

`TTEval` joins the two as a ``torch.autograd.Function`` that saves only the
cores and X: the backward recomputes the interfaces. What bounds the kernels
on the card, and how they are laid out, is in the source's note.

Half precision and long chains. bfloat16 and float16 cores take the
per-sample kernels at every shape (`_grouped` and `_grouped_backward`
refuse them: the grouped kernels have float32 and float64 instances only).
They compute in float32 and round each interface to the cores' dtype after
its mode, as each einsum of the plain chain rounds its output; the values
come back in the cores' dtype, and the backward sums its gradients in a
float32 scratch that the wrapper rounds to the cores' dtype once. A chain
of any number of modes is taken: up to ``MAX_MODES`` the kernels read the
mode table from their parameter struct, beyond it from a copy in device
memory (`_mode_table`); where one warp's left interfaces do not fit a
block's shared memory, the backward keeps them in a device-memory scratch
of one slot a warp of its grid (`Plan.bwd_spill`, at most ``_SPILL_BYTES``).
Both take the kernels' general instances, which the others never do.
Float32 and float64 chains take the grouped routes only where each middle
mode brings enough slices: the byte floors grow with the middle modes past
two (`_floor_bytes`), since the grouped routes pay their fixed cost once a
mode.

Each wrapper takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it checks device, dtype (float32, float64,
bfloat16 or float16 cores, int32 or int64 coordinates), shapes and
contiguity, launches its kernels on the current stream, and raises on any
failure: it never falls back, neither to the plain version nor to the
other kernel. Negative
coordinates wrap as in NumPy; an out-of-range one raises ``IndexError``
(the wrapper reads one flag back from the card per call). `TTEval`'s
backward passes ``checked=True``, since its forward already raised on the
same X: it reads no flag, so a training step reads the flag once (in its
forward), not twice. `CheckedTTEval`'s forward (``tt_eval(...,
checked=True)``) reads none, for coordinates in range by construction. Each wrapper counts its calls that launched in a
plain integer attribute (``tt_eval_kernel.launches``), which only a launch
raises; ``.grouped`` counts those that took the grouped path.

Under ``torch.profiler`` the dispatch records its spans
(`utils.trace_annotation`): ``tn.tt_eval`` around `tt_eval`,
``tn.tt_eval:operands`` and ``tn.tt_eval:launch`` in `tt_eval_kernel` on
the card, ``tn.tt_eval_backward`` with its own two on autograd's thread,
and ``tn.wait:*`` around each copy or read that waits for the card (the
dimensions' copy, the flag's read, coordinates from the host).
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import sys
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from tntorch_tpu_torch.ops.gram_kernels import _on_cpu
from tntorch_tpu_torch.utils import trace_annotation

MAX_MODES = 128  # csrc/tt_eval.cu: MAX_MODES, the modes the kernels' parameter struct holds
_SMEM = 227 * 1024  # shared memory one block may use on Hopper
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}
# The per-sample kernels' arithmetic type: float32 for the half types
_ACC = {torch.bfloat16: torch.float32, torch.float16: torch.float32}
_ITYPES = {torch.int32: 0, torch.int64: 1}
# The grouped kernel (csrc/tt_eval.cu: GT, GCOLS, GPAD, grouped_smem): sorted
# positions per block, output columns per pass, pad of a transposed row
_GROUP_TILE, _GROUP_COLS, _GROUP_PAD = 128, 64, 4
# From the crossover measured on the card (PERF.md): the grouped kernel serves
# a call when every middle mode has at least _GROUP_MIN samples per slice
# (B >= G * I_k) and the slices the per-sample kernel would gather come to at
# least _GROUP_MIN_BYTES, against which the grouped call's fixed cost (sorts
# and bookkeeping, ~0.3-0.5 ms) is small (at R = 64 the per-sample kernel is
# ahead through 64 samples per slice, the grouped one from 128)
_GROUP_MIN, _GROUP_MIN_BYTES = 128, 1 << 30
# The grouped backward's reduction (csrc/tt_eval.cu: slice_grad_kernel)
# takes P sorted positions a block, 1 to 8 steps of _SLICE_TILE (SMAXP =
# 1024 at most). From the crossover of whole calls on the card (PERF.md):
# the grouped backward serves a call when every middle mode has at least
# _BWD_MIN samples per slice and the middle slices of all samples come to at
# least _BWD_MIN_BYTES, against which its fixed cost (sorts, bookkeeping
# and ~30 launches, ~0.7-1 ms) is small
_SLICE_TILE = 128
_BWD_MIN, _BWD_MIN_BYTES = 64, 1 << 30
# Both byte floors were set at N = 3-4, over at most two middle modes. The
# grouped route's fixed cost is paid once a middle mode (a sort, launches),
# so past two middle modes the floor grows with them: at 2^16 samples, 200
# modes of rank 8 in float32 (16 MiB of slices a mode) ran 2.3-2.9x slower
# grouped than per sample, 512 modes of rank 64 in float64 (2 GiB a mode)
# 4.1-4.5x faster (PERF.md).


def _floor_bytes(floor, modes):
    """The slices' byte floor of a grouped route over ``modes`` modes: the
    N = 3-4 floor, scaled by the middle modes past two."""
    return floor * max(1, (modes - 2) / 2)
# The plain backward scatters its outer products in slices of at most this
# many elements, so that large batches stay within device memory
_CHUNK = 1 << 26
# The per-sample kernels (csrc/tt_eval.cu: WARPS, the register template's
# columns a lane): warps a block at most; the bytes of cores a block stages
# (forward) or of gradients it privatizes (backward) in shared memory. From
# the card (PERF.md): staging pays from _STAGE_MIN samples per staged element
# (each block first waits for its copy, so a block needs many samples), a
# privatized gradient from _PRIV_MIN samples per slice (B >= _PRIV_MIN *
# I_k; below, zeroing and adding the block's copy costs more than the global
# atomics it saves)
_WARPS, _COLS = 8, (1, 2, 4)
_HELD_BYTES = 48 * 1024
_STAGE_MIN, _PRIV_MIN = 64, 256
# Most bytes of the backward's left interfaces kept in device memory where
# they do not fit a block (Plan.bwd_spill): the grid is cut to as many
# warps as this holds slots, at least one block
_SPILL_BYTES = 1 << 30


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

def _check(name, cores, X):
    """Validate the operands of a launch; returns (dtype code, index code,
    ranks, mode sizes)."""
    dtype = cores[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: kernel takes float32, float64, bfloat16 or float16 cores, "
                        f"got {dtype}")
    if X.dtype not in _ITYPES:
        raise TypeError(f"{name}: kernel takes int32 or int64 coordinates, got {X.dtype}")
    N = len(cores)
    if N < 1:
        raise ValueError(f"{name}: the kernel takes one mode or more, got {N}")
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
    return _DTYPES[dtype], _ITYPES[X.dtype], tuple(ranks), tuple(dims)


def _launch(fn, *args):
    from tntorch_tpu_torch._build import library

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library("tt_eval"), fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _acc_itemsize(itemsize):
    """Bytes of the per-sample kernels' arithmetic type for cores of
    ``itemsize`` bytes: float32 for the half types."""
    return max(itemsize, 4)


@functools.lru_cache(maxsize=512)
def _ints(values):
    """A tuple of ints as a ctypes array, made once and kept: the kernels
    only read it."""
    return _array(ctypes.c_int, values)


def _raise_if_flagged(flag, name):
    with trace_annotation("tn.wait:flag"):
        flagged = int(flag.item())
    if flagged:
        raise IndexError(f"{name}: a coordinate is out of range for its mode "
                         "(mode k takes -I_k .. I_k - 1)")


class Plan(NamedTuple):
    """How the per-sample kernels run a chain (`_per_sample_plan`)."""

    W: int            # lanes a sample: 32 // W samples a warp
    fwd_cols: int     # interface columns a lane keeps in registers, forward: 1; 0: in shared memory
    bwd_cols: int     # the same, backward: 1, 2 or 4; 0: in shared memory
    staged: bool      # forward: every core staged in shared memory
    private: tuple    # backward: per core, its gradient summed in shared memory first
    fwd_warps: int    # warps a block (0: one warp's buffers exceed a block) and its shared
    fwd_smem: int     # memory (bytes), forward
    bwd_warps: int    # the same, backward
    bwd_smem: int
    bwd_spill: bool   # backward: the left interfaces in device memory, not shared


def _round4(n):
    return -(-n // 4) * 4


def _lefts_elems(W, cols, lsize):
    """Elements of the left interfaces one warp keeps (csrc/tt_eval.cu:
    lefts_elems): those of its 32 / W samples, or of its one sample with the
    interface in shared memory (cols 0)."""
    return (1 if cols == 0 else 32 // W) * lsize


def _warp_elems(backward, W, cols, maxr, lsize, spill=False):
    """Elements of one warp's shared buffers (csrc/tt_eval.cu: warp_elems):
    with the interface in shared memory (cols 0) two interfaces; backward,
    the left interfaces too (`_lefts_elems`), unless ``spill`` keeps them in
    device memory."""
    return (2 * maxr if cols == 0 else 0) + (
        _lefts_elems(W, cols, lsize) if backward and not spill else 0)


def _per_sample_smem(held, held_size, per_warp, warp_size):
    """Warps a block and its shared memory (csrc/tt_eval.cu:
    per_sample_smem): the held copy of ``held`` elements of ``held_size``
    bytes (staged cores in the cores' type, privatized gradients in the
    arithmetic type), then one buffer a warp of ``per_warp`` elements of
    ``warp_size`` bytes (the arithmetic type); _WARPS warps, halved until
    they fit, or (0, 0) when one does not."""
    def smem(warps):
        return held * held_size + warps * per_warp * warp_size

    warps = _WARPS
    while warps > 1 and smem(warps) > _SMEM:
        warps //= 2
    return (warps, smem(warps)) if smem(warps) <= _SMEM else (0, 0)


@functools.lru_cache(maxsize=256)  # a launch's host time: ~7 us a call on the card's host
def _per_sample_plan(ranks, dims, B, itemsize, W=None, staged=None, private=None, shared=False):
    """The plan of the per-sample kernels for a chain of ranks R_0..R_N and
    mode sizes I_k (tuples) at B samples, cores of ``itemsize`` bytes, pure.
    Interfaces and gradients are in the arithmetic type (float32 for 2-byte
    cores, `_acc_itemsize`), a staged core in the cores' type. W: the
    smallest power of two
    >= the widest interface the chain carries (max of R_0..R_{N-1}; R_N is
    never carried, only column 0 of the last mode is), at most 32. Columns a
    lane: the backward keeps ceil(max / W) rounded up to 1, 2 or 4, else 0
    (the interface in shared memory, one warp a sample: from rank 129); the
    forward 1, else 0 (from rank 33: its shared-memory interface measured
    faster on the card than 2 and 4 columns a lane). staged (forward, 1
    column a lane only): all the cores fit _HELD_BYTES and there are at
    least _STAGE_MIN samples per staged element. private: each core in mode
    order with at least _PRIV_MIN samples per slice whose gradient still
    fits _HELD_BYTES with those before it. bwd_spill: one warp's left
    interfaces (sum of R_0..R_{N-1} a sample) do not fit a block beside the
    privatized gradients, so they go to device memory (a long chain's, or
    ranks in the hundreds). A chain past MAX_MODES (both kernels) and a
    spilled backward take the kernels' general instances, which stage no
    cores and privatize no last core. The keyword arguments force a
    choice (a wider W, staging or privatizing on or off, ``shared=True``:
    the interface in shared memory), as the tests and chip_smoke.py do. A
    kernel whose buffers do not fit a block gets 0 warps (`_plan_for`
    raises when it is launched); raises ValueError where W cannot carry the
    ranks."""
    N = len(dims)
    maxr = max(ranks[:-1])
    need = 32 if shared else min(32, 1 << (maxr - 1).bit_length())
    W = need if W is None else W
    if W not in (1, 2, 4, 8, 16, 32) or W < need:
        raise ValueError(f"per-sample tt_eval: {W} lanes do not carry rank {maxr}")
    bwd_cols = 0 if shared else next((c for c in _COLS if c * W >= maxr), 0)
    fwd_cols = int(bwd_cols == 1)
    sizes = [_round4(ranks[k] * dims[k] * ranks[k + 1]) for k in range(N)]
    acc = _acc_itemsize(itemsize)
    if staged is None:
        staged = sum(sizes) <= _HELD_BYTES // itemsize and B >= _STAGE_MIN * sum(sizes)
    staged = bool(staged) and fwd_cols == 1 and N <= MAX_MODES
    if private is None or isinstance(private, bool):
        chosen, used = [], 0
        for size, I in zip(sizes, dims):
            chosen.append(private is True or (private is None and B >= _PRIV_MIN * I
                                              and used + size <= _HELD_BYTES // acc))
            used += size * chosen[-1]
        private = tuple(chosen)
    lsize = sum(ranks[:-1])
    fwd = _per_sample_smem(sum(sizes) * staged, itemsize,
                           _warp_elems(False, W, fwd_cols, maxr, lsize), acc)

    def backward(private, spill):
        held = sum(s for s, p in zip(sizes, private) if p)
        return _per_sample_smem(held, acc, _warp_elems(True, W, bwd_cols, maxr, lsize, spill), acc)

    if N > MAX_MODES:
        private = private[:-1] + (False,)
    spill = not backward(private, False)[0]
    if spill:
        private = private[:-1] + (False,)
    return Plan(W, fwd_cols, bwd_cols, staged, private, *fwd, *backward(private, spill), spill)


def _plan_for(name, ranks, dims, B, itemsize, backward):
    """`_per_sample_plan` for the kernel about to launch (the backward's
    when ``backward``); raises ValueError where that kernel's buffers do not
    fit a block, whatever the other's."""
    plan = _per_sample_plan(ranks, dims, B, itemsize)
    if not (plan.bwd_warps if backward else plan.fwd_warps):
        raise ValueError(f"{name}: ranks {list(ranks)} at mode sizes {list(dims)} exceed a "
                         f"block's shared memory ({_SMEM} bytes)")
    return plan


def _grouped_smem(Rl, itemsize):
    """Shared memory of one grouped block (csrc/tt_eval.cu: grouped_smem):
    the tile's positions and keys, its input rows and one slice's columns."""
    return _GROUP_TILE * (8 + 4) + Rl * (_GROUP_TILE + _GROUP_PAD + _GROUP_COLS) * itemsize


def _grouped(ranks, dims, B, itemsize):
    """Whether `tt_eval_kernel` takes the grouped kernel: float32 or float64
    cores (``itemsize`` 4 or 8: the grouped kernel has no half-precision
    instance, so bfloat16 and float16 cores take the per-sample kernel at
    every shape); N >= 3; every
    middle mode k has a block that fits shared memory and at least
    ``_GROUP_MIN`` samples per slice (B >= _GROUP_MIN * I_k); and the
    middle slices of all samples come to ``_GROUP_MIN_BYTES`` or more, that
    floor scaled by the middle modes past two (`_floor_bytes`)."""
    mids = range(1, len(dims) - 1)
    return (itemsize >= 4 and len(dims) >= 3
            and B * sum(ranks[k] * ranks[k + 1] for k in mids) * itemsize
            >= _floor_bytes(_GROUP_MIN_BYTES, len(dims))
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
    with trace_annotation("tn.wait:dims_copy"):  # pageable memory: the copy waits for the card
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
    """Whether `tt_eval_backward_kernel` takes the grouped path: float32 or
    float64 cores (its grouped interface launches and ``slice_grad_kernel``
    have no half-precision instance, so bfloat16 and float16 cores take the
    per-sample kernel at every shape); N >= 3;
    every middle mode k has grouped interface blocks that fit shared memory
    in both directions (R_k for the left sweep, R_{k+1} for the right) and
    at least ``_BWD_MIN`` samples per slice (B >= _BWD_MIN * I_k); and the
    middle slices of all samples come to ``_BWD_MIN_BYTES`` or more, that
    floor scaled by the middle modes past two (`_floor_bytes`)."""
    mids = range(1, len(dims) - 1)
    return (itemsize >= 4 and len(dims) >= 3
            and B * sum(ranks[k] * ranks[k + 1] for k in mids) * itemsize
            >= _floor_bytes(_BWD_MIN_BYTES, len(dims))
            and all(max(_grouped_smem(ranks[k], itemsize),
                        _grouped_smem(ranks[k + 1], itemsize)) <= _SMEM
                    and B >= _BWD_MIN * dims[k] for k in mids))


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _mode_rows(cores, grads, ranks, dims, held):
    """A chain's mode table as the per-sample kernels read it from device
    memory (csrc/tt_eval.cu: Mode), pure: one 32-byte row a mode, the core's
    and the gradient's addresses (0 for none), then R_k, R_{k+1}, I_k as
    int32 and the core's place in the block's shared copy (elements: the
    held cores' sizes, each rounded up to 4, in mode order; -1 if not held).
    ``cores`` and ``grads`` are addresses (ints). Returns an (N, 4) int64
    array."""
    N = len(dims)
    rows = np.zeros((N, 4), np.int64)
    rows[:, 0] = cores
    rows[:, 1] = grads
    ints = rows.view(np.int32).reshape(N, 8)  # little-endian, as the card reads it
    ints[:, 4], ints[:, 5], ints[:, 6] = ranks[:-1], ranks[1:], dims
    sizes = [_round4(ranks[k] * dims[k] * ranks[k + 1]) * bool(h) for k, h in enumerate(held)]
    ints[:, 7] = np.where(held, np.cumsum([0] + sizes[:-1]), -1)
    return rows


def _mode_table(cores, grads, ranks, dims, held):
    """A chain's mode table in device memory (`_mode_rows`, copied from
    pinned memory without waiting for the card), for the kernels' general
    instances: a chain past ``MAX_MODES`` (shorter ones pass theirs in the
    parameter struct), or a backward whose left interfaces spill."""
    rows = _mode_rows([c.data_ptr() for c in cores],
                      [0] * len(cores) if grads is None else [d.data_ptr() for d in grads],
                      ranks, dims, held)
    return torch.from_numpy(rows).pin_memory().to(cores[0].device, non_blocking=True)


def _tt_eval_grouped(dcode, cores, X, ranks, out):
    """One grouped launch per middle mode; returns the out-of-range flag."""
    B, N = X.shape
    with trace_annotation("tn.tt_eval:operands"):
        Xw, flag, sorts, first, last = _group_operands(cores, X)
    with trace_annotation("tn.tt_eval:launch"):
        src, src_idx = first, _col(Xw, 0)  # mode 0's rows, looked up by coordinate
        for k in range(1, N - 2):
            src, src_idx = _interface(dcode, cores[k], *sorts[k - 1], src, src_idx, N), _ptr(None)
        keys, perm = sorts[-1]  # mode N-2, its epilogue dotted with C_{N-1}[:, x, 0]
        core = cores[N - 2]
        _launch("tnt_tt_eval_grouped", dcode, _ptr(core), ranks[N - 2], core.shape[1],
                ranks[N - 1], _ptr(keys), _ptr(perm), B, _ptr(src), src_idx, _ptr(None),
                _ptr(last), _col(Xw, N - 1), N, _ptr(out))
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
    with trace_annotation("tn.tt_eval_backward:operands"):
        Xw, flag, sorts, first, last = _group_operands(cores, X, range(N), check)
        bounds = [_run_bounds(keys, I) for (keys, _), I in zip(sorts, dims)]
    with trace_annotation("tn.tt_eval_backward:launch"):
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
        grads = [d.view(c.shape)
                 for d, c in zip(torch.split(flat, [c.numel() for c in cores]), cores)]
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
            _launch("tnt_tt_eval_slice_grad", dcode, I, rows, cols, _ptr(bounds[k]),
                    _ptr(keys), _ptr(perm), _ptr(g), B, P, _ptr(A), aidx, _ptr(C), cidx, N,
                    _ptr(grads[k]), *strides, _ptr(part))
    return grads, flag


def tt_eval_kernel(cores, X, checked=False):
    """Values (B,) of the TT ``cores`` at the rows of X (B, N).
    ``checked=True`` says that X's coordinates are known to be in range: on
    the card the call then reads no flag back (the kernels still guard every
    load)."""
    cores = list(cores)
    if _on_cpu(*cores, X):
        return tt_eval_plain(cores, X)
    dcode, icode, ranks, dims = _check("tt_eval", cores, X)
    B, N = X.shape
    out = torch.empty(B, dtype=cores[0].dtype, device=X.device)
    if B == 0:
        return out
    with torch.cuda.device(X.device):
        if _grouped(ranks, dims, B, cores[0].element_size()):
            flag = _tt_eval_grouped(dcode, cores, X, ranks, out)
            tt_eval_kernel.grouped += 1
        else:
            with trace_annotation("tn.tt_eval:operands"):
                plan = _plan_for("tt_eval", ranks, dims, B, cores[0].element_size(), False)
                flag = torch.zeros(1, dtype=torch.int32, device=X.device)
                table = (_mode_table(cores, None, ranks, dims, [False] * N) if N > MAX_MODES
                         else None)
            with trace_annotation("tn.tt_eval:launch"):
                _launch("tnt_tt_eval", dcode, icode, N,
                        _array(ctypes.c_void_p, [c.data_ptr() for c in cores]),
                        _ints(ranks), _ints(dims), _ptr(table), ctypes.c_void_p(X.data_ptr()),
                        B, ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(flag.data_ptr()),
                        plan.W, plan.fwd_cols, plan.staged, plan.fwd_warps)
    tt_eval_kernel.launches += 1
    if not checked:
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
    dcode, icode, ranks, dims = _check("tt_eval_backward", cores, X)
    B, N = X.shape
    if g.dtype != cores[0].dtype or tuple(g.shape) != (B,) or not g.is_contiguous():
        raise ValueError(f"tt_eval_backward: g must be a contiguous ({B},) {cores[0].dtype} array")
    if B == 0:
        return [torch.zeros_like(c) for c in cores]
    with trace_annotation("tn.tt_eval_backward"), torch.cuda.device(X.device):
        if _grouped_backward(ranks, dims, B, cores[0].element_size()):
            grads, flag = _tt_eval_backward_grouped(dcode, cores, X, g, ranks, not checked)
            tt_eval_backward_kernel.grouped += 1
        else:
            grads, flag = _tt_eval_backward_per_sample(dcode, icode, cores, X, g, ranks, dims)
        tt_eval_backward_kernel.launches += 1
        if not checked:
            _raise_if_flagged(flag, "tt_eval_backward")
    return grads


def _tt_eval_backward_per_sample(dcode, icode, cores, X, g, ranks, dims):
    """The per-sample backward: one launch into a zeroed gradient buffer in
    the kernel's arithmetic type (float32 for half cores, rounded to the
    cores' dtype once, after the launch), with the left interfaces in a
    device-memory scratch where the plan spills them. Returns the gradients
    and the out-of-range flag."""
    B, N = X.shape
    acc = _ACC.get(g.dtype, g.dtype)

    def views(flat):
        return [d.view(c.shape) for d, c in zip(torch.split(flat, [c.numel() for c in cores]),
                                                 cores)]

    with trace_annotation("tn.tt_eval_backward:operands"):
        plan = _plan_for("tt_eval_backward", ranks, dims, B, cores[0].element_size(), True)
        flat = torch.zeros(sum(c.numel() for c in cores), dtype=acc, device=g.device)
        grads = views(flat)
        flag = torch.zeros(1, dtype=torch.int32, device=X.device)
        spill, slots = None, 0
        if plan.bwd_spill:
            per = _lefts_elems(plan.W, plan.bwd_cols, sum(ranks[:-1]))
            warps = -(-B // (32 // plan.W))  # the warps the samples need
            slots = max(plan.bwd_warps, min(warps, _SPILL_BYTES // (per * flat.element_size())))
            spill = torch.empty(slots * per, dtype=acc, device=g.device)
        table = (_mode_table(cores, grads, ranks, dims, plan.private)
                 if N > MAX_MODES or plan.bwd_spill else None)
    with trace_annotation("tn.tt_eval_backward:launch"):
        _launch("tnt_tt_eval_backward", dcode, icode, N,
                _array(ctypes.c_void_p, [c.data_ptr() for c in cores]),
                _array(ctypes.c_void_p, [d.data_ptr() for d in grads]),
                _ints(ranks), _ints(dims), _ptr(table), ctypes.c_void_p(X.data_ptr()),
                ctypes.c_void_p(g.data_ptr()), B, ctypes.c_void_p(flag.data_ptr()), plan.W,
                plan.bwd_cols, _ints(plan.private), plan.bwd_warps, _ptr(spill), slots)
        return (grads if acc == g.dtype else views(flat.to(g.dtype))), flag


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
        return _save_and_eval(ctx, X, cores, False)

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


class CheckedTTEval(TTEval):
    """`TTEval` for coordinates known to be in range: on the card the
    forward reads no flag back, so it does not wait for the card."""

    @staticmethod
    def forward(ctx, X, *cores):
        return _save_and_eval(ctx, X, cores, True)


def _save_and_eval(ctx, X, cores, checked):
    X = X.contiguous()
    cores = [c.contiguous() for c in cores]
    ctx.save_for_backward(X, *cores)
    return tt_eval_kernel(cores, X, checked)


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
    if X.device == device:
        return X
    with trace_annotation("tn.wait:coords_copy"):  # from the host: the copy waits for the card
        return X.to(device)


def _distributed(*xs) -> bool:
    """Whether any of ``xs`` is a DTensor (none can be before
    ``torch.distributed.tensor`` is imported, which `parallel` does on use)."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and any(isinstance(x, module.DTensor) for x in xs)


def tt_eval(cores, X, use_kernel=None, use_pallas=None, checked=False):
    """Evaluate a TT (list of cores (R_k, I_k, R_{k+1})) at the B integer
    coordinate rows of X (B, N); returns (B,) values, column 0 of the last
    interface (as the JAX package's ``tt_eval``/``tt_batch_forward``).

    Real cores go through `TTEval`: on the card the forward and backward
    kernels run (float32, float64, bfloat16 and float16, at any number of
    modes; other dtypes raise), on the CPU their plain versions. Complex
    cores take the plain gather-and-einsum chain, as the JAX dispatcher
    takes its XLA chain for non-float32 input.
    ``use_kernel=False`` takes that chain for any input; ``use_pallas``,
    the JAX package's name for it, is an alias. ``checked=True`` says that
    X's coordinates are known to be in range (`CheckedTTEval`: on the card
    no flag is read back). Differentiable with respect to the cores.

    Where X or the cores are DTensors (X sharded over its rows, the cores
    replicated: `parallel`), each rank evaluates its rows this way and the
    values come back as a DTensor (`parallel.mesh.dtensor_tt_eval`)."""
    if use_kernel is None:
        use_kernel = use_pallas
    cores = list(cores)
    if _distributed(X, *cores):
        from tntorch_tpu_torch.parallel.mesh import dtensor_tt_eval

        return dtensor_tt_eval(cores, X, use_kernel, checked)
    with trace_annotation("tn.tt_eval"):
        X = _as_coords(X, cores)
        if use_kernel is False or cores[0].is_complex():
            return tt_eval_plain(cores, X)
        return (CheckedTTEval if checked else TTEval).apply(X, *cores)


def tt_batch_forward(cores, X):
    """Evaluate a TT at a batch of integer index vectors (the compressed
    fancy-indexing forward pass), through `tt_eval`'s dispatcher."""
    return tt_eval(cores, X)
