"""The three contractions of the batched Gram-rounding sweep, each as a
hand-written CUDA kernel for Hopper (``csrc/gram_kernels.cu``) with its plain
PyTorch version beside it.

They replace the Pallas TPU kernels of ``tntorch_tpu/ops/pallas_gram.py``:

- ``gram_edge`` <- ``pallas_gram_edge``: right-Gram edge
  ``G'[a,d] = sum_i sum_c (C_i G)[a,c] C_i[d,c]``;
- ``wgram`` <- ``pallas_wgram``: weighted left Gram ``sum_i C_i^T W C_i``;
- ``proj2`` <- ``pallas_proj2``: double-sided projection ``Y C_i X`` per i.

What bounds them on an H100: at the bench shape (B=32, Rl=Rr=128, I=256,
f32) an edge does ~128 FLOP per byte of C it reads, far above the ~20 FLOP/B
ridge of FP32 FMA against HBM, so in exact f32 they are compute-bound, not
memory-bound as on the TPU. The kernels keep the intermediate (T = C G, W C,
Y C) in shared memory as the TPU kernels kept it in VMEM. Tensor cores are
later work.

``gram_edge`` and ``wgram`` have two kernels, chosen by a pure function of
the shape and dtype, `_gram_resident`. In float32 with Rl, Rr <= 128 they
run the resident-Gram kernel: one wave of persistent blocks, each walking a
contiguous run of the B x I items (z, i) that `_gram_plan` gives it, with G
(or W) loaded once per sample, C_i streamed once per i through a
``cp.async`` ring and the sum over i held in registers; each block writes
one partial per sample its run touches, and a second pass sums each
sample's partials in a fixed order (no atomics, deterministic). Elsewhere
(float64, ranks above 128) they run the two-stage kernel, which splits I
across blocks until a wave is full and sums the splits the same way.

``proj2`` has two kernels, chosen by a pure function of the shape,
`_proj2_resident`. Where r1 <= 64, r2 <= 64, Rr <= 128 and Y, X, the
intermediate and a 3-stage ring of C slices fit the 227 KB of shared memory
a block may use (Rl <= 320 in float32, <= 144 in float64), it runs the
resident-projector kernel: persistent blocks, one wave, each walking a
contiguous run of (z, i) items with Y and X loaded once per sample and C
streamed through a ``cp.async`` ring. Beyond that tile it runs the two-stage
kernel that ``gram_edge`` and ``wgram`` use, per i.

Each wrapper takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it checks device, dtype (float32 or float64), shape
and contiguity, launches its kernel on the current stream, and raises on any
failure: it never falls back. Each wrapper counts its launches in a plain
integer attribute (``gram_edge.launches``), which only a launch of the
kernel raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPES = {torch.float32: 0, torch.float64: 1}
# Output tile of a block (csrc/gram_kernels.cu): 64 rows by 128 columns for
# gram_edge and wgram, by 64 columns for proj2
_TM, _TN_GRAM, _TN_PROJ = 64, 128, 64
_MAX_GRID_YZ = 65535
# The resident proj2 kernel's tile (r1 and r2, Rr), its ring stages, and per
# item size its mode indices per work unit and k-slice depth; the shared
# memory a block may use
_RES_R, _RES_RR, _RES_STAGES = 64, 128, 3
_RES_UNIT = {4: (2, 16), 8: (1, 8)}
_SMEM_MAX = 232448
# The resident-Gram kernel's tile: Rl, Rr <= 128, float32 only
_GRAM_R = 128


def _proj2_smem(Rl: int, itemsize: int) -> int:
    """Shared bytes of the resident proj2 kernel: Y^T (Rl rounded up to a
    k-slice, by 64), X (128 x 64), the intermediate (128 x 64 per mode
    index of a unit) and the ring of C slices."""
    ip, ks = _RES_UNIT[itemsize]
    krl = -(-Rl // ks) * ks
    return itemsize * (krl * _RES_R + _RES_RR * _RES_R + _RES_RR * ip * _RES_R
                       + _RES_STAGES * ks * ip * _RES_RR)


def _proj2_resident(r1: int, Rl: int, Rr: int, r2: int, itemsize: int) -> bool:
    """True when proj2 of these ranks runs the resident-projector kernel:
    the shape fits its tile and its shared memory fits one block."""
    return (r1 <= _RES_R and r2 <= _RES_R and Rr <= _RES_RR
            and _proj2_smem(Rl, itemsize) <= _SMEM_MAX)


def _gram_resident(Rl: int, Rr: int, itemsize: int) -> bool:
    """True when gram_edge and wgram of these ranks run the resident-Gram
    kernel: float32, both ranks within its 128 x 128 tile (its shared
    memory, G or W, T and the ring, is fixed at 224 KB)."""
    return itemsize == 4 and Rl <= _GRAM_R and Rr <= _GRAM_R


def _gram_plan(B: int, I: int, blocks: int):
    """The resident-Gram kernel's work plan for `blocks` blocks over the
    B x I items (z, i), numbered z * I + i: block j walks items
    [run[j], run[j + 1]) in order and writes the partial sum of each sample
    its run touches, the first into slot first[j] and one slot further for
    each sample after; sample z's partials are slots [sample[z],
    sample[z + 1]), in block order, and are summed in that order. Returns
    the three lists (run, first, sample)."""
    units = B * I
    if not 1 <= blocks <= units:
        raise ValueError(f"need 1 <= blocks <= B * I = {units}, got {blocks}")
    run = [units * j // blocks for j in range(blocks + 1)]
    first, sample = [], [None] * B + [0]
    slots = 0
    for j in range(blocks):
        first.append(slots)
        z_first, z_last = run[j] // I, (run[j + 1] - 1) // I
        for z in range(z_first, z_last + 1):
            if sample[z] is None:
                sample[z] = slots + z - z_first
        slots += z_last - z_first + 1
    sample[B] = slots
    return run, first, sample


@functools.lru_cache(maxsize=64)
def _plan_on(B: int, I: int, blocks: int, device_index: int):
    """`_gram_plan` as one int64 tensor on the card, made once per shape,
    and its number of slots."""
    run, first, sample = _gram_plan(B, I, blocks)
    plan = torch.tensor(run + first + sample, dtype=torch.int64,
                        device=torch.device("cuda", device_index))
    return plan, sample[-1]


def _gram_resident_launch(edge: int, C, Q, out):
    """gram_edge (edge 0) or wgram (edge 1) through the resident-Gram kernel."""
    B, Rl, I, Rr = C.shape
    M = out.shape[-1]
    blocks = min(B * I, _wave(0, 3, C.device.index))
    plan, slots = _plan_on(B, I, blocks, C.device.index)
    part = torch.empty((slots, M, M), dtype=C.dtype, device=C.device)
    _launch("tnt_gram_resident", edge, _ptr(C), _ptr(Q), _ptr(out), _ptr(part), _ptr(plan),
            B, Rl, I, Rr, blocks)


# ---------------------------------------------------------------------------
# Plain versions: the einsum equivalences the TPU kernels' docstrings state
# ---------------------------------------------------------------------------

def gram_edge_plain(C, G):
    """(B, Rl, I, Rr), (B, Rr, Rr) -> (B, Rl, Rl)."""
    return torch.einsum("zaic,zdic->zad", torch.einsum("zaib,zbc->zaic", C, G), C)


def wgram_plain(C, W):
    """(B, Rl, I, Rr), (B, Rl, Rl) -> (B, Rr, Rr): einsum('zaib,zad,zdic->zbc')."""
    return torch.einsum("zaib,zaic->zbc", C, torch.einsum("zad,zdic->zaic", W, C))


def proj2_plain(Y, C, X):
    """(B, r1, Rl), (B, Rl, I, Rr), (B, Rr, r2) -> (B, r1, I, r2)."""
    return torch.einsum("zrib,zbc->zric", torch.einsum("zra,zaib->zrib", Y, C), X)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*ts) -> bool:
    """True when every operand is on the CPU; raises on a device mix or on a
    device the kernels do not serve."""
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(name, ts, shapes):
    dtype = ts[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: kernel takes float32 or float64, got {dtype}")
    for t, want in zip(ts, shapes):
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: expected shape {tuple(want)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if any(s <= 0 for want in shapes for s in want):
        raise ValueError(f"{name}: empty operand")
    if shapes[0][0] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: batch {shapes[0][0]} exceeds the grid limit")
    return _DTYPES[dtype]


@functools.lru_cache(maxsize=None)
def _wave(code: int, kernel: int, device_index: int, Rl: int = 0) -> int:
    """Blocks of one kernel that the card holds at once (occupancy x SMs).
    Kernels: 0 two-stage Gram, 1 two-stage proj2, 2 resident proj2 (sized
    for its shared memory at Rl), 3 resident Gram."""
    from tntorch_tpu_torch._build import library

    per_sm = library("gram_kernels").tnt_occupancy(code, kernel, Rl)
    if per_sm <= 0:
        raise RuntimeError(f"tnt_occupancy: CUDA error {-per_sm}" if per_sm else
                           "tnt_occupancy: the kernel fits no SM")
    return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def _pieces(code: int, kernel: int, blocks: int, I: int, device) -> int:
    """Pieces to cut I into so that blocks x pieces fills one wave of
    resident blocks, never more: a partial second wave would run at a
    fraction of the card."""
    return max(1, min(I, _wave(code, kernel, device.index) // blocks, _MAX_GRID_YZ))


def _tiles(m: int, n: int, tn: int) -> int:
    return -(-m // _TM) * -(-n // tn)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _launch(fn, *args):
    from tntorch_tpu_torch._build import library

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library("gram_kernels"), fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")


def gram_edge(C, G):
    """Right-Gram edge (B, Rl, I, Rr), (B, Rr, Rr) -> (B, Rl, Rl). On the
    card it runs the kernel `_gram_resident` picks."""
    if _on_cpu(C, G):
        return gram_edge_plain(C, G)
    B, Rl, I, Rr = C.shape
    code = _check("gram_edge", (C, G), ((B, Rl, I, Rr), (B, Rr, Rr)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, Rl, Rl), dtype=C.dtype, device=C.device)
        if _gram_resident(Rl, Rr, C.element_size()):
            _gram_resident_launch(0, C, G, out)
        else:
            splits = _pieces(code, 0, B * _tiles(Rl, Rl, _TN_GRAM), I, C.device)
            scratch = torch.empty((splits, B, Rl, Rl), dtype=C.dtype, device=C.device) if splits > 1 else None
            _launch("tnt_gram_edge", code, _ptr(C), _ptr(G), _ptr(out), _ptr(scratch),
                    B, Rl, I, Rr, splits)
    gram_edge.launches += 1
    return out


def wgram(C, W):
    """Weighted left Gram (B, Rl, I, Rr), (B, Rl, Rl) -> (B, Rr, Rr). On the
    card it runs the kernel `_gram_resident` picks."""
    if _on_cpu(C, W):
        return wgram_plain(C, W)
    B, Rl, I, Rr = C.shape
    code = _check("wgram", (C, W), ((B, Rl, I, Rr), (B, Rl, Rl)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, Rr, Rr), dtype=C.dtype, device=C.device)
        if _gram_resident(Rl, Rr, C.element_size()):
            _gram_resident_launch(1, C, W, out)
        else:
            splits = _pieces(code, 0, B * _tiles(Rr, Rr, _TN_GRAM), I, C.device)
            scratch = torch.empty((splits, B, Rr, Rr), dtype=C.dtype, device=C.device) if splits > 1 else None
            _launch("tnt_wgram", code, _ptr(C), _ptr(W), _ptr(out), _ptr(scratch),
                    B, Rl, I, Rr, splits)
    wgram.launches += 1
    return out


def proj2(Y, C, X):
    """Double-sided projection (B, r1, Rl), (B, Rl, I, Rr), (B, Rr, r2) ->
    (B, r1, I, r2). On the card it runs the kernel `_proj2_resident`
    picks."""
    if _on_cpu(Y, C, X):
        return proj2_plain(Y, C, X)
    B, Rl, I, Rr = C.shape
    r1, r2 = Y.shape[-2], X.shape[-1]
    code = _check("proj2", (C, Y, X), ((B, Rl, I, Rr), (B, r1, Rl), (B, Rr, r2)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, r1, I, r2), dtype=C.dtype, device=C.device)
        if _proj2_resident(r1, Rl, Rr, r2, C.element_size()):
            units = B * -(-I // _RES_UNIT[C.element_size()][0])
            blocks = min(units, _wave(code, 2, C.device.index, Rl))
            _launch("tnt_proj2_resident", code, _ptr(Y), _ptr(C), _ptr(X), _ptr(out),
                    B, r1, Rl, I, Rr, r2, blocks)
        else:
            chunks = _pieces(code, 1, B * _tiles(r1, r2, _TN_PROJ), I, C.device)
            _launch("tnt_proj2", code, _ptr(Y), _ptr(C), _ptr(X), _ptr(out),
                    B, r1, Rl, I, Rr, r2, chunks)
    proj2.launches += 1
    return out


gram_edge.launches = 0
wgram.launches = 0
proj2.launches = 0

KERNELS = (gram_edge, wgram, proj2)
PLAIN = {gram_edge: gram_edge_plain, wgram: wgram_plain, proj2: proj2_plain}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
