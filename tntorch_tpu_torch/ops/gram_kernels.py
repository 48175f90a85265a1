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
Y C) in shared memory as the TPU kernels kept it in VMEM, split I across
blocks so that a batch of 32 fills one wave of resident blocks on the
132 SMs, and sum the splits in a second pass without atomics
(deterministic). Tensor cores are later work.

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
def _wave(code: int, kernel: int, device_index: int) -> int:
    """Blocks of one kernel that the card holds at once (occupancy x SMs)."""
    from tntorch_tpu_torch._build import library

    per_sm = library("gram_kernels").tnt_occupancy(code, kernel)
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
    """Right-Gram edge (B, Rl, I, Rr), (B, Rr, Rr) -> (B, Rl, Rl)."""
    if _on_cpu(C, G):
        return gram_edge_plain(C, G)
    B, Rl, I, Rr = C.shape
    code = _check("gram_edge", (C, G), ((B, Rl, I, Rr), (B, Rr, Rr)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, Rl, Rl), dtype=C.dtype, device=C.device)
        splits = _pieces(code, 0, B * _tiles(Rl, Rl, _TN_GRAM), I, C.device)
        scratch = torch.empty((splits, B, Rl, Rl), dtype=C.dtype, device=C.device) if splits > 1 else None
        _launch("tnt_gram_edge", code, _ptr(C), _ptr(G), _ptr(out), _ptr(scratch),
                B, Rl, I, Rr, splits)
    gram_edge.launches += 1
    return out


def wgram(C, W):
    """Weighted left Gram (B, Rl, I, Rr), (B, Rl, Rl) -> (B, Rr, Rr)."""
    if _on_cpu(C, W):
        return wgram_plain(C, W)
    B, Rl, I, Rr = C.shape
    code = _check("wgram", (C, W), ((B, Rl, I, Rr), (B, Rl, Rl)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, Rr, Rr), dtype=C.dtype, device=C.device)
        splits = _pieces(code, 0, B * _tiles(Rr, Rr, _TN_GRAM), I, C.device)
        scratch = torch.empty((splits, B, Rr, Rr), dtype=C.dtype, device=C.device) if splits > 1 else None
        _launch("tnt_wgram", code, _ptr(C), _ptr(W), _ptr(out), _ptr(scratch),
                B, Rl, I, Rr, splits)
    wgram.launches += 1
    return out


def proj2(Y, C, X):
    """Double-sided projection (B, r1, Rl), (B, Rl, I, Rr), (B, Rr, r2) ->
    (B, r1, I, r2)."""
    if _on_cpu(Y, C, X):
        return proj2_plain(Y, C, X)
    B, Rl, I, Rr = C.shape
    r1, r2 = Y.shape[-2], X.shape[-1]
    code = _check("proj2", (C, Y, X), ((B, Rl, I, Rr), (B, r1, Rl), (B, Rr, r2)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, r1, I, r2), dtype=C.dtype, device=C.device)
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
