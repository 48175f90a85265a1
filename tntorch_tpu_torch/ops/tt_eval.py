"""Evaluation of a TT at integer coordinates, and its gradient, each as a
hand-written CUDA kernel for Hopper (``csrc/tt_eval.cu``) with its plain
PyTorch version beside it.

Counterpart of ``tntorch_tpu/ops/pallas_tt.py`` (``pallas_tt_eval`` and its
dispatcher ``tt_eval``) and of ``tntorch_tpu/parallel/mesh.py``'s
``tt_batch_forward``:

- ``tt_eval_kernel`` <- ``pallas_tt_eval``: the value of the TT with cores
  C_k (R_k, I_k, R_{k+1}) at each row of X (B, N): ``v <- ones(R_0)``,
  ``v <- v C_k[:, X[b,k], :]`` per mode, column 0 of the last interface;
- ``tt_eval_backward_kernel``: the cores' gradient of ``sum_b g_b
  value_b``. It has no Pallas counterpart (JAX differentiates
  ``tt_batch_forward`` in XLA); the training path needs it because its
  forward now runs in a kernel.

`TTEval` joins the two as a ``torch.autograd.Function`` that saves only the
cores and X: the backward recomputes the interfaces. What bounds the kernels
on the card, and how they are laid out, is in the source's note.

Each wrapper takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it checks device, dtype (float32 or float64
cores, int32 or int64 coordinates), shapes and contiguity, launches its
kernel on the current stream, and raises on any failure: it never falls
back. Negative coordinates wrap as in NumPy; an out-of-range one raises
``IndexError`` (the kernel flags it, so the wrapper reads one flag back from
the card per call). Each wrapper counts its launches in a plain integer
attribute (``tt_eval_kernel.launches``), which only a launch of the kernel
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from tntorch_tpu_torch.ops.gram_kernels import _on_cpu

MAX_MODES = 128  # csrc/tt_eval.cu: MAX_MODES, the modes one launch takes
_SMEM = 227 * 1024  # shared memory one block may use on Hopper
_DTYPES = {torch.float32: 0, torch.float64: 1}
_ITYPES = {torch.int32: 0, torch.int64: 1}
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
        flag = torch.zeros(1, dtype=torch.int32, device=X.device)
        _launch("tnt_tt_eval", dcode, icode, N, _array(ctypes.c_void_p, [c.data_ptr() for c in cores]),
                _array(ctypes.c_int, ranks), _array(ctypes.c_int, dims), ctypes.c_void_p(X.data_ptr()),
                B, ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(flag.data_ptr()))
    tt_eval_kernel.launches += 1
    _raise_if_flagged(flag, "tt_eval")
    return out


def tt_eval_backward_kernel(cores, X, g):
    """Gradients of ``sum_b g_b tt_eval(cores, X)_b``, one per core."""
    cores = list(cores)
    if _on_cpu(*cores, X, g):
        return tt_eval_backward_plain(cores, X, g)
    dcode, icode, ranks, dims = _check("tt_eval_backward", cores, X, backward=True)
    B, N = X.shape
    if g.dtype != cores[0].dtype or tuple(g.shape) != (B,) or not g.is_contiguous():
        raise ValueError(f"tt_eval_backward: g must be a contiguous ({B},) {cores[0].dtype} array")
    flat = torch.zeros(sum(c.numel() for c in cores), dtype=g.dtype, device=g.device)
    grads = list(torch.split(flat, [c.numel() for c in cores]))
    grads = [d.view(c.shape) for d, c in zip(grads, cores)]
    if B == 0:
        return grads
    with torch.cuda.device(X.device):
        flag = torch.zeros(1, dtype=torch.int32, device=X.device)
        _launch("tnt_tt_eval_backward", dcode, icode, N,
                _array(ctypes.c_void_p, [c.data_ptr() for c in cores]),
                _array(ctypes.c_void_p, [d.data_ptr() for d in grads]),
                _array(ctypes.c_int, ranks), _array(ctypes.c_int, dims),
                ctypes.c_void_p(X.data_ptr()), ctypes.c_void_p(g.data_ptr()), B,
                ctypes.c_void_p(flag.data_ptr()))
    tt_eval_backward_kernel.launches += 1
    _raise_if_flagged(flag, "tt_eval_backward")
    return grads


tt_eval_kernel.launches = 0
tt_eval_backward_kernel.launches = 0

KERNELS = (tt_eval_kernel, tt_eval_backward_kernel)
PLAIN = {tt_eval_kernel: tt_eval_plain, tt_eval_backward_kernel: tt_eval_backward_plain}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


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
        grads = tt_eval_backward_kernel(cores, X, g.contiguous())
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
