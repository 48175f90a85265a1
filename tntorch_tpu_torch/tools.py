"""Manipulation and multilinear algebra on compressed tensors.

Counterpart of ``tntorch_tpu/tools.py``, for what the statistics and cross
approximation need: ``ttm`` (tensor times matrix along modes), ``squeeze``
and ``unsqueeze``; ``meshgrid`` (the coordinate tensors of a grid) and
``stack`` (non-batch tensors into one batch). The module's other names
exist here as functions that raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor, _not_ported_stub
from tntorch_tpu_torch.utils import asarray, default_device, default_dtype, policy_precision


def squeeze(t, dim=None):
    """Remove singleton modes (all of them, or those in ``dim``). ``dim``
    counts modes: a batch tensor's batch axis is never squeezed."""
    off = 1 if t.batch else 0
    mode_shape = np.array(t.shape[off:])
    if dim is None:
        dim = np.where(mode_shape == 1)[0]
    if not hasattr(dim, "__len__"):
        dim = [dim]
    dim = [d + t.dim() if d < 0 else int(d) for d in dim]
    if not np.all(mode_shape[dim] == 1):
        raise ValueError(f"squeeze: modes {dim} of shape {tuple(mode_shape)} are not all 1")
    idx = [slice(None)] * (t.dim() + off)
    for m in dim:
        idx[m + off] = 0
    return t[tuple(idx)]


def unsqueeze(t, dim):
    """Insert singleton modes at the positions ``dim`` (counting modes; a
    batch tensor keeps its batch axis first)."""
    if not hasattr(dim, "__len__"):
        dim = [dim]
    off = 1 if t.batch else 0
    idx = [slice(None)] * (t.dim() + off + len(dim))
    for d in dim:
        idx[d + off] = None
    return t[tuple(idx)]


@policy_precision
def ttm(t, U, dim=None, transpose: bool = False):
    """Tensor times matrix along one or several modes: mode ``dim[j]`` is
    multiplied by ``U[j]`` (J x I_n; ``transpose`` takes I_n x J). A vector
    (I_n,) contracts the mode to size 1; in a batch, an (B, I_n) matrix is
    one vector per sample. A mode with a Tucker factor multiplies the
    factor, a mode without one its core. Factors without a device join the
    tensor's."""
    if not isinstance(U, (list, tuple)):
        U = [U]
    U = [asarray(u, device=t.device) for u in U]
    if dim is None:
        dim = range(len(U))
    if not hasattr(dim, "__len__"):
        dim = [dim]
    dim = [d + t.dim() if d < 0 else d for d in dim]
    cores, Us = [], []
    for n in range(t.dim()):
        if n not in dim:
            cores.append(t.cores[n])
            Us.append(t.Us[n])
            continue
        factor = U[dim.index(n)]
        if transpose:
            factor = factor.transpose(-1, -2)
        if factor.ndim == 1:
            factor = factor[None]  # one row; broadcasts over a batch
        elif factor.ndim == 2 and t.batch:
            factor = factor[:, None]  # (B, I): one row per sample
        dtype = torch.promote_types(t.dtype, factor.dtype)
        factor = factor.to(dtype)
        if t.Us[n] is None:
            cores.append(torch.einsum("...iak,...ja->...ijk", t.cores[n].to(dtype), factor))
            Us.append(None)
        else:
            cores.append(t.cores[n])
            Us.append(factor @ t.Us[n].to(dtype))
    return Tensor(cores, Us=Us, batch=t.batch)


def meshgrid(*axes, batch: bool = False, device=None):
    """The N rank-1 tensors of a grid: tensor n holds mode n's coordinates,
    constant along the other modes. An axis is a vector of coordinates or a
    size (``arange``); each is cast to `default_dtype` (torch's default,
    float32 unless the caller sets another), as the JAX package casts to
    its own default. Vectors that are not torch tensors, and sizes, land on
    ``device`` (default: `default_device`). The ones-cores are shared
    between the N tensors, as in the JAX package."""
    if not hasattr(axes, "__len__"):
        axes = [axes]
    if hasattr(axes[0], "__len__"):
        axes = axes[0]
    axes = list(axes)
    N = len(axes)
    dtype = default_dtype()
    for n in range(N):
        if not hasattr(axes[n], "__len__"):
            axes[n] = torch.arange(axes[n], dtype=dtype, device=device or default_device())
        else:
            axes[n] = asarray(axes[n], dtype=dtype, device=device)
    ones = [torch.ones((1, ax.shape[0], 1), dtype=dtype, device=ax.device) for ax in axes]
    tensors = []
    for n in range(N):
        cores = list(ones)
        cores[n] = axes[n][None, :, None]
        tensors.append(Tensor(cores, batch=batch))
    return tensors


def stack(ts):
    """Stack non-batch tensors of one shape into one batch Tensor, at the
    largest rank of each edge: each sample becomes a plain TT, its cores
    zero-padded to those ranks (so samples of different ranks stack). The
    inverse is ``[t[b] for b in range(B)]``."""
    ts = list(ts)
    if not ts:
        raise ValueError("stack expects at least one tensor")
    if any(t.batch for t in ts):
        raise ValueError("stack expects non-batch tensors (already-batched input)")
    shape = tuple(ts[0].shape)
    for t in ts[1:]:
        if tuple(t.shape) != shape:
            raise ValueError(f"stack expects equal shapes, got {tuple(t.shape)} vs {shape}")
    ts = [t.tt() for t in ts]
    N = len(shape)
    rmaxs = [max(int(t.ranks_tt[k]) for t in ts) for k in range(N + 1)]
    bcores = []
    for n in range(N):
        padded = [torch.nn.functional.pad(t.cores[n], (0, rmaxs[n + 1] - t.cores[n].shape[2],
                                                       0, 0, 0, rmaxs[n] - t.cores[n].shape[0]))
                  for t in ts]
        bcores.append(torch.stack(padded))
    return Tensor(bcores, batch=True)


_NOT_PORTED = ("cat", "transpose", "flip", "unbind", "unfolding",
               "right_unfolding", "left_unfolding", "mask", "sample", "hash",
               "generate_basis", "reduce", "pad", "convolve", "shift_mode")
globals().update({name: _not_ported_stub(name, "queue 1 item 8") for name in _NOT_PORTED})
