"""Finite-difference vector calculus on compressed tensors.

Counterpart of ``tntorch_tpu/derivatives.py``. A derivative along a mode
differences that mode's core (or its Tucker factor, where it has one), so
every result stays compressed at the input's ranks; sums of derivatives
(``divergence``, ``laplacian``, ``curl``) add ranks. ``partial`` takes
central differences with linear extrapolation at the ends (or wraps around
with ``periodic``) over a grid spanning ``bounds`` (default: [0, I] per
mode), the JAX package's conventions. The updates are out of place, so
autograd flows through them. Batch tensors differentiate every sample at
once.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.automata import weight_mask
from tntorch_tpu_torch.metrics import dot
from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.tools import mask as apply_mask
from tntorch_tpu_torch.utils import asarray


def partialset(t, order=1, mask=None, bounds=None) -> Tensor:
    """Every partial derivative of the orders in ``order``, at once: each
    mode's core is stacked with its forward differences up to the largest
    order (annotated 0, 1, 2, ... in ``idxs``), and a Hamming-weight
    automaton (`automata.weight_mask`, narrowed by ``mask``) keeps the
    combinations of the asked total order. ``bounds`` gives each mode's
    grid span (default [0, I - 1])."""
    off = 1 if t.batch else 0
    spatial = list(t.shape[off:])
    if bounds is None:
        bounds = [[0, sh - 1] for sh in spatial]
    if not hasattr(order, "__len__"):
        order = [order]
    max_order = max(order)

    def diff(core, n):
        if core.shape[-2] == 1:
            raise ValueError(f"Tensor size {spatial[n]} along dimension {n} not enough to "
                             "compute high-order derivative")
        step = (bounds[n][1] - bounds[n][0]) / (core.shape[-2] - 1)
        return (core[..., 1:, :] - core[..., :-1, :]) / step

    cores, idxs = [], []
    for n in range(t.dim()):
        core = t._cp_to_tt(t.cores[n])
        stack = [core if t.Us[n] is None else torch.einsum("...ijk,...aj->...iak", core, t.Us[n])]
        idx = np.zeros([spatial[n]])
        for o in range(1, max_order + 1):
            stack.append(diff(stack[-1], n))
            idx = np.concatenate((idx, np.ones(stack[-1].shape[-2]) * o))
        cores.append(torch.cat(stack, dim=-2))
        idxs.append(idx)
    if t.batch:
        idxs = [np.arange(t.shape[0])] + idxs
    d = Tensor(cores, idxs=idxs, batch=t.batch)
    wm = weight_mask(t.dim(), order, nsymbols=max_order + 1, device=t.device, dtype=t.dtype)
    if mask is not None:
        wm = apply_mask(wm, mask)
    result = apply_mask(d, wm)
    result.idxs = idxs
    return result


def _central(x, step, periodic: bool):
    """Central differences of ``x`` along axis -2: wrapped around, or with
    the ends extrapolated linearly, over ``step`` (twice the spacing)."""
    if periodic:
        return (torch.roll(x, -1, dims=-2) - torch.roll(x, 1, dims=-2)) / step
    x = torch.cat((x[..., :1, :], x, x[..., -1:, :]), dim=-2)
    first = x[..., :1, :] - (x[..., 2:3, :] - x[..., 1:2, :])
    x = torch.cat((first, x[..., 1:, :]), dim=-2)
    last = x[..., -1:, :] + (x[..., -2:-1, :] - x[..., -3:-2, :])
    x = torch.cat((x[..., :-1, :], last), dim=-2)
    return (x[..., 2:, :] - x[..., :-2, :]) / step


def partial(t, dim, order=1, bounds=None, periodic=False) -> Tensor:
    """The ``order``-th derivative along the mode(s) ``dim`` by central
    differences. ``bounds`` has one [lo, hi] pair per entry of ``dim``
    (default [0, I]), and ``periodic`` one flag (or one for all)."""
    if not hasattr(dim, "__len__"):
        dim = [dim]
    dim = [d + t.dim() if d < 0 else int(d) for d in dim]
    off = 1 if t.batch else 0
    if bounds is None:
        bounds = [[0, t.shape[d + off]] for d in dim]
    if not hasattr(bounds[0], "__len__"):
        bounds = [bounds]
    if len(bounds) != len(dim):
        raise ValueError(
            f"need one bounds pair per dim entry: got {len(bounds)} for {len(dim)} dims")
    if not hasattr(periodic, "__len__"):
        periodic = [periodic] * len(dim)
    t2 = t.clone()
    for i, d in enumerate(dim):
        step = (bounds[i][1] - bounds[i][0]) / (t.shape[d + off] + 1) * 2
        for _ in range(order):
            if t2.Us[d] is None:
                t2.cores[d] = _central(t2.cores[d], step, periodic[i])
            else:
                t2.Us[d] = _central(t2.Us[d], step, periodic[i])
    return t2


def gradient(t, dim="all", bounds=None):
    """The first derivatives along the modes ``dim`` (default: all), as a
    list; a single Tensor for an int ``dim``. ``bounds``: one pair for all
    modes, or one per mode of ``dim``."""
    off = 1 if t.batch else 0
    if dim == "all":
        dim = range(t.dim())
    scalar = not hasattr(dim, "__len__")
    if scalar:
        dim = [dim]
    dim = [d + t.dim() if d < 0 else int(d) for d in dim]
    if bounds is None:
        bounds = [[0, t.shape[d + off]] for d in dim]
    if not hasattr(bounds[0], "__len__"):
        bounds = [bounds] * len(dim)
    outs = [partial(t, d, order=1, bounds=[b]) for d, b in zip(dim, bounds)]
    return outs[0] if scalar else outs


def _pdf(t, marginals, midpoints: bool) -> Tensor:
    """The rank-1 product density of ``marginals`` (default uniform), each
    normalized; with ``midpoints``, of the interval midpoints' weights
    (the last entry 0), where forward differences live."""
    off = 1 if t.batch else 0
    spatial = list(t.shape[off:])
    if marginals is None:
        marginals = [torch.ones(sh, dtype=t.dtype, device=t.device) / sh for sh in spatial]
    marginals = [asarray(m, dtype=t.dtype, device=t.device) for m in marginals]
    if any(len(m) != sh for m, sh in zip(marginals, spatial)):
        raise ValueError("each marginal needs one weight per entry of its mode")
    b = (t.shape[0],) if t.batch else ()
    cores = []
    for m in marginals:
        if midpoints:
            m = (m[:-1] + m[1:]) / 2
            m = torch.cat((m / m.sum(), torch.zeros(1, dtype=m.dtype, device=m.device)))
        else:
            m = m / m.sum()
        cores.append(m[None, :, None].expand(b + (1, m.shape[0], 1)))
    return Tensor(cores, batch=t.batch)


def active_subspace(t, bounds=None, marginals=None):
    """The main directions of variation (Constantine et al.): eigenvalues,
    descending, and eigenvectors of the Gram matrix of the gradient under
    the marginals' density; (B, N) and (B, N, N) for a batch."""
    pdf = _pdf(t, marginals, midpoints=True)
    grad = gradient(t, dim="all", bounds=bounds)
    N = t.dim()
    M = [[None] * N for _ in range(N)]
    for i in range(N):
        first = grad[i] * pdf
        for j in range(i, N):
            M[i][j] = M[j][i] = dot(first, grad[j])
    M = torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)
    w, v = torch.linalg.eigh(M)
    return w.flip(-1), v.flip(-1)


def dgsm(t, bounds=None, marginals=None):
    """Derivative-based global sensitivity measures (Kucherenko and Iooss):
    the mean squared derivative along each mode under the marginals'
    density; (N,), or (B, N) for a batch."""
    pdf = _pdf(t, marginals, midpoints=False)
    grad = gradient(t, dim="all", bounds=bounds)
    return torch.stack([dot(g * pdf, g) for g in grad], dim=-1)


def _bounds_per_field(bounds, n: int) -> list:
    if bounds is None:
        return [None] * n
    if not hasattr(bounds[0], "__len__"):
        return [bounds] * n
    if len(bounds) != n:
        raise ValueError(f"need {n} bounds pairs, got {len(bounds)}")
    return list(bounds)


def divergence(ts, bounds=None) -> Tensor:
    """The divergence of the N-D vector field given as N tensors of one
    shape."""
    if ts[0].dim() != len(ts) or any(t.shape != ts[0].shape for t in ts[1:]):
        raise ValueError("divergence needs N tensors of one N-D shape")
    bounds = _bounds_per_field(bounds, len(ts))
    return sum(partial(ts[n], n, order=1, bounds=bounds[n]) for n in range(len(ts)))


def curl(ts, bounds=None) -> list:
    """The curl of the 3-D vector field given as 3 tensors of 3 modes."""
    if len(ts) != 3 or any(t.dim() != 3 for t in ts):
        raise ValueError("curl needs a 3-D vector field: 3 tensors of 3 modes")
    bounds = _bounds_per_field(bounds, 3)
    return [
        partial(ts[2], 1, bounds=bounds[1]) - partial(ts[1], 2, bounds=bounds[2]),
        partial(ts[0], 2, bounds=bounds[2]) - partial(ts[2], 0, bounds=bounds[0]),
        partial(ts[1], 0, bounds=bounds[0]) - partial(ts[0], 1, bounds=bounds[1]),
    ]


def laplacian(t, bounds=None) -> Tensor:
    """The Laplacian of a scalar field: the sum of second derivatives."""
    bounds = _bounds_per_field(bounds, t.dim())
    return sum(partial(t, n, order=2, bounds=bounds[n]) for n in range(t.dim()))
