"""Constructors: random, constant and structured tensor trains.

Counterpart of ``tntorch_tpu/create.py``. ``rand``/``randn`` take TT, CP
and Tucker ranks (a mode with a CP rank gets an (I, R) factor, and the TT
ranks beside it must be left out); JAX's ``key=`` becomes a ``torch.Generator``
(``generator=``), which draws the factors and the cores, mode by mode,
factor first; the two packages give different numbers from the same seed.
``ones``, ``zeros`` and ``full`` are rank 1 (with ones as factors where
``ranks_tucker`` asks for them), ``eye`` a rank-m matrix, ``gaussian`` a
rank-1 Tucker tensor of normalized Gaussian bells, and ``arange``,
``linspace``, ``logspace`` 1-D tensors of NumPy's grids (the JAX package's
signatures). Cores land on ``device``, by default the package's default
device (the CUDA card); the ``*_like`` forms default to the model tensor's
device and take its shape, not its dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import default_device, default_dtype


def rand(*shape, **kwargs) -> Tensor:
    """TT with uniform-[0, 1) random cores."""
    return _create(torch.rand, *shape, **kwargs)


def randn(*shape, **kwargs) -> Tensor:
    """TT with standard-normal random cores."""
    return _create(torch.randn, *shape, **kwargs)


def rand_like(t, **kwargs) -> Tensor:
    """Uniform random tensor of ``t``'s shape."""
    return rand(t.shape, **_like(t, kwargs))


def randn_like(t, **kwargs) -> Tensor:
    """Standard-normal random tensor of ``t``'s shape."""
    return randn(t.shape, **_like(t, kwargs))


def _constant(value):
    def draw(shape, generator=None, dtype=None, device=None):
        return torch.full(shape, float(value), dtype=dtype, device=device)

    return draw


def ones(*shape, **kwargs) -> Tensor:
    """Rank-1 TT of ones."""
    return _create(_constant(1), *shape, ranks_tt=1, **kwargs)


def ones_like(t, **kwargs) -> Tensor:
    return ones(t.shape, **_like(t, kwargs))


def zeros(*shape, **kwargs) -> Tensor:
    """Rank-1 TT of zeros."""
    return _create(_constant(0), *shape, ranks_tt=1, **kwargs)


def zeros_like(t, **kwargs) -> Tensor:
    return zeros(t.shape, **_like(t, kwargs))


def full(shape, fill_value, **kwargs) -> Tensor:
    """Rank-1 TT of ``fill_value``."""
    return fill_value * ones(*shape, **kwargs)


def full_like(t, fill_value, **kwargs) -> Tensor:
    return full(t.shape, fill_value=fill_value, **_like(t, kwargs))


def _like(t, kwargs) -> dict:
    """``kwargs`` with ``t``'s device unless they name one."""
    return {"device": t.device, **kwargs}


def eye(n: int, m: Optional[int] = None, device=None, requires_grad=None, dtype=None) -> Tensor:
    """The n x m identity matrix as a 2-D TT of rank m."""
    if m is None:
        m = n
    dtype = dtype or default_dtype()
    device = device or default_device()
    c1 = torch.eye(n, m, dtype=dtype, device=device)
    c2 = torch.eye(m, m, dtype=dtype, device=device)
    return Tensor([c1[None], c2[:, :, None]], requires_grad=requires_grad)


def gaussian(*shape, sigma_factor=0.2, device=None, dtype=None) -> Tensor:
    """Axis-aligned Gaussian bell that sums to 1: a rank-1 Tucker tensor
    whose mode-n factor is a normalized bell of width ``sigma_factor[n] *
    shape[n]`` over ``linspace(-shape[n]/2, shape[n]/2)``."""
    if hasattr(shape[0], "__len__"):
        shape = shape[0]
    N = len(shape)
    if not hasattr(sigma_factor, "__len__"):
        sigma_factor = [sigma_factor] * N
    dtype = dtype or default_dtype()
    device = device or default_device()
    cores = [torch.ones((1, 1, 1), dtype=dtype, device=device) for _ in range(N)]
    Us = []
    for n in range(N):
        sigma = sigma_factor[n] * shape[n]
        if shape[n] == 1:
            x = torch.zeros(1, dtype=dtype, device=device)
        else:
            x = torch.linspace(-shape[n] / 2, shape[n] / 2, shape[n], dtype=dtype, device=device)
        U = torch.exp(-(x ** 2) / (2 * sigma ** 2))
        Us.append(U[:, None] / U.sum())
    return Tensor(cores, Us)


def gaussian_like(t, **kwargs) -> Tensor:
    return gaussian(t.shape, **_like(t, kwargs))


def _grid(numpy_fn, args, kwargs) -> Tensor:
    """A 1-D TT of NumPy's ``numpy_fn(*args, **kwargs)`` (the JAX package's
    signatures), in ``dtype`` on ``device``."""
    dtype = kwargs.pop("dtype", None) or default_dtype()
    device = kwargs.pop("device", None) or default_device()
    x = torch.from_numpy(np.asarray(numpy_fn(*args, **kwargs))).to(device=device, dtype=dtype)
    return Tensor([x[None, :, None]])


def arange(*args, **kwargs) -> Tensor:
    """1-D TT of ``np.arange(*args)``."""
    return _grid(np.arange, args, kwargs)


def linspace(*args, **kwargs) -> Tensor:
    """1-D TT of ``np.linspace(*args)``."""
    return _grid(np.linspace, args, kwargs)


def logspace(*args, **kwargs) -> Tensor:
    """1-D TT of ``np.logspace(*args)``."""
    return _grid(np.logspace, args, kwargs)


def _full_ranks(spatial) -> list:
    """The exact TT ranks of a dense tensor of shape ``spatial``: at each
    inner edge, the smaller side of the unfolding."""
    return [min(int(np.prod(spatial[:n])), int(np.prod(spatial[n:])))
            for n in range(1, len(spatial))]


def _create(draw, *shape, ranks_tt=None, ranks_cp=None, ranks_tucker=None,
            requires_grad: bool = False, device=None, batch: bool = False,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None) -> Tensor:
    if hasattr(shape[0], "__len__"):
        shape = tuple(shape[0])
    dtype = dtype or default_dtype()
    device = device or default_device()
    bdim = tuple(shape[:1]) if batch else ()
    spatial = list(shape[1:] if batch else shape)
    N = len(spatial)
    if not hasattr(ranks_tucker, "__len__"):
        ranks_tucker = [ranks_tucker] * N
    # the cores' middle axes: a mode's Tucker rank where it has a factor
    inner = [s if rt is None else int(rt) for s, rt in zip(spatial, ranks_tucker)]
    if ranks_tt is None and ranks_cp is None:
        ranks_tt = _full_ranks(inner)
    if not hasattr(ranks_tt, "__len__"):
        ranks_tt = [ranks_tt] * (N - 1)
    if not hasattr(ranks_cp, "__len__"):
        ranks_cp = [ranks_cp] * N
    tt_edges = [None, *ranks_tt, None]
    if len(tt_edges) != N + 1 or len(ranks_cp) != N:
        raise ValueError("ranks_tt needs N - 1 entries and ranks_cp N")
    ranks = list(tt_edges)
    for n, rc in enumerate(ranks_cp):  # a CP factor's rank is both of its edges
        if rc is not None:
            if tt_edges[n] is not None or tt_edges[n + 1] is not None:
                raise ValueError("The ranks_tt and ranks_cp provided are incompatible")
            ranks[n] = ranks[n + 1] = rc
    ranks[0] = 1 if ranks[0] is None else ranks[0]
    ranks[-1] = 1 if ranks[-1] is None else ranks[-1]
    if any(r is None for r in ranks):
        raise ValueError("One or more TT/CP ranks were not specified")
    # Draw where the generator lives (the caller's stream of numbers), then move
    where = generator.device if generator is not None else device

    def sample(*s):
        return draw(bdim + s, generator=generator, dtype=dtype, device=where).to(device)

    cores, Us = [], []
    for n in range(N):
        Us.append(None if ranks_tucker[n] is None else sample(spatial[n], inner[n]))
        cores.append(sample(ranks[n], inner[n], ranks[n + 1]) if ranks_cp[n] is None
                     else sample(inner[n], ranks_cp[n]))
    return Tensor(cores, Us=Us, batch=batch, requires_grad=requires_grad)
