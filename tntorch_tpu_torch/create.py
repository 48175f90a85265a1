"""Random tensor trains: ``rand`` and ``randn`` with TT and Tucker ranks.

Counterpart of ``tntorch_tpu/create.py``'s ``rand``/``randn``. JAX's
``key=`` becomes a ``torch.Generator`` (``generator=``), which draws the
factors and the cores, mode by mode, factor first; the two packages give
different numbers from the same seed. Cores land on ``device``, by default
the package's default device (the CUDA card). CP ranks are not ported
(ROADMAP.md, queue 1 item 3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor, _not_ported
from tntorch_tpu_torch.utils import default_device, default_dtype


def rand(*shape, **kwargs) -> Tensor:
    """TT with uniform-[0, 1) random cores."""
    return _create(torch.rand, *shape, **kwargs)


def randn(*shape, **kwargs) -> Tensor:
    """TT with standard-normal random cores."""
    return _create(torch.randn, *shape, **kwargs)


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
    if ranks_cp is not None:
        raise _not_ported("CP ranks", "queue 1 item 3")
    dtype = dtype or default_dtype()
    device = device or default_device()
    bdim = tuple(shape[:1]) if batch else ()
    spatial = list(shape[1:] if batch else shape)
    N = len(spatial)
    if not hasattr(ranks_tucker, "__len__"):
        ranks_tucker = [ranks_tucker] * N
    # the cores' middle axes: a mode's Tucker rank where it has a factor
    inner = [s if rt is None else int(rt) for s, rt in zip(spatial, ranks_tucker)]
    if ranks_tt is None:
        ranks_tt = _full_ranks(inner)
    if not hasattr(ranks_tt, "__len__"):
        ranks_tt = [ranks_tt] * (N - 1)
    ranks = [1, *ranks_tt, 1]
    if len(ranks) != N + 1 or any(r is None for r in ranks):
        raise ValueError("One or more TT ranks were not specified")
    # Draw where the generator lives (the caller's stream of numbers), then move
    where = generator.device if generator is not None else device

    def sample(*s):
        return draw(bdim + s, generator=generator, dtype=dtype, device=where).to(device)

    cores, Us = [], []
    for n in range(N):
        Us.append(None if ranks_tucker[n] is None else sample(spatial[n], inner[n]))
        cores.append(sample(ranks[n], inner[n], ranks[n + 1]))
    return Tensor(cores, Us=Us, batch=batch, requires_grad=requires_grad)
