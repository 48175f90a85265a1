"""Carry tensors between this package and ``tntorch_tpu`` as NumPy arrays.

Neither side imports the other: cores cross as NumPy arrays (a JAX array
converts with ``np.asarray``), so the same weights feed both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import default_device


def tensor_from_arrays(cores, Us=None, batch: bool = False, device=None) -> Tensor:
    """Build a `Tensor` from array cores (NumPy, or anything ``np.asarray``
    takes), keeping their dtype, on ``device`` (default: the package's
    default device, the CUDA card)."""
    device = device or default_device()
    cores = [torch.from_numpy(np.array(c)) for c in cores]
    if Us is not None:
        Us = [None if U is None else torch.from_numpy(np.array(U)) for U in Us]
    return Tensor(cores, Us=Us, batch=batch, device=device)


def tensor_to_arrays(t: Tensor) -> list:
    """The cores of ``t`` as NumPy arrays on the host."""
    return [c.detach().cpu().numpy() for c in t.cores]
