"""Carry tensors between this package and ``tntorch_tpu`` as NumPy arrays.

Neither side imports the other: cores cross as NumPy arrays (a JAX array
converts with ``np.asarray``), so the same weights feed both packages; a
cross's recorded index sets cross the same way (`cross_info_from_arrays`).
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import default_device, to_numpy


def tensor_from_arrays(cores, Us=None, batch: bool = False, device=None) -> Tensor:
    """Build a `Tensor` from array cores (NumPy, or anything ``np.asarray``
    takes), keeping their dtype, on ``device`` (default: the package's
    default device, the CUDA card). The cores are the JAX package's: TT
    cores (R, I, R'), CP factors (I, R), or a mix of both, with a leading
    batch axis when ``batch``."""
    device = device or default_device()
    cores = [torch.from_numpy(np.array(c)) for c in cores]
    if Us is not None:
        Us = [None if U is None else torch.from_numpy(np.array(U)) for U in Us]
    return Tensor(cores, Us=Us, batch=batch, device=device)


def tensor_to_arrays(t: Tensor) -> list:
    """The cores of ``t`` (TT cores and CP factors as they are) as NumPy
    arrays on the host, the JAX package's layout."""
    return [c.detach().cpu().numpy() for c in t.cores]


def cross_info_from_arrays(info: dict, device=None) -> dict:
    """A copy of a cross's ``info`` whose index sets (``lsets``, ``rsets``,
    ``left_locals``: NumPy or JAX arrays, as the JAX package returns them,
    or torch tensors on any device) are int64 tensors on ``device`` (default: the package's default
    device), as the port's `cross` returns them: what `cross_forward` needs
    to replay a run of either package."""
    device = device or default_device()
    out = dict(info)
    for key in ("lsets", "rsets", "left_locals"):
        out[key] = [torch.from_numpy(np.array(to_numpy(x), dtype=np.int64)).to(device)
                    for x in info[key]]
    out["Rs"] = np.array(info["Rs"], dtype=np.int64)
    return out
