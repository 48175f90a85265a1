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


def _from_array(x) -> torch.Tensor:
    """A CPU tensor of the array's values in its dtype: bfloat16 arrays (the
    JAX package's, NumPy arrays of ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) cross bit for bit as 2-byte words."""
    x = np.array(x)
    if x.dtype.name == "bfloat16" and x.dtype.itemsize == 2:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def tensor_from_arrays(cores, Us=None, batch: bool = False, device=None) -> Tensor:
    """Build a `Tensor` from array cores (NumPy, or anything ``np.asarray``
    takes), keeping their dtype (bfloat16 and float16 included), on
    ``device`` (default: the package's default device, the CUDA card). The
    cores are the JAX package's: TT cores (R, I, R'), CP factors (I, R), or
    a mix of both, with a leading batch axis when ``batch``."""
    device = device or default_device()
    cores = [_from_array(c) for c in cores]
    if Us is not None:
        Us = [None if U is None else _from_array(U) for U in Us]
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
