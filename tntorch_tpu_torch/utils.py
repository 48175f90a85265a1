"""Shared utilities: precision policy, array conversion, generators, trace spans.

Counterpart of ``tntorch_tpu/utils/__init__.py``. The XLA compile-cache
machinery and ``take_mode`` (a one-hot-GEMM gather for the TPU) have no
counterpart: PyTorch runs eagerly and gathers natively.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger("tntorch_tpu_torch")

_PRECISION_MODES = ("highest", "high", "default", "bf16")
_precision_policy = "highest"


def set_policy(precision: str) -> None:
    """Set the library-wide precision policy.

    The names are the JAX package's. Here every policy computes float32
    products in full float32: the library runs them with
    ``torch.backends.cuda.matmul.allow_tf32`` False whatever the process set
    (see `policy_precision`); mapping 'high'/'default' to 3xTF32/TF32 on
    Hopper is open work. The policy still selects algorithm variants as in
    the JAX package: every performance policy takes CholeskyQR2 for the
    orthogonalization sweeps and randomized subspace edges for Gram
    rounding. 'bf16' Gram rounding is not ported and raises.
    """
    global _precision_policy
    if precision not in _PRECISION_MODES:
        raise ValueError(f"precision must be one of {_PRECISION_MODES}")
    _precision_policy = precision


def get_policy() -> str:
    """Current library-wide precision policy (see set_policy)."""
    return _precision_policy


def resolve_precision(precision=None) -> str:
    """Explicit precision arg if given, else the library policy."""
    return _precision_policy if precision is None else precision


def policy_precision(fn):
    """Decorator: run ``fn`` with float32 matmuls in full float32 (no TF32),
    the matmul precision every policy maps to in this package, and restore
    the caller's setting afterwards."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prev)

    return wrapper


def default_device() -> str:
    """Where the package puts data that comes without a device (NumPy
    arrays, lists, scalars): the CUDA card, the counterpart of JAX's default
    backend. A ``torch.Tensor`` keeps its own device, the caller's choice.
    Without a card, moving there raises, as torch does: there is no silent
    CPU fallback; pass ``device="cpu"`` to work on the CPU."""
    return "cuda"


def seed(s: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (default: `default_device`)
    seeded with ``s``. The package keeps no global random state: callers
    pass generators."""
    return torch.Generator(device=device or default_device()).manual_seed(int(s))


def default_dtype() -> torch.dtype:
    """PyTorch's default floating dtype."""
    return torch.get_default_dtype()


def asarray(x: Any, dtype: Optional[torch.dtype] = None, device=None) -> torch.Tensor:
    """Convert NumPy / PyTorch / array-like / scalar input to a torch tensor.
    Anything with ``__array__`` (a JAX array included) goes through NumPy and
    lands on ``device``, by default `default_device`; a ``torch.Tensor``
    stays where it is unless ``device`` is given."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
        device = device or default_device()
    return x.to(device=device, dtype=dtype)


def to_numpy(x: Any) -> np.ndarray:
    """Convert a torch tensor, a compressed ``Tensor`` or array-like input to
    a NumPy array (a ``Tensor`` decompresses)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "cores") and hasattr(x, "numpy"):
        return x.numpy()
    return np.asarray(x)


def trace_annotation(name: str):
    """A labelled span for ``torch.profiler`` traces."""
    return torch.profiler.record_function(name)
