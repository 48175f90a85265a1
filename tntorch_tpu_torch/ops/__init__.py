"""Elementwise operations on compressed tensors.

Counterpart of ``tntorch_tpu/ops/__init__.py``. Every nonlinear operation
is a TT-cross approximation (`tn.cross`) over its input tensor(s), on
their device: on the card its default ``fuse="auto"`` runs the fused
sweep, on the CPU the eager one. The unary ones pass their keywords on
to it (``tn.exp(t, seed=0, eps=1e-8, fuse=False)``). ``cumsum`` is exact:
a cumulative sum of each core (or Tucker factor) along its mode. ``tn``
is resolved at call time: `cross` imports this package's submodules, so
it cannot be imported here.

The submodules hold the kernels' wrappers and the sweeps that call them:
`tt_eval`, `gram_kernels`, `maxvol_kernels`, `rounding`, `decomposition`.
"""

from __future__ import annotations

import numpy as np
import torch

import tntorch_tpu_torch as tn

__all__ = [
    "cumsum", "cumprod", "abs", "acos", "asin", "atan", "cos", "cosh", "erf",
    "erfinv", "exp", "log", "log10", "log2", "reciprocal", "rsqrt", "sigmoid",
    "sin", "sinh", "sqrt", "tan", "tanh", "add", "atan2", "div", "mul", "pow",
]


def cumsum(t, dim=None):
    """Exact cumulative sum along the modes ``dim`` (default: all)."""
    if dim is None:
        dim = range(t.dim())
    if not hasattr(dim, "__len__"):
        dim = [dim]
    t = t.clone()
    for n in dim:
        if t.Us[n] is None:
            t.cores[n] = torch.cumsum(t.cores[n], dim=-2)
        else:
            t.Us[n] = torch.cumsum(t.Us[n], dim=-2)
    return t


def cumprod(t, dim=None):
    """Cumulative product, exp(cumsum(log(t))) by cross approximation."""
    return tn.exp(tn.cumsum(tn.log(t), dim=dim))


def _unary(fn, doc):
    def op(t, **kwargs):
        return tn.cross(lambda x: fn(x), tensors=[t], verbose=False, **kwargs)

    op.__doc__ = f"Elementwise {doc} by cross approximation; keywords go to `tn.cross`."
    return op


abs = _unary(torch.abs, "absolute value")
acos = _unary(torch.arccos, "arc cosine")
asin = _unary(torch.arcsin, "arc sine")
atan = _unary(torch.arctan, "arc tangent")
cos = _unary(torch.cos, "cosine")
cosh = _unary(torch.cosh, "hyperbolic cosine")
erf = _unary(torch.special.erf, "error function")
erfinv = _unary(torch.special.erfinv, "inverse error function")
exp = _unary(torch.exp, "exponential")
log = _unary(torch.log, "natural logarithm")
log10 = _unary(lambda x: torch.log(x) / np.log(10.0), "base-10 logarithm")
log2 = _unary(lambda x: torch.log(x) / np.log(2.0), "base-2 logarithm")
reciprocal = _unary(lambda x: 1.0 / x, "reciprocal")
rsqrt = _unary(lambda x: 1.0 / torch.sqrt(x), "reciprocal square root")
sigmoid = _unary(lambda x: 1.0 / (1.0 + torch.exp(-x)), "logistic sigmoid")
sin = _unary(torch.sin, "sine")
sinh = _unary(torch.sinh, "hyperbolic sine")
sqrt = _unary(torch.sqrt, "square root")
tan = _unary(torch.tan, "tangent")
tanh = _unary(torch.tanh, "hyperbolic tangent")


def add(t1, t2):
    """Elementwise sum by cross approximation."""
    return tn.cross(lambda x, y: x + y, tensors=[t1, t2], verbose=False)


def atan2(t1, t2):
    """Elementwise atan2(t1, t2) by cross approximation."""
    return tn.cross(lambda x, y: torch.arctan2(x, y), tensors=[t1, t2], verbose=False)


def div(t1, t2):
    """Elementwise quotient, ``t1 / t2``."""
    return t1 / t2


def mul(t1, t2):
    """Elementwise product by cross approximation."""
    return tn.cross(lambda x, y: x * y, tensors=[t1, t2], verbose=False)


def pow(t1, t2):
    """Elementwise power, ``t1 ** t2``."""
    return t1 ** t2
