"""Propositional calculus on {0, 1}^N mask tensors.

Counterpart of ``tntorch_tpu/logic.py``. A formula over N symbols is a
tensor of 2^N zeros and ones in TT form; the connectives are the Tensor's
``~ & | ^`` and the predicates read norms and sums of compressed tensors.
The constructors take the JAX package's arguments plus ``device`` (default:
`utils.default_device`, the card) and ``dtype`` (default:
`utils.default_dtype`); the functions of a formula work where it is.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.automata import _tensor, weight_mask
from tntorch_tpu_torch.metrics import norm
from tntorch_tpu_torch.metrics import sum as tn_sum
from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.tools import mask


def _rank1(N, values, which, device, dtype):
    """The rank-1 formula whose core is ``values`` (the entries at 0 and 1)
    on the modes in ``which`` (default: all) and ones elsewhere."""
    which = range(N) if which is None else np.atleast_1d(which)
    cores = [np.ones([1, 2, 1]) for _ in range(N)]
    for w in which:
        cores[int(w)] = np.asarray(values, dtype=np.float64).reshape(1, 2, 1)
    return _tensor(cores, device, dtype)


def true(N, device=None, dtype=None):
    """The formula that every input satisfies."""
    return _rank1(N, [1, 1], None, device, dtype)


def false(N, device=None, dtype=None):
    """The formula that no input satisfies."""
    return _rank1(N, [0, 0], None, device, dtype)


def all(N, which=None, device=None, dtype=None):
    """True where every symbol (in ``which``) is 1."""
    return _rank1(N, [0, 1], which, device, dtype)


def none(N, which=None, device=None, dtype=None):
    """True where no symbol (in ``which``) is 1."""
    return _rank1(N, [1, 0], which, device, dtype)


def any(N, which=None, device=None, dtype=None):
    """True where at least one symbol (in ``which``) is 1."""
    return ~none(N, which, device=device, dtype=dtype)


def one(N, which=None, device=None, dtype=None):
    """True where exactly one symbol is 1 (and, given ``which``, one of
    those is)."""
    if which is None:
        return weight_mask(N, 1, device=device, dtype=dtype)
    return weight_mask(N, 1, device=device, dtype=dtype) & any(N, which, device, dtype)


def symbols(N, device=None, dtype=None):
    """The N formulas x_1 ... x_N, each true where its symbol is 1."""
    return [presence(N, n, device=device, dtype=dtype) for n in range(N)]


def relevant_symbols(t):
    """The symbols that change the formula's value for some input: the
    symbol n whose difference core (x_n = 1 minus x_n = 0) leaves a
    non-zero tensor."""
    t2 = Tensor([torch.cat((c[:, 1:2, :] - c[:, 0:1, :], c), dim=1) for c in t.tt().cores])
    keep = slice(1, 3)
    return [n for n in range(t.dim())
            if float(norm(t2[tuple([keep] * n + [0] + [keep] * (t.dim() - n - 1))])) > 1e-10]


def irrelevant_symbols(t):
    """The symbols that the formula does not depend on."""
    rel = relevant_symbols(t)
    return [n for n in range(t.dim()) if n not in rel]


def only(t):
    """The formula with every irrelevant symbol forced to 0."""
    return mask(t, absence(t.dim(), irrelevant_symbols(t), device=t.device, dtype=t.dtype))


def presence(N, which, device=None, dtype=None):
    """True where every symbol in ``which`` is 1."""
    return _rank1(N, [0, 1], which, device, dtype)


def absence(N, which, device=None, dtype=None):
    """True where every symbol in ``which`` is 0."""
    return _rank1(N, [1, 0], which, device, dtype)


def is_tautology(t) -> bool:
    """Whether every input satisfies ``t``."""
    return bool(norm(~t) <= 1e-6)


def is_contradiction(t) -> bool:
    """Whether no input satisfies ``t``."""
    return bool(norm(t) <= 1e-6)


def is_satisfiable(t) -> bool:
    """Whether some input satisfies ``t``."""
    return bool(tn_sum(t) >= 1e-6)


def implies(t1, t2) -> bool:
    """Whether every input that satisfies ``t1`` satisfies ``t2``."""
    return is_contradiction(t1 & ~t2)


def equiv(t1, t2) -> bool:
    """Whether ``t1`` and ``t2`` accept the same inputs."""
    return implies(t1, t2) and implies(t2, t1)
