"""ANOVA decomposition and Sobol sensitivity indices, in compressed form.

Counterpart of ``tntorch_tpu/anova.py`` (Ballester-Ripoll et al., "Sobol
Tensor Trains for Global Sensitivity Analysis", 2017). The ANOVA tensor of
``t`` gives every mode a factor ``[E; U - E]``: its entry 0 is the mode's
mean under the marginal, entries 1.. the deviations from it, so that an
index string's zeros and non-zeros pick one ANOVA term. Sobol indices are
masked dot products on that tensor, the mask an automaton over the
{0, 1+} strings (`logic`, `automata`). Batch tensors give one value per
sample; ``marginals`` (one weight vector per mode, any scale) default to
uniform.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.automata import accepted_inputs, weight, weight_one_hot
from tntorch_tpu_torch.metrics import dot
from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.tools import mask as apply_mask
from tntorch_tpu_torch.utils import asarray


def _marginals(t, marginals) -> list:
    """One normalized weight vector per mode, in ``t``'s dtype on its
    device."""
    off = 1 if t.batch else 0
    if marginals is None:
        marginals = [None] * t.dim()
    out = []
    for n, m in enumerate(marginals):
        m = (torch.ones(t.shape[n + off], dtype=t.dtype, device=t.device) if m is None
             else asarray(m, dtype=t.dtype, device=t.device))
        out.append(m / m.sum())
    return out


def _anova_idxs(t) -> list:
    """The {0, 1+} annotations of an ANOVA tensor of ``t``: 0 for the mean
    entry, 1 for every deviation, behind ``arange(B)`` for a batch."""
    off = 1 if t.batch else 0
    idxs = [np.array([0] + [1] * sh) for sh in t.shape[off:]]
    return ([np.arange(t.shape[0])] + idxs) if t.batch else idxs


def anova_decomposition(t, marginals=None) -> Tensor:
    """The ANOVA tensor of ``t``: every mode's factor (the identity where
    it has none) becomes ``[E; U - E]``, E its mean row under the mode's
    marginal. Its shape grows by one on every mode."""
    off = 1 if t.batch else 0
    Us = []
    for n, m in enumerate(_marginals(t, marginals)):
        U = t.Us[n]
        if U is None:
            U = torch.eye(t.shape[n + off], dtype=t.dtype, device=t.device)
            if t.batch:
                U = U.expand((t.shape[0],) + U.shape)
        expected = (U * m[:, None]).sum(-2, keepdim=True)
        Us.append(torch.cat((expected, U - expected), dim=-2))
    return Tensor(list(t.cores), Us, idxs=_anova_idxs(t), batch=t.batch)


def undo_anova_decomposition(a) -> Tensor:
    """The tensor whose ANOVA tensor is ``a``: each entry is the mean plus
    its deviation."""
    cores, Us = [], []
    for c, U in zip(a.cores, a.Us):
        if U is None:
            cores.append(c[..., 1:, :] + c[..., 0:1, :])
            Us.append(None)
        else:
            cores.append(c)
            Us.append(U[..., 1:, :] + U[..., 0:1, :])
    return Tensor(cores, Us=Us, batch=a.batch)


def truncate_anova(t, mask, keepdim=False, marginals=None) -> Tensor:
    """``t`` with only the ANOVA terms that ``mask`` selects. Unless
    ``keepdim``, the modes that no selected term depends on are dropped
    (taken at index 0)."""
    t = undo_anova_decomposition(apply_mask(anova_decomposition(t, marginals=marginals), mask))
    if keepdim:
        return t
    affecting = accepted_inputs(mask).cpu().numpy().sum(axis=0)
    key = [slice(None) if affecting[n] else 0 for n in range(t.dim())]
    if t.batch:  # a batch key starts with the batch axis
        key.insert(0, slice(None))
    return t[tuple(key)]


def sobol(t, mask, marginals=None, normalize=True):
    """The Sobol index of the variables' subsets that ``mask`` selects: the
    variance of their ANOVA terms, over the total variance unless
    ``normalize`` is False. A mask that leaves a rank on its last core (a
    counter, `automata.weight_one_hot`) gives one index per counter value,
    as a 1-mode Tensor."""
    off = 1 if t.batch else 0
    shapes = t.shape[off:]
    b = (t.shape[0],) if t.batch else ()
    margs = _marginals(t, marginals)
    a = anova_decomposition(t, marginals)
    # Take the empty term (the mean, at index 0 of every mode) out
    oh = [torch.cat((torch.ones((1, 1, 1), dtype=t.dtype, device=t.device),
                     torch.zeros((1, sh, 1), dtype=t.dtype, device=t.device)), dim=1)
          for sh in shapes]
    one_hot0 = Tensor([c.expand(b + c.shape) for c in oh], batch=t.batch)
    a = a - one_hot0 * a[(slice(None),) * off + (0,) * t.dim()]
    a.idxs = _anova_idxs(t)

    am = a.clone()
    for n, m in enumerate(margs):  # weigh each deviation by its marginal
        x = am.cores[n] if am.Us[n] is None else am.Us[n]
        x = torch.cat((x[..., :1, :], x[..., 1:, :] * m[:, None]), dim=-2)
        if am.Us[n] is None:
            am.cores[n] = x
        else:
            am.Us[n] = x
    am_masked = apply_mask(am, mask)
    R = am_masked.cores[-1].shape[-1]
    if R > 1:  # expose the counter as one more mode
        eye = torch.eye(R, dtype=t.dtype, device=t.device)[:, :, None]
        am_masked.cores.append(eye.expand(b + eye.shape))
        am_masked.Us.append(None)
    if normalize:
        return dot(a, am_masked) / dot(a, am)
    return dot(a, am_masked)


def mean_dimension(t, mask=None, marginals=None):
    """The mean dimension: the variance-weighted mean order of the ANOVA
    terms (1 for an additive function), or, given ``mask``, of the terms it
    selects."""
    w = weight(t.dim(), device=t.device, dtype=t.dtype)
    if mask is None:
        return sobol(t, w, marginals=marginals)
    return (sobol(t, apply_mask(w, mask), marginals=marginals)
            / sobol(t, mask, marginals=marginals))


def dimension_distribution(t, mask=None, order=None, marginals=None):
    """The share of the variance in each interaction order 1 .. ``order``
    (default N), of all terms or of those ``mask`` selects; (B, order) for
    a batch."""
    if order is None:
        order = t.dim()
    counter = weight_one_hot(t.dim(), order + 1, device=t.device, dtype=t.dtype)
    if mask is None:
        return sobol(t, counter, marginals=marginals).full()[..., 1:]
    num = sobol(t, apply_mask(counter, mask), marginals=marginals).full()[..., 1:]
    den = sobol(t, mask, marginals=marginals)
    if num.ndim > 1:  # a batch: (B, order) over (B, 1)
        den = den[..., None]
    return num / den
