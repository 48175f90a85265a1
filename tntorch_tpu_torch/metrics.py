"""Inner products and distances computed in compressed form.

Counterpart of ``tntorch_tpu/metrics.py`` (dot, normsq, norm, dist,
relative_error). Batch tensors give one value per sample, shape (B,).
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor, _not_ported
from tntorch_tpu_torch.utils import asarray, policy_precision


def _process(gt, approx):
    """Decompress if exactly one side is compressed. A batch Tensor side
    gives (B, ...) dense data and batch=True, so dense reductions are per
    sample."""
    is1, is2 = isinstance(gt, Tensor), isinstance(approx, Tensor)
    if is1 and is2:
        return gt, approx, False
    batch = (is1 and gt.batch) or (is2 and approx.batch)
    # Dense array-like input joins the compressed side's device
    device = gt.device if is1 else approx.device if is2 else None
    gt = gt.full() if is1 else asarray(gt, device=device)
    approx = approx.full() if is2 else asarray(approx, device=device)
    if batch:
        gt, approx = torch.broadcast_tensors(gt, approx)
    return gt, approx, batch


def _flat(x, batch):
    return x.reshape(x.shape[0], -1) if batch else x.reshape(-1)


@policy_precision
def dot(t1, t2, k=None):
    """Generalized dot: contract the k leading modes (default: all), without
    conjugation. Full contractions give a scalar, or (B,) for batches."""
    t1, t2, dbatch = _process(t1, t2)
    if not isinstance(t1, Tensor) and not isinstance(t2, Tensor):
        return (_flat(t1, dbatch) * _flat(t2, dbatch)).sum(-1)
    if t1.batch != t2.batch:
        raise ValueError("Cannot dot a batch tensor with a non-batch tensor")
    batch = t1.batch
    dtype = torch.promote_types(t1.dtype, t2.dtype)

    def _project_left(core, M):
        return torch.einsum("...sr,...rai->...sai", M, core.to(dtype))

    Lprod = torch.ones((int(t2.ranks_tt[0]), int(t1.ranks_tt[0])), dtype=dtype, device=t1.device)
    if k is None:
        k = min(t1.dim(), t2.dim())
    if k > t1.dim() or k > t2.dim():
        raise ValueError(f"k={k} exceeds the number of modes")
    off = 1 if batch else 0
    if not np.array_equal(t1.shape[off:off + k], t2.shape[off:off + k]):
        raise ValueError(
            "Dot product requires leading dimensions to be equal, but they are {} and {}".format(
                t1.shape[off:off + k], t2.shape[off:off + k]
            )
        )
    for mu in range(k):
        Ucore = _project_left(t1.cores[mu], Lprod)
        Lprod = torch.einsum("...sai,...saj->...ij", t2.cores[mu].to(dtype), Ucore)

    if k == t1.dim() and k == t2.dim():
        return Lprod.sum((-2, -1))
    if k < t1.dim():
        if k < t2.dim():
            raise _not_ported("A partial dot leaving modes on both sides (tn.transpose)",
                              "queue 1 item 8")
        t1trail = Tensor(list(t1.cores[k:]), batch=batch)
        t1trail.cores[0] = _project_left(t1trail.cores[0], Lprod)
        return t1trail
    t2trail = Tensor(list(t2.cores[k:]), batch=batch)
    t2trail.cores[0] = _project_left(t2trail.cores[0], Lprod.mT)
    return t2trail


def _is_complex(t):
    return isinstance(t, Tensor) and t.dtype.is_complex


def _conj(t):
    t2 = t.clone()
    t2.cores = [c.conj() for c in t2.cores]
    return t2


def _normsq_hermitian(t):
    """<t, t> with conjugation: real and nonnegative for complex tensors."""
    return dot(_conj(t), t).real.clamp(min=0)


def dist(t1, t2):
    """Euclidean distance in compressed form; (B,) for batch input."""
    t1, t2, dbatch = _process(t1, t2)
    if not isinstance(t1, Tensor) and not isinstance(t2, Tensor):
        return torch.linalg.vector_norm(_flat(t1 - t2, dbatch), dim=-1)
    if _is_complex(t1) or _is_complex(t2):
        cross = dot(_conj(t1), t2).real
        return torch.sqrt(
            (_normsq_hermitian(t1) + _normsq_hermitian(t2) - 2 * cross).clamp(min=0)
        )
    return torch.sqrt((dot(t1, t1) + dot(t2, t2) - 2 * dot(t1, t2)).clamp(min=0))


def relative_error(gt, approx):
    """||gt - approx|| / ||gt|| in compressed form; (B,) for batch input."""
    gt, approx, dbatch = _process(gt, approx)
    if not isinstance(gt, Tensor) and not isinstance(approx, Tensor):
        return torch.linalg.vector_norm(_flat(gt - approx, dbatch), dim=-1) / (
            torch.linalg.vector_norm(_flat(gt, dbatch), dim=-1)
        )
    if _is_complex(gt) or _is_complex(approx):
        return dist(gt, approx) / torch.sqrt(_normsq_hermitian(gt))
    dotgt = dot(gt, gt)
    return torch.sqrt((dotgt + dot(approx, approx) - 2 * dot(gt, approx)).clamp(min=0)) / (
        torch.sqrt(dotgt.clamp(min=0))
    )


def normsq(t):
    """Squared Frobenius norm <t, t> (Hermitian for complex cores)."""
    if _is_complex(t):
        return _normsq_hermitian(t)
    return dot(t, t)


def norm(t):
    """Frobenius norm (Hermitian for complex cores)."""
    return torch.sqrt(normsq(t).clamp(min=0))
