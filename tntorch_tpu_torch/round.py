"""Functional rounding and the truncated-SVD factorization.

Counterpart of ``tntorch_tpu/round.py`` (``round_tt``, ``round_tucker``,
``round``, ``truncated_svd``).
The rank choice syncs the singular values to the host, as it does there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tntorch_tpu_torch.utils import policy_precision


def round_tt(t, **kwargs):
    """Copy-and-round via Tensor.round_tt."""
    t2 = t.clone()
    t2.round_tt(**kwargs)
    return t2


def round_tucker(t, **kwargs):
    """Copy-and-round via Tensor.round_tucker."""
    t2 = t.clone()
    t2.round_tucker(**kwargs)
    return t2


def round(t, **kwargs):
    """Copy-and-round via Tensor.round (TT, then Tucker with the budget
    left over)."""
    t2 = t.clone()
    t2.round(**kwargs)
    return t2


@policy_precision
def truncated_svd(M, delta: Optional[float] = None, eps: Optional[float] = None,
                  rmax: Optional[int] = None, left_ortho: bool = True,
                  algorithm: str = "svd", verbose: bool = False, batch: bool = False):
    """Factor M (m x n, or B x m x n when batch) into U (m x r) @ V (r x n)
    with an error-budgeted rank.

    - delta: absolute error budget; eps: relative budget (exclusive).
    - 'svd' takes a singular value decomposition; 'eig' the eigh of the
      Gram of the short side (negative eigenvalues clamped to zero).
    - batch picks one shared rank: the largest any sample's budget needs.
    """
    if delta is not None and eps is not None:
        raise ValueError("Provide either `delta` or `eps`")
    if algorithm not in ("svd", "eig"):
        raise ValueError(f"algorithm must be 'svd' or 'eig', got {algorithm!r}")
    eps_rel = eps if (eps is not None and batch) else None
    if delta is None and eps is not None and not batch:
        delta = eps * float(torch.linalg.vector_norm(M))
    if delta is None:
        delta = 0.0
    rmax = np.iinfo(np.int32).max if rmax is None else int(rmax)
    if rmax < 1:
        raise ValueError("rmax must be >= 1")

    if algorithm == "svd":
        svd0, svd1, _ = torch.linalg.svd(M, full_matrices=False)
        singular_vectors = "left"
    else:
        if M.shape[-2] <= M.shape[-1]:
            gram = M @ M.mH
            singular_vectors = "left"
        else:
            gram = M.mH @ M
            singular_vectors = "right"
        w, v = torch.linalg.eigh((gram + gram.mH) / 2)
        svd0 = torch.flip(v, dims=[-1])
        svd1 = torch.flip(torch.sqrt(w.clamp(min=0)), dims=[-1])

    S_host = svd1.detach().cpu().numpy()

    if (S_host.max() if batch else S_host[0]) < 1e-13:  # zero matrix: rank-1 zeros
        b = M.shape[:1] if batch else ()
        return (torch.zeros(b + (M.shape[-2], 1), dtype=M.dtype, device=M.device),
                torch.zeros(b + (1, M.shape[-1]), dtype=M.dtype, device=M.device))

    S2 = S_host.astype(np.float64) ** 2
    if batch:
        if eps_rel is not None or delta > 0:
            tails = np.cumsum(S2[:, ::-1], axis=1)
            if eps_rel is not None:
                budget2 = (eps_rel**2) * S2.sum(axis=1, keepdims=True)
            else:
                budget2 = np.full((S2.shape[0], 1), float(delta) ** 2)
            discardable = (tails <= budget2).sum(axis=1)
            rank = max(1, min(rmax, int((S2.shape[1] - discardable).max())))
        else:
            rank = max(1, min(rmax, S2.shape[-1]))
    else:
        where = np.where(np.cumsum(S2[::-1]) <= delta**2)[0]
        if len(where) == 0:
            rank = max(1, min(rmax, len(S2)))
        else:
            rank = max(1, min(rmax, len(S2) - 1 - int(where[-1])))

    left = svd0[..., :rank]
    sr = svd1[..., :rank]
    # zero sigmas kept by rmax carry no data: a guarded reciprocal
    tiny = torch.finfo(sr.dtype).tiny
    sr_inv = torch.where(sr > tiny, 1.0 / torch.where(sr > tiny, sr, torch.ones_like(sr)),
                         torch.zeros_like(sr)).to(M.dtype)
    sr = sr.to(M.dtype)

    if singular_vectors == "left":
        if left_ortho:
            M2 = left.mH @ M
        else:
            M2 = sr_inv[..., None] * (left.mH @ M)
            left = left * sr[..., None, :]
    else:
        if left_ortho:
            M2 = M @ (left * sr_inv[..., None, :])
            left, M2 = M2, (left * sr[..., None, :]).mH
        else:
            left, M2 = M @ left, left.mH
    return left, M2
