"""Fixed-rank TT-SVD of dense data.

Counterpart of ``tntorch_tpu/ops/decomposition.py``. For a fixed target
rank the decomposition needs no rank choice on the host: one unfolding
after the other, each truncated to its rank.

- `tt_svd_gram`: the top-r subspace of each unfolding from the eigh of the
  Gram of its short side; deterministic. Batches (leading axis B) run one
  body over the batch axis.
- `tt_svd_randomized`: a randomized range finder per unfolding (Gaussian
  sketch, power iteration, QR, eigh of the small Gram), after Halko,
  Martinsson and Tropp.

PyTorch runs eagerly, so there is no jit: each is a short chain of batched
products and ``torch.linalg`` calls on the data's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tntorch_tpu_torch.utils import policy_precision


def _cap_ranks(shape, rmax) -> Tuple[int, ...]:
    """Target ranks clipped to the exact TT ranks of ``shape`` and to the
    chain cap r_k <= r_{k-1} I_{k-1} (the rows of the mode-k unfolding)."""
    N = len(shape)
    if not hasattr(rmax, "__len__"):
        rmax = [rmax] * (N - 1)
    ranks = [1]
    for k in range(1, N):
        full = min(int(np.prod(shape[:k])), int(np.prod(shape[k:])))
        ranks.append(min(int(rmax[k - 1]), full, ranks[-1] * int(shape[k - 1])))
    ranks.append(1)
    return tuple(ranks)


def _sym(G):
    return (G + G.mT) / 2


def _top(G, r):
    """The top-r eigenvectors of the symmetric G, descending (torch's eigh
    reads one triangle; JAX's symmetrizes, so this does too)."""
    return torch.flip(torch.linalg.eigh(_sym(G))[1], dims=[-1])[..., :r]


@policy_precision
def tt_svd_gram(data: torch.Tensor, rmax, batch: bool = False) -> list:
    """Deterministic fixed-rank TT-SVD of ``data`` ((B, ...) when
    ``batch``): each unfolding's top-r left subspace from the eigh of the
    Gram of its short side (the right vectors, pushed through and
    normalized, when the columns are fewer)."""
    b = tuple(data.shape[:1]) if batch else ()
    shape = data.shape[len(b):]
    ranks = _cap_ranks(shape, rmax)
    N = len(shape)
    cores = []
    M = data.reshape(b + (shape[0], -1))
    for k in range(N - 1):
        r = ranks[k + 1]
        m, n = M.shape[-2:]
        if m <= n:
            U = _top(M @ M.mT, r)
        else:
            U = M @ _top(M.mT @ M, r)  # un-normalized left vectors
            U = U / torch.linalg.vector_norm(U, dim=-2, keepdim=True).clamp(min=1e-30)
        cores.append(U.reshape(b + (ranks[k], shape[k], r)))
        M = (U.mT @ M).reshape(b + (r * shape[k + 1], -1))
    cores.append(M.reshape(b + (ranks[N - 1], shape[N - 1], 1)))
    return cores


def _omega(k: int, n: int, p: int, dtype, device, generator):
    """The (n, p) Gaussian sketch of unfolding k. From ``generator`` where
    the caller gives one; else from a CPU generator seeded by (k, n, p) in
    float64, cast and moved, so the CPU and the card use the same sketch.
    (The JAX package splits its key once per unfolding, which torch cannot
    replay.)"""
    if generator is None:
        g = torch.Generator().manual_seed((k * 1_000_003 + n) * 1_000_003 + p)
        return torch.randn((n, p), generator=g, dtype=torch.float64).to(device=device,
                                                                         dtype=dtype)
    return torch.randn((n, p), generator=generator, dtype=dtype,
                       device=generator.device).to(device)


@policy_precision
def tt_svd_randomized(data: torch.Tensor, rmax, generator: Optional[torch.Generator] = None,
                      oversample: int = 8, n_iter: int = 1) -> list:
    """Randomized fixed-rank TT-SVD: per unfolding M (m x n), Y = M Omega
    with p = min(r + oversample, m, n) columns, ``n_iter`` power
    iterations Y <- M (M^T Y), Q from the QR of Y, and the top-r left
    vectors of B = Q^T M from the eigh of B B^T."""
    shape = data.shape
    ranks = _cap_ranks(shape, rmax)
    N = len(shape)
    cores = []
    M = data.reshape(shape[0], -1)
    for k in range(N - 1):
        r = ranks[k + 1]
        m, n = M.shape
        p = min(r + oversample, m, n)
        Y = M @ _omega(k, n, p, data.dtype, data.device, generator)
        for _ in range(n_iter):  # power iteration for spectral accuracy
            Y = M @ (M.T @ Y)
        Q = torch.linalg.qr(Y).Q  # (m, p)
        Bm = Q.T @ M  # (p, n)
        U = _top(Bm @ Bm.T, r)  # (p, r)
        cores.append((Q @ U).reshape(ranks[k], shape[k], r))
        M = (U.T @ Bm).reshape(r * shape[k + 1], -1)
    cores.append(M.reshape(ranks[N - 1], shape[N - 1], 1))
    return cores
