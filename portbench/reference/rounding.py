"""Plain fixed-rank rounding of a batch of tensor trains by the randomized
two-sided Gram sweep (Al Daas, Ballard et al., "Parallel TT rounding based
on Gram SVD"), as ``round_tt(rmax, algorithm='randgram')`` states it for
batched real cores: right Grams from the last core in, then left to right
each edge's left Gram, its Cholesky factor F, the top-r subspace of
F^T G F by q = 2 power iterations on a fixed Gaussian sketch with
CholeskyQR, and the deferred push of each edge's transform into the next
core. A frozen copy of the algorithm's rules (jitter, sketch, iteration
count), written as plain einsums: it imports nothing of the port.

``jitter`` is the rule of the configuration's dtype (1e-6 of the trace for
float32, 1e-12 for float64), whatever precision the reference runs in: it
is part of what the sweep computes, not of its rounding."""

from __future__ import annotations

import torch

from portbench.reference.precision import Precision

POWER_ITERATIONS = 2


def jitter_rule(dtype_name: str) -> float:
    return 1e-12 if dtype_name == "float64" else 1e-6


def sketch(n: int, r: int, dtype_name: str, prec: Precision, device) -> torch.Tensor:
    """The (n, r) Gaussian sketch: drawn on the CPU from a generator seeded
    from (n, r) in float64, then rounded to the configuration's dtype."""
    g = torch.Generator().manual_seed((7 * 1_000_003 + n) * 1_000_003 + r)
    wide = torch.randn((n, r), generator=g, dtype=torch.float64)
    stated = wide.to(torch.float64 if dtype_name == "float64" else torch.float32)
    return prec.cast(stated).to(device)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _trace(G):
    return torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None, None]


def _sym(G):
    return 0.5 * (G + G.mT)


class _Sweep:
    def __init__(self, prec: Precision, dtype_name: str):
        self.prec = prec
        self.dtype_name = dtype_name
        self.eps_rel = jitter_rule(dtype_name)

    def jitter(self, G):
        return self.eps_rel * _trace(G) + torch.finfo(G.dtype).tiny

    def cholqr(self, Y):
        """Q of one CholeskyQR pass over the last two dims."""
        G = self.prec.matmul(Y.mT, Y)
        R = torch.linalg.cholesky_ex(_sym(G) + self.jitter(G) * _eye(G.shape[-1], G),
                                     upper=True).L
        return torch.linalg.solve_triangular(R, Y, upper=True, left=False)

    def top_subspace(self, A, r):
        S = sketch(A.shape[-1], r, self.dtype_name, self.prec, A.device)
        Y = self.prec.matmul(A, S)
        for _ in range(POWER_ITERATIONS):
            Y = self.prec.matmul(A, self.cholqr(Y))
        return self.cholqr(Y)

    def factorize(self, G, L, r):
        """(X, Y) of an edge from its right Gram G and left Gram L: L ~= F F^T,
        U spans the top-r subspace of F^T G F, X = F^-T U, Y = U^T F^T."""
        eye = _eye(L.shape[-1], L)
        F = torch.linalg.cholesky_ex(_sym(L) + self.jitter(L) * eye).L
        Finv = torch.linalg.solve_triangular(F.mT, eye.expand(L.shape), upper=True)
        A = self.prec.matmul(self.prec.matmul(F.mT, G), F)
        if r < A.shape[-1]:
            U = self.top_subspace(A, r)
        else:
            U = torch.flip(torch.linalg.eigh(_sym(A))[1], dims=(-1,))[..., :r]
        return self.prec.matmul(Finv, U), self.prec.matmul(U.mT, F.mT)


def round_randgram(cores, rmax: int, dtype_name: str, prec: Precision):
    """Cores (B, R_k, I_k, R_{k+1}) of B TTs of three modes or more, rounded
    to ranks at most ``rmax``, computed in ``prec``."""
    sw = _Sweep(prec, dtype_name)
    p = prec
    cores = [p.cast(c) for c in cores]
    N = len(cores)
    if N < 3:
        raise ValueError("the reference sweep takes three modes or more")
    B = cores[0].shape[0]
    G = [None] * (N + 1)
    G[N] = torch.ones((B, 1, 1), dtype=cores[0].dtype, device=cores[0].device)
    for k in range(N, 1, -1):
        C = cores[k - 1]
        if C.shape[-1] == 1:
            Cm = C.reshape(B, C.shape[1], C.shape[2])
            G[k - 1] = p.matmul(Cm * G[k], Cm.mT)
        else:
            T = p.einsum("zaib,zbc->zaic", C, G[k])
            G[k - 1] = p.einsum("zaic,zdic->zad", T, C)
    out = list(cores)
    Yp = None
    for k in range(1, N):
        C = cores[k - 1]
        if Yp is None:
            L = p.einsum("zaib,zaid->zbd", C, C)
        else:
            W = p.matmul(Yp.mT, Yp)
            L = p.einsum("zad,zdic->zaic", W, C)
            L = p.einsum("zaib,zaic->zbc", C, L)
        X, Y = sw.factorize(G[k], L, min(rmax, C.shape[-1]))
        if Yp is None:
            out[k - 1] = p.einsum("zaib,zbc->zaic", C, X)
        else:
            YC = p.einsum("zra,zaib->zrib", Yp, C)
            out[k - 1] = p.einsum("zrib,zbc->zric", YC, X)
        Yp = Y
    Cn = cores[N - 1]
    out[N - 1] = p.matmul(Yp, Cn.reshape(B, Cn.shape[1], -1)).reshape(
        B, Yp.shape[1], Cn.shape[2], Cn.shape[3])
    return out
