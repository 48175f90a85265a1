"""Plain evaluation of tensor trains at integer coordinates: the chain
``v <- v C_k[:, x_k, :]`` over the modes, in blocks of rows so that the
gathered slices fit."""

from __future__ import annotations

import torch

from portbench.reference.precision import Precision

# Gathered slice entries a block may hold (2^26: 512 MiB in float64)
BLOCK_ENTRIES = 1 << 26


def _rows_per_block(cores) -> int:
    widest = max(c.shape[0] * c.shape[2] for c in cores)
    return max(1, BLOCK_ENTRIES // widest)


def tt_values(cores, X, prec: Precision, absolute: bool = False) -> torch.Tensor:
    """Values (B,) of the TT with cores (R_k, I_k, R_{k+1}), R_0 = R_N = 1,
    at the rows of X (B, N), in ``prec``. With ``absolute`` the chain runs on
    |C_k|: each value's sum of the magnitudes of its terms, the scale that
    its rounding error is measured against."""
    cores = [prec.cast(c.abs() if absolute else c) for c in cores]
    out = []
    step = _rows_per_block(cores)
    for b0 in range(0, X.shape[0], step):
        x = X[b0:b0 + step]
        v = cores[0][0, x[:, 0], :]
        for k in range(1, len(cores)):
            v = prec.einsum("br,rbs->bs", v, cores[k][:, x[:, k], :])
        out.append(v[:, 0])
    return torch.cat(out)


def batch_values(cores, X, prec: Precision) -> torch.Tensor:
    """Values (M, P) of M TTs, cores (M, R_k, I_k, R_{k+1}), each at its own
    P rows X (M, P, N)."""
    cores = [prec.cast(c) for c in cores]
    M, P = X.shape[:2]
    member = torch.arange(M, device=X.device)[:, None].expand(M, P)
    v = cores[0][member, 0, X[..., 0], :]  # (M, P, R_1)
    for k in range(1, len(cores)):
        v = prec.einsum("mpr,mprs->mps", v, cores[k][member, :, X[..., k], :])
    return v[..., 0]
