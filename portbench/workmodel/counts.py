"""Operations (an FMA counts 2) and bytes (each input read once, each output
written once) of the port's entry points, from their shapes alone, and the
least time they need on the card.

Frozen copies: ``gram_flops`` and ``bound_s`` of ``chip_smoke.py``
(``gram_flops``, ``bound_ms``) and ``tt_eval_flops`` of its ``tt_work``."""

from __future__ import annotations

from math import prod

from portbench.workmodel.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

ITEMSIZE = {"float32": 4, "float64": 8, "int32": 4, "int64": 8}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time for the work: the larger of its operations over the
    dtype's peak and its bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def nbytes(shapes, dtype: str) -> float:
    return float(sum(prod(s) for s in shapes)) * ITEMSIZE[dtype]


def gram_flops(name: str, B, Rl, I, Rr, r1=0, r2=0) -> float:
    """One call of Gram entry point ``name`` on cores C (B, Rl, I, Rr):
    ``gram_edge(C, G)`` = C G C^T over (i, Rr), ``wgram(C, W)`` = C^T W C
    over (Rl, i), ``proj2(Y, C, X)`` = Y C X with Y (B, r1, Rl), X (B, Rr, r2)."""
    per = {"gram_edge": Rl * Rr * Rr + Rl * Rr * Rl, "wgram": Rl * Rl * Rr + Rl * Rr * Rr,
           "proj2": r1 * Rl * Rr + r1 * Rr * r2}[name]
    return 2.0 * B * I * per


def gram_work(name: str, shapes, dtype: str):
    """(flops, bytes) of one Gram call from its arguments' shapes:
    gram_edge (C, G), wgram (C, W), proj2 (Y, C, X)."""
    if name == "proj2":
        (B, r1, Rl), (_, _, I, Rr), (_, _, r2) = shapes
        out = (B, r1, I, r2)
        flops = gram_flops(name, B, Rl, I, Rr, r1, r2)
    else:
        (B, Rl, I, Rr), _ = shapes
        out = (B, Rl, Rl) if name == "gram_edge" else (B, Rr, Rr)
        flops = gram_flops(name, B, Rl, I, Rr)
    return flops, nbytes(list(shapes) + [out], dtype)


def tt_eval_flops(ranks, B: int):
    """(forward, backward) FLOPs of evaluating a TT of boundary-1 ``ranks``
    at B coordinate rows: only column 0 of the last mode is needed. The
    backward recomputes the left interfaces, forms each outer product and
    sweeps the right interfaces back."""
    ranks = list(ranks)
    cols = ranks[1:-1] + [1]
    fwd = sum(r * c for r, c in zip(ranks, cols))
    left = sum(ranks[k] * ranks[k + 1] for k in range(len(ranks) - 2))
    outer = sum(r * c for r, c in zip(ranks, cols))
    right = sum(r * c for r, c in zip(ranks[1:], cols[1:]))
    return 2.0 * B * fwd, 2.0 * B * (left + outer + right)


def tt_eval_work(core_shapes, x_shape, dtype: str, index_dtype: str, backward: bool):
    """(flops, bytes) of one ``tt_eval_kernel`` (values) or
    ``tt_eval_backward_kernel`` (the cores' gradients) call."""
    ranks = [core_shapes[0][0]] + [s[2] for s in core_shapes]
    B = x_shape[0]
    fwd, bwd = tt_eval_flops(ranks, B)
    x_bytes = nbytes([x_shape], index_dtype)
    if backward:  # cores and g in, gradients out
        return bwd, nbytes(list(core_shapes) * 2 + [(B,)], dtype) + x_bytes
    return fwd, nbytes(list(core_shapes) + [(B,)], dtype) + x_bytes

