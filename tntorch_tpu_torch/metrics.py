"""Inner products, distances and statistics computed in compressed form.

Counterpart of ``tntorch_tpu/metrics.py`` (dot, normsq, norm, dist,
relative_error, rmse, r_squared, sum, mean, var, std, skew, kurtosis,
raw_moment, normalized_moment, hadamard_sum). Batch tensors give one value
per sample, shape (B,). The statistics ride on `tools.ttm` (rank-1
contractions with ones or marginal weights) and on `dot`; their helper
arrays take the tensor's device and dtype. ``skew`` and ``kurtosis`` raise
the standardized tensor to a power by cross approximation (``**``); the
moments of `raw_moment` are Hadamard sums, exact or by rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor
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
    conjugation. Full contractions give a scalar, or (B,) for batches. CP
    factors take part as they are: each keeps the running product's axis
    of its rank instead of contracting it."""
    t1, t2, dbatch = _process(t1, t2)
    if not isinstance(t1, Tensor) and not isinstance(t2, Tensor):
        return (_flat(t1, dbatch) * _flat(t2, dbatch)).sum(-1)
    if t1.batch != t2.batch:
        raise ValueError("Cannot dot a batch tensor with a non-batch tensor")
    batch = t1.batch
    dtype = torch.promote_types(t1.dtype, t2.dtype)

    m = 3 if batch else 2  # the ndim of a CP factor

    def _project_left(core, M):
        if core.ndim == m:
            return torch.einsum("...sr,...ar->...sar", M, core.to(dtype))
        return torch.einsum("...sr,...rai->...sai", M, core.to(dtype))

    def _project_spatial(core, M):
        if core.ndim == m:
            return torch.einsum("...ak,...aj->...jk", core.to(dtype), M.to(dtype))
        return torch.einsum("...iak,...aj->...ijk", core.to(dtype), M.to(dtype))

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
        core1, core2 = t1.cores[mu], t2.cores[mu]
        U1, U2 = t1.Us[mu], t2.Us[mu]
        # Absorb the Tucker factors: the side without one takes the other's
        if U1 is None:
            if U2 is not None:
                core1 = _project_spatial(core1, U2)
        elif U2 is None:
            core2 = _project_spatial(core2, U1)
        else:
            core2 = _project_spatial(core2, torch.einsum("...as,...ar->...sr", U2.to(dtype),
                                                         U1.to(dtype)))
        Ucore = _project_left(core1, Lprod)
        spec = "...as,...sar->...sr" if core2.ndim == m else "...sai,...saj->...ij"
        Lprod = torch.einsum(spec, core2.to(dtype), Ucore)

    if k == t1.dim() and k == t2.dim():
        return Lprod.sum((-2, -1))
    if k < t1.dim():
        t1trail = Tensor(list(t1.cores[k:]), Us=list(t1.Us[k:]), batch=batch)
        t1trail.cores[0] = _project_left(t1trail.cores[0], Lprod)
        if k == t2.dim():
            return t1trail
        # modes left on both sides: t1's trailing modes reversed, then t2's
        from tntorch_tpu_torch.tools import transpose

        t2trail = Tensor(list(t2.cores[k:]), Us=list(t2.Us[k:]), batch=batch)
        t1trail = transpose(t1trail)
        return Tensor(t1trail.cores + t2trail.cores, Us=t1trail.Us + t2trail.Us, batch=batch)
    t2trail = Tensor(list(t2.cores[k:]), Us=list(t2.Us[k:]), batch=batch)
    t2trail.cores[0] = _project_left(t2trail.cores[0], Lprod.mT)
    return t2trail


def _is_complex(t):
    return isinstance(t, Tensor) and t.dtype.is_complex


def _conj(t):
    t2 = t.clone()
    t2.cores = [c.conj() for c in t2.cores]
    t2.Us = [None if U is None else U.conj() for U in t2.Us]
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


def rmse(gt, approx):
    """Root-mean-square error; (B,) for batch input."""
    gt, approx, dbatch = _process(gt, approx)
    if not isinstance(gt, Tensor) and not isinstance(approx, Tensor):
        n = gt.numel() / gt.shape[0] if dbatch else gt.numel()
        return torch.linalg.vector_norm(_flat(gt - approx, dbatch), dim=-1) / np.sqrt(n)
    n = gt.numel() / (gt.shape[0] if gt.batch else 1)
    return dist(gt, approx) / np.sqrt(n)


def r_squared(gt, approx):
    """The R^2 score; (B,) for batch input."""
    gt, approx, dbatch = _process(gt, approx)
    if not isinstance(gt, Tensor) and not isinstance(approx, Tensor):
        gf, af = _flat(gt, dbatch), _flat(approx, dbatch)
        d = torch.linalg.vector_norm(gf - af, dim=-1)
        dm = torch.linalg.vector_norm(gf - gf.mean(dim=-1, keepdim=True), dim=-1)
        return 1 - d**2 / dm**2
    return 1 - dist(gt, approx) ** 2 / normsq(gt - mean(gt))


def _modes(t, dim):
    if dim is None:
        dim = range(t.dim())
    if not hasattr(dim, "__len__"):
        dim = [dim]
    return [d + t.dim() if d < 0 else int(d) for d in dim]


def sum(t, dim=None, keepdim=False, _normalize=False):
    """Sum over all modes or the modes ``dim`` by rank-1 contractions with
    ones (`tools.ttm`). A full sum gives a scalar tensor, or (B,) for a
    batch (whose batch axis is never reduced); a partial one a Tensor, with
    the reduced modes squeezed unless ``keepdim``."""
    from tntorch_tpu_torch.tools import squeeze, ttm

    dim = _modes(t, dim)
    off = 1 if t.batch else 0
    us = [torch.ones(t.shape[d + off], dtype=t.dtype, device=t.device) for d in dim]
    if _normalize:
        us = [u / u.shape[0] for u in us]
    result = ttm(t, us, dim)
    if keepdim:
        return result
    if t.batch:  # exactly the reduced modes: an unrelated singleton survives
        return squeeze(result, dim=dim)
    return squeeze(result)


def _pdf_cores(t, marginals, dims, uniform):
    """Rank-1 cores of the weights: each marginal (I,) or (B, I) of the
    modes ``dims`` normalized to a PMF, 1/I (``uniform``) or 1 elsewhere,
    on the tensor's device and in its dtype; broadcast over a batch."""
    off = 1 if t.batch else 0
    cores = [torch.ones((1, sh, 1), dtype=t.dtype, device=t.device) / (sh if uniform(n) else 1)
             for n, sh in enumerate(t.shape[off:])]
    for d, marg in zip(dims, marginals):
        marg = asarray(marg, dtype=t.dtype, device=t.device)
        cores[d] = (marg / marg.sum(dim=-1, keepdim=True))[..., None, :, None]
    if t.batch:
        cores = [c.expand((t.shape[0],) + c.shape[-3:]) for c in cores]
    return Tensor(cores, batch=t.batch)


def mean(t, dim=None, marginals=None, keepdim=False):
    """Mean over all modes or the modes ``dim``; with ``marginals`` (one
    weight vector per reduced mode, (I,) or (B, I) per sample) the
    expectation under them. Modes in ``dim`` beyond the marginals given
    stay uniform, and unreduced modes are not weighted."""
    if marginals is not None:
        dim = _modes(t, dim)
        pdf = _pdf_cores(t, marginals, dim, uniform=lambda n: n in dim)
        return sum(t * pdf, dim, keepdim)
    return sum(t, dim, keepdim, _normalize=True)


def var(t, marginals=None):
    """Variance; (B,) for batch input. With ``marginals`` (one per mode)
    the variance under them."""
    if marginals is not None:
        if len(marginals) != t.dim():
            raise ValueError(f"var needs one marginal per mode ({t.dim()}), got {len(marginals)}")
        tcentered = t - mean(t, marginals=marginals)
        pdf = _pdf_cores(t, marginals, range(t.dim()), uniform=lambda n: False)
        return dot(tcentered * pdf, tcentered)
    n = t.numel() / (t.shape[0] if t.batch else 1)  # entries per sample
    return normsq(t - mean(t)) / n


def std(t):
    """Standard deviation, sqrt(var)."""
    return torch.sqrt(var(t))


def skew(t):
    """Skewness, E[((t - E t) / std t)^3]; the power by cross approximation."""
    return mean(((t - mean(t)) / std(t)) ** 3)


def kurtosis(t, fisher=True):
    """Kurtosis, E[((t - E t) / std t)^4], less 3 when ``fisher`` (the
    excess kurtosis); the power by cross approximation."""
    return mean(((t - mean(t)) / std(t)) ** 4) - fisher * 3


def raw_moment(t, k, marginals=None, eps=1e-6, algorithm="eig"):
    """E[t^k], the Hadamard sum of k copies of t over the entries' count, or
    with ``marginals`` (one weight vector per mode) under their product."""
    if marginals is not None:
        pdf = _pdf_cores(t, marginals, range(t.dim()), uniform=lambda n: False)
        return hadamard_sum([t] * (k - 1) + [t * pdf], eps=eps, algorithm=algorithm)
    n = t.numel() / (t.shape[0] if t.batch else 1)  # entries per sample
    return hadamard_sum([t] * k, eps=eps, algorithm=algorithm) / n


def normalized_moment(t, k, marginals=None, eps=1e-12, algorithm="eig"):
    """E[(t - E t)^k] / var(t)^(k/2)."""
    return raw_moment(t - mean(t, marginals=marginals), k=k, marginals=marginals, eps=eps,
                      algorithm=algorithm) / var(t, marginals=marginals) ** (k / 2.0)


def hadamard_sum(ts, algorithm="exact", eps=None):
    """The sum of the entries of the elementwise product of the tensors
    ``ts`` (one shape): contracted exactly (``'exact'``, batches in one
    pass), or mode by mode with a TT rounding of the M-tensor chain to
    ``eps`` (default 1e-14) by ``algorithm`` ('eig', 'svd'; batches one
    sample at a time, the ranks being the data's)."""
    M = len(ts)
    if eps is None:
        eps = 1e-14
    batch = ts[0].batch
    if any(t.batch != batch for t in ts):
        raise ValueError("Cannot mix batch and non-batch tensors in hadamard_sum")
    for t in ts[1:]:
        if tuple(ts[0].shape) != tuple(t.shape):
            raise ValueError(f"hadamard_sum expects equal shapes (incl. batch size), got "
                             f"{tuple(t.shape)} vs {tuple(ts[0].shape)}")
    if batch and algorithm != "exact":
        values = [hadamard_sum([t[b] for t in ts], algorithm=algorithm, eps=eps)
                  for b in range(ts[0].shape[0])]
        return torch.stack([torch.as_tensor(v) for v in values])
    cores = [t.tt().cores for t in ts]
    if algorithm == "exact" or ts[0].dim() == 1:
        return _hadamard_sum_exact(cores, batch)
    return _hadamard_sum_rounded(cores, eps, algorithm)


@policy_precision
def _hadamard_sum_exact(core_lists, batch):
    """Exact M-tensor Hadamard sum of TT cores (a leading batch axis on
    every core when ``batch``): a state with one rank axis per tensor,
    carried along the modes, each tensor's core contracted into its axis
    at every index of the mode, then the mode summed."""
    M = len(core_lists)
    c0 = core_lists[0][0]
    lead = tuple(c0.shape[:1]) if batch else ()
    ranks = "".join(chr(ord("b") + m) for m in range(M))  # the state's rank axes
    state = torch.ones(lead + (1,) * M, dtype=c0.dtype, device=c0.device)
    for n in range(len(core_lists[0])):
        state = state.unsqueeze(len(lead)).expand(
            lead + (core_lists[0][n].shape[-2],) + state.shape[len(lead):])
        for m in range(M):
            out = ranks[:m] + "Z" + ranks[m + 1:]
            state = torch.einsum(f"...a{ranks},...{ranks[m]}aZ->...a{out}", state,
                                 core_lists[m][n])
        state = state.sum(len(lead))
    return state.reshape(lead)


@policy_precision
def _hadamard_sum_rounded(core_lists, eps, algorithm):
    """The rounded Hadamard sum of plain TTs: the M tensors' cores at one
    mode as an M-core chain of diagonal cores, rounded; each mode's chain
    contracted into the running one, which is rounded again."""
    M = len(core_lists)

    def diag_core(c, m):
        # (Rl, I, Rr) -> (I, Rl, Rr, I): core[a, l, r, b] = delta(a, b) c[l, a, r]
        eye = torch.eye(c.shape[1], dtype=c.dtype, device=c.device)
        core = eye[:, None, None, :] * c.permute(1, 0, 2)[:, :, :, None]
        if m == 0:
            core = core.sum(0, keepdim=True)
        if m == M - 1:
            core = core.sum(-1, keepdim=True)
        return core

    def chain(cores):
        cs = [diag_core(cores[m], m) for m in range(M)]
        t = Tensor([c.reshape(c.shape[0], c.shape[1] * c.shape[2], c.shape[3]) for c in cs])
        t.round_tt(eps, algorithm=algorithm)
        return [c.reshape(c.shape[0], cores[m].shape[0], cores[m].shape[2], c.shape[-1])
                for m, c in enumerate(t.cores)]

    N = len(core_lists[0])
    this = chain([cs[0] for cs in core_lists])
    for n in range(1, N):
        nxt = chain([cs[n] for cs in core_lists])
        cores = []
        for m in range(M):
            c = torch.einsum("ijkl,akbc->iajblc", this[m], nxt[m])
            cores.append(c.reshape(c.shape[0] * c.shape[1] * c.shape[2], c.shape[3],
                                   c.shape[4] * c.shape[5]))
        t = Tensor(cores)
        t.round_tt(eps, algorithm=algorithm)
        this = [c.reshape(c.shape[0], 1, c.shape[1], -1) for c in t.cores]
    return Tensor([c.reshape(c.shape[0], c.shape[2], c.shape[3]) for c in this]).full().reshape(())
