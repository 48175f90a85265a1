"""Fixed-rank and error-budgeted TT rounding sweeps, and Tucker rounding.

Counterpart of ``tntorch_tpu/ops/rounding.py``. PyTorch runs eagerly, so
there is no jit. The TT sweeps slice data-dependent ranks directly; the
Tucker sweep (`_tucker_eps_body`) masks them, as the JAX package does, so
that a batch runs one body and the ranks come back in one host read. The
batched Gram sweep
(`round_tt_gram_batched`) runs its three large contractions through the
hand-written CUDA kernels of `gram_kernels` when the cores are on the card,
and through their plain versions when they are on the CPU: the same algebra
either way. Under ``torch.profiler`` the sweep records
``tn.round_tt:right_grams``, one ``tn.round_tt:edge`` an edge, and in
`_sketch` ``tn.round_tt:sketch`` around ``tn.wait:sketch_copy``
(`utils.trace_annotation`).
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.utils import policy_precision, resolve_precision, trace_annotation

_INT_MAX = int(np.iinfo(np.int32).max)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _trace(G):
    """Real trace over the last two dims, shaped to broadcast against G."""
    return torch.diagonal(G, dim1=-2, dim2=-1).real.sum(-1)[..., None, None]


def _flip(x):
    return torch.flip(x, dims=[-1])


def _sym(G):
    """Hermitian part: JAX's cholesky and eigh symmetrize their input, while
    torch's read one triangle."""
    return (G + G.mH) / 2


def cholesky_qr2(M):
    """CholeskyQR2 (Yamamoto et al. 2015): tall-skinny QR as two rounds of
    Gram + Cholesky + triangular solve, batched over leading dims. The
    trace-scaled, dtype-aware jitter keeps the Cholesky alive on
    rank-deficient input."""

    def one(M):
        G = M.mH @ M
        eps_rel = 1e-14 if torch.finfo(M.dtype).eps < 1e-10 else 1e-6
        jit = eps_rel * _trace(G) + torch.finfo(M.dtype).tiny
        R = torch.linalg.cholesky_ex(_sym(G) + jit * _eye(G.shape[-1], G), upper=True).L
        # Q = M R^{-1}
        return torch.linalg.solve_triangular(R, M, upper=True, left=False), R

    Q1, R1 = one(M)
    Q, R2 = one(Q1)
    return Q, R2 @ R1


def _left_orthogonalize_sweep(cores, qr=torch.linalg.qr):
    """QR sweep making cores 0..N-2 left-orthogonal; cores may carry leading
    batch dims (..., Rl, I, Rr)."""
    cores = list(cores)
    for mu in range(len(cores) - 1):
        c = cores[mu]
        b, (Rl, I, Rr) = c.shape[:-3], c.shape[-3:]
        Q, R = qr(c.reshape(b + (Rl * I, Rr)))
        cores[mu] = Q.reshape(b + (Rl, I, Q.shape[-1]))
        nxt = cores[mu + 1]
        cores[mu + 1] = (R @ nxt.reshape(b + (nxt.shape[-3], -1))).reshape(
            b + (R.shape[-2],) + nxt.shape[-2:]
        )
    return cores


@policy_precision
def round_tt_fixed(cores, rmax: int):
    """Round a TT to rank <= rmax through a QR sweep and Gram-eigh
    truncations; ranks are min(rmax, full), never chosen from an error
    budget."""
    cores = _left_orthogonalize_sweep(list(cores))
    for mu in range(len(cores) - 1, 0, -1):
        Rl, I, Rr = cores[mu].shape
        r = min(rmax, Rl)
        M = cores[mu].reshape(Rl, I * Rr)
        _, V = torch.linalg.eigh(_sym(M @ M.mH))  # Hermitian Gram, ascending
        U = _flip(V)[:, :r]
        cores[mu] = (U.mH @ M).reshape(r, I, Rr)
        cores[mu - 1] = torch.einsum("ijk,kl->ijl", cores[mu - 1], U)
    return cores


def round_tt_flops(shapes, rmax: int) -> float:
    """Nominal FLOP count of the fixed-rank rounding sweep of a TT whose
    cores have ``shapes`` (R_k, I_k, R_{k+1}): a QR (2 m n^2) and the push
    of its R factor right per left-orthogonalization, then per truncation a
    Gram, an eigh (~9 R^3), the projection and the absorption of U left.
    The JAX package's model (its ops/rounding.py ``round_tt_flops``), the
    same count in the same order, so a rate quoted by either package
    divides the same work."""
    flops = 0.0
    cur = [tuple(s) for s in shapes]
    for mu in range(len(cur) - 1):  # the left-to-right QR sweep
        Rl, I, Rr = cur[mu]
        m, n = Rl * I, Rr
        flops += 2.0 * m * n * n  # QR
        k = min(m, n)
        R2l, I2, R2r = cur[mu + 1]
        flops += 2.0 * k * R2l * I2 * R2r  # push R right
        cur[mu] = (Rl, I, k)
        cur[mu + 1] = (k, I2, R2r)
    for mu in range(len(cur) - 1, 0, -1):  # the right-to-left truncation
        Rl, I, Rr = cur[mu]
        r = min(rmax, Rl)
        flops += 2.0 * Rl * Rl * I * Rr  # Gram
        flops += 9.0 * Rl**3  # eigh (approx)
        flops += 2.0 * r * Rl * I * Rr  # project
        Pl, PI, PRr = cur[mu - 1]
        flops += 2.0 * Pl * PI * PRr * r  # absorb U left
        cur[mu] = (r, I, Rr)
        cur[mu - 1] = (Pl, PI, r)
    return flops


@policy_precision
def tt_full(cores):
    """Dense reconstruction of a pure TT (chain of matmuls)."""
    factor = cores[0].reshape(-1, cores[0].shape[-1])
    for c in cores[1:]:
        factor = (factor @ c.reshape(c.shape[0], -1)).reshape(-1, c.shape[-1])
    return factor.reshape([c.shape[1] for c in cores])


@policy_precision
def tt_dot(cores1, cores2):
    """TT-TT inner product (core-by-core chain, unconjugated)."""
    L = torch.ones((cores2[0].shape[0], cores1[0].shape[0]), dtype=cores1[0].dtype,
                   device=cores1[0].device)
    for c1, c2 in zip(cores1, cores2):
        L = torch.einsum("saj,sai->ji", c2, torch.einsum("sr,rai->sai", L, c1))
    return L.sum()


def _sqrt_factor(G, eps_rel=None):
    """Lower Cholesky factor F of the jittered Hermitian PSD G (G ~= F F^H)
    and Finv = F^{-H}, batched over leading dims. The trace-scaled jitter
    dominates the Gram's roundoff negatives, so exactly singular Grams
    (rounding t+t) stay factorizable in f32 and f64."""
    if eps_rel is None:
        eps_rel = 1e-12 if torch.finfo(G.dtype).eps < 1e-10 else 1e-6
    tr = _trace(G)
    jitter = eps_rel * tr + torch.finfo(tr.dtype).tiny
    eye = _eye(G.shape[-1], G)
    F = torch.linalg.cholesky_ex(_sym(G) + jitter * eye).L
    # F^H Finv = I
    Finv = torch.linalg.solve_triangular(F.mH, eye.expand(G.shape), upper=True)
    return F, Finv


def resolve_edge_solver(edge_solver, precision) -> str:
    """'eigh' under the exact-first 'highest' policy, randomized subspace
    edges ('rand') under every performance policy, unless given."""
    if edge_solver is not None:
        return edge_solver
    return "eigh" if precision == "highest" else "rand"


def _cholqr(Y):
    """One CholeskyQR pass (Q only) over the last two dims, dtype-aware
    jitter."""
    eps_rel = 1e-12 if torch.finfo(Y.dtype).eps < 1e-10 else 1e-6
    G = Y.mH @ Y
    jit = eps_rel * _trace(G) + torch.finfo(G.real.dtype).tiny
    R = torch.linalg.cholesky_ex(_sym(G) + jit * _eye(G.shape[-1], G), upper=True).L
    return torch.linalg.solve_triangular(R, Y, upper=True, left=False)  # Y R^{-1}


def _sketch(n: int, r: int, dtype, device):
    """The (n, r) Gaussian sketch of the randomized edges. Drawn from a CPU
    generator seeded from (n, r) in double precision, then cast to the
    working dtype and moved to the device: the CPU and the card use the
    identical sketch, float32 and float64 runs the same one up to rounding,
    and distinct problem shapes draw distinct sketches. (The JAX package draws from
    ``jax.random.key(7)`` folded over (n, r), which torch cannot
    reproduce.)"""
    with trace_annotation("tn.round_tt:sketch"):
        g = torch.Generator().manual_seed((7 * 1_000_003 + n) * 1_000_003 + r)
        wide = torch.complex128 if dtype.is_complex else torch.float64
        draw = torch.randn((n, r), generator=g, dtype=wide)
        with trace_annotation("tn.wait:sketch_copy"):  # pageable memory: waits for the card
            return draw.to(device=device, dtype=dtype)


def _subspace_topr(A, r, q=2):
    """Orthonormal basis of ~the top-r eigenspace of the PSD matrix A
    (batched over leading dims) by randomized subspace iteration: q power
    iterations with CholeskyQR re-orthogonalization, no eigh."""
    Y = A @ _sketch(A.shape[-1], r, A.dtype, A.device)
    for _ in range(q):
        Y = A @ _cholqr(Y)
    return _cholqr(Y)


def _edge_rank(rmax, k, width):
    rk = rmax if isinstance(rmax, int) else rmax[k - 1]
    return min(rk, width)


def _identity(x):
    return x


def _edge_basis(A, r, edge_solver):
    """Top-r eigenbasis of the Hermitian PSD A (..., n, n)."""
    if edge_solver == "rand" and r < A.shape[-1]:
        # Any orthonormal basis of the top-r subspace gives the same projection
        return _subspace_topr(A, r)
    _, V = torch.linalg.eigh(_sym(A))  # ascending
    return _flip(V)[..., :r]


def _factorize(Gk, Lk, r, edge_solver):
    """Interface transforms of one edge from its right Gram Gk and left Gram
    Lk: X = F^{-H} U right-multiplies the core, Y = U^H F^H pushes the middle
    factor right, where Lk ~= F F^H and U spans the top-r eigenspace of
    A = F^H Gk F."""
    F, Finv = _sqrt_factor(Lk)
    U = _edge_basis(F.mH @ Gk @ F, r, edge_solver)
    return Finv @ U, U.mH @ F.mH


@policy_precision
def round_tt_gram(cores, rmax, precision: str = None, edge_solver: str = None):
    """Fixed-rank TT rounding without orthogonalization sweeps: the two-sided
    Gram method (cf. Al Daas, Ballard et al., "Parallel TT rounding based on
    Gram SVD"). The Gram squares the condition number: a performance path.

    :param precision: the policy name (default: the library policy); every
        policy computes in full precision here, except that 'bf16' takes
        `round_tt_gram_bf16` for real cores (complex ones keep their dtype).
    :param edge_solver: 'eigh' (exact truncation) or 'rand' (randomized
        subspace iteration); default follows the policy.
    """
    precision = resolve_precision(precision)
    edge_solver = resolve_edge_solver(edge_solver, precision)
    if not isinstance(rmax, int):
        rmax = tuple(int(r) for r in rmax)
    if precision == "bf16" and not cores[0].is_complex():
        return [c[0] for c in round_tt_gram_bf16([c[None] for c in cores], rmax, edge_solver)]
    return _round_tt_gram_body(list(cores), rmax, edge_solver)


@policy_precision
def round_tt_gram_bf16(cores, rmax, edge_solver: str = "eigh"):
    """The bf16-in, f32-accumulate Gram rounding of a batch of real TTs
    (cores (B, Rl, I, Rr)), the JAX package's ``_round_tt_gram_bf16_jit``
    over a leading batch axis (its batch vmaps that body; this one is
    batched natively, one batched ``eigh`` per edge, every sample on the
    same `_sketch`).

    The cores are rounded to bfloat16, and so are the right Gram chain's
    products T = C G and the new cores; every large product takes its
    bf16 operands upcast to float32 and runs in full float32 (a product of
    two bf16 numbers is exact in float32, so only the order of the sums
    differs from a bf16 x bf16 -> f32 unit). The Grams G and Lk and every
    factorization stay float32, the Cholesky jitter at 1e-3 of the trace
    (the bf16 contractions' noise floor). The output takes the input's
    dtype."""
    bf, f32 = torch.bfloat16, torch.float32
    in_dtype = cores[0].dtype
    cores = [c.to(bf) for c in cores]
    N = len(cores)
    B = cores[0].shape[0]

    def mm(spec, a, b):
        return torch.einsum(spec, a.to(f32), b.to(f32))

    G = [None] * (N + 1)
    G[N] = torch.ones((B, 1, 1), dtype=f32, device=cores[0].device)
    for k in range(N, 1, -1):
        C = cores[k - 1]
        T = mm("zaib,zbc->zaic", C, G[k]).to(bf)
        G[k - 1] = mm("zaic,zdic->zad", T, C)

    for k in range(1, N):
        C = cores[k - 1]
        # The prefix interface is orthonormal after each edge's projection,
        # so the left Gram is the plain Gram of the right unfolding
        Lk = mm("zaib,zaid->zbd", C, C)
        F, Finv = _sqrt_factor(Lk, eps_rel=1e-3)
        r = _edge_rank(rmax, k, Lk.shape[-1])
        U = _edge_basis(F.mT @ G[k] @ F, r, edge_solver)
        X, Y = Finv @ U, U.mT @ F.mT
        cores[k - 1] = mm("zaib,zbc->zaic", C, X).to(bf)
        nxt = cores[k]
        cores[k] = mm("zrb,zbj->zrj", Y, nxt.reshape(B, nxt.shape[1], -1)).reshape(
            B, r, nxt.shape[2], nxt.shape[3]).to(bf)
    return [c.to(in_dtype) for c in cores]


def _round_tt_gram_body(cores, rmax, edge_solver="eigh"):
    """Complex-safe: Hermitian Grams, the (F, F^{-H}) pair, conjugate
    transposes in the projections."""
    N = len(cores)
    G = [None] * (N + 1)
    G[N] = torch.ones((1, 1), dtype=cores[0].dtype, device=cores[0].device)
    for k in range(N, 1, -1):
        C = cores[k - 1]
        T = torch.einsum("aib,bc->aic", C, G[k])
        G[k - 1] = torch.einsum("aic,dic->ad", T, C.conj())

    for k in range(1, N):
        C = cores[k - 1]
        # The prefix interface is orthonormal after each edge's projection,
        # so the left Gram is the plain Gram of the right unfolding
        Lk = torch.einsum("aib,aid->bd", C.conj(), C)
        r = _edge_rank(rmax, k, Lk.shape[-1])
        X, Y = _factorize(G[k], Lk, r, edge_solver)
        cores[k - 1] = torch.einsum("aib,bc->aic", C, X)
        nxt = cores[k]
        cores[k] = (Y @ nxt.reshape(nxt.shape[0], -1)).reshape(r, nxt.shape[1], nxt.shape[2])
    return cores


def _rmax_list(rmax, count):
    """``count`` rank caps from None, one cap or a list (None: no cap)."""
    if rmax is None:
        return [_INT_MAX] * count
    if not hasattr(rmax, "__len__"):
        return [int(rmax)] * count
    return [_INT_MAX if r is None else int(r) for r in rmax]


def _eps_sweep(cores, eps, rmax, algorithm, qr):
    """Error-budgeted rounding of a batch of TTs (cores (B, Rl, I, Rr)).

    Left-orthogonalize, then a right-to-left sweep truncating each edge by
    its Gram-eigh ('eig') or SVD ('svd') spectrum. The rank rule is the JAX
    package's: with delta = eps * ||t|| / sqrt(N-1) per sample,
    k_discard = #(cumsum of the ascending sigma^2 <= delta^2) and
    r = clip(rows - k_discard, 1, rmax). The batch shares the largest rank;
    directions beyond a sample's own rank are zeroed, as the JAX package's
    masked kernels do. Returns the cores and the achieved relative error
    per sample (from the discarded spectra)."""
    cores = _left_orthogonalize_sweep(list(cores), qr=qr)
    N = len(cores)
    B = cores[0].shape[0]
    norm = torch.linalg.vector_norm(cores[-1].reshape(B, -1), dim=-1)
    delta2 = (eps / max(1.0, float(np.sqrt(N - 1))) * norm) ** 2
    disc2 = torch.zeros_like(norm)
    for mu in range(N - 1, 0, -1):
        _, Rl, I, Rr = cores[mu].shape
        M = cores[mu].reshape(B, Rl, I * Rr)
        if algorithm == "svd":
            U, S, Vh = torch.linalg.svd(M, full_matrices=False)
            w = _flip(S**2)  # ascending sigma^2
        else:
            w, V = torch.linalg.eigh(_sym(M @ M.mH))
            w = w.clamp(min=0)
        k = w.shape[-1]
        k_discard = (torch.cumsum(w, -1) <= delta2[:, None]).sum(-1)
        r_s = (k - k_discard).clamp(1, min(rmax[mu - 1], k))
        disc2 = disc2 + (w * (torch.arange(k, device=w.device) < (k - r_s)[:, None])).sum(-1)
        r = int(r_s.max())
        mask = (torch.arange(r, device=w.device) < r_s[:, None]).to(M.dtype)  # (B, r)
        if algorithm == "svd":
            cores[mu] = (Vh[:, :r] * mask[..., None]).reshape(B, r, I, Rr)
            left = U[..., :r] * S[:, None, :r].to(M.dtype) * mask[:, None, :]
        else:
            U = _flip(V)[..., :r] * mask[:, None, :]
            s = torch.sqrt(_flip(w)[:, :r].clamp(min=torch.finfo(w.dtype).tiny)).to(M.dtype)
            # core mu keeps the row-orthonormal U^H M / sigma; the scale goes
            # left, so the next edge's spectrum measures the global error
            cores[mu] = ((U.mH @ M) / s[..., None] * mask[..., None]).reshape(B, r, I, Rr)
            left = U * s[:, None, :]
        cores[mu - 1] = torch.einsum("zijk,zkl->zijl", cores[mu - 1], left)
    reached = torch.sqrt(disc2) / norm.clamp(min=torch.finfo(norm.dtype).tiny)
    return cores, reached


@policy_precision
def round_tt_eps(cores, eps: float, rmax=None, algorithm: str = "eig",
                 return_reached: bool = False):
    """Adaptive-rank rounding of one TT (3D cores), 'eig' or 'svd' spectra.
    Under the performance policies the orthogonalization uses CholeskyQR2.
    With ``return_reached`` also returns the achieved relative error."""
    N = len(cores)
    qr = torch.linalg.qr if resolve_precision(None) == "highest" else cholesky_qr2
    out, reached = _eps_sweep([c[None] for c in cores], eps, _rmax_list(rmax, N - 1), algorithm, qr)
    out = [c[0] for c in out]
    return (out, reached[0]) if return_reached else out


@policy_precision
def round_tt_batch(cores, rmax=None, algorithm: str = "svd", return_reached: bool = False):
    """Batch rounding with the reference's batch rule: no error budget
    (eps = 0), rank min(rmax, rows, cols) per edge, shared across the batch.
    Input/output: 4D cores (B, Rl, I, Rr)."""
    out, reached = _eps_sweep(list(cores), 0.0, _rmax_list(rmax, len(cores) - 1), algorithm,
                              torch.linalg.qr)
    return (out, reached) if return_reached else out


def _tucker_eps_body(cores, us, eps, dims, algorithm, rmax):
    """Masked Tucker rounding of a batch of TTs (cores (B, Rl, S, Rr); ``us``
    the factors, (I, S) shared or (B, I, S)), the JAX package's
    ``_tucker_eps_body`` over a leading batch axis.

    Left-orthogonalize, then right to left per mode: QR the core's
    (Rl Rr, S) unfolding and push R into the factor, truncate the factor by
    its SVD ('svd') or Gram-eigh ('eig') spectrum with the budget
    delta = eps/sqrt(len(dims)) * |U| (every other node is orthogonal, so
    the local error is the global one), keep the factor orthonormal with
    the scale in the core, and right-orthogonalize. As in the JAX package,
    every mode is truncated: ``dims`` only sets the split. Ranks are
    clip(k - k_discard, 1, rmax) per sample; columns beyond a sample's rank
    are zeroed, not cut, so the ranks stay on the device. Returns the cores,
    the factors and the ranks (B, N)."""
    cores = _left_orthogonalize_sweep(list(cores))
    us = list(us)
    N = len(cores)
    B = cores[0].shape[0]
    delta_scale = eps / max(1.0, float(np.sqrt(len(dims))))
    effs = [None] * N
    for mu in range(N - 1, -1, -1):
        _, Rl, S, Rr = cores[mu].shape
        # Push the core's non-orthogonality into the factor
        Q, Rm = torch.linalg.qr(cores[mu].mT.reshape(B, Rl * Rr, S))  # S' = min(Rl Rr, S)
        Sp = Q.shape[-1]
        core = Q.reshape(B, Rl, Rr, Sp).mT
        U = us[mu] @ Rm.mT  # (B, I, S')
        delta = delta_scale * torch.linalg.vector_norm(U.reshape(B, -1), dim=-1)
        if algorithm == "svd":
            left, s, vh = torch.linalg.svd(U, full_matrices=False)
            k = s.shape[-1]  # min(I, S')
            w = s**2
            proj = s[..., None].to(U.dtype) * vh  # (B, k, S'): U = left @ proj
        else:
            w, V = torch.linalg.eigh(_sym(U.mH @ U))
            w, Vd = _flip(w).clamp(min=0), _flip(V)  # descending
            k = Sp
            sig = torch.sqrt(w.clamp(min=torch.finfo(w.dtype).tiny))
            left = (U @ Vd) / sig[:, None, :].to(U.dtype)  # orthonormal
            proj = sig[..., None].to(U.dtype) * Vd.mH  # (B, S', S')
        k_discard = (torch.cumsum(_flip(w), -1) <= (delta**2)[:, None]).sum(-1)
        # rmax caps inside the sweep: later modes see the capped network
        r = (k - k_discard).clamp(1, min(rmax[mu], k))
        mask = (torch.arange(k, device=r.device) < r[:, None]).to(U.dtype)  # (B, k)
        us[mu] = left * mask[:, None, :]
        cores[mu] = torch.einsum("zisk,zas->ziak", core, proj * mask[..., None])
        effs[mu] = r
        if mu > 0:
            # Right-orthogonalize mu, pushing L into core mu-1. A wide
            # unfolding's reduced QR gives L (min, Rl): that is the new width
            core = cores[mu]
            Rl = core.shape[1]
            Q, L = torch.linalg.qr(core.reshape(B, Rl, -1).mT)
            cores[mu] = Q.mT.reshape((B, Q.shape[-1]) + core.shape[2:])
            prev = cores[mu - 1]
            cores[mu - 1] = (prev.reshape(B, -1, Rl) @ L.mT).reshape(
                prev.shape[:-1] + (L.shape[-2],))
    return cores, us, torch.stack(effs, dim=-1)


def _compact(cores, us, effs, batch):
    """Cut the zeroed tails: one host read of the ranks (the largest of the
    batch's), then slices."""
    effs = effs.max(dim=0).values.tolist()
    out_cores = [c[..., :r, :] for c, r in zip(cores, effs)]
    out_us = [u[..., :r] for u, r in zip(us, effs)]
    if not batch:
        out_cores, out_us = [c[0] for c in out_cores], [u[0] for u in out_us]
    return out_cores, out_us


@policy_precision
def round_tucker_eps(cores, us, eps: float, rmax=None, dims=None, algorithm: str = "eig"):
    """Adaptive Tucker rounding of one TT (3D cores, factors ``us`` (I, S),
    identities for modes without one), with one host read for the ranks.
    Every mode is truncated; ``dims`` only sets the eps/sqrt(len(dims))
    split. Returns (cores, us)."""
    N = len(cores)
    dims = tuple(range(N) if dims is None else dims)
    out = _tucker_eps_body([c[None] for c in cores], [u[None] for u in us], eps, dims,
                           algorithm, _rmax_list(rmax, N))
    return _compact(*out, batch=False)


@policy_precision
def round_tucker_eps_batch(cores, us, rmax=None, dims=None, algorithm: str = "svd"):
    """Batch Tucker rounding with the reference's batch rule: no error
    budget (eps = 0), rank min(rmax, full) per factor; one body over the
    batch axis, the identity factors ``us`` (I, S) shared. Returns (cores,
    us) cut to the largest rank of the batch."""
    N = len(cores)
    dims = tuple(range(N) if dims is None else dims)
    out = _tucker_eps_body(list(cores), list(us), 0.0, dims, algorithm, _rmax_list(rmax, N))
    return _compact(*out, batch=True)


@policy_precision
def round_tt_gram_batched(cores, rmax, edge_solver: str = "eigh", reduce=None):
    """Fixed-rank Gram rounding of a batch of TTs (cores (B, Rl, I, Rr)).

    Real cores run the right-Gram chain through `gram_edge`, except an edge
    whose core has one right rank (the last): that one is the batched
    product `(C G) C^T` with C as (B, Rl, I), as in the JAX package, on the
    CPU and the card alike. For N >= 3 they run the no-push left sweep:
    interface transforms Y are deferred instead of pushed into the next
    core; the left Gram of the pushed core Y C is
    `wgram(C, Y^T Y)` and each output core is `proj2(Y_prev, C, X)`, so the
    pushed core never exists. On CUDA tensors those are the hand-written
    kernels; on the CPU their plain versions. Complex cores take the einsum
    push sweep (the JAX package's own branch).

    ``reduce``, where given, maps every Gram matrix to its sum over the
    slices of the modes that other processes hold (an all-reduce: the
    mode-sharded sweep of `parallel.round_tt_gram_sharded`). It is applied
    to each right Gram and each left Gram, the only contractions over the
    mode index, before the edge's factorization; everything else is local
    to a mode index. Without it the sweep is the single-device one."""
    from tntorch_tpu_torch.ops.gram_kernels import gram_edge, proj2, wgram

    if reduce is None:
        reduce = _identity

    cores = [c.contiguous() for c in cores]
    N = len(cores)
    B = cores[0].shape[0]
    real = not cores[0].is_complex()

    G = [None] * (N + 1)
    G[N] = torch.ones((B, 1, 1), dtype=cores[0].dtype, device=cores[0].device)
    with trace_annotation("tn.round_tt:right_grams"):
        for k in range(N, 1, -1):
            C = cores[k - 1]
            if real and C.shape[-1] == 1:
                # One right rank: the edge is a batched product, which the JAX
                # package leaves to XLA's einsum too (gram_edge_supported refuses
                # Rr % 128 != 0; tntorch_tpu/ops/rounding.py:790-795)
                Cm = C.reshape(B, C.shape[1], C.shape[2])
                G[k - 1] = reduce((Cm * G[k]) @ Cm.mT)
            elif real:
                G[k - 1] = reduce(gram_edge(C, G[k]))
            else:
                T = torch.einsum("zaib,zbc->zaic", C, G[k])
                G[k - 1] = reduce(torch.einsum("zaic,zdic->zad", T, C.conj()))

    if real and N >= 3:
        out = list(cores)
        Yp = None
        for k in range(1, N):
            with trace_annotation("tn.round_tt:edge"):
                C = cores[k - 1]  # the original core: pushes are deferred
                if Yp is None:
                    Lk = reduce(torch.einsum("zaib,zaid->zbd", C, C))
                else:
                    Lk = reduce(wgram(C, (Yp.mT @ Yp).contiguous()))
                X, Y = _factorize(G[k], Lk, _edge_rank(rmax, k, C.shape[-1]), edge_solver)
                if Yp is None:
                    out[k - 1] = torch.einsum("zaib,zbc->zaic", C, X)
                else:
                    out[k - 1] = proj2(Yp.contiguous(), C, X.contiguous())
                Yp = Y
        Cn = cores[N - 1]
        out[N - 1] = (Yp @ Cn.reshape(B, Cn.shape[1], -1)).reshape(
            B, Yp.shape[1], Cn.shape[2], Cn.shape[3]
        )
        return out

    for k in range(1, N):
        with trace_annotation("tn.round_tt:edge"):
            C = cores[k - 1]
            Lk = reduce(torch.einsum("zaib,zaid->zbd", C.conj(), C))
            r = _edge_rank(rmax, k, C.shape[-1])
            X, Y = _factorize(G[k], Lk, r, edge_solver)
            cores[k - 1] = torch.einsum("zaib,zbc->zaic", C, X)
            nxt = cores[k]
            cores[k] = (Y @ nxt.reshape(B, nxt.shape[1], -1)).reshape(
                B, r, nxt.shape[2], nxt.shape[3]
            )
    return cores
