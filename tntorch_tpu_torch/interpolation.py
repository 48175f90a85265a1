"""Completion and interpolation: ALS on sparse samples, sparse TT-SVD, LARS
and a polynomial chaos expansion (PCE) surrogate.

Counterpart of ``tntorch_tpu/interpolation.py``. The JAX package's jitted
programs become torch ops on the data's device: each ALS mode's slice
solves (`_als_solve_mode`: gather, Khatri-Rao rows, ridge-regularized
normal equations, one batched ``torch.linalg.solve``), the sketched range
finder of `sparse_tt_svd` (`_sketch_range`: scatter-adds by
``index_add_`` and Householder QR) and the LARS active-set loop
(`_lars_path_kernel`: a fixed number of masked steps on a padded Cholesky
factor). The sparse bookkeeping (segments, unique columns) stays in host
NumPy. Float32 products run in full float32 (`utils.policy_precision`).

Data without a device lands on ``device`` (default: `default_device`, the
card). Two differences from the JAX package: the sketch's Gaussian draw
(`_sketch_omega`) comes from a CPU generator, as the JAX key cannot be
replayed; and on the card ``index_add_`` on floating values sums in an
order that varies from call to call, so the sketched path is not bitwise
reproducible there. ``als_completion(mesh=)`` shards each mode's slice
solves over a mesh of ranks (`parallel`).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tntorch_tpu_torch.ops.rounding import _sym
from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import asarray, default_dtype, logger, policy_precision, to_numpy


@policy_precision
def _als_solve_mode(left, right, y, seg_idx, seg_w):
    """One ALS mode's per-slice least squares, batched over the slices.

    Samples are grouped by their mode index into padded segments (seg_idx
    (I, S), pad weight 0): slice i's design matrix holds the Khatri-Rao
    rows l_p (x) r_p of its samples, and its solution comes from the
    normal equations with a dtype-aware ridge (underdetermined slices make
    the Gram exactly singular).

    :param left: (P, Rl) left interfaces; right: (P, Rr); y: (P,)
    :return: (slices (I, Rl, Rr), the sum of squared residuals on the device)
    """
    Rl, Rr = left.shape[1], right.shape[1]
    I, S = seg_idx.shape
    A = (left[seg_idx][..., :, None] * right[seg_idx][..., None, :]).reshape(I, S, Rl * Rr)
    A = A * seg_w[..., None]
    b = y[seg_idx] * seg_w
    G = torch.einsum("isa,isb->iab", A, A)
    rhs = torch.einsum("isa,is->ia", A, b)
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    eps_rel = 1e-13 if G.dtype == torch.float64 else 1e-6
    ridge = eps_rel * tr + torch.finfo(A.dtype).tiny
    eye = torch.eye(Rl * Rr, dtype=A.dtype, device=A.device)
    sol = torch.linalg.solve(G + ridge * eye, rhs[..., None])[..., 0]
    resid = torch.einsum("isa,ia->is", A, sol) - b
    return sol.reshape(I, Rl, Rr), (resid ** 2).sum()


def _mode_segments(X, mu, I, ws, device, dtype):
    """Sample rows grouped by their mode-``mu`` index into zero-weight
    padded segments, built on the host: (seg_idx (I, S_max), seg_w (I,
    S_max)) on ``device``."""
    order = np.argsort(X[:, mu], kind="stable")
    starts = np.searchsorted(X[order, mu], np.arange(I + 1))
    S = max(1, int(np.diff(starts).max()))
    seg_idx = np.zeros((I, S), dtype=np.int64)
    seg_w = np.zeros((I, S), dtype=np.float64)
    for i in range(I):
        sl = order[starts[i]:starts[i + 1]]
        seg_idx[i, :len(sl)] = sl
        seg_w[i, :len(sl)] = ws[sl]
    return (torch.from_numpy(seg_idx).to(device),
            torch.from_numpy(seg_w).to(device=device, dtype=dtype))


def als_completion(X, y, ranks_tt, shape=None, ws=None, x0=None, niter=10, verbose=True,
                   mesh=None, restarts: int = 1, restart_tol: float = 1e-4,
                   _return_eps: bool = False, device=None,
                   generator: Optional[torch.Generator] = None):
    """Complete a TT from P (index, value) samples by alternating least
    squares over its cores, with memoized left and right interface chains.

    Each mode's slice solves run as one batched program (`_als_solve_mode`);
    a sweep reads the residual back once, for its ``eps``. ``x0`` (a TT of
    the target shape) is updated in place and returned; without it a
    ``tn.rand`` start is drawn from ``generator``. With ``restarts`` > 1 and
    no ``x0``, up to that many starts are tried and the fit with the lowest
    training residual is returned, stopping once it is below
    ``restart_tol``. ``y`` is cast to `default_dtype`, as in the JAX
    package, and lands on ``device`` unless it is a torch tensor.

    ``mesh`` (a ``DeviceMesh``, `parallel`; every rank calls with the same
    arguments) shards each mode's slice solves over the mesh's first axis:
    the slices, padded with empty ones to a multiple of the axis size, are
    split by `parallel.mesh.local_rows`, each rank solves its own, and one
    all-gather (`parallel.mesh.gather_rows`) puts the core together on
    every rank. The interface chains stay replicated; the sweep's residual
    is summed over the axis by one all-reduce at its one read. x0's cores
    are rank 0's (one broadcast each)."""
    if restarts > 1 and x0 is None:
        best, best_eps = None, float("inf")
        for _ in range(int(restarts)):
            cand, eps = als_completion(X, y, ranks_tt, shape=shape, ws=ws, niter=niter,
                                       verbose=verbose, mesh=mesh, _return_eps=True,
                                       device=device, generator=generator)
            # NaN residuals (diverged solves, niter=0) still return a tensor
            if best is None or eps < best_eps:
                best, best_eps = cand, eps
            if eps < restart_tol:
                break
        return (best, best_eps) if _return_eps else best

    X = np.asarray(to_numpy(X))
    if np.issubdtype(X.dtype, np.floating) or X.ndim != 2:
        raise ValueError("X must be a (P, N) integer array")
    y = asarray(y, dtype=default_dtype(), device=device)
    if y.ndim != 1:
        raise ValueError("y must be a vector")
    ws = np.ones(len(y)) if ws is None else np.asarray(to_numpy(ws))
    X = X.astype(np.int64)
    if shape is None:
        shape = [int(v) for v in X.max(axis=0) + 1]
    P, N = X.shape
    if x0 is None:
        from tntorch_tpu_torch.create import rand

        x0 = rand(shape, ranks_tt=ranks_tt, dtype=y.dtype, device=y.device, generator=generator)
    for dim in range(N):
        if len(np.unique(X[:, dim])) != x0.shape[dim]:
            raise ValueError("One groundtruth sample is needed for every tensor slice")

    if verbose:
        print("Completing a {}D tensor of size {} using {} samples...".format(N, list(shape), P))

    normy = float(torch.linalg.vector_norm(y))
    x0.orthogonalize(0)
    if x0.dtype != y.dtype or x0.device != y.device:
        x0.cores = [c.to(device=y.device, dtype=y.dtype) for c in x0.cores]
    # The orthogonalizers write x0.cores in place: `cores` stays x0's list
    cores = x0.cores
    segments = [_mode_segments(X, mu, x0.shape[mu], ws, y.device, y.dtype) for mu in range(N)]
    if mesh is not None:
        from tntorch_tpu_torch.parallel.mesh import (
            _all_reduce, _broadcast, _size, gather_rows, local_rows)

        axis = mesh.mesh_dim_names[0]
        shards = _size(mesh, axis)
        group = mesh.get_group(axis) if shards > 1 else None
        for n, c in enumerate(cores):
            cores[n] = _broadcast(c.detach().contiguous().clone(), mesh)

        def shard(seg):
            # empty slices (zero weight) pad the mode to a multiple of the axis size
            pad = (-seg.shape[0]) % shards
            return local_rows(torch.nn.functional.pad(seg, (0, 0, 0, pad)), mesh, axis)

        segments = [(shard(si), shard(sw)) for si, sw in segments]
    Xd = torch.from_numpy(X).to(y.device)

    lefts = [torch.ones((1, P, cores[n].shape[0]), dtype=y.dtype, device=y.device)
             for n in range(N)]
    rights = [None] * N
    rights[-1] = torch.ones((1, P, 1), dtype=y.dtype, device=y.device)
    for dim in range(N - 2, -1, -1):
        rights[dim] = torch.einsum("ijk,kjl->ijl", cores[dim + 1][:, Xd[:, dim + 1], :],
                                   rights[dim + 1])

    def optimize_core(mu, direction):
        # Columns ordered (r_left, r_right): the solution reshapes into the core
        seg_idx, seg_w = segments[mu]
        slices, sse = _als_solve_mode(lefts[mu][0], rights[mu][:, :, 0].T, y, seg_idx, seg_w)
        if mesh is not None:
            slices = gather_rows(slices, mesh, axis, seg_idx.shape[0] * shards)
        cores[mu] = slices[:x0.shape[mu]].permute(1, 0, 2)
        if direction == "right":
            x0.left_orthogonalize(mu)
            lefts[mu + 1] = torch.einsum("ijk,kjl->ijl", lefts[mu], cores[mu][:, Xd[:, mu], :])
        else:
            x0.right_orthogonalize(mu)
            rights[mu - 1] = torch.einsum("ijk,kjl->ijl", cores[mu][:, Xd[:, mu], :], rights[mu])
        return sse

    start = time.time()
    eps = float("inf")
    for swp in range(niter):
        for mu in range(N - 1):
            optimize_core(mu, "right")
        for mu in range(N - 1, 0, -1):
            sse = optimize_core(mu, "left")
        if mesh is not None and group is not None:
            sse = _all_reduce(sse.reshape(1).clone(), group)[0]
        eps = float(torch.sqrt(sse)) / normy  # the sweep's one read
        if verbose:
            print("iter: {: <{}}".format(swp, len("{}".format(niter)) + 1), end="")
            print("| eps: {:.3e}".format(eps), end="")
            print(" | time: {:8.4f}".format(time.time() - start))
    if _return_eps:
        return x0, eps
    return x0


def _sketch_omega(key: int, mode: int, ncols: int, k: int, dtype, device):
    """The (ncols, k) Gaussian test matrix of unfolding ``mode``'s sketch:
    drawn in float64 on the CPU from a generator seeded by (key, mode,
    ncols, k), then cast and moved, so the CPU and the card sketch alike.
    (The JAX package draws ``normal(fold_in(key, mode), (ncols, k))``.)"""
    seed = ((int(key) * 1_000_003 + mode) * 1_000_003 + ncols) * 1_000_003 + k
    g = torch.Generator().manual_seed(seed % (2 ** 63))
    return torch.randn((ncols, k), generator=g, dtype=torch.float64).to(device=device,
                                                                         dtype=dtype)


@policy_precision
def _sketch_range(rows, cols, ys, nrows, ncols, Om):
    """Randomized range finder on the COO unfolding D (nrows x ncols),
    never materialized (Halko-Martinsson-Tropp, one power iteration). Every
    product with D or D^T is a scatter-add over the entries:
    (D @ M)[r] += y_i * M[c_i]. Householder QR keeps a rank-deficient panel
    exact. Returns the ascending eigendecomposition of (Q^T D)(Q^T D)^T (the
    top-k squared singular values of D), Q (nrows x k), B^T = D^T Q (ncols x
    k), and ||y||^2."""
    k = Om.shape[1]
    contrib = ys[:, None]

    def scatter(n, idx, values):
        return torch.zeros((n, k), dtype=ys.dtype, device=ys.device).index_add_(0, idx, values)

    Y = scatter(nrows, rows, contrib * Om[cols])
    Z = torch.linalg.qr(scatter(ncols, cols, contrib * Y[rows])).Q
    Q = torch.linalg.qr(scatter(nrows, rows, contrib * Z[cols])).Q
    Bt = scatter(ncols, cols, contrib * Q[rows])
    w, vecs = torch.linalg.eigh(_sym(Bt.T @ Bt))
    return w, vecs, Q, Bt, torch.dot(ys, ys)


# Unfoldings taller than this take the sketched range finder instead of the
# dense scatter and its nrows x nrows Gram
_SPARSE_DENSE_ROWS_MAX = 8192
# The sketch's widest width; reaching it with energy left over warns
_SPARSE_SKETCH_MAX = 4096


@policy_precision
def sparse_tt_svd(X, y, eps, shape=None, rmax=None, key=None, device=None):
    """TT-SVD of sparse COO data (P coordinates X, values y; coordinates
    must be unique) to the relative error ``eps``.

    Per unfolding, on the device: the scatter into the dense (rows x unique
    columns) matrix D, its Gram, ``eigh`` and the projection onto the kept
    basis; the COO bookkeeping stays in host NumPy, and each mode reads its
    eigenvalues back once for the rank. Unfoldings of more than
    ``_SPARSE_DENSE_ROWS_MAX`` rows take the sketched range finder
    (`_sketch_range`, scatter-adds from the COO data; the sketch widens
    while the unseen energy exceeds the budget, up to
    ``_SPARSE_SKETCH_MAX``). Eigenvalues under the Gram's roundoff floor
    (32 eps(dtype) times the energy) are never kept as rank. ``key`` (an
    int, default 0) seeds the sketch (`_sketch_omega`). ``y`` is cast to
    `default_dtype`, as in the JAX package, and lands on ``device`` unless
    it is a torch tensor."""
    X = np.asarray(to_numpy(X))
    if np.issubdtype(X.dtype, np.floating) or X.ndim != 2:
        raise ValueError("X must be a (P, N) integer array")
    dtype = default_dtype()
    y = asarray(y, dtype=dtype, device=device)
    if y.ndim != 1:
        raise ValueError("y must be a vector")
    dev = y.device
    X = X.astype(np.int64)
    key = 0 if key is None else int(key)
    N = X.shape[1]
    if shape is None:
        shape = [int(v) for v in X.max(axis=0) + 1]
    shape = list(shape)
    if N != len(shape):
        raise ValueError(f"X has {N} columns for a shape of {len(shape)} modes")
    if rmax is None:
        rmax = np.iinfo(np.int32).max

    delta = eps / np.sqrt(max(N - 1, 1)) * float(torch.linalg.vector_norm(y))
    eps_dtype = float(torch.finfo(dtype).eps)

    def pick_rank(tail, rmax, n_eigs):
        # Keep the largest eigenvalues whose discarded ascending tail fits
        # the budget, with the dtype's noise floor
        budget = max(delta ** 2, 32.0 * eps_dtype * float(tail[-1]))
        where = np.where(tail <= budget)[0]
        if len(where) == 0:
            return max(1, int(min(rmax, n_eigs)))
        return max(1, int(min(rmax, n_eigs - 1 - where[-1])))

    def truncate(Xs, ys, nrows, mode):
        u, v = np.unique(Xs[:, 1:], axis=0, return_inverse=True)
        v = v.reshape(-1)
        if nrows <= _SPARSE_DENSE_ROWS_MAX:
            D = torch.zeros((nrows, len(u)), dtype=dtype, device=dev)
            D[torch.from_numpy(Xs[:, 0]).to(dev), torch.from_numpy(v).to(dev)] = ys
            w, vecs = torch.linalg.eigh(_sym(D @ D.T))  # ascending; w == sigma^2
            tail = torch.cumsum(w.clamp(min=0), 0).cpu().numpy()  # the mode's read
            rank = pick_rank(tail, rmax, len(tail))
            left = vecs.flip(-1)[:, :rank]
            FD = left.T @ D  # rank x len(u)
        else:
            # Sketched: dedupe (row, col) pairs first (the scatter-adds would sum them)
            ncols = len(u)
            keep = np.unique(Xs[:, 0] * ncols + v, return_index=True)[1]
            rows_d = torch.from_numpy(Xs[keep, 0]).to(dev)
            cols_d = torch.from_numpy(v[keep]).to(dev)
            ys_d = ys[torch.from_numpy(keep).to(dev)]
            cap = min(nrows, ncols, _SPARSE_SKETCH_MAX)
            target = rmax if rmax <= cap else 256
            k = int(min(cap, max(32, 2 * target)))
            while True:
                Om = _sketch_omega(key, mode, ncols, k, dtype, dev)
                w, vecs, Q, Bt, energy = _sketch_range(rows_d, cols_d, ys_d, nrows, ncols, Om)
                w_np = w.clamp(min=0).cpu().numpy()
                tail, energy = np.cumsum(w_np), float(energy)
                resid = max(0.0, energy - float(tail[-1]))  # the unseen spectrum
                tail = tail + resid
                rank = pick_rank(tail, min(rmax, k), k)
                noise_floor = 32.0 * eps_dtype * energy
                budget = max(delta ** 2, noise_floor)
                if resid <= budget or k >= min(cap, rmax):
                    break
                # Widen: each extra column absorbs at most ~the smallest
                # captured eigenvalue, so `need` bounds the width from below;
                # past half the cap, go to the cap at once
                lam_small = float(np.median(w_np[:max(1, k // 8)]))
                need = k + int(np.ceil((resid - budget) / lam_small)) if lam_small > 0 else cap
                if need >= cap // 2:
                    k = int(cap)
                else:
                    k_next = 2 * k
                    while k_next < need:
                        k_next *= 2
                    k = int(min(cap, k_next))
            if resid > max(delta ** 2, noise_floor) and rmax > k:
                logger.warning(
                    "sparse_tt_svd: sketched unfolding (%d rows) could not reach eps within "
                    "the k=%d sketch cap (left-over energy %.3e > budget %.3e); result is the "
                    "best rank-%d sketch", nrows, k, np.sqrt(resid), delta, rank)
            sel = vecs.flip(-1)[:, :rank]
            left = Q @ sel  # nrows x rank
            FD = sel.T @ Bt.T  # rank x len(u) == left^T D
        # Host: the COO bookkeeping of the merged tensor
        idx = np.unique(v, return_index=True)[1]
        new_row = np.remainder(np.arange(rank * len(u)), rank)
        newcols = np.repeat(Xs[idx, 1:][:, None, :], rank, axis=1).reshape(len(idx) * rank, -1)
        newX = np.concatenate([new_row[:, None], newcols], axis=1)
        return left, newX, FD.T.reshape(-1)

    cores = []
    curshape = shape.copy()
    for n in range(1, N):
        left, X, y = truncate(X, y, curshape[0], mode=n)
        cores.append(left.reshape(left.shape[0] // shape[n - 1], shape[n - 1], left.shape[1]))
        curshape[0] = left.shape[1]
        if n < N - 1:  # merge the first two indices (a sparse reshape)
            X = np.concatenate([X[:, 0:1] * curshape[1] + X[:, 1:2], X[:, 2:]], axis=1)
            curshape[1] *= curshape[0]
            curshape = curshape[1:]
    last = torch.zeros(tuple(curshape), dtype=dtype, device=dev)
    last[tuple(torch.from_numpy(c).to(dev) for c in X.T)] = y
    cores.append(last[:, :, None])
    return Tensor([c.to(dtype) for c in cores])


def get_bounding_box(X):
    """The bounding box of a point set: a (min, max) pair per column."""
    X = np.asarray(to_numpy(X))
    flat = X.reshape(-1, X.shape[-1])
    return [(float(lo), float(hi)) for lo, hi in zip(flat.min(0), flat.max(0))]


def features2indices(X, bbox=None, I=512, domain=None, device=None):
    """Continuous features to grid indices: onto ``I`` ticks of the
    bounding box ``bbox`` (default: the data's), or to the nearest point of
    each axis of ``domain``. An int64 tensor on ``device``."""
    X = np.asarray(to_numpy(X), dtype=np.float64)
    if domain is not None:
        out = np.zeros_like(X)
        for n in range(X.shape[1]):
            dn = np.asarray(to_numpy(domain[n]))
            out[:, n] = np.interp(X[:, n], dn, np.arange(len(dn)))
        return asarray(np.round(out).astype(np.int64), device=device)
    if bbox is None:
        bbox = get_bounding_box(X)
    if len(bbox) != X.shape[-1]:
        raise ValueError(f"bbox has {len(bbox)} axes for {X.shape[-1]} features")
    bbox = np.asarray(bbox, dtype=np.float64)
    X = (X - bbox[:, 0]) / (bbox[:, 1] - bbox[:, 0])
    X = np.clip(np.round(X * (I - 1)).astype(np.int64), 0, I - 1)
    return asarray(X, device=device)


discretize = features2indices


def indices2features(X, bbox=None, I=512, domain=None, device=None):
    """Grid indices to cell-centred features (on ``I`` ticks of ``bbox``,
    or the points of ``domain``), in `default_dtype` on ``device``."""
    X = np.asarray(to_numpy(X))
    if np.issubdtype(X.dtype, np.floating) or X.ndim != 2:
        raise ValueError("X must be a (P, N) integer array")
    if domain is None:
        domain = [np.linspace(b[0] + (b[1] - b[0]) / (2 * I), b[1] - (b[1] - b[0]) / (2 * I), I)
                  for b in bbox]
    result = np.zeros(X.shape)
    for n in range(X.shape[1]):
        result[:, n] = np.asarray(to_numpy(domain[n]))[X[:, n]]
    return asarray(result, dtype=default_dtype(), device=device)


def empirical_marginals(X, domain, device=None):
    """The discrete marginal distribution of a sample set on each axis of
    the grid ``domain``: one vector per axis, in `default_dtype` on
    ``device``."""
    X = np.asarray(to_numpy(X))
    if X.ndim != 2 or X.shape[1] != len(domain):
        raise ValueError(f"X must be (P, {len(domain)})")
    P, N = X.shape
    X_discrete = to_numpy(features2indices(X, domain=domain, device="cpu"))
    result = [np.zeros(len(domain[n])) for n in range(N)]
    for n in range(N):
        unique, counts = np.unique(X_discrete[:, n], return_counts=True)
        result[n][unique] = counts.astype(np.float64) / P
    return [asarray(r, dtype=default_dtype(), device=device) for r in result]


def gram_schmidt(x, S, device=None):
    """The coefficients (S x S) of the polynomials of degree < S that are
    orthonormal under the empirical measure of the samples ``x``
    (Witteveen & Bijl 2012)."""
    x = asarray(x, device=device)
    if x.ndim != 1:
        raise ValueError("x must be a vector")
    xpowers = x[:, None] ** torch.arange(S, device=x.device)[None, :]

    def proj(u, v):
        xu, xv = xpowers @ u, xpowers @ v
        return torch.mean(xu * xv) / torch.mean(xu * xu) * u

    def norm(u):
        xu = xpowers @ u
        return torch.sqrt(torch.mean(xu * xu))

    Psi = torch.eye(S, dtype=x.dtype, device=x.device)
    for s in range(1, S):
        u = Psi[:, s]
        for k in range(s):
            u = u - proj(Psi[:, k], u)
        Psi[:, s] = u / norm(u)
    return Psi


@policy_precision
def _lars_path_kernel(G, b, maxK: int):
    """The LARS active-set loop (covariance form) on the device: maxK
    masked steps, each admitting the most correlated inactive feature,
    extending the Cholesky factor of the signed active Gram (kept in a
    padded (maxK, maxK) buffer whose unused rows are identity rows, so the
    padded triangular solves are exact), and stepping along the
    equiangular direction by the least candidate step (Efron et al. 2004,
    eq. 2.13). A ``done`` flag freezes the state once the correlations
    vanish; nothing is read back inside the loop.

    :return: (path (M, maxK+1), the number of steps taken, on the device)
    """
    M = G.shape[0]
    dtype, dev = G.dtype, G.device
    tiny = 1e-12 if dtype == torch.float64 else 1e-6
    slots = torch.arange(maxK, device=dev)
    feats = torch.arange(M, device=dev)
    L = torch.eye(maxK, dtype=dtype, device=dev)
    act_idx = torch.zeros(maxK, dtype=torch.int64, device=dev)
    s_act = torch.zeros(maxK, dtype=dtype, device=dev)
    act_mask = torch.zeros(M, dtype=torch.bool, device=dev)
    coef = torch.zeros(M, dtype=dtype, device=dev)
    path = torch.zeros((M, maxK + 1), dtype=dtype, device=dev)
    nsteps = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    c = b.clone()
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for k in range(maxK):
        C = c.abs().max()
        step_done = done | (C < tiny)

        # 1. admit the most correlated inactive feature (one-element
        # indices: a 0-d device index would be read back)
        j = torch.where(act_mask, -inf, c.abs()).argmax().reshape(1)
        sj = torch.where(c.index_select(0, j) < 0, -1.0, 1.0).to(dtype)
        Gj = G.index_select(0, j)[0]  # row j

        # 2. extend the Cholesky factor with the signed Gram row of j
        in_prev = slots < k
        g_row = torch.where(in_prev, sj * s_act * Gj[act_idx], zero)
        w_ = torch.linalg.solve_triangular(L, g_row[:, None], upper=False)[:, 0]
        # pivot clamp relative to the column's scale: an exactly dependent
        # column takes a ridge-like step, not a 1/sqrt(tiny) one
        Gjj = Gj.index_select(0, j)[0]
        ljj = torch.sqrt(torch.maximum(Gjj - w_ @ w_, tiny * Gjj + tiny))
        new_row = torch.where(slots == k, ljj, torch.where(in_prev, w_, zero))
        L_new = L.clone()
        L_new[k] = new_row
        L = torch.where(step_done, L, L_new)
        keep = step_done | (slots != k)
        act_idx = torch.where(keep, act_idx, j)
        s_act = torch.where(keep, s_act, sj)
        act_mask = torch.where(step_done, act_mask, act_mask | (feats == j))

        # 3. the equiangular direction: (L L^T) w = 1 over the filled slots
        in_cur = slots <= k
        ones_k = in_cur.to(dtype)
        z = torch.linalg.solve_triangular(L, ones_k[:, None], upper=False)
        w = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
        AA = 1.0 / torch.sqrt(torch.clamp(w.sum(), min=tiny))
        w = AA * w

        # 4. a = X^T u, without forming u
        a = (G[:, act_idx] * torch.where(in_cur, s_act, zero)[None, :]) @ w

        # 5. the step: the least positive candidate over the inactive features
        g1 = (C - c) / (AA - a)
        g2 = (C + c) / (AA + a)
        valid1 = ~act_mask & torch.isfinite(g1) & (g1 > tiny)
        valid2 = ~act_mask & torch.isfinite(g2) & (g2 > tiny)
        cand = torch.minimum(torch.where(valid1, g1, inf).min(), torch.where(valid2, g2, inf).min())
        full_step = C / AA  # the exact least-squares step
        use_cand = torch.isfinite(cand) & (k + 1 < maxK)
        gamma = torch.minimum(torch.where(use_cand, cand, full_step), full_step)

        # 6. coefficients (over the active slots) and correlations
        upd = torch.where(in_cur & ~step_done, gamma * s_act * w, zero)
        coef = coef.index_add(0, act_idx, upd)
        c = torch.where(step_done, c, c - gamma * a)
        path[:, k + 1] = coef
        nsteps = torch.where(step_done, nsteps, k + 1)
        done = step_done
    return path, nsteps


@policy_precision
def _normal_equations(X, y, dtype):
    """X^T X and X^T y, cast to ``dtype``."""
    return (X.T @ X).to(dtype), (X.T @ y).to(dtype)


def lars_path(X, y, max_nonzero: Optional[int] = None, device=None):
    """Least Angle Regression (Efron et al. 2004): the whole coefficient
    path, an (M x K) float64 NumPy array whose column k has k active
    coefficients (the last ones repeat once the correlations vanish).

    The Gram X^T X and X^T y are products on the device, and the active-set
    loop runs there (`_lars_path_kernel`) with one read at the end, of the
    step count. `_lars_path_host` is the NumPy oracle.

    :param X: design matrix (P x M), columns assumed non-degenerate
    :param max_nonzero: stop after this many active features (default
        min(P, M))
    """
    Xd = asarray(X, device=device).detach()
    yd = asarray(y, dtype=Xd.dtype, device=Xd.device).detach()
    P, M = Xd.shape
    G, b = _normal_equations(Xd, yd, torch.promote_types(Xd.dtype, default_dtype()))
    if max_nonzero is None:
        max_nonzero = min(P, M)
    maxK = min(max_nonzero, min(P, M))
    if maxK <= 0:
        return np.zeros((M, 1))
    path, nsteps = _lars_path_kernel(G, b, maxK)
    return path[:, :int(nsteps) + 1].cpu().numpy().astype(np.float64)


def _lars_path_host(X, y, max_nonzero: Optional[int] = None):
    """Host NumPy LARS in float64 (the covariance form, a Python loop): the
    oracle of `_lars_path_kernel`."""
    Xd = np.asarray(to_numpy(X), dtype=np.float64)
    yd = np.asarray(to_numpy(y), dtype=np.float64)
    P, M = Xd.shape
    G_full = Xd.T @ Xd
    b = Xd.T @ yd
    if max_nonzero is None:
        max_nonzero = min(P, M)
    max_nonzero = min(max_nonzero, min(P, M))

    coef = np.zeros(M)
    path = [coef.copy()]
    active: list = []
    c = b.copy()  # the correlations X^T (y - X coef)
    tiny = 1e-12
    while len(active) < max_nonzero:
        C = np.abs(c).max()
        if C < tiny:
            break
        inactive = np.setdiff1d(np.arange(M), active)
        j = inactive[np.argmax(np.abs(c[inactive]))]
        active.append(int(j))
        s = np.sign(c[active])
        G = G_full[np.ix_(active, active)] * np.outer(s, s)
        try:
            w = np.linalg.solve(G, np.ones(len(active)))
        except np.linalg.LinAlgError:
            w = np.linalg.lstsq(G, np.ones(len(active)), rcond=None)[0]
        AA = 1.0 / np.sqrt(max(np.sum(w), tiny))
        w = AA * w
        a = (G_full[:, active] * s[None, :]) @ w
        if len(active) < M and len(active) < max_nonzero:
            ina = np.setdiff1d(np.arange(M), active)
            with np.errstate(divide="ignore", invalid="ignore"):
                g1 = (C - c[ina]) / (AA - a[ina])
                g2 = (C + c[ina]) / (AA + a[ina])
            candidates = np.concatenate([g1, g2])
            candidates = candidates[np.isfinite(candidates) & (candidates > tiny)]
            gamma = candidates.min() if len(candidates) else C / AA
            gamma = min(gamma, C / AA)
        else:
            gamma = C / AA
        coef[active] += gamma * s * w
        c = c - gamma * a
        path.append(coef.copy())
    return np.stack(path, axis=1)  # M x K


class PCEInterpolator:
    """Polynomial chaos expansion surrogate with hyperbolic truncation and
    LARS coefficient selection (Torre et al. 2020), on `lars_path`. Data
    without a device lands on ``device`` (default: `default_device`)."""

    def __init__(self, device=None):
        self.device = device

    @policy_precision
    def _design_matrix(self, x):
        N = len(self.Psis)
        S = self.Psis[0].shape[0]
        powers = torch.arange(S, device=x.device)[None, :]
        M = torch.stack([(x[:, n:n + 1] ** powers) @ self.Psis[n] for n in range(N)], dim=1)
        modes = torch.arange(N, device=x.device).repeat(len(self.coords))
        degrees = torch.from_numpy(np.asarray(self.coords).reshape(-1)).to(x.device)
        M = M[:, modes, degrees].reshape(-1, self.coords.shape[0], self.coords.shape[1])
        return torch.prod(M, dim=2)

    def fit(self, X, y, p=5, q=0.75, val_split=0.1, seed=0, matrix_size_limit=5e7,
            retrain=True, verbose=True):
        """Fit by hyperbolic truncation and LARS, choosing the number of
        terms on a validation split of ``val_split`` of the rows (drawn
        from NumPy's ``default_rng(seed)``)."""
        X = asarray(X, dtype=default_dtype(), device=self.device)
        y = asarray(y, dtype=default_dtype(), device=X.device)
        if X.ndim != 2 or y.ndim != 1 or y.shape[0] != X.shape[0]:
            raise ValueError("fit takes X (P, N) and y (P,)")
        if not 0 <= q <= 1:
            raise ValueError("q must lie in [0, 1]")
        P, N = X.shape

        self.bbox = get_bounding_box(X)
        self.X_mean = X.mean(0)
        self.X_std = X.std(0, correction=1)
        X = (X - self.X_mean[None, :]) / self.X_std[None, :]

        n_val = int(P * val_split)
        rng = np.random.default_rng(seed=seed)
        idx_val = rng.choice(P, n_val, replace=False)  # a split must not repeat rows
        idx_train = np.delete(np.arange(P), idx_val)
        idx_val, idx_train = (torch.from_numpy(i).to(X.device) for i in (idx_val, idx_train))
        y_train, y_val = y[idx_train], y[idx_val]

        if verbose:
            start = time.time()
            print("PCE interpolation (p={}, q={}) of {} points ({} train + {} val) in {}D"
                  .format(p, q, P, P - n_val, n_val, N))
            print("{:.3f}s | ".format(time.time() - start), end="")
            print("Hyperbolic truncation...", end="")

        idx = np.zeros(N, dtype=np.int64)

        def find_candidates(p, q):
            # Walk the coefficient hypercube: hyperbolic truncation keeps a
            # contiguous region, so the walk is cheap
            S = int(np.ceil(p))
            coords = []
            while True:
                pos = N - 1
                while pos >= 0 and (max(idx) >= S
                                    or np.sum(idx.astype(np.float64) ** q) >= p ** q):
                    idx[pos] = 0
                    idx[pos - 1] += 1
                    pos -= 1
                if pos < 0:
                    break
                coords.append(idx.copy())
                idx[-1] += 1
                if len(coords) * P > matrix_size_limit:
                    raise ValueError(
                        "Design matrix exceeds matrix_size_limit ({:g} elements). "
                        "Decrease p or q, or increase matrix_size_limit".format(matrix_size_limit))
            return np.array(coords, dtype=np.int64)

        self.coords = find_candidates(p, q)
        S = int(np.ceil(p))

        if verbose:
            print(" done, we kept {} / {} candidates".format(len(self.coords), S ** N))
            print("{:.3f}s | ".format(time.time() - start), end="")
            print("Assembling a {} X {} design matrix...".format(P, len(self.coords)), end="",
                  flush=True)

        self.Psis = [gram_schmidt(X[:, n], S) for n in range(N)]
        M = self._design_matrix(X)
        M_train, M_val = M[idx_train], M[idx_val]

        if verbose:
            print(" done")
            print("{:.3f}s | ".format(time.time() - start), end="")
            print("Finding best nnz in LARS...", end="", flush=True)

        coef_path = lars_path(M_train, y_train)  # M x K
        reco_path = to_numpy(M_val) @ coef_path
        error_path = np.sqrt(np.sum((reco_path - to_numpy(y_val)[:, None]) ** 2, axis=0)) / max(
            float(torch.linalg.vector_norm(y_val)), 1e-300)
        argmin = int(np.argmin(error_path))
        nnz = len(np.where(coef_path[:, argmin])[0])

        if verbose:
            print(" done, val eps={:.5g}".format(error_path[argmin]))
            print("{:.3f}s | ".format(time.time() - start), end="")

        if retrain:
            if verbose:
                print("Retraining at nnz={}...".format(nnz), end="", flush=True)
            coef_ = lars_path(M, y, max_nonzero=nnz)[:, -1]
            nonzeros = np.where(coef_)[0]
            self.allcoords = self.coords
            self.allcoef = asarray(coef_, dtype=default_dtype(), device=X.device)
            self.coef = asarray(coef_[nonzeros], dtype=default_dtype(), device=X.device)
            self.coords = self.coords[nonzeros, :]
            if verbose:
                reco = M[:, torch.from_numpy(nonzeros).to(X.device)] @ self.coef
                print(" done, training eps={:.5g}".format(
                    float(torch.linalg.vector_norm(y - reco) / torch.linalg.vector_norm(y))))
                print("{:.3f}s".format(time.time() - start), flush=True)
                print()
        else:
            nonzeros = np.where(coef_path[:, argmin])[0]
            self.coef = asarray(coef_path[nonzeros, argmin], dtype=default_dtype(),
                                device=X.device)
            self.coords = self.coords[nonzeros, :]
            if verbose:
                print()

    def predict(self, X):
        """The surrogate at new inputs (P x N): a (P,) tensor."""
        X = asarray(X, dtype=default_dtype(), device=self.X_mean.device)
        return self._design_matrix((X - self.X_mean[None, :]) / self.X_std[None, :]) @ self.coef

    @policy_precision
    def to_tensor(self, domain=512, rmax=200, eps=1e-3, verbose=True):
        """The surrogate as a TT-Tucker tensor on a grid (``domain`` points
        per axis of the bounding box, or the given axes): a sparse TT-SVD
        of the coefficients, with the polynomial bases as Tucker
        factors."""
        N = len(self.Psis)
        S = self.Psis[0].shape[0]
        dev = self.X_mean.device
        if not isinstance(domain, (list, tuple)):
            domain = [torch.linspace(b[0] + (b[1] - b[0]) / (2 * domain),
                                     b[1] - (b[1] - b[0]) / (2 * domain), domain,
                                     dtype=default_dtype(), device=dev) for b in self.bbox]
        if len(domain) != N:
            raise ValueError(f"domain has {len(domain)} axes for {N} features")
        centred = [(asarray(domain[n], device=dev) - self.X_mean[n]) / self.X_std[n]
                   for n in range(N)]

        if verbose:
            start = time.time()
            print("Conversion to TT-Tucker format (rmax={}, eps={:.5g})".format(rmax, eps))
            print("{:.3f}s | ".format(time.time() - start), end="")
            print("Sparse TT-SVD...", end="", flush=True)

        t = sparse_tt_svd(self.coords, self.coef, rmax=rmax, eps=eps)

        if verbose:
            err = (torch.linalg.vector_norm(t[self.coords].full() - self.coef)
                   / torch.linalg.vector_norm(self.coef))
            print(" done, rmax={}, eps={:.5g}".format(max(t.ranks_tt), float(err)))

        powers = torch.arange(S, device=dev)
        t.Us = [(centred[n][:, None] ** powers).to(default_dtype()) @ self.Psis[n][:, :t.shape[n]]
                for n in range(N)]

        if verbose:
            print("{:.3f}s".format(time.time() - start), flush=True)
            print()
        return t
