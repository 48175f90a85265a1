"""The NumPy host sweep of TT-cross, ``cross(fuse="host")``.

Counterpart of ``tntorch_tpu/cross_host.py``. For a host-locked function
(a NumPy or Python callable) the whole sweep runs in NumPy, SciPy and BLAS
next to it, and the card sees two transfers: the input cores come down in
one read (`download_cores`) and the result cores go up in one copy
(`upload_cores`).

- fiber evaluation is a NumPy einsum over the interface chains;
- orthogonalization is a Gram-eigh basis in float64 (`_gram_orth_q`): one
  syrk, a small eigh and one GEMM, robust to the rank deficiency smooth
  functions produce;
- pivoting is the host `maxvol.maxvol`, the JAX package's hybrid: C =
  Q inv(Q[rows]) by BLAS, then the C++ swap loop of the host library
  (``csrc/maxvol_host.cpp``). C is the interpolation core itself (A = QR
  gives A inv(A[rows]) = Q inv(Q[rows])), so no separate solve is needed.

The rank schedule, the random stream, the validation error, the info dict
and the error messages are the eager sweep's (`cross.cross`). The inputs
enter as TT cores (`Tensor.tt`), so the JAX package's CP branches have no
counterpart here.
"""

from __future__ import annotations

import sys
import time
import warnings

import numpy as np
import scipy.linalg
import torch

from tntorch_tpu_torch.maxvol import _initial_pivots
from tntorch_tpu_torch.maxvol import maxvol as _host_maxvol
from tntorch_tpu_torch.utils import default_device


def _np_fibers(lint, core, rint):
    """(Rl x I x Rr) fiber values of one TT core, flattened."""
    return np.einsum("ai,ibj,jc->abc", lint, core, rint, optimize=True).reshape(-1)


def _np_rchain(cores_tail, idx):
    """Right interface chain: the cores j+1..N-1 contracted at the index
    rows ``idx``."""
    M = np.ones((cores_tail[-1].shape[-1], idx.shape[0]), dtype=cores_tail[-1].dtype)
    for n in range(len(cores_tail) - 1, -1, -1):
        M = np.einsum("iaj,ja->ia", cores_tail[n][:, idx[:, n], :], M)
    return M


def _np_init_interfaces(tensors_np, rsets, N):
    """Left and right interface chains of each input tensor (the host
    mirror of `cross.init_interfaces`)."""
    t_lint, t_rint = [], []
    for cores in tensors_np:
        dtype = cores[0].dtype
        lint = [np.ones((1, cores[0].shape[0]), dtype=dtype)] + [None] * (N - 1)
        rint = [None] * (N - 1) + [np.ones((cores[-1].shape[-1], 1), dtype=dtype)]
        for j in range(N - 1):
            rint[j] = _np_rchain(cores[j + 1:], np.asarray(rsets[j])[:, : N - 1 - j])
        t_lint.append(lint)
        t_rint.append(rint)
    return t_lint, t_rint


def _np_tt_forward(cores, X):
    """TT values at the integer points X (P x N). A core with Rl Rr > 16 is
    gathered through an (I, Rl, Rr) copy, so that each lookup reads one
    contiguous block."""
    v = np.ones((X.shape[0], cores[0].shape[0]), dtype=cores[0].dtype)
    for n, c in enumerate(cores):
        if c.shape[0] * c.shape[2] > 16:
            ct = np.ascontiguousarray(c.transpose(1, 0, 2))
            v = np.einsum("br,brs->bs", v, ct[X[:, n]], optimize=True)
        else:
            v = np.einsum("br,rbs->bs", v, c[:, X[:, n], :], optimize=True)
    return v[:, 0]


def download_cores(tensors):
    """Every input tensor's cores as NumPy arrays, with one read from their
    device: the flattened cores are concatenated there first (cores of
    mixed dtypes are read one by one)."""
    allc = [c.detach() for t in tensors for c in t.cores]
    if len({c.dtype for c in allc}) == 1:
        flat = torch.cat([c.reshape(-1) for c in allc]).cpu().numpy()
        parts = np.split(flat, np.cumsum([c.numel() for c in allc])[:-1])
        host = [p.reshape(tuple(c.shape)) for p, c in zip(parts, allc)]
    else:
        host = [c.cpu().numpy() for c in allc]
    out, k = [], 0
    for t in tensors:
        out.append(host[k:k + t.dim()])
        k += t.dim()
    return out


def upload_cores(cores_np, device=None):
    """The host sweep's cores as torch tensors on ``device`` (default: the
    card), with one copy: the flattened cores are concatenated on the host,
    moved, and viewed there."""
    flat = torch.from_numpy(np.concatenate([np.ravel(c) for c in cores_np]))
    flat = flat.to(device or default_device())
    out, off = [], 0
    for c in cores_np:
        out.append(flat[off:off + c.size].view(c.shape))
        off += c.size
    return out


_completion_cache = {}  # (m, d, dtype) -> cached unit-norm random block


def _completion_block(m, d, dtype):
    """A deterministic pseudo-random (m, d) block of unit columns for
    completing a rank-deficient basis, cached per shape: the same shapes
    recur every iteration, and the draw would dominate the completion."""
    key = (m, d, np.dtype(dtype).str)
    blk = _completion_cache.get(key)
    if blk is None:
        rng = np.random.default_rng(m * 1000003 + d)
        blk = rng.standard_normal((m, d)).astype(dtype)
        blk /= np.sqrt(np.einsum("ij,ij->j", blk, blk))
        if len(_completion_cache) > 8:
            _completion_cache.clear()
        _completion_cache[key] = blk
    return blk.copy()


def _gram_orth_q(V):
    """A well-conditioned column basis Q = V W of the tall V, from the
    eigendecomposition of its Gram in float64, and the count of its
    significant columns.

    The Gram squares the condition number, so it is formed and factored in
    float64; the basis GEMM runs in V's dtype. Any invertible W leaves the
    interpolation core exact (Q inv(Q[rows]) = V inv(V[rows])), so the
    choice affects only the pivots' conditioning. Directions below the work
    dtype's Gram noise floor (duplicated fiber columns, or roundoff) are
    replaced by a deterministic random completion orthogonal to the live
    columns, as a Householder QR would complete them. The columns come in
    ascending eigenvalue order."""
    m, k = V.shape
    Vd = V.astype(np.float64, copy=False)
    G = Vd.T @ Vd
    try:
        lam, U = scipy.linalg.eigh(G, check_finite=False)
    except scipy.linalg.LinAlgError:
        Qf = scipy.linalg.qr(V, mode="economic", check_finite=False)[0]
        return Qf, Qf.shape[1]
    lmax = float(lam[-1]) if lam[-1] > 0 else 1.0
    s = 1.0 / np.sqrt(np.maximum(lam, lmax * 1e-30) + np.finfo(np.float64).tiny)
    Q = V @ (U * s).astype(V.dtype)
    cn = np.sqrt(np.einsum("ij,ij->j", Q, Q))
    Q /= np.maximum(cn, np.finfo(V.dtype).eps).astype(V.dtype)
    eps_d = float(np.finfo(V.dtype).eps)
    k0 = max(int(np.sum(lam > lmax * (16.0 * eps_d) ** 2)), 1)
    if k0 < k:
        R = _completion_block(m, k - k0, V.dtype)
        Ql = Q[:, k - k0:]
        R = R - Ql @ (Ql.T @ R)  # keep the completion out of the live span
        R = R / np.maximum(np.sqrt(np.einsum("ij,ij->j", R, R)), np.finfo(V.dtype).eps)
        Q[:, : k - k0] = R
    return Q, k0


def _orth_and_pivot(M):
    """Quasi-maxvol rows ``lj`` of the tall M and its interpolation core
    ``Q inv(Q[lj])`` (= M inv(M[lj])).

    maxvol's swap loop runs over the significant columns of the basis only,
    when they are at most 0.6 of them; the roundoff columns take LU pivots
    among the rows of largest norm that are not chosen yet (four times
    their count), and the core is solved on the combined rows."""
    m, k = M.shape
    if m <= k:
        return np.arange(m, dtype=np.int64), np.eye(m, dtype=M.dtype)
    Q, k0 = _gram_orth_q(M)
    if k0 >= k or k0 > 0.6 * k:
        return _host_maxvol(Q, 1.05, 100)
    sig = np.ascontiguousarray(Q[:, k - k0:])
    lj_sig, _ = _host_maxvol(sig, 1.05, 100)
    # The zeroed copy steers only the pivots' choice; the core uses Q's rows
    noise_masked = Q[:, : k - k0].copy()
    noise_masked[lj_sig] = 0.0
    d = k - k0
    ncand = min(m, max(4 * d, d + 8))
    rn = np.einsum("ij,ij->i", noise_masked, noise_masked)
    cand = np.argpartition(rn, -ncand)[-ncand:]
    lj_noise = cand[_initial_pivots(noise_masked[cand], ncand)[:d]]
    lj = np.concatenate([np.asarray(lj_sig, dtype=np.int64), np.asarray(lj_noise, dtype=np.int64)])
    # C's columns follow the rows' order in lj, which the index sets record
    Qperm = np.concatenate([sig, Q[:, : k - k0]], axis=1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
            C = Qperm @ scipy.linalg.inv(Qperm[lj], check_finite=False)
        if not np.all(np.isfinite(C)):
            raise scipy.linalg.LinAlgError("non-finite interpolation core")
    except scipy.linalg.LinAlgError:
        lj, C = _host_maxvol(Q, 1.05, 100)
    return lj, C


def host_sweep(f, tensors_np, Is, Rs, lsets, rsets, X_val, kickrank, rmax, eps, max_iter,
               verbose, record_samples, info, function, grow_schedule, draw_extra, start):
    """The whole cross sweep on the host: the eager sweep's loop (`cross.cross`)
    with NumPy arrays. ``f`` takes one NumPy vector per input tensor;
    ``grow_schedule``/``draw_extra`` are the rank increase and its draw of
    new rows, shared with the eager sweep so that the random stream stays
    in step. Updates ``info`` (``nsamples``, ``eval_time``, ``val_epss``,
    and the samples with ``record_samples``) and returns (cores, lsets,
    rsets, left_locals, Rs, val_eps)."""
    N = len(Is)
    dtype = tensors_np[0][0].dtype
    lsets = [np.asarray(l) for l in lsets[:1]] + [None] * (N - 1)
    rsets = [np.asarray(r) for r in rsets]

    def call(Xs):
        t0 = time.time()
        ev = np.asarray(f(*Xs))
        info["eval_time"] += time.time() - t0
        return ev[:, 0] if ev.ndim == 2 else ev

    ys_val = call([_np_tt_forward(cores, X_val) for cores in tensors_np])
    norm_ys_val = float(np.linalg.norm(ys_val))

    t_lint, t_rint = _np_init_interfaces(tensors_np, rsets, N)
    cores = [None] * N
    left_locals = []
    recorded = []

    def evaluate(j):
        Xs = [_np_fibers(t_lint[k][j], cores_k[j], t_rint[k][j])
              for k, cores_k in enumerate(tensors_np)]
        ev = call(Xs)
        bad = ~np.isfinite(ev)
        if bad.any():
            p = int(np.flatnonzero(bad)[0])
            raise ValueError("Invalid return value for function {}: f({}) = {}".format(
                function, ", ".join("{:g}".format(float(x[p])) for x in Xs), float(ev[p])))
        if record_samples:
            recorded.append((Xs, ev))
        info["nsamples"] += ev.size
        return np.ascontiguousarray(ev.astype(dtype, copy=False))

    val_eps = np.inf
    for i in range(max_iter):
        if verbose:
            print("iter: {: <{}}".format(i, len("{}".format(max_iter)) + 1), end="")
            sys.stdout.flush()
        left_locals = []

        # Left to right
        for j in range(N - 1):
            lj, core = _orth_and_pivot(evaluate(j).reshape(-1, Rs[j + 1]))
            cores[j] = core.reshape(Rs[j], Is[j], Rs[j + 1])
            left_locals.append(lj)
            lr, li = lj // Is[j], lj % Is[j]
            lsets[j + 1] = np.concatenate([lsets[j][lr], li[:, None].astype(lsets[j].dtype)],
                                          axis=1)
            for k, cores_k in enumerate(tensors_np):
                t_lint[k][j + 1] = np.einsum("ai,iaj->aj", t_lint[k][j][lr, :],
                                             cores_k[j][:, li, :], optimize=True)

        # Right to left
        for j in range(N - 1, 0, -1):
            lj, core = _orth_and_pivot(np.ascontiguousarray(evaluate(j).reshape(Rs[j], -1).T))
            cores[j] = core.T.reshape(Rs[j], Is[j], Rs[j + 1])
            li, lr = lj // Rs[j + 1], lj % Rs[j + 1]
            rsets[j - 1] = np.concatenate([li[:, None].astype(rsets[j].dtype), rsets[j][lr]],
                                          axis=1)
            for k, cores_k in enumerate(tensors_np):
                t_rint[k][j - 1] = np.einsum("iaj,ja->ia", cores_k[j][:, li, :],
                                             t_rint[k][j][:, lr], optimize=True)

        # Leave the first core ready
        cores[0] = evaluate(0).reshape(Rs[0], Is[0], Rs[1])

        val_eps = float(np.linalg.norm(ys_val - _np_tt_forward(cores, X_val)) / norm_ys_val)
        info["val_epss"].append(val_eps)
        converged = val_eps < eps
        if verbose:
            print("| eps: {:.3e}".format(val_eps), end="")
            print(" | time: {:8.4f} | largest rank: {:3d}".format(time.time() - start,
                                                                 int(max(Rs))), end="")
            if converged:
                print(" <- converged: eps < {}".format(eps))
            elif i == max_iter - 1:
                print(" <- max_iter was reached: {}".format(max_iter))
            else:
                print()
        if converged:
            break
        elif i < max_iter - 1 and kickrank is not None:  # grow ranks
            newRs = grow_schedule(Rs)
            extra = draw_extra(newRs)
            for n in range(N - 1):
                if newRs[n + 1] > Rs[n + 1]:
                    rsets[n] = np.vstack([rsets[n], extra[: newRs[n + 1] - Rs[n + 1], n:]])
            Rs = newRs
            t_lint, t_rint = _np_init_interfaces(tensors_np, rsets, N)

    if recorded:
        info["sample_positions"] = np.concatenate([np.stack(Xs, axis=1) for Xs, _ in recorded])
        info["sample_values"] = np.concatenate([ev.reshape(-1) for _, ev in recorded])
    return cores, lsets, rsets, left_locals, Rs, val_eps
