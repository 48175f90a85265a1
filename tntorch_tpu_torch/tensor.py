"""The tensor-train container, TT subset.

Counterpart of ``tntorch_tpu/tensor.py``. A `Tensor` holds N TT cores
(R_{n-1} x I_n x R_n), with a leading batch axis B on every core when
``batch=True``. Cores are ``torch.Tensor``s on one device, chosen by the
caller (``device=``); every method works where the cores are, and the
batched Gram rounding runs on the card's kernels when they are on the card.

CP cores, Tucker factors, decomposition of dense data (``ranks_tt=``,
``eps=``, ...), indexing, autodiff and Tucker rounding are not ported yet
and raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.utils import asarray, logger, policy_precision, trace_annotation


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


def _full_rank_tt(data: torch.Tensor) -> list:
    """Exact (uncompressed) TT of a dense tensor: identity cores on the short
    side, the data on the long side."""
    shape = data.shape
    N = data.ndim
    eye = lambda n: torch.eye(n, dtype=data.dtype, device=data.device)  # noqa: E731
    result = []
    resh = data.reshape(shape[0], -1)
    for n in range(1, N):
        L, R = resh.shape
        if L < R:
            result.append(eye(L).reshape(L // shape[n - 1], shape[n - 1], L))
            resh = resh.reshape(L * shape[n], R // shape[n])
        else:
            result.append(resh.reshape(L // shape[n - 1], shape[n - 1], R))
            resh = eye(R).reshape(R * shape[n], R // shape[n])
    result.append(resh.reshape(resh.shape[0] // shape[N - 1], shape[N - 1], 1))
    return result


def _core_kron(a, b, batch: bool = False):
    """Slice-wise Kronecker product of two TT cores."""
    if batch:
        c = a[:, :, None, :, :, None] * b[:, None, :, :, None, :]
        return c.reshape(a.shape[0], a.shape[1] * b.shape[1], -1, a.shape[-1] * b.shape[-1])
    c = a[:, None, :, :, None] * b[None, :, :, None, :]
    return c.reshape(a.shape[0] * b.shape[0], -1, a.shape[-1] * b.shape[-1])


def _broadcast(a: "Tensor", b: "Tensor"):
    """Repeat-based shape broadcasting for binary ops; mode sizes must be
    integer multiples of each other, batch sizes equal."""
    if a.batch != b.batch:
        raise ValueError(
            "Cannot operate a batch tensor with a non-batch tensor; "
            "stack the non-batch operand into a batch (or index the batch one) first"
        )
    if tuple(a.shape) == tuple(b.shape):
        return a, b
    if a.dim() != b.dim():
        raise ValueError(f"Cannot broadcast: lhs has {a.dim()} dimensions, rhs has {b.dim()}")
    off = 1 if a.batch else 0
    if off and a.shape[0] != b.shape[0]:
        raise ValueError(f"Cannot broadcast batch sizes {a.shape[0]} and {b.shape[0]}")
    ra, rb = [], []
    for n, (s1, s2) in enumerate(zip(a.shape[off:], b.shape[off:])):
        if max(s1, s2) % min(s1, s2) != 0:
            raise ValueError(
                f"Cannot broadcast mode {n}: sizes {s1} and {s2} are not integer multiples"
            )
        ra.append(s2 // s1 if s2 > s1 else 1)
        rb.append(s1 // s2 if s1 > s2 else 1)
    return a.repeat(*ra), b.repeat(*rb)


_f32_gram_warned = False


def _warn_f32_gram_once():
    global _f32_gram_warned
    if not _f32_gram_warned:
        _f32_gram_warned = True
        logger.warning(
            "round_tt(algorithm='gram'/'randgram') on float32 cores: the Gram "
            "method squares the condition number, so rank-deficient input "
            "(e.g. rounding t+t) carries a ~1e-3 relative error floor. Use "
            "tn.set_policy('highest') (which routes 'gram' to the SVD sweep), "
            "algorithm='svd', or float64 cores when accuracy matters. This "
            "warning is shown once per process."
        )


def _left_unfolding(core, batch):
    return core.reshape(((core.shape[0],) if batch else ()) + (-1, core.shape[-1]))


def _right_unfolding(core, batch):
    return core.reshape(((core.shape[0],) if batch else ()) + (core.shape[-3], -1))


class Tensor:
    """A tensor train, or a batch of B tensor trains of one shape."""

    def __init__(self, data, Us=None, device=None, batch: bool = False, dtype=None,
                 ranks_tt=None, ranks_tucker=None, ranks_cp=None, eps=None,
                 requires_grad: bool = False):
        """Build from a list of TT cores, or exactly (full rank) from a dense
        array. ``device``/``dtype`` move and cast the cores."""
        if ranks_tt is not None or eps is not None:
            raise _not_ported("Decomposing dense data (ranks_tt=, eps=)",
                              "queue 1 item 1")
        if ranks_tucker is not None or ranks_cp is not None:
            raise _not_ported("Tucker and CP formats", "queue 1 item 3")
        if Us is not None and any(U is not None for U in Us):
            raise _not_ported("Tucker factors", "queue 1 item 3")
        if requires_grad:
            raise _not_ported("Autodiff", "queue 1 item 6")
        self.batch = bool(batch)
        tt_ndim = 4 if self.batch else 3
        if isinstance(data, (list, tuple)):
            cores = [asarray(d, dtype=dtype, device=device) for d in data]
            if any(c.ndim == tt_ndim - 1 for c in cores):
                raise _not_ported("CP cores", "queue 1 item 3")
            if not all(c.ndim == tt_ndim for c in cores):
                raise ValueError(f"All tensor cores must have {tt_ndim} dimensions")
            if len({c.device for c in cores}) > 1:
                raise ValueError("All tensor cores must be on one device")
            d = 1 if self.batch else 0
            for n in range(len(cores) - 1):
                if cores[n].shape[-1] != cores[n + 1].shape[d]:
                    raise ValueError("Core ranks do not match")
            self.cores = cores
        else:
            data = asarray(data, dtype=dtype, device=device)
            if data.ndim == 0:
                data = data[None]
            if self.batch:
                per_sample = [_full_rank_tt(x) for x in data]
                self.cores = [torch.stack(cs) for cs in zip(*per_sample)]
            else:
                self.cores = _full_rank_tt(data)
        self.Us = [None] * len(self.cores)

    # ------------------------------------------------------------------
    # Arithmetic
    # ------------------------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Tensor):  # scalar, or one scalar per sample
            c0 = self.cores[0]
            b = self.shape[:1] if self.batch else ()
            cores = [torch.ones(b + (1, s, 1), dtype=c0.dtype, device=c0.device)
                     for s in self.shape[len(b):]]
            factor = other
            if self.batch and torch.as_tensor(other).ndim == 1:  # shape (B,)
                factor = torch.as_tensor(other).to(c0.device, c0.dtype).reshape(-1, 1, 1, 1)
            cores[0] = cores[0] * factor
            other = Tensor(cores, batch=self.batch)
        this, other = _broadcast(self, other)

        if this.dim() == 1:
            return Tensor([this.cores[0] + other.cores[0]], batch=self.batch)

        cores = []
        for core1, core2 in zip(this.cores, other.cores):
            b = core1.shape[:1] if self.batch else ()
            R1l, I, R1r = core1.shape[-3:]
            R2l, _, R2r = core2.shape[-3:]
            dtype = torch.promote_types(core1.dtype, core2.dtype)
            c = torch.zeros(b + (R1l + R2l, I, R1r + R2r), dtype=dtype, device=core1.device)
            c[..., :R1l, :, :R1r] = core1
            c[..., R1l:, :, R1r:] = core2
            cores.append(c)
        # Boundary rank-1 collapses
        d = 1 if self.batch else 0
        cores[0] = cores[0].sum(dim=d, keepdim=True)
        cores[-1] = cores[-1].sum(dim=-1, keepdim=True)
        return Tensor(cores, batch=self.batch)

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        return self + -1 * other

    def __rsub__(self, other):
        return -1 * self + other

    def __neg__(self):
        return -1 * self

    def __mul__(self, other):
        if not isinstance(other, Tensor):  # scalar: spread |c|^(1/N), sign on core 0
            result = self.clone()
            arr = torch.as_tensor(other)
            if self.batch and arr.ndim == 1:  # one scalar per sample, shape (B,)
                arr = arr.to(self.cores[0].device)
                factor = (arr.abs() ** (1.0 / self.dim())).reshape(-1, 1, 1, 1)
                result.cores = [c * factor.to(c.dtype) for c in result.cores]
                result.cores[0] = result.cores[0] * arr.sign().reshape(-1, 1, 1, 1).to(
                    result.cores[0].dtype)
                return result
            # Python floats keep the cores' dtype
            factor = float(np.abs(other) ** (1.0 / self.dim()))
            result.cores = [c * factor for c in result.cores]
            result.cores[0] = result.cores[0] * float(np.sign(other))
            return result
        this, other = _broadcast(self, other)
        cores = [_core_kron(c1, c2, self.batch) for c1, c2 in zip(this.cores, other.cores)]
        return Tensor(cores, batch=self.batch)

    def __rmul__(self, other):
        return self * other

    def __truediv__(self, other):
        if isinstance(other, Tensor):
            raise _not_ported("Division by a Tensor (cross approximation)", "queue 1 item 7")
        return self * (1.0 / other)

    # ------------------------------------------------------------------
    # Shapes and ranks
    # ------------------------------------------------------------------
    @property
    def shape(self):
        shape = [self.cores[0].shape[0]] if self.batch else []
        return tuple(shape + [c.shape[-2] for c in self.cores])

    @property
    def ranks_tt(self):
        first = self.cores[0].shape[1 if self.batch else 0]
        return np.array([first] + [c.shape[-1] for c in self.cores])

    @property
    def ranks_tucker(self):
        return np.array([c.shape[-2] for c in self.cores])

    @property
    def device(self):
        return self.cores[0].device

    @property
    def dtype(self):
        return self.cores[0].dtype

    def dim(self):
        return len(self.cores)

    def __repr__(self):
        # The JAX package's tensor-network diagram, TT rows only
        N = self.dim()
        s = f"{N}D TT tensor:\n\n"
        if self.batch:
            s += f"with batch = {self.cores[0].shape[0]}\n"
        row = [" "] * (4 * N - 1)
        for n, size in enumerate(self.ranks_tucker):
            t = str(size)
            p = n * 4 - len(t) // 2 + 2
            row[p:p + len(t)] = t
        s += "".join(row) + "\n"
        row = [" "] * (4 * N - 1)
        for n in range(N):
            row[n * 4 + 2] = "|"
        s += "".join(row) + "\n"
        row = [" "] * (4 * N - 1)
        for n in range(N):
            node = f"({n})"
            p = (n + 1) * 4 - (len(node) - 1) // 2
            row[p:p + len(node)] = node
        s += "".join(row[2:]) + "\n"
        s += " / \\" * N + "\n"
        row = [" "] * (4 * (N + 1))
        for n, r in enumerate(self.ranks_tt):
            t = str(r)
            row[n * 4:n * 4 + len(t)] = t
        s += "".join(row) + "\n"
        return s

    # ------------------------------------------------------------------
    # Decompression and format
    # ------------------------------------------------------------------
    @policy_precision
    def full(self) -> torch.Tensor:
        """Decompress to a dense torch tensor on the cores' device."""
        c0 = self.cores[0]
        bshape = (c0.shape[0],) if self.batch else ()
        factor = torch.ones(bshape + (1, int(self.ranks_tt[0])), dtype=c0.dtype, device=c0.device)
        for core in self.cores:
            factor = torch.einsum("...ai,...ibj->...abj", factor, core)
            factor = factor.reshape(bshape + (-1, factor.shape[-1]))
        factor = factor.sum(-1) if factor.shape[-1] > 1 else factor[..., 0]
        return factor.reshape(self.shape)

    def numpy(self) -> np.ndarray:
        return self.full().detach().cpu().numpy()

    def _cp_to_tt(self, factor=None):
        """TT cores are already TT: a no-op (CP cores are not ported)."""
        tt_ndim = 4 if self.batch else 3
        for c in self.cores if factor is None else [factor]:
            if c.ndim != tt_ndim:
                raise _not_ported("CP cores", "queue 1 item 3")
        return factor

    def clone(self):
        return Tensor(list(self.cores), batch=self.batch)

    def repeat(self, *rep):
        """Tile along modes, like torch.repeat."""
        if len(rep) == 1 and hasattr(rep[0], "__len__"):
            rep = tuple(rep[0])
        if len(rep) != self.dim() or any(r < 1 for r in rep):
            raise ValueError("repeat takes one count >= 1 per mode")
        reps = [(1,) * (c.ndim - 2) + (r, 1) for c, r in zip(self.cores, rep)]
        return Tensor([c.repeat(*rp) for c, rp in zip(self.cores, reps)], batch=self.batch)

    # ------------------------------------------------------------------
    # Orthogonalization and rounding
    # ------------------------------------------------------------------
    @policy_precision
    def left_orthogonalize(self, mu: int):
        """QR the mu-th core's left unfolding; push R right."""
        if not 0 <= mu < self.dim() - 1:
            raise ValueError(f"mu must be in [0, {self.dim() - 1})")
        Q, R = torch.linalg.qr(_left_unfolding(self.cores[mu], self.batch))
        self.cores[mu] = Q.reshape(self.cores[mu].shape[:-1] + (Q.shape[-1],))
        nxt = _right_unfolding(self.cores[mu + 1], self.batch)
        self.cores[mu + 1] = (R @ nxt).reshape(R.shape[:-1] + self.cores[mu + 1].shape[-2:])
        return R

    @policy_precision
    def right_orthogonalize(self, mu: int):
        """LQ (QR of the transpose) on the right unfolding; push L left."""
        if not 1 <= mu < self.dim():
            raise ValueError(f"mu must be in [1, {self.dim()})")
        Q, L = torch.linalg.qr(_right_unfolding(self.cores[mu], self.batch).mT)
        L, Q = L.mT, Q.mT
        self.cores[mu] = Q.reshape(Q.shape[:-1] + self.cores[mu].shape[-2:])
        prev = _left_unfolding(self.cores[mu - 1], self.batch)
        self.cores[mu - 1] = (prev @ L).reshape(self.cores[mu - 1].shape[:-1] + (L.shape[-1],))
        return L

    def orthogonalize(self, mu: int):
        """Make the tensor mu-orthogonal by QR sweeps from both ends."""
        if mu < 0:
            mu += self.dim()
        c0 = self.cores[0]
        bshape = (c0.shape[0],) if self.batch else ()
        L = torch.ones(bshape + (1, 1), dtype=c0.dtype, device=c0.device)
        R = torch.ones(bshape + (1, 1), dtype=c0.dtype, device=c0.device)
        for i in range(mu):
            R = self.left_orthogonalize(i)
        for i in range(self.dim() - 1, mu, -1):
            L = self.right_orthogonalize(i)
        return R, L

    @policy_precision
    def round_tt(self, eps: float = 1e-14, rmax=None, algorithm: str = "svd",
                 verbose: bool = False):
        """Reduce TT ranks in place.

        - 'svd'/'eig': the error-budgeted sweep (delta = eps*|t|/sqrt(N-1));
          batch tensors keep rank min(rmax, rows, cols) with no budget.
        - 'gram'/'randgram': fixed-rank Gram rounding (needs rmax); batches
          go through `round_tt_gram_batched`, on the card's kernels when the
          cores are there. Under the 'highest' policy, float32 'gram' routes
          to the SVD sweep. 'randgram' forces randomized edges.
        - ``verbose`` (or any other algorithm) runs the eager
          orthogonalize + `truncated_svd` sweep.
        """
        from tntorch_tpu_torch.ops import rounding as ops
        from tntorch_tpu_torch.utils import resolve_precision

        N = self.dim()
        if not hasattr(rmax, "__len__"):
            rmax = [rmax] * (N - 1)
        if len(rmax) != N - 1:
            raise ValueError(f"rmax needs {N - 1} entries, got {len(rmax)}")

        if algorithm in ("eig", "svd") and not verbose:
            with trace_annotation("tn.round_tt:eps_sweep"):
                if self.batch:
                    self.cores = ops.round_tt_batch(self.cores, rmax, algorithm)
                else:
                    self.cores = ops.round_tt_eps(self.cores, eps, rmax, algorithm=algorithm)
            return

        if algorithm in ("gram", "randgram"):
            if any(r is None for r in rmax):
                raise ValueError(f"algorithm='{algorithm}' requires explicit rmax")
            precision = resolve_precision(None)
            solver = ops.resolve_edge_solver("rand" if algorithm == "randgram" else None,
                                             precision)
            rt = tuple(int(r) for r in rmax)
            if torch.finfo(self.dtype).eps > 1e-10:  # f32 / c64 class
                if algorithm == "gram" and precision == "highest":
                    # accuracy first: the Gram method squares the condition
                    # number, so float32 'gram' takes the SVD sweep instead
                    with trace_annotation("tn.round_tt:gram_to_svd_route"):
                        if self.batch:
                            self.cores = ops.round_tt_batch(self.cores, list(rt), "svd")
                        else:
                            self.cores = ops.round_tt_eps(self.cores, 0.0, list(rt),
                                                          algorithm="svd")
                    return
                _warn_f32_gram_once()
            with trace_annotation("tn.round_tt:gram"):
                if self.batch:
                    if precision == "bf16" and not self.dtype.is_complex:
                        raise _not_ported("bf16 Gram rounding", "queue 1 item 4")
                    self.cores = ops.round_tt_gram_batched(self.cores, rt, solver)
                else:
                    self.cores = ops.round_tt_gram(self.cores, rt, edge_solver=solver)
            return

        from tntorch_tpu_torch.round import truncated_svd

        self.orthogonalize(N - 1)
        delta = None
        if not self.batch:
            norm = float(torch.linalg.vector_norm(self.cores[-1]))
            delta = eps / max(1.0, np.sqrt(N - 1)) * norm
        for mu in range(N - 1, 0, -1):
            M = _right_unfolding(self.cores[mu], self.batch)
            left, right = truncated_svd(M, delta=delta, rmax=rmax[mu - 1], left_ortho=False,
                                        algorithm=algorithm, verbose=verbose, batch=self.batch)
            self.cores[mu] = right.reshape(
                ((self.cores[mu].shape[0],) if self.batch else ()) + (-1,)
                + self.cores[mu].shape[-2:]
            )
            self.cores[mu - 1] = torch.einsum("...ijk,...kl->...ijl", self.cores[mu - 1], left)

    def round(self, eps: float = 1e-14, **kwargs):
        raise _not_ported("round() (its Tucker stage)", "queue 1 item 3")

    def round_tucker(self, *args, **kwargs):
        raise _not_ported("round_tucker", "queue 1 item 3")

    def __getitem__(self, key):
        raise _not_ported("Indexing", "queue 1 item 2")

    # ------------------------------------------------------------------
    # Metrics
    # ------------------------------------------------------------------
    def dot(self, other, **kwargs):
        from tntorch_tpu_torch.metrics import dot

        return dot(self, other, **kwargs)

    def norm(self):
        from tntorch_tpu_torch.metrics import norm

        return norm(self)

    def normsq(self):
        from tntorch_tpu_torch.metrics import normsq

        return normsq(self)
