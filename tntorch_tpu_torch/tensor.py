"""The tensor-train container, TT subset.

Counterpart of ``tntorch_tpu/tensor.py``. A `Tensor` holds N TT cores
(R_{n-1} x I_n x R_n), with a leading batch axis B on every core when
``batch=True``. Cores are ``torch.Tensor``s on one device, chosen by the
caller (``device=``); every method works where the cores are, and the
batched Gram rounding runs on the card's kernels when they are on the card.

Data without a device (NumPy arrays, lists) lands on the package's default
device, the CUDA card (`utils.default_device`); ``device="cpu"`` keeps it on
the CPU. Indexing (``t[key]``) follows NumPy over the compressed cores; a
key that indexes every mode with coordinate arrays evaluates the TT through
`ops.tt_eval.TTEval`, the card's evaluation kernels. ``requires_grad=True``
makes the cores leaf tensors for autograd and `optimize`.

CP cores, Tucker factors, decomposition of dense data (``ranks_tt=``,
``eps=``, ...), ``__setitem__``, mask-Tensor keys and Tucker rounding are
not ported yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.utils import asarray, logger, policy_precision, to_numpy, trace_annotation


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


def _steps(k, size: int, device):
    """A slice with a negative step as the index tensor it selects (torch
    slices take positive steps only); any other key as it is."""
    if isinstance(k, slice) and (k.step or 1) < 0:
        return torch.arange(*k.indices(size), device=device)
    return k


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
        self.requires_grad = bool(requires_grad)
        if self.requires_grad:  # leaves of autograd (sharing torch input's storage)
            self.cores = [c.detach().requires_grad_(True) for c in self.cores]

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
        t = Tensor(list(self.cores), batch=self.batch)
        t.requires_grad = self.requires_grad
        return t

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

    # ------------------------------------------------------------------
    # Indexing
    # ------------------------------------------------------------------
    def _process_key(self, key):
        if not hasattr(key, "__len__"):
            key = (key,)
        fancy = False
        if isinstance(key, torch.Tensor):
            key = to_numpy(key)
        if isinstance(key, np.ndarray) and key.ndim == 1:
            key = list(key)
        if any(not np.isscalar(k) for k in key):
            key = list(key)
            fancy = True
        if isinstance(key, tuple):
            key = list(key)
        elif not fancy:
            key = [key]

        nonecount = sum(1 for k in key if k is None)
        for i in range(len(key)):
            if key[i] is Ellipsis:
                key = (key[:i] + [slice(None)] * (len(self.shape) - (len(key) - nonecount) + 1)
                       + key[i + 1:])
                break
        if any(k is Ellipsis for k in key):
            raise IndexError("Only one ellipsis is allowed, at most")
        if len(self.shape) - (len(key) - nonecount) < 0:
            raise IndexError(
                f"Too many index entries {len(self.shape)} vs {len(key) - nonecount}")
        return key + [slice(None)] * (len(self.shape) - (len(key) - nonecount))

    def _index_array(self, k, size: int) -> torch.Tensor:
        """A 1-D coordinate array for a mode of ``size``, checked and wrapped
        on the host, as an int64 tensor on the cores' device."""
        k = np.asarray(to_numpy(k))
        if k.ndim != 1 or not (k.dtype.kind in "iu" or k.size == 0):
            raise IndexError(f"index arrays must be 1-D integer arrays, got {k.dtype} {k.shape}")
        k = k.astype(np.int64)
        if k.size and (k.min() < -size or k.max() >= size):
            raise IndexError(f"index out of range for a mode of size {size}")
        return torch.from_numpy(np.where(k < 0, k + size, k)).to(self.device)

    @policy_precision
    def __getitem__(self, key):
        """NumPy-style indexing over the compressed cores: int, slice, index
        array, ``None`` and ``Ellipsis``, for batch and non-batch TTs.

        A key of index arrays for every mode of a non-batch TT with
        boundary ranks 1 (a (P, N) array, or N arrays of length P) returns
        the one-core TT (1, P, 1) of the P values, evaluated by `TTEval`
        (the card's forward and backward kernels for real cores on the card).
        Mask-Tensor keys are not ported."""
        if isinstance(key, Tensor):
            raise _not_ported("Indexing with a mask Tensor", "queue 1 item 10")
        if isinstance(key, (np.ndarray, torch.Tensor)) and key.ndim == 2:
            if self._all_modes(key):
                return self._evaluate(key)
            key = to_numpy(key)
            key = [key[:, col] for col in range(key.shape[1])]
        key = self._process_key(key)
        if self._all_modes(key):
            if len({len(k) for k in key}) > 1:
                raise ValueError("Index arrays must have the same length")
            return self._evaluate(np.stack([np.asarray(to_numpy(k)) for k in key], axis=1))
        return self._getitem_impl(key)

    def _all_modes(self, key) -> bool:
        """Whether ``key`` (a (P, N) array or a processed key) indexes every
        mode of this non-batch, boundary-rank-1 TT with coordinate arrays."""
        if self.batch or self.ranks_tt[0] != 1 or self.ranks_tt[-1] != 1:
            return False
        if isinstance(key, (np.ndarray, torch.Tensor)):
            return key.shape[1] == self.dim()
        return len(key) == self.dim() and all(
            hasattr(k, "__len__") and np.ndim(to_numpy(k)) == 1 for k in key)

    def _evaluate(self, X):
        from tntorch_tpu_torch.ops.tt_eval import tt_eval

        if not isinstance(X, torch.Tensor):
            X = np.asarray(X)
            if X.dtype.kind not in "iu" and X.size:
                raise IndexError(f"index arrays must be integer arrays, got {X.dtype}")
            X = X.astype(np.int64)
        values = tt_eval(self.cores, X)
        return Tensor([values.reshape(1, -1, 1)])

    def __setitem__(self, key, value):
        raise _not_ported("Assignment (__setitem__)", "queue 1 item 2")

    def _getitem_impl(self, key):
        batch = self.batch
        B = "b" if batch else ""  # einsum prefix for the batch axis
        batch_dim_processed = False
        batch_dim_idx = slice(None)

        def nd(x):
            """ndim not counting the batch axis."""
            return x.ndim - (1 if batch else 0)

        def bsel(x):
            """Apply the pending batch index, keeping a leading batch axis."""
            if not batch:
                return x
            y = x[_steps(batch_dim_idx, x.shape[0], x.device)]
            if isinstance(batch_dim_idx, (int, np.integer)):
                y = y[None]
            return y

        def einsum(spec, *ops):
            return torch.einsum(spec.replace("~", B), *ops)

        def join_cores(c1, c2):
            n1, n2 = nd(c1), nd(c2)
            spec = {(1, 2): "~i,~ai->~ai", (2, 2): "~ij,~aj->~iaj",
                    (1, 3): "~i,~iaj->~iaj", (2, 3): "~ij,~jak->~iak"}.get((n1, n2))
            if spec is None:
                raise ValueError
            return einsum(spec, c1, c2)

        last_mode = None
        factors = {"int": None, "index": None, "index_done": False}
        cores = []
        counter = 0
        first_index_dim = None

        def insert_core(core=None, k=None):
            if factors["index"] is not None:
                if factors["int"] is not None:
                    factors["index"] = join_cores(factors["int"], factors["index"])
                    factors["int"] = None
                cores.append(factors["index"])
                factors["index"] = None
                factors["index_done"] = True
            if core is not None:
                new = bsel(core[..., _steps(k, core.shape[-2], core.device), :])
                if factors["int"] is not None:
                    cores.append(join_cores(factors["int"], new))
                    factors["int"] = None
                else:
                    cores.append(new)

        def get_key(c, k):
            """Mode ``c`` of the cores at ``k``: an int or a coordinate array."""
            return bsel(self.cores[c][..., k, :])

        for i in range(len(key)):
            if hasattr(key[i], "__len__"):
                this_mode = "index"
            elif key[i] is None:
                this_mode = "none"
            elif isinstance(key[i], (int, np.integer)):
                this_mode = "int"
            elif isinstance(key[i], slice):
                this_mode = "slice"
            else:
                raise IndexError

            if this_mode == "none":
                c0 = self.cores[0]
                if batch:
                    if not batch_dim_processed:
                        raise ValueError("Cannot change batch dimension")
                    r = int(self.ranks_tt[counter - 1])
                    eye = torch.eye(r, dtype=c0.dtype, device=c0.device)
                    eye = eye[None].repeat(self.shape[0], 1, 1)
                    insert_core(eye[:, :, None, :], k=slice(None))
                else:
                    r = int(self.ranks_tt[counter])
                    insert_core(torch.eye(r, dtype=c0.dtype, device=c0.device)[:, None, :],
                                k=slice(None))
            elif this_mode == "slice":
                if batch and not batch_dim_processed:
                    batch_dim_processed = True
                    batch_dim_idx = key[i]
                else:
                    insert_core(self.cores[counter - 1 if batch else counter], k=key[i])
                counter += 1
            elif this_mode == "index":
                if batch and first_index_dim == 0:
                    raise ValueError("Advanced indexing is prohibited for batch dimension")
                if factors["index_done"]:
                    raise IndexError("All index arrays must appear contiguously")
                c = counter - 1 if batch else counter
                size = self.shape[counter]
                if factors["index"] is None:
                    if batch:
                        if first_index_dim is None:
                            first_index_dim = i
                        if batch_dim_processed:
                            factors["index"] = get_key(c, self._index_array(key[i], size))
                        else:
                            batch_dim_processed = True
                            batch_dim_idx = self._index_array(key[i], size)
                    else:
                        factors["index"] = get_key(c, self._index_array(key[i], size))
                else:
                    if factors["index"].shape[-2] != len(key[i]):
                        raise ValueError("Index arrays must have the same length")
                    a1 = factors["index"]
                    a2 = get_key(c, self._index_array(key[i], size))
                    spec = {(2, 2): "~ai,~ai->~ai", (2, 3): "~ai,~iaj->~iaj",
                            (3, 2): "~iaj,~aj->~iaj", (3, 3): "~iaj,~jak->~iak"}
                    factors["index"] = einsum(spec[(nd(a1), nd(a2))], a1, a2)
                counter += 1
            elif this_mode == "int":
                if batch and not batch_dim_processed:
                    batch_dim_processed = True
                    batch_dim_idx = int(key[i])
                else:
                    if last_mode == "index":
                        insert_core()
                    c2v = get_key(counter - 1 if batch else counter, int(key[i]))
                    if factors["int"] is None:
                        factors["int"] = c2v
                    else:
                        c1 = factors["int"]
                        spec = {(1, 1): "~i,~i->~i", (1, 2): "~i,~ij->~ij",
                                (2, 1): "~ij,~j->~ij", (2, 2): "~ij,~jk->~ik"}
                        factors["int"] = einsum(spec[(nd(c1), nd(c2v))], c1, c2v)
                counter += 1
            last_mode = this_mode

        # Pending factors at the end
        if last_mode == "index":
            insert_core()
        elif last_mode == "int" and factors["int"] is not None:
            if len(cores) > 0:
                last = cores[-1]
                if batch and last.shape[0] != factors["int"].shape[0]:
                    last = bsel(last)
                spec = {(2, 1): "~ai,~i->~ai", (2, 2): "~ai,~ij->~iaj",
                        (3, 1): "~iaj,~j->~ai", (3, 2): "~iaj,~jk->~iak"}
                cores[-1] = einsum(spec[(nd(last), nd(factors["int"]))], last, factors["int"])
            else:  # scalar result (per sample in batch mode)
                f = factors["int"]
                # Surviving axes are boundary ranks; the contraction sums them
                if not batch or isinstance(batch_dim_idx, (int, np.integer)):
                    return f.sum()
                return f.sum(dim=tuple(range(1, f.ndim))) if f.ndim > 1 else f

        if batch and isinstance(batch_dim_idx, (int, np.integer)):
            return Tensor([c[0] for c in cores], batch=False)
        return Tensor(cores, batch=self.batch)

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
