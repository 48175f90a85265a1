"""The tensor-network container: tensor trains, CP tensors and hybrids of
the two, with optional Tucker factors.

Counterpart of ``tntorch_tpu/tensor.py``. A `Tensor` holds N cores, each a
TT core (R_{n-1} x S_n x R_n) or a CP factor (S_n x R), with a leading
batch axis B on every core when ``batch=True``; mode n may carry a Tucker
factor U_n (I_n x S_n, or B x I_n x S_n), in which case the core's mode
axis (-2) is the factor's S_n and the mode's size is I_n. Cores and factors are ``torch.Tensor``s on
one device, chosen by the caller (``device=``); every method works where
they are, and the batched Gram rounding runs on the card's kernels when
they are on the card.

Data without a device (NumPy arrays, lists) lands on the package's default
device, the CUDA card (`utils.default_device`); ``device="cpu"`` keeps it on
the CPU. A dense array decomposes exactly (full rank), or to
``ranks_tt=``/``ranks_tucker=`` (TT-SVD, Tucker rounding; ``algorithm=
'gram'``/``'randomized'`` for the fixed-rank kernels of
`ops.decomposition`), or to an error budget ``eps=`` (`round`), or to
``ranks_cp=`` by CP-ALS (`_cp_als_iter`, from the sequentially truncated
HOSVD of `_cp_hosvd_factors`; on a Tucker core with ``ranks_tucker=``). A
core list may mix CP factors, (I, R) or (B, I, R) in a batch, with TT
cores: a CP factor is a TT core with diagonal slices (`_cp_to_tt`), and
``+``, ``*``, ``dot``, ``full`` and indexing act on it as it is. Indexing
(``t[key]``) follows NumPy over the compressed cores; a key that indexes
every mode of a TT or CP tensor without factors with coordinate arrays
evaluates it through `ops.tt_eval.TTEval`, the card's evaluation kernels
(CP factors converted to TT cores first); a mask Tensor with one accepted
string (`automata.accepted_inputs`) selects the entries whose ``idxs``
match that string.
``requires_grad=True`` makes the cores and factors leaf tensors for
autograd and `optimize`. Division by a Tensor (``t / t2``, ``2.0 / t``)
and ``**`` are cross approximations (`tn.reciprocal`, `tn.cross`). Each
mode carries an index annotation ``idxs`` (NumPy; ``arange`` by default,
with a leading ``arange(B)`` for a batch), as in the JAX package.
``t[key] = value`` is assignment as algebra (`Tensor.__setitem__`): the
ranks grow by the replaced and the assigned ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.utils import asarray, logger, policy_precision, to_numpy, trace_annotation


def _full_rank_tt(data: torch.Tensor, batch: bool = False) -> list:
    """Exact (uncompressed) TT of a dense tensor, (B, ...) when ``batch``:
    identity cores on the short side, the data on the long side."""
    b = tuple(data.shape[:1]) if batch else ()
    shape = data.shape[len(b):]
    N = len(shape)

    def eye(n, *s):
        e = torch.eye(n, dtype=data.dtype, device=data.device).reshape(s)
        return e.expand(b + s).contiguous()

    result = []
    resh = data.reshape(b + (shape[0], -1))
    for n in range(1, N):
        L, R = resh.shape[-2:]
        if L < R:
            result.append(eye(L, L // shape[n - 1], shape[n - 1], L))
            resh = resh.reshape(b + (L * shape[n], R // shape[n]))
        else:
            result.append(resh.reshape(b + (L // shape[n - 1], shape[n - 1], R)))
            resh = eye(R, R * shape[n], R // shape[n])
    result.append(resh.reshape(b + (resh.shape[-2] // shape[N - 1], shape[N - 1], 1)))
    return result


def _core_kron(a, b, batch: bool = False):
    """Slice-wise Kronecker product of two TT cores."""
    if batch:
        c = a[:, :, None, :, :, None] * b[:, None, :, :, None, :]
        return c.reshape(a.shape[0], a.shape[1] * b.shape[1], -1, a.shape[-1] * b.shape[-1])
    c = a[:, None, :, :, None] * b[None, :, :, None, :]
    return c.reshape(a.shape[0] * b.shape[0], -1, a.shape[-1] * b.shape[-1])


def _absorb(core, U):
    """Core (..., Rl, S, Rr) times its factor (..., I, S): (..., Rl, I, Rr)."""
    return torch.einsum("...ijk,...aj->...iak", core, U)


def _block_diag(c1, c2, spatial: bool):
    """Block-diagonal core over both rank axes, and over the middle axis too
    when ``spatial`` (two Tucker cores); the left operand's dtype. Cores
    placed alike over a mesh (DTensors, `parallel`), replicated or sharded
    over their batch, are joined shard by shard on each rank."""
    if hasattr(c1, "device_mesh"):
        from tntorch_tpu_torch.parallel.mesh import on_shards

        joined = on_shards(lambda a, b: _block_diag(a, b, spatial), c1, c2)
        if joined is not None:
            return joined
    b = c1.shape[:-3]
    R1l, S1, R1r = c1.shape[-3:]
    R2l, S2, R2r = c2.shape[-3:]
    S = S1 + S2 if spatial else S1
    c = torch.zeros(b + (R1l + R2l, S, R1r + R2r), dtype=c1.dtype, device=c1.device)
    c[..., :R1l, :S1, :R1r] = c1
    c[..., R1l:, S - S2:, R1r:] = c2
    return c


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


def _rmax_per_mode(rmax, n: int) -> list:
    if not hasattr(rmax, "__len__"):
        rmax = [rmax] * n
    if len(rmax) != n:
        raise ValueError(f"rmax needs {n} entries, got {len(rmax)}")
    return list(rmax)


def _cp_khatri_asc(cores, batch: bool):
    """Khatri-Rao product of CP factors (..., I_n, R), rows in C order
    (earlier modes slower), so that they align with reshapes of the data."""
    R = cores[0].shape[-1]
    bshape = tuple(cores[0].shape[:1]) if batch else ()
    k = cores[0]
    for c in cores[1:]:
        k = (k[..., :, None, :] * c[..., None, :, :]).reshape(bshape + (-1, R))
    return k


def _cp_als_iter(data, cores, normsq_data, batch: bool = False):
    """One CP-ALS sweep over every mode, then the relative error, as a
    device scalar (the batch's mean for a batch). The right-hand side of
    mode n is three GEMMs on the data as it lies, ``sum_l [reshape(data,
    (L I_n, T)) @ KR]_{l,i,r} KL_{l,r}``, with no mode-n unfolding copy;
    each mode solves its R x R normal equations by ``pinv``. The error
    comes from ``|data - X|^2 = |data|^2 - 2<data, X> + |X|^2``, whose
    terms the last mode's equations already hold: no dense
    reconstruction. ``cores`` may be any start (the tests feed the JAX
    package's)."""
    N = len(cores)
    bshape = tuple(data.shape[:1]) if batch else ()
    shapes = data.shape[len(bshape):]
    R = cores[0].shape[-1]
    cores = list(cores)
    grams = [c.mT @ c for c in cores]
    rhs = prod = None
    for n in range(N):
        prod = torch.ones_like(grams[0])
        for m in range(N):
            if m != n:
                prod = prod * grams[m]
        L = int(np.prod(shapes[:n], dtype=np.int64))
        if n == N - 1:  # the trailing mode: unf^T @ KL as one transposed GEMM
            M2 = data.reshape(bshape + (L, shapes[n]))
            rhs = torch.einsum("...li,...lr->...ir", M2, _cp_khatri_asc(cores[:n], batch))
        else:
            KR = _cp_khatri_asc(cores[n + 1:], batch)
            Y = (data.reshape(bshape + (L * shapes[n], -1)) @ KR).reshape(
                bshape + (L, shapes[n], R))
            if n == 0:
                rhs = Y.reshape(bshape + (shapes[0], R))
            else:
                rhs = (Y * _cp_khatri_asc(cores[:n], batch)[..., :, None, :]).sum(-3)
        cores[n] = (torch.linalg.pinv(prod) @ rhs.mT).mT
        grams[n] = cores[n].mT @ cores[n]
    red = (-2, -1)
    dot_dx = (rhs * cores[N - 1]).sum(red)
    normsq_x = (prod * grams[N - 1]).sum(red)
    relsq = (normsq_data - 2 * dot_dx + normsq_x).clamp(min=0) / normsq_data
    return tuple(cores), (relsq.sqrt().mean() if batch else relsq.sqrt())


def _cp_hosvd_factors(data, R: int, batch: bool = False):
    """The CP-ALS start: the sequentially truncated HOSVD. Mode n's factor
    is the top min(R, I_n) eigenvectors of the Gram of the data projected
    onto the factors of modes 0..n-1, so only mode 0 reads the whole
    tensor, on its own layout. ``eigh`` fixes each column up to its sign,
    which torch and JAX may choose differently: the tests compare the
    factors by their projectors and carry the JAX package's across."""
    bshape = tuple(data.shape[:1]) if batch else ()
    shapes = data.shape[len(bshape):]
    N = len(shapes)
    core = data.reshape(bshape + (1,) + tuple(shapes))
    factors = []
    for n in range(N):
        P, I = core.shape[len(bshape)], shapes[n]
        M = core.reshape(bshape + (P, I, -1))
        gram = torch.einsum("...pit,...pjt->...ij", M, M)
        U = torch.linalg.eigh(gram)[1].flip(-1)[..., :min(R, I)]
        factors.append(U)
        if n < N - 1:
            core = torch.einsum("...pit,...ir->...prt", M, U).reshape(
                bshape + (P * U.shape[-1],) + tuple(shapes[n + 1:]))
    return tuple(factors)


def _cp_random_factors(shapes, R: int, like: torch.Tensor):
    """Standard-normal (..., I, R) CP factors, one per size in ``shapes``,
    in ``like``'s dtype and on its device, from fresh entropy: the start of
    CP-ALS on a Tucker core, and the columns that pad the HOSVD start where
    R > I_n (the JAX package draws ``jax.random.normal`` from its key
    stream, which torch cannot replay; the tests patch this helper)."""
    from tntorch_tpu_torch.utils import next_key

    g = next_key(device=like.device)
    return [torch.randn(tuple(s) + (R,), generator=g, dtype=like.dtype, device=like.device)
            for s in shapes]


class Tensor:
    """A tensor train, CP tensor or hybrid with optional Tucker factors, or
    a batch of B of them of one shape."""

    def __init__(self, data, Us=None, idxs=None, device=None, requires_grad=None,
                 ranks_cp=None, ranks_tucker=None, ranks_tt=None, eps=None,
                 max_iter: int = 25, tol: float = 1e-4, verbose: bool = False,
                 batch: bool = False, algorithm: str = "svd", dtype=None):
        """Build from a list of TT cores and CP factors (and optional Tucker
        factors ``Us``), or from a dense array: exactly (full rank), to
        ``ranks_tt``/``ranks_tucker``, by CP-ALS to ``ranks_cp`` (with
        ``ranks_tucker``: on the Tucker core), or to the relative error
        ``eps``.
        ``device``/``dtype`` move and cast the cores and factors. The
        parameters are the JAX package's, in its order; ``ranks_cp`` runs
        CP-ALS (at most ``max_iter`` sweeps, until a sweep gains less than
        ``tol`` of relative error; ``verbose`` prints each sweep's).
        ``algorithm`` picks the rounding ('svd', 'eig'), or for
        ``ranks_tt`` alone the fixed-rank TT-SVD kernels ('gram',
        'randomized')."""
        if eps is not None and (ranks_tucker is not None or ranks_tt is not None
                                or ranks_cp is not None):
            raise ValueError("Specify eps or ranks, but not both")
        self.batch = bool(batch)
        self.requires_grad = bool(requires_grad)  # None means False
        # Modes whose Tucker factor is fixed: not trained by optimize, not
        # counted by dof
        self.frozen_Us = set()
        if isinstance(data, (list, tuple)):
            cores = [asarray(d, dtype=dtype, device=device) for d in data]
            if not all(self._m <= c.ndim <= self._m + 1 for c in cores):
                raise ValueError("All tensor cores must have 2 (for CP) or 3 (for TT) "
                                 "dimensions, one more in a batch")
            if len({c.device for c in cores}) > 1:
                raise ValueError("All tensor cores must be on one device")
            for n in range(len(cores) - 1):
                # a TT core's left rank, or a CP factor's rank (its last axis)
                nxt = cores[n + 1].shape[-1 if cores[n + 1].ndim == self._m else -3]
                if cores[n].shape[-1] != nxt:
                    raise ValueError("Core ranks do not match")
            self.cores = cores
            self.Us = self._factors(Us, dtype)
        elif ranks_cp is not None:
            if ranks_tt is not None:
                raise ValueError("ALS for CP-TT is not yet supported")
            if hasattr(ranks_cp, "__len__"):
                raise ValueError("ranks_cp of a dense tensor is one rank")
            data = asarray(data, dtype=dtype, device=device)
            self._init_cp_als(data[None] if data.ndim == 0 else data, int(ranks_cp),
                              ranks_tucker, max_iter, tol, verbose, algorithm)
        else:
            self._decompose(asarray(data, dtype=dtype, device=device), ranks_tt,
                            ranks_tucker, algorithm)
        if idxs is None:
            idxs = [np.arange(sh) for sh in self.shape]
        self.idxs = [None if i is None else to_numpy(i) for i in idxs]
        if self.requires_grad:  # leaves of autograd (sharing torch input's storage)
            self.cores = [c.detach().requires_grad_(True) for c in self.cores]
            self.Us = [None if U is None else U.detach().requires_grad_(True) for U in self.Us]
        if eps is not None:
            self.round(eps, algorithm=algorithm)

    def _factors(self, Us, dtype):
        """The Tucker factors on the cores' device, checked against them."""
        N = len(self.cores)
        if Us is None:
            return [None] * N
        if len(Us) != N:
            raise ValueError(f"Us needs one entry per mode ({N}), got {len(Us)}")
        Us = [None if U is None else asarray(U, dtype=dtype, device=self.device) for U in Us]
        fd = 3 if self.batch else 2
        for n, U in enumerate(Us):
            if U is None:
                continue
            if U.ndim != fd or self.cores[n].shape[-2] != U.shape[-1]:
                raise ValueError(f"Tucker factor {n} has shape {tuple(U.shape)}: it must have "
                                 f"{fd} dimensions and {self.cores[n].shape[-2]} columns")
        return Us

    @policy_precision
    def _init_cp_als(self, data, R, ranks_tucker, max_iter, tol, verbose, algorithm):
        """CP-ALS of the dense ``data``: from the HOSVD start
        (`_cp_hosvd_factors`, padded by `_cp_random_factors` where R > I_n),
        or, with ``ranks_tucker``, on the Tucker core of the Tucker-rounded
        data from a random start, the factors kept. One read of the error a
        sweep."""
        bshape = tuple(data.shape[:1]) if self.batch else ()
        if ranks_tucker is None:
            self.Us = [None] * (data.ndim - len(bshape))
            cores = []
            for c in _cp_hosvd_factors(data, R, self.batch):
                if c.shape[-1] < R:
                    pad = _cp_random_factors([c.shape[:-1]], R - c.shape[-1], c)[0]
                    c = torch.cat([c, pad], dim=-1)
                cores.append(c)
        else:
            self.cores = _full_rank_tt(data, self.batch)
            self.Us = [None] * len(self.cores)
            self.round_tucker(rmax=ranks_tucker, algorithm=algorithm)
            data = self.tucker_core()
            cores = _cp_random_factors([bshape + (s,) for s in data.shape[len(bshape):]], R,
                                       data)
        errors = []
        normsq = (data * data).sum(tuple(range(len(bshape), data.ndim)))
        for it in range(max_iter):
            cores, rel = _cp_als_iter(data, cores, normsq, self.batch)
            errors.append(float(rel))
            if verbose:
                print(f"iter: {it} | eps: {errors[-1]:.8f}")
            if len(errors) >= 2 and errors[-2] - errors[-1] < tol:
                break
        self.cores = list(cores)

    def _decompose(self, data, ranks_tt, ranks_tucker, algorithm):
        """TT (and Tucker) cores of the dense ``data``, as the JAX package
        builds them: the fixed-rank TT-SVD kernels for ``ranks_tt`` alone
        with 'gram'/'randomized', else the exact TT, Tucker-rounded to
        ``ranks_tucker`` and TT-rounded to ``ranks_tt``."""
        if data.ndim == 0:
            data = data[None]
        self.Us = [None] * (data.ndim - (1 if self.batch else 0))
        if ranks_tt is not None and ranks_tucker is None and algorithm in ("gram", "randomized"):
            from tntorch_tpu_torch.ops import decomposition as dec

            if self.batch:  # the batch takes the Gram kernel, whichever was asked
                self.cores = dec.tt_svd_gram(data, ranks_tt, batch=True)
            elif algorithm == "randomized":
                self.cores = dec.tt_svd_randomized(data, ranks_tt)
            else:
                self.cores = dec.tt_svd_gram(data, ranks_tt)
            return
        self.cores = _full_rank_tt(data, self.batch)
        if ranks_tucker is not None:
            # round_tucker knows 'svd'/'eig' only: 'gram' and 'randomized'
            # are Gram/eigh-based
            self.round_tucker(rmax=ranks_tucker,
                              algorithm="eig" if algorithm in ("gram", "randomized") else algorithm)
        if ranks_tt is not None:
            self.round_tt(rmax=ranks_tt, algorithm=algorithm)

    # ------------------------------------------------------------------
    # Arithmetic
    # ------------------------------------------------------------------
    @property
    def _m(self) -> int:
        """The ndim of a CP factor in this tensor's layout (a TT core has
        one more)."""
        return 3 if self.batch else 2

    def _is_tt(self, core) -> bool:
        return core.ndim == self._m + 1

    def _absorb(self, core, U):
        """Mode factor ``U`` (..., I, S) multiplied into ``core``: a CP
        factor (..., S, R) becomes (..., I, R), a TT core (..., Rl, S, Rr)
        becomes (..., Rl, I, Rr)."""
        if core.ndim == self._m:
            return torch.einsum("...jk,...aj->...ak", core, U)
        return _absorb(core, U)

    def _lift(self, core):
        """A CP factor (..., I, R) as the (..., 1, I, R) TT core of rank-1
        left; a TT core as it is."""
        return core.unsqueeze(-3) if core.ndim == self._m else core

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
            def one_mode(t):
                # a CP factor's values are its column sums: adding (I, R) to
                # (1, I, 1) core by core would count the other operand R times
                c = t.decompress_tucker_factors().cores[0]
                return self._lift(c.sum(-1, keepdim=True)) if c.ndim == self._m else c

            return Tensor([one_mode(this) + one_mode(other)], batch=self.batch)

        cp = [this.cores[n].ndim == self._m and other.cores[n].ndim == self._m
              for n in range(this.dim())]
        cores, Us = [], []
        for n in range(this.dim()):
            core1, core2 = this.cores[n], other.cores[n]
            if cp[n]:  # two CP factors: block-diagonal over the lifted views
                core1, core2 = self._lift(core1), self._lift(core2)
            else:
                core1, core2 = self._cp_to_tt(core1), self._cp_to_tt(core2)
            U1, U2 = this.Us[n], other.Us[n]
            if U1 is not None and U2 is not None:
                # Block-diagonal over the rank axes and the Tucker axis
                cores.append(_block_diag(core1, core2, spatial=True))
                Us.append(torch.cat((U1, U2.to(U1.dtype)), dim=-1))
                continue
            if U1 is not None:
                core1 = _absorb(core1, U1)
            if U2 is not None:
                core2 = _absorb(core2, U2)
            cores.append(_block_diag(core1, core2, spatial=False))
            Us.append(None)
        # Boundary rank-1 collapses; two CP factors drop their lifted axis
        d = 1 if self.batch else 0
        if not cp[0]:
            cores[0] = cores[0].sum(dim=d, keepdim=True)
        if not cp[-1]:
            cores[-1] = cores[-1].sum(dim=-1, keepdim=True)
        cores = [c.sum(dim=d) if both else c for c, both in zip(cores, cp)]
        return Tensor(cores, Us=Us, batch=self.batch)

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
            if isinstance(other, torch.Tensor) or (self.batch and np.ndim(other) == 1):
                # A torch scalar stays on its device (and in the autograd
                # graph); one scalar per sample, shape (B,), spreads per core
                arr = torch.as_tensor(other)
                factor, sign = arr.abs() ** (1.0 / self.dim()), torch.sgn(arr)

                def per_sample(x, c):  # (B,) over a TT core's or a CP factor's axes
                    if self.batch and arr.ndim == 1:
                        x = x.reshape((-1,) + (1,) * (c.ndim - 1))
                    return x.to(c.device, c.dtype)

                result.cores = [c * per_sample(factor, c) for c in result.cores]
                c0 = result.cores[0]
                result.cores[0] = c0 * per_sample(sign, c0)
                return result
            # Python floats keep the cores' dtype
            factor = float(np.abs(other) ** (1.0 / self.dim()))
            result.cores = [c * factor for c in result.cores]
            result.cores[0] = result.cores[0] * float(np.sign(other))
            return result
        this, other = _broadcast(self, other)
        off = 1 if self.batch else 0
        cores, Us = [], []
        for n in range(this.dim()):
            core1, core2 = this.cores[n], other.cores[n]
            cp = core1.ndim == self._m and core2.ndim == self._m
            if cp:  # two CP factors: the Kronecker product of the lifted views
                core1, core2 = self._lift(core1), self._lift(core2)
            else:
                core1, core2 = self._cp_to_tt(core1), self._cp_to_tt(core2)
            U1, U2 = this.Us[n], other.Us[n]
            if (U1 is not None and U2 is not None
                    and core1.shape[-2] * core2.shape[-2] < this.shape[n + off]):
                # Keep the Tucker structure: Kronecker cores and factors
                c = torch.einsum("...ijk,...abc->...iajbkc", core1, core2)
                cores.append(c.reshape(c.shape[:-6] + (
                    core1.shape[-3] * core2.shape[-3], core1.shape[-2] * core2.shape[-2],
                    core1.shape[-1] * core2.shape[-1])))
                U = torch.einsum("...ij,...ik->...ijk", U1, U2)
                Us.append(U.reshape(U.shape[:-2] + (-1,)))
            else:
                if U1 is not None:
                    core1 = _absorb(core1, U1)
                if U2 is not None:
                    core2 = _absorb(core2, U2)
                cores.append(_core_kron(core1, core2, self.batch))
                Us.append(None)
            if cp:
                cores[-1] = cores[-1].squeeze(-3)
        return Tensor(cores, Us=Us, batch=self.batch)

    def __rmul__(self, other):
        return self * other

    def __truediv__(self, other):
        if isinstance(other, Tensor):
            import tntorch_tpu_torch as tn

            return self * tn.reciprocal(other)
        return self * (1.0 / other)

    def __rtruediv__(self, other):
        import tntorch_tpu_torch as tn

        return other * tn.reciprocal(self)

    def __pow__(self, other):
        from tntorch_tpu_torch.cross import cross

        if isinstance(other, Tensor):
            return cross(function=lambda x, y: x ** y, tensors=[self, other], verbose=False)
        return cross(function=lambda x: x ** other, tensors=[self], verbose=False)

    def __rpow__(self, other):
        from tntorch_tpu_torch.cross import cross

        return cross(function=lambda x: other ** x, tensors=[self], verbose=False)

    # Boolean algebra on {0, 1} tensors
    def __invert__(self):
        return 1 - self

    def __and__(self, other):
        return self * other

    def __or__(self, other):
        return self + other - self * other

    def __xor__(self, other):
        return self + other - 2 * self * other

    def __eq__(self, other):
        from tntorch_tpu_torch.metrics import dist

        # dist is (B,) for batch tensors: equal only if every sample matches
        return bool(torch.all(dist(self, other) <= 1e-14))

    def __ne__(self, other):
        return not self == other

    __hash__ = None  # mutable container

    # ------------------------------------------------------------------
    # Shapes and ranks
    # ------------------------------------------------------------------
    @property
    def shape(self):
        shape = [self.cores[0].shape[0]] if self.batch else []
        return tuple(shape + [c.shape[-2] if U is None else U.shape[-2]
                              for c, U in zip(self.cores, self.Us)])

    def b(self):
        """The batch size."""
        if not self.batch:
            raise ValueError("b() is the batch size of a batch tensor")
        return self.cores[0].shape[0]

    @property
    def ranks_tt(self):
        # a CP factor's rank is its last axis, on both sides
        c0 = self.cores[0]
        first = c0.shape[-1] if c0.ndim == self._m else c0.shape[-3]
        return np.array([first] + [c.shape[-1] for c in self.cores])

    @ranks_tt.setter
    def ranks_tt(self, value):
        self.round_tt(rmax=value)

    @property
    def ranks_tucker(self):
        return np.array([c.shape[-2] for c in self.cores])

    @ranks_tucker.setter
    def ranks_tucker(self, value):
        self.round_tucker(rmax=value)

    @property
    def device(self):
        return self.cores[0].device

    @property
    def dtype(self):
        return self.cores[0].dtype

    def dim(self):
        return len(self.cores)

    def size(self):
        return self.shape

    def numel(self):
        """The number of entries (the batch's included), as a float."""
        return float(np.round(np.prod([float(s) for s in self.shape])))

    def numcoef(self):
        """The number of stored coefficients: cores and factors."""
        return sum(int(np.prod(c.shape)) for c in self.cores) + sum(
            int(np.prod(U.shape)) for U in self.Us if U is not None)

    def __repr__(self):
        # The JAX package's tensor-network diagram
        N = self.dim()
        tucker = any(U is not None for U in self.Us)
        kinds = [("TT", any(self._is_tt(c) for c in self.cores)),
                 ("CP", any(c.ndim == self._m for c in self.cores)), ("Tucker", tucker)]
        s = "{}D {} tensor:\n\n".format(N, "-".join(k for k, present in kinds if present))
        if self.batch:
            s += f"with batch = {self.cores[0].shape[0]}\n"

        def centred(row, n, text):
            p = n * 4 - len(text) // 2 + 2
            row[p:p + len(text)] = text

        shape = self.shape[1 if self.batch else 0:]
        tuckerr = self.ranks_tucker
        if tucker:
            row = [" "] * (4 * N - 1)
            for n in range(N):
                if self.Us[n] is not None:
                    centred(row, n, str(shape[n]))
            s += "".join(row) + "\n"
        for first in (True, False):
            row = [" "] * (4 * N - 1)
            for n in range(N):
                if (self.Us[n] is None) == first:
                    centred(row, n, str(tuckerr[n]))
                else:
                    row[n * 4 + 2] = "|"
            s += "".join(row) + "\n"
        row = [" "] * (4 * N - 1)
        for n in range(N):
            node = f"<{n}>" if self.cores[n].ndim == self._m else f"({n})"
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
    def tucker_core(self) -> torch.Tensor:
        """The dense Tucker core: the cores' TT, factors left out."""
        return Tensor(list(self.cores), batch=self.batch).full()

    @policy_precision
    def decompress_tucker_factors(self, dim="all"):
        """A copy with the factors of the modes ``dim`` multiplied into
        their cores."""
        if dim == "all":
            dim = range(self.dim())
        if not hasattr(dim, "__len__"):
            dim = [dim]
        cores, Us = [], []
        for n, (c, U) in enumerate(zip(self.cores, self.Us)):
            if n in dim and U is not None:
                cores.append(self._absorb(c, U))
                Us.append(None)
            else:
                cores.append(c)
                Us.append(U)
        return Tensor(cores, Us=Us, idxs=getattr(self, "idxs", None), batch=self.batch)

    def tt(self):
        """The same tensor as a plain TT: factors multiplied in, CP factors
        as TT cores."""
        t = self.decompress_tucker_factors()
        t._cp_to_tt()
        return t

    @policy_precision
    def full(self) -> torch.Tensor:
        """Decompress to a dense torch tensor on the cores' device."""
        t = self.decompress_tucker_factors()
        c0 = t.cores[0]
        bshape = (c0.shape[0],) if self.batch else ()
        factor = c0.new_ones(bshape + (1, int(self.ranks_tt[0])))
        last = t.dim() - 1
        for n, core in enumerate(t.cores):
            if core.ndim == self._m:  # a CP factor: a diagonal core
                spec = "...ai,...bi->...ab" if n == last else "...ai,...bi->...abi"
                factor = torch.einsum(spec, factor, core)
                factor = factor[..., None] if n == last else factor
            else:
                factor = torch.einsum("...ai,...ibj->...abj", factor, core)
            factor = factor.reshape(bshape + (-1, factor.shape[-1]))
        factor = factor.sum(-1) if factor.shape[-1] > 1 else factor[..., 0]
        return factor.reshape(self.shape)

    def torch(self) -> torch.Tensor:
        """The dense ``torch.Tensor``, on the cores' device (the JAX
        package returns a CPU tensor here; in this package ``full()`` and
        ``torch()`` are one)."""
        return self.full()

    def numpy(self) -> np.ndarray:
        """The dense NumPy array (of cores placed over a mesh, `parallel`:
        the whole tensor, on every rank, from the gathered cores)."""
        if any(hasattr(c, "device_mesh") for c in self.cores):
            from tntorch_tpu_torch.parallel.mesh import gather

            t = self.clone()
            t.cores = [gather(c) for c in t.cores]
            t.Us = [None if U is None else gather(U) for U in t.Us]
            return t.numpy()
        return self.full().detach().cpu().numpy()

    def to(self, device):
        """Move the cores and factors to ``device``, in place; returns self."""
        self.cores = [c.to(device) for c in self.cores]
        self.Us = [None if U is None else U.to(device) for U in self.Us]
        return self

    def _cp_to_tt(self, factor=None):
        """A CP factor (..., I, R) as the TT core with diagonal slices
        ``C[..., a, i, b] = delta(a, b) factor[..., i, a]``; a TT core as it
        is. Without ``factor``, converts every core in place: the first
        factor becomes (..., 1, I, R) and the last (..., R, I, 1)."""
        m = self._m
        if factor is None:
            if self.cores[0].ndim == m:
                self.cores[0] = self._lift(self.cores[0])
            for mu in range(1, self.dim() - 1):
                self.cores[mu] = self._cp_to_tt(self.cores[mu])
            if self.cores[-1].ndim == m:
                self.cores[-1] = self.cores[-1].mT[..., None]
            return None
        if factor.ndim == m + 1:
            return factor
        eye = torch.eye(factor.shape[-1], dtype=factor.dtype, device=factor.device)
        return eye[:, None, :] * factor.mT[..., :, :, None]

    def as_leaf(self):
        """Detach the cores and factors from autograd, in place; returns self."""
        self.cores = [c.detach() for c in self.cores]
        self.Us = [None if U is None else U.detach() for U in self.Us]
        return self

    def set_factors(self, name, dim="all", requires_grad: bool = False):
        """Give the modes ``dim`` Tucker factors from the basis family
        ``name`` (`tools.generate_basis`: square where the mode has no
        factor yet, else the factor's shape), in the cores' dtype and on
        their device, in place. ``requires_grad`` governs the new factors
        only: by default they are frozen (`optimize` leaves them alone and
        `dof` does not count them); the cores keep their flag."""
        from tntorch_tpu_torch.tools import generate_basis

        if dim == "all":
            dim = range(self.dim())
        off = 1 if self.batch else 0
        for m in dim:
            shape = ((self.shape[m + off],) * 2 if self.Us[m] is None
                     else tuple(self.Us[m].shape[-2:]))
            U = generate_basis(name, shape, dtype=self.dtype, device=self.device)
            if self.batch:
                U = U[None].repeat(self.shape[0], 1, 1)
            self.Us[m] = U
            if requires_grad:
                self.frozen_Us.discard(m)
            else:
                self.frozen_Us.add(m)

    def clone(self):
        t = Tensor(list(self.cores), Us=list(self.Us), idxs=getattr(self, "idxs", None),
                   batch=self.batch)
        t.requires_grad = self.requires_grad
        t.frozen_Us = set(self.frozen_Us)
        return t

    def repeat(self, *rep):
        """Tile along modes, like torch.repeat (a mode's factor, where it
        has one, is tiled instead of its core). Counts beyond the modes
        append trailing modes of that size, constant along the new mode:
        each a core that passes the last rank through (ones when it is 1)."""
        if len(rep) == 1 and hasattr(rep[0], "__len__"):
            rep = tuple(rep[0])
        if len(rep) < self.dim() or any(r < 1 for r in rep):
            raise ValueError("repeat takes a count >= 1 for every mode, and for each new one")
        t = self.clone()
        last = t.cores[-1]
        R = last.shape[-1]
        eye = torch.eye(R, dtype=last.dtype, device=last.device)[:, None, :]
        for r in rep[self.dim():]:
            core = eye.expand(last.shape[:-3] + (R, r, R)).contiguous()
            t.cores.append(core)
            t.Us.append(None)
            t.idxs.append(np.arange(r))
        for n, r in enumerate(rep[:self.dim()]):
            x = t.cores[n] if t.Us[n] is None else t.Us[n]
            x = x.repeat(*((1,) * (x.ndim - 2) + (r, 1)))
            if t.Us[n] is None:
                t.cores[n] = x
            else:
                t.Us[n] = x
        return t

    # ------------------------------------------------------------------
    # Orthogonalization and rounding
    # ------------------------------------------------------------------
    @policy_precision
    def factor_orthogonalize(self, mu: int):
        """QR mode mu's factor; push R into its core."""
        if self.Us[mu] is None:
            return
        Q, R = torch.linalg.qr(self.Us[mu])
        self.Us[mu] = Q
        self.cores[mu] = self._absorb(self.cores[mu], R)

    @policy_precision
    def left_orthogonalize(self, mu: int):
        """QR the mu-th core's left unfolding; push R right."""
        if not 0 <= mu < self.dim() - 1:
            raise ValueError(f"mu must be in [0, {self.dim() - 1})")
        self.factor_orthogonalize(mu)
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
        self.factor_orthogonalize(mu)
        Q, L = torch.linalg.qr(_right_unfolding(self.cores[mu], self.batch).mT)
        L, Q = L.mT, Q.mT
        self.cores[mu] = Q.reshape(Q.shape[:-1] + self.cores[mu].shape[-2:])
        prev = _left_unfolding(self.cores[mu - 1], self.batch)
        self.cores[mu - 1] = (prev @ L).reshape(self.cores[mu - 1].shape[:-1] + (L.shape[-1],))
        return L

    def orthogonalize(self, mu: int):
        """Make the tensor mu-orthogonal by QR sweeps from both ends (the
        factors of the swept modes orthogonalized on the way)."""
        if mu < 0:
            mu += self.dim()
        self._cp_to_tt()
        c0 = self.cores[0]
        bshape = (c0.shape[0],) if self.batch else ()
        L = torch.ones(bshape + (1, 1), dtype=c0.dtype, device=c0.device)
        R = torch.ones(bshape + (1, 1), dtype=c0.dtype, device=c0.device)
        for i in range(mu):
            R = self.left_orthogonalize(i)
        for i in range(self.dim() - 1, mu, -1):
            L = self.right_orthogonalize(i)
        return R, L

    def _eyes(self):
        """Identity factors of every mode, the cores' device and dtype."""
        off = 1 if self.batch else 0
        return [torch.eye(s, dtype=self.dtype, device=self.device) for s in self.shape[off:]]

    @policy_precision
    def round_tucker(self, eps: float = 1e-14, rmax=None, dim="all", algorithm: str = "svd"):
        """Reduce Tucker ranks in place, as the JAX package does, path by path.

        - 'svd'/'eig' on a TT without factors: one masked sweep
          (`ops.rounding.round_tucker_eps`, or `round_tucker_eps_batch`
          for batches, which keeps rank min(rmax, full) with no budget) and
          one host read of the ranks. These truncate every mode: ``dim``
          only sets the split eps/sqrt(len(dim)).
        - otherwise the eager sweep: orthogonalize, then per mode in ``dim``
          push the core's non-orthogonality into the factor and truncate it
          by `truncated_svd(left_ortho=True)`; other modes pass through.
        """
        from tntorch_tpu_torch.ops import rounding as ops

        N = self.dim()
        rmax = _rmax_per_mode(rmax, N)
        if dim == "all":
            dim = range(N)
        if not hasattr(dim, "__len__"):
            dim = [dim]
        self._cp_to_tt()
        kernel = algorithm in ("eig", "svd") and all(U is None for U in self.Us)
        if kernel and self.batch:
            self.cores, self.Us = ops.round_tucker_eps_batch(
                self.cores, self._eyes(), rmax=rmax, dims=dim, algorithm=algorithm)
            return
        if kernel:
            self.cores, self.Us = ops.round_tucker_eps(
                self.cores, self._eyes(), eps, rmax=rmax, dims=dim, algorithm=algorithm)
            return

        from tntorch_tpu_torch.round import truncated_svd

        self.orthogonalize(-1)
        bshape = (self.cores[0].shape[0],) if self.batch else ()
        off = len(bshape)
        for mu in range(N - 1, -1, -1):
            if mu not in dim:
                # Modes left alone only pass through the orthogonalization
                if mu > 0:
                    self.right_orthogonalize(mu)
                continue
            if self.Us[mu] is None:
                eye = torch.eye(self.shape[mu + off], dtype=self.dtype, device=self.device)
                self.Us[mu] = eye.expand(bshape + eye.shape).contiguous()
            # Push the core's non-orthogonality into the factor
            core = self.cores[mu]
            Q, R = torch.linalg.qr(core.mT.reshape(bshape + (-1, core.shape[-2])))
            self.cores[mu] = Q.reshape(bshape + (core.shape[-3], core.shape[-1], -1)).mT
            self.Us[mu] = self.Us[mu] @ R.mT
            left, right = truncated_svd(self.Us[mu], eps=eps / np.sqrt(len(dim)),
                                        rmax=rmax[mu], left_ortho=True, algorithm=algorithm,
                                        batch=self.batch)
            self.Us[mu] = left
            self.cores[mu] = _absorb(self.cores[mu], right)
            if mu > 0:
                self.right_orthogonalize(mu)

    def _round_tt_computes_reached(self, algorithm: str = "svd", verbose: bool = False) -> bool:
        """Whether round_tt takes a sweep that reports the reached error in
        ``_round_reached_dev``: one definition for round_tt's dispatch and
        round()'s budget."""
        return algorithm in ("eig", "svd") and not verbose and all(U is None for U in self.Us)

    @policy_precision
    def round_tt(self, eps: float = 1e-14, rmax=None, algorithm: str = "svd",
                 verbose: bool = False):
        """Reduce TT ranks in place.

        - 'svd'/'eig' on a TT without factors: the error-budgeted sweep
          (delta = eps*|t|/sqrt(N-1)); batch tensors keep rank min(rmax,
          rows, cols) with no budget. The reached relative error stays on
          the device in ``_round_reached_dev``.
        - 'gram'/'randgram': fixed-rank Gram rounding (needs rmax), the
          factors orthogonalized first; batches go through
          `round_tt_gram_batched`, on the card's kernels when the cores are
          there. Under the 'highest' policy, float32 'gram' routes to the
          SVD sweep. 'randgram' forces randomized edges.
        - ``verbose``, Tucker factors with 'svd'/'eig', or any other
          algorithm: the eager orthogonalize + `truncated_svd` sweep.
        """
        with trace_annotation("tn.round_tt"):
            self._round_tt(eps, rmax, algorithm, verbose)

    def _round_tt(self, eps, rmax, algorithm, verbose):
        from tntorch_tpu_torch.ops import rounding as ops
        from tntorch_tpu_torch.utils import resolve_precision

        N = self.dim()
        rmax = _rmax_per_mode(rmax, N - 1)
        self._round_reached_dev = None
        self._cp_to_tt()

        if self._round_tt_computes_reached(algorithm, verbose):
            if self.batch:
                self.cores, self._round_reached_dev = ops.round_tt_batch(
                    self.cores, rmax, algorithm, return_reached=True)
            else:
                self.cores, self._round_reached_dev = ops.round_tt_eps(
                    self.cores, eps, rmax, algorithm=algorithm, return_reached=True)
            return

        if algorithm in ("gram", "randgram"):
            if any(r is None for r in rmax):
                raise ValueError(f"algorithm='{algorithm}' requires explicit rmax")
            # Non-orthogonal factors would change the truncation's metric
            for n in range(N):
                self.factor_orthogonalize(n)
            precision = resolve_precision(None)
            solver = ops.resolve_edge_solver("rand" if algorithm == "randgram" else None,
                                             precision)
            rt = tuple(int(r) for r in rmax)
            if torch.finfo(self.dtype).eps > 1e-10:  # f32 / c64 class
                if algorithm == "gram" and precision == "highest":
                    # accuracy first: the Gram method squares the condition
                    # number, so float32 'gram' takes the SVD sweep instead
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
                        self.cores = ops.round_tt_gram_bf16(self.cores, rt, solver)
                    else:
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
        """TT rounding, then Tucker rounding with the budget left over,
        ``(1+eps)/(1+reached) - 1``, in place. The reached error comes from
        the sweep's discarded spectra where round_tt reports it (one host
        read; the worst sample of a batch), else from `relative_error`
        against a copy. The Tucker stage gets only ``rmax``, ``dim`` and
        ``algorithm``, with 'gram'/'randomized' as 'eig'."""
        from tntorch_tpu_torch.metrics import relative_error

        kernel_path = self._round_tt_computes_reached(kwargs.get("algorithm", "svd"),
                                                      kwargs.get("verbose", False))
        copy = None if kernel_path else self.clone()
        self.round_tt(eps, **kwargs)
        if self._round_reached_dev is not None:
            reached = float(self._round_reached_dev.max())
        elif copy is None:
            reached = eps  # no report and no copy: skip the Tucker stage
        else:
            reached = float(relative_error(copy, self).max())
        if reached < eps:
            tkwargs = {k: v for k, v in kwargs.items() if k in ("rmax", "dim", "algorithm")}
            if tkwargs.get("algorithm") in ("gram", "randomized"):
                tkwargs["algorithm"] = "eig"  # TT-stage-only algorithms
            self.round_tucker((1 + eps) / (1 + reached) - 1, **tkwargs)

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

    @staticmethod
    def _coordinates(k, size: int) -> np.ndarray:
        """A 1-D index array for a mode of ``size`` as int64 coordinates: a
        boolean mask of the mode's length selects its True positions (as
        NumPy reads it); integers are checked, negative ones wrapped."""
        k = np.asarray(to_numpy(k))
        if k.dtype == bool:
            if k.shape != (size,):
                raise IndexError(f"a boolean index of shape {k.shape} does not match a mode "
                                 f"of size {size}")
            return np.flatnonzero(k)
        if k.ndim != 1 or not (k.dtype.kind in "iu" or k.size == 0):
            raise IndexError(f"index arrays must be 1-D integer or boolean arrays, "
                             f"got {k.dtype} {k.shape}")
        k = k.astype(np.int64)
        if k.size and (k.min() < -size or k.max() >= size):
            raise IndexError(f"index out of range for a mode of size {size}")
        return np.where(k < 0, k + size, k)

    def _index_array(self, k, size: int) -> torch.Tensor:
        """`_coordinates` as an int64 tensor on the cores' device."""
        return torch.from_numpy(self._coordinates(k, size)).to(self.device)

    @policy_precision
    def __getitem__(self, key):
        """NumPy-style indexing over the compressed cores: int, slice, index
        array, ``None`` and ``Ellipsis``, for batch and non-batch tensors.
        A mode's Tucker factor is indexed in place of its core.

        A key of index arrays for every mode of a non-batch TT or CP tensor
        without factors and with boundary ranks 1 (a (P, N) array, or N
        arrays of length P) returns the one-core TT (1, P, 1) of the P
        values, evaluated by `TTEval` (the card's forward and backward
        kernels for real cores on the card; CP factors become TT cores
        first, `_cp_to_tt`).

        A non-batch mask Tensor with exactly one accepted string s
        (`automata.accepted_inputs`) selects, on each mode, the entries whose
        ``idxs`` (clipped to 1) equal s's symbol: an int where one entry
        does, else the slice from the first to the last (the JAX package's
        rule, for the {0, 1+} annotations of `anova_decomposition` and
        `partialset`); a batch keeps every sample (the JAX package reads
        the batch axis as a mode there and fails)."""
        if isinstance(key, Tensor):
            return self[self._mask_key(key)]
        if isinstance(key, (np.ndarray, torch.Tensor)) and key.ndim == 2:
            if self._all_modes(key):
                return self._evaluate(key)
            key = to_numpy(key)
            key = [key[:, col] for col in range(key.shape[1])]
        key = self._process_key(key)
        if self._all_modes(key):
            if len({len(k) for k in key}) > 1:
                raise ValueError("Index arrays must have the same length")
            return self._evaluate(np.stack([self._coordinates(k, size)
                                            for k, size in zip(key, self.shape)], axis=1))
        return self._getitem_impl(key)

    def _mask_key(self, mask):
        """The key of a mask Tensor (see `__getitem__`)."""
        from tntorch_tpu_torch.automata import accepted_inputs
        from tntorch_tpu_torch.metrics import sum as tn_sum

        if mask.batch:
            raise ValueError("Batch mask Tensors are not supported as indices; "
                             "index with one sample, e.g. t[mask_sample]")
        if abs(float(tn_sum(mask)) - 1) > 1e-8:
            raise ValueError("When indexing via a mask tensor, that mask should have exactly "
                             "1 accepting string")
        s = to_numpy(accepted_inputs(mask)[0])
        off = 1 if self.batch else 0
        key = [slice(None)] * off  # a batch keeps every sample
        for n in range(self.dim()):
            idx = np.minimum(np.asarray(self.idxs[n + off]).astype(np.int64), 1)
            w = np.flatnonzero(idx == s[n])
            key.append(int(w[0]) if len(w) == 1 else slice(int(w[0]), int(w[-1]) + 1))
        return tuple(key)

    def _all_modes(self, key) -> bool:
        """Whether ``key`` (a (P, N) array or a processed key) indexes every
        mode of this non-batch tensor, whose TT view (`_cp_to_tt`) has
        boundary ranks 1, with coordinate arrays. A tensor with Tucker
        factors never qualifies: its cores' middle axis is the factor's, not
        the mode's."""
        c0, cN = self.cores[0], self.cores[-1]
        first = 1 if c0.ndim == self._m else c0.shape[-3]
        last = 1 if cN.ndim == self._m and self.dim() > 1 else cN.shape[-1]
        if self.batch or first != 1 or last != 1 or any(U is not None for U in self.Us):
            return False
        if isinstance(key, (np.ndarray, torch.Tensor)):
            return key.shape[1] == self.dim()
        return len(key) == self.dim() and all(
            hasattr(k, "__len__") and np.ndim(to_numpy(k)) == 1 for k in key)

    def _evaluate(self, X):
        from tntorch_tpu_torch.ops.tt_eval import tt_eval

        with trace_annotation("tn.getitem"):
            if not isinstance(X, torch.Tensor):
                X = np.asarray(X)
                if X.dtype.kind not in "iu" and X.size:
                    raise IndexError(f"index arrays must be integer arrays, got {X.dtype}")
                X = X.astype(np.int64)
            cores = self.cores
            if any(c.ndim == self._m for c in cores):
                cores = self.tt().cores
            values = tt_eval(cores, X)
            return Tensor([values.reshape(1, -1, 1)])

    @policy_precision
    def __setitem__(self, key, value):
        """Assignment as algebra, not a write: ``self <- self - old + new``,
        where ``old`` keeps the cores' slices at ``key`` (zeros elsewhere)
        and ``new`` holds ``value`` there, so the ranks grow by both. The
        JAX package's body (its tensor.py ``__setitem__``) step by step:
        Tucker factors are multiplied in and CP factors become TT cores
        first, in ``self`` and in a Tensor ``value`` (a clone); an array
        value goes to ``self``'s device and dtype; a repeated fancy index
        keeps its last write (deduplicated on the host, with the matching
        rows of ``value``); an int batch key or mode key becomes a length-1
        slice, negative ones wrapped; a mode an int key dropped from
        ``value`` goes back at that mode's position. A mask Tensor key
        selects what it selects in `__getitem__` (the JAX package raises
        ``TypeError`` there). Each scatter writes into a fresh zero tensor,
        so autograd flows from the cores. The cores are rebuilt as leaves
        when ``self.requires_grad``, and ``frozen_Us`` is kept."""
        from tntorch_tpu_torch.tools import unsqueeze

        if isinstance(key, Tensor):  # a mask Tensor selects as in __getitem__
            key = self._mask_key(key)
        if any(U is not None for U in self.Us):
            # The scatters index cores by mode-space keys
            t2 = self.decompress_tucker_factors()
            self.cores, self.Us = t2.cores, t2.Us
        self._cp_to_tt()
        key = self._process_key(key)
        dev, dtype = self.device, self.dtype
        scalar = False
        if isinstance(value, (np.ndarray, torch.Tensor)):
            value = asarray(value, dtype=dtype, device=dev)
            if value.ndim == 0:
                value, scalar = float(value), True
            else:
                if self.batch:
                    if isinstance(key[0], (int, np.integer)):
                        value = value[None]
                    if value.ndim == 1:
                        value = value[:, None]
                value = Tensor(value, batch=self.batch)
        elif isinstance(value, Tensor):
            if any(c.ndim == value._m for c in value.cores) or any(
                    U is not None for U in value.Us):
                value = value.clone().decompress_tucker_factors()
                value._cp_to_tt()
        else:
            scalar = True

        off = 1 if self.batch else 0
        key_length = len(key) - off
        # A repeated fancy index keeps its last write (NumPy's assignment):
        # CUDA scatters leave the order of repeats undefined, so the host
        # keeps each index's last occurrence, and the matching rows of value
        for i in range(key_length):
            kk = key[i + off]
            if isinstance(kk, slice) or not hasattr(kk, "__len__"):
                continue
            arr = np.asarray(to_numpy(kk))
            if arr.ndim != 1 or arr.dtype == bool:
                continue
            arr = np.where(arr < 0, arr + int(self.shape[i + off]), arr).astype(np.int64)
            if len(np.unique(arr)) != len(arr):
                last = {int(v): p for p, v in enumerate(arr)}
                keep = np.sort(np.asarray(list(last.values()), dtype=np.int64))
                voff = 1 if (isinstance(value, Tensor) and value.batch) else 0
                if (not scalar and i < value.dim()
                        and int(value.shape[i + voff]) == len(arr)):
                    sel = [slice(None)] * (value.dim() + voff)
                    sel[i + voff] = keep.tolist()
                    value = value[tuple(sel)]
                    arr = arr[keep]
                elif scalar:
                    arr = arr[keep]
            key[i + off] = arr

        if self.batch and not isinstance(key[0], slice) and not hasattr(key[0], "__len__"):
            # An int batch key stays a length-1 slice: dropping the batch
            # axis would misalign every scatter below
            k0 = int(key[0])
            k0 = k0 + self.shape[0] if k0 < 0 else k0
            key[0] = slice(k0, k0 + 1)

        def index(k):
            return k if isinstance(k, slice) else torch.as_tensor(np.asarray(k), device=dev)

        subtract_cores, add_cores = [], []
        for i in range(key_length):
            k = i + off
            if not isinstance(key[k], slice) and not hasattr(key[k], "__len__"):
                kk = int(key[k])  # wrapped: slice(-1, 0) would be empty
                kk = kk + int(self.shape[k]) if kk < 0 else kk
                key[k] = slice(kk, kk + 1)
            sel = ((index(key[0]),) if self.batch else ()) + (..., index(key[k]), slice(None))
            core = self.cores[i]
            chunk = core[sel]
            sub = torch.zeros_like(core)
            sub[sel] = chunk
            subtract_cores.append(sub)
            sh = chunk.shape[-2]

            if scalar:
                add = torch.zeros(core.shape[:-3] + (1, core.shape[-2], 1), dtype=dtype,
                                  device=dev)
                add[sel] = 1
                if i == 0:
                    add = add * value
            else:
                if len(value.shape) != len(key):
                    # An int key dropped this mode from value: it goes back
                    # at this mode's position (the JAX package rebuilds the
                    # value densely there; a singleton mode is the same
                    # values at the value's own ranks)
                    if k >= len(value.shape) or (sh == 1 and value.shape[k] == sh):
                        value = unsqueeze(value, value.dim())
                    elif sh == 1:
                        value = unsqueeze(value, i)
                vc = value.cores[i]
                if not self.batch and chunk.shape[1] != value.shape[i]:
                    raise ValueError(
                        "{}-th dimension mismatch in tensor assignment: {} (lhs) != {} (rhs)"
                        .format(i, chunk.shape[1], value.shape[i]))
                add = torch.zeros(core.shape[:-3] + (vc.shape[-3], core.shape[-2], vc.shape[-1]),
                                  dtype=dtype, device=dev)
                add[sel] = vc.to(dtype)
            add_cores.append(add)

        result = (self - Tensor(subtract_cores, batch=self.batch)
                  + Tensor(add_cores, batch=self.batch))
        rg, frozen = self.requires_grad, set(self.frozen_Us)
        self.__init__(result.cores, result.Us, self.idxs, batch=self.batch, requires_grad=rg)
        self.frozen_Us = frozen

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
        cores, Us = [], []
        counter = 0
        first_index_dim = None

        def insert_core(core=None, k=None, U=None):
            if factors["index"] is not None:
                if factors["int"] is not None:
                    factors["index"] = join_cores(factors["int"], factors["index"])
                    factors["int"] = None
                cores.append(factors["index"])
                Us.append(None)
                factors["index"] = None
                factors["index_done"] = True
            if core is not None:
                if U is None:
                    new, nU = bsel(core[..., _steps(k, core.shape[-2], core.device), :]), None
                else:  # the factor takes the key; the core stays whole
                    new, nU = bsel(core), bsel(U[..., _steps(k, U.shape[-2], U.device), :])
                if factors["int"] is not None:
                    cores.append(join_cores(factors["int"], new))
                    factors["int"] = None
                else:
                    cores.append(new)
                Us.append(nU)

        def get_key(c, k):
            """Mode ``c`` at ``k`` (an int or a coordinate array), its Tucker
            factor absorbed (a CP factor's core is (S, R))."""
            if self.Us[c] is None:
                return bsel(self.cores[c][..., k, :])
            sl, core = bsel(self.Us[c][..., k, :]), bsel(self.cores[c])
            cp = nd(core) == 2
            if nd(sl) == 1:  # k was an int
                return einsum("~ji,~j->~i" if cp else "~ijk,~j->~ik", core, sl)
            return einsum("~ji,~aj->~ai" if cp else "~ijk,~aj->~iak", core, sl)

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
                    c = counter - 1 if batch else counter
                    insert_core(self.cores[c], k=key[i], U=self.Us[c])
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
            return Tensor([c[0] for c in cores], Us=[None if U is None else U[0] for U in Us],
                          batch=False)
        return Tensor(cores, Us=Us, batch=self.batch)

    # ------------------------------------------------------------------
    # Metrics and statistics
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

    def sum(self, **kwargs):
        from tntorch_tpu_torch.metrics import sum

        return sum(self, **kwargs)

    def mean(self, **kwargs):
        from tntorch_tpu_torch.metrics import mean

        return mean(self, **kwargs)

    def var(self, **kwargs):
        from tntorch_tpu_torch.metrics import var

        return var(self, **kwargs)

    def std(self, **kwargs):
        from tntorch_tpu_torch.metrics import std

        return std(self, **kwargs)
