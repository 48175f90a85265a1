"""The tensor-network container: tensor trains with optional Tucker factors.

Counterpart of ``tntorch_tpu/tensor.py``. A `Tensor` holds N TT cores
(R_{n-1} x S_n x R_n), with a leading batch axis B on every core when
``batch=True``; mode n may carry a Tucker factor U_n (I_n x S_n, or
B x I_n x S_n), in which case the core's middle axis is the factor's
S_n and the mode's size is I_n. Cores and factors are ``torch.Tensor``s on
one device, chosen by the caller (``device=``); every method works where
they are, and the batched Gram rounding runs on the card's kernels when
they are on the card.

Data without a device (NumPy arrays, lists) lands on the package's default
device, the CUDA card (`utils.default_device`); ``device="cpu"`` keeps it on
the CPU. A dense array decomposes exactly (full rank), or to
``ranks_tt=``/``ranks_tucker=`` (TT-SVD, Tucker rounding; ``algorithm=
'gram'``/``'randomized'`` for the fixed-rank kernels of
`ops.decomposition`), or to an error budget ``eps=`` (`round`). Indexing
(``t[key]``) follows NumPy over the compressed cores; a key that indexes
every mode of a TT without factors with coordinate arrays evaluates it
through `ops.tt_eval.TTEval`, the card's evaluation kernels.
``requires_grad=True`` makes the cores and factors leaf tensors for
autograd and `optimize`. Division by a Tensor (``t / t2``, ``2.0 / t``)
and ``**`` are cross approximations (`tn.reciprocal`, `tn.cross`). Each
mode carries an index annotation ``idxs`` (NumPy; ``arange`` by default,
with a leading ``arange(B)`` for a batch), as in the JAX package.

CP cores (``ranks_cp=``), ``__setitem__`` and mask-Tensor keys are not
ported yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from tntorch_tpu_torch.utils import asarray, logger, policy_precision, to_numpy, trace_annotation


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


def _not_ported_stub(name: str, item: str):
    """A function ``name`` that raises `_not_ported` for ``tn.name``."""
    def stub(*args, **kwargs):
        raise _not_ported(f"tn.{name}", item)

    stub.__name__ = stub.__qualname__ = name
    stub.roadmap_item = item
    return stub


def _not_ported_module(name: str, item: str) -> types.ModuleType:
    """A stand-in for the JAX package's submodule ``name``: every public
    attribute raises `_not_ported` for ``tn.name.attr``."""
    module = types.ModuleType(f"tntorch_tpu_torch.{name}",
                              f"Not ported yet (ROADMAP.md, {item}).")

    def __getattr__(attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise _not_ported(f"tn.{name}.{attr}", item)

    module.__getattr__ = __getattr__
    module.roadmap_item = item
    return module


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
    when ``spatial`` (two Tucker cores); the left operand's dtype."""
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


class Tensor:
    """A tensor train with optional Tucker factors, or a batch of B of them
    of one shape."""

    def __init__(self, data, Us=None, idxs=None, device=None, requires_grad=None,
                 ranks_cp=None, ranks_tucker=None, ranks_tt=None, eps=None,
                 max_iter: int = 25, tol: float = 1e-4, verbose: bool = False,
                 batch: bool = False, algorithm: str = "svd", dtype=None):
        """Build from a list of TT cores (and optional Tucker factors
        ``Us``), or from a dense array: exactly (full rank), to
        ``ranks_tt``/``ranks_tucker``, or to the relative error ``eps``.
        ``device``/``dtype`` move and cast the cores and factors. The
        parameters are the JAX package's, in its order; ``max_iter``,
        ``tol`` and ``verbose`` steer CP-ALS, which is not ported, and
        change nothing here. ``algorithm`` picks the rounding ('svd',
        'eig'), or for ``ranks_tt`` alone the fixed-rank TT-SVD kernels
        ('gram', 'randomized')."""
        if ranks_cp is not None:
            raise _not_ported("CP-ALS (ranks_cp=)", "queue 1 item 3")
        if eps is not None and (ranks_tucker is not None or ranks_tt is not None):
            raise ValueError("Specify eps or ranks, but not both")
        self.batch = bool(batch)
        self.requires_grad = bool(requires_grad)  # None means False
        # Modes whose Tucker factor is fixed: not trained by optimize, not
        # counted by dof
        self.frozen_Us = set()
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
            self.Us = self._factors(Us, dtype)
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
            a, b = this.tt().cores[0], other.tt().cores[0]
            return Tensor([a + b], batch=self.batch)

        cores, Us = [], []
        for n in range(this.dim()):
            core1, core2 = this.cores[n], other.cores[n]
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
        # Boundary rank-1 collapses
        d = 1 if self.batch else 0
        cores[0] = cores[0].sum(dim=d, keepdim=True)
        cores[-1] = cores[-1].sum(dim=-1, keepdim=True)
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
                if self.batch and arr.ndim == 1:
                    factor, sign = factor.reshape(-1, 1, 1, 1), sign.reshape(-1, 1, 1, 1)
                result.cores = [c * factor.to(c.device, c.dtype) for c in result.cores]
                c0 = result.cores[0]
                result.cores[0] = c0 * sign.to(c0.device, c0.dtype)
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
                continue
            if U1 is not None:
                core1 = _absorb(core1, U1)
            if U2 is not None:
                core2 = _absorb(core2, U2)
            cores.append(_core_kron(core1, core2, self.batch))
            Us.append(None)
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
        first = self.cores[0].shape[1 if self.batch else 0]
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
        s = "{}D {} tensor:\n\n".format(N, "TT-Tucker" if tucker else "TT")
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
                cores.append(_absorb(c, U))
                Us.append(None)
            else:
                cores.append(c)
                Us.append(U)
        return Tensor(cores, Us=Us, idxs=getattr(self, "idxs", None), batch=self.batch)

    def tt(self):
        """The same tensor as a plain TT (factors multiplied in)."""
        return self.decompress_tucker_factors()

    @policy_precision
    def full(self) -> torch.Tensor:
        """Decompress to a dense torch tensor on the cores' device."""
        t = self.decompress_tucker_factors()
        c0 = t.cores[0]
        bshape = (c0.shape[0],) if self.batch else ()
        factor = torch.ones(bshape + (1, int(self.ranks_tt[0])), dtype=c0.dtype, device=c0.device)
        for core in t.cores:
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
        return self.full().detach().cpu().numpy()

    def to(self, device):
        """Move the cores and factors to ``device``, in place; returns self."""
        self.cores = [c.to(device) for c in self.cores]
        self.Us = [None if U is None else U.to(device) for U in self.Us]
        return self

    def _cp_to_tt(self, factor=None):
        """TT cores are already TT: a no-op (CP cores are not ported)."""
        tt_ndim = 4 if self.batch else 3
        for c in self.cores if factor is None else [factor]:
            if c.ndim != tt_ndim:
                raise _not_ported("CP cores", "queue 1 item 3")
        return factor

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
        self.cores[mu] = _absorb(self.cores[mu], R)

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
        kernel = algorithm in ("eig", "svd") and all(U is None for U in self.Us)
        if kernel and self.batch:
            with trace_annotation("tn.round_tucker:batch_kernel"):
                self.cores, self.Us = ops.round_tucker_eps_batch(
                    self.cores, self._eyes(), rmax=rmax, dims=dim, algorithm=algorithm)
            return
        if kernel:
            with trace_annotation("tn.round_tucker:eps_kernel"):
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
        from tntorch_tpu_torch.ops import rounding as ops
        from tntorch_tpu_torch.utils import resolve_precision

        N = self.dim()
        rmax = _rmax_per_mode(rmax, N - 1)
        self._round_reached_dev = None

        if self._round_tt_computes_reached(algorithm, verbose):
            with trace_annotation("tn.round_tt:eps_sweep"):
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

        A key of index arrays for every mode of a non-batch TT without
        factors and with boundary ranks 1 (a (P, N) array, or N arrays of
        length P) returns the one-core TT (1, P, 1) of the P values,
        evaluated by `TTEval` (the card's forward and backward kernels for
        real cores on the card). Mask-Tensor keys are not ported."""
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
            return self._evaluate(np.stack([self._coordinates(k, size)
                                            for k, size in zip(key, self.shape)], axis=1))
        return self._getitem_impl(key)

    def _all_modes(self, key) -> bool:
        """Whether ``key`` (a (P, N) array or a processed key) indexes every
        mode of this non-batch, boundary-rank-1 TT with coordinate arrays.
        A tensor with Tucker factors never qualifies: its cores' middle axis
        is the factor's, not the mode's."""
        if (self.batch or self.ranks_tt[0] != 1 or self.ranks_tt[-1] != 1
                or any(U is not None for U in self.Us)):
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
            factor absorbed."""
            if self.Us[c] is None:
                return bsel(self.cores[c][..., k, :])
            sl, core = bsel(self.Us[c][..., k, :]), bsel(self.cores[c])
            if nd(sl) == 1:  # k was an int
                return einsum("~ijk,~j->~ik", core, sl)
            return einsum("~ijk,~aj->~iak", core, sl)

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
