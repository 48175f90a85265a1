"""Supervised learners on TT-Tucker grid tensors.

Counterpart of ``tntorch_tpu/models/learners.py``: sklearn-style
`TTRegressor` and `TTClassifier`. The model is a ``[nticks] * N`` tensor
(with one trailing class mode for the classifier) with fixed smooth factor
bases (DCT by default, `Tensor.set_factors`), so the learned function is
smooth in each feature; continuous features go onto the grid by
`interpolation.features2indices` (bounding box learned from the training
set), and training is `optimize` on the gathered entries. With
``ranks_tucker=None`` the tensor is a plain TT and ``t[idx]`` evaluates on
the card's evaluation kernels; an ensemble (``n_estimators > 1``) is a
batch tensor evaluated by `_batch_gather`.

``key=`` takes an int seed or a ``torch.Generator``. An int seeds CPU
generators (one for the initial tensor, one for the bootstrap rows), so the
card and the CPU start from the same numbers; a generator is drawn from in
turn. Neither gives the JAX package's numbers. ``device=`` places the model
and the data (default: `default_device`).

``mesh=`` (a ``DeviceMesh`` with a 'dp' axis, `parallel`; every rank fits
with the same arguments) trains data-parallel, as the JAX package does:
`optimize` replicates the model from rank 0, and the training rows (a
single model's samples, an ensemble's members with their rows) shard over
'dp' by `parallel.shard_array` where its size divides them. Each rank then
evaluates its rows on its replica (an ensemble: its members' slice of the
batch cores, at its members' rows) and the loss is the sum of every rank's
terms over the global count, so each gradient is a partial sum that
`optimize` all-reduces. Where 'dp' does not divide them, every rank
computes the whole loss. After the fit each rank holds the whole model as
plain tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from tntorch_tpu_torch.interpolation import features2indices, get_bounding_box
from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import default_device, default_dtype, to_numpy


def _batch_gather(t, idx):
    """Every member of a batch TT-Tucker tensor at integer index rows.

    ``idx`` is ``(B, P, N)`` (rows per member, e.g. bootstrap resamples) or
    ``(P, N)`` for all members. Returns ``(B, P)`` when every mode is
    indexed, or ``(B, P, I_last)`` when ``N == t.dim() - 1`` (the
    classifier's free class mode): gathers and one einsum chain for all
    members at once.
    """
    B = t.cores[0].shape[0]
    idx = torch.as_tensor(idx, device=t.device).long()
    if idx.ndim == 2:
        idx = idx[None].expand((B,) + idx.shape)
    P, N = idx.shape[1:]
    res = None
    for n in range(N):
        core = t.cores[n]  # (B, r, K, s)
        U = t.Us[n]
        if U is None:
            rows = idx[:, None, :, n, None].expand(B, core.shape[1], P, core.shape[3])
            C = torch.gather(core, 2, rows).permute(0, 2, 1, 3)  # (B, P, r, s)
        else:
            Ue = torch.gather(U, 1, idx[:, :, n, None].expand(B, P, U.shape[2]))  # (B, P, K)
            C = torch.einsum("bpk,brks->bprs", Ue, core)
        res = C[:, :, 0, :] if res is None else torch.einsum("bpr,bprs->bps", res, C)
    if N == t.dim():
        return res[..., 0]
    if N != t.dim() - 1:
        raise ValueError(f"index rows of {N} columns for a tensor of {t.dim()} modes")
    mat = t.cores[-1][..., 0]  # (B, r, K)
    if t.Us[-1] is not None:
        mat = torch.einsum("brk,bck->brc", mat, t.Us[-1])
    return torch.einsum("bpr,brc->bpc", res, mat)


class _TTLearner:
    """What `TTRegressor` and `TTClassifier` share."""

    _has_class_mode = False

    def __init__(
        self,
        nticks: int = 64,
        ranks_tt: int = 10,
        ranks_tucker: Optional[int] = 8,
        basis: str = "dct",
        max_iter: int = 4000,
        tol: float = 1e-7,
        optimizer=None,
        verbose: bool = False,
        domain: Optional[Sequence] = None,
        n_estimators: int = 1,
        bootstrap: bool = True,
        mesh=None,
        key: Union[int, torch.Generator, None] = None,
        device=None,
    ):
        if mesh is not None and "dp" not in mesh.mesh_dim_names:
            raise ValueError(
                "Learner mesh must have a 'dp' axis to shard samples/members over "
                f"(got axes {mesh.mesh_dim_names}); build it with tn.parallel.make_mesh()")
        self.nticks = int(nticks)
        self.ranks_tt = ranks_tt
        self.ranks_tucker = ranks_tucker
        self.basis = basis
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.optimizer = optimizer
        self.verbose = verbose
        self.domain = domain
        self.n_estimators = int(n_estimators)
        self.bootstrap = bool(bootstrap)
        self.mesh = mesh
        self.key = 0 if key is None else key
        self.device = torch.device(device or default_device())
        self.tensor_ = None
        self.bbox_ = None
        self.losses_ = None

    def _generator(self, stream: int) -> torch.Generator:
        """The generator of one stream of draws: 0 for the initial tensor,
        17 for the bootstrap rows (the JAX package folds 17 into its key)."""
        if isinstance(self.key, torch.Generator):
            return self.key
        return torch.Generator().manual_seed(int(self.key) * 1_000_003 + stream)

    # -- feature handling ------------------------------------------------
    def _fit_grid(self, X):
        X = np.asarray(to_numpy(X), dtype=np.float64)
        if X.ndim != 2:
            raise ValueError(f"X must be (P, N), got shape {X.shape}")
        if self.domain is not None and len(self.domain) != X.shape[1]:
            raise ValueError(
                f"domain has {len(self.domain)} axes but X has {X.shape[1]} features")
        if self.domain is None:
            # Widen the box a hair so that test points at the training
            # extremes do not all fall on the boundary ticks
            self.bbox_ = [(lo - 1e-12 - 0.025 * (hi - lo), hi + 1e-12 + 0.025 * (hi - lo))
                          for (lo, hi) in get_bounding_box(X)]
        return X

    def _indices(self, X):
        X = np.asarray(to_numpy(X), dtype=np.float64)
        if self.domain is not None:
            return features2indices(X, domain=self.domain, device=self.device)
        return features2indices(X, bbox=self.bbox_, I=self.nticks, device=self.device)

    def _grid_shape(self, N):
        if self.domain is not None:
            return [len(d) for d in self.domain]
        return [self.nticks] * N

    def _make_tensor(self, shape):
        from tntorch_tpu_torch.create import rand

        B = self.n_estimators
        t = rand(([B] + list(shape)) if B > 1 else list(shape), ranks_tt=self.ranks_tt,
                 ranks_tucker=self.ranks_tucker, requires_grad=True, batch=B > 1,
                 device=self.device, generator=self._generator(0))
        if self.basis is not None and self.ranks_tucker is not None:
            # Fixed smooth bases on the feature modes only (the class mode,
            # where there is one, keeps its free factor)
            nfeat = len(shape) - (1 if self._has_class_mode else 0)
            t.set_factors(self.basis, dim=range(nfeat))
        return t

    def _member_rows(self, P):
        """(B, P) training rows per ensemble member: bootstrap resamples
        (bagging), or every row for plain random-restart ensembles."""
        if self.bootstrap:
            g = self._generator(17)
            return torch.randint(0, P, (self.n_estimators, P), generator=g,
                                 device=g.device).to(self.device)
        return torch.arange(P, device=self.device).expand(self.n_estimators, P)

    def _key(self, idx):
        """``idx`` as the tensor's key: the device tensor where it indexes
        every mode of a plain TT (the evaluation kernels), else a host
        array (the compressed indexing reads its keys on the host)."""
        return idx if self.tensor_._all_modes(idx) else idx.cpu().numpy()

    def _shard(self, *arrs):
        """The training arrays with their leading axis (samples for a single
        model, members for an ensemble) sharded over the mesh's 'dp' axis
        by `parallel.shard_array` (rank 0's copies), where its size divides
        them, as the JAX package shards them; else as they are."""
        if self.mesh is None:
            return arrs
        from tntorch_tpu_torch.parallel.algorithms import shard_array
        from tntorch_tpu_torch.parallel.mesh import _size

        k = _size(self.mesh, "dp")
        if k == 1 or arrs[0].shape[0] % k:
            return arrs
        return tuple(shard_array(a, self.mesh) for a in arrs)

    def _on_rank(self, t, *data):
        """The model and the training arrays as this rank computes on them:
        without a mesh, as they are; with one, the replicated cores and
        factors as plain tensors, whose gradients are this rank's partial
        sums over 'dp' where the arrays are sharded (an ensemble cut to this
        rank's members), and the arrays' local rows."""
        if self.mesh is None:
            return (t, *data)
        from torch.distributed.tensor import Partial, Replicate

        from tntorch_tpu_torch.parallel.mesh import local_rows

        mesh = self.mesh
        sharded = hasattr(data[0], "to_local")
        grads = [Partial() if sharded and name == "dp" else Replicate()
                 for name in mesh.mesh_dim_names]

        def local(x):
            if x is None:
                return None
            x = x.to_local(grad_placements=grads) if hasattr(x, "to_local") else x
            return local_rows(x, mesh, "dp") if sharded and t.batch else x

        model = Tensor([local(c) for c in t.cores], Us=[local(U) for U in t.Us], batch=t.batch)
        return (model, *(x.to_local() if hasattr(x, "to_local") else x for x in data))

    @staticmethod
    def _mean(terms, like):
        """The mean of the loss terms of every rank's rows: ``terms`` are
        this rank's, shaped as its rows of ``like``. Where ``like`` is
        sharded, each rank's terms over the global count, summed over the
        ranks (a partial sum that `optimize` reduces)."""
        if not hasattr(like, "to_local"):
            return terms.mean()
        from tntorch_tpu_torch.parallel.mesh import _wrap

        return _wrap(terms / like.numel(), like.device_mesh, list(like.placements),
                     like.shape).sum()

    def _optimize(self, loss):
        from tntorch_tpu_torch.autodiff import optimize

        self.losses_ = optimize(self.tensor_, loss, optimizer=self.optimizer, tol=self.tol,
                                max_iter=self.max_iter, verbose=self.verbose, mesh=self.mesh)
        if self.mesh is not None:
            # every rank keeps the whole model, as plain tensors
            t = self.tensor_
            t.cores = [c.to_local().detach().requires_grad_(True) for c in t.cores]
            t.Us = [U.to_local().detach().requires_grad_(True) if hasattr(U, "to_local") else U
                    for U in t.Us]
        return self


class TTRegressor(_TTLearner):
    """Least-squares regression on a smooth TT-Tucker grid tensor.

    >>> reg = tn.TTRegressor(nticks=64, ranks_tt=8)
    >>> reg.fit(X, y).predict(Xtest)

    The target is standardized internally; ``score`` returns R². The fixed
    smooth factor basis is what lets the grid tensor generalize between
    training points (``basis=None``, free factors, memorizes the visited
    cells).
    """

    def fit(self, X, y):
        X = self._fit_grid(X)
        y = np.asarray(to_numpy(y), dtype=np.float64).reshape(-1)
        if len(y) != len(X):
            raise ValueError(f"X has {len(X)} rows but y has {len(y)}")
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yt = torch.from_numpy((y - self._y_mean) / self._y_std).to(self.device, default_dtype())
        idx = self._indices(X)
        self.tensor_ = self._make_tensor(self._grid_shape(X.shape[1]))

        if self.n_estimators > 1:
            sel = self._member_rows(len(y))
            IDX, Y = self._shard(idx[sel], yt[sel])

            def loss(t):
                m, IDXl, Yl = self._on_rank(t, IDX, Y)
                return self._mean((_batch_gather(m, IDXl) - Yl) ** 2, Y)
        else:
            idx, yt = self._shard(idx, yt)
            key = self._key(idx.to_local() if hasattr(idx, "to_local") else idx)

            def loss(t):
                m, yl = self._on_rank(t, yt)
                return self._mean((m[key].full() - yl) ** 2, yt)

        return self._optimize(loss)

    def predict(self, X):
        if self.tensor_ is None:
            raise ValueError("fit must be called before predict")
        idx = self._indices(X)
        with torch.no_grad():
            if self.n_estimators > 1:
                pred = _batch_gather(self.tensor_, idx).mean(0)
            else:
                pred = self.tensor_[self._key(idx)].full()
        return pred * self._y_std + self._y_mean

    def score(self, X, y):
        """The coefficient of determination R² (sklearn's convention)."""
        y = np.asarray(to_numpy(y), dtype=np.float64).reshape(-1)
        pred = np.asarray(to_numpy(self.predict(X)), dtype=np.float64)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum()) or 1.0
        return 1.0 - ss_res / ss_tot


class TTClassifier(_TTLearner):
    """Multi-class classification: a ``[*grid, C]`` logit tensor trained
    with softmax cross-entropy. ``predict_proba`` returns (P, C)
    probabilities in the order of ``classes_``."""

    _has_class_mode = True

    def fit(self, X, y):
        X = self._fit_grid(X)
        y = np.asarray(to_numpy(y)).reshape(-1)
        if len(y) != len(X):
            raise ValueError(f"X has {len(X)} rows but y has {len(y)}")
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        C = len(self.classes_)
        if C < 2:
            raise ValueError("need at least 2 classes")
        yt = torch.from_numpy(y_enc.reshape(-1).astype(np.int64)).to(self.device)
        idx = self._indices(X)
        self.tensor_ = self._make_tensor(self._grid_shape(X.shape[1]) + [C])

        if self.n_estimators > 1:
            sel = self._member_rows(len(y))
            IDX, Y = self._shard(idx[sel], yt[sel])

            def loss(t):
                m, IDXl, Yl = self._on_rank(t, IDX, Y)
                logp = torch.log_softmax(_batch_gather(m, IDXl), dim=-1)  # (B, P, C)
                return self._mean(-torch.gather(logp, 2, Yl[..., None])[..., 0], Y)
        else:
            idx, yt = self._shard(idx, yt)
            key = self._key(idx.to_local() if hasattr(idx, "to_local") else idx)

            def loss(t):
                m, yl = self._on_rank(t, yt)
                # a (P, N) key leaves the class mode free: (P, C) logits
                logp = torch.log_softmax(m[key].full(), dim=-1)
                return self._mean(-torch.gather(logp, 1, yl[:, None])[:, 0], yt)

        return self._optimize(loss)

    def predict_proba(self, X):
        if self.tensor_ is None:
            raise ValueError("fit must be called before predict")
        idx = self._indices(X)
        with torch.no_grad():
            if self.n_estimators > 1:
                # bagging: the members' probabilities averaged
                return torch.softmax(_batch_gather(self.tensor_, idx), dim=-1).mean(0)
            return torch.softmax(self.tensor_[self._key(idx)].full(), dim=-1)

    def predict(self, X):
        return self.classes_[to_numpy(self.predict_proba(X).argmax(-1))]

    def score(self, X, y):
        """The mean accuracy."""
        y = np.asarray(to_numpy(y)).reshape(-1)
        return float((self.predict(X) == y).mean())
