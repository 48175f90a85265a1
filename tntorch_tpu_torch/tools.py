"""Manipulation and multilinear algebra on compressed tensors.

Counterpart of ``tntorch_tpu/tools.py``: array-like manipulation
(``squeeze``, ``unsqueeze``, ``cat``, ``transpose``, ``flip``, ``unbind``,
``pad``, ``stack``, ``meshgrid``, the unfoldings), ``ttm`` (tensor times
matrix along modes), ``mask``, ``sample`` (points drawn from a tensor read
as a PMF), ``hash``, ``generate_basis`` (the Tucker bases of
`Tensor.set_factors`), ``reduce`` (a rounded binary-tree fold),
``convolve`` (FFT of the cores and TT-cross) and ``shift_mode`` (pairwise
SVD swaps). The mode axis of every core and factor is axis -2, batch or
not, CP factors (I, R) included: the tools keep CP factors as they are,
except ``sample``, ``convolve`` and ``shift_mode``, which work on the TT
view (`Tensor.tt`; ``shift_mode`` converts ``t`` in place, as its
orthogonalization does).

Two draws cannot be the JAX package's, whose keys torch cannot replay:
``sample``'s uniforms (`_sample_uniforms`) and ``hash``'s weights
(`_hash_weights`); each sits behind its helper so that a test can put the
JAX package's numbers in.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import asarray, default_device, default_dtype, policy_precision


def squeeze(t, dim=None):
    """Remove singleton modes (all of them, or those in ``dim``). ``dim``
    counts modes: a batch tensor's batch axis is never squeezed."""
    off = 1 if t.batch else 0
    mode_shape = np.array(t.shape[off:])
    if dim is None:
        dim = np.where(mode_shape == 1)[0]
    if not hasattr(dim, "__len__"):
        dim = [dim]
    dim = [d + t.dim() if d < 0 else int(d) for d in dim]
    if not np.all(mode_shape[dim] == 1):
        raise ValueError(f"squeeze: modes {dim} of shape {tuple(mode_shape)} are not all 1")
    idx = [slice(None)] * (t.dim() + off)
    for m in dim:
        idx[m + off] = 0
    return t[tuple(idx)]


def unsqueeze(t, dim):
    """Insert singleton modes at the positions ``dim`` (counting modes; a
    batch tensor keeps its batch axis first)."""
    if not hasattr(dim, "__len__"):
        dim = [dim]
    off = 1 if t.batch else 0
    idx = [slice(None)] * (t.dim() + off + len(dim))
    for d in dim:
        idx[d + off] = None
    return t[tuple(idx)]


@policy_precision
def ttm(t, U, dim=None, transpose: bool = False):
    """Tensor times matrix along one or several modes: mode ``dim[j]`` is
    multiplied by ``U[j]`` (J x I_n; ``transpose`` takes I_n x J). A vector
    (I_n,) contracts the mode to size 1; in a batch, an (B, I_n) matrix is
    one vector per sample. A mode with a Tucker factor multiplies the
    factor, a mode without one its core. Factors without a device join the
    tensor's."""
    if not isinstance(U, (list, tuple)):
        U = [U]
    U = [asarray(u, device=t.device) for u in U]
    if dim is None:
        dim = range(len(U))
    if not hasattr(dim, "__len__"):
        dim = [dim]
    dim = [d + t.dim() if d < 0 else d for d in dim]
    cores, Us = [], []
    for n in range(t.dim()):
        if n not in dim:
            cores.append(t.cores[n])
            Us.append(t.Us[n])
            continue
        factor = U[dim.index(n)]
        if transpose:
            factor = factor.transpose(-1, -2)
        if factor.ndim == 1:
            factor = factor[None]  # one row; broadcasts over a batch
        elif factor.ndim == 2 and t.batch:
            factor = factor[:, None]  # (B, I): one row per sample
        dtype = torch.promote_types(t.dtype, factor.dtype)
        factor = factor.to(dtype)
        if t.Us[n] is None:
            spec = "...ai,...ja->...ji" if t.cores[n].ndim == t._m else "...iak,...ja->...ijk"
            cores.append(torch.einsum(spec, t.cores[n].to(dtype), factor))
            Us.append(None)
        else:
            cores.append(t.cores[n])
            Us.append(factor @ t.Us[n].to(dtype))
    return Tensor(cores, Us=Us, batch=t.batch)


def meshgrid(*axes, batch: bool = False, device=None):
    """The N rank-1 tensors of a grid: tensor n holds mode n's coordinates,
    constant along the other modes. An axis is a vector of coordinates or a
    size (``arange``); each is cast to `default_dtype` (torch's default,
    float32 unless the caller sets another), as the JAX package casts to
    its own default. Vectors that are not torch tensors, and sizes, land on
    ``device`` (default: `default_device`). The ones-cores are shared
    between the N tensors, as in the JAX package."""
    if not hasattr(axes, "__len__"):
        axes = [axes]
    if hasattr(axes[0], "__len__"):
        axes = axes[0]
    axes = list(axes)
    N = len(axes)
    dtype = default_dtype()
    for n in range(N):
        if not hasattr(axes[n], "__len__"):
            axes[n] = torch.arange(axes[n], dtype=dtype, device=device or default_device())
        else:
            axes[n] = asarray(axes[n], dtype=dtype, device=device)
    ones = [torch.ones((1, ax.shape[0], 1), dtype=dtype, device=ax.device) for ax in axes]
    tensors = []
    for n in range(N):
        cores = list(ones)
        cores[n] = axes[n][None, :, None]
        tensors.append(Tensor(cores, batch=batch))
    return tensors


def stack(ts):
    """Stack non-batch tensors of one shape into one batch Tensor, at the
    largest rank of each edge: each sample becomes a plain TT, its cores
    zero-padded to those ranks (so samples of different ranks stack). The
    inverse is ``[t[b] for b in range(B)]``."""
    ts = list(ts)
    if not ts:
        raise ValueError("stack expects at least one tensor")
    if any(t.batch for t in ts):
        raise ValueError("stack expects non-batch tensors (already-batched input)")
    shape = tuple(ts[0].shape)
    for t in ts[1:]:
        if tuple(t.shape) != shape:
            raise ValueError(f"stack expects equal shapes, got {tuple(t.shape)} vs {shape}")
    ts = [t.tt() for t in ts]
    N = len(shape)
    rmaxs = [max(int(t.ranks_tt[k]) for t in ts) for k in range(N + 1)]
    bcores = []
    for n in range(N):
        padded = [torch.nn.functional.pad(t.cores[n], (0, rmaxs[n + 1] - t.cores[n].shape[2],
                                                       0, 0, 0, rmaxs[n] - t.cores[n].shape[0]))
                  for t in ts]
        bcores.append(torch.stack(padded))
    return Tensor(bcores, batch=True)


def cat(*ts, dim):
    """Concatenate along the mode ``dim``: each tensor's core (or factor)
    is zero-padded along the mode to the joint length, and the padded
    tensors are summed (their ranks add)."""
    if hasattr(ts[0], "__len__"):
        ts = ts[0]
    if len(ts) == 1:
        return ts[0].clone()
    if dim < 0:
        dim += ts[0].dim()
    off = 1 if ts[0].batch else 0
    if any(t.shape[n + off] != ts[0].shape[n + off]
           for t in ts[1:] for n in range(ts[0].dim()) if n != dim):
        raise ValueError(
            "To concatenate tensors, all must have the same shape along all but the given dim")
    bounds = np.concatenate([[0], np.cumsum([t.shape[dim + off] for t in ts])])
    result = None
    for i, t in enumerate(ts):
        t = t.clone()
        pad = (0, 0, int(bounds[i]), int(bounds[-1] - bounds[i + 1]))
        if t.Us[dim] is None:
            t.cores[dim] = F.pad(t.cores[dim], pad)
        else:
            t.Us[dim] = F.pad(t.Us[dim], pad)
        result = t if result is None else result + t
    return result


def transpose(t):
    """Reverse the order of the modes: each TT core swaps its rank axes (a
    batch keeps its leading axis; a CP factor is symmetric in its rank),
    factors and ``idxs`` follow their modes."""
    off = 1 if t.batch else 0
    perm = (0, 3, 2, 1) if off else (2, 1, 0)
    n_order = range(t.dim() - 1, -1, -1)
    return Tensor([t.cores[n] if t.cores[n].ndim == t._m else t.cores[n].permute(perm)
                   for n in n_order], [t.Us[n] for n in n_order],
                  idxs=t.idxs[:off] + [t.idxs[n + off] for n in n_order], batch=t.batch)


def flip(t, dim):
    """Reverse the order along the modes ``dim``."""
    if not hasattr(dim, "__len__"):
        dim = [dim]
    result = t.clone()
    for d in dim:
        if d < 0:
            d += t.dim()
        if result.Us[d] is not None:
            result.Us[d] = torch.flip(result.Us[d], dims=[-2])
        else:
            result.cores[d] = torch.flip(result.cores[d], dims=[-2])
    return result


def unbind(t, dim):
    """The slices of ``t`` along the mode ``dim``, as a list (batch slices
    for a batch)."""
    if dim < 0:
        dim += t.dim()
    off = 1 if t.batch else 0
    return [t[tuple([slice(None)] * (dim + off) + [sl] + [slice(None)] * (t.dim() - 1 - dim))]
            for sl in range(t.shape[dim + off])]


def unfolding(data, n, batch: bool = False):
    """The mode-``n`` unfolding of a dense array, (I_n, rest), or (B, I_n,
    rest) for a batch."""
    data = asarray(data)
    if batch:
        perm = [0, n + 1] + list(range(1, n + 1)) + list(range(n + 2, data.ndim))
        return data.permute(perm).reshape(data.shape[0], data.shape[n + 1], -1)
    perm = [n] + list(range(n)) + list(range(n + 1, data.ndim))
    return data.permute(perm).reshape(data.shape[n], -1)


def right_unfolding(core, batch: bool = False):
    """The R_{n-1} x (I_n R_n) matricization of a core."""
    if batch:
        return core.reshape(core.shape[0], core.shape[1], -1)
    return core.reshape(core.shape[0], -1)


def left_unfolding(core, batch: bool = False):
    """The (R_{n-1} I_n) x R_n matricization of a core."""
    if batch:
        return core.reshape(core.shape[0], -1, core.shape[-1])
    return core.reshape(-1, core.shape[-1])


def pad(t, shape, dim=None, fill_value=0):
    """Pad the modes ``dim`` (default: all) to the sizes ``shape``. The
    first padded mode's new entries hold ``fill_value`` and the others'
    zeros, as in the JAX package."""
    if dim is None:
        dim = range(t.dim())
    if not hasattr(dim, "__len__"):
        dim = [dim]
    if not hasattr(shape, "__len__"):
        shape = [shape] * len(dim)
    t = t.clone()
    for i in range(len(dim)):
        d = dim[i] + t.dim() if dim[i] < 0 else dim[i]
        mult = fill_value if i == 0 else 0
        x = t.cores[d] if t.Us[d] is None else t.Us[d]
        extra = mult * torch.ones(x.shape[:-2] + (shape[i] - x.shape[-2], x.shape[-1]),
                                  dtype=x.dtype, device=x.device)
        x = torch.cat([x, extra], dim=-2)
        if t.Us[d] is None:
            t.cores[d] = x
        else:
            t.Us[d] = x
    return t


def mask(t, mask):
    """The elementwise product of ``t`` with the non-batch tensor ``mask``,
    read at ``t``'s index annotations (``idxs``; coordinates past the
    mask's size take its last entry). A batch ``t`` takes the same mask for
    every sample."""
    off = 1 if t.batch else 0
    cores, Us = [], []
    for n in range(t.dim()):
        idx = np.array(t.idxs[n + off]).astype(np.int64)
        idx[idx >= mask.shape[n]] = mask.shape[n] - 1
        if mask.Us[n] is None:
            c = mask.cores[n]
            cores.append(c[..., torch.from_numpy(idx).to(c.device), :])
            Us.append(None)
        else:
            cores.append(mask.cores[n])
            Us.append(mask.Us[n][torch.from_numpy(idx).to(mask.Us[n].device), :])
    if t.batch:
        B = t.shape[0]
        cores = [c.expand((B,) + c.shape) for c in cores]
        Us = [None if U is None else U.expand((B,) + U.shape) for U in Us]
    return t * Tensor(cores, Us, batch=t.batch)


def _sample_uniforms(N: int, P: int, dtype, device, seed=None) -> list:
    """The N (P, 1) uniform [0, 1) draws of `sample`, one per mode, from a
    generator on ``device`` seeded with ``seed`` (or fresh entropy). The
    JAX package draws ``jax.random.uniform(split(key(seed), N)[mu], (P, 1))``,
    which torch cannot replay."""
    from tntorch_tpu_torch.utils import next_key, seed as seeded

    g = next_key(device=device) if seed is None else seeded(seed, device)
    return [torch.rand((P, 1), generator=g, dtype=dtype, device=device) for _ in range(N)]


@policy_precision
def _sample_rows(cores, uniforms) -> torch.Tensor:
    """Sequential conditional sampling from the TT ``cores`` read as an
    unnormalized PMF (absolute values), with the given (P, 1) uniforms per
    mode: per mode, the suffix is marginalized by a right-product chain,
    the P conditional PMFs come from one product, and their CDFs are
    inverted. Returns the (P, N) coordinates."""
    rights = [torch.ones((1,), dtype=cores[0].dtype, device=cores[0].device)]
    for core in cores[::-1]:
        rights.append(core.sum(1) @ rights[-1])
    rights = rights[::-1]
    P = uniforms[0].shape[0]
    lefts = torch.ones((P, 1), dtype=cores[0].dtype, device=cores[0].device)
    Xs = []
    for mu, core in enumerate(cores):
        fiber = torch.einsum("ijk,k->ij", core, rights[mu + 1])
        p = (lefts @ fiber).abs()  # (P, I)
        p = p / p.sum(1, keepdim=True)
        cdf = torch.cumsum(p, 1)
        rows = torch.clamp((cdf < uniforms[mu]).sum(1), max=core.shape[1] - 1)
        Xs.append(rows)
        lefts = torch.einsum("ij,jik->ik", lefts, core[:, rows, :])
    return torch.stack(Xs, dim=1)


def sample(t, P: int = 1, seed=None) -> torch.Tensor:
    """Draw P integer points (with replacement) from ``t`` read as an
    unnormalized PMF: a (P, N) int64 tensor on ``t``'s device. ``seed``
    seeds the uniforms (`_sample_uniforms`); without one they come from
    fresh entropy."""
    t2 = t.tt()
    us = _sample_uniforms(t2.dim(), int(P), t2.cores[0].real.dtype, t2.device, seed)
    return _sample_rows(t2.cores, us)


def _hash_weights(shape) -> list:
    """The fixed (I_n, 1) weight columns of `hash`, one per mode: uniform
    [0, 1) draws in float64 on the CPU from a generator seeded with 0 (the
    JAX package draws its own from ``jax.random.key(0)``, which torch
    cannot replay)."""
    g = torch.Generator().manual_seed(0)
    return [torch.rand((int(sh), 1), generator=g, dtype=torch.float64) for sh in shape]


def hash(t):
    """A fingerprint of the tensor that does not depend on its
    representation: its dot product with a fixed random rank-1 tensor
    (`_hash_weights`). A batch gives one value per sample, (B,)."""
    off = 1 if t.batch else 0
    b = (t.shape[0],) if off else ()
    dtype, device = t.dtype, t.device
    cores = [torch.ones(b + (1, 1, 1), dtype=dtype, device=device) for _ in range(t.dim())]
    Us = [U.to(device=device, dtype=dtype).expand(b + U.shape)
          for U in _hash_weights(t.shape[off:])]
    return t.dot(Tensor(cores, Us, batch=t.batch))


def generate_basis(name: str, shape, orthonormal: bool = False, dtype=None, device=None):
    """A truncated function basis as an (I, S) matrix: 'dct', 'legendre',
    'chebyshev', 'hermite' (on linspace(-1, 1, I)) or 'identity', with
    unit columns when ``orthonormal``. Computed in NumPy/SciPy in float64,
    then cast to ``dtype`` (default: `default_dtype`) on ``device``
    (default: `default_device`)."""
    if name == "dct":
        import scipy.fft

        U = scipy.fft.dct(np.eye(shape[0]), norm="ortho")[:, : shape[1]]
    elif name == "identity":
        U = np.eye(shape[0], shape[1])
    else:
        x = np.linspace(-1, 1, shape[0])
        family = {"legendre": np.polynomial.legendre.legval,
                  "chebyshev": np.polynomial.chebyshev.chebval,
                  "hermite": np.polynomial.hermite.hermval}.get(name)
        if family is None:
            raise ValueError("Unsupported basis function")
        U = family(x, np.eye(shape[0], shape[1])).T
    if orthonormal:
        U = U / np.sqrt(np.sum(U * U, axis=0))
    return asarray(U, dtype=dtype or default_dtype(), device=device)


def reduce(ts, function, eps=0, rmax=np.iinfo(np.int32).max, algorithm="svd", verbose=False,
           **kwargs):
    """Fold the sequence ``ts`` with the binary ``function`` along a binary
    tree, rounding every intermediate result (`round`, to ``eps`` and
    ``rmax``), so that ranks stay bounded however long the sequence."""
    from tntorch_tpu_torch.round import round as tn_round

    def fold(a, b):
        return tn_round(function(a, b, **kwargs), eps=eps, rmax=rmax, algorithm=algorithm)

    d = dict()
    start = time.time()
    for i, elem in enumerate(ts):
        if verbose and i % 100 == 0:
            print("reduce: element {}, time={:g}".format(i, time.time() - start))
        climb = 0
        while climb in d:
            elem = fold(d.pop(climb), elem)
            climb += 1
        d[climb] = elem
    keys = list(d.keys())
    result = d[keys[0]]
    for key in keys[1:]:
        result = fold(result, d[key])
    return result


def convolve(t1, t2, mode: str = "full", **kwargs):
    """N-D convolution of two tensors: the FFT of each core, the products
    of the real and imaginary parts of the spectra by two TT-crosses on
    the complex tensors, their inverse FFTs, and a third cross for the real
    part. ``mode`` is 'full', 'same' (centred, as ``np.convolve``) or
    'valid'; ``kwargs`` go to `cross`. The result has complex cores, as in
    the JAX package."""
    from tntorch_tpu_torch.cross import cross

    N = t1.dim()
    if N != t2.dim():
        raise ValueError(f"convolve needs tensors of one order, got {N} and {t2.dim()}")
    t1, t2 = t1.tt(), t2.tt()
    n_fft = [t1.shape[n] + t2.shape[n] - 1 for n in range(N)]
    t1f = Tensor([torch.fft.fft(t1.cores[n], n=n_fft[n], dim=1) for n in range(N)])
    t2f = Tensor([torch.fft.fft(t2.cores[n], n=n_fft[n], dim=1) for n in range(N)])

    def multr(x, y):
        return x.real * y.real - x.imag * y.imag

    def multi(x, y):
        return x.imag * y.real + x.real * y.imag

    t12fr = cross(tensors=[t1f, t2f], function=multr, **kwargs)
    t12fi = cross(tensors=[t1f, t2f], function=multi, **kwargs)
    t12fi.cores[-1] = t12fi.cores[-1] * 1j
    t12r = Tensor([torch.fft.ifft(c, dim=1) for c in t12fr.cores])
    t12i = Tensor([torch.fft.ifft(c, dim=1) for c in t12fi.cores])
    t12 = cross(tensors=[t12r, t12i], function=lambda x, y: x.real + y.real, **kwargs)
    for n in range(N):
        if mode == "same":  # centred, as np.convolve
            out_len = max(t1.shape[n], t2.shape[n])
            start = (n_fft[n] - out_len) // 2
        elif mode == "valid":
            k = min(t1.shape[n], t2.shape[n])
            out_len, start = max(t1.shape[n], t2.shape[n]) - k + 1, k - 1
        else:
            continue
        t12.cores[n] = t12.cores[n][:, start:start + out_len, :]
    return t12


def shift_mode(t, n, shift, eps=1e-3):
    """Move mode ``n`` by ``shift`` places, in place, by pairwise SVD swaps
    of neighbouring cores (`truncated_svd`): each swap keeps the bond's
    rank (``eps='same'``) or truncates to the relative error ``eps /
    sqrt(|shift|)``. Tucker factors are multiplied into their cores
    first. One eager loop serves every layout; each swap reads its singular
    values to the host once, for its rank. Returns ``t``."""
    from tntorch_tpu_torch.round import truncated_svd

    N = t.dim()
    if not 0 <= n + shift < N:
        raise ValueError(f"mode {n} shifted by {shift} leaves the {N} modes")
    if eps != "same" and (isinstance(eps, str) or eps < 0):
        raise ValueError("Relative error '{}' not recognized".format(eps))
    if shift == 0:
        return t
    if any(U is not None for U in t.Us):
        t2 = t.decompress_tucker_factors()
        t.cores, t.Us = t2.cores, t2.Us
    t.orthogonalize(n)
    cores = t.cores
    sign = int(np.sign(shift))
    for i in range(n, n + shift, sign):
        c1, c2, left_ortho = (i, i + 1, True) if sign == 1 else (i - 1, i, False)
        lead = cores[c1].shape[:-3]  # (B,) for a batch
        R1, I1, R2 = cores[c1].shape[-3:]
        I2, R3 = cores[c2].shape[-2:]
        sc = torch.einsum("...iaj,...jbk->...ibak", cores[c1], cores[c2])
        sc = sc.reshape(lead + (R1 * I2, I1 * R3))
        if eps == "same":
            left, right = truncated_svd(sc, eps=0, rmax=R2, left_ortho=left_ortho,
                                        batch=t.batch)
        else:
            left, right = truncated_svd(sc, eps=eps / np.sqrt(np.abs(shift)),
                                        left_ortho=left_ortho, batch=t.batch)
        cores[c1] = left.reshape(lead + (R1, I2, left.shape[-1]))
        cores[c2] = right.reshape(lead + (left.shape[-1], I1, R3))
    return t
