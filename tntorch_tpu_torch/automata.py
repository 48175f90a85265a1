"""Tensor trains as weighted finite automata: Hamming-weight masks and
counters, and the strings an automaton accepts.

Counterpart of ``tntorch_tpu/automata.py``. The constructors take the JAX
package's arguments plus ``device`` (default: `utils.default_device`, the
card) and ``dtype`` (default: `utils.default_dtype`). ``accepted_inputs``
walks the automaton on the host, as the JAX package does: a depth-first
recursion over the prefixes that still lead to an accepted string, with the
cores read back once.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import default_device, default_dtype


def _tensor(cores, device, dtype) -> Tensor:
    """A TT of NumPy ``cores`` in ``dtype`` on ``device``."""
    dtype = dtype or default_dtype()
    device = device or default_device()
    return Tensor([torch.from_numpy(np.asarray(c, dtype=np.float64)).to(device, dtype)
                   for c in cores])


def weight_mask(N, weight, nsymbols=2, device=None, dtype=None) -> Tensor:
    """The mask of the strings whose number of non-zero symbols is in
    ``weight`` (an int or a list)."""
    weight = np.atleast_1d(np.asarray(weight, dtype=np.int64))
    if weight.min() < 0:
        raise ValueError("weights must be non-negative")
    t = weight_one_hot(N, int(weight.max() + 1), nsymbols, device=device, dtype=dtype)
    t.cores[-1] = t.cores[-1][:, :, torch.from_numpy(weight).to(t.device)].sum(2, keepdim=True)
    return t


def weight_one_hot(N, r=None, nsymbols=2, device=None, dtype=None) -> Tensor:
    """The counter automaton: a string with k non-zero symbols leaves the
    one-hot vector of k (of length ``r``, default N + 1) on the last core's
    right rank."""
    if not hasattr(nsymbols, "__len__"):
        nsymbols = [nsymbols] * N
    if len(nsymbols) != N:
        raise ValueError(f"nsymbols needs {N} entries, got {len(nsymbols)}")
    if r is None:
        r = N + 1
    cores = []
    for n in range(N):
        core = np.zeros([r, nsymbols[n], r])
        core[:, 0, :] = np.eye(r)
        for s in range(1, nsymbols[n]):
            core[:, s, s:] = np.eye(r)[:, :-s]
        cores.append(core)
    cores[0] = cores[0][0:1, :, :]
    return _tensor(cores, device, dtype)


def _counter(N, nsymbols, weights, device, dtype) -> Tensor:
    """The rank-2 automaton that sums ``weights[s]`` over the symbols s of
    a string."""
    cores = []
    for _ in range(N):
        core = np.tile(np.eye(2)[:, None, :], (1, nsymbols, 1))
        core[1, :, 0] = weights
        cores.append(core)
    cores[0] = cores[0][1:2, :, :]
    cores[-1] = cores[-1][:, :, 0:1]
    return _tensor(cores, device, dtype)


def weight(N, nsymbols=2, device=None, dtype=None) -> Tensor:
    """The automaton whose value at a string is the sum of its symbols (the
    Hamming weight of a binary string)."""
    return _counter(N, nsymbols, np.arange(nsymbols), device, dtype)


def length(N, nsymbols=2, device=None, dtype=None) -> Tensor:
    """The automaton whose value at a string is its number of non-zero
    symbols (the JAX package's semantics; the original tntorch leaves it
    unimplemented)."""
    return _counter(N, nsymbols, (np.arange(nsymbols) != 0).astype(np.float64), device, dtype)


def accepted_inputs(t):
    """Every string that the automaton ``t`` accepts, in lexicographic
    order, a string s appearing t[s] times: a (total, N) int64 tensor on
    ``t``'s device. A batch gives one such tensor per sample, as a list.
    The walk runs on the host: per mode, the accepted counts of each prefix's
    extensions come from one product with the suffix sums; a prefix that
    leads to none is cut."""
    if t.batch:
        return [accepted_inputs(t[b]) for b in range(t.shape[0])]
    cores = [c.detach().cpu().numpy() for c in t.tt().cores]
    N = len(cores)
    rights = [np.ones(1)]
    for core in cores[::-1]:
        rights.append(core.sum(axis=1) @ rights[-1])
    rights = rights[::-1]
    total = int(round(float(rights[0].sum())))
    Xs = np.zeros([total, N], dtype=np.int64)

    def recursion(left, bound, mu):
        if mu == N:
            return
        fiber = np.einsum("ijk,k->ij", cores[mu], rights[mu + 1])
        per_point = np.round(left @ fiber)
        c = np.concatenate(([0], np.cumsum(per_point))).astype(np.int64)
        for i in range(per_point.shape[-1]):
            if c[i] == c[i + 1]:  # no accepted string has this prefix
                continue
            Xs[bound + c[i]:bound + c[i + 1], mu] = i
            recursion(left @ cores[mu][:, i, :], bound + c[i], mu + 1)

    recursion(np.ones(1), 0, 0)
    return torch.from_numpy(Xs).to(t.device)
