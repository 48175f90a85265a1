"""Distributed heavy algorithms: mode-sharded TT rounding and batch-sharded
rounding, and the placements of dp training.

Counterpart of ``tntorch_tpu/parallel/algorithms.py``. The rounding is the
two-sided Gram method (cf. Al Daas, Ballard, Benner et al., "Parallel
algorithms for TT arithmetic & rounding"): every rank owns a slice of each
core along its mode dimension, the Gram matrices are formed from local
partial sums and one all-reduce per Gram, and the small R x R
factorizations run redundantly on every rank. The only communication is
2(N-1) all-reduces of R x R matrices. Each rank runs the single-device
sweep, `ops.rounding.round_tt_gram_batched` (on the card: the ``gram_edge``,
``wgram`` and ``proj2`` kernels), on its slices as a batch of one, with
that all-reduce as the sweep's ``reduce`` hook. Every function here is
collective, as in `parallel.mesh`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate

from tntorch_tpu_torch.ops.rounding import round_tt_gram_batched
from tntorch_tpu_torch.parallel.mesh import _all_reduce, _on, _put, _size, _wrap


def round_tt_gram_sharded(cores: Sequence[torch.Tensor], rmax, mesh: DeviceMesh,
                          axis: str = "tp", edge_solver: str = "eigh"):
    """Multi-rank fixed-rank TT rounding: the cores shard along their MODE
    dimension over ``axis``, and each Gram matrix is summed over the shards
    by one all-reduce.

    Matches `ops.rounding.round_tt_gram` (same algorithm; the sums over a
    mode run in another order, so agreement is to roundoff). A mode that
    the axis does not divide gives uneven shards (``torch.chunk``'s); each
    rank pads its slices with zeros up to the largest shard (zero slices
    change neither the Grams nor the values on the original index range)
    and strips the padding from its output. The edge solvers run on the
    all-reduced Grams, the same on every rank; 'rand' draws its sketch from
    a generator seeded by the shape (`ops.rounding._sketch`), so every rank
    draws the same one.

    :param rmax: int or per-edge sequence of ints
    :return: list of rounded cores, mode-sharded over ``axis`` (DTensors)
    """
    where = _on(mesh, axis, 1)
    k = _size(mesh, axis)
    placed = [_put(c, mesh, where) for c in cores]
    sizes = [c.to_local().shape[1] for c in placed]
    padded = []
    for c, size in zip(placed, sizes):
        local = c.to_local()
        width = -(-c.shape[1] // k)
        if width > size:
            local = torch.nn.functional.pad(local, (0, 0, 0, width - size))
        padded.append(local[None])
    group = mesh.get_group(mesh.mesh_dim_names.index(axis)) if k > 1 else None

    def reduce(G):
        return _all_reduce(G.contiguous(), group)

    if not isinstance(rmax, int):
        rmax = tuple(int(r) for r in rmax)
    out = round_tt_gram_batched(padded, rmax, edge_solver, reduce if group else None)
    return [_wrap(o[0, :, :size], mesh, where, (o.shape[1], c.shape[1], o.shape[3]))
            for o, c, size in zip(out, placed, sizes)]


def round_tt_batch_sharded(cores: Sequence[torch.Tensor], rmax, mesh: DeviceMesh,
                           axis: str = "dp"):
    """Batch-sharded fixed-rank rounding of a batch=True TT: the leading
    batch dim shards over ``axis`` (pure data parallelism, no
    communication), each rank rounding its samples by the single-device
    batched Gram sweep ('eigh' edges).

    :param cores: batched cores (B x R x I x R), B at least the axis size
    :return: list of rounded cores, batch-sharded over ``axis`` (DTensors)
    """
    where = _on(mesh, axis, 0)
    B, k = cores[0].shape[0], _size(mesh, axis)
    if B < k:
        raise ValueError(f"{B} TTs cannot give each of the {k} ranks of '{axis}' one")
    local = [_put(c, mesh, where).to_local() for c in cores]
    if not isinstance(rmax, int):
        rmax = tuple(int(r) for r in rmax)
    out = round_tt_gram_batched(local, rmax, "eigh")
    return [_wrap(o, mesh, where, (B,) + tuple(o.shape[1:])) for o in out]


def shard_array(x, mesh: DeviceMesh, axis: str = "dp"):
    """Place an array with its leading dim sharded over ``axis`` (rank 0's
    copy): the data half of the dp recipe of ``optimize(..., mesh=)``."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return _put(x, mesh, _on(mesh, axis, 0))


def replicate_pytree(tree, mesh: DeviceMesh):
    """Replicate every leaf (tensor, array or number) of a nest of lists,
    tuples and dicts across the mesh, from rank 0: the parameters of dp
    training."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_pytree(v, mesh) for v in tree)
    if isinstance(tree, dict):
        return {k: replicate_pytree(v, mesh) for k, v in tree.items()}
    x = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(np.asarray(tree))
    return _put(x, mesh, [Replicate()] * mesh.ndim)

