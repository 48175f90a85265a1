"""Meshes and placements for compressed tensors, and the sharded
contractions and forwards.

Counterpart of ``tntorch_tpu/parallel/mesh.py``. JAX is single-controller:
one process sees every device, and a sharded ``jax.Array`` is global.
PyTorch runs one process per rank (SPMD), so here:

- a ``jax.sharding.Mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
  over the ranks of the default process group (started by `launch.run`,
  by ``torchrun`` or by the caller);
- a ``NamedSharding`` with its ``PartitionSpec`` is a list of DTensor
  placements, one per mesh dimension (``Shard(d)``, ``Replicate()``);
- ``np.asarray(sharded)`` is `gather` (``DTensor.full_tensor()`` by
  explicit collectives: DTensor's own, functional ones crash over gloo on
  a card, torch 2.11);
- ``shard_map`` with ``lax.psum`` is a computation on the local shards
  (``to_local()``) with explicit collectives (``dist.all_reduce`` over
  ``mesh.get_group(axis)``).

The sharded functions compute on local shards with those explicit
collectives, not through DTensor's sharding propagation: the port's kernels
are ``ctypes`` launches that DTensor cannot see. Their results come back as
DTensors with the placements of the JAX functions' outputs. Every function
here is collective: each rank of the mesh calls it with the same
arguments. Placing a tensor that is not yet a DTensor takes rank 0's copy
(one broadcast per mesh dimension); a DTensor with the asked placements is
used as it is. Over a gloo process group, the collectives of tensors on a
card go through host memory (`_staged`), so that several ranks can share
one card (NCCL refuses that).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from tntorch_tpu_torch.ops.tt_eval import tt_batch_forward, tt_eval
from tntorch_tpu_torch.utils import default_device


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names=("dp", "tp"),
    devices=None,
    dcn_shape: Optional[Sequence[int]] = None,
    device=None,
) -> DeviceMesh:
    """Build a mesh of ranks. Default: every rank on 'dp' and 1 on 'tp'.

    :param shape: mesh shape, e.g. (4, 2) for 4-way data x 2-way rank
        parallelism; it multiplies to the rank count (per slice with
        ``dcn_shape``).
    :param devices: the global ranks to lay out (default: every rank of
        the default process group), the counterpart of JAX's devices.
    :param dcn_shape: multi-slice layout, per-axis slice counts elementwise
        with ``shape``: axis i then spans dcn_shape[i] slices x shape[i]
        ranks, slice-major, a slice being a contiguous block of ranks (the
        JAX package's fallback layout; torch knows no slice topology).
    :param device: the device type of the mesh, "cuda" or "cpu" (default:
        the package's, the card). It is the caller's: a rank's tensors must
        live there.
    """
    devices = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if dcn_shape is None:
        if int(np.prod(shape)) != n:
            raise ValueError(f"mesh shape {shape} != {n} ranks")
        ranks = np.asarray(devices).reshape(shape)
    else:
        dcn_shape = tuple(int(d) for d in dcn_shape)
        if len(dcn_shape) != len(shape):
            raise ValueError("dcn_shape must match shape's length")
        if int(np.prod(shape)) * int(np.prod(dcn_shape)) != n:
            raise ValueError(f"hybrid mesh {shape} x {dcn_shape} != {n} ranks")
        k = len(shape)
        ranks = np.asarray(devices).reshape(dcn_shape + shape)
        ranks = ranks.transpose([a for j in range(k) for a in (j, j + k)])
        ranks = ranks.reshape([d * s for d, s in zip(dcn_shape, shape)])
    device = torch.device(device or default_device()).type
    return DeviceMesh(device, torch.as_tensor(ranks), mesh_dim_names=tuple(axis_names))


def placements(spec, mesh_dim_names) -> list:
    """The DTensor placements, one per mesh dimension, of the JAX package's
    ``PartitionSpec`` ``spec`` (per tensor dimension, a mesh axis name or
    None): ``Shard(d)`` where tensor dimension d carries the axis,
    ``Replicate()`` elsewhere."""
    spec = tuple(spec)
    unknown = {a for a in spec if a is not None} - set(mesh_dim_names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} are not mesh dimensions {mesh_dim_names}")
    return [Shard(spec.index(name)) if name in spec else Replicate()
            for name in mesh_dim_names]


def _on(mesh, axis, dim) -> list:
    """Placements sharding tensor dimension ``dim`` over mesh axis ``axis``."""
    return [Shard(dim) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def _size(mesh, axis) -> int:
    """The mesh's extent along ``axis``; 1 where it has no such axis."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def _chunk(n, k, c):
    """(start, stop) of chunk ``c`` of ``n`` items split ``k`` ways, as
    ``torch.chunk`` and DTensor split them (ceil(n/k) each, the last ones
    short or empty)."""
    s = -(-n // k)
    return min(n, c * s), min(n, (c + 1) * s)


def _staged(collective, group, out, *args, **kwargs):
    """``collective(*args, group=group, **kwargs)`` writing into ``out`` (a
    tensor or a list of them), through host memory where the group is
    gloo's and ``out`` lives on a card: a copy to the host before, and
    back after. The other arguments are tensors or not, as
    ``collective``'s."""
    outs = out if isinstance(out, list) else [out]
    if not (outs[0].is_cuda and dist.get_backend(group) == "gloo"):
        collective(*args, group=group, **kwargs)
        return out
    host = {id(t): t.cpu() for t in (*outs, *(a for a in args if isinstance(a, torch.Tensor)))}

    def cpu(a):
        if isinstance(a, list):
            return [host[id(t)] for t in a]
        return host.get(id(a), a)

    collective(*(cpu(a) for a in args), group=group, **kwargs)
    for t in outs:
        t.copy_(host[id(t)])
    return out


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    """``x`` summed (or ``op``) over ``group``, in place: one all-reduce."""
    return _staged(dist.all_reduce, group, x, x, op=op)


def _broadcast(x, mesh):
    """Rank 0's ``x`` on every rank of the mesh: one broadcast along each
    mesh dimension of more than one rank."""
    coord = mesh.get_coordinate()
    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            src = mesh.mesh[tuple(coord[:d]) + (0,) + tuple(coord[d + 1:])]
            _staged(dist.broadcast, mesh.get_group(d), x, x, src=int(src))
    return x


def _put(x, mesh, where) -> DTensor:
    """``x`` as a DTensor with placements ``where`` on ``mesh``. A DTensor
    already placed so is returned as it is; another DTensor is gathered
    first; a plain tensor (or array) is rank 0's copy, broadcast."""
    if isinstance(x, DTensor):
        if x.device_mesh == mesh and list(x.placements) == list(where):
            return x
        x = _gather(x)
    else:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        x = _broadcast(x.detach().to(mesh.device_type).contiguous(), mesh)
    coord, local = mesh.get_coordinate(), x
    for d, p in enumerate(where):
        if isinstance(p, Shard):
            start, stop = _chunk(x.shape[p.dim], mesh.size(d), coord[d])
            local = local.narrow(p.dim, start, stop - start)
    return DTensor.from_local(local.contiguous(), mesh, where, run_check=False,
                              shape=x.shape, stride=x.stride())


def place(x, mesh: DeviceMesh, spec) -> DTensor:
    """``x`` placed on ``mesh`` as the JAX package's ``PartitionSpec``
    ``spec`` says (per dimension, the mesh axis that shards it, or None):
    the counterpart of ``jax.device_put(x, NamedSharding(mesh, spec))``.
    Rank 0's copy of a plain tensor is broadcast; a DTensor is re-placed."""
    spec = tuple(spec) + (None,) * (x.ndim - len(tuple(spec)))
    return _put(x, mesh, placements(spec, mesh.mesh_dim_names))


def _wrap(local, mesh, where, shape) -> DTensor:
    """The DTensor of global ``shape`` whose shard on this rank is ``local``."""
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, where, run_check=False, shape=shape,
                              stride=stride)


def on_shards(fn, *xs):
    """``fn`` of the local shards of the DTensors ``xs``, wrapped back as a
    DTensor, where the op is local: the ``xs`` are placed alike, each
    dimension of the mesh replicating them or sharding their leading
    (batch) dimension, which ``fn`` keeps. None otherwise: the caller's op
    then goes through DTensor."""
    mesh, where = xs[0].device_mesh, list(xs[0].placements)
    if any(not isinstance(x, DTensor) or x.device_mesh != mesh or list(x.placements) != where
           for x in xs):
        return None
    if any(not (isinstance(p, Replicate) or p == Shard(0)) for p in where):
        return None
    local = fn(*(x.to_local() for x in xs))
    return _wrap(local, mesh, where, (xs[0].shape[0],) + tuple(local.shape[1:]))


def _placed(t, cores, Us=None):
    t2 = t.clone()
    t2.cores = cores
    if Us is not None:
        t2.Us = Us
    return t2


def shard_batch(t, mesh: DeviceMesh, axis: str = "dp"):
    """Shard a batch=True tensor's leading batch dim (its cores' and its
    Tucker factors') across ``axis``: pure data parallelism."""
    if not t.batch:
        raise ValueError("shard_batch requires a batch=True tensor")
    where = _on(mesh, axis, 0)
    return _placed(t, [_put(c, mesh, where) for c in t.cores],
                   [None if U is None else _put(U, mesh, where) for U in t.Us])


def rank_specs(cores, axis: str = "tp", batch: bool = False, mesh_dim_names=("dp", "tp")):
    """Placements sharding each interior TT-rank edge consistently: core n's
    right rank and core n+1's left rank carry the same axis, alternating
    (even cores their right rank, odd cores their left), so that each
    contraction is local up to one reduction at the boundary. ``batch``
    shifts every dimension by the leading B dim (batch TT cores are 4D,
    batch CP factors 3D). One placement list per core, over the mesh
    dimensions ``mesh_dim_names``."""
    N = len(cores)
    b = (None,) if batch else ()
    tt_ndim = 4 if batch else 3
    out = []
    for n, c in enumerate(cores):
        left = axis if (n > 0 and n % 2 == 1) else None
        right = axis if (n < N - 1 and n % 2 == 0) else None
        spec = (*b, left, None, right) if c.ndim == tt_ndim else (*b, None, right)
        out.append(placements(spec, mesh_dim_names))
    return out


def _replicated(Us, mesh):
    """Tucker factors replicated over the mesh (DTensors mix with DTensors
    only)."""
    return [None if U is None else _put(U, mesh, [Replicate()] * mesh.ndim) for U in Us]


def shard_ranks(t, mesh: DeviceMesh, axis: str = "tp"):
    """Shard the cores' TT-rank edges across ``axis`` (`rank_specs`):
    rank/tensor parallelism. Tucker factors are replicated."""
    specs = rank_specs(t.cores, axis, t.batch, mesh.mesh_dim_names)
    return _placed(t, [_put(c, mesh, w) for c, w in zip(t.cores, specs)],
                   _replicated(t.Us, mesh))


def replicate(t, mesh: DeviceMesh):
    """Replicate every core (and Tucker factor) across the mesh (dp
    parameter placement)."""
    where = [Replicate()] * mesh.ndim
    return _placed(t, [_put(c, mesh, where) for c in t.cores], _replicated(t.Us, mesh))


def local_rows(x, mesh: DeviceMesh, axis: str = "dp"):
    """This rank's chunk of ``x``'s rows (``torch.chunk``'s, by its
    coordinate along mesh axis ``axis``): the rows it computes on where the
    JAX package places ``x`` with ``PartitionSpec(axis)``. No collective."""
    k = _size(mesh, axis)
    if k == 1:
        return x
    c = mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]
    start, stop = _chunk(x.shape[0], k, c)
    return x[start:stop]


def gather_rows(local, mesh: DeviceMesh, axis: str, n: int) -> torch.Tensor:
    """The ``n`` rows whose chunks (`local_rows`) the ranks along mesh axis
    ``axis`` hold, on every rank: one all-gather over that axis (`_gather`,
    uneven chunks padded). Not differentiable."""
    if _size(mesh, axis) == 1:
        return local
    local = local.detach()
    return _gather(_wrap(local, mesh, _on(mesh, axis, 0), (n,) + tuple(local.shape[1:])))


def _gather(x, keep=()):
    """The local tensor of ``x`` with every shard gathered, by one
    all-gather per sharded mesh dimension, except those of the mesh
    dimensions in ``keep``; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, local = x.device_mesh, x.to_local()
    for d, p in enumerate(x.placements):
        if isinstance(p, Partial):
            raise ValueError("a partial DTensor is not a placed tensor")
        if not isinstance(p, Shard) or d in keep or mesh.size(d) == 1:
            continue
        k, n = mesh.size(d), x.shape[p.dim]
        width = -(-n // k)
        pad = [0, 0] * (local.ndim - 1 - p.dim) + [0, width - local.shape[p.dim]]
        parts = [local.new_empty(local.shape[:p.dim] + (width,) + local.shape[p.dim + 1:])
                 for _ in range(k)]
        _staged(dist.all_gather, mesh.get_group(d), parts, parts,
                torch.nn.functional.pad(local, pad).contiguous())
        local = torch.cat([q.narrow(p.dim, 0, stop - start) for q, (start, stop)
                           in zip(parts, (_chunk(n, k, c) for c in range(k)))], dim=p.dim)
    return local


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _reduce_partial(x) -> DTensor:
    """The DTensor ``x`` with each ``Partial`` placement reduced over its
    mesh dimension (one explicit all-reduce each) and replicated there."""
    where = list(x.placements)
    if not any(isinstance(p, Partial) for p in where):
        return x
    mesh, local = x.device_mesh, x.to_local().detach().clone().contiguous()
    for d, p in enumerate(where):
        if isinstance(p, Partial):
            if mesh.size(d) > 1:
                _all_reduce(local, mesh.get_group(d), _REDUCE_OPS[p.reduce_op])
                if p.reduce_op == "avg":
                    local /= mesh.size(d)
            where[d] = Replicate()
    return DTensor.from_local(local, mesh, where, run_check=False, shape=x.shape,
                              stride=x.stride())


def gather(x) -> torch.Tensor:
    """The whole of a DTensor as a plain tensor on every rank (its partial
    sums reduced, its shards gathered), by explicit collectives: the
    counterpart of ``np.asarray`` of a sharded array. A plain tensor comes
    back as it is."""
    return _gather(_reduce_partial(x)) if isinstance(x, DTensor) else x


def _batch_axes(t):
    """The mesh dimensions over which a batch tensor's cores all shard the
    batch dim, with the mesh; ((), None) where there are none."""
    first = t.cores[0]
    if not (t.batch and isinstance(first, DTensor)):
        return (), None
    dims = tuple(d for d, p in enumerate(first.placements) if p == Shard(0))
    same = all(isinstance(c, DTensor) and c.device_mesh == first.device_mesh
               and all(c.placements[d] == Shard(0) for d in dims) for c in t.cores)
    return (dims, first.device_mesh) if same else ((), None)


def sharded_dot(t1, t2):
    """The dot product of two placed tensors (``tn.dot``). A core sharded
    over TT ranks or modes is gathered by one all-gather per sharded mesh
    dimension, so a call makes at most 2N collectives, none larger than one
    core; batch shards stay local, each rank computing its samples' dots.
    The result is a DTensor: replicated, or for batch tensors sharded like
    their batch."""
    from tntorch_tpu_torch.metrics import dot

    keep, batch_mesh = _batch_axes(t1)
    if keep and _batch_axes(t2) != (keep, batch_mesh):
        keep = ()
    meshes = [c.device_mesh for c in (*t1.cores, *t2.cores) if isinstance(c, DTensor)]
    if not meshes:
        return dot(t1, t2)
    mesh = meshes[0]

    def local(t):
        return _placed(t, [_gather(c, keep) for c in t.cores],
                       [None if U is None else _gather(U, keep) for U in t.Us])

    l1 = local(t1)
    out = dot(l1, l1 if t2 is t1 else local(t2))
    if keep:
        where = [Shard(0) if d in keep else Replicate() for d in range(mesh.ndim)]
        return _wrap(out, mesh, where, (t1.shape[0],))
    return _wrap(out, mesh, [Replicate()] * mesh.ndim, ())


def sharded_norm(t):
    """Frobenius norm of a placed tensor, through `sharded_dot`."""
    return torch.sqrt(torch.clamp(sharded_dot(t, t), min=0))


def dtensor_tt_eval(cores, X, use_kernel=None, checked=False) -> torch.Tensor:
    """`ops.tt_eval.tt_eval` where X or the cores are DTensors: X sharded
    over its rows (``Shard(0)``) or replicated, the cores replicated (a
    plain core is taken as the same on every rank). Each rank evaluates
    its rows through the dispatcher, on the card the kernels; the values
    come back as a DTensor sharded as X's rows, or for a plain X as a plain
    tensor, the same on every rank. The cores' gradient on a rank is the
    part of its rows, which a backward through the replicated cores sums
    over the mesh (DTensor's ``Partial``)."""
    DT = [x for x in (X, *cores) if isinstance(x, DTensor)]
    mesh = DT[0].device_mesh
    sharded = isinstance(X, DTensor)
    if sharded:
        if any(isinstance(p, Shard) and p.dim != 0 or isinstance(p, Partial)
               for p in X.placements):
            raise ValueError("X must be sharded over its rows (Shard(0)) or replicated")
        rows = list(X.placements)
        X, B = X.to_local(), X.shape[0]
    else:
        rows = [Replicate()] * mesh.ndim
    grads = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    local = []
    for c in cores:
        if not isinstance(c, DTensor):
            c = DTensor.from_local(c, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if not all(isinstance(p, Replicate) for p in c.placements):
            raise ValueError("tt_eval takes replicated cores; for rank-sharded ones, "
                             "use parallel.tt_forward_sharded")
        local.append(c.to_local(grad_placements=grads))
    values = tt_eval(local, X, use_kernel=use_kernel, checked=checked)
    return _wrap(values, mesh, rows, (B,)) if sharded else values


def tt_forward_sharded(cores, X, mesh: DeviceMesh, dp_axis: str = "dp", tp_axis: str = "tp"):
    """Batch-sharded, rank-sharded TT evaluation: X's rows shard over
    ``dp_axis``. Where ``tp_axis`` has one rank (or the mesh has none), the
    cores are replicated and each rank evaluates its rows through the
    ``tt_eval`` dispatcher (on the card, its kernels); otherwise the
    interior rank edges shard over ``tp_axis`` in `tt_forward_shard_map`'s
    alternating layout. Returns (B,) values sharded over ``dp_axis``."""
    if _size(mesh, tp_axis) > 1:
        return tt_forward_shard_map(cores, X, mesh, dp_axis, tp_axis)
    X = _put(X, mesh, _on(mesh, dp_axis, 0))
    return dtensor_tt_eval([_put(c, mesh, [Replicate()] * mesh.ndim) for c in cores], X)


def tt_forward_shard_map(cores, X, mesh: DeviceMesh, dp_axis: str = "dp", tp_axis: str = "tp"):
    """TT evaluation with explicit collectives: samples shard over
    ``dp_axis``; interior rank edges shard over ``tp_axis`` in an
    alternating column/row layout (`rank_specs`: even cores column-sharded,
    odd cores row-sharded, the last core never column-sharded), so each odd
    core leaves a partial product that one all-reduce over tp sums. Only
    even edges are split, so an odd edge needs no divisibility; an uneven
    split of an even edge gives uneven shards. The chain of gathers and
    products runs on each rank's shards (not differentiable).

    :param cores: pure TT cores, R_0 = R_N = 1
    :param X: (B, N) integer coordinates
    :return: (B,) values, sharded over ``dp_axis`` and replicated over tp
    """
    specs = rank_specs(cores, tp_axis, False, mesh.mesh_dim_names)
    local = [_put(c, mesh, w).to_local() for c, w in zip(cores, specs)]
    rows = _on(mesh, dp_axis, 0)
    Xd = _put(X, mesh, rows)
    Xl = Xd.to_local().long()
    group = mesh.get_group(mesh.mesh_dim_names.index(tp_axis)) if _size(mesh, tp_axis) > 1 else None
    v = torch.ones((Xl.shape[0], local[0].shape[0]), dtype=local[0].dtype, device=Xl.device)
    for k, core in enumerate(local):
        v = torch.einsum("br,rbs->bs", v, core[:, Xl[:, k], :])
        if k % 2 == 1 and group is not None:  # row-sharded core: partial sums over tp
            v = _all_reduce(v.contiguous(), group)
    return _wrap(v[:, 0], mesh, rows, (Xd.shape[0],))


__all__ = ["make_mesh", "placements", "place", "gather", "local_rows", "gather_rows",
           "rank_specs", "shard_batch", "shard_ranks", "replicate", "sharded_dot",
           "sharded_norm", "tt_batch_forward", "tt_forward_sharded", "tt_forward_shard_map"]
