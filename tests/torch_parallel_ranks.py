"""The rank side of tests/test_torch_parallel.py: functions that every rank
of a `tntorch_tpu_torch.parallel.launch.Group` runs on the CPU (gloo),
importable by the spawned ranks, which import neither JAX nor the JAX
package. Each takes NumPy inputs and a mesh shape and returns NumPy
results (gathered: the same on every rank) with what the rank saw."""

import numpy as np
import torch
import torch.distributed as dist

import tntorch_tpu_torch as tn
from tntorch_tpu_torch import parallel as par
from tntorch_tpu_torch.ops import rounding as tr


def _mesh(shape):
    torch.set_num_threads(1)  # four ranks share the cores with the other test workers
    return par.make_mesh(shape, ("dp", "tp"), device="cpu")


def _t(arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _np(x):
    return par.gather(x).numpy()


def mesh_layout(shape, dcn_shape):
    """The ranks of each mesh position."""
    return par.make_mesh(shape, ("dp", "tp"), dcn_shape=dcn_shape, device="cpu").mesh.tolist()


def placements(shape, cores, batch, Us, array):
    """Each placement function's local shards on this rank and the gathered
    whole, for a TT (``cores``, ``batch``, factors ``Us``) and an array."""
    mesh = _mesh(shape)
    t = tn.Tensor(_t(cores), Us=None if Us is None else _t(Us), batch=batch)
    out = {"rank": dist.get_rank()}
    placed = {"replicate": par.replicate(t, mesh), "shard_ranks": par.shard_ranks(t, mesh)}
    if batch:
        placed["shard_batch"] = par.shard_batch(t, mesh)
    for name, p in placed.items():
        out[name] = ([c.to_local().numpy() for c in p.cores], [_np(c) for c in p.cores],
                     [None if U is None else (U.to_local().numpy(), _np(U)) for U in p.Us])
    x = torch.from_numpy(array)
    sharded = par.shard_array(x, mesh)
    reps = par.replicate_pytree({"a": x, "b": [x[0], 3.0]}, mesh)
    placed_tp = par.place(x, mesh, (None, "tp"))
    out["shard_array"] = (sharded.to_local().numpy(), _np(sharded))
    out["replicate_pytree"] = (_np(reps["a"]), _np(reps["b"][0]), float(reps["b"][1]))
    out["place"] = (placed_tp.to_local().numpy(), _np(placed_tp))
    out["numpy"] = placed["shard_ranks"].numpy()
    return out


def dot(shape, cores1, cores2, batch, how):
    """sharded_dot and sharded_norm of two TTs placed by ``how``, with the
    collectives of the dot."""
    mesh = _mesh(shape)
    place = {"ranks": par.shard_ranks, "replicate": par.replicate,
             "batch": par.shard_batch}[how]
    a = place(tn.Tensor(_t(cores1), batch=batch), mesh)
    b = place(tn.Tensor(_t(cores2), batch=batch), mesh)
    with par.counting_collectives() as calls:
        d = par.sharded_dot(a, b)
    return _np(d), _np(par.sharded_norm(a)), calls


def forward(shape, cores, X, how):
    """``how`` (tt_forward_sharded or tt_forward_shard_map) at X, with the
    values' placements and the collectives."""
    mesh = _mesh(shape)
    fn = getattr(par, how)
    with par.counting_collectives() as calls:
        y = fn(_t(cores), torch.from_numpy(X), mesh)
    return _np(y), list(y.placements), calls


def round_gram(shape, cores, rmax, edge_solver, sketches):
    """round_tt_gram_sharded of mode-sharded ``cores``, with the
    collectives; ``sketches`` ((n, r) -> array) stand in for the 'rand'
    edges' draws, patched into this rank's `ops.rounding._sketch`."""
    mesh = _mesh(shape)
    placed = [par.place(c, mesh, (None, "tp")) for c in _t(cores)]
    real = tr._sketch
    if sketches:
        tr._sketch = lambda n, r, dtype, device: torch.from_numpy(sketches[(n, r)]).to(
            device, dtype)
    try:
        with par.counting_collectives() as calls:
            out = par.round_tt_gram_sharded(placed, rmax, mesh, edge_solver=edge_solver)
    finally:
        tr._sketch = real
    return [_np(c) for c in out], [list(c.placements) for c in out], calls


def round_batch(shape, cores, rmax):
    """round_tt_batch_sharded of batch-sharded ``cores``, with the
    collectives."""
    mesh = _mesh(shape)
    placed = [par.place(c, mesh, ("dp",)) for c in _t(cores)]
    with par.counting_collectives() as calls:
        out = par.round_tt_batch_sharded(placed, rmax, mesh)
    return [_np(c) for c in out], calls


def optimize(shape, cores, X, y, steps, lr):
    """optimize(mesh=) of a TT from ``cores`` on dp-sharded data (Adam at
    ``lr``): the loss history and the trained cores."""
    mesh = _mesh(shape)
    t = tn.Tensor(_t(cores), requires_grad=True)
    Xs, ys = par.shard_array(X, mesh), par.shard_array(y, mesh)

    def loss(t_):
        return torch.mean((tn.parallel.tt_batch_forward(list(t_.cores), Xs) - ys) ** 2)

    hist = tn.optimize(t, loss, optimizer=lambda ps: torch.optim.Adam(ps, lr=lr),
                       max_iter=steps - 1, tol=None, verbose=False, mesh=mesh)
    return hist, [_np(c.detach()) for c in t.cores], [list(c.placements) for c in t.cores]


def fail_on_rank_one():
    """Rank 1 raises; the others wait for it in a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()


def sleep(seconds):
    import time

    time.sleep(seconds)
