"""The rank side of tests/test_torch_parallel.py: functions that every rank
of a `tntorch_tpu_torch.parallel.launch.Group` runs on the CPU (gloo),
importable by the spawned ranks, which import neither JAX nor the JAX
package. Each takes NumPy inputs and a mesh shape and returns NumPy
results (gathered: the same on every rank) with what the rank saw."""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

import tntorch_tpu_torch as tn
from tntorch_tpu_torch import parallel as par
from tntorch_tpu_torch.ops import rounding as tr


def _mesh(shape, names=("dp", "tp")):
    torch.set_num_threads(1)  # four ranks share the cores with the other test workers
    return par.make_mesh(shape, names, device="cpu")


def _t(arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _np(x):
    return par.gather(x).numpy()


@contextlib.contextmanager
def solo_mesh(names=("dp", "tp")):
    """For the block, a process group of this one process (gloo, an
    in-memory store) and its mesh of one rank; the group is destroyed
    after. The ``mesh=`` paths run there as on one rank of many."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield par.make_mesh((1,) * len(names), names, device="cpu")
    finally:
        dist.destroy_process_group()


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


# The rank side of tests/test_torch_parallel_paths.py: the mesh= paths of
# cross, als_completion and the learners, and the orbax checkpoints


def _float64():
    torch.set_default_dtype(torch.float64)  # meshgrid and the learners cast to it


def hilbert(*xs):
    return 1 / sum(xs)


def cross(shape, axes, kw):
    """cross(mesh=) of 1/sum(x) on ``axes``: the result's dense form, the
    run's info (index sets as NumPy) and the collectives."""
    _float64()
    mesh = _mesh(shape, ("dp",))
    with par.counting_collectives() as calls:
        t, info = tn.cross(function=hilbert, domain=axes, device="cpu", verbose=False,
                           return_info=True, mesh=mesh, **kw)
    sets = {k: [np.asarray(x) for x in info[k]] for k in ("lsets", "rsets", "left_locals")}
    return (t.numpy(), [int(r) for r in info["Rs"]], info["nsamples"], sets,
            info.get("sample_values"), calls)


def minimize(shape, cores, kw):
    """minimum and argmin of a batch TT with mesh=, with the collectives of
    the minimum and the warnings logged."""
    import logging

    _float64()
    mesh = _mesh(shape, ("dp",))
    t = tn.Tensor(_t(cores), batch=True)
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    tn.utils.logger.addHandler(handler)
    try:
        with par.counting_collectives() as calls:
            m = tn.minimum(t, mesh=mesh, **kw)
        a = tn.argmin(t, mesh=mesh, **kw)
    finally:
        tn.utils.logger.removeHandler(handler)
    return m.numpy(), a, calls, logged


def fused_cross(shape, axes, kw):
    """cross(mesh=, fuse=True) of 1/sum(x) on ``axes``: `cross`'s results,
    then whether the run fused and the iterations it kept."""
    _float64()
    mesh = _mesh(shape, ("dp",))
    with par.counting_collectives() as calls:
        t, info = tn.cross(function=hilbert, domain=axes, device="cpu", verbose=False,
                           return_info=True, mesh=mesh, fuse=True, **kw)
    sets = {k: [np.asarray(x) for x in info[k]] for k in ("lsets", "rsets", "left_locals")}
    return (t.numpy(), [int(r) for r in info["Rs"]], info["nsamples"], sets, calls,
            info["fused"], len(info["val_epss"]))


def minimize_one_stream(shape, cores, kw):
    """minimum and argmin of a batch TT with mesh= on the one stream
    (``fuse=True``): the results, the collectives of each, the warnings
    logged and the one stream's record after the minimum."""
    import importlib
    import logging

    _float64()
    cross_module = importlib.import_module("tntorch_tpu_torch.cross")
    mesh = _mesh(shape, ("dp",))
    t = tn.Tensor(_t(cores), batch=True)
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    tn.utils.logger.addHandler(handler)
    try:
        with par.counting_collectives() as calls:
            m = tn.minimum(t, mesh=mesh, fuse=True, **kw)
        stats = dict(cross_module._BATCHED_MIN_STATS)
        with par.counting_collectives() as arg_calls:
            a = tn.argmin(t, mesh=mesh, fuse=True, **kw)
    finally:
        tn.utils.logger.removeHandler(handler)
    return m.numpy(), a, calls, arg_calls, logged, stats


def host_cross(axes):
    """cross(fuse="host", mesh=): the warnings logged and the dense result."""
    import logging

    _float64()
    mesh = _mesh((dist.get_world_size(),), ("dp",))
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    tn.utils.logger.addHandler(handler)
    try:
        t = tn.cross(function=hilbert, domain=axes, device="cpu", verbose=False, fuse="host",
                     mesh=mesh, seed=0)
    finally:
        tn.utils.logger.removeHandler(handler)
    return t.numpy(), logged


def als(shape, X, y, x0, R, I, niter):
    """als_completion(mesh=) from x0's cores: the dense result, the
    training eps and the collectives."""
    _float64()
    mesh = _mesh(shape)
    with par.counting_collectives() as calls:
        t, eps = tn.als_completion(X, torch.from_numpy(y), ranks_tt=R, shape=[I] * X.shape[1],
                                   x0=tn.Tensor(_t(x0)), niter=niter, verbose=False, mesh=mesh,
                                   _return_eps=True)
    return t.numpy(), eps, calls


def learner(shape, cls, kw, X, y, carried, rows, Xt):
    """A learner's fit with mesh= from a carried initial tensor (cores,
    factors, frozen modes, batch) and bootstrap rows: the losses, the
    predictions at Xt and the collectives."""
    _float64()
    mesh = _mesh(shape)
    lrn = getattr(tn, cls)(key=3, device="cpu", mesh=mesh, **kw)
    cores, Us, frozen, batch = carried

    def make(_):
        t = tn.Tensor(_t(cores), Us=_t(Us), batch=batch, requires_grad=True)
        t.frozen_Us = set(frozen)
        return t

    lrn._make_tensor = make
    if rows is not None:
        lrn._member_rows = lambda P: torch.from_numpy(rows)
    with par.counting_collectives() as calls:
        lrn.fit(X, y)
    pred = lrn.predict_proba(Xt) if cls == "TTClassifier" else lrn.predict(Xt)
    return lrn.losses_, pred.numpy(), calls, [c.is_leaf for c in lrn.tensor_.cores]


def orbax(shape, cores, Us, path):
    """save_orbax_sharded of a batch TT sharded over dp (shard_batch), then
    load_orbax_sharded onto the mesh (each rank's shards and placements)
    and without a mesh (the whole)."""
    mesh = _mesh(shape)
    t = tn.Tensor(_t(cores), Us=None if Us is None else _t(Us), batch=True)
    t.frozen_Us = {1}
    placed = par.shard_batch(t, mesh)
    tn.save_orbax_sharded(placed, path)
    back = tn.load_orbax_sharded(path, mesh=mesh)
    flat = tn.load_orbax_sharded(path, device="cpu")
    return ([list(c.placements) for c in back.cores],
            [c.to_local().numpy() for c in back.cores], [_np(c) for c in back.cores],
            [None if U is None else _np(U) for U in back.Us],
            [c.numpy() for c in flat.cores], back.frozen_Us, back.batch,
            [c.to_local().numpy() for c in placed.cores])


def learner_without_dp():
    """The error of a learner given a mesh without a 'dp' axis."""
    mesh = _mesh((dist.get_world_size(),), ("tp",))
    try:
        tn.TTRegressor(mesh=mesh, device="cpu")
    except ValueError as e:
        return str(e)
    return None
