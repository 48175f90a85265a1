"""Save and load compressed tensors and matrix operators.

Counterpart of ``tntorch_tpu/serialization.py``, in its ``.npz`` layout,
so that a file written by either package loads in the other: ``core_n``,
``U_n`` and ``idx_n`` arrays, ``n_cores`` for matrices, and ``meta``, JSON
bytes in a ``uint8`` array (``n_cores``, ``batch``, ``us_mask``,
``frozen_Us`` and ``version`` for a `Tensor`; ``kind``, the dimensions,
``rank`` and ``batch_size`` for a matrix). Saving reads each core from
the card once; loading lands on the card unless ``device=`` says
otherwise, like the package's other entry points. A dtype that NumPy
lacks (bfloat16) raises ``TypeError`` rather than being stored as another.

The JAX package's orbax checkpoints (``save_orbax``, ``load_orbax`` and
their sharded forms) are directories of ``torch.distributed.checkpoint``
(DCP) here: PyTorch has no orbax. They keep orbax's payload layout
(``cores``, ``Us`` and ``idxs`` keyed by mode; ``save_orbax``'s ``meta``
with ``n_cores``, ``batch`` and ``frozen_Us_mask``) and the sharded pair's
``<path>.specs.json`` sidecar in the JAX package's schema, but neither
package loads the other's directory: a load of one without DCP's
``.metadata`` raises ``ValueError``. Under an initialized process group
(`parallel`) every rank calls them with the same arguments, and DCP
writes each tensor once: a placed tensor's shards each from the rank that
holds them.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import default_device


def _host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a NumPy array, with one read from its device."""
    try:
        return x.detach().cpu().numpy()
    except TypeError:
        raise TypeError(f"cannot save a {x.dtype} array: NumPy has no such dtype; cast it "
                        "(e.g. to torch.float32) first") from None


def _npz(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _meta(data) -> dict:
    return json.loads(bytes(data["meta"]).decode())


def _write(path, arrays: dict, meta: dict):
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _device_arrays(arrays, device):
    """The host arrays as torch tensors on ``device`` (default: the card)."""
    return [None if a is None else torch.from_numpy(a).to(device or default_device())
            for a in arrays]


def save(t: Tensor, path):
    """Write a `Tensor` (cores, Tucker factors, ``idxs``, the batch flag and
    ``frozen_Us``) to the ``.npz`` file ``path``."""
    meta = {
        "n_cores": t.dim(),
        "batch": bool(t.batch),
        "us_mask": [U is not None for U in t.Us],
        "frozen_Us": sorted(int(m) for m in t.frozen_Us),
        "version": 1,
    }
    arrays = {f"core_{n}": _host(c) for n, c in enumerate(t.cores)}
    arrays.update({f"U_{n}": _host(U) for n, U in enumerate(t.Us) if U is not None})
    arrays.update({f"idx_{n}": np.asarray(idx) for n, idx in enumerate(t.idxs or [])
                   if idx is not None})
    _write(path, arrays, meta)


def load(path, device=None) -> Tensor:
    """A `Tensor` stored by `save` (of either package), on ``device``
    (default: the card)."""
    with np.load(_npz(path)) as data:
        meta = _meta(data)
        N = meta["n_cores"]
        cores = _device_arrays([data[f"core_{n}"] for n in range(N)], device)
        Us = _device_arrays([data[f"U_{n}"] if meta["us_mask"][n] else None
                             for n in range(N)], device)
        idxs = [data[f"idx_{n}"] if f"idx_{n}" in data else None
                for n in range(N + (1 if meta["batch"] else 0))]
    t = Tensor(cores, Us=Us, idxs=idxs if any(i is not None for i in idxs) else None,
               batch=meta["batch"])
    t.frozen_Us = set(meta.get("frozen_Us", ()))
    return t


def save_matrix(m, path):
    """Write a `TTMatrix` or `CPMatrix` to the ``.npz`` file ``path``."""
    from tntorch_tpu_torch.models.matrix import CPMatrix, TTMatrix

    if isinstance(m, TTMatrix):
        kind = "tt"
    elif isinstance(m, CPMatrix):
        kind = "cp"
    else:
        raise TypeError(f"save_matrix expects TTMatrix or CPMatrix, got {type(m)}")
    meta = {
        "kind": kind,
        "input_dims": [int(d) for d in m.input_dims],
        "output_dims": [int(d) for d in m.output_dims],
        "version": 1,
    }
    if kind == "cp":
        meta["rank"] = int(m.rank)
        meta["batch_size"] = int(m.batch_size)
    arrays = {f"core_{n}": _host(c) for n, c in enumerate(m.cores)}
    arrays["n_cores"] = np.asarray(len(m.cores))
    _write(path, arrays, meta)


def load_matrix(path, device=None):
    """A `TTMatrix` or `CPMatrix` stored by `save_matrix` (of either
    package), on ``device`` (default: the card)."""
    from tntorch_tpu_torch.models.matrix import CPMatrix, TTMatrix

    with np.load(_npz(path)) as data:
        meta = _meta(data)
        cores = _device_arrays([data[f"core_{n}"] for n in range(int(data["n_cores"]))], device)
    if meta["kind"] == "tt":
        return TTMatrix(cores, None, meta["input_dims"], meta["output_dims"])
    m = CPMatrix.__new__(CPMatrix)
    m.rank = meta["rank"]
    m.input_dims = np.asarray(meta["input_dims"])
    m.output_dims = np.asarray(meta["output_dims"])
    m.batch_size = meta.get("batch_size", 1)
    m.d = len(meta["input_dims"])
    m.cores = cores
    return m


def _dcp(op, state, path):
    """``torch.distributed.checkpoint.save`` or ``load`` (``op``) of the flat
    or nested ``state`` at the directory ``path``: collective under an
    initialized process group, a single process's otherwise."""
    import torch.distributed.checkpoint as dcp

    alone = not (dist.is_available() and dist.is_initialized())
    with warnings.catch_warnings():  # DCP warns of a single process, which is asked for here
        warnings.filterwarnings("ignore", "torch.distributed is disabled", UserWarning)
        getattr(dcp, op)(state, checkpoint_id=path, no_dist=alone)


def _stored(path) -> dict:
    """The tensors a DCP directory holds, by flat key ("cores.0"), as their
    storage metadata; ``ValueError`` where ``path`` is not such a
    directory (an orbax checkpoint of the JAX package, or none)."""
    from torch.distributed.checkpoint import FileSystemReader

    if not os.path.isfile(os.path.join(path, ".metadata")):
        raise ValueError(f"{path} is not a torch.distributed.checkpoint directory: the JAX "
                         "package's orbax checkpoints and this package's DCP checkpoints are "
                         "other formats, and neither package loads the other's")
    return FileSystemReader(path).read_metadata().state_dict_metadata


def _whole(x):
    """``x`` detached, a placed tensor gathered (`parallel.gather`)."""
    if hasattr(x, "to_local"):
        from tntorch_tpu_torch.parallel.mesh import gather

        x = gather(x)
    return x.detach()


def _tensor(cores, Us, idxs, batch, frozen) -> Tensor:
    """The `Tensor` of loaded cores and factors (lists by mode) and idxs (by
    position, a batch's leading one included), with ``frozen`` factors."""
    idxs = [idxs.get(str(n)) for n in range(len(cores) + (1 if batch else 0))]
    t = Tensor(cores, Us=Us, idxs=idxs if any(i is not None for i in idxs) else None,
               batch=batch)
    t.frozen_Us = set(frozen)
    return t


def save_orbax(t: Tensor, path):
    """Write ``t`` (placed tensors gathered first) to the DCP directory
    ``path`` in orbax's payload layout (module docstring)."""
    payload = {
        "cores": {str(n): _whole(c) for n, c in enumerate(t.cores)},
        "Us": {str(n): _whole(U) for n, U in enumerate(t.Us) if U is not None},
        "idxs": {str(n): torch.as_tensor(np.asarray(i)) for n, i in enumerate(t.idxs or [])
                 if i is not None},
        "meta": {"n_cores": torch.tensor(t.dim()), "batch": torch.tensor(int(t.batch)),
                 "frozen_Us_mask": torch.tensor([int(m in t.frozen_Us) for m in range(t.dim())],
                                                dtype=torch.int64)},
    }
    _dcp("save", payload, os.path.abspath(str(path)))


def _load_flat(path, stored, keys, device):
    """The tensors ``keys`` of the DCP directory ``path`` (``stored``: its
    metadata) as plain tensors on ``device``."""
    state = {k: torch.empty(stored[k].size, dtype=stored[k].properties.dtype, device=device)
             for k in keys}
    _dcp("load", state, path)
    return state


def _by_mode(state, prefix) -> dict:
    """The entries ``prefix.<mode>`` of a flat state, by mode."""
    return {k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(prefix + ".")}


def load_orbax(path, device=None) -> Tensor:
    """A `Tensor` stored by `save_orbax`, on ``device`` (default: the
    card)."""
    path = os.path.abspath(str(path))
    stored = _stored(path)
    if "meta.n_cores" not in stored:
        raise ValueError(f"{path} holds no save_orbax payload (no meta.n_cores)")
    device = device or default_device()
    state = _load_flat(path, stored, list(stored), device)
    N, batch = int(state["meta.n_cores"]), bool(int(state["meta.batch"]))
    cores, Us = _by_mode(state, "cores"), _by_mode(state, "Us")
    idxs = {k: v.cpu().numpy() for k, v in _by_mode(state, "idxs").items()}
    mask = state["meta.frozen_Us_mask"].tolist()
    return _tensor([cores[str(n)] for n in range(N)], [Us.get(str(n)) for n in range(N)], idxs,
                   batch, [m for m, bit in enumerate(mask) if bit])


def _spec_to_json(x):
    """The JAX package's JSON form of a placed tensor's ``PartitionSpec``:
    per dimension None, the mesh axis that shards it, or a list of several;
    None for a tensor that is not placed."""
    if not hasattr(x, "placements"):
        return None
    names = x.device_mesh.mesh_dim_names
    axes = [[] for _ in range(x.ndim)]
    for d, p in enumerate(x.placements):
        if p.is_partial():
            raise ValueError("a partial DTensor is not a placed tensor")
        if p.is_shard():
            axes[p.dim].append(names[d])
    return [None if not a else a[0] if len(a) == 1 else a for a in axes]


def save_orbax_sharded(t: Tensor, path):
    """Write ``t`` to the DCP directory ``path`` keeping its placements:
    each rank writes the shards of its placed cores and factors (DCP's
    DTensor support), and rank 0 writes the ``<path>.specs.json`` sidecar in
    the JAX package's schema (each leaf's spec, ``n_cores``, ``batch``,
    ``frozen_Us``, ``idxs``), so that `load_orbax_sharded` can place them
    again."""
    payload = {"cores": {str(n): c.detach() for n, c in enumerate(t.cores)},
               "Us": {str(n): U.detach() for n, U in enumerate(t.Us) if U is not None}}
    meta = {
        "n_cores": t.dim(),
        "batch": bool(t.batch),
        "frozen_Us": sorted(int(m) for m in t.frozen_Us),
        "core_specs": [_spec_to_json(c) for c in t.cores],
        "U_specs": {str(n): _spec_to_json(U) for n, U in enumerate(t.Us) if U is not None},
        "idxs": {str(n): np.asarray(i).tolist() for n, i in enumerate(t.idxs or [])
                 if i is not None},
        "version": 1,
    }
    path = os.path.abspath(str(path))
    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        # before DCP's save, which ends with every rank in step: no rank
        # returns before the sidecar is written
        with open(path + ".specs.json", "w") as fh:
            json.dump(meta, fh)
    _dcp("save", payload, path)


def load_orbax_sharded(path, mesh=None, device=None) -> Tensor:
    """A `Tensor` stored by `save_orbax_sharded`. With ``mesh``, each core
    and factor comes back as a DTensor placed as the sidecar records (an
    axis it names must be one of the mesh's), each rank reading only its
    own shards; without, as plain tensors on ``device`` (default: the
    card)."""
    path = os.path.abspath(str(path))
    stored = _stored(path)
    with open(path + ".specs.json") as fh:
        meta = json.load(fh)
    N = int(meta["n_cores"])
    specs = {f"cores.{n}": s for n, s in enumerate(meta["core_specs"])}
    specs.update({f"Us.{k}": s for k, s in meta["U_specs"].items()})
    if mesh is None:
        state = _load_flat(path, stored, list(specs), device or default_device())
    else:
        state = {k: _placed_template(stored[k], s, mesh) for k, s in specs.items()}
        _dcp("load", state, path)
    cores, Us = _by_mode(state, "cores"), _by_mode(state, "Us")
    idxs = {k: np.asarray(v) for k, v in (meta.get("idxs") or {}).items()}
    return _tensor([cores[str(n)] for n in range(N)], [Us.get(str(n)) for n in range(N)], idxs,
                   bool(meta["batch"]), meta.get("frozen_Us", ()))


def _placed_template(stored, spec, mesh):
    """An empty DTensor of a stored tensor's shape and dtype, placed on
    ``mesh`` as the JAX-schema ``spec`` says (None: replicated): DCP loads
    each rank's shards into it."""
    from tntorch_tpu_torch.parallel.mesh import _chunk, _wrap, placements

    if any(isinstance(a, list) for a in spec or ()):
        raise ValueError(f"spec {spec}: a dimension sharded over several mesh axes is not "
                         "supported")
    size = tuple(stored.size)
    where = placements(spec or (), mesh.mesh_dim_names)
    local, coord = list(size), mesh.get_coordinate()
    for d, p in enumerate(where):
        if p.is_shard():
            start, stop = _chunk(size[p.dim], mesh.size(d), coord[d])
            local[p.dim] = stop - start
    return _wrap(torch.empty(local, dtype=stored.properties.dtype, device=mesh.device_type),
                 mesh, where, size)
