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

The orbax checkpoints of the JAX package (``save_orbax``, ``load_orbax``
and their sharded forms) are JAX-only and not ported: they raise
``NotImplementedError``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor, _not_ported_stub
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


# JAX-only (orbax): each raises NotImplementedError citing its ROADMAP item
globals().update({name: _not_ported_stub(name, "queue 1 item 11")
                  for name in ("save_orbax", "load_orbax", "save_orbax_sharded",
                               "load_orbax_sharded")})
