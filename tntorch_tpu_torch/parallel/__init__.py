"""Counterpart of ``tntorch_tpu.parallel``: meshes, dp/tp placements and
the sharded algorithms, on ``torch.distributed``.

The JAX package is single-controller (one process, a mesh of its devices,
global sharded arrays); the port runs one process per rank (SPMD): a mesh
is a ``DeviceMesh``, a sharding a list of DTensor placements, and the
sharded functions compute on local shards with explicit collectives
(`mesh`, `algorithms`). `launch` starts several ranks from one command
(on the CPU with gloo, as the tests do; on the card); ``torchrun`` does as
well. ``optimize(..., mesh=)`` trains over dp-sharded data; ``cross``,
``als_completion`` and the learners take ``mesh=`` too (their rows shard
by `local_rows` and come back by `gather_rows`), and the ``*_orbax*``
checkpoints of `serialization` write and read placed tensors.

The names load on first use, so that importing the package does not
import ``torch.distributed.tensor``.
"""

import importlib

from tntorch_tpu_torch.ops.tt_eval import tt_batch_forward

_NAMES = {
    "mesh": ("make_mesh", "placements", "place", "gather", "local_rows", "gather_rows",
             "rank_specs", "shard_batch", "shard_ranks", "replicate", "sharded_dot",
             "sharded_norm", "tt_forward_sharded", "tt_forward_shard_map"),
    "algorithms": ("round_tt_gram_sharded", "round_tt_batch_sharded", "shard_array",
                   "replicate_pytree"),
    "launch": ("Group", "RankError", "run", "counting_collectives"),
}
_WHERE = {name: module for module, names in _NAMES.items() for name in names}


def __getattr__(name):
    if name in _NAMES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _WHERE:
        return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["tt_batch_forward", *_WHERE]
