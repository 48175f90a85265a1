"""tntorch_tpu_torch: the PyTorch + CUDA port of ``tntorch_tpu``.

The same flat ``tn.*`` namespace, for the slices ported so far: build a
tensor train (from cores, exactly from dense data, or at random with
``rand``/``randn``), do arithmetic on it (``+``, ``-``, ``*``), round it
(``round_tt``: the error-budgeted sweep and fixed-rank Gram rounding,
batched on hand-written Hopper kernels), measure it (``dot``, ``norm``,
``dist``, ``relative_error``), index and evaluate it (``t[key]``,
``tt_eval``, on the card's evaluation kernels) and fit it (``optimize``).
Data without a device lands on the CUDA card (`utils.default_device`).
The package imports torch and numpy, never jax. Names of ``tntorch_tpu``
outside the slices exist here as functions that raise
``NotImplementedError`` naming the ROADMAP item that will port them.
"""

from tntorch_tpu_torch import interop, parallel, utils
from tntorch_tpu_torch.autodiff import dof, optimize
from tntorch_tpu_torch.create import rand, randn
from tntorch_tpu_torch.metrics import dist, dot, norm, normsq, relative_error
from tntorch_tpu_torch.ops.tt_eval import tt_eval
from tntorch_tpu_torch.ops.rounding import (
    round_tt_fixed, round_tt_gram, round_tt_gram_batched, tt_dot, tt_full,
)
from tntorch_tpu_torch.round import round_tt, truncated_svd
from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import get_policy, set_policy

_NOT_PORTED = {
    "round": "queue 1 item 3",
    "round_tucker": "queue 1 item 3",
    "cross": "queue 1 item 7",
    "maxvol": "queue 1 item 7",
    "sobol": "queue 1 item 10",
    "save": "queue 1 item 11",
    "load": "queue 1 item 11",
}


def _not_ported_stub(name, item):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"tn.{name} is not ported yet (ROADMAP.md, {item})")

    stub.__name__ = stub.__qualname__ = name
    return stub


globals().update({name: _not_ported_stub(name, item) for name, item in _NOT_PORTED.items()})

__version__ = "0.1.0"
