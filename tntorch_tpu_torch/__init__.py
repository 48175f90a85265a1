"""tntorch_tpu_torch: the PyTorch + CUDA port of ``tntorch_tpu``.

The same flat ``tn.*`` namespace, for the slices ported so far: build a
tensor train with optional Tucker factors (from cores and factors; from
dense data, exactly or by TT-SVD and Tucker rounding to ``ranks_tt``/
``ranks_tucker`` or an error budget ``eps``; at random with
``rand``/``randn``), do arithmetic on it (``+``, ``-``, ``*``, ``~ & | ^``),
round it (``round_tt``: the error-budgeted sweep and fixed-rank Gram
rounding, batched on hand-written Hopper kernels; ``round_tucker``;
``round``, both in turn), measure it (``dot``, ``norm``, ``dist``,
``relative_error``, ``rmse``, ``r_squared``, ``sum``, ``mean``, ``var``,
``std``), reshape it (``ttm``, ``squeeze``, ``unsqueeze``), index and
evaluate it (``t[key]``, ``tt_eval``, on the card's evaluation kernels)
and fit it (``optimize``). Data without a device lands on the CUDA card
(`utils.default_device`). The package imports torch and numpy, never jax.
Names of ``tntorch_tpu`` outside the slices exist here as functions that
raise ``NotImplementedError`` naming the ROADMAP item that will port them.
"""

from tntorch_tpu_torch import interop, parallel, tools, utils
from tntorch_tpu_torch.autodiff import dof, optimize
from tntorch_tpu_torch.create import rand, randn
from tntorch_tpu_torch.metrics import (
    dist, dot, mean, norm, normsq, r_squared, relative_error, rmse, std, sum, var,
)
from tntorch_tpu_torch.ops.tt_eval import tt_eval
from tntorch_tpu_torch.ops.rounding import (
    round_tt_fixed, round_tt_gram, round_tt_gram_batched, tt_dot, tt_full,
)
from tntorch_tpu_torch.round import round, round_tt, round_tucker, truncated_svd
from tntorch_tpu_torch.tensor import Tensor, _not_ported_stub
from tntorch_tpu_torch.tools import squeeze, ttm, unsqueeze
from tntorch_tpu_torch.utils import get_policy, set_policy

_NOT_PORTED = {
    "cross": "queue 1 item 7",
    "maxvol": "queue 1 item 7",
    "sobol": "queue 1 item 10",
    "save": "queue 1 item 11",
    "load": "queue 1 item 11",
}


globals().update({name: _not_ported_stub(name, item) for name, item in _NOT_PORTED.items()})

__version__ = "0.1.0"
