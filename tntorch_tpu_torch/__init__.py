"""tntorch_tpu_torch: the PyTorch + CUDA port of ``tntorch_tpu``.

The same flat ``tn.*`` namespace, for the slices ported so far: build a
tensor train, CP tensor or hybrid with optional Tucker factors (from cores
and factors; from dense data, exactly or by TT-SVD and Tucker rounding to
``ranks_tt``/``ranks_tucker``, by CP-ALS to ``ranks_cp``, or to an error
budget ``eps``; at random with
``rand``/``randn``; as constants and grids with ``ones``, ``zeros``,
``full``, ``eye``, ``gaussian``, the ``*_like`` forms, ``arange``,
``linspace``, ``logspace``), do arithmetic on it (``+``, ``-``, ``*``,
``/``, ``**``, ``~ & | ^``), apply elementwise functions to it (``exp``,
``log``, ``sqrt``, ``sin`` ... ``tanh``, ``add``, ``mul``, ``div``,
``pow``, ``atan2``, ``cumsum``, ``cumprod``; by TT-cross),
round it (``round_tt``: the error-budgeted sweep and fixed-rank Gram
rounding, batched on hand-written Hopper kernels; ``round_tucker``;
``round``, both in turn), measure it (``dot``, ``norm``, ``dist``,
``relative_error``, ``rmse``, ``r_squared``, ``sum``, ``mean``, ``var``,
``std``, ``skew``, ``kurtosis``, ``raw_moment``, ``normalized_moment``,
``hadamard_sum``), reshape it (``ttm``, ``squeeze``, ``unsqueeze``), index and
evaluate it (``t[key]``, ``tt_eval``, on the card's evaluation kernels),
fit it (``optimize``), build it from a black-box function by TT-cross
(``cross``, with ``maxvol``/``rect_maxvol``, ``meshgrid`` and ``stack``;
``cross_forward`` replays a cross differentiably), find its extremes
(``minimum``, ``argmin``, ``maximum``, ``argmax``, by the minimizing
cross), manipulate it (``cat``,
``transpose``, ``flip``, ``unbind``, ``pad``, ``mask``, ``sample``,
``hash``, ``reduce``, ``convolve``, ``shift_mode``, the unfoldings, and
Tucker bases by ``generate_basis``/``Tensor.set_factors``), complete it
from sparse samples (``als_completion``, ``sparse_tt_svd``), build
surrogates (``lars_path``, ``PCEInterpolator`` and its feature helpers)
and learn with it (``TTRegressor``, ``TTClassifier``), analyse it (ANOVA
and Sobol indices: ``anova_decomposition``, ``sobol``, ``mean_dimension``,
``dimension_distribution``, ...; propositional logic on {0, 1}^N masks:
``symbols``, ``only``, ``implies``, ...; weighted automata:
``weight_mask``, ``accepted_inputs``, ...; finite-difference calculus:
``partial``, ``gradient``, ``divergence``, ``curl``, ``laplacian``,
``active_subspace``, ``dgsm``), and build operators from it (``TTMatrix``,
``CPMatrix``, ``tt_multiply``, ``cp_multiply``), assign into it
(``t[key] = value``), and save and load it (``save``, ``load``,
``save_matrix``, ``load_matrix``, in the JAX package's ``.npz`` layout;
``save_orbax``, ``load_orbax`` and their sharded forms as
``torch.distributed.checkpoint`` directories), and shard it over several
ranks (`parallel`: meshes, dp/tp placements, the sharded dot, forwards and
Gram roundings on ``torch.distributed``, and the ``mesh=`` of
``optimize``, ``cross``, ``als_completion`` and the learners;
`parallel.launch` starts the ranks). Data without a device lands on the
CUDA card (`utils.default_device`). The package imports torch, numpy and
scipy, never jax.
"""

from tntorch_tpu_torch import (
    anova, automata, cross_host, derivatives, interop, interpolation, logic, models, parallel,
    serialization, tools, utils,
)
from tntorch_tpu_torch.anova import (
    anova_decomposition, dimension_distribution, mean_dimension, sobol, truncate_anova,
    undo_anova_decomposition,
)
from tntorch_tpu_torch.automata import accepted_inputs, length, weight, weight_mask, weight_one_hot
from tntorch_tpu_torch.autodiff import dof, optimize
from tntorch_tpu_torch.create import (
    arange, eye, full, full_like, gaussian, gaussian_like, linspace, logspace, ones, ones_like,
    rand, rand_like, randn, randn_like, zeros, zeros_like,
)
from tntorch_tpu_torch.cross import (
    argmax, argmin, cross, cross_forward, init_interfaces, maximum, minimum,
)
from tntorch_tpu_torch.derivatives import (
    active_subspace, curl, dgsm, divergence, gradient, laplacian, partial, partialset,
)
from tntorch_tpu_torch.interpolation import (
    PCEInterpolator, als_completion, empirical_marginals, features2indices, get_bounding_box,
    gram_schmidt, indices2features, lars_path, sparse_tt_svd,
)
from tntorch_tpu_torch.logic import (
    absence, all, any, equiv, false, implies, irrelevant_symbols, is_contradiction,
    is_satisfiable, is_tautology, none, one, only, presence, relevant_symbols, symbols, true,
)
from tntorch_tpu_torch.maxvol import maxvol, py_maxvol, py_rect_maxvol, rect_maxvol
from tntorch_tpu_torch.metrics import (
    dist, dot, hadamard_sum, kurtosis, mean, norm, normalized_moment, normsq, r_squared,
    raw_moment, relative_error, rmse, skew, std, sum, var,
)
from tntorch_tpu_torch.ops import *  # noqa: F401,F403 (the elementwise family)
from tntorch_tpu_torch.ops.tt_eval import tt_eval
from tntorch_tpu_torch.ops.rounding import (
    round_tt_fixed, round_tt_gram, round_tt_gram_batched, tt_dot, tt_full,
)
from tntorch_tpu_torch.round import round, round_tt, round_tucker, truncated_svd
from tntorch_tpu_torch.serialization import (
    load, load_matrix, load_orbax, load_orbax_sharded, save, save_matrix, save_orbax,
    save_orbax_sharded,
)
from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.models import (
    CPMatrix, TTClassifier, TTMatrix, TTRegressor, cp_multiply, matrix, tt_multiply,
)
from tntorch_tpu_torch.tools import (
    cat, convolve, flip, generate_basis, hash, left_unfolding, mask, meshgrid, pad, reduce,
    right_unfolding, sample, shift_mode, squeeze, stack, transpose, ttm, unbind, unfolding,
    unsqueeze,
)
from tntorch_tpu_torch.utils import (
    asarray, default_dtype, get_policy, matmul_precision, next_key, set_policy,
)

__version__ = "0.1.0"
