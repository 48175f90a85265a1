"""The tutorials of the port: one module for each script of the JAX
package's ``examples/``, each printing the same lines from the same data.

    python -m tntorch_tpu_torch.examples.<name>                 # on the card, float32
    TN_DEVICE=cpu python -m tntorch_tpu_torch.examples.<name>   # on the CPU, float64

Each module has ``main(device=None, dtype=None, **caps) -> dict``, which
prints the tutorial and returns the figures it printed (and the values
that `expected.check` holds its claims with). By default it
runs on the card (`utils.default_device`) in float32, the JAX scripts'
accelerator mode; ``device="cpu"`` or ``TN_DEVICE=cpu`` runs it on the
CPU in float64, the JAX scripts' default. Without a card and without
either, it raises: nothing falls back to the CPU. Data that the JAX
script draws from ``np.random.default_rng(0)`` is drawn the same way;
random TTs and learner keys take ``torch.Generator``s from `utils.seed`,
since ``jax.random`` draws cannot be replayed. The training tutorials take
iteration caps (``max_iter=``...) for short runs on the CPU; the card
runs them uncapped.
"""

import contextlib
import os
import time

import numpy as np
import torch

from tntorch_tpu_torch import utils

# In the order of their port: the analytic ones first, then those that
# train; multichip, last, runs on several ranks (`parallel.launch`)
NAMES = ("decompositions", "arithmetics_and_formats", "sobol_indices", "logic_and_automata",
         "vector_fields", "anova_active_subspaces", "cross_approximation", "batch_ensembles",
         "completion", "pce", "classification", "exponential_machines", "multichip")


def resolve(device=None, dtype=None):
    """The tutorial's (device, dtype): ``device``, else the CPU under
    ``TN_DEVICE=cpu``, else `utils.default_device`; ``dtype``, else float64
    on the CPU and float32 on the card. Raises where the device is a card
    and there is none."""
    if device is None:
        device = "cpu" if os.environ.get("TN_DEVICE") == "cpu" else utils.default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the tutorials run on the CUDA card by default and there is none: "
                           "pass device='cpu' or set TN_DEVICE=cpu to run on the CPU")
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    return device, dtype


@contextlib.contextmanager
def running(device=None, dtype=None):
    """Within the block, torch's default dtype is the tutorial's (the
    counterpart of the JAX scripts' ``jax_enable_x64``: the package casts
    grids and fitted data to it); yields `resolve`'s (device, dtype)."""
    device, dtype = resolve(device, dtype)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield device, dtype
    finally:
        torch.set_default_dtype(prev)


def seconds_since(start, device):
    """Wall seconds since ``start`` (``time.perf_counter``), after the
    card's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - start


def figure(x):
    """A printed figure as a Python number or a (nested) list of them."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return x.tolist() if isinstance(x, (torch.Tensor, np.ndarray, np.generic)) else x
