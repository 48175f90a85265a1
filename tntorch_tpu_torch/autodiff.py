"""Gradient-based fitting of compressed tensors.

Counterpart of ``tntorch_tpu/autodiff.py`` (``optimize``, ``dof``). JAX's
jitted loss -> grad -> optax step becomes PyTorch autograd and a
``torch.optim`` optimizer running eagerly; ``block_iters`` keeps its
meaning (the loss history is fetched, and convergence checked, once per
block of steps). The losses, step count and stopping rule are the JAX
package's. A loss built on ``t[X]`` evaluates through `ops.tt_eval.TTEval`,
so on the card every step runs the evaluation kernel forward and backward.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from tntorch_tpu_torch.parallel import ParallelNotPorted
from tntorch_tpu_torch.tensor import Tensor


def _get_params(tensors) -> list:
    """The trainable leaves: the cores of every `Tensor` flagged
    ``requires_grad`` (batch tensors included: an elementwise optimizer and
    a per-sample-separable loss fit every sample independently). A Tensor's
    cores are replaced by fresh leaves first, so that training never writes
    into storage the caller or a clone shares."""
    params = []
    for i, t in enumerate(tensors):
        if isinstance(t, Tensor):
            if t.requires_grad:
                t.cores = [c.detach().clone().requires_grad_(True) for c in t.cores]
                params.extend(t.cores)
        elif getattr(t, "requires_grad", False):
            raise ValueError(  # the JAX package's rule
                f"optimize() can only train tn.Tensor inputs (position {i}): wrap the "
                "parameter in a tn.Tensor (e.g. a 1-mode tensor)")
    return params


def optimize(
    tensors,
    loss_function: Callable,
    optimizer: Optional[Callable] = None,
    tol: Optional[float] = 1e-4,
    max_iter: float = 1e4,
    print_freq: int = 500,
    verbose: bool = True,
    use_jit: bool = True,
    block_iters: int = 1,
    mesh=None,
):
    """Iterative learning loop: optimizes the cores of every input tensor
    flagged ``requires_grad`` against ``loss_function(*tensors)``, in place.

    Converged when the loss is below ``tol``, or improved by a relative
    amount below ``tol`` while decelerating (the JAX package's rule). With
    ``tol=None`` it runs ``max_iter + 1`` steps. Returns the loss history:
    the loss at each step's parameters, before its update.

    :param optimizer: a callable mapping the list of parameters to a
        ``torch.optim.Optimizer``; default ``torch.optim.Adam(params,
        lr=1e-3)``, the counterpart of ``optax.adam(1e-3)``
    :param use_jit: accepted for the JAX package's signature; no effect
        (PyTorch runs eagerly)
    :param block_iters: run this many steps between reads of the loss back
        to the host; convergence is then checked once per block
    :param mesh: not ported (ROADMAP queue 1 item 12): raises
    """
    if mesh is not None:
        raise ParallelNotPorted("optimize(mesh=...)")
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    tensors = list(tensors)
    params = _get_params(tensors)
    if len(params) == 0:
        raise ValueError(
            "There are no parameters to optimize. Did you forget a requires_grad=True somewhere?"
        )
    if optimizer is None:
        optimizer = lambda ps: torch.optim.Adam(ps, lr=1e-3)  # noqa: E731
    opt = optimizer(params)

    def step():
        """One update; returns the total loss and its parts, on the device."""
        opt.zero_grad(set_to_none=True)
        loss = loss_function(*tensors)
        parts = list(loss) if isinstance(loss, (tuple, list)) else [loss]
        total = sum(parts)
        total.backward()
        opt.step()
        return total.detach(), [p.detach() for p in parts]

    losses_hist = []
    converged = False
    start = time.time()
    it = 0
    loss_parts = None
    if block_iters > 1:
        while True:
            block = [step() for _ in range(block_iters)]
            losses_hist.extend(torch.stack([tl for tl, _ in block]).tolist())  # one sync
            loss_parts = block[-1][1]
            it += block_iters
            if len(losses_hist) >= 3 and tol is not None:
                l3, l2, l1 = losses_hist[-3], losses_hist[-2], losses_hist[-1]
                delta = l1 - l2
                if (l1 <= tol or 0 <= -delta / l1 <= tol) and l2 - l1 < l3 - l2:
                    converged = True
                    break
            if it >= max_iter:
                break
            if verbose and it % max(print_freq, block_iters) < block_iters:
                _print_status(it, max_iter, loss_parts, losses_hist, start)
                print()
    else:
        while True:
            total, loss_parts = step()
            losses_hist.append(float(total))
            delta_loss = losses_hist[-1] - losses_hist[-2] if len(losses_hist) >= 2 else float("-inf")
            # A transient loss increase (delta > 0) does not count as convergence
            if (
                it >= 2
                and tol is not None
                and (losses_hist[-1] <= tol or 0 <= -delta_loss / losses_hist[-1] <= tol)
                and losses_hist[-2] - losses_hist[-1] < losses_hist[-3] - losses_hist[-2]
            ):
                converged = True
                break
            if it == max_iter:
                break
            if verbose and it % print_freq == 0:
                _print_status(it, max_iter, loss_parts, losses_hist, start)
                print()
            it += 1

    opt.zero_grad(set_to_none=True)  # the trained cores stay in t.cores; free the last grads
    if verbose:
        _print_status(it, max_iter, loss_parts, losses_hist, start)
        print(" <- converged (tol={})".format(tol) if converged
              else " <- max_iter was reached: {}".format(max_iter))
    return losses_hist


def _print_status(it, max_iter, loss_parts, losses_hist, start):
    print("iter: {: <{}} | loss: ".format(it, len("{}".format(max_iter))), end="")
    print(" + ".join("{:10.6f}".format(float(l)) for l in loss_parts), end="")
    if len(loss_parts) > 1:
        print(" = {:10.4}".format(losses_hist[-1]), end="")
    print(" | total time: {:9.4f}".format(time.time() - start), end="")


def dof(t) -> int:
    """Degrees of freedom: the total size of the trainable cores."""
    if not getattr(t, "requires_grad", False):
        return 0
    return int(sum(np.prod(c.shape) for c in t.cores))
