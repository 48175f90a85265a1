"""Gradient-based fitting of compressed tensors.

Counterpart of ``tntorch_tpu/autodiff.py`` (``optimize``, ``dof``). JAX's
jitted loss -> grad -> optax step becomes PyTorch autograd and a
``torch.optim`` optimizer running eagerly; ``block_iters`` keeps its
meaning (the loss history is fetched, and convergence checked, once per
block of steps). The losses, step count and stopping rule are the JAX
package's. A loss built on ``t[X]`` evaluates through `ops.tt_eval.TTEval`,
so on the card every step runs the evaluation kernel forward and backward.

With ``mesh=`` (a ``DeviceMesh``, `parallel`) the trainable cores and
factors become replicated DTensors, as the JAX package replicates them. A
loss over data sharded across the mesh (`parallel.shard_array`) then
evaluates on each rank's rows and reduces to the global loss through
DTensor; each rank's gradient is the part of its rows (``Partial``), which
one all-reduce per parameter sums before the step. The loss code is the
one written for one device; every rank keeps the same history.

Under ``torch.profiler`` each step records ``tn.optimize:step`` (with
``:loss``, ``:backward``, ``:update``) and each read of the losses
``tn.wait:loss_read`` (`utils.trace_annotation`).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import trace_annotation


def _leaf(x):
    return x.detach().clone().requires_grad_(True)


def _get_params(tensors, leaf=_leaf) -> list:
    """The trainable leaves: the cores and the Tucker factors outside
    ``frozen_Us`` of every `Tensor` flagged ``requires_grad`` (batch
    tensors included: an elementwise optimizer and a per-sample-separable
    loss fit every sample independently). They are replaced by fresh leaves
    (``leaf(x)``) first, so that training never writes into storage the
    caller or a clone shares; frozen factors stay as they are."""
    params = []
    for i, t in enumerate(tensors):
        if isinstance(t, Tensor):
            if t.requires_grad:
                t.cores = [leaf(c) for c in t.cores]
                t.Us = [U if U is None or m in t.frozen_Us else leaf(U)
                        for m, U in enumerate(t.Us)]
                params.extend(t.cores)
                params.extend(U for m, U in enumerate(t.Us)
                              if U is not None and m not in t.frozen_Us)
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
    """Iterative learning loop: optimizes the cores and unfrozen Tucker
    factors of every input tensor flagged ``requires_grad`` against
    ``loss_function(*tensors)``, in place.

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
    :param mesh: a ``DeviceMesh`` for data-parallel training (called by
        every rank of it): the trainable cores and factors are replicated
        over the mesh from rank 0 (`parallel.replicate_pytree`), and after
        each backward every gradient that DTensor left partial (the loss
        consumed data sharded over the mesh, `parallel.shard_array`) is
        summed over the mesh by one all-reduce before the step
    """
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    tensors = list(tensors)
    if mesh is None:
        params = _get_params(tensors)
    else:
        from tntorch_tpu_torch.parallel.algorithms import replicate_pytree

        params = _get_params(tensors, lambda x: _leaf(replicate_pytree(x, mesh)))
        verbose = verbose and torch.distributed.get_rank() == 0
    if len(params) == 0:
        raise ValueError(
            "There are no parameters to optimize. Did you forget a requires_grad=True somewhere?"
        )
    if optimizer is None:
        optimizer = lambda ps: torch.optim.Adam(ps, lr=1e-3)  # noqa: E731
    opt = optimizer(params)

    def step():
        """One update; returns the total loss and its parts, on the device.
        The gradients are freed after the update, so that each step starts
        from none."""
        with trace_annotation("tn.optimize:loss"):
            loss = loss_function(*tensors)
            parts = list(loss) if isinstance(loss, (tuple, list)) else [loss]
            total = sum(parts[1:], parts[0])  # no 0 + loss: it would settle a partial DTensor loss
        with trace_annotation("tn.optimize:backward"):
            total.backward()
            if mesh is not None:
                parts = _settle(params, parts)
                total = sum(parts[1:], parts[0])
        with trace_annotation("tn.optimize:update"):
            opt.step()
            opt.zero_grad(set_to_none=True)
        return total.detach(), [p.detach() for p in parts]

    losses_hist = []
    converged = False
    start = time.time()
    it = 0
    loss_parts = None
    if block_iters > 1:
        while True:
            block = []
            for _ in range(block_iters):
                with trace_annotation("tn.optimize:step"):
                    block.append(step())
            with trace_annotation("tn.wait:loss_read"):
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
            with trace_annotation("tn.optimize:step"):
                total, loss_parts = step()
                with trace_annotation("tn.wait:loss_read"):
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

    if verbose:
        _print_status(it, max_iter, loss_parts, losses_hist, start)
        print(" <- converged (tol={})".format(tol) if converged
              else " <- max_iter was reached: {}".format(max_iter))
    return losses_hist


def _settle(params, parts):
    """A step on a mesh: each gradient that holds the part of each rank's
    samples (a DTensor with a ``Partial`` placement) summed over the mesh,
    one all-reduce per parameter; and the loss parts, gathered: the same
    plain values on every rank."""
    from tntorch_tpu_torch.parallel.mesh import _reduce_partial, gather

    for p in params:
        if p.grad is not None:
            p.grad = _reduce_partial(p.grad)
    return [gather(p.detach()) for p in parts]


def _print_status(it, max_iter, loss_parts, losses_hist, start):
    print("iter: {: <{}} | loss: ".format(it, len("{}".format(max_iter))), end="")
    print(" + ".join("{:10.6f}".format(float(l)) for l in loss_parts), end="")
    if len(loss_parts) > 1:
        print(" = {:10.4}".format(losses_hist[-1]), end="")
    print(" | total time: {:9.4f}".format(time.time() - start), end="")


def dof(t) -> int:
    """Degrees of freedom: the total size of the trainable cores and
    factors (frozen factors excluded)."""
    if not getattr(t, "requires_grad", False):
        return 0
    return int(sum(np.prod(c.shape) for c in t.cores)) + int(sum(
        np.prod(U.shape) for m, U in enumerate(t.Us) if U is not None and m not in t.frozen_Us))
