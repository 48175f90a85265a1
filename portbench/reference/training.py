"""Plain training of a tensor train on samples: the mean squared error of
its values at the sample rows against the targets, its gradient by
autograd over blocks of rows, and Adam's update as ``torch.optim.Adam``
states it (lr, betas (0.9, 0.999), eps 1e-8, bias-corrected moments),
written out here."""

from __future__ import annotations

import torch

from portbench.reference.precision import Precision
from portbench.reference.tt import _rows_per_block

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def loss_and_grads(cores, X, y, prec: Precision, rows=None):
    """The mean of (value - y)^2 over the rows of X (all of them, or the
    first ``rows``), and the gradient of every core."""
    leaves = [c.detach().requires_grad_(True) for c in cores]
    B = X.shape[0] if rows is None else rows
    step = _rows_per_block(leaves)
    total = torch.zeros((), dtype=prec.dtype, device=X.device)
    for b0 in range(0, B, step):
        x = X[b0:min(b0 + step, B)]
        v = leaves[0][0, x[:, 0], :]
        for k in range(1, len(leaves)):
            v = prec.einsum("br,rbs->bs", v, leaves[k][:, x[:, k], :])
        part = ((v[:, 0] - y[b0:b0 + x.shape[0]]) ** 2).sum() / B
        part.backward()
        total = total + part.detach()
    return total, [c.grad.detach() for c in leaves]


class Adam:
    """torch.optim.Adam's update, on plain tensors."""

    def __init__(self, params, lr: float):
        self.lr = lr
        self.t = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    def step(self, params, grads):
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        out = []
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            out.append(p - (self.lr / c1) * m / (v.sqrt() / c2 ** 0.5 + ADAM_EPS))
        return out


def first_steps(cores, X, y, lr: float, steps: int, prec: Precision, rows=None):
    """``steps`` Adam steps from ``cores``: each step's loss (before its
    update), the first gradient, and the parameters after the last step."""
    params = [prec.cast(c) for c in cores]
    y = prec.cast(y)
    opt = Adam(params, lr)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads(params, X, y, prec, rows)
        losses.append(float(loss))
        if first is None:
            first = grads
        params = opt.step(params, grads)
    return losses, first, params


def step_from(cores, m, v, steps: int, X, y, lr: float, prec: Precision, rows=None):
    """One Adam step from a state that has taken ``steps`` steps, with first
    and second moments ``m`` and ``v``: the gradient at ``cores`` and the
    parameters after the step."""
    params = [prec.cast(c) for c in cores]
    _, grads = loss_and_grads(params, X, prec.cast(y), prec, rows)
    opt = Adam(params, lr)
    opt.t = steps
    opt.m = [prec.cast(x).clone() for x in m]
    opt.v = [prec.cast(x).clone() for x in v]
    return grads, opt.step(params, grads)
