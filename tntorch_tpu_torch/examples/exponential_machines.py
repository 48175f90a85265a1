"""Exponential machines: TT-parameterized regression on binary features
(reference docs/tutorials/exponential_machines.ipynb; Novikov et al. 2017).

The model is w[x_1, ..., x_N], a 2^N tensor of interaction weights stored
as a TT, evaluated at the feature activation pattern of each sample
(BASELINE config 4); each step runs the evaluation kernels forward and
backward, then Adam. The port of ``examples/exponential_machines.py``.
``max_iter`` caps the iterations (6000 uncapped), for a short run on the
CPU.
"""

import time

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import running, seconds_since
from tntorch_tpu_torch.utils import seed


def main(device=None, dtype=None, max_iter=None) -> dict:
    out = {}
    with running(device, dtype) as (device, dtype):
        rng = np.random.default_rng(0)
        N, P = 10, 2000

        # Synthetic sparse-interaction ground truth over binary features
        Xb = rng.integers(0, 2, (P, N))
        y = (
            1.5 * Xb[:, 0]
            - 2.0 * Xb[:, 1]
            + 0.8 * Xb[:, 2] * Xb[:, 3]
            - 1.2 * Xb[:, 1] * Xb[:, 4] * Xb[:, 5]
            + 0.1 * rng.standard_normal(P)
        )
        X = torch.from_numpy(Xb).to(device)
        y = torch.from_numpy(y).to(device, dtype)

        w = tn.rand([2] * N, ranks_tt=4, requires_grad=True, generator=seed(0, "cpu"),
                    device=device, dtype=dtype)
        w.cores = [c * 0.3 for c in w.cores]

        def loss(w):
            pred = w[X].full()
            return torch.mean((pred - y) ** 2)

        # On the card the per-iteration loss read dominates; read the losses
        # once per block of 64 update steps
        block = 1 if device.type == "cpu" else 64
        t0 = time.perf_counter()
        losses = tn.optimize([w], loss, tol=1e-7, max_iter=6000 if max_iter is None else max_iter,
                             print_freq=1000,
                             optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
                             block_iters=block)
        out["final_mse"], out["iters"] = losses[-1], len(losses)
        out["seconds"] = seconds_since(t0, device)
        print("final mse {:.4g} after {} iters, {:.2f}s".format(
            out["final_mse"], out["iters"], out["seconds"]))

        with torch.no_grad():
            pred = w[X].full()
            ss_res = float(torch.sum((pred - y) ** 2))
            ss_tot = float(torch.sum((y - torch.mean(y)) ** 2))
        out["train_r2"] = 1 - ss_res / ss_tot
        print("train R^2:", out["train_r2"])
    return out


if __name__ == "__main__":
    main()
