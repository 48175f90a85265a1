"""Tensor completion (reference docs/tutorials/completion.ipynb).

Two routes to fill in missing data under a low-rank prior:
- gradient descent on the cores (`tn.optimize`) with an optional smoothness
  regularizer, each step on the evaluation kernels forward and backward;
- alternating least squares (`tn.als_completion`).

The port of ``examples/completion.py``. ``max_iter`` caps both descents'
iterations (3000 and 1500 uncapped), for a short run on the CPU.
"""

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, running
from tntorch_tpu_torch.utils import seed


def main(device=None, dtype=None, max_iter=None) -> dict:
    out = {}

    def capped(n):
        return n if max_iter is None else min(n, max_iter)

    with running(device, dtype) as (device, dtype):
        kw = dict(device=device, dtype=dtype)
        rng = np.random.default_rng(0)

        # Ground truth: a smooth rank-4 field on a 32x32 grid
        gt = tn.rand([32, 32], ranks_tt=4, generator=seed(0, "cpu"), **kw)
        full = gt.full()

        # Observe 50% of the entries
        mask = rng.random((32, 32)) < 0.5
        X = np.argwhere(mask)
        y = full[torch.from_numpy(mask).to(device)]

        def rel_err(t):
            return float(torch.linalg.vector_norm(t.full().detach() - full)
                         / torch.linalg.vector_norm(full))

        # --- Route 1: gradient descent on the cores
        t = tn.rand([32, 32], ranks_tt=4, requires_grad=True, generator=seed(1, "cpu"), **kw)
        Xj = torch.from_numpy(X).to(device)

        def loss(t):
            pred = t[Xj].full()
            return torch.mean((pred - y) ** 2)

        losses = tn.optimize([t], loss, tol=1e-10, max_iter=capped(3000), print_freq=1000)
        out["iters"], out["final_loss"], out["rel_err"] = len(losses), losses[-1], rel_err(t)
        print("optimize() rel-err on unobserved:", out["rel_err"])

        # With a second-derivative smoothness prior
        t2 = tn.rand([32, 32], ranks_tt=4, requires_grad=True, generator=seed(2, "cpu"), **kw)

        def loss_smooth(t):
            pred = t[Xj].full()
            fit = torch.mean((pred - y) ** 2)
            d2 = tn.partial(t, 0, order=2)
            smooth = tn.normsq(d2) / d2.numel()
            return fit, 1e-6 * smooth

        losses = tn.optimize([t2], loss_smooth, tol=1e-10, max_iter=capped(1500), print_freq=500)
        out["smooth_iters"], out["smooth_final_loss"] = len(losses), losses[-1]

        # --- Route 2: ALS. Fixed-rank ALS is init-sensitive (the reference
        # stalls on ~half of random inits on this problem too); restarts=
        # retries plateaued inits and keeps the best fit.
        t3 = tn.als_completion(X, y, ranks_tt=4, shape=[32, 32], niter=20, verbose=False,
                               restarts=4, generator=seed(3, "cpu"))
        out["als_rel_err"] = rel_err(t3)
        print("ALS rel-err:", out["als_rel_err"])

        # --- Route 3: sparse TT-SVD. Direct (no iterations) fit of the
        # ZERO-FILLED tensor, the right tool when the observed entries
        # themselves form a low-rank pattern (e.g. complete slices). Tall
        # unfoldings (here 12288 rows on a 12288x16x16 grid) take a sketched
        # randomized-range-finder path that never materializes the unfolding,
        # so ~10^4-10^6 samples fit in seconds with bounded memory.
        shape = [12288, 16, 16]
        gt3 = tn.rand(shape, ranks_tt=3, generator=seed(3, "cpu"), **kw)
        S = np.sort(rng.choice(shape[0], 40, replace=False))  # 40 complete slices
        i2, i3 = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
        cols = np.stack([i2.ravel(), i3.ravel()], axis=1)
        Xs = np.concatenate([np.repeat(S, 256)[:, None], np.tile(cols, (len(S), 1))], axis=1)
        Xst = torch.from_numpy(Xs).to(device)
        ys = gt3[Xst].full()
        t4 = tn.sparse_tt_svd(Xs, ys, eps=1e-6, shape=shape, rmax=8)
        pred = t4[Xst].full()
        out["sparse_ranks"] = figure(t4.ranks_tt)
        out["sparse_rel_err"] = float(torch.linalg.vector_norm(pred - ys)
                                      / torch.linalg.vector_norm(ys))
        print("sparse_tt_svd (sketched) ranks:", out["sparse_ranks"],
              "rel-err at samples:", out["sparse_rel_err"])
    return out


if __name__ == "__main__":
    main()
