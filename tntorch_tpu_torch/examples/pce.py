"""Polynomial chaos expansions (reference docs/tutorials/pce.ipynb + pce2.ipynb).

Two ways to build a PCE surrogate of a noisy quadratic blackbox:

1. Gradient descent on a TT-Tucker tensor whose Tucker factors are FIXED
   Legendre polynomials (`set_factors('legendre')`): the expansion
   coefficients live in the TT core and are the only trainable dof.
2. `tn.PCEInterpolator`: sparse adaptive PCE via the LARS path
   (the reference uses scikit-learn here; ours is self-contained).

The port of ``examples/pce.py``. ``max_iter`` caps both descents'
iterations (`tn.optimize`'s default, 10^4, uncapped), for a short run on
the CPU.
"""

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import running
from tntorch_tpu_torch.utils import seed


def main(device=None, dtype=None, max_iter=None) -> dict:
    out = {}
    fit = {} if max_iter is None else dict(max_iter=max_iter)
    with running(device, dtype) as (device, dtype):
        kw = dict(device=device, dtype=dtype)
        rng = np.random.default_rng(0)
        P, N, ticks = 200, 5, 32
        ntrain = int(P * 0.75)

        X = rng.integers(0, ticks, (P, N)).astype(np.float64)
        ws = rng.uniform(size=N)
        y = (X**2) @ ws
        y += rng.standard_normal(P) * y.std() / 10

        X_train = torch.from_numpy(X[:ntrain].astype(np.int64)).to(device)
        y_train = torch.from_numpy(y[:ntrain]).to(device, dtype)
        X_test = torch.from_numpy(X[ntrain:].astype(np.int64)).to(device)
        y_test = torch.from_numpy(y[ntrain:]).to(device, dtype)

        # --- unconstrained TT regression overfits ---
        t = tn.rand([ticks] * N, ranks_tt=2, requires_grad=True, generator=seed(0, "cpu"), **kw)

        def loss(t):
            return tn.relative_error(y_train, t[X_train]) ** 2

        out["plain_iters"] = len(tn.optimize(t, loss, verbose=False, **fit))
        with torch.no_grad():
            out["plain_test_rel_err"] = float(tn.relative_error(y_test, t[X_test]))
        out["plain_dof"] = tn.dof(t)
        print("plain TT    | test rel-err {:.4f} | dof {}".format(
            out["plain_test_rel_err"], out["plain_dof"]))

        # --- PCE: fixed Legendre factors, only the TT core is trainable ---
        t = tn.rand([ticks] * N, ranks_tt=2, ranks_tucker=3, requires_grad=True,
                    generator=seed(1, "cpu"), **kw)
        t.set_factors("legendre", requires_grad=False)
        out["pce_iters"] = len(tn.optimize(t, loss, verbose=False, **fit))
        with torch.no_grad():
            out["pce_test_rel_err"] = float(tn.relative_error(y_test, t[X_test]))
        out["pce_dof"] = tn.dof(t)
        print("PCE (GD)    | test rel-err {:.4f} | dof {}".format(
            out["pce_test_rel_err"], out["pce_dof"]))

        # --- sparse adaptive PCE via LARS (reference pce2.ipynb) ---
        pce = tn.PCEInterpolator(device=device)
        pce.fit(X[:ntrain], y[:ntrain], p=3, verbose=False)
        pred = pce.predict(X[ntrain:])
        out["lars_test_rel_err"] = float(torch.linalg.vector_norm(pred - y_test)
                                         / torch.linalg.vector_norm(y_test))
        out["lars_terms"] = len(pce.coef)
        print("PCE (LARS)  | test rel-err {:.4f} | {} active terms".format(
            out["lars_test_rel_err"], out["lars_terms"]))
    return out


if __name__ == "__main__":
    main()
