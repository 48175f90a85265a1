"""ANOVA decomposition + active subspaces (reference docs/tutorials/anova.ipynb
and active_subspaces.ipynb).

Everything runs in compressed TT form: the ANOVA transform, logical masking of
interaction terms, Sobol-style variance accounting, and the active-subspace
eigendecomposition of the gradient covariance. The port of
``examples/anova_active_subspaces.py``.
"""

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, running
from tntorch_tpu_torch.utils import seed


def main(device=None, dtype=None) -> dict:
    out = {}
    with running(device, dtype) as (device, dtype):
        kw = dict(device=device, dtype=dtype)
        N = 4
        t = tn.rand([32] * N, ranks_tt=5, generator=seed(0, "cpu"), **kw)

        # --- ANOVA decomposition and truncation ---
        anova = tn.anova_decomposition(t)
        x, y, z, w = tn.symbols(N, **kw)

        # Drop every interaction involving the last variable
        t_cut = tn.undo_anova_decomposition(tn.mask(anova, ~w))
        out["kept_without_w"] = float(tn.var(t_cut) / tn.var(t)) * 100
        print("variance kept without w-terms: {:.2f}%".format(out["kept_without_w"]))

        # The empty ANOVA term is the constant (global-mean) function
        empty = tn.undo_anova_decomposition(tn.mask(anova, tn.none(N, **kw)))
        out["var_f0"], out["f0"] = float(tn.var(empty)), float(empty[0, 0, 0, 0])
        out["mean"] = float(tn.mean(t))
        print("var(f_0) = {:.3g} (should be 0); f_0 = {:.6f} = mean = {:.6f}".format(
            out["var_f0"], out["f0"], out["mean"]))

        # Summing ALL terms recovers the function
        all_summed = tn.undo_anova_decomposition(tn.mask(anova, tn.true(N, **kw)))
        out["reassembly_rel_err"] = float(tn.relative_error(t, all_summed))
        print("rel-err of full ANOVA reassembly: {:.3g}".format(out["reassembly_rel_err"]))

        # Keep only interactions of order <= 2 (weight mask over the TT)
        m = tn.weight_mask(N, [0, 1, 2], **kw)
        t_trunc = tn.truncate_anova(t, m, keepdim=True)
        out["order2_rel_err"] = float(tn.relative_error(t, t_trunc))
        print("rel-err after order<=2 truncation: {:.4f}".format(out["order2_rel_err"]))

        # Sobol variance shares
        out["sobol_without_w"] = float(tn.sobol(t, ~w)) * 100
        out["sobol_singletons"] = float(tn.sobol(t, tn.only(x | y | z))) * 100
        print("sobol share of terms without w: {:.2f}%".format(out["sobol_without_w"]))
        print("sobol share of pure x/y/z singletons: {:.2f}%".format(out["sobol_singletons"]))

        # --- Active subspaces of a learned surrogate ---
        rng = np.random.default_rng(0)
        ticks, P = 64, 100

        def f(X):
            return X[:, 0] * X[:, 1] + X[:, 2]  # x3 is inactive

        X = np.round(rng.uniform(size=(P, N)) * (ticks - 1))
        yv = f(X)

        s = tn.rand([ticks] * N, ranks_tt=2, ranks_tucker=2, requires_grad=True,
                    generator=seed(1, "cpu"), **kw)
        s.set_factors("legendre")

        Xi = torch.from_numpy(X.astype(np.int64)).to(device)
        yj = torch.from_numpy(yv).to(device, dtype)

        def loss(s):
            return torch.linalg.vector_norm(s[Xi].full() - yj) / torch.linalg.vector_norm(yj)

        out["losses"] = len(tn.optimize(s, loss, verbose=False))
        eigvals, _ = tn.active_subspace(s, bounds=None)
        ev = np.asarray(figure(eigvals))
        out["eigenvalues"] = ev.tolist()
        out["smallest_share"] = 100 * ev.min() / ev.sum()
        print("active-subspace eigenvalues:", np.round(ev, 4))
        print("(one input is inactive: smallest eigenvalue is {:.2g}% of the trace)".format(
            out["smallest_share"]))
    return out


if __name__ == "__main__":
    main()
