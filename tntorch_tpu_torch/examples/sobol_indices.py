"""Global sensitivity analysis (reference docs/tutorials/sobol.ipynb).

Sobol indices of the 20D Sobol g-function surrogate, computed entirely in
compressed TT form (BASELINE config 5). The port of
``examples/sobol_indices.py``.
"""

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, running


def main(device=None, dtype=None) -> dict:
    out = {}
    with running(device, dtype) as (device, dtype):
        N = 20
        I = 16
        a = torch.tensor([(n - 1.0) / 2.0 for n in range(1, N + 1)], dtype=dtype, device=device)

        # g-function: prod_n (|4x_n - 2| + a_n) / (1 + a_n); separable ->
        # representable exactly as a rank-1 TT over the grid
        xs = torch.linspace(0, 1, I, dtype=dtype, device=device)
        cores = []
        for n in range(N):
            g = (torch.abs(4 * xs - 2) + a[n]) / (1 + a[n])
            cores.append(g[None, :, None])
        t = tn.Tensor(cores)

        x_syms = tn.symbols(N, device=device, dtype=dtype)
        s1 = [float(tn.sobol(t, tn.only(x_syms[n]))) for n in range(4)]
        out["first_order"] = s1
        print("first-order indices (vars 0..3):", np.round(s1, 4))

        # closed Sobol index of {x0, x1}; total index of x0
        out["closed_x0_x1"] = float(tn.sobol(t, tn.only(x_syms[0] | x_syms[1])))
        out["total_x0"] = float(tn.sobol(t, x_syms[0]))
        print("S_{x0 or x1}:", out["closed_x0_x1"])
        print("S^T_{x0}:", out["total_x0"])

        out["mean_dimension"] = float(tn.mean_dimension(t))
        print("mean dimension:", out["mean_dimension"])
        dd = figure(tn.dimension_distribution(t))
        out["dimension_distribution"] = dd[:5]
        print("dimension distribution (first 5 orders):", np.round(dd[:5], 4))

        # Moments, fully compressed
        out["mean"], out["var"] = float(tn.mean(t)), float(tn.var(t))
        print("mean:", out["mean"], " var:", out["var"])
    return out


if __name__ == "__main__":
    main()
