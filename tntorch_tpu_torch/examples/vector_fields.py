"""Vector calculus on compressed fields
(reference docs/tutorials/derivatives.ipynb + BASELINE config 5).

Gradient / divergence / curl / Laplacian of 3D fields, plus batched vector
field ops using batch=True (a leading batch dim through every core). The
port of ``examples/vector_fields.py``.
"""

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, running
from tntorch_tpu_torch.utils import seed


def main(device=None, dtype=None) -> dict:
    out = {}
    with running(device, dtype) as (device, dtype):
        I = 64
        axes = [torch.linspace(0, 1, I, dtype=dtype, device=device)] * 3
        X, Y, Z = tn.meshgrid(axes)

        # Scalar potential phi = x^2 + y*z (low-rank by construction)
        phi = X * X + Y * Z
        bounds = [[0, 1]] * 3

        g = tn.gradient(phi, bounds=bounds)
        out["gradient_ranks"] = [int(max(gi.ranks_tt)) for gi in g]
        print("gradient ranks:", out["gradient_ranks"])

        # curl(grad phi) = 0
        c = tn.curl(g, bounds=bounds)
        out["curl_norms"] = [float(tn.norm(ci)) for ci in c]
        print("||curl grad phi|| (should be ~0):", out["curl_norms"])

        div = tn.divergence(g, bounds=bounds)
        lap = tn.laplacian(phi, bounds=bounds)
        out["div_minus_laplacian"] = float(tn.norm(div - lap))
        print("||div grad - laplacian||:", out["div_minus_laplacian"])

        # Active subspace of the potential
        w, v = tn.active_subspace(phi, bounds=bounds)
        out["eigenvalues"] = figure(w)
        print("active-subspace eigenvalues:", np.round(np.asarray(out["eigenvalues"]), 6))

        # Batched 3D fields: 8 fields processed at once (batch dim in every core)
        B = 8
        batch = tn.randn(B, I, I, I, ranks_tt=4, batch=True, generator=seed(0, "cpu"),
                         device=device, dtype=dtype)
        batch.round_tt(rmax=3, algorithm="gram")  # batched Gram rounding
        out["round_ranks"], out["batch"] = figure(batch.ranks_tt), int(batch.b())
        print("batched round ranks:", batch.ranks_tt, "batch:", out["batch"])
        s = batch + batch
        out["sum_shape"] = list(s.shape)
        print("batched arithmetic ok:", s.shape)
    return out


if __name__ == "__main__":
    main()
