"""Batched ensembles: one code path for B independent compressed tensors.

The reference rejects batch tensors in nearly every analytics routine
(metrics.py:18-23, anova.py:20-21); here the whole pipeline (statistics,
Sobol sensitivity, rounding, checkpointing) runs over the leading batch
axis in one call each instead of B Python loops. Typical use: an ensemble
of surrogate models (one per scenario/posterior draw) analyzed in one
shot. The port of ``examples/batch_ensembles.py``; its sharded orbax
checkpoint becomes a ``.npz`` one (`tn.save`/`tn.load`), always run.
"""

import os
import tempfile

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, running
from tntorch_tpu_torch.utils import seed


def main(device=None, dtype=None) -> dict:
    out = {}
    with running(device, dtype) as (device, dtype):
        kw = dict(device=device, dtype=dtype)
        B, N, I = 8, 4, 16

        # An ensemble of B perturbed models of the same 4D field
        rng = np.random.default_rng(0)
        base = tn.rand([I] * N, ranks_tt=4, generator=seed(0, "cpu"), **kw)
        dense = base.numpy()
        ensemble = np.stack(
            [dense * (1 + 0.1 * rng.standard_normal()) + 0.05 * rng.standard_normal(dense.shape)
             for _ in range(B)]
        )
        t = tn.Tensor(torch.from_numpy(ensemble).to(device, dtype), ranks_tt=8, batch=True)

        # --- Per-sample statistics, one call each (returns (B,) arrays) ---
        out["means"], out["stds"] = figure(tn.mean(t)), figure(tn.std(t))
        print("means:", np.round(out["means"], 4))
        print("stds: ", np.round(out["stds"], 4))

        # --- Per-sample Sobol sensitivity of variable 0, one call ---
        syms = tn.symbols(N, **kw)
        out["sobol_0"] = figure(tn.sobol(t, tn.only(syms[0])))
        print("sobol S_0 per member:", np.round(out["sobol_0"], 4))
        dd = figure(tn.dimension_distribution(t))
        out["dimension_distribution_0"] = dd[0]
        print("dimension distribution (member 0):", np.round(dd[0], 4))

        # --- Build an ensemble from already-compressed members: tn.stack
        # zero-pads heterogeneous per-sample ranks to a common batch tensor ---
        members = [tn.rand([I] * N, ranks_tt=r, generator=seed(100 + r, "cpu"), **kw)
                   for r in (2, 3, 5)]
        small = tn.stack(members)
        out["stacked_shape"], out["stacked_ranks"] = list(small.shape), figure(small.ranks_tt)
        print("stacked ensemble:", small.shape, "ranks", out["stacked_ranks"])
        # dist of near-identical tensors is cancellation-limited, so compare
        # relative to the member's norm
        out["stacked_errors"] = [float(tn.relative_error(members[b], small[b]))
                                 for b in range(len(members))]
        out["preserved"] = all(e < 1e-7 for e in out["stacked_errors"])
        print("per-member values preserved:", out["preserved"])

        # --- Ensemble arithmetic with per-sample scalars ---
        centered = t - tn.mean(t)  # subtracts each member's own mean
        out["centered_max"] = float(tn.mean(centered).abs().max())
        out["centered"] = out["centered_max"] < 1e-10
        print("centered means ~0:", out["centered"])

        # --- Batch rounding: fixed-rank reference rule ---
        s = t + t
        s.round_tt(rmax=8)
        out["rounded_ranks"] = figure(s.ranks_tt)
        print("rounded ranks:", out["rounded_ranks"])

        # --- Checkpoint: the whole ensemble through one .npz file ---
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ensemble.npz")
            tn.save(t, path)
            back = tn.load(path, device=device)
        out["round_trip"] = (back.batch and len(back.cores) == len(t.cores)
                             and all(torch.equal(a, b) for a, b in zip(back.cores, t.cores)))
        print("checkpoint round trip:", out["round_trip"])
    return out


if __name__ == "__main__":
    main()
