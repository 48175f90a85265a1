"""Decomposition formats (reference docs/tutorials/decompositions.ipynb).

TT, Tucker and CP decomposition of an analytic 128^3 field, with
compression ratios and relative errors. The port of
``examples/decompositions.py``.
"""

import time

import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, running, seconds_since


def main(device=None, dtype=None) -> dict:
    out = {}
    with running(device, dtype) as (device, dtype):
        x = torch.linspace(-1, 1, 128, dtype=dtype, device=device)
        X, Y, Z = torch.meshgrid(x, x, x, indexing="ij")
        data = torch.sqrt(torch.sqrt(X**2 + (Y + Z) ** 2) + 1e-12)
        full = tn.Tensor(data)

        for name, kwargs in (("tt", dict(ranks_tt=3)), ("tucker", dict(ranks_tucker=3)),
                             ("cp", dict(ranks_cp=3))):
            t0 = time.perf_counter()
            t = tn.Tensor(data, **kwargs)
            dt = seconds_since(t0, device)
            err = float(tn.relative_error(full, t))
            print("{:22s} compression {:8.1f}x   rel-err {:.2e}   {:.3f}s".format(
                str(kwargs), t.numel() / t.numcoef(), err, dt))
            print(t)
            out.update({f"{name}_numcoef": t.numcoef(), f"{name}_rel_err": err,
                        f"{name}_ranks_tt": figure(t.ranks_tt),
                        f"{name}_ranks_tucker": figure(t.ranks_tucker), f"{name}_seconds": dt})

        # Hybrid: TT-Tucker
        t = tn.Tensor(data, ranks_tt=4, ranks_tucker=6)
        out["tt_tucker_rel_err"] = float(tn.relative_error(full, t))
        print("TT-Tucker rel-err:", out["tt_tucker_rel_err"])

        # Error-bounded: eps
        t = tn.Tensor(data, eps=1e-5)
        out["eps_ranks"], out["eps_rel_err"] = figure(t.ranks_tt), float(tn.relative_error(full, t))
        print("eps=1e-5 -> ranks", t.ranks_tt, "rel-err", out["eps_rel_err"])

        # The fixed-rank decomposition kernels
        t0 = time.perf_counter()
        t = tn.Tensor(data, ranks_tt=3, algorithm="randomized")
        out["randomized_rel_err"] = float(tn.relative_error(full, t))
        print("randomized TT-SVD: rel-err {:.2e} in {:.3f}s".format(
            out["randomized_rel_err"], seconds_since(t0, device)))
        t0 = time.perf_counter()
        u = t + t
        u.round_tt(1e-8, algorithm="eig")  # adaptive-eps rounding
        out["round_ranks"] = figure(u.ranks_tt)
        print("adaptive-eps round: ranks", u.ranks_tt,
              "in {:.3f}s".format(seconds_since(t0, device)))
    return out


if __name__ == "__main__":
    main()
