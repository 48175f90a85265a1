"""TT-cross approximation (reference docs/tutorials/cross.ipynb).

Builds TTs from black-box functions sampled on maxvol-chosen fibers:
a 5D Hilbert tensor over 3.4e7 grid points, then elementwise functions of
existing compressed tensors, then global minima. The port of
``examples/cross_approximation.py``.
"""

import time

import numpy as np
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, running, seconds_since
from tntorch_tpu_torch.utils import seed


def main(device=None, dtype=None) -> dict:
    out = {}
    with running(device, dtype) as (device, dtype):
        kw = dict(device=device, dtype=dtype)
        # Domain mode: f: R^5 -> R over a grid
        domain = [torch.linspace(1, 32, 32, **kw)] * 5
        t0 = time.perf_counter()
        t = tn.cross(function=lambda x, y, z, u, v: 1.0 / (x + y + z + u + v),
                     domain=domain, eps=1e-6, verbose=True, seed=0)
        out["hilbert_ranks"] = figure(t.ranks_tt)
        out["hilbert_seconds"] = seconds_since(t0, device)
        print("Hilbert 32^5:", t.ranks_tt, "in {:.2f}s".format(out["hilbert_seconds"]))

        # Matrix-callback mode
        t2 = tn.cross(function=lambda M: 1.0 / torch.sum(M, dim=1), domain=domain,
                      function_arg="matrix", eps=1e-6, verbose=False, seed=0)
        out["matrix_rel_err"] = float(tn.relative_error(t, t2))
        print("matrix mode rel-err:", out["matrix_rel_err"])

        # Tensor mode: elementwise transforms of compressed tensors
        tsq = tn.cross(function=lambda x: x**2, tensors=[t], verbose=False, seed=0)
        out["square_rel_err"] = float(tn.relative_error(tn.Tensor(t.full() ** 2), tsq))
        print("x^2 rel-err vs dense:", out["square_rel_err"])

        # Element-wise division t1 / t2 rides the same machinery
        ones = tn.ones(*t.shape, **kw)
        inv = ones / t
        out["inverse_rel_err"] = float(tn.relative_error(tn.Tensor(1 / t.full()), inv))
        print("1/t rel-err:", out["inverse_rel_err"])

        # Global optima (Oseledets' atan transform + rect_maxvol)
        q = tn.randn(8, 8, 8, 8, ranks_tt=3, generator=seed(7, "cpu"), **kw)
        out["min_found"] = float(tn.minimum(q, verbose=False))
        dense = q.full()
        out["min_true"] = float(dense.min())
        print("min found/true:", out["min_found"], out["min_true"])
        out["argmax"] = tn.argmax(q, verbose=False)
        print("argmax:", out["argmax"])
        out["max_true"], out["value_at_argmax"] = float(dense.max()), float(dense[out["argmax"]])

        # Differentiable cross (reference diffcross.ipynb): record the pivots
        # once, then replay them with fresh evaluations: no maxvol in the
        # replay, so autograd flows through the whole interpolation
        w = tn.randn(8, 8, 8, 8, ranks_tt=3, generator=seed(8, "cpu"), **kw)
        _, info = tn.cross(lambda x: x**2, tensors=[w], verbose=False, return_info=True, seed=1)
        cores = [c.detach().clone().requires_grad_(True) for c in w.cores]
        out_t = tn.cross_forward(info, lambda x: x**2, tensors=[tn.Tensor(cores)])
        g = torch.autograd.grad(tn.normsq(out_t), cores)
        out["grad_max"] = float(g[0].abs().max())
        print("grad through cross_forward: |g0| = {:.4g}".format(out["grad_max"]))
        # the same gradient without the cross, held against the replay's
        cores = [c.detach().clone().requires_grad_(True) for c in w.cores]
        exact = torch.autograd.grad(tn.normsq(tn.Tensor(cores) * tn.Tensor(cores)), cores)
        out["grad_exact_max"] = float(exact[0].abs().max())

        # Host-only functions (NumPy ufuncs, wrapped C libraries) still
        # cross-approximate: the whole sweep runs natively on the host
        # (NumPy/BLAS, cross_host.py; fuse='host' takes that path)
        def black_box(a, b, c):
            return np.sqrt(np.asarray(a) ** 2 + np.asarray(b) ** 2 + np.asarray(c) ** 2)

        dom3 = [torch.linspace(0.0, 1.0, 32, **kw)] * 3
        hb, hinfo = tn.cross(function=black_box, domain=dom3, eps=1e-6, verbose=False,
                             fuse="host", return_info=True)
        out["host_val_eps"], out["host_ranks"] = float(hinfo["val_eps"]), figure(hb.ranks_tt)
        print("host-sweep cross: val_eps={:.2e}, ranks={}".format(
            out["host_val_eps"], out["host_ranks"]))
    return out


if __name__ == "__main__":
    main()
