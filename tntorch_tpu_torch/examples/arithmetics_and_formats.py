"""Compressed arithmetics + the tensor-format zoo
(reference docs/tutorials/arithmetics.ipynb, main_formats.ipynb,
other_formats.ipynb).

Shows rank growth under +,-,* and recompression with `tn.round`, elementwise
transcendental functions via cross-approximation, and the free per-mode
mixing of TT / CP / Tucker formats in one `Tensor`. The port of
``examples/arithmetics_and_formats.py``.
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
        # --- arithmetic + rounding ---
        t1 = tn.ones([32] * 4, **kw)
        t2 = tn.ones([32] * 4, **kw)
        t = tn.round((t1 + t2) * (t2 - 2))  # ranks add/multiply, then recompress
        out["max_rank"], out["value"] = int(max(t.ranks_tt)), float(t[0, 0, 0, 0])
        print("(1+1)*(1-2) rounded:", "max rank", out["max_rank"], "value", out["value"])

        # Algebraic slice assignment
        t = tn.ones(5, 5, **kw)
        t[:3, :] = 2
        t[:, :2] *= 3
        out["assigned"] = figure(t.full())
        print("after slice assignment:\n", t.numpy())

        # A smooth multiplicative function: compress, then transform elementwise
        domain = [torch.linspace(0, np.pi, 32, **kw)] * 4
        x, y, z, w = tn.meshgrid(domain)
        t = tn.round(1 / (1 + x + y + z + w))
        out["ranks"] = figure(t.ranks_tt)
        print("1/(1+x+y+z+w):", "TT ranks", t.ranks_tt)

        s = tn.round(tn.sin(t) ** 2 + tn.cos(t) ** 2)  # == 1 everywhere
        out["mean"], out["var"] = float(tn.mean(s)), float(tn.var(s))
        print("sin^2+cos^2: mean {:.6f}, var {:.3g}".format(out["mean"], out["var"]))

        # --- the format zoo: per-mode TT / CP / Tucker mixing ---
        print()
        out["zoo"] = {}
        for desc, kwargs in [
            ("TT", dict(ranks_tt=5)),
            ("TT-Tucker", dict(ranks_tt=5, ranks_tucker=6)),
            ("TT-Tucker (partial)", dict(ranks_tt=5, ranks_tucker=[None, 6, None, None, 7])),
            ("Tucker (as TT-Tucker)", dict(ranks_tucker=3)),
            ("CP", dict(ranks_cp=4)),
            ("hybrid TT-CP", dict(ranks_tt=[2, 3, None, None], ranks_cp=[None, None, None, 4, 4])),
            ("CP-Tucker", dict(ranks_cp=2, ranks_tucker=4)),
        ]:
            t = tn.rand([32] * 5, generator=seed(0, "cpu"), **kw, **kwargs)
            out["zoo"][desc] = t.numcoef()
            print("{:22s} #coef {:>7d}  compression {:8.1f}x".format(
                desc, t.numcoef(), t.numel() / t.numcoef()))
    return out


if __name__ == "__main__":
    main()
