"""Evaluation traffic: one caller evaluates one TT at a batch of uniform
random coordinates per call, ``tn.tt_eval(cores, X)``, over a pool of
distinct batches used in turn. The check compares every value of a sample
of the window's calls with the plain chain in float64, each against the
sum of the magnitudes of its terms (the chain on |C_k|)."""

from __future__ import annotations

import torch

from portbench.drivers import Reservoir, Window, closed_loop, generator, worst
from portbench.reference.precision import DTYPES, Precision
from portbench.reference.tt import tt_values


def tt_cores(config, dtype, g, device):
    """The configuration's TT, cores N(0, 1/R_k) so that values are O(1)."""
    N, I, R = config["modes"], config["mode_size"], config["rank"]
    ranks = [1] + [R] * (N - 1) + [1]
    return [torch.randn((ranks[k], I, ranks[k + 1]), generator=g, device=device, dtype=dtype)
            / ranks[k] ** 0.5 for k in range(N)]


class Driver:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.dtype_name = mix["dtype"]
        self.P = mix["points"]
        self.kept = Reservoir(mix["compared_calls"], self.seed)

    def setup(self):
        import tntorch_tpu_torch as tn

        self.tn = tn
        g = generator(self.seed, self.device, 0)
        self.cores = tt_cores(self.config, DTYPES[self.dtype_name], g, self.device)
        N, I = self.config["modes"], self.config["mode_size"]
        self.pool = [torch.randint(0, I, (self.P, N), generator=g, device=self.device)
                     for _ in range(self.mix["pool"])]
        for i in range(len(self.pool)):
            self.call(i)
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()

    def call(self, i):
        return self.tn.tt_eval(self.cores, self.pool[i % len(self.pool)])

    def window(self, seconds, hooks, sync) -> Window:
        return closed_loop(self.call, seconds, self.P, sync, hooks, self.kept)

    def release(self):
        self.tn = None

    def _gaps(self, values, X):
        """|value - reference| over the sum of the magnitudes of its terms."""
        f64 = Precision("float64")
        if values.shape != (X.shape[0],):
            return torch.full((1,), float("inf"))
        want = tt_values(self.cores, X, f64)
        scale = tt_values(self.cores, X, f64, absolute=True)
        return ((values.double() - want).abs() / scale).cpu()

    def check(self):
        gaps = [self._gaps(v, self.pool[i % len(self.pool)]) for i, v in self.kept.items]
        return {"value_gap": (worst(gaps), self.mix["limits"]["value_gap"])}

    def control(self, precision: str):
        prec = Precision(precision)
        gaps = [self._gaps(tt_values(self.cores, X, prec), X) for X in self.pool]
        return {"value_gap": worst(gaps)}
