"""Rounding traffic: one caller rounds whole ensembles of TTs back to back,
``Tensor(cores, batch=True).round_tt(rmax, algorithm)``, over a pool of
distinct ensembles used in turn.

Each ensemble member is what tntorch's ``+`` makes of two TTs of half the
configuration's rank, s + noise * n, with a random orthogonal change of
basis on every edge so that no core is block diagonal. Both s and n have
flat spectra on every edge (`_flat_tt`), so rounding to the half rank
removes the n part and the truncation is separated by 1 / noise.

The check compares a sample of the window's calls, every member of each,
with the plain reference sweep in float64, by each member's relative RMS
gap at random points of the TT, and holds the worst member."""

from __future__ import annotations

import torch

from portbench.drivers import Reservoir, Window, closed_loop, generator, worst
from portbench.reference.precision import DTYPES, Precision
from portbench.reference.rounding import round_randgram
from portbench.reference.tt import batch_values

# Members the reference rounds and evaluates at once
MEMBER_BLOCK = 16


class Driver:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.dtype_name = mix["dtype"]
        self.dtype = DTYPES[self.dtype_name]
        self.B = mix["batch"]
        self.rmax = mix["rmax"]
        self.kept = Reservoir(mix["compared_calls"], self.seed)
        self.pool = []
        self._refs = {}

    # -- inputs ------------------------------------------------------------

    def _flat_tt(self, g, ranks, scale):
        """B TTs of ``ranks`` whose every edge has a flat spectrum: the first
        core's left unfolding has orthonormal columns, the last core's right
        unfolding orthonormal rows, and each slice of a middle core is
        diag(+-1) Q diag(+-1) / sqrt(I) with Q a random orthogonal matrix, so
        that both unfoldings of a middle core are orthonormal too."""
        N, I = len(ranks) - 1, self.config["mode_size"]
        kw = dict(generator=g, device=self.device, dtype=self.dtype)

        def orthonormal(rows, cols):
            return torch.linalg.qr(torch.randn((self.B, rows, cols), **kw))[0]

        def signs(R):
            return torch.randint(0, 2, (self.B, I, R), generator=g, device=self.device
                                 ).to(self.dtype) * 2 - 1

        cores = [orthonormal(I, ranks[1])[:, None] * scale]
        for k in range(1, N - 1):
            Q = orthonormal(ranks[k], ranks[k + 1])
            left, right = signs(ranks[k]), signs(ranks[k + 1])
            cores.append(left.permute(0, 2, 1)[..., None] * Q[:, :, None, :]
                         * right[:, None, :, :] / I ** 0.5)
        cores.append(orthonormal(I, ranks[N - 1]).mT[..., None])
        return cores

    def _ensemble(self, g):
        """B members, each s + noise * n with a random basis on every edge."""
        N, R = self.config["modes"], self.config["rank"]
        h = R // 2
        half = [1] + [h] * (N - 1) + [1]
        s = self._flat_tt(g, half, 1.0)
        n = self._flat_tt(g, half, self.mix["noise"])
        I = self.config["mode_size"]
        cores = [torch.cat([s[0], n[0]], dim=-1)]
        for k in range(1, N - 1):
            c = torch.zeros((self.B, R, I, R), device=self.device, dtype=self.dtype)
            c[:, :h, :, :h] = s[k]
            c[:, h:, :, h:] = n[k]
            cores.append(c)
        cores.append(torch.cat([s[-1], n[-1]], dim=1))
        del s, n
        kw = dict(generator=g, device=self.device, dtype=self.dtype)
        for k in range(1, N):  # the edge between cores k-1 and k
            Q = torch.linalg.qr(torch.randn((R, R), **kw))[0]
            cores[k - 1] = cores[k - 1] @ Q
            cores[k] = torch.einsum("ab,zbic->zaic", Q.mT, cores[k])
        return [c.contiguous() for c in cores]

    def setup(self):
        import tntorch_tpu_torch as tn

        self.tn = tn
        tn.set_policy(self.mix["policy"])
        g = generator(self.seed, self.device, 0)
        self.pool = [self._ensemble(g) for _ in range(self.mix["pool"])]
        for i in range(len(self.pool)):  # every input of the window, once
            self.call(i)
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()

    # -- the window ----------------------------------------------------------

    def call(self, i):
        t = self.tn.Tensor(self.pool[i % len(self.pool)], batch=True)
        t.round_tt(rmax=self.rmax, algorithm=self.mix["algorithm"])
        return t.cores

    def window(self, seconds, hooks, sync) -> Window:
        return closed_loop(self.call, seconds, self.B, sync, hooks, self.kept)

    def release(self):
        self.tn = None

    # -- the check -----------------------------------------------------------

    def _reference(self, p):
        """The plain sweep of pool ensemble ``p`` in float64, every member."""
        if p not in self._refs:
            self._refs[p] = self._round(self.pool[p], Precision("float64"))
        return self._refs[p]

    def _round(self, cores, prec):
        blocks = [round_randgram([c[b:b + MEMBER_BLOCK] for c in cores], self.rmax,
                                 self.dtype_name, prec)
                  for b in range(0, self.B, MEMBER_BLOCK)]
        return [torch.cat(parts) for parts in zip(*blocks)]

    def _gaps(self, got, want, stream):
        """Each member's relative RMS gap between the TTs ``got`` and ``want``
        at the same random points of that member."""
        N, I = self.config["modes"], self.config["mode_size"]
        if (len(got) != N or any(c.ndim != 4 or c.shape[0] != self.B or c.shape[2] != I
                                 for c in got)):
            return torch.full((self.B,), float("inf"))
        g = generator(self.seed, self.device, stream)
        X = torch.randint(0, I, (self.B, self.mix["points"], N), generator=g,
                          device=self.device)
        f64 = Precision("float64")
        gaps = []
        for b in range(0, self.B, MEMBER_BLOCK):
            part = slice(b, b + MEMBER_BLOCK)
            a = batch_values([c[part] for c in got], X[part], f64)
            w = batch_values([c[part] for c in want], X[part], f64)
            gaps.append(((a - w) ** 2).sum(1).sqrt() / (w ** 2).sum(1).sqrt())
        return torch.cat(gaps).cpu()

    def _readings(self, outputs):
        """``tt_gap``, the worst member's gap to the float64 reference over
        ``outputs``: (pool index, cores) pairs."""
        return {"tt_gap": worst([self._gaps(cores, self._reference(p), 100 + p)
                                 for p, cores in outputs])}

    def check(self):
        found = self._readings([(i % len(self.pool), out) for i, out in self.kept.items])
        return {k: (v, self.mix["limits"][k]) for k, v in found.items()}

    def control(self, precision: str):
        return self._readings([(p, self._round(cores, Precision(precision)))
                               for p, cores in enumerate(self.pool)])
