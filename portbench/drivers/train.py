"""Training traffic: one ``tn.optimize`` run fits a TT to fixed samples,
``optimize([t], lambda t: mean((t[X].full() - y) ** 2), tol=None)``, with
Adam (lr from the mix) and one step a loss read, the defaults.

The run is one object from set-up to the window's end: its first
``warmup_steps`` steps are set-up, and the window opens at the next entry
to the loss and closes at the first entry after ``seconds``. That entry's
step still runs, outside the window, and the entry after it raises to end
the run. A step's time is the interval between successive entries to the
loss. The targets y are the values of a second random TT of the
configuration's shape, made by the plain chain.

The check follows the reference through the first three steps from the
same start: each step's loss, the norm of each core's first gradient (as
Adam holds it after one step, exp_avg / (1 - beta1)), and the norm of
each core's change after three steps, as the fourth step's entry finds
the cores. It then holds the window's last step: from the cores and Adam's
moments as the closing entry finds them, the values that the step's loss
read (each over the sum of its terms' magnitudes) and each core's change
norm after that step. (That step the reference can follow only from the
program's own state; the first three hold the start. The model has more
parameters than samples, so by the window's end the fit sits at float32's
rounding, where the change norms of sound runs part from the reference's
by up to about a sixth: that number catches a step that did not happen or
went grossly wrong.) Norms are
compared by the worst core: the gap between the program's norm and the
reference's, over the larger of the reference's norm of that core and of
the median core, leaving out cores whose reference gradient is under a
thousandth of the median core's."""

from __future__ import annotations

import statistics
import time

import torch

from portbench.drivers import Window, generator, worst
from portbench.drivers.eval import tt_cores
from portbench.reference.precision import DTYPES, Precision
from portbench.reference.training import BETAS, first_steps, step_from
from portbench.reference.tt import tt_values

CHECKED_STEPS = 3


class WindowClosed(Exception):
    """Raised from the loss at the first entry after the window's seconds."""


def norm_gaps(got, want) -> float:
    """The worst core's |norm(got) - norm(want)| over max(norm(want), the
    median core's norm(want))."""
    median = statistics.median(want)
    return max(abs(a - b) / max(b, median) for a, b in zip(got, want))


def moved(got, want, ref_grads):
    """The entries of ``got`` and ``want`` for the cores that the reference's
    gradient moves: not under a thousandth of the median core's."""
    kept = [k for k, g in enumerate(ref_grads) if g >= 1e-3 * statistics.median(ref_grads)]
    return [got[k] for k in kept], [want[k] for k in kept]


def _norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


class Driver:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.dtype_name = mix["dtype"]
        if mix["warmup_steps"] <= CHECKED_STEPS:
            raise ValueError("the checked steps have to be set-up's: warmup_steps > "
                             f"{CHECKED_STEPS}")
        self.losses, self.first_grads, self.changes = [], None, None
        self.late, self.late_values, self.late_after = None, None, None

    def setup(self):
        import tntorch_tpu_torch as tn

        self.tn = tn
        dtype = DTYPES[self.dtype_name]
        g = generator(self.seed, self.device, 0)
        self.init = tt_cores(self.config, dtype, g, self.device)
        teacher = tt_cores(self.config, dtype, g, self.device)
        N, I = self.config["modes"], self.config["mode_size"]
        self.X = torch.randint(0, I, (self.mix["samples"], N), generator=g, device=self.device)
        self.y = tt_values(teacher, self.X, Precision(self.dtype_name)).to(dtype)
        self.t = tn.Tensor([c.clone() for c in self.init], requires_grad=True)

    def _adam(self, params):
        self.opt = torch.optim.Adam(params, lr=self.mix["lr"])
        return self.opt

    def window(self, seconds, hooks, sync) -> Window:
        """Runs the whole optimize run; set-up's steps first, then the window."""
        warmup = self.mix["warmup_steps"]
        entries = []
        state = {}

        def loss(t):
            now = time.perf_counter()
            e = len(entries)
            entries.append(now)
            if e == 1:  # after the first update: the first gradient as Adam holds it
                nan = torch.tensor(float("nan"))
                self.first_grads = _norms(self.opt.state[p].get("exp_avg", nan) / (1 - BETAS[0])
                                          for p in t.cores)
            elif e == CHECKED_STEPS:  # the cores after three updates
                self.changes = _norms(p.detach() - c for p, c in zip(t.cores, self.init))
            if e == warmup:
                hooks.open()
                entries[e] = state["start"] = time.perf_counter()
            elif "closed" in state:  # the cores after the window's last step
                self.late_after = [p.detach().clone() for p in t.cores]
                raise WindowClosed
            elif e > warmup and now >= state["start"] + seconds:
                hooks.close(sync)
                state["closed"] = e
                self.late = self._state(t.cores)
            values = t[self.X].full()
            value = ((values - self.y) ** 2).mean()
            if e < CHECKED_STEPS:
                self.losses.append(value.detach())
            elif e == state.get("closed"):
                self.late_values = values.detach().clone()
            return value

        try:
            self.tn.optimize([self.t], loss, optimizer=self._adam, tol=None, max_iter=10 ** 12,
                             verbose=False)
        except WindowClosed:
            pass
        closed = state.get("closed", len(entries) - 1)
        steps = closed - warmup
        times = entries[warmup:closed + 1]
        return Window(seconds=times[-1] - times[0], calls=steps, work=steps,
                      latencies=[b - a for a, b in zip(times, times[1:])])

    def _state(self, cores):
        """Copies of the cores and of Adam's state for them: (cores, exp_avg,
        exp_avg_sq, steps taken); None where Adam holds no state."""
        held = [self.opt.state[p] for p in cores]
        if not all("exp_avg" in h for h in held):
            return None
        return ([p.detach().clone() for p in cores], [h["exp_avg"].clone() for h in held],
                [h["exp_avg_sq"].clone() for h in held], int(held[0]["step"]))

    def release(self):
        self.losses = [float(v) for v in self.losses]
        self.t = self.opt = self.tn = None

    def _readings(self, losses, grads, changes, ref, late, late_ref):
        ref_losses, ref_grads, ref_changes = ref
        late_values, late_changes = late
        (want, scale), ref_late_grads, ref_late_changes = late_ref
        if late_values.shape != want.shape:
            value_gap = float("inf")
        else:
            value_gap = worst([(late_values.double() - want).abs() / scale])
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_norm_gap": norm_gaps(grads, ref_grads),
            "change_norm_gap": norm_gaps(*moved(changes, ref_changes, ref_grads)),
            "late_value_gap": value_gap,
            "late_change_norm_gap": norm_gaps(*moved(late_changes, ref_late_changes,
                                                     ref_late_grads)),
        }

    def _steps(self, precision: str, rows=None):
        losses, grads, params = first_steps(self.init, self.X, self.y, self.mix["lr"],
                                            CHECKED_STEPS, Precision(precision), rows)
        return (losses, _norms(grads),
                _norms(p - c.to(p.dtype) for p, c in zip(params, self.init)))

    def _late_step(self, precision: str, rows=None):
        """(gradient norms, change norms) of one step from the window's last
        state, as the reference takes it in ``precision``."""
        cores, m, v, steps = self.late
        grads, params = step_from(cores, m, v, steps, self.X, self.y, self.mix["lr"],
                                  Precision(precision), rows)
        return _norms(grads), _norms(p - c.to(p.dtype) for p, c in zip(params, cores))

    def reference(self):
        """The float64 reference's first steps, and from the window's last
        state: its values (with their terms' magnitudes) and its step."""
        if not hasattr(self, "_ref"):
            f64, cores = Precision("float64"), self.late[0]
            values = (tt_values(cores, self.X, f64), tt_values(cores, self.X, f64, absolute=True))
            self._ref = self._steps("float64"), (values, *self._late_step("float64"))
        return self._ref

    def _program_late(self):
        return self.late_values, _norms(a - b for a, b in zip(self.late_after, self.late[0]))

    def check(self):
        if (len(self.losses) < CHECKED_STEPS or self.changes is None
                or self.late is None or self.late_values is None or self.late_after is None):
            values = dict.fromkeys(self.mix["limits"], float("inf"))
        else:
            values = self._readings(self.losses, self.first_grads, self.changes,
                                    self.reference()[0], self._program_late(),
                                    self.reference()[1])
        return {k: (v if v == v else float("inf"), self.mix["limits"][k])
                for k, v in values.items()}

    def _stand_in(self, precision: str, rows=None):
        """The readings of the reference in ``precision`` in the program's
        place, over ``rows`` of the samples in every step where given."""
        X = self.X if rows is None else self.X[:rows]
        values = tt_values(self.late[0], X, Precision(precision))
        values = torch.cat([values, values.new_zeros(self.X.shape[0] - X.shape[0])])
        _, changes = self._late_step(precision, rows)
        return self._readings(*self._steps(precision, rows), self.reference()[0],
                              (values, changes), self.reference()[1])

    def control(self, precision: str):
        return self._stand_in(precision)

    def half_batch_fault(self):
        """The readings of the reference with half of the samples left out of
        every step, the mean taken over the rest."""
        return self._stand_in("float64", self.X.shape[0] // 2)
