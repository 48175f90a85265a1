#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tntorch_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, then the result lines
    python3 chip_smoke.py --only 3b,8     # probe, build and those phases only

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, each fatal on failure:

1. device probe: a CUDA card must be present (no CPU fallback);
2. build the hand-written kernels from ``tntorch_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on the card, float32 and
   float64: the Gram kernels at the bench cell's shapes and at ragged
   shapes, the evaluation kernels (``tt_eval`` on both its kernels and
   ``tt_eval_backward`` on both its paths, grouped and per sample, each
   forced at every shape with `tt_path` and `tt_bwd_path`) at the
   evaluation design shape (N=4, I=1024, R=64, B=2^20), the training shape
   (N=3, I=256, R=16, B=8192), ragged shapes with negative coordinates
   (B=1000 and B=1) and a skewed shape (~90% of 2^18 samples on one
   coordinate of a middle mode, so that a run is split across blocks);
   with times, each kernel's bound and a one-call PyTorch yardstick where
   there is one. Both evaluation kernels and both backward paths are
   timed in turns at the design shape and at B/I = 8..256 (their
   crossovers), the grouped ones must give bitwise the same values on two
   calls, and the per-sample backward's device time at the training shape
   is read by the profiler beside its call's time.
   ``gram_edge``, ``wgram`` and ``proj2`` are each held on both of their
   kernels (the resident one: G or W, or the projectors, in shared memory;
   and the two-stage kernel, which also serves the shapes beyond the
   resident tile), each call also bitwise equal to a second one; at the
   bench shape the wrapper's kernel, the two-stage kernel and the plain
   version are timed in turns with the SM clock read while the resident
   kernel runs; the Rr=1 edge is timed as the kernel and as the batched
   product that the sweep routes it to;
4. the rounding path: batched TT rounding of B=32 TTs (N=4, I=256, rank
   128 -> 64, float32) through ``Tensor.round_tt(algorithm='randgram')``,
   with launch counts (2/2/2), a check of two samples against the port on
   the CPU in float64, the sweep's time in turns with the kernels, with
   their plain versions, with the two-stage ``gram_edge``/``wgram`` and
   with the two-stage ``proj2``, and a torch.profiler breakdown of one
   sweep for each kernel variant, with each Gram launch's device time;
5. a non-batch pass on the card (``+``, ``*``, ``round_tt``, ``dot``,
   ``norm``) against the same on the CPU;
6. the evaluation path: ``tn.tt_eval`` and ``t[X].full()`` at the design
   shape, one forward call each on the grouped kernel, 4096 values against
   the port on the CPU in float64, and evaluations per second with the
   grouped kernel, the per-sample kernel and the plain version in turns;
7. the training path at the repo's largest training configuration
   (benchmarks/bench_optimize.py: a 256^3 TT of rank 16, 8192 observed
   entries, full size): ``tn.optimize`` with Adam (lr 1e-3) on
   ``mean((t[X].full() - y)**2)``, exact forward and backward launch
   counts (both on their per-sample kernels), one read of the out-of-range
   flag per step, a falling loss, the first 20 losses against the port on
   the CPU in float64, iterations per second with the kernels and with
   their plain versions in turns, and a torch.profiler breakdown of a step;
8. training at the evaluation design shape: ``tn.optimize`` (Adam, lr
   1e-3) on ``mean((t[X].full() - y)**2)`` with a 1024^4 rank-64 float32 TT
   and 2^20 samples, 10 steps, one grouped forward and one grouped
   backward call per step, a falling loss, the first 3 losses against the
   same run on the plain versions on the card, iterations per second in
   turns with the kernels, with the per-sample backward and with the plain
   versions, and a profile of three steps.

The data of phases 6 to 8 comes without a device and lands on the card by
the package's default. The second-to-last line is one JSON object with
each kernel's launches, error, times and bound; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each with its reason:
# - kernel vs plain version, max |diff| / max |plain|: float32 1e-4 (the two
#   sum up to I*Rr = 32768 terms per output in different orders; the JAX
#   package's own kernel tests use 1e-4), float64 1e-12.
KERNEL_TOL = {"float32": 1e-4, "float64": 1e-12}
# - main path, float32 on the card vs float64 on the CPU, compressed relative
#   error between the two rounded TTs: the Gram method squares the condition
#   number and the rank-64 cut of a flat random spectrum amplifies roundoff;
#   float32 against float64 differs by ~3e-4 on the CPU at this shape, while
#   the truncation error itself is ~0.83. 1e-2 leaves a 30x margin.
MAIN_TOL = 1e-2
# - non-batch pass, float64 on both devices: roundoff of the sweeps, 1e-10;
#   except round_tt(eps=1e-6) of the rank-deficient c + c, which under the
#   'high' policy orthogonalizes by CholeskyQR2 with a 1e-14 trace jitter
#   (~1e-7 relative error in the discarded directions, device-dependent
#   roundoff): both results are held to the eps budget, 1e-6.
F64_TOL = 1e-10
EPS = 1e-6
# - evaluation, float32 on the card vs float64 on the CPU, max |diff| over
#   max |value|: a 4-mode chain of rank-64 vector-matrix products in float32
#   carries ~1e-7 relative roundoff per product; 1e-4 leaves a wide margin.
EVAL_TOL = 1e-4
# - training, float32 on the card vs float64 on the CPU, the first 20 losses,
#   max relative difference: float32 evaluation and gradient roundoff, then
#   Adam steps of lr 1e-3 that normalise the gradient; the port's own
#   float32 and float64 runs on the CPU differ by 1.7e-7 here. 1e-5.
TRAIN_TOL = 1e-5
# - training at the design shape, kernels vs the plain versions, both float32
#   on the card, the first 3 losses, max relative difference: the two sum
#   each value and gradient in other orders (~1e-7 relative each), and Adam's
#   first steps move every parameter by ~lr whatever the gradient's size, so
#   a gradient entry near zero may step either way. 1e-4.
DESIGN_TRAIN_TOL = 1e-4

BENCH = dict(B=32, N=4, I=256, R=128, rmax=64)
# The evaluation kernel's design shape (the TPU kernel's stated regime,
# pallas_tt.py:18-19) and the largest training configuration
# (benchmarks/bench_optimize.py:89)
EVAL = dict(N=4, I=1024, R=64, B=1 << 20)
TRAIN = dict(N=3, I=256, R=16, B=8192, steps=20)
# Published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FP32, HBM = 67e12, 3.35e12


def bound_ms(flops, nbytes):
    """The least time for the work: the larger of its operations over the
    FP32 peak and its bytes over the memory rate; and which one bounds it."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase(name):
    print(f"== {name}", flush=True)


def cuda_time(fn, reps=5, inner=5):
    """Median over `reps` of the mean time (ms) of `inner` calls, by CUDA
    events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def _two_stage(predicate, fn):
    from tntorch_tpu_torch.ops import gram_kernels as gk

    choice = getattr(gk, predicate)
    setattr(gk, predicate, lambda *_: False)
    try:
        return fn()
    finally:
        setattr(gk, predicate, choice)


def two_stage_proj2(fn):
    """``fn()`` with proj2 on its two-stage kernel at every shape."""
    return _two_stage("_proj2_resident", fn)


def two_stage_gram(fn):
    """``fn()`` with gram_edge and wgram on their two-stage kernel at every
    shape."""
    return _two_stage("_gram_resident", fn)


TWO_STAGE = {"gram_edge": two_stage_gram, "wgram": two_stage_gram, "proj2": two_stage_proj2}


def tt_path(grouped, fn):
    """``fn()`` with ``tt_eval`` forced onto its grouped kernel (True) or
    its per-sample kernel (False) at every shape."""
    from tntorch_tpu_torch.ops import tt_eval as te

    choice = te._grouped
    te._grouped = lambda *_: grouped
    try:
        return fn()
    finally:
        te._grouped = choice


def tt_bwd_path(grouped, fn):
    """``fn()`` with ``tt_eval_backward`` forced onto its grouped path (True)
    or its per-sample kernel (False) at every shape."""
    from tntorch_tpu_torch.ops import tt_eval as te

    choice = te._grouped_backward
    te._grouped_backward = lambda *_: grouped
    try:
        return fn()
    finally:
        te._grouped_backward = choice


def device_ms(fn, name, calls=20):
    """Median device time (ms) of the launches of the kernels whose name
    holds ``name`` over `calls` calls of ``fn`` (torch.profiler), and their
    count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if e.device_type == DeviceType.CUDA and name in e.name)
    if not times:
        raise AssertionError(f"the profiler saw no launch of {name}")
    return times[len(times) // 2], len(times)


def smi_while(fn, launches=400):
    """The card's SM clock and power draw, read by nvidia-smi while
    `launches` calls of ``fn`` queued ahead of it run on the card."""
    import torch

    for _ in range(launches):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def probe():
    phase("1. device probe")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"device 0: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible; "
          f"name, power limit: {smi}")
    print(f"allow_tf32 (cuda matmul) = {torch.backends.cuda.matmul.allow_tf32}; "
          "the port runs every float32 product in full float32")
    return smi


def build():
    phase("2. kernel build")
    from tntorch_tpu_torch import _build

    t0 = time.time()
    paths = _build.build_all()
    for name in paths:
        _build.library(name)
    print(f"built {', '.join(so.name for so in paths.values())} in {time.time() - t0:.1f} s")
    for name, so in paths.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "Function properties for" in line:  # the mangled name, past its namespace
                kernel = line.split("for", 1)[1].strip()
                print(f"  ptxas {name}: {re.sub(r'^_ZN.*?_cu_[0-9a-f]+', '', kernel)[:70]}")
            elif "Used" in line or "spill" in line:
                print(f"  ptxas {name}:   {line.replace('ptxas info    :', '').strip()}")


def kernel_inputs(shape, dtype, gen):
    import torch

    B, Rl, I, Rr, r1, r2 = shape

    def rn(*s):
        return torch.randn(*s, generator=gen, dtype=torch.float64, device="cuda").to(dtype)

    def psd(n):
        A = rn(B, n, n)
        return (A @ A.mT / n).contiguous()

    C = rn(B, Rl, I, Rr) / max(Rl, Rr) ** 0.5
    return {
        "gram_edge": (C, psd(Rr)),
        "wgram": (C, psd(Rl)),
        "proj2": (rn(B, r1, Rl).contiguous(), C, rn(B, Rr, r2).contiguous()),
    }


def check_kernels():
    phase("3. kernels against their plain versions")
    import torch

    from tntorch_tpu_torch.ops import gram_kernels as gk

    B, R, I, r = BENCH["B"], BENCH["R"], BENCH["I"], BENCH["rmax"]
    bench_shape = (B, R, I, R, r, r)
    # In float32, gram_edge, wgram and proj2 run their resident kernels at
    # the first four shapes and the two-stage kernel at the last two (beyond
    # the resident tiles); at the first four the two-stage kernel is
    # checked too. Float64 runs the two-stage Gram kernel everywhere
    shapes = [bench_shape, (B, R, I, 1, r, 1), (3, 5, 37, 3, 4, 2), (2, 5, 37, 1, 3, 1),
              (2, 70, 37, 130, 65, 3), (2, 256, 16, 256, 128, 128)]
    kernels = {"gram_edge": gk.gram_edge, "wgram": gk.wgram, "proj2": gk.proj2}
    # One PyTorch call that computes each function (a yardstick the port
    # never calls), and each kernel's work at a shape
    library = {
        "gram_edge": lambda C, G: torch.einsum("zaib,zbc,zdic->zad", C, G, C),
        "wgram": lambda C, W: torch.einsum("zaib,zad,zdic->zbc", C, W, C),
        "proj2": lambda Y, C, X: torch.einsum("zra,zaib,zbc->zric", Y, C, X),
    }

    def flops(name, B, Rl, I, Rr, r1, r2):
        per = {"gram_edge": Rl * Rr * Rr + Rl * Rr * Rl, "wgram": Rl * Rl * Rr + Rl * Rr * Rr,
               "proj2": r1 * Rl * Rr + r1 * Rr * r2}[name]
        return 2.0 * B * I * per

    report = {name: {} for name in kernels}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for shape in shapes:
            inputs = kernel_inputs(shape, dtype, gen)
            Rl, Rr, r1, r2 = shape[1], shape[3], shape[4], shape[5]
            resident = {"gram_edge": gk._gram_resident(Rl, Rr, dtype.itemsize),
                        "wgram": gk._gram_resident(Rl, Rr, dtype.itemsize),
                        "proj2": gk._proj2_resident(r1, Rl, Rr, r2, dtype.itemsize)}
            # (tag, kernel name, call, whether the call is the wrapper's own
            # choice); where the wrapper takes a resident kernel, the
            # two-stage kernel is held to the plain version too
            runs = []
            for name, kernel in kernels.items():
                runs.append((f"{name}/{'resident' if resident[name] else 'two-stage'}", name,
                             kernel, True))
                if resident[name]:
                    runs.append((f"{name}/two-stage", name,
                                 lambda *a, n=name: TWO_STAGE[n](lambda: kernels[n](*a)), False))
            for tag, name, kernel, main in runs:
                args = inputs[name]
                got = kernel(*args)
                again = kernel(*args)
                torch.cuda.synchronize()
                want = gk.PLAIN[kernels[name]](*args)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{tag} {dname} {shape}: non-finite output")
                if not torch.equal(got, again):
                    raise AssertionError(f"{tag} {dname} {shape}: two calls differ")
                err = float((got - want).abs().max())
                rel = err / max(float(want.abs().max()), 1e-300)
                line = (f"{tag:19s} {dname} B,Rl,I,Rr,r1,r2={shape}: max|diff| {err:.3e}, "
                        f"rel {rel:.3e}, bitwise equal on two calls")
                if shape == bench_shape and dtype == torch.float32 and main:
                    # The kernel, its plain version and (where the wrapper
                    # takes a resident kernel) the two-stage kernel, in turns
                    variants = {"kernel": lambda: kernel(*args),
                                "plain": lambda: gk.PLAIN[kernel](*args)}
                    if resident[name]:
                        variants["two-stage"] = lambda: TWO_STAGE[name](lambda: kernel(*args))
                    turns = {v: [] for v in variants}
                    for v in list(variants) + list(variants)[::-1]:
                        turns[v].append(cuda_time(variants[v]))
                    ms, plain_ms = min(turns["kernel"]), min(turns["plain"])
                    library_ms = cuda_time(lambda: library[name](*args))
                    bound, by = bound_ms(flops(name, *shape), nbytes(*args, got))
                    report[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound, bound_by=by, library_ms=library_ms)
                    line += (f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, one einsum "
                             f"{library_ms:.3f} ms, bound {bound:.3f} ms ({by}), "
                             f"{flops(name, *shape) / ms / 1e9:.1f} TFLOP/s"
                             f"\n    in turns (ms): " + "; ".join(f"{v} {t}" for v, t in turns.items()))
                    if resident[name]:
                        report[name]["two_stage_ms"] = min(turns["two-stage"])
                        line += (f"\n    SM clock, power while the resident kernel runs: "
                                 f"{smi_while(lambda: kernel(*args))}")
                print(line, flush=True)
                if rel > KERNEL_TOL[dname]:
                    raise AssertionError(f"{tag} disagrees with its plain version: rel {rel:.3e}")
    # The last right edge of the bench sweep: C (B, R, I, 1), G (B, 1, 1).
    # The sweep routes it to one batched product, as the JAX package does;
    # the kernel still takes it
    C, G = kernel_inputs((B, R, I, 1, r, 1), torch.float32, gen)["gram_edge"]
    Cm = C.reshape(B, R, I)
    ms = cuda_time(lambda: gk.gram_edge(C, G))
    routed_ms = cuda_time(lambda: (Cm * G) @ Cm.mT)
    plain_ms = cuda_time(lambda: gk.gram_edge_plain(C, G))
    library_ms = cuda_time(lambda: library["gram_edge"](C, G))
    bound, by = bound_ms(flops("gram_edge", B, R, I, 1, r, 1), nbytes(C, G) + B * R * R * 4)
    err = float(((Cm * G) @ Cm.mT - gk.gram_edge(C, G)).abs().max())
    print(f"gram_edge float32 last edge C {tuple(C.shape)}: kernel {ms:.3f} ms, routed "
          f"batched product {routed_ms:.3f} ms (max|diff| to the kernel {err:.3e}), plain "
          f"{plain_ms:.3f} ms, one einsum {library_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    return report


def tt_problem(ranks, I, B, dtype, seed, negative=False, skew=False):
    """Cores N(0,1)/sqrt(R_k) (R_k, I, R_{k+1}), coordinates (B, N) and
    weights (B,) from numpy seeds, on the card. ``skew``: ~90% of the
    samples share coordinate 7 of mode 1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    N = len(ranks) - 1
    cores = [torch.from_numpy(rng.standard_normal((ranks[k], I, ranks[k + 1])) / np.sqrt(ranks[k]))
             .to("cuda", dtype) for k in range(N)]
    X_np = rng.integers(-I if negative else 0, I, (B, N))
    if skew:
        X_np[rng.random(B) < 0.9, 1] = 7
    X = torch.from_numpy(X_np).cuda()
    g = torch.from_numpy(rng.standard_normal(B)).to("cuda", dtype)
    return cores, X, g


def tt_work(cores, X):
    """FLOPs of one forward and one backward evaluation (an FMA counts 2):
    only column 0 of the last mode is needed."""
    ranks = [cores[0].shape[0]] + [c.shape[2] for c in cores]
    cols = ranks[1:-1] + [1]
    B = X.shape[0]
    fwd = sum(r * c for r, c in zip(ranks, cols))
    left = sum(ranks[k] * ranks[k + 1] for k in range(len(cores) - 1))
    outer = sum(r * c for r, c in zip(ranks, cols))
    right = sum(r * c for r, c in zip(ranks[1:], cols[1:]))
    return 2.0 * B * fwd, 2.0 * B * (left + outer + right)


def check_tt_kernels():
    phase("3b. evaluation kernels against their plain versions")
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    E, T = EVAL, TRAIN
    design = [1] + [E["R"]] * (E["N"] - 1) + [1]
    # (tag, ranks, I, B, negative coordinates, skewed keys); "skewed" puts
    # ~90% of the samples on one coordinate of mode 1, so that its run is
    # split across the backward's blocks
    shapes = [
        ("design", design, E["I"], E["B"], False, False),
        ("training", [1] + [T["R"]] * (T["N"] - 1) + [1], T["I"], T["B"], False, False),
        ("ragged", [2, 5, 3, 7, 3], 37, 1000, True, False),
        ("ragged", [2, 5, 3, 7, 3], 37, 1, True, False),
        ("skewed", design, E["I"], 1 << 18, False, True),
    ]
    paths = ("grouped", "per-sample")
    report = {"tt_eval": {}, "tt_eval_backward": {}}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for tag, ranks, I, B, negative, skew in shapes:
            cores, X, g = tt_problem(ranks, I, B, dtype, seed=3, negative=negative, skew=skew)
            # Both forward kernels and both backward paths, each forced
            # (the grouped ones also where their predicates refuse the
            # shape, so a tile meets many runs)
            got = {p: tt_path(p == "grouped", lambda: te.tt_eval_kernel(cores, X)) for p in paths}
            again = tt_path(True, lambda: te.tt_eval_kernel(cores, X))
            grads = {p: tt_bwd_path(p == "grouped", lambda: te.tt_eval_backward_kernel(cores, X, g))
                     for p in paths}
            grads_again = tt_bwd_path(True, lambda: te.tt_eval_backward_kernel(cores, X, g))
            torch.cuda.synchronize()
            want = te.tt_eval_plain(cores, X)
            want_grads = te.tt_eval_backward_plain(cores, X, g)
            torch.cuda.synchronize()
            if not torch.equal(got["grouped"], again):
                raise AssertionError(f"grouped tt_eval {dname} {tag}: two calls differ")
            if not all(torch.equal(a, b) for a, b in zip(grads["grouped"], grads_again)):
                raise AssertionError(f"grouped tt_eval_backward {dname} {tag}: two calls differ")
            errs = {}
            checks = ([(f"tt_eval/{p}", [got[p]], [want]) for p in paths]
                      + [(f"tt_eval_backward/{p}", grads[p], want_grads) for p in paths])
            for name, a, b in checks:
                if not all(torch.isfinite(x).all() for x in a):
                    raise AssertionError(f"{name} {dname} {tag}: non-finite output")
                err = max(float((x - y).abs().max()) for x, y in zip(a, b))
                rel = err / max(max(float(y.abs().max()) for y in b), 1e-300)
                errs[name] = (err, rel)
                if rel > KERNEL_TOL[dname]:
                    raise AssertionError(f"{name} {dname} {tag} disagrees with its plain version: "
                                         f"rel {rel:.3e}")
            dims = [I] * (len(ranks) - 1)
            chosen = "grouped" if te._grouped(ranks, dims, B, dtype.itemsize) else "per-sample"
            chosen_bwd = ("grouped" if te._grouped_backward(ranks, dims, B, dtype.itemsize)
                          else "per-sample")
            line = (f"{tag:8s} {dname} ranks {ranks} I={I} B={B}{' negative X' if negative else ''}"
                    f" (takes {chosen}, backward {chosen_bwd}): tt_eval rel grouped "
                    f"{errs['tt_eval/grouped'][1]:.3e} (bitwise equal on two calls), per-sample "
                    f"{errs['tt_eval/per-sample'][1]:.3e}; backward rel grouped "
                    f"{errs['tt_eval_backward/grouped'][1]:.3e} (bitwise equal on two calls), "
                    f"per-sample {errs['tt_eval_backward/per-sample'][1]:.3e}")
            if tag == "design" and dtype == torch.float32:
                fwd_flops, bwd_flops = tt_work(cores, X)
                bound, by = bound_ms(fwd_flops, nbytes(*cores, X, got["grouped"]))
                turns = {p: [] for p in paths}
                for p in paths + paths[::-1]:
                    turns[p].append(tt_path(p == "grouped", lambda: cuda_time(
                        lambda: te.tt_eval_kernel(cores, X), reps=3, inner=3)))
                plain_ms = cuda_time(lambda: te.tt_eval_plain(cores, X), reps=3, inner=3)
                report["tt_eval"].update(
                    max_abs_err=errs["tt_eval/grouped"][0], ms=min(turns["grouped"]),
                    per_sample_ms=min(turns["per-sample"]), plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by, library_ms=None)
                line += (f"\n    tt_eval in turns: grouped {turns['grouped']} ms, per-sample "
                         f"{turns['per-sample']} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
                         f"({by}), {B / min(turns['grouped']) * 1e3:.3e} samples/s grouped")
                bound, by = bound_ms(bwd_flops, nbytes(*cores, X, g, *want_grads))
                turns = {p: [] for p in paths}
                for p in paths + paths[::-1]:
                    turns[p].append(tt_bwd_path(p == "grouped", lambda: cuda_time(
                        lambda: te.tt_eval_backward_kernel(cores, X, g), reps=3, inner=3)))
                plain_ms = cuda_time(lambda: te.tt_eval_backward_plain(cores, X, g), reps=3, inner=3)
                report["tt_eval_backward"].update(
                    max_abs_err=errs["tt_eval_backward/grouped"][0], ms=min(turns["grouped"]),
                    per_sample_ms=min(turns["per-sample"]), plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by, library_ms=None)
                line += (f"\n    tt_eval_backward in turns: grouped {turns['grouped']} ms, "
                         f"per-sample {turns['per-sample']} ms, plain {plain_ms:.3f} ms, bound "
                         f"{bound:.3f} ms ({by})")
                print(line, flush=True)
                line = "    profile, one grouped tt_eval_backward call:"
                print(line, flush=True)
                tt_bwd_path(True, lambda: profile_device(
                    lambda: te.tt_eval_backward_kernel(cores, X, g), steps=1,
                    each="slice_grad_kernel"))
                line = ""
            if tag == "training" and dtype == torch.float32:  # where training launches it
                ms = cuda_time(lambda: te.tt_eval_backward_kernel(cores, X, g))
                checked_ms = cuda_time(lambda: te.tt_eval_backward_kernel(cores, X, g, True))
                dev_ms, n = device_ms(lambda: te.tt_eval_backward_kernel(cores, X, g, True),
                                      "tt_eval_backward_kernel")
                bound, by = bound_ms(tt_work(cores, X)[1], nbytes(*cores, X, g, *want_grads))
                report["tt_eval_backward"].update(training_shape_ms=ms,
                                                  training_shape_checked_ms=checked_ms,
                                                  training_shape_device_ms=dev_ms)
                line += (f"\n    tt_eval_backward at the training shape (per-sample kernel): "
                         f"call {ms:.4f} ms (flag read), {checked_ms:.4f} ms (checked=True, no "
                         f"read); the kernel alone {dev_ms:.4f} ms of device time (median of {n} "
                         f"launches, profiler); bound {bound:.4f} ms ({by})")
            if line:
                print(line, flush=True)
    tt_crossover()
    tt_bwd_crossover()
    return report


def tt_crossover():
    """Each whole ``tt_eval_kernel`` call (sorts, launches and the flag's
    read-back) on both kernels in turns, at a few samples per slice: where
    the grouped kernel starts to win sets ops/tt_eval.py's _GROUP_MIN."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    E, T = EVAL, TRAIN
    for ranks, I in (([1] + [E["R"]] * (E["N"] - 1) + [1], E["I"]),
                     ([1] + [T["R"]] * (T["N"] - 1) + [1], T["I"])):
        row = []
        for per_slice in (8, 16, 32, 64, 128, 256):
            cores, X, _ = tt_problem(ranks, I, per_slice * I, torch.float32, seed=6)
            turns = {True: [], False: []}
            for grouped in (True, False, False, True):
                turns[grouped].append(tt_path(grouped, lambda: cuda_time(
                    lambda: te.tt_eval_kernel(cores, X), reps=3, inner=3)))
            row.append(f"B/I={per_slice}: grouped {min(turns[True]):.4f}, per-sample "
                       f"{min(turns[False]):.4f}")
        print(f"crossover, ranks {ranks} I={I}, ms per call (best of two turns): "
              + "; ".join(row), flush=True)


def tt_bwd_crossover():
    """Each whole ``tt_eval_backward_kernel`` call on both paths in turns, at
    B/I = 8..256 samples per slice, at R=64 (the design's N and I) and R=16
    (the training's): where the grouped path starts to win sets
    ops/tt_eval.py's _BWD_MIN and _BWD_MIN_BYTES."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    E, T = EVAL, TRAIN
    for ranks, I in (([1] + [E["R"]] * (E["N"] - 1) + [1], E["I"]),
                     ([1] + [T["R"]] * (T["N"] - 1) + [1], T["I"])):
        row = []
        for per_slice in (8, 16, 32, 64, 128, 256):
            cores, X, g = tt_problem(ranks, I, per_slice * I, torch.float32, seed=8)
            turns = {True: [], False: []}
            for grouped in (True, False, False, True):
                turns[grouped].append(tt_bwd_path(grouped, lambda: cuda_time(
                    lambda: te.tt_eval_backward_kernel(cores, X, g), reps=3, inner=3)))
            row.append(f"B/I={per_slice}: grouped {min(turns[True]):.4f}, per-sample "
                       f"{min(turns[False]):.4f}")
        print(f"backward crossover, ranks {ranks} I={I}, ms per call (best of two turns): "
              + "; ".join(row), flush=True)


def bench_cores():
    """The bench cell's cores (bench.py): N=4, I=256, R=128, scaled by
    1/sqrt(R), stacked B times with 1% per-sample jitter, float32."""
    import numpy as np

    N, I, R, B = BENCH["N"], BENCH["I"], BENCH["R"], BENCH["B"]
    rng = np.random.default_rng(0)
    ranks = [1] + [R] * (N - 1) + [1]
    cores = [(rng.standard_normal((ranks[n], I, ranks[n + 1])) / np.sqrt(R)).astype(np.float32)
             for n in range(N)]
    rng = np.random.default_rng(1)
    return [(np.stack([c] * B) * (1 + 0.01 * rng.standard_normal((B,) + c.shape)))
            .astype(np.float32) for c in cores]


def main_path():
    phase("4. main path: batched randgram rounding, B=32 N=4 I=256 R=128->64 float32")
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import gram_kernels as gk

    tn.set_policy("high")
    cores = bench_cores()
    B, rmax = BENCH["B"], BENCH["rmax"]
    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=True, device="cuda")
    print(f"input: {tuple(t.shape)}, ranks {t.ranks_tt.tolist()}, {t.dtype}, "
          f"{sum(c.numel() * c.element_size() for c in t.cores) / 2**30:.3f} GiB of cores")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    gk.reset_launches()
    out = tn.round_tt(t, rmax=rmax, algorithm="randgram")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in gk.KERNELS}
    print(f"launches in the main path: {launches}")
    want = {"gram_edge": 2, "wgram": 2, "proj2": 2}  # the Rr=1 edge is a batched product
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    if out.ranks_tt.tolist() != [1, rmax, rmax, rmax, 1]:
        raise AssertionError(f"ranks {out.ranks_tt.tolist()}")
    if not all(torch.isfinite(c).all() for c in out.cores):
        raise AssertionError("non-finite cores")

    # Two samples against the port on the CPU in float64 (same sketch)
    ref_in = tn.Tensor([torch.from_numpy(c[:2].astype(np.float64)) for c in cores], batch=True)
    ref = tn.round_tt(ref_in, rmax=rmax, algorithm="randgram")
    got = tn.Tensor([c[:2].double().cpu() for c in out.cores], batch=True)
    dev = tn.relative_error(ref, got)
    trunc = tn.relative_error(ref_in, ref)
    print(f"card f32 vs CPU f64, samples 0-1: rel err {dev.tolist()} (tol {MAIN_TOL}); "
          f"truncation error {trunc.tolist()}")
    if not bool((dev <= MAIN_TOL).all()):
        raise AssertionError("main path disagrees with the CPU float64 run")

    # Sweep time, kernels and plain versions in turns
    def sweep():
        tn.round_tt(t, rmax=rmax, algorithm="randgram")

    kern = {k: getattr(gk, k) for k in want}

    def plain_versions(fn):
        for k in want:
            setattr(gk, k, gk.PLAIN[kern[k]])
        try:
            return fn()
        finally:
            for k in want:
                setattr(gk, k, kern[k])

    variants = {"kernels": lambda fn: fn(), "plain versions": plain_versions,
                "kernels, two-stage gram_edge/wgram": two_stage_gram,
                "kernels, two-stage proj2": two_stage_proj2}
    runs = {v: [] for v in variants}
    for v in list(variants) + list(variants)[::-1]:
        runs[v].append(variants[v](lambda: cuda_time(sweep, reps=5, inner=3)))
    print(f"sweep time, B={B}, in turns: " + "; ".join(f"{v} {t} ms" for v, t in runs.items())
          + "; per sample " + ", ".join(f"{min(t) / B:.4f} ms ({v})" for v, t in runs.items()))

    # Where one sweep's device time goes, by kernel (torch.profiler), with
    # each kernel variant
    print("profile, kernels:")
    profile_device(sweep, steps=1, each="gram_resident_kernel")
    print("profile, kernels with the two-stage gram_edge/wgram:")
    two_stage_gram(lambda: profile_device(sweep, steps=1, each="two_stage_kernel<float, 8"))
    print("profile, kernels with the two-stage proj2:")
    two_stage_proj2(lambda: profile_device(sweep, steps=1))
    return launches


def nonbatch_pass():
    phase("5. non-batch pass on the card, float64, against the CPU")
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    rng = np.random.default_rng(2)
    N, I, r = 4, 256, 32
    ranks = [1] + [r] * (N - 1) + [1]

    def cores():
        return [rng.standard_normal((ranks[n], I, ranks[n + 1])) / np.sqrt(r) for n in range(N)]

    ca, cb = cores(), cores()

    def run(device):
        a = tn.interop.tensor_from_arrays(ca, device=device)
        b = tn.interop.tensor_from_arrays(cb, device=device)
        c = a + 0.01 * b
        d = c + c
        d.round_tt(eps=EPS)
        e = (c * 2).clone()
        e.round_tt(rmax=64, algorithm="gram")
        return c, d, e, float(tn.dot(c, d)), float(tn.norm(e))

    gpu, cpu = run("cuda"), run("cpu")
    checks = (("a+0.01b", F64_TOL), ("round_tt(eps=1e-6) of c+c", EPS),
              ("round_tt(rmax=64, gram) of 2c", F64_TOL))
    for (name, tol), g, c in zip(checks, gpu, cpu):
        g = tn.Tensor([x.cpu() for x in g.cores])
        err = float(tn.relative_error(c, g))
        print(f"{name}: ranks card {g.ranks_tt.tolist()} cpu {c.ranks_tt.tolist()}, "
              f"rel err {err:.3e} (tol {tol})")
        if g.ranks_tt.tolist() != c.ranks_tt.tolist() or not err <= tol:
            raise AssertionError(f"{name} disagrees between the card and the CPU")
    def host(t):
        return tn.Tensor([x.cpu() for x in t.cores])

    budget = [float(tn.relative_error(2 * host(r[0]), host(r[1]))) for r in (gpu, cpu)]
    print(f"round_tt(eps=1e-6) error against 2c: card {budget[0]:.3e}, cpu {budget[1]:.3e}")
    if not max(budget) <= EPS:
        raise AssertionError("round_tt(eps) exceeded its error budget")
    for name, g, c in zip(("dot", "norm"), gpu[3:], cpu[3:]):
        rel = abs(g - c) / abs(c)
        print(f"{name}: card {g!r} cpu {c!r}, rel {rel:.3e}")
        if not rel <= F64_TOL:
            raise AssertionError(f"{name} disagrees between the card and the CPU")


def profile_device(fn, steps, each=None):
    """Run ``fn`` under torch.profiler; print the wall time, the device's
    busy time by kernel and its idle share, per step; and the time of every
    launch of the kernels whose name holds ``each``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: CPU ops and annotation ranges carry the device time of
    # what they enclose, which would count it twice
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("tn.")),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled {steps} step(s) (profiler on): wall {wall_ms / steps:.3f} ms/step, device "
          f"busy {busy / steps:.3f} ms/step (idle share {max(0.0, 1 - busy / wall_ms):.3f}); "
          "top device time per step:")
    for ms, count, key in rows[:10]:
        print(f"  {ms / steps:8.4f} ms  x{count / steps:<5.1f} {key[:90]}")
    if each:
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and each in e.name]
        print(f"  each launch of {each}, in order: " + ", ".join(f"{t:.4f} ms" for t in times))


def eval_path():
    phase("6. evaluation path: tn.tt_eval and t[X].full(), N=4 I=1024 R=64 B=2^20 float32")
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    N, I, R, B = EVAL["N"], EVAL["I"], EVAL["R"], EVAL["B"]
    rng = np.random.default_rng(4)
    ranks = [1] + [R] * (N - 1) + [1]
    cores = [(rng.standard_normal((ranks[k], I, ranks[k + 1])) / np.sqrt(ranks[k]))
             .astype(np.float32) for k in range(N)]
    X_np = rng.integers(0, I, (B, N))
    t = tn.interop.tensor_from_arrays(cores)  # no device given: the card
    X = tn.utils.asarray(X_np)
    if t.device.type != "cuda" or X.device.type != "cuda":
        raise AssertionError(f"data without a device landed on {t.device}, {X.device}")
    launches = {}
    for name, run in (("tn.tt_eval", lambda: tn.tt_eval(t.cores, X)),
                      ("t[X].full()", lambda: t[X].full())):
        te.reset_launches()
        values = run()
        torch.cuda.synchronize()
        counts = [k.launches for k in te.KERNELS]
        print(f"{name}: {tuple(values.shape)} values, launches (forward, backward) {counts}, "
              f"grouped {te.tt_eval_kernel.grouped}")
        if counts != [1, 0] or tuple(values.shape) != (B,) or not torch.isfinite(values).all():
            raise AssertionError(f"{name}: expected one forward launch and {B} finite values")
        if te.tt_eval_kernel.grouped != 1:
            raise AssertionError(f"{name}: the forward did not take the grouped kernel")
        launches[name] = counts
        if name == "tn.tt_eval":
            first = values
        elif not torch.equal(values, first):
            raise AssertionError("t[X].full() and tn.tt_eval disagree")
    ref = tn.tt_eval([torch.from_numpy(c.astype(np.float64)) for c in cores], X_np[:4096])
    err = float((first[:4096].double().cpu() - ref).abs().max() / ref.abs().max())
    print(f"card f32 vs CPU f64, 4096 values: rel {err:.3e} (tol {EVAL_TOL})")
    if not err <= EVAL_TOL:
        raise AssertionError("evaluation disagrees with the CPU float64 run")

    variants = {
        "grouped kernel": lambda: tn.tt_eval(t.cores, X),
        "per-sample kernel": lambda: tt_path(False, lambda: tn.tt_eval(t.cores, X)),
        "plain chain": lambda: tn.tt_eval(t.cores, X, use_kernel=False),
    }
    runs = {v: [] for v in variants}
    for v in list(variants) + list(variants)[::-1]:
        runs[v].append(cuda_time(variants[v], reps=3, inner=3))
    print(f"tn.tt_eval at B={B}, in turns: " + "; ".join(f"{v} {t} ms" for v, t in runs.items())
          + "; " + ", ".join(f"{B / min(t) * 1e3:.4e} evals/s ({v})" for v, t in runs.items()))
    print("profile, tn.tt_eval on the grouped kernel:")
    profile_device(variants["grouped kernel"], steps=1, each="tt_eval_grouped_kernel")
    return {k: sum(launches[n][i] for n in launches) for i, k in enumerate(("tt_eval", "tt_eval_backward"))}


def train_path():
    T = TRAIN
    phase(f"7. training path: tn.optimize, {T['I']}^{T['N']} TT rank {T['R']}, "
          f"{T['B']} samples, Adam lr 1e-3, float32")
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    N, I, R, B, steps = T["N"], T["I"], T["R"], T["B"], T["steps"]
    rng = np.random.default_rng(5)
    ranks = [1] + [R] * (N - 1) + [1]
    # uniform [0, 1) cores, as tn.rand draws them (benchmarks/bench_optimize.py)
    cores = [rng.uniform(0, 1, (ranks[k], I, ranks[k + 1])).astype(np.float32) for k in range(N)]
    X_np = rng.integers(0, I, (B, N))
    y_np = rng.standard_normal(B).astype(np.float32)
    X, y = tn.utils.asarray(X_np), tn.utils.asarray(y_np)  # no device given: the card

    def fit(max_iter, device=None, dtype=None):
        cs = [c if dtype is None else c.astype(dtype) for c in cores]
        t = tn.Tensor(cs, device=device, requires_grad=True)
        Xd, yd = X.to(t.device), y.to(t.device, t.dtype)
        hist = tn.optimize([t], lambda t: torch.mean((t[Xd].full() - yd) ** 2), tol=None,
                           max_iter=max_iter, verbose=False)
        return t, hist

    reads = [0]
    flagged = te._raise_if_flagged

    def counted(*args):
        reads[0] += 1
        return flagged(*args)

    te.reset_launches()
    te._raise_if_flagged = counted
    try:
        t, hist = fit(steps - 1)
    finally:
        te._raise_if_flagged = flagged
    torch.cuda.synchronize()
    launches = {k.__name__.replace("_kernel", ""): k.launches for k in te.KERNELS}
    print(f"{len(hist)} steps, launches {launches}, grouped {te.tt_eval_kernel.grouped} "
          f"(backward {te.tt_eval_backward_kernel.grouped}), out-of-range flag read {reads[0]} "
          f"times; loss {hist[0]:.6f} -> {hist[-1]:.6f}")
    if t.device.type != "cuda":
        raise AssertionError(f"the TT trained on {t.device}")
    if launches != {"tt_eval": steps, "tt_eval_backward": steps} or len(hist) != steps:
        raise AssertionError(f"expected {steps} steps with one forward and one backward launch each")
    if te.tt_eval_kernel.grouped != 0 or te.tt_eval_backward_kernel.grouped != 0:
        raise AssertionError("the training step left the per-sample kernels")
    if reads[0] != steps:
        raise AssertionError(f"expected one flag read per step, got {reads[0]} in {steps} steps")
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError("the loss did not fall")
    _, ref = fit(steps - 1, device="cpu", dtype=np.float64)
    err = float(np.max(np.abs(np.array(hist) - ref) / np.abs(ref)))
    print(f"card f32 vs CPU f64, {steps} losses: max rel {err:.3e} (tol {TRAIN_TOL})")
    if not err <= TRAIN_TOL:
        raise AssertionError("training disagrees with the CPU float64 run")

    # Iterations per second, kernels and plain versions in turns
    timed_steps = 200

    def timed(use_plain):
        run = lambda: fit(timed_steps - 1)  # noqa: E731
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_versions(run) if use_plain else run()
        torch.cuda.synchronize()
        return timed_steps / (time.perf_counter() - t0)

    rates = {False: [], True: []}
    for use_plain in (False, True, True, False):
        rates[use_plain].append(timed(use_plain))
    print(f"optimize, {timed_steps} steps a run: kernels {[round(r, 1) for r in rates[False]]} "
          f"iters/s, plain versions {[round(r, 1) for r in rates[True]]} iters/s")
    profile_device(lambda: fit(9), steps=10)
    return launches


def plain_versions(fn):
    """``fn()`` with the evaluation wrappers replaced by their plain
    versions (on the card), as TTEval calls them."""
    from tntorch_tpu_torch.ops import tt_eval as te

    kern = (te.tt_eval_kernel, te.tt_eval_backward_kernel)
    te.tt_eval_kernel = te.tt_eval_plain
    te.tt_eval_backward_kernel = lambda cores, X, g, checked=False: te.tt_eval_backward_plain(
        cores, X, g)
    try:
        return fn()
    finally:
        te.tt_eval_kernel, te.tt_eval_backward_kernel = kern


def train_design_path():
    E = EVAL
    N, I, R, B = E["N"], E["I"], E["R"], E["B"]
    steps = 10
    phase(f"8. training at the design shape: tn.optimize, {I}^{N} TT rank {R}, {B} samples, "
          "Adam lr 1e-3, float32")
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    rng = np.random.default_rng(7)
    ranks = [1] + [R] * (N - 1) + [1]
    cores = [(rng.standard_normal((ranks[k], I, ranks[k + 1])) / np.sqrt(ranks[k]))
             .astype(np.float32) for k in range(N)]
    X = tn.utils.asarray(rng.integers(0, I, (B, N)))  # no device given: the card
    y = tn.utils.asarray(rng.standard_normal(B).astype(np.float32))
    start = tn.Tensor(cores).cores  # the card, once: each fit starts from a copy

    def fit(max_iter):
        t = tn.Tensor([c.clone() for c in start], requires_grad=True)
        hist = tn.optimize([t], lambda t: torch.mean((t[X].full() - y) ** 2), tol=None,
                           max_iter=max_iter, verbose=False)
        return t, hist

    te.reset_launches()
    t, hist = fit(steps - 1)
    torch.cuda.synchronize()
    launches = {k.__name__.replace("_kernel", ""): k.launches for k in te.KERNELS}
    grouped = [te.tt_eval_kernel.grouped, te.tt_eval_backward_kernel.grouped]
    print(f"{len(hist)} steps, launches {launches}, grouped (forward, backward) {grouped}; "
          f"loss {hist[0]:.6f} -> {hist[-1]:.6f}")
    if t.device.type != "cuda":
        raise AssertionError(f"the TT trained on {t.device}")
    if launches != {"tt_eval": steps, "tt_eval_backward": steps} or grouped != [steps, steps]:
        raise AssertionError(f"expected {steps} steps with one grouped forward and one grouped "
                             "backward call each")
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError("the loss did not fall")
    t3, _ = fit(2)
    p3, ref = plain_versions(lambda: fit(2))
    err = float(np.max(np.abs(np.array(hist[:3]) - ref) / np.abs(ref)))
    moved = max(float((a - b).detach().abs().max()) for a, b in zip(t3.cores, p3.cores))
    print(f"kernels vs plain versions on the card, first 3 losses {hist[:3]} vs {ref}: max rel "
          f"{err:.3e} (tol {DESIGN_TRAIN_TOL}); after 3 steps the cores differ by at most "
          f"{moved:.3e} (Adam moves each entry by ~1e-3 a step)")
    if not err <= DESIGN_TRAIN_TOL:
        raise AssertionError("training at the design shape disagrees with the plain versions")

    # Iterations per second in turns: kernels, kernels with the per-sample
    # backward, plain versions (fewer steps: ~0.3 s each)
    variants = {"kernels": (lambda fn: fn(), 20),
                "kernels, per-sample backward": (lambda fn: tt_bwd_path(False, fn), 10),
                "plain versions": (plain_versions, 3)}
    rates = {v: [] for v in variants}
    for v in list(variants) + list(variants)[::-1]:
        wrap, n = variants[v]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wrap(lambda: fit(n - 1))
        torch.cuda.synchronize()
        rates[v].append(n / (time.perf_counter() - t0))
    print("optimize at the design shape, iters/s in turns: "
          + "; ".join(f"{v} {[round(r, 2) for r in rs]}" for v, rs in rates.items()))
    profile_device(lambda: fit(2), steps=3)
    return launches


PHASES = {"3": "check_kernels", "3b": "check_tt_kernels", "4": "main_path",
          "5": "nonbatch_pass", "6": "eval_path", "7": "train_path", "8": "train_design_path"}


def main():
    if not os.path.isdir(os.path.join(ROOT, "tntorch_tpu_torch")):
        raise SystemExit("chip_smoke.py needs the repository beside it (tntorch_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    # --only 3b,8: the device probe, the build and those phases, and no
    # result line (a short call while a kernel is worked on)
    only = sys.argv[2].split(",") if sys.argv[1:2] == ["--only"] else None
    if sys.argv[1:] and (only is None or len(sys.argv) != 3 or not set(only) <= set(PHASES)):
        raise SystemExit(f"usage: chip_smoke.py [--only PHASE[,PHASE...]], phases {list(PHASES)}")
    smi = probe()
    build()
    if only:
        for name in only:
            globals()[PHASES[name]]()
        print(smi)
        print(f"phases {only} passed; a partial run prints no result line")
        return
    report = check_kernels()
    report.update(check_tt_kernels())
    launches = main_path()
    nonbatch_pass()
    evals = eval_path()
    trains = train_path()
    designs = train_design_path()
    launches.update({k: evals[k] + trains[k] + designs[k] for k in evals})

    import torch

    replaces = {
        "gram_edge": "tntorch_tpu/ops/pallas_gram.py:125",
        "wgram": "tntorch_tpu/ops/pallas_gram.py:187",
        "proj2": "tntorch_tpu/ops/pallas_gram.py:254",
        "tt_eval": "tntorch_tpu/ops/pallas_tt.py:89",
        "tt_eval_backward": "no TPU kernel: XLA's gradient of tntorch_tpu/parallel/mesh.py:150",
    }
    sources = {"tt_eval": "tt_eval.cu", "tt_eval_backward": "tt_eval.cu"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"tntorch_tpu_torch/csrc/{sources.get(name, 'gram_kernels.cu')}",
         "replaces": replaces[name], "launches": launches[name], **report[name]}
        for name in replaces
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
