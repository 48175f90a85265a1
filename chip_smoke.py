#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tntorch_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, each fatal on failure:

1. device probe: a CUDA card must be present (no CPU fallback);
2. build the hand-written kernels from ``tntorch_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on the card, float32 and
   float64: the Gram kernels at the bench cell's shapes and at ragged
   shapes, the evaluation kernels (``tt_eval``, ``tt_eval_backward``) at
   the evaluation design shape (N=4, I=1024, R=64, B=2^20), the training
   shape (N=3, I=256, R=16, B=8192) and ragged shapes; with times, each
   kernel's bound and a one-call PyTorch yardstick where there is one;
4. the rounding path: batched TT rounding of B=32 TTs (N=4, I=256, rank
   128 -> 64, float32) through ``Tensor.round_tt(algorithm='randgram')``,
   with launch counts, a check of two samples against the port on the CPU
   in float64, the sweep's time with the kernels and with their plain
   versions, and a torch.profiler breakdown of one sweep;
5. a non-batch pass on the card (``+``, ``*``, ``round_tt``, ``dot``,
   ``norm``) against the same on the CPU;
6. the evaluation path: ``tn.tt_eval`` and ``t[X].full()`` at the design
   shape, one forward launch each, 4096 values against the port on the CPU
   in float64, and evaluations per second with the kernel and with its
   plain version in turns;
7. the training path at the repo's largest training configuration
   (benchmarks/bench_optimize.py: a 256^3 TT of rank 16, 8192 observed
   entries, full size): ``tn.optimize`` with Adam (lr 1e-3) on
   ``mean((t[X].full() - y)**2)``, exact forward and backward launch
   counts, a falling loss, the first 20 losses against the port on the CPU
   in float64, iterations per second with the kernels and with their plain
   versions in turns, and a torch.profiler breakdown of a step.

The data of phases 6 and 7 comes without a device and lands on the card by
the package's default. The second-to-last line is one JSON object with
each kernel's launches, error, times and bound; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import os
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
    print(f"device 0: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
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
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())


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
    shapes = [bench_shape, (B, R, I, 1, r, 1), (3, 5, 37, 3, 4, 2), (2, 5, 37, 1, 3, 1),
              (2, 70, 37, 130, 65, 3)]
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
            for name, kernel in kernels.items():
                args = inputs[name]
                got = kernel(*args)
                torch.cuda.synchronize()
                want = gk.PLAIN[kernel](*args)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name} {dname} {shape}: non-finite output")
                err = float((got - want).abs().max())
                rel = err / max(float(want.abs().max()), 1e-300)
                line = f"{name:9s} {dname} B,Rl,I,Rr,r1,r2={shape}: max|diff| {err:.3e}, rel {rel:.3e}"
                if shape == bench_shape and dtype == torch.float32:
                    ms = cuda_time(lambda: kernel(*args))
                    plain_ms = cuda_time(lambda: gk.PLAIN[kernel](*args))
                    library_ms = cuda_time(lambda: library[name](*args))
                    bound, by = bound_ms(flops(name, *shape), nbytes(*args, got))
                    report[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound, bound_by=by, library_ms=library_ms)
                    line += (f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, one einsum "
                             f"{library_ms:.3f} ms, bound {bound:.3f} ms ({by})")
                print(line, flush=True)
                if rel > KERNEL_TOL[dname]:
                    raise AssertionError(f"{name} disagrees with its plain version: rel {rel:.3e}")
    # The last right edge of the bench sweep: C (B, R, I, 1), G (B, 1, 1)
    C, G = kernel_inputs((B, R, I, 1, r, 1), torch.float32, gen)["gram_edge"]
    ms = cuda_time(lambda: gk.gram_edge(C, G))
    plain_ms = cuda_time(lambda: gk.gram_edge_plain(C, G))
    library_ms = cuda_time(lambda: library["gram_edge"](C, G))
    bound, by = bound_ms(flops("gram_edge", B, R, I, 1, r, 1), nbytes(C, G) + B * R * R * 4)
    print(f"gram_edge float32 last edge C {tuple(C.shape)}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, one einsum {library_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    return report


def tt_problem(ranks, I, B, dtype, seed, negative=False):
    """Cores N(0,1)/sqrt(R_k) (R_k, I, R_{k+1}), coordinates (B, N) and
    weights (B,) from numpy seeds, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    N = len(ranks) - 1
    cores = [torch.from_numpy(rng.standard_normal((ranks[k], I, ranks[k + 1])) / np.sqrt(ranks[k]))
             .to("cuda", dtype) for k in range(N)]
    X = torch.from_numpy(rng.integers(-I if negative else 0, I, (B, N))).cuda()
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
    shapes = [
        ("design", [1] + [E["R"]] * (E["N"] - 1) + [1], E["I"], E["B"], False),
        ("training", [1] + [T["R"]] * (T["N"] - 1) + [1], T["I"], T["B"], False),
        ("ragged", [2, 5, 3, 7, 3], 37, 1000, True),
        ("ragged", [2, 5, 3, 7, 3], 37, 1, True),
    ]
    report = {"tt_eval": {}, "tt_eval_backward": {}}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for tag, ranks, I, B, negative in shapes:
            cores, X, g = tt_problem(ranks, I, B, dtype, seed=3, negative=negative)
            got = te.tt_eval_kernel(cores, X)
            grads = te.tt_eval_backward_kernel(cores, X, g)
            torch.cuda.synchronize()
            want = te.tt_eval_plain(cores, X)
            want_grads = te.tt_eval_backward_plain(cores, X, g)
            torch.cuda.synchronize()
            errs = {}
            for name, a, b in [("tt_eval", [got], [want]), ("tt_eval_backward", grads, want_grads)]:
                if not all(torch.isfinite(x).all() for x in a):
                    raise AssertionError(f"{name} {dname} {tag}: non-finite output")
                err = max(float((x - y).abs().max()) for x, y in zip(a, b))
                rel = err / max(max(float(y.abs().max()) for y in b), 1e-300)
                errs[name] = (err, rel)
                if rel > KERNEL_TOL[dname]:
                    raise AssertionError(f"{name} disagrees with its plain version: rel {rel:.3e}")
            line = (f"{tag:8s} {dname} ranks {ranks} I={I} B={B}{' negative X' if negative else ''}:"
                    f" tt_eval rel {errs['tt_eval'][1]:.3e}, backward rel "
                    f"{errs['tt_eval_backward'][1]:.3e}")
            if tag == "design" and dtype == torch.float32:
                fwd_flops, bwd_flops = tt_work(cores, X)
                runs = {
                    "tt_eval": (lambda: te.tt_eval_kernel(cores, X),
                                lambda: te.tt_eval_plain(cores, X),
                                bound_ms(fwd_flops, nbytes(*cores, X, got))),
                    "tt_eval_backward": (lambda: te.tt_eval_backward_kernel(cores, X, g),
                                         lambda: te.tt_eval_backward_plain(cores, X, g),
                                         bound_ms(bwd_flops, nbytes(*cores, X, g, *grads))),
                }
                for name, (kern, plain, (bound, by)) in runs.items():
                    ms = cuda_time(kern, reps=3, inner=3)
                    plain_ms = cuda_time(plain, reps=3, inner=3)
                    report[name].update(max_abs_err=errs[name][0], ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound, bound_by=by, library_ms=None)
                    line += (f"\n    {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                             f"bound {bound:.3f} ms ({by}), {B / ms * 1e3:.3e} samples/s")
            print(line, flush=True)
    return report


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
    want = {"gram_edge": 3, "wgram": 2, "proj2": 2}
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

    plain = {k: gk.PLAIN[getattr(gk, k)] for k in want}
    kern = {k: getattr(gk, k) for k in want}

    def timed(use_plain):
        for k in want:
            setattr(gk, k, plain[k] if use_plain else kern[k])
        try:
            return cuda_time(sweep, reps=5, inner=3)
        finally:
            for k in want:
                setattr(gk, k, kern[k])

    order = [False, True, True, False]
    runs = {False: [], True: []}
    for use_plain in order:
        runs[use_plain].append(timed(use_plain))
    ms_k, ms_p = min(runs[False]), min(runs[True])
    print(f"sweep time, B={B}: kernels {runs[False]} ms, plain versions {runs[True]} ms; "
          f"per sample {ms_k / B:.4f} ms (kernels), {ms_p / B:.4f} ms (plain)")

    # Where one sweep's device time goes, by kernel (torch.profiler)
    profile_device(sweep, steps=1)
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


def profile_device(fn, steps):
    """Run ``fn`` under torch.profiler; print the wall time, the device's
    busy time by kernel and its idle share, per step."""
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
        print(f"{name}: {tuple(values.shape)} values, launches (forward, backward) {counts}")
        if counts != [1, 0] or tuple(values.shape) != (B,) or not torch.isfinite(values).all():
            raise AssertionError(f"{name}: expected one forward launch and {B} finite values")
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

    runs = {True: [], False: []}
    for kernel in (True, False, False, True):
        runs[kernel].append(cuda_time(lambda: tn.tt_eval(t.cores, X, use_kernel=None if kernel
                                                         else False), reps=3, inner=3))
    best = {k: min(v) for k, v in runs.items()}
    print(f"tn.tt_eval at B={B}: kernel {runs[True]} ms, plain chain {runs[False]} ms; "
          f"{B / best[True] * 1e3:.4e} evals/s (kernel), {B / best[False] * 1e3:.4e} evals/s (plain)")
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

    te.reset_launches()
    t, hist = fit(steps - 1)
    torch.cuda.synchronize()
    launches = {k.__name__.replace("_kernel", ""): k.launches for k in te.KERNELS}
    print(f"{len(hist)} steps, launches {launches}; loss {hist[0]:.6f} -> {hist[-1]:.6f}")
    if t.device.type != "cuda":
        raise AssertionError(f"the TT trained on {t.device}")
    if launches != {"tt_eval": steps, "tt_eval_backward": steps} or len(hist) != steps:
        raise AssertionError(f"expected {steps} steps with one forward and one backward launch each")
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError("the loss did not fall")
    _, ref = fit(steps - 1, device="cpu", dtype=np.float64)
    err = float(np.max(np.abs(np.array(hist) - ref) / np.abs(ref)))
    print(f"card f32 vs CPU f64, {steps} losses: max rel {err:.3e} (tol {TRAIN_TOL})")
    if not err <= TRAIN_TOL:
        raise AssertionError("training disagrees with the CPU float64 run")

    # Iterations per second, kernels and plain versions in turns
    kern = (te.tt_eval_kernel, te.tt_eval_backward_kernel)
    plain = (te.tt_eval_plain, te.tt_eval_backward_plain)
    timed_steps = 200

    def timed(use_plain):
        te.tt_eval_kernel, te.tt_eval_backward_kernel = plain if use_plain else kern
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(timed_steps - 1)
            torch.cuda.synchronize()
            return timed_steps / (time.perf_counter() - t0)
        finally:
            te.tt_eval_kernel, te.tt_eval_backward_kernel = kern

    rates = {False: [], True: []}
    for use_plain in (False, True, True, False):
        rates[use_plain].append(timed(use_plain))
    print(f"optimize, {timed_steps} steps a run: kernels {[round(r, 1) for r in rates[False]]} "
          f"iters/s, plain versions {[round(r, 1) for r in rates[True]]} iters/s")
    profile_device(lambda: fit(9), steps=10)
    return launches


def main():
    if not os.path.isdir(os.path.join(ROOT, "tntorch_tpu_torch")):
        raise SystemExit("chip_smoke.py needs the repository beside it (tntorch_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    smi = probe()
    build()
    report = check_kernels()
    report.update(check_tt_kernels())
    launches = main_path()
    nonbatch_pass()
    evals = eval_path()
    trains = train_path()
    launches.update({k: evals[k] + trains[k] for k in evals})

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
