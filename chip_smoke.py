#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tntorch_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, each fatal on failure:

1. device probe: a CUDA card must be present (no CPU fallback);
2. build the hand-written kernels from ``tntorch_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the bench
   cell's shapes and at ragged shapes, float32 and float64, with times;
4. the main path: batched TT rounding of B=32 TTs (N=4, I=256, rank
   128 -> 64, float32) through ``Tensor.round_tt(algorithm='randgram')``,
   with launch counts, a check of two samples against the port on the CPU
   in float64, the sweep's time with the kernels and with their plain
   versions, and a torch.profiler breakdown of one sweep;
5. a non-batch pass on the card (``+``, ``*``, ``round_tt``, ``dot``,
   ``norm``) against the same on the CPU.

The second-to-last line is one JSON object with each kernel's launches,
error and times; the last is ``{"ok": true, "device": {...}}``.
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

BENCH = dict(B=32, N=4, I=256, R=128, rmax=64)


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
    so = _build.build()
    _build.library()
    print(f"built {so.name} in {time.time() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())


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
                    report[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
                    line += f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
                print(line, flush=True)
                if rel > KERNEL_TOL[dname]:
                    raise AssertionError(f"{name} disagrees with its plain version: rel {rel:.3e}")
    # The last right edge of the bench sweep: C (B, R, I, 1), G (B, 1, 1)
    C, G = kernel_inputs((B, R, I, 1, r, 1), torch.float32, gen)["gram_edge"]
    ms = cuda_time(lambda: gk.gram_edge(C, G))
    plain_ms = cuda_time(lambda: gk.gram_edge_plain(C, G))
    print(f"gram_edge float32 last edge C {tuple(C.shape)}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: CPU ops and annotation ranges (the library's "tn.*"
    # spans appear on the device too) carry the device time of what they
    # enclose, which would count it twice
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("tn.")),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled sweep (profiler on): wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.2f}); top device time:")
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")
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


def main():
    if not os.path.isdir(os.path.join(ROOT, "tntorch_tpu_torch")):
        raise SystemExit("chip_smoke.py needs the repository beside it (tntorch_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    smi = probe()
    build()
    report = check_kernels()
    launches = main_path()
    nonbatch_pass()

    import torch

    replaces = {
        "gram_edge": "tntorch_tpu/ops/pallas_gram.py:125",
        "wgram": "tntorch_tpu/ops/pallas_gram.py:187",
        "proj2": "tntorch_tpu/ops/pallas_gram.py:254",
    }
    kernels = [
        {"name": name, "route": "cuda", "source": "tntorch_tpu_torch/csrc/gram_kernels.cu",
         "replaces": replaces[name], "launches": launches[name], **report[name]}
        for name in ("gram_edge", "wgram", "proj2")
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
