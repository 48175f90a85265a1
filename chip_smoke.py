#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tntorch_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, then the result lines
    python3 chip_smoke.py --only 3b,8     # probe, build and those phases only

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, each fatal on failure:

1. device probe: a CUDA card must be present (no CPU fallback);
2. build the hand-written kernels from ``tntorch_tpu_torch/csrc``, one
   ``nvcc`` per source, and the host maxvol library
   (``csrc/maxvol_host.cpp``) with the host C++ compiler, all started
   together;
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
   is read by the profiler beside its call's time. The per-sample kernels
   (one lane group per sample, `_per_sample_plan`) are also held at
   PER_SAMPLE's shapes (cp[X] at 2^20 points, training, OPT4, config 3's
   held-out points, ranks 129, one and two modes), f32 and f64, within
   KERNEL_TOL of their plain versions, the forward bitwise equal on two
   calls and an out-of-range coordinate raising IndexError at every shape;
   every plan they can be forced into is held at PLAN_SHAPES (``--only
   3s``); and their device and call times are read beside their bounds
   (``--only 3t``, which runs on the parent commit's tree too; at the
   training shape also each wrapper's host time per call). Off by default,
   ``--only 3x`` times each choice of the per-sample plan forced both ways
   (`plan_choices`). The per-sample kernels' bfloat16 and float16
   instances are held at the design shape and in 20 steps of phase 7's
   training, and chains past 128 modes at 200 and 512 modes, each counted
   through ``tn.tt_eval`` and autograd and timed (`check_half_and_long`,
   ``--only 3n``); every forced plan is held in all four dtypes.
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
   versions, and a profile of three steps;
9. BASELINE configurations 1 and 2 at their own size, float64, and Tucker
   compression of the rounding ensemble: (9a) ``tn.randn(32, 32, 32, 32,
   ranks_tt=5)`` with ``mean``, ``sum``, ``sum(dim=[1, 3])``, ``var``,
   ``std``, ``norm``, ``t[3, :, 5, 7:20]``, ``t[X]`` at 4096 coordinates and
   ``round(1e-6)`` against the dense tensor on the card (1e-6) and against
   the port on the CPU (1e-10); (9b) the dense 64^4 tensor
   ``1/(i+j+k+l+1)`` built on the card, decomposed by ``Tensor(x,
   eps=1e-9)`` (1e-9 against dense; ranks, coefficients and compression
   printed; timed by CUDA events), by ``ranks_tt=10, ranks_tucker=10``,
   and by ``ranks_tt=10`` with ``algorithm='gram'`` and ``'randomized'``,
   each in float64 and float32, with errors and times, ranks and values
   checked against the port on the CPU in float64; (9c) phase 4's ensemble
   rounded by ``round_tt(rmax=64, algorithm='randgram')`` (launch counts
   2/2/2) and then Tucker-rounded by the batched ``round_tucker(rmax=64)``,
   two samples against the CPU in float64, the Tucker stage timed.
   ``python3 chip_smoke.py --only 9`` runs the probe, the build and this
   phase only;
10. TT-cross (``tn.cross``, its validation on the ``tt_eval`` kernel), each
   part at its own size: (10a) BASELINE config 3, a 10-D sum of sines on
   32^10 with eps=1e-6 and seed 0, and (10b) the reference's tutorial
   cross, the 5-D Hilbert tensor 1/sum(x) on 32^5 with seed 7, each a warm
   timed call in float32 and in float64: val_eps below 1e-6, the
   approximation at 10^5 held-out grid points (``t[X]``, the ``tt_eval``
   kernel) against float64 values of the function (1e-6 in float64,
   ``CROSS_F32_TOL`` in float32), the float64 rank schedule and sample
   count equal to the port's on the CPU, one ``tt_eval`` launch per input
   and per iteration, and f-evals/s (samples over the call's wall time,
   ending in a synchronize, as benchmarks/bench_cross.py defines it);
   (10c) the fixed-rank throughput shape (N=5, I=256, ranks_tt=100,
   max_iter=2, float32; its maxvol calls work on 25600 x 100, past the LU
   tournament's block): f-evals/s, val_eps and the held-out error within
   ``CROSS_FIXED_TOL``, then a counted run (`counted_maxvol`): the maxvol
   calls, the launches of their kernels and the host syncs inside them
   (none), a float64 run held to the port's on the CPU (iterations,
   sample count, held-out error within ``CROSS_FIXED_F64_TOL``),
   ``maxvol_device`` alone on a 25600 x 100 orthonormal matrix (float64:
   the CPU's rows, and C within 1e-12 of a solve; float32: converged, C
   within 1e-4 of the float64 solve at its rows), both maxvol kernels
   against their plain versions there (`hold_maxvol_kernels`), and a
   torch.profiler split of one iteration by the sweep's spans (fibers, QR,
   LU, swaps, solves, validation) with the device's idle share. Phases 10,
   11b and 17 pass ``fuse=False``: they hold the eager sweep (phase 18 the
   fused one). In 10a-10c the ``tt_eval``
   kernel, on both its routes, is held to its plain version (``KERNEL_TOL``)
   at every shape the crosses give it: the inputs at the validation set,
   the approximation at the validation set and at the held-out points;
   those launches are not counted. ``--only 10`` runs it alone;
11. the elementwise family, the minimizing cross and ``cross_forward``:
   (11a) every name of ``tn.ops.__all__``, ``t / t2``, ``2.0 / t``,
   ``t ** 2``, ``2.0 ** t``, ``cumsum`` and ``cumprod`` along modes 1 and
   3, in float64 and float32, on BASELINE config 1's size (32^4; inputs
   1.5 + u and u - 0.5, u a ``tn.rand`` rank-5 TT mapped onto [0, 1]), each
   against the same function of the dense tensor on the card (1,048,576
   values, ``FAMILY_TOL``), ``skew`` and ``kurtosis`` of config 1's own
   ``tn.randn`` TT against the dense moments (``KURTOSIS_TOL``), ``tn.exp`` and ``tn.sqrt``
   of config 3's cross result at 10^5 held-out points, and f-evals/s of a
   warm ``tn.exp``; (11b) the minimizing cross in float64: the separable
   5-D function of tests/test_cross.py on 32^5 within ``MIN_OPT_TOL`` of
   the dense optimum on the device path and the ``record_samples`` host
   path, ``minimum``/``argmin``/``maximum``/``argmax`` of config 1's
   ``tn.randn`` and ``minimum`` of config 3's sines against the port on
   the CPU, the warm times at 32^5 and 32^10, and the host syncs of one
   iteration (CUDA's sync debug mode: one outside ``maxvol_device``, none
   inside); the family of 11a and 11c's cross run the card's default,
   the fused sweep;
   (11c) ``cross_forward`` of x**2 on a 32^4 rank-5 TT with autograd: the
   forward against the cross's result, the gradient of ``normsq`` against
   the same replay on the CPU, the warm forward + backward time. The
   ``tt_eval`` kernel, both routes, is then held to its plain version at
   the shapes the phase gave it, and one float32 ``tn.exp`` is profiled
   (idle share). ``--only 11`` runs it alone;
12. BASELINE config 4, tensor completion and regression, at the repo's own
   sizes, float64 unless named: (12a) ALS completion at bench.py's shape
   (32^4 rank 3, 20,000 samples, every slice sampled, 5 sweeps; float64
   and float32 from one x0): training eps, the error at 10^5 held-out
   points, samples/s, the float64 reconstruction against the port on the
   CPU; (12b) ``tn.optimize`` at bench.py's ``bench_optimize`` shape (64^3
   rank 8, 20,000 samples, Adam lr 1e-3, 640 steps, block_iters 64; also in
   float32) and exponential machines (examples/exponential_machines.py: 10
   binary features, 2000 samples, rank 4, Adam lr 1e-2, up to 2000 steps):
   a falling loss, the first 20 losses against the CPU, iters/s, the
   machine's train R^2 and one forward and one backward launch a step;
   (12c) ``TTClassifier`` on the Swiss roll (single and 4 bagged) and
   ``TTRegressor`` at 2^16 samples (DCT factors, and a plain TT on the
   evaluation kernels), 300 steps each, against the same fits on the CPU;
   (12d) sparse TT-SVD on its dense path (196,608 samples of a planted
   rank-3 32^4 TT) and sketched path (61,440 samples of a 16384 x 32 x 32
   rank-4 TT), ``lars_path`` against its NumPy oracle, and the PCE
   surrogate (examples/pce.py's size) against the CPU; (12e) the tools on
   config 1's size against the dense tensor on the card (cat, transpose,
   the partial dot, flip, unbind, pad, mask, reduce of 64 TTs,
   shift_mode), hash across representations, sample (10^6 points,
   marginals within 5 sigma), convolve against scipy, generate_basis. Then
   one block of exponential machines and one ALS sweep are profiled, the
   launches are read, and the ``tt_eval`` kernel, both routes, is held to
   its plain version at the phase's shapes. ``--only 12`` runs it alone.
13. CP tensors and BASELINE config 5, float64 unless named: (13a) CP-ALS
   of benchmarks/bench_cp_als.py's 128^3 field at rank 3 (BASELINE.md row
   10), float64 and float32 (warm wall, sweeps, error to the data), the
   float64 result against the port on the CPU; ``randn`` with ``ranks_cp``
   at 32^4, CP + TT arithmetic, ``dot``, ``norm``, ``full`` and slicing
   against dense; ``t[X]`` of the CP tensor at 2^20 coordinates (its TT
   view on the ``tt_eval`` kernel); ``tn.exp`` of a CP tensor by cross;
   (13b) the Sobol indices, mean dimension and dimension distribution of
   examples/sobol_indices.py's 20-D g-function at 32 points a mode against
   their closed forms, the same calls on a 20-D randn TT of rank 10 against
   the port on the CPU, logic formulas, ``accepted_inputs`` and a
   mask-Tensor key; (13c) 32 potentials on 256^3 at TT rank 16 in one
   batch: gradient, divergence, curl and laplacian, ``div grad -
   laplacian`` and ``curl grad`` at roundoff over the batch, two fields
   against NumPy's differences and the port on the CPU, the divergences
   (rank 49) rounded to 16 by 'gram' (float64) and 'randgram' (float32) on
   the Gram kernels; (13d) a 4096 x 4096 operator (a sum of 4 Kronecker
   products) as ``TTMatrix`` and ``CPMatrix`` in the (8, 8, 8, 8) layout,
   ``tt_multiply`` and ``cp_multiply`` of 16 TT vectors against the dense
   product, a Kronecker ``TTMatrix``'s determinant and inverse against
   torch.linalg. Then the launches are read, the field chain is profiled,
   and ``tt_eval`` (both routes) and each Gram kernel are held to their
   plain versions at the phase's shapes, the Gram kernels timed against
   them in turns. ``--only 13`` runs it alone;
14. the modules ported last, float64 unless named: (14a) assignment at the
   evaluation design shape (N=4, I=1024, R=64, float64 and float32): a
   rank-1 TT into the slab ``t[:, 5:9]``, a scalar at the repeated rows
   ``t[[3, 700, 3]]`` and a rank-1 TT at the negative int key ``t[:, -2]``,
   each on a clone, its wall and ranks printed, then ``t[X]`` at 2^20
   points forced onto the grouped ``tt_eval`` kernel: the original's values
   outside the assigned region and the value's inside (``ASSIGN_TOL``);
   (14b) ``save``/``load`` of phase 4's B=32 ensemble, a Tucker and a CP
   tensor and 13d's ``TTMatrix``/``CPMatrix`` through a temporary
   directory (walls, sizes, loaded arrays bitwise equal), then
   ``round_tt(rmax=64, 'randgram')`` of the loaded ensemble (2/2/2 Gram
   launches) bitwise equal to the rounding before saving; (14c) the bf16
   Gram variant (``set_policy('bf16')``) of the ensemble: its truncation
   error within ``BF16_FACTOR`` of the float32 sweep's, its distance to the
   CPU's float64 rounding and to the float32 sweep, two samples against
   the port's bf16 body on the CPU (``BF16_CPU_TOL``), and both sweeps
   timed in turns; (14d) BASELINE config 3 by ``cross(fuse='host')`` with
   a NumPy function, pivoting on the host maxvol library and on the NumPy
   loop (``maxvol._maxvol_plain``), and by the eager device sweep, in
   turns: equal ranks, val_eps and 10^5 held-out points (``t[X]`` on the
   card) within 1e-6, f-evals/s of each, the host sweeps' share in maxvol
   and maxvol's time a call at each shape, the library's calls (none of
   the NumPy loop in its run); the same at 10c's fixed-rank 256^5 cross
   at ranks 100 (the host sweeps within ``HOST_FIXED_TOL``, the device
   sweep within ``CROSS_FIXED_F64_TOL``); ``maxvol`` alone at 25600 x 100
   in float64 and float32 and at config 3's largest pivot matrix, the
   library against the NumPy loop in turns (median of 3), rows equal and C
   within ``MAXVOL_TOL`` (also ``rect_maxvol(maxK=r)``), beside the host
   CPU's model (``lscpu``; ``--only 14d`` runs 14d alone). Then the
   launches are read, and ``tt_eval`` (both routes) and each Gram call of
   14b's path (recorded by ``recording_gram``) are held to their plain
   versions. ``--only 14`` runs it alone;
15. the tutorials (``tntorch_tpu_torch/examples/``, the port of the JAX
   package's ``examples/``; ``multichip.py`` runs in phase 16c), each through its
   ``main()`` as a user runs it: the eight analytic ones (decompositions,
   arithmetic and formats, Sobol indices, logic and automata, vector
   fields, ANOVA and active subspaces, cross approximation, batch
   ensembles) in float64, where vector_fields' batched 'gram' rounding
   takes the Gram kernels, and the four training ones (completion, PCE,
   classification, exponential machines) in float32 at their own sizes
   and iteration counts, each held by ``examples.expected.check`` to the
   JAX tutorials' figures and to its claims; per tutorial its wall, its
   launches of each kernel, the grouped ``tt_eval`` count and the route
   of each rounding. Every ``tt_eval``, ``tt_eval_backward`` and Gram call
   the tutorials made (recorded by ``recording_tt_eval`` and
   ``recording_gram``) is then held to its plain version, and one forward
   call of each tutorial on both ``tt_eval`` routes. ``--only 15`` runs it
   alone; ``tutorials_path("cpu", expected.CPU_CAPS)`` rehearses it on the
   CPU;
16. the parallel layer (``tntorch_tpu_torch/parallel``), each case at the
   size of the phase it borrows from: the mode-sharded Gram rounding of
   phase 4's first TT (float32 at tp=4 and tp=2, float64 at tp=4), the
   batch-sharded rounding of phase 4's ensemble, ``tt_forward_sharded`` at
   the evaluation design shape (dp=4; and at (2, 2), the alternating layout,
   on all 2^20 rows) and ``optimize(mesh=)`` of phase 7's training: (16a) on
   one rank of an NCCL process group, mesh (1, 1), (16b) on four ranks
   sharing the card in a gloo process group (NCCL refuses two ranks on one
   card), meshes (1, 4), (2, 2) and (4, 1); per rank its launches of each
   kernel (2/2/2 Gram launches for a sweep), its collectives with their
   sizes, its walls, and every kernel call it made held to the plain
   version; each result against the single-process port on the card and
   against the CPU in float64; (16c) the multichip tutorial on four ranks
   of the card, held by ``examples.expected.check``. The walls are of ranks
   sharing one card, their collectives through host memory: not
   multi-card numbers. ``--only 16`` runs it alone;
   ``parallel_path("cpu", small sizes)`` rehearses it on the CPU;
17. the last ``mesh=`` paths and the checkpoints, on four gloo ranks sharing
   the card (mesh (4, 1)), each case against the single-process port on the
   card at the size of the phase it borrows from (``SIZES17``): (17a)
   ``cross(mesh=)``, fiber-parallel over dp=4, on BASELINE config 3 (float64
   and float32) and phase 10c's fixed-rank 256^5 cross at ranks 100
   (float32): the rank schedule, sample count and every rank's index sets
   equal to the single process's, the approximations within ``CROSS17_TOL``,
   val_eps within its limit; config 3 on the fused sweep (``fuse=True``,
   float64: one all-gather a step of every iteration the chunks ran,
   index sets equal to the single process's fused run); the batched
   minimize of phase 11b's separable function as B=8 rank-2 TTs over dp=4,
   by one cross per sample (``fuse=False``) and by the one stream
   (``fuse=True``: one all-gather a chunk, then the minima's and the
   argmins'): minima and argmins equal, the dense optima within
   ``MIN_OPT_TOL``; (17b) ``als_completion(mesh=)`` on config 4
   (phase 12a's), float64, within ``ALS17_TOL``; (17c) phase 12c's
   ``TTRegressor`` at 2^16 samples as a plain TT (its samples over dp; the
   tt_eval kernels forward and backward) and as an 8-member ensemble (its
   members over dp), and the 4-member ``TTClassifier`` ensemble on the Swiss
   roll: predictions within rtol ``PRED17_RTOL`` and atol ``PRED17_ATOL``;
   (17d) phase 14b's 1 GiB ensemble by ``save_orbax_sharded``
   batch-sharded over dp (8 TTs a rank), ``load_orbax_sharded`` onto the
   mesh (shards and placements bitwise), then ``round_tt_batch_sharded`` of
   the restored shards (2/2/2 Gram launches a rank) bitwise equal to that
   of the shards placed before saving; in the single process
   ``save_orbax``/``load_orbax`` and ``.npz`` of the ensemble and the
   sharded checkpoint loaded without a mesh, each bitwise, with their
   walls. Per case and rank: its launches of each kernel, its collectives
   (count and largest), its walls beside the single process's; every kernel
   call it made held to the plain version. ``--only 17`` runs it alone;
   ``mesh_paths_path("cpu", small sizes)`` rehearses it on the CPU;
18. the fused cross tier (``cross(fuse="auto")`` on the card: speculative
   chunks of 6, then 4, iterations with one read each, on the maxvol
   kernels ``lu_rows`` and ``maxvol_swaps``), each run against the same
   call with ``fuse=False`` in turns (``SIZES18``): (18a) BASELINE config 3
   and (18b) the 5-D Hilbert cross of phase 10, float64 and float32, held
   to val_eps below eps and the held-out limits of 10a-10b; (18c) 10c's
   fixed-rank 256^5 cross at ranks 100 (its 25600 x 100 Q on the
   resident grid of the swap kernel), float64 and float32, within
   ``CROSS_FIXED_F64_TOL`` and ``CROSS_FIXED_TOL``; each float64 fused run
   with the eager run's ranks, samples and iterations; (18d) 11b's
   minimizing cross of the separable function on 32^5, within
   ``MIN_OPT_TOL`` of the dense optimum, fused and eager equal; (18e)
   ``tn.exp`` on config 1's size, float32, within ``FAMILY_TOL``. Per run:
   ``fused``, walls in turns, f-evals/s; the launches of ``tt_eval``,
   ``lu_rows`` and ``maxvol_swaps`` on that path; (18f) a counted run of
   each (`count_reads18`, CUDA's sync debug mode, the grids already on the
   card): one host read per chunk, none inside ``maxvol_device``; profiles
   of the fused config-3 and 256^5 runs (idle share, the maxvol kernels'
   share of the device time: `profile18`); (18g) each route of
   ``maxvol_swaps`` at a shape of its own (the cluster at the phase's
   1024 x 46 Q and on 16 CTAs, the resident grid at the 25600 x 100 Qs in
   float32 and float64, the streamed grid past the resident grid's last
   shape) and ``lu_rows`` (its Qs' first r rows and whole permutations,
   the tournament's last LU), timed in turns with their plain versions
   (the call by CUDA events, the kernel by torch.profiler, time per swap)
   beside their bounds and ``torch.lu_unpack``'s permutation matrix; every
   route held bitwise to the plain version at the last shape of each route
   and the first of the next, forced on small shapes, and on ties and a
   NaN (`hold_swap_routes`); then every recorded Q shape (up to four of
   each dtype and route) held to the plain versions (rows equal, C within
   ``MAXVOL_TOL``). ``--only 18`` runs it alone; ``fused_path("cpu", small
   sizes)`` rehearses it on the CPU with ``fuse=True`` (no counts,
   profiles or kernels there). Two sub-phases run only when named:
   ``--only 18x`` times the cluster route against the resident grid in
   turns up to 16 CTAs' shared memory (`swap_crossover`, what sets
   ``_CLUSTER_MAX_BYTES``); ``--only 18p`` runs 18f's profiles and the
   swap kernel at the sweep's shapes, for comparing two trees
   (`maxvol_profiles`);
19. the one-stream batched minimize (``tn.minimum``, ``argmin``,
   ``maximum``, ``argmax`` of a batch, ``fuse="auto"``: every sample as one
   stream of fused chunks on the batched maxvol kernels), each against
   the per-sample loop (``fuse=False``) in turns (``SIZES19``): phase 17's
   B=8 separable 32^5 batch, float64 (optima within ``MIN_OPT_TOL``,
   argmins and argmaxes the dense ones), and phase 4's B=32 ensemble
   rounded to rank 64, float32 and float64 (each optimum equal to t at its
   coordinates within ``KERNEL_TOL``; the float64 minima against the CPU's
   one stream within ``MIN_CPU_TOL``, argmins equal, argmaxes compared).
   Per batch: walls in turns (one stream, loop, one stream), the one
   stream's launches (``tt_eval`` 1 + 10, ``lu_rows`` and ``maxvol_swaps``
   one a maxvol step, for the whole batch) against the loop's, host reads
   by CUDA's sync debug mode (one a chunk); then every batched ``maxvol_swaps`` shape of the runs held
   bitwise to the plain loop, and at the largest of each B and dtype one
   batched launch timed in turns against B single launches and the plain
   loop beside its bound. ``--only 19`` runs it alone;
   ``one_stream_path("cpu", small sizes)`` rehearses it on the CPU.

The data of phases 6 to 8 comes without a device and lands on the card by
the package's default. The second-to-last line is one JSON object with
each kernel's launches, error, times and bound; the last is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
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
# - BASELINE configs (BASELINE.json): config 1 within 1e-6 of the dense
#   tensor, config 2 within 1e-9; both in float64.
CONFIG1_TOL, CONFIG2_EPS = 1e-6, 1e-9
# - the same float64 computation on the card and on the CPU: roundoff, 1e-10
#   for config 1's values and for config 2's eps and fixed-rank
#   decompositions (cuSOLVER's and the CPU LAPACK's Householder QR of the
#   4096 x 4096 middle unfolding each carry ~n eps = 1e-12 of roundoff:
#   5.1e-12 apart on an H100 against 4.5e-10 of truncation error).
CPU_TOL, DECOMP_TOL = 1e-10, 1e-10
# - 'gram' TT-SVD squares the condition number, so the two libraries' top-r
#   subspaces differ by more than roundoff (3.7e-9 apart on an H100 against
#   1.3e-7 of truncation error): the card's and the CPU's approximations must
#   lie within a tenth of the CPU's own truncation error of each other.
GRAM_SHARE = 0.1
# - 'randomized' TT-SVD: the power iteration squares the spectrum, and a
#   1e-15 perturbation of the input moves its result by about its own error
#   (32^4, 48^4 on the CPU; an H100's error 1.9x the CPU's with the same
#   sketch): its error against dense must stay within 10x the CPU's.
RAND_FACTOR = 10
# - float32 TT-SVD against the dense tensor: the Gram-based kernels square
#   the condition number, so directions below ~3e-4 of the top singular
#   value are roundoff; 1.1e-3 to 3.1e-3 at 32^4 and 48^4 on the CPU. 5e-2.
F32_DECOMP_TOL = 5e-2
# - Tucker rounding of the float32 ensemble on the card against the same
#   input in float64 on the CPU: 1.7e-5 for float32 on the CPU (two
#   samples); the cut of a flat spectrum amplifies roundoff. 1e-3.
TUCKER_TOL = 1e-3
#
# - TT-cross (phase 10): BASELINE's limit, 1e-6, on the reported validation
#   error of every run and on the held-out error of the float64 runs. The
#   float32 runs are held to 1e-5 against float64 values of the function:
#   float32 stores each sample with 6e-8 of relative roundoff, and the
#   10-mode evaluation chain and the interpolation solves (maxvol keeps
#   |C| <= 1.05) each add a few of those, so ~1e-6 is the floor; 1e-5
#   leaves a margin over it.
# - the fixed-rank cross (10c) in float32 runs at rank 100, far beyond the
#   function's numerical rank (its float64 run reaches 1.7e-14 in one
#   iteration): its error is float32 roundoff amplified by the rank-100
#   interpolation (maxvol bounds each core's coefficients by 1.05, not
#   their sum over 100 columns and 5 cores). The port on the CPU reads
#   1.2e-5 and 1.5e-5 (val_eps, two iterations) and 1.6e-5 at the held-out
#   points; 1e-4. The float64 run: the same amplification of float64
#   roundoff, 1.7e-14 on the CPU; 1e-10.
# - maxvol_device alone at 25600 x 100: C after the swaps against a fresh
#   solve at the same rows, max |diff| (|C| <= 1.05): tens of rank-1
#   updates, 9e-15 in float64 and 4e-6 in float32 on the CPU; 1e-12 and
#   1e-4 (float32 against the float64 solve).
CROSS_F32_TOL = 1e-5
CROSS_FIXED_TOL, CROSS_FIXED_F64_TOL = 1e-4, 1e-10
# - the elementwise family (phase 11a): the JAX package's own limit for
#   cross-based ops, 1e-4 relative to the dense result
#   (tests/test_cross.py:44-59), and skew relative to its value. Kurtosis
#   1e-3 relative: the 4th power of config 1's standardized TT needs more
#   rank than 25 iterations of kickrank 3 reach (73), and ``**`` draws its
#   pivots unseeded (as the JAX package's does), so its error is random:
#   over 24 runs of the port on the CPU, float64, median 2.9e-5 and at most
#   1.7e-4 (float32: at most 8.2e-6).
# - the minimizing cross (11b): the dense optimum within 1e-10, the JAX
#   package's own limit (tests/test_cross.py:116-140); the card against the
#   port on the CPU, float64: 1e-12 relative (the same sweep; the fibers'
#   einsums sum in another order), the argmins equal.
# - cross_forward (11c): the replay within 1e-5 of the cross's result (the
#   JAX package's limit, tests/test_cross.py:36-41; least squares at the
#   recorded pivots), and its gradient within 1e-8 of the CPU's, relative
#   to the largest entry (float64 roundoff through an SVD per core).
FAMILY_TOL, KURTOSIS_TOL = 1e-4, 1e-3
MIN_OPT_TOL, MIN_CPU_TOL = 1e-10, 1e-12
FORWARD_TOL, GRAD_TOL = 1e-5, 1e-8
MAXVOL_TOL = {"float32": 1e-4, "float64": 1e-12}
# - the host sweep at the fixed rank 100 on 256^5 (14d), float64, both of
#   its pivots: HOST_FIXED_TOL on val_eps and at the held-out points. Rank
#   100 is far past the function's numerical rank, and the host sweep's
#   Gram-eigh basis (the JAX package's algorithm, which the port's equals
#   index set for index set) squares the condition number, so its
#   interpolation past that rank loses accuracy where the device sweep's QR
#   does not: on the CPU, on 128^5, both packages read val_eps 8.7e-6 after
#   the first iteration and 9.4e-5 after the second, held-out 1.1e-4.
HOST_FIXED_TOL = 1e-3

BENCH = dict(B=32, N=4, I=256, R=128, rmax=64)
# The evaluation kernel's design shape (the TPU kernel's stated regime,
# pallas_tt.py:18-19) and the largest training configuration
# (benchmarks/bench_optimize.py:89)
EVAL = dict(N=4, I=1024, R=64, B=1 << 20)
# BASELINE config 3 (benchmarks/bench_cross.py:33-48): a 10-D sum of sines
# on 32^10; the reference's tutorial cross (bench.py:370-376): the 5-D
# Hilbert tensor 1/sum(x) on 32^5; the fixed-rank throughput shape
# (bench.py:354-387)
CROSS3 = dict(N=10, I=32, lo=0.0, hi=2 * 3.141592653589793, eps=1e-6, seed=0)
HILBERT5 = dict(N=5, I=32, lo=1.0, hi=32.0, eps=1e-6, seed=7)
CROSS_FIXED = dict(N=5, I=256, lo=1.0, hi=256.0, ranks_tt=100, max_iter=2, seed=0)
HELD_OUT = 10 ** 5
VAL_SIZE = 1000  # cross's default validation set
TRAIN = dict(N=3, I=256, R=16, B=8192, steps=20)
# Published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores (TF32 would lose precision under the 'highest' policy), FP64
# on the tensor cores (DMMA, full precision), HBM3 bandwidth
PEAK_FP32, PEAK_FP64, HBM = 67e12, 67e12, 3.35e12


def bound_ms(flops, nbytes, peak=PEAK_FP32):
    """The least time for the work: the larger of its operations over the
    peak of their type (FP32 unless given) and its bytes over the memory
    rate; and which one bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


_START = time.perf_counter()
_PHASES = []  # (name, seconds since the start when it began)


def phase(name):
    """Announces a phase with the seconds since the script started."""
    _PHASES.append((name, time.perf_counter() - _START))
    print(f"== {name} [{_PHASES[-1][1]:.1f} s]", flush=True)


def phase_times():
    """A line on where the run's time went: each phase's seconds, the
    longest first, and the total."""
    ends = [t for _, t in _PHASES[1:]] + [time.perf_counter() - _START]
    spans = sorted(((e - t, n.split(":")[0][:40]) for (n, t), e in zip(_PHASES, ends)),
                   reverse=True)
    return (f"phase times (s), longest first: "
            + "; ".join(f"{n} {d:.1f}" for d, n in spans) + f"; total {ends[-1]:.1f}")


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


def forced_tile(name, tile, fn):
    """``fn()`` with Gram kernel ``name`` (gram_edge and wgram share their
    route) forced onto tile instance ``tile`` at every shape; None forces
    the two-stage kernel."""
    from tntorch_tpu_torch.ops import gram_kernels as gk

    attr = "_proj2_tile" if name == "proj2" else "_gram_tile"
    choice = getattr(gk, attr)
    setattr(gk, attr, lambda *_: tile)
    try:
        return fn()
    finally:
        setattr(gk, attr, choice)


def two_stage_proj2(fn):
    """``fn()`` with proj2 on its two-stage kernel at every shape."""
    return forced_tile("proj2", None, fn)


def two_stage_gram(fn):
    """``fn()`` with gram_edge and wgram on their two-stage kernel at every
    shape."""
    return forced_tile("gram_edge", None, fn)


def gram_instances(name, shape, itemsize):
    """Every tile instance of Gram kernel ``name`` that takes ``shape`` (B,
    Rl, I, Rr, r1, r2), the wrapper's own choice first; then None, the
    two-stage kernel."""
    from tntorch_tpu_torch.ops import gram_kernels as gk

    _, Rl, _, Rr, r1, r2 = shape
    tiles = (gk._proj2_tiles_for(r1, Rl, Rr, r2, itemsize) if name == "proj2"
             else gk._gram_tiles_for(Rl, Rr, itemsize))
    return tiles + [None]


def route_name(tile):
    if tile is None:
        return "two-stage"
    return f"tile r{tile[0]} seg{tile[1]}" if isinstance(tile, tuple) else f"tile {tile}"


def route_kernel(name, tile, itemsize):
    """The CUDA kernel that runs Gram kernel ``name`` on ``tile``, as the
    profiler names it (the sum over slots is a second launch)."""
    if tile is None:
        return "two_stage_kernel"
    if name == "proj2":
        return "proj2_resident_kernel" if itemsize == 4 and tile[0] == 64 else "proj2_tile_kernel"
    if tile == 128:
        return "gram_pair_kernel" if itemsize == 8 else "gram_resident_kernel"
    return "gram_tile_kernel"


def gram_route(kernel, args):
    """The route Gram wrapper ``kernel`` takes on ``args``, by its pure
    route function."""
    from tntorch_tpu_torch.ops import gram_kernels as gk

    if kernel.__name__ == "proj2":
        (B, r1, Rl), (_, Rr, r2) = args[0].shape, args[2].shape
        return route_name(gk._proj2_tile(r1, Rl, Rr, r2, args[1].element_size()))
    B, Rl, I, Rr = args[0].shape
    return route_name(gk._gram_tile(Rl, Rr, args[0].element_size()))


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
    for _ in range(3):  # a session now and then returns no device events: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                       if e.device_type == DeviceType.CUDA and name in e.name)
        if times:
            return times[len(times) // 2], len(times)
    raise AssertionError(f"the profiler saw no launch of {name}")


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
    seconds = getattr(_build, "BUILD_SECONDS", {})  # an older tree's _build has none
    print(f"built {', '.join(so.name for so in paths.values())} in {time.time() - t0:.1f} s; "
          "compiler by source (s): " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
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


def gram_flops(name, B, Rl, I, Rr, r1, r2):
    """The FLOPs of one call of a Gram kernel at B, Rl, I, Rr (and proj2's
    r1, r2): an FMA counts 2."""
    per = {"gram_edge": Rl * Rr * Rr + Rl * Rr * Rl, "wgram": Rl * Rl * Rr + Rl * Rr * Rr,
           "proj2": r1 * Rl * Rr + r1 * Rr * r2}[name]
    return 2.0 * B * I * per


GRAM_EINSUM = {"gram_edge": "zaib,zbc,zdic->zad", "wgram": "zaib,zad,zdic->zbc",
               "proj2": "zra,zaib,zbc->zric"}


def gram_library(name, *args):
    """One PyTorch call that computes Gram kernel ``name``'s function on its
    arguments: a yardstick the port never calls."""
    import torch

    operands = args if name == "proj2" else (args[0], args[1], args[0])
    return torch.einsum(GRAM_EINSUM[name], *operands)


def in_turns(variants):
    """Each call of ``variants`` (name -> call) timed by cuda_time in turns,
    in order and then in reverse; each name's list of times (ms)."""
    turns = {v: [] for v in variants}
    for v in list(variants) + list(variants)[::-1]:
        turns[v].append(cuda_time(variants[v]))
    return turns


# Phase 3's Gram shapes beyond the bench's: P13 is config 5's divergence
# fields (phase 13c) at rank 49 rounded to 16; a rank-16 core rounded to 8;
# PAIR, ragged ranks that float64 serves on the cluster instance
P13 = (32, 49, 256, 49, 16, 16)
RANK16 = (32, 16, 256, 16, 8, 8)
PAIR = (32, 97, 256, 83, 16, 16)


def pair_instance():
    """Prints, once, what ptxas gave float64's cluster instance
    (gram_pair_kernel: numRegs, and localSizeBytes as its stack frame, with
    its spills) and the clusters a wave holds."""
    from tntorch_tpu_torch import _build
    from tntorch_tpu_torch.ops import gram_kernels as gk

    lines, kernel = [], None
    for line in _build.library_path("gram_kernels").with_suffix(".log").read_text().splitlines():
        if "Function properties for" in line:
            kernel = ("gram_edge" if "ILb1E" in line else "wgram") if "gram_pair_kernel" in line else None
        elif kernel and ("Used" in line or "spill" in line):
            lines.append(f"{kernel}: {line.replace('ptxas info    :', '').strip()}")
    waves = [gk._tile_wave(1, kind, 128, 0) for kind in (0, 1)]
    print(f"gram_pair_kernel (float64, tile 128, {gk._PAIR_CTAS} CTAs a cluster, "
          f"{gk._gram_smem(128, 8)} B of shared memory a CTA): clusters a wave, gram_edge / "
          f"wgram: {waves[0]} / {waves[1]}; ptxas: " + "; ".join(lines), flush=True)


def check_kernels():
    phase("3. kernels against their plain versions")
    import torch

    from tntorch_tpu_torch.ops import gram_kernels as gk

    B, R, I, r = BENCH["B"], BENCH["R"], BENCH["I"], BENCH["rmax"]
    bench_shape = (B, R, I, R, r, r)
    # Every tile instance that takes a shape (gram_instances), forced, and
    # the two-stage kernel, f32 and f64, each held to the plain version and
    # bitwise to a second call; the last two shapes are beyond every tile.
    # At the bench shape, P13 and RANK16 each is timed in turns with the
    # plain version, beside one einsum and its bound (f64 at the FP64 peak)
    # PAIR is timed in float64, where it takes the cluster instance
    pair_instance()
    shapes = [bench_shape, P13, RANK16, PAIR, (B, R, I, 1, r, 1), (3, 5, 37, 3, 4, 2),
              (2, 5, 37, 1, 3, 1), (2, 70, 37, 130, 65, 3), (2, 256, 16, 256, 128, 128)]
    kernels = {"gram_edge": gk.gram_edge, "wgram": gk.wgram, "proj2": gk.proj2}
    flops = gram_flops
    report = {name: {} for name in kernels}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        peak = PEAK_FP64 if dtype == torch.float64 else PEAK_FP32
        timed = (bench_shape, P13, RANK16) + ((PAIR,) if dtype == torch.float64 else ())
        for shape in shapes:
            inputs = kernel_inputs(shape, dtype, gen)
            for name, kernel in kernels.items():
                args = inputs[name]
                want = gk.PLAIN[kernel](*args)
                instances = gram_instances(name, shape, dtype.itemsize)
                calls = {route_name(t): (lambda t=t: forced_tile(name, t, lambda: kernel(*args)))
                         for t in instances}
                errs = {}
                for tag, call in calls.items():
                    got = call()
                    again = call()
                    torch.cuda.synchronize()
                    label = f"{name}/{tag}{' (route)' if tag == route_name(instances[0]) else ''}"
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{label} {dname} {shape}: non-finite output")
                    if not torch.equal(got, again):
                        raise AssertionError(f"{label} {dname} {shape}: two calls differ")
                    err = float((got - want).abs().max())
                    rel = err / max(float(want.abs().max()), 1e-300)
                    errs[tag] = err
                    print(f"{label:32s} {dname} B,Rl,I,Rr,r1,r2={shape}: max|diff| {err:.3e}, "
                          f"rel {rel:.3e}, bitwise equal on two calls", flush=True)
                    if rel > KERNEL_TOL[dname]:
                        raise AssertionError(f"{label} {dname} {shape} disagrees with its plain "
                                             f"version: rel {rel:.3e}")
                if shape not in timed:
                    continue
                route = route_name(instances[0])
                turns = in_turns({**calls, "plain": lambda: gk.PLAIN[kernel](*args)})
                ms, plain_ms = min(turns[route]), min(turns["plain"])
                library_ms = cuda_time(lambda: gram_library(name, *args))
                bound, by = bound_ms(flops(name, *shape), nbytes(*args, want), peak)
                # The route's kernel alone on the card's clock (the call's
                # time also holds the host's launch and, on a tile, the sum
                # over slots)
                dev, _ = device_ms(calls[route], route_kernel(name, instances[0], dtype.itemsize))
                print(f"  {name} {dname} {shape} on its route ({route}): {ms:.4f} ms a call, "
                      f"its kernel {dev:.4f} ms, plain {plain_ms:.4f} ms, one einsum "
                      f"{library_ms:.4f} ms (call / einsum {ms / library_ms:.2f}x), bound "
                      f"{bound:.4f} ms ({by}; kernel / bound {dev / bound:.2f}x), "
                      f"{flops(name, *shape) / ms / 1e9:.1f} TFLOP/s\n    in turns (ms): "
                      + "; ".join(f"{v} {t}" for v, t in turns.items()), flush=True)
                if shape == bench_shape and dtype == torch.float32:
                    report[name].update(max_abs_err=errs[route], ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound, bound_by=by, library_ms=library_ms,
                                        two_stage_ms=min(turns["two-stage"]))
                    print(f"    SM clock, power while the route runs: "
                          f"{smi_while(lambda: kernel(*args))}", flush=True)
                if dtype == torch.float64 and instances[0] == 128 and name != "proj2":
                    report[name].setdefault("float64_pair", []).append(dict(
                        shape=list(shape[:4]), max_abs_err=errs[route], ms=ms, kernel_ms=dev,
                        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=library_ms,
                        two_stage_ms=min(turns["two-stage"])))
    # The last right edge of the bench sweep: C (B, R, I, 1), G (B, 1, 1).
    # The sweep routes it to one batched product, as the JAX package does;
    # the kernel still takes it
    C, G = kernel_inputs((B, R, I, 1, r, 1), torch.float32, gen)["gram_edge"]
    Cm = C.reshape(B, R, I)
    ms = cuda_time(lambda: gk.gram_edge(C, G))
    routed_ms = cuda_time(lambda: (Cm * G) @ Cm.mT)
    plain_ms = cuda_time(lambda: gk.gram_edge_plain(C, G))
    library_ms = cuda_time(lambda: gram_library("gram_edge", C, G))
    bound, by = bound_ms(flops("gram_edge", B, R, I, 1, r, 1), nbytes(C, G) + B * R * R * 4)
    err = float(((Cm * G) @ Cm.mT - gk.gram_edge(C, G)).abs().max())
    print(f"gram_edge float32 last edge C {tuple(C.shape)}: kernel {ms:.3f} ms, routed "
          f"batched product {routed_ms:.3f} ms (max|diff| to the kernel {err:.3e}), plain "
          f"{plain_ms:.3f} ms, one einsum {library_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    return report


def device_per_call(fn, calls=20):
    """Device time (ms) per call of ``fn``: every kernel it launches, summed
    over `calls` calls (torch.profiler), divided by `calls`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then returns no device events: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA]
        if times:
            return sum(times) / 1e3 / calls
    raise AssertionError("the profiler saw no device work")


def time_gram_routes():
    """3g (off by default): each Gram wrapper on its own route at the bench
    shape, P13 and RANK16, f32 and f64, and PAIR in f64: call time (CUDA events) and device
    time per call (profiler) beside one einsum and the bound. It uses only
    the wrappers, so it runs on the parent's tree too: copy this file into
    an unpacked parent and run `--only 3g` there and here in turns."""
    phase("3g. each Gram kernel on its own route: call and device time, one einsum")
    import torch

    from tntorch_tpu_torch.ops import gram_kernels as gk

    B, R, I, r = BENCH["B"], BENCH["R"], BENCH["I"], BENCH["rmax"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((B, R, I, R, r, r), P13, RANK16, PAIR):
        for dtype in (torch.float32, torch.float64) if shape != PAIR else (torch.float64,):
            inputs = kernel_inputs(shape, dtype, gen)
            peak = PEAK_FP64 if dtype == torch.float64 else PEAK_FP32
            for kernel in gk.KERNELS:
                name, args = kernel.__name__, inputs[kernel.__name__]
                ms = cuda_time(lambda: kernel(*args))
                dev = device_per_call(lambda: kernel(*args))
                library_ms = cuda_time(lambda: gram_library(name, *args))
                bound, by = bound_ms(gram_flops(name, *shape),
                                     nbytes(*args, kernel(*args)), peak)
                print(f"3g {name:9s} {str(dtype)[6:]} {shape}: call {ms:.4f} ms, device "
                      f"{dev:.4f} ms a call, one einsum {library_ms:.4f} ms, bound {bound:.4f} ms "
                      f"({by})", flush=True)


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
            again_ps = tt_path(False, lambda: te.tt_eval_kernel(cores, X))
            grads = {p: tt_bwd_path(p == "grouped", lambda: te.tt_eval_backward_kernel(cores, X, g))
                     for p in paths}
            grads_again = tt_bwd_path(True, lambda: te.tt_eval_backward_kernel(cores, X, g))
            torch.cuda.synchronize()
            want = te.tt_eval_plain(cores, X)
            want_grads = te.tt_eval_backward_plain(cores, X, g)
            torch.cuda.synchronize()
            if not torch.equal(got["grouped"], again):
                raise AssertionError(f"grouped tt_eval {dname} {tag}: two calls differ")
            if not torch.equal(got["per-sample"], again_ps):
                raise AssertionError(f"per-sample tt_eval {dname} {tag}: two calls differ")
            tt_path(False, lambda: tt_bwd_path(False, lambda: hold_out_of_range(
                f"per-sample {dname} {tag}", cores, X, g)))
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
                    f"{errs['tt_eval/per-sample'][1]:.3e} (bitwise equal on two calls, out of "
                    "range raises); backward rel grouped "
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
    times = check_per_sample()
    for name, key in (("tt_eval", "fwd"), ("tt_eval_backward", "bwd")):
        report[name]["per_sample"] = {
            f"{tag} {dname}": {"ms": t[f"{key}_dev"], "call_ms": t[f"{key}_call"],
                               "bound_ms": t[f"{key}_bound"], "bound_by": t[f"{key}_by"]}
            for tag, by_dtype in times.items() for dname, t in by_dtype.items()}
    for name, by_tag in check_half_and_long().items():
        report[name]["half_and_long"] = by_tag
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


# Phase 3b's per-sample shapes, (tag, ranks, I, B): cp[X] at phase 13's
# size (P13), the training step (phase 7), OPT4 (phase 12's
# bench_optimize shape), config 3's held-out points (phase 10), ranks 129
# (more than one interface column a lane), and one and two modes
PER_SAMPLE = [
    ("P13", [1, 5, 5, 5, 1], 32, 1 << 20),
    ("training", [1, 16, 16, 1], 256, 8192),
    ("OPT4", [1, 8, 8, 1], 64, 20000),
    ("config3", [1] + [4] * 9 + [1], 32, 10 ** 5),
    ("ranks129", [1, 129, 129, 1], 64, 4096),
    ("N1", [3, 4], 50, 3000),
    ("N2", [1, 16, 1], 128, 5000),
]
# Small shapes on which every plan the wrapper may be forced into is held:
# each lane width from the ranks' own to 32, the cores staged or not, the
# gradients privatized or not; (ranks, I, B, negative coordinates)
PLAN_SHAPES = [
    ([1, 5, 5, 5, 1], 32, 3000, False),
    ([2, 5, 3, 7, 3], 37, 1000, True),
    ([3, 4], 50, 777, True),
    ([1, 16, 1], 64, 1000, False),
    ([1] + [4] * 9 + [1], 32, 1000, True),  # N = 10
    ([1, 40, 40, 1], 16, 500, False),  # 2 columns a lane (backward)
    ([1, 100, 100, 1], 8, 300, False),  # 4 columns a lane (backward)
    ([1, 129, 129, 1], 8, 300, False),  # the interface in shared memory
    ([2, 300, 300, 2], 4, 100, True),
]


@contextlib.contextmanager
def forced_tt_plan(**force):
    """The per-sample kernels on `_per_sample_plan`'s plan with ``force``
    (W, staged, private, shared) imposed, inside the block."""
    from tntorch_tpu_torch.ops import tt_eval as te

    plan = te._per_sample_plan
    te._per_sample_plan = lambda ranks, dims, B, itemsize: plan(ranks, dims, B, itemsize, **force)
    try:
        yield
    finally:
        te._per_sample_plan = plan


def _rel_all(got, want):
    """max |got - want| over max |want|, across lists of tensors."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return err / max(max(float(b.abs().max()) for b in want), 1e-300)


def hold_out_of_range(tag, cores, X, g):
    """An out-of-range coordinate raises IndexError through the flag, in
    both kernels; with ``checked=True`` (no flag read) the forward writes
    NaN for that sample alone and the backward leaves it out."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    bad = X.clone()
    bad[0, -1] = cores[-1].shape[1]
    for fn in (lambda: te.tt_eval_kernel(cores, bad),
               lambda: te.tt_eval_backward_kernel(cores, bad, g)):
        try:
            fn()
        except IndexError:
            continue
        raise AssertionError(f"{tag}: an out-of-range coordinate did not raise")
    got = te.tt_eval_kernel(cores, bad, True)
    want = te.tt_eval_plain(cores, X)
    if not (bool(torch.isnan(got[0])) and torch.isfinite(got[1:]).all()
            and (len(X) == 1 or _rel_all([got[1:]], [want[1:]]) <= KERNEL_TOL[str(g.dtype)[6:]])):
        raise AssertionError(f"{tag}: the out-of-range sample is not NaN alone")
    g0 = g.clone()
    g0[0] = 0
    rel = _rel_all(te.tt_eval_backward_kernel(cores, bad, g, True),
                   te.tt_eval_backward_plain(cores, X, g0))
    if not rel <= KERNEL_TOL[str(g.dtype)[6:]]:
        raise AssertionError(f"{tag}: the out-of-range sample reached the gradient ({rel:.2e})")


def hold_per_sample_plans():
    """3s: both per-sample kernels against their plain versions on
    PLAN_SHAPES under every plan the wrapper can be forced into (f32 and
    f64 within KERNEL_TOL; bf16 and f16 against `half_plain`, output by
    output, `hold_half`; int64 and int32 coordinates), the forward bitwise equal
    on two calls, out-of-range coordinates raising (f32 and f64: the
    coordinates' code is the same in every type); prints the count of plans
    held and the largest error per dtype."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    start, held, worst = time.perf_counter(), 0, {}
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
        dname = str(dtype)[6:]
        for ranks, I, B, negative in PLAN_SHAPES:
            cores, X, g = tt_problem(ranks, I, B, dtype, seed=11, negative=negative)
            dims = [I] * (len(ranks) - 1)
            want = te.tt_eval_plain(cores, X)
            want_grads = te.tt_eval_backward_plain(cores, X, g)
            rc = [c.double() for c in cores]
            ref = te.tt_eval_plain(rc, X), te.tt_eval_backward_plain(rc, X, g.double())
            if dname in HALF:  # the half types against the plain version of their arithmetic
                want, want_grads = half_plain(cores, X, g)
            need = te._per_sample_plan(tuple(ranks), tuple(dims), B, dtype.itemsize).W
            for W in (1, 2, 4, 8, 16, 32):
                # each choice both ways; private None: the plan's own choice per core
                for staged, private in ((False, False), (True, True), (False, None),
                                        (True, None)):
                    if W < need:
                        continue
                    forced = te._per_sample_plan(tuple(ranks), tuple(dims), B, dtype.itemsize,
                                                 W, staged, private)
                    if not (forced.fwd_warps and forced.bwd_warps):
                        continue  # the forced plan does not fit a block: not a plan the card takes
                    tag = (f"{dname} ranks {ranks} I={I} B={B} W={W} staged={staged} "
                           f"private={private}")
                    with forced_tt_plan(W=W, staged=staged, private=private):
                        Xs = X.int() if W == need and staged else X
                        got = te.tt_eval_kernel(cores, Xs)
                        again = te.tt_eval_kernel(cores, Xs)
                        grads = te.tt_eval_backward_kernel(cores, Xs, g)
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"3s {tag}: two forward calls differ")
                        for name, a, b, r in (("tt_eval", [got], [want], [ref[0]]),
                                              ("tt_eval_backward", grads, want_grads, ref[1])):
                            if dname in KERNEL_TOL:
                                rel = _rel_all(a, b)
                                if not (all(bool(torch.isfinite(t).all()) for t in a)
                                        and rel <= KERNEL_TOL[dname]):
                                    raise AssertionError(f"3s {name} {tag}: rel {rel:.3e}")
                            else:
                                rel = hold_half(f"3s {name} {tag}", a, b, r, dname)[0]
                            worst[dname] = max(worst.get(dname, 0.0), rel)
                        held += 1
            if dname in KERNEL_TOL:
                hold_out_of_range(f"3s {dname} ranks {ranks}", cores, X, g)
    print(f"3s per-sample plans: {held} forced plans held on {len(PLAN_SHAPES)} shapes x 4 "
          f"dtypes; largest rel error (bf16/f16: error over max |value| against the float64 "
          f"reference, each output over its own) {worst} (tol {KERNEL_TOL}; bf16/f16 hold_half: "
          f"slack {HALF_SLACK} u, agreement {HALF_AGREE}); "
          f"{time.perf_counter() - start:.1f} s", flush=True)


def host_us(fn, blocks=9, calls=200):
    """The host's time (us) per call of ``fn``: ``blocks`` blocks of
    ``calls`` calls enqueued back to back (for kernels shorter than the
    calls' host work, so the queue does not fill), each block's time per
    call; returns their least and their median."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    times.sort()
    return times[0], times[len(times) // 2]


def time_host():
    """3h: each per-sample wrapper's host time per call at the training
    shape, f32 and f64 (checked=True: no flag read; `host_us`). It uses
    only what the parent commit's ops/tt_eval.py has too, so the same
    function times both trees in turns."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    for dtype in (torch.float32, torch.float64):
        cores, X, g = tt_problem([1, 16, 16, 1], 256, 8192, dtype, seed=12)
        fwd = tt_path(False, lambda: host_us(lambda: te.tt_eval_kernel(cores, X, True)))
        bwd = tt_bwd_path(False, lambda: host_us(
            lambda: te.tt_eval_backward_kernel(cores, X, g, True)))
        print(f"3h training {str(dtype)[6:]}: host per call, least / median of 9 blocks of 200: "
              f"tt_eval {fwd[0]:.1f} / {fwd[1]:.1f} us, tt_eval_backward {bwd[0]:.1f} / "
              f"{bwd[1]:.1f} us", flush=True)


def _per_sample_times(cores, X, g, host=False):
    """The per-sample kernels' device times (profiler, median of 20) and
    whole calls (CUDA events, checked=True: no flag read), forced per sample;
    in ms; with ``host``, each wrapper's host time per call (us)."""
    from tntorch_tpu_torch.ops import tt_eval as te

    def fwd():
        return te.tt_eval_kernel(cores, X, True)

    def bwd():
        return te.tt_eval_backward_kernel(cores, X, g, True)

    def times():
        t = dict(fwd_dev=device_ms(fwd, "tt_eval_kernel")[0], fwd_call=cuda_time(fwd),
                 bwd_dev=device_ms(bwd, "tt_eval_backward_kernel")[0], bwd_call=cuda_time(bwd))
        if host:
            t.update(fwd_host_us=host_us(fwd), bwd_host_us=host_us(bwd))
        return t

    return tt_path(False, lambda: tt_bwd_path(False, times))


def time_per_sample():
    """3t: the per-sample kernels at PER_SAMPLE's shapes, f32 and f64:
    device time and call time beside the bound. It uses only what the
    parent commit's ops/tt_eval.py has too, so the same function times both
    trees (run it there and here in turns). Returns {shape: {dtype:
    times}}."""
    import torch

    out = {}
    for tag, ranks, I, B in PER_SAMPLE:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            cores, X, g = tt_problem(ranks, I, B, dtype, seed=12)
            t = _per_sample_times(cores, X, g, host=tag == "training")
            fwd_flops, bwd_flops = tt_work(cores, X)
            peak = PEAK_FP32 if dtype == torch.float32 else PEAK_FP64
            t["fwd_bound"], t["fwd_by"] = bound_ms(
                fwd_flops, nbytes(*cores, X) + B * dtype.itemsize, peak)
            t["bwd_bound"], t["bwd_by"] = bound_ms(
                bwd_flops, nbytes(*cores, X, g, *cores), peak)
            out.setdefault(tag, {})[dname] = t
            print(f"3t {tag:8s} {dname} ranks {max(ranks)} N={len(ranks) - 1} I={I} B={B}: "
                  f"tt_eval kernel {t['fwd_dev']:.4f} ms (call {t['fwd_call']:.4f}), bound "
                  f"{t['fwd_bound']:.5f} ({t['fwd_by']}); backward kernel {t['bwd_dev']:.4f} ms "
                  f"(call {t['bwd_call']:.4f}), bound {t['bwd_bound']:.5f} ({t['bwd_by']})"
                  + (f"; host per call, least and median: {t['fwd_host_us'][0]:.1f}, "
                     f"{t['fwd_host_us'][1]:.1f} / {t['bwd_host_us'][0]:.1f}, "
                     f"{t['bwd_host_us'][1]:.1f} us" if "fwd_host_us" in t else ""), flush=True)
    return out


# 3x's choices of `_per_sample_plan`, each forced both ways at the shapes
# that set it: (choice, tag, ranks, I, B, kernel, the forced plans)
PLAN_CHOICES = [
    ("staging", "P13", [1, 5, 5, 5, 1], 32, 1 << 20, "fwd", ({"staged": True}, {"staged": False})),
    ("staging", "config3", [1] + [4] * 9 + [1], 32, 10 ** 5, "fwd",
     ({"staged": True}, {"staged": False})),
    ("staging", "OPT4", [1, 8, 8, 1], 64, 20000, "fwd", ({"staged": True}, {"staged": False})),
    ("staging", "N2", [1, 16, 1], 128, 5000, "fwd", ({"staged": True}, {"staged": False})),
    ("privatizing", "P13", [1, 5, 5, 5, 1], 32, 1 << 20, "bwd",
     ({"private": True}, {"private": False})),
    ("privatizing", "P13 B=4096", [1, 5, 5, 5, 1], 32, 4096, "bwd",
     ({"private": True}, {"private": False})),
    ("privatizing", "OPT4", [1, 8, 8, 1], 64, 20000, "bwd",
     ({"private": True}, {"private": False})),
    ("privatizing", "config3", [1] + [4] * 9 + [1], 32, 10 ** 5, "bwd",
     ({"private": True}, {"private": False})),
    ("the forward's shared-memory interface", "ranks 64", [1, 64, 64, 1], 64, 4096, "fwd",
     ({},)),
    ("the forward's shared-memory interface", "ranks 100", [1, 100, 100, 1], 64, 4096, "fwd",
     ({},)),
    ("the shared-memory interface", "ranks 100", [1, 100, 100, 1], 64, 4096, "bwd",
     ({}, {"shared": True})),
    ("the lane width", "P13", [1, 5, 5, 5, 1], 32, 1 << 20, "fwd",
     ({}, {"W": 16}, {"W": 32})),
]


def plan_choices():
    """3x, off by default (``--only 3x``): each choice of the per-sample
    plan forced both ways at the shapes that set it, in turns (each plan,
    then the same in reverse), float32, device time by profiler: staging
    (`_STAGE_MIN`), privatizing (`_PRIV_MIN`), the backward's shared-memory
    interface against its register template, and the lane width; and the
    forward at ranks 64 and 100, where it keeps its interface in shared
    memory."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    for choice, tag, ranks, I, B, which, plans in PLAN_CHOICES:
        cores, X, g = tt_problem(ranks, I, B, torch.float32, seed=12)
        dims = [I] * (len(ranks) - 1)
        own = te._per_sample_plan(tuple(ranks), tuple(dims), B, 4)
        times = [[] for _ in plans]
        for i in list(range(len(plans))) + list(range(len(plans)))[::-1]:
            with forced_tt_plan(**plans[i]):
                if which == "fwd":
                    ms = tt_path(False, lambda: device_ms(
                        lambda: te.tt_eval_kernel(cores, X, True), "tt_eval_kernel"))[0]
                else:
                    ms = tt_bwd_path(False, lambda: device_ms(
                        lambda: te.tt_eval_backward_kernel(cores, X, g, True),
                        "tt_eval_backward_kernel"))[0]
            times[i].append(ms)
        print(f"3x {choice}, {tag} {which} (the plan: W={own.W} cols={own.fwd_cols}/"
              f"{own.bwd_cols} staged="
              f"{own.staged} private={''.join('1' if p else '0' for p in own.private)}): "
              + "; ".join(f"{p or 'as planned'} {min(t):.4f} ms" for p, t in zip(plans, times)),
              flush=True)


def check_per_sample():
    """3b's per-sample shapes (PER_SAMPLE), f32 and f64, on the wrapper's
    own plan: both kernels within KERNEL_TOL of their plain versions, the
    forward bitwise equal on two calls, an out-of-range coordinate raising;
    then the forced plans (3s) and the times (3t)."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    for tag, ranks, I, B in PER_SAMPLE:
        parts = []
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            cores, X, g = tt_problem(ranks, I, B, dtype, seed=12)
            dims = [I] * (len(ranks) - 1)
            plan = te._per_sample_plan(tuple(ranks), tuple(dims), B, dtype.itemsize)
            got, again, grads = tt_path(False, lambda: tt_bwd_path(False, lambda: (
                te.tt_eval_kernel(cores, X), te.tt_eval_kernel(cores, X),
                te.tt_eval_backward_kernel(cores, X, g))))
            want = plain_values(cores, X)
            want_grads = te.tt_eval_backward_plain(cores, X, g)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"per-sample tt_eval {dname} {tag}: two calls differ")
            rels = [_rel_all([got], [want]), _rel_all(grads, want_grads)]
            if not (all(bool(torch.isfinite(t).all()) for t in [got, *grads])
                    and max(rels) <= KERNEL_TOL[dname]):
                raise AssertionError(f"per-sample {dname} {tag} disagrees with its plain "
                                     f"versions: rel {rels}")
            tt_path(False, lambda: tt_bwd_path(False, lambda: hold_out_of_range(
                f"per-sample {dname} {tag}", cores, X, g)))
            parts.append(f"{dname} rel {rels[0]:.2e}/{rels[1]:.2e} (W={plan.W} cols="
                         f"{plan.fwd_cols}/{plan.bwd_cols} staged={plan.staged} private="
                         f"{''.join('1' if p else '0' for p in plan.private)})")
        print(f"per-sample {tag:8s} ranks {max(ranks)} N={len(ranks) - 1} I={I} B={B}: "
              + "; ".join(parts) + "; forward bitwise equal on two calls, out of range raises",
              flush=True)
    hold_per_sample_edges()
    hold_per_sample_plans()
    return time_per_sample()


def hold_per_sample_edges():
    """3b's edge cases of the per-sample kernels, f32 and f64: (1) a shape
    whose forward fits a block but whose backward's left interfaces do not
    (f64: N=120 at rank 250): the forward within KERNEL_TOL of its plain
    version and bitwise on two calls, the backward too, its left interfaces
    spilled to device memory in f64 (in f32 they fit a block at one warp);
    (2) an infinite core entry in the last
    column of a middle mode whose rank is not a multiple of the lane width
    (ranks 5, W=8), with gradients privatized (B=4096) and not (B=256): the
    kernels' infinite and NaN entries where the plain versions have them,
    the finite ones within KERNEL_TOL."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    parts = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype)[6:]
        cores, X, g = tt_problem([1] + [250] * 119 + [1], 2, 64, dtype, seed=13)
        got, again = tt_path(False, lambda: (te.tt_eval_kernel(cores, X),
                                             te.tt_eval_kernel(cores, X)))
        want = te.tt_eval_plain(cores, X)
        torch.cuda.synchronize()
        rel = _rel_all([got], [want])
        if not (torch.equal(got, again) and rel <= KERNEL_TOL[dname]):
            raise AssertionError(f"3b N=120 rank 250 {dname}: forward rel {rel:.2e}")
        spill = te._per_sample_plan(tuple(t.shape[0] for t in cores) + (1,), (2,) * 120, 64,
                                    dtype.itemsize).bwd_spill
        if spill != (dtype == torch.float64):
            raise AssertionError(f"3b N=120 rank 250 {dname}: the plan's spill is {spill}")
        grads = tt_bwd_path(False, lambda: te.tt_eval_backward_kernel(cores, X, g))
        brel = _rel_all(grads, te.tt_eval_backward_plain(cores, X, g))
        if not brel <= KERNEL_TOL[dname]:
            raise AssertionError(f"3b N=120 rank 250 {dname}: backward rel {brel:.2e}")
        parts.append(f"N=120 rank 250 {dname}: forward rel {rel:.1e}, backward {brel:.1e}"
                     f"{' (left interfaces spilled to device memory)' if spill else ''}")
        del cores
        for B in (256, 4096):
            cores, X, g = tt_problem([1, 5, 5, 5, 1], 4, B, dtype, seed=14)
            cores[1][2, 1, 4] = float("inf")
            got, grads = tt_path(False, lambda: tt_bwd_path(False, lambda: (
                te.tt_eval_kernel(cores, X), te.tt_eval_backward_kernel(cores, X, g))))
            want, want_grads = te.tt_eval_plain(cores, X), te.tt_eval_backward_plain(cores, X, g)
            for a, b in zip([got, *grads], [want, *want_grads]):
                finite, inf = torch.isfinite(b), torch.isinf(b)
                if not (torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a[inf], b[inf])
                        and (not finite.any()
                             or _rel_all([a[finite]], [b[finite]]) <= KERNEL_TOL[dname])):
                    raise AssertionError(f"3b an infinite entry, {dname} B={B}: the kernels' "
                                         "non-finite entries differ from the plain versions'")
            plan = te._per_sample_plan((1, 5, 5, 5, 1), (4,) * 4, B, dtype.itemsize)
            parts.append(f"inf {dname} B={B} (private "
                         f"{''.join('1' if p else '0' for p in plan.private)}): "
                         f"{int(sum(int((~torch.isfinite(d)).sum()) for d in grads))} "
                         "non-finite gradient entries, as the plain version")
    print("3b per-sample edges: " + "; ".join(parts), flush=True)


# Phase 3b's half-precision and long-chain instances of the per-sample
# kernels: each half type's unit roundoff; the chains past MAX_MODES, (tag,
# ranks, I, B, dtypes): 200 modes of rank 8, and 512 modes of rank 64 in
# float64, whose backward keeps its left interfaces in device memory
UNIT = {"bfloat16": 2.0**-8, "float16": 2.0**-11, "float32": 2.0**-24}
LONG_CHAINS = [("N200", [1] + [8] * 199 + [1], 2, 1 << 16, ("float32", "bfloat16")),
               ("N512", [1] + [64] * 511 + [1], 2, 1 << 16, ("float64",))]
# - bfloat16 training (phase 7's shape), kernels vs the plain versions, 20
#   losses: each loss is a bfloat16 mean (a relative step of 2^-7 near
#   1000), and an entry whose gradient's sign differs between the two
#   (float32 sums against bfloat16 ones) moves by Adam's 1e-3 the other way:
#   two steps of bfloat16
BF16_TRAIN_TOL = 2.0**-6


def plain_grads(cores, X, g):
    """``tt_eval_backward_plain`` summed over chunks of X whose gathered
    slices stay within 8 GiB (the float64 reference at 2^20 samples)."""
    from tntorch_tpu_torch.ops import tt_eval as te

    per = max(int(c.shape[0] * c.shape[2]) for c in cores) * cores[0].element_size()
    step = max(1, (8 << 30) // per)
    parts = [te.tt_eval_backward_plain(cores, X[i:i + step], g[i:i + step])
             for i in range(0, X.shape[0], step)]
    return [sum(ds) for ds in zip(*parts)]


def half_plain(cores, X, g, rounded=True):
    """The plain PyTorch version of the per-sample kernels' half-precision
    arithmetic (tests/test_torch_tt_eval_half.py: `_kernel_arithmetic`):
    products and sums in float32 inside a mode, each left and right
    interface rounded to the cores' dtype after its mode (not with
    ``rounded=False``, the chain a kernel that skipped those roundings would
    compute), the value rounded to it; the gradients' terms g_b L_k[b]
    (outer) Rt_{k+1}[b] summed in float32 and rounded once. float32 matmuls
    at full precision; chunks of samples keep each gathered slice within
    1 GiB. Returns (values, gradients) in the cores' dtype."""
    import torch

    td = cores[0].dtype
    cs = [c.float() for c in cores]
    B, N = X.shape
    dims = torch.tensor([c.shape[1] for c in cores], device=X.device)
    Xw = torch.where(X < 0, X + dims, X)

    def rnd(t):
        return t.to(td).float() if rounded else t

    def chunks(k):
        step = max(1, (1 << 28) // (cs[k].shape[0] * cs[k].shape[2]))
        return [slice(b, b + step) for b in range(0, B, step)]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lefts = [torch.ones((B, cs[0].shape[0]), device=X.device)]
        for k in range(N - 1):
            lefts.append(rnd(torch.cat([torch.einsum("br,rbs->bs", lefts[-1][p],
                                                     cs[k][:, Xw[p, k], :]) for p in chunks(k)])))
        values = torch.einsum("br,rb->b", lefts[-1], cs[-1][:, Xw[:, -1], 0]).to(td)
        gf = g.float()
        grads = [torch.zeros_like(c) for c in cs]
        right = torch.zeros((B, cs[-1].shape[-1]), device=X.device)
        right[:, 0] = 1
        for k in reversed(range(N)):
            parts = chunks(k)
            for p in parts:
                outer = (gf[p, None] * lefts[k][p])[:, :, None] * right[p, None, :]
                grads[k].index_add_(1, Xw[p, k], outer.permute(1, 0, 2))
            if k:  # Rt_{N-1} = C_{N-1}[:, x, 0] is a core's entries: rounding keeps it
                right = rnd(torch.cat([torch.einsum("rbs,bs->br", cs[k][:, Xw[p, k], :], right[p])
                                       for p in parts]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return values, [d.to(td) for d in grads]


# The half-precision checks (`hold_half`): each output (the values, or one
# core's gradient) of a kernel against `half_plain` on the same inputs, both
# measured against the float64 evaluation of those inputs: the kernel's
# error at most `half_plain`'s plus HALF_SLACK u max|ref| of that output
# alone; and at least HALF_AGREE of the output's entries bitwise equal to
# `half_plain`'s (the two sum in different orders, so a float32 sum near a
# rounding boundary of the half type may round the other way). A CPU model
# of a kernel that sums in another order (float64 sums rounded to float32)
# agreed on 0.974 or more of every output at PLAN_SHAPES, 32768 samples of
# 256^4 rank 64 and 200 modes of rank 8 in bfloat16; the chain without the
# roundings between modes on 0.632 or fewer where N >= 3 (at N <= 2 every
# interface is a core's entries, so there is nothing to round). Phase 3b
# shows such a chain, and a zeroed gradient, refused (`refuse_broken_half`).
HALF = ("bfloat16", "float16")
HALF_SLACK, HALF_AGREE = 2, 0.8


def hold_half(tag, got, want, ref, dname):
    """Holds a kernel's bfloat16/float16 outputs ``got`` (a list: the values,
    or one gradient a core) against `half_plain`'s ``want``, with ``ref``
    the float64 evaluation of the same rounded inputs, as HALF_SLACK and
    HALF_AGREE say, output by output. Raises AssertionError naming the
    output; returns the largest error over max|ref| of the kernel and of
    `half_plain`, and the least share of entries that agree."""
    import torch

    worst = [0.0, 0.0, 1.0]
    for k, (a, w, r) in enumerate(zip(got, want, ref)):
        name = f"{tag} output {k}"
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite output")
        scale = max(float(r.abs().max()), 1e-300)
        err = float((a.double() - r).abs().max())
        werr = float((w.double() - r).abs().max())
        touched = (a != 0) | (w != 0)
        agree = float((a == w)[touched].float().mean()) if bool(touched.any()) else 1.0
        if not (err <= werr + HALF_SLACK * UNIT[dname] * scale and agree >= HALF_AGREE):
            raise AssertionError(f"{name} disagrees with the plain version of the kernels' "
                                 f"arithmetic: error {err:.3e} against {werr:.3e} (max |value| "
                                 f"{scale:.3e}), {agree:.3f} of the entries equal")
        worst = [max(worst[0], err / scale), max(worst[1], werr / scale), min(worst[2], agree)]
    return worst


def refuse_broken_half(tag, grads, want, ref, cores, X, g, dname):
    """`hold_half` refuses what a broken kernel would give at this shape:
    the kernel's gradients with core 0's zeroed, and the values and
    gradients of the chain without the roundings between modes
    (`half_plain` with ``rounded=False``). Raises if either passes."""
    zeroed = [d.clone() for d in grads]
    zeroed[0].zero_()
    unrounded = half_plain(cores, X, g, rounded=False)
    for what, got, wants, refs in (("core 0's gradient zeroed", zeroed, want[1], ref[1]),
                                   ("the values without rounding", [unrounded[0]], [want[0]],
                                    [ref[0]]),
                                   ("the gradients without rounding", unrounded[1], want[1],
                                    ref[1])):
        try:
            hold_half(f"3b {tag} {what}", got, wants, refs, dname)
        except AssertionError as e:
            print(f"3b refused as it should be: {e}", flush=True)
        else:
            raise AssertionError(f"3b {tag}: the half check passed {what}")


def within_plain(tag, got, plain, ref, dname, factor):
    """The CPU tests' 130-mode tolerance (tests/test_torch_tt_eval_half.py):
    |got - ref| <= factor |plain - ref| + 2 u max|ref| over the lists, ref the plain
    version in float64 on the same rounded inputs; float64 within
    KERNEL_TOL of the plain version. Raises; returns the kernel's error and
    the plain version's."""
    import torch

    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError(f"{tag}: non-finite output")
    if dname == "float64":
        rel = _rel_all(got, plain)
        if not rel <= KERNEL_TOL[dname]:
            raise AssertionError(f"{tag} disagrees with its plain version: rel {rel:.3e}")
        return rel, 0.0
    err = max(float((a.double() - r).abs().max()) for a, r in zip(got, ref))
    perr = max(float((p.double() - r).abs().max()) for p, r in zip(plain, ref))
    scale = max(float(r.abs().max()) for r in ref)
    if not err <= factor * perr + 2 * UNIT[dname] * scale:
        raise AssertionError(f"{tag} disagrees with its plain version: error {err:.3e} against "
                             f"{perr:.3e} (max |value| {scale:.3e})")
    return err / scale, perr / scale


def _drive_counted(cores, X, g):
    """``tn.tt_eval`` and its gradient through autograd, the user's path,
    with the launch counts set to 0 before and read after: (values,
    gradients, {kernel: (launches, grouped)})."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    params = [c.clone().requires_grad_() for c in cores]
    te.reset_launches()
    values = tn.tt_eval(params, X)
    (g * values).sum().backward()
    torch.cuda.synchronize()
    counts = {k.__name__: (k.launches, k.grouped) for k in te.KERNELS}
    return values.detach(), [p.grad for p in params], counts


def check_half_and_long():
    """3b (``--only 3n`` alone): the per-sample kernels' half-precision and
    long-chain instances on the card: bfloat16 and float16 output by output
    against `half_plain`, the plain version of their arithmetic
    (`hold_half`); float32 against the plain versions to the CPU tests'
    130-mode tolerance (`within_plain`); float64 within KERNEL_TOL of them.
    (1) bfloat16 and float16 at the evaluation design shape through
    ``tn.tt_eval`` and autograd, counted (the grouped kernels refuse half
    cores: per sample, one launch each), timed beside the plain version and
    the bound, and the check shown to refuse a zeroed gradient and the chain
    without its roundings (`refuse_broken_half`); (2) ``tn.optimize`` at
    phase 7's shape in bfloat16, 20 steps, counted, its losses against the
    plain versions' (BF16_TRAIN_TOL); (3) LONG_CHAINS at 2^16 samples on
    the per-sample kernels, counted and timed (the 512-mode backward
    spills its left interfaces), the float32 and float64 chains also on the
    grouped kernels, forced, both routes timed in turns. Returns {kernel:
    {tag: numbers}}."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    start = time.perf_counter()
    out = {"tt_eval": {}, "tt_eval_backward": {}}

    def held(tag, dname, cores, X, g, peak, reps):
        """The user's path counted (forced per sample by the caller where
        the dispatch would group), the kernels against the plain versions
        and the float64 reference, then the kernels timed (`cuda_time`,
        warm, `reps` of one call) and the plain versions by CUDA events: a
        second, warm call each where ``reps`` > 1, else the first (the
        512-mode chain's plain backward takes seconds); records the numbers
        under ``tag`` and returns a line on them."""
        values, grads, counts = _drive_counted(cores, X, g)
        want = (1, 0)
        if counts != {"tt_eval_kernel": want, "tt_eval_backward_kernel": want}:
            raise AssertionError(f"3b {tag}: expected one per-sample launch of each kernel, "
                                 f"got {counts}")
        if not (values.dtype == cores[0].dtype and all(d.dtype == cores[0].dtype for d in grads)):
            raise AssertionError(f"3b {tag}: values or gradients left the cores' dtype")
        plain_f, pf = event_ms(lambda: te.tt_eval_plain(cores, X))
        plain_b, pb = event_ms(lambda: te.tt_eval_backward_plain(cores, X, g))
        if dname == "float64":
            ref = plain_f, plain_b
        else:
            rc = [c.double() for c in cores]
            ref = plain_values(rc, X), plain_grads(rc, X, g.double())
        if dname in HALF:
            want = half_plain(cores, X, g)
            errs = (hold_half(f"3b tt_eval {tag}", [values], [want[0]], [ref[0]], dname),
                    hold_half(f"3b tt_eval_backward {tag}", grads, want[1], ref[1], dname))
            if tag.startswith("design"):
                refuse_broken_half(tag, grads, want, ref, cores, X, g, dname)
            # the plain versions' own error, for the record (their backward sums in the half type)
            plain_errs = [max(float((p.double() - r).abs().max()) / float(r.abs().max())
                              for p, r in zip(ps, rs))
                          for ps, rs in (([plain_f], [ref[0]]), (plain_b, ref[1]))]
            errs = tuple((e[0], pe, e[2]) for e, pe in zip(errs, plain_errs))
            del want
        else:
            errs = (within_plain(f"3b tt_eval {tag}", [values], [plain_f], [ref[0]], dname, 1),
                    within_plain(f"3b tt_eval_backward {tag}", grads, plain_b, ref[1], dname, 2))
            errs = tuple((*e, None) for e in errs)
        del plain_f, plain_b, ref
        if reps > 1:
            pf = event_ms(lambda: te.tt_eval_plain(cores, X))[1]
            pb = event_ms(lambda: te.tt_eval_backward_plain(cores, X, g))[1]
        fwd = cuda_time(lambda: te.tt_eval_kernel(cores, X, True), reps=reps, inner=1)
        bwd = cuda_time(lambda: te.tt_eval_backward_kernel(cores, X, g, True), reps=reps, inner=1)
        fwd_flops, bwd_flops = tt_work(cores, X)
        fb = bound_ms(fwd_flops, nbytes(*cores, X, values), peak)
        bb = bound_ms(bwd_flops, nbytes(*cores, X, g, *grads), peak)
        for name, ms, plain_ms, bound, err in (("tt_eval", fwd, pf, fb, errs[0]),
                                               ("tt_eval_backward", bwd, pb, bb, errs[1])):
            out[name][tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                                  rel_err=err[0], plain_rel_err=err[1])
            if err[2] is not None:
                out[name][tag]["agree"] = err[2]
        agree = ("" if errs[0][2] is None else
                 f"; entries equal to the plain version of the kernels' arithmetic: values "
                 f"{errs[0][2]:.4f}, gradients (least over cores) {errs[1][2]:.4f}")
        return values, grads, (f"one launch each: error/max |value| {errs[0][0]:.2e} (plain {errs[0][1]:.2e}), "
                f"gradient (largest over cores, each over its own max |value|) {errs[1][0]:.2e} "
                f"(plain {errs[1][1]:.2e}){agree}; tt_eval {fwd:.4f} ms "
                f"(plain {pf:.3f}{'' if reps > 1 else ', its first call'}, bound {fb[0]:.5f} "
                f"{fb[1]}), backward {bwd:.4f} ms (plain {pb:.3f}, bound {bb[0]:.5f} {bb[1]})")

    E = EVAL
    design = [1] + [E["R"]] * (E["N"] - 1) + [1]
    for dname in ("bfloat16", "float16"):
        dtype = getattr(torch, dname)
        cores, X, g = tt_problem(design, E["I"], E["B"], dtype, seed=21)
        tag = f"design {dname}"
        line = held(tag, dname, cores, X, g, PEAK_FP32, 3)[2]
        print(f"3b {tag} N={E['N']} I={E['I']} R={E['R']} B={E['B']}, per sample: {line}",
              flush=True)
        del cores, X, g

    # (2) training in bfloat16 at phase 7's shape, counted, against the plain versions
    T = TRAIN
    steps = T["steps"]
    cores_np, X_np, y_np = train_data(T)
    X = torch.from_numpy(X_np).cuda()
    y = torch.from_numpy(y_np).to("cuda", torch.bfloat16)

    def fit():
        t = tn.Tensor([torch.from_numpy(c).to("cuda", torch.bfloat16) for c in cores_np],
                      requires_grad=True)
        return tn.optimize([t], lambda t: torch.mean((t[X].full() - y) ** 2), tol=None,
                           max_iter=steps - 1, verbose=False)

    te.reset_launches()
    hist = fit()
    torch.cuda.synchronize()
    counts = {k.__name__: (k.launches, k.grouped) for k in te.KERNELS}
    ref = plain_versions(fit)
    err = float(np.max(np.abs(np.array(hist) - np.array(ref)) / np.abs(np.array(ref))))
    print(f"3b training bfloat16 {T['I']}^{T['N']} rank {T['R']} B={T['B']}: {len(hist)} steps, "
          f"launches (calls, grouped) {counts}; loss {hist[0]:.2f} -> {hist[-1]:.2f}, kernels "
          f"against the plain versions: max rel {err:.3e} (tol {BF16_TRAIN_TOL})", flush=True)
    if counts != {"tt_eval_kernel": (steps, 0), "tt_eval_backward_kernel": (steps, 0)}:
        raise AssertionError("3b bfloat16 training: expected one per-sample launch of each "
                             "kernel a step")
    if not (np.isfinite(hist).all() and hist[-1] < hist[0] and err <= BF16_TRAIN_TOL):
        raise AssertionError("3b bfloat16 training: the loss did not fall, or it disagrees with "
                             "the plain versions")

    # (3) chains past MAX_MODES on the per-sample kernels
    for tag, ranks, I, B, dnames in LONG_CHAINS:
        for dname in dnames:
            dtype = getattr(torch, dname)
            cores, X, g = tt_problem(ranks, I, B, dtype, seed=22)
            dims = (I,) * (len(ranks) - 1)
            plan = te._per_sample_plan(tuple(ranks), dims, B, dtype.itemsize)
            peak = PEAK_FP64 if dname == "float64" else PEAK_FP32
            values, grads, line = tt_path(False, lambda: tt_bwd_path(False, lambda: held(
                f"{tag} {dname}", dname, cores, X, g, peak, 3 if tag == "N200" else 1)))
            routes = "/".join("grouped" if pick(ranks, dims, B, dtype.itemsize) else "per-sample"
                              for pick in (te._grouped, te._grouped_backward))
            print(f"3b {tag} {dname}: {len(ranks) - 1} modes I={I} ranks {max(ranks)} B={B}, "
                  f"forced per sample (the dispatch takes {routes}; plan W={plan.W} cols "
                  f"{plan.fwd_cols}/{plan.bwd_cols}, left interfaces "
                  f"{'spilled' if plan.bwd_spill else 'shared'}): {line}", flush=True)
            if dname != "bfloat16":  # the grouped route too, forced, timed in turns
                te.reset_launches()
                grouped = tt_path(True, lambda: te.tt_eval_kernel(cores, X))
                ggrads = tt_bwd_path(True, lambda: te.tt_eval_backward_kernel(cores, X, g))
                if (te.tt_eval_kernel.grouped, te.tt_eval_backward_kernel.grouped) != (1, 1):
                    raise AssertionError(f"3b {tag} {dname}: the grouped route was not taken")
                if dname == "float32":
                    rc = [c.double() for c in cores]
                    ref = plain_values(rc, X), plain_grads(rc, X, g.double())
                    plain = te.tt_eval_plain(cores, X), te.tt_eval_backward_plain(cores, X, g)
                    within_plain(f"3b grouped tt_eval {tag}", [grouped], [plain[0]], [ref[0]],
                                 dname, 1)
                    within_plain(f"3b grouped tt_eval_backward {tag}", ggrads, plain[1], ref[1],
                                 dname, 2)
                    held_as = "held to the same tolerance"
                else:  # against the per-sample kernels' outputs, just held to the plain versions
                    rel = _rel_all([grouped, *ggrads], [values, *grads])
                    if not rel <= KERNEL_TOL[dname]:
                        raise AssertionError(f"3b grouped {tag} {dname}: rel {rel:.3e} against "
                                             "the per-sample kernels")
                    held_as = f"within {rel:.1e} of the per-sample kernels"
                # in turns; the 512-mode per-sample calls (~1.2 s) are timed once, above
                turns = {p: [] for p in ("grouped", "per-sample")}
                for p in (("grouped", "per-sample", "per-sample", "grouped") if tag == "N200"
                          else ("grouped", "grouped")):
                    turns[p].append(tt_path(p == "grouped", lambda: tt_bwd_path(
                        p == "grouped", lambda: cuda_time(lambda: (
                            te.tt_eval_kernel(cores, X, True),
                            te.tt_eval_backward_kernel(cores, X, g, True)),
                            reps=3 if tag == "N200" else 1, inner=1))))
                if not turns["per-sample"]:
                    turns["per-sample"] = [sum(out[name][f"{tag} {dname}"]["ms"]
                                               for name in ("tt_eval", "tt_eval_backward"))]
                for name in ("tt_eval", "tt_eval_backward"):
                    out[name][f"{tag} {dname}"]["turns_fwd_bwd_ms"] = turns
                print(f"3b {tag} {dname} on the grouped kernels, forced: {held_as}; forward + "
                      f"backward, ms: grouped {turns['grouped']}, per-sample "
                      f"{turns['per-sample']}{' in turns' if tag == 'N200' else ''}", flush=True)
            del cores, X, g, values, grads
    print(f"3b half and long chains: {time.perf_counter() - start:.1f} s", flush=True)
    return out


def bench_cores(cfg=BENCH):
    """The bench cell's cores (bench.py): N=4, I=256, R=128, scaled by
    1/sqrt(R), stacked B times with 1% per-sample jitter, float32 (``cfg``
    another N, I, R, B)."""
    import numpy as np

    N, I, R, B = cfg["N"], cfg["I"], cfg["R"], cfg["B"]
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
    pair_sweep(t)
    return launches


def pair_sweep(t):
    """Phase 4's sweep on the ensemble in float64: its Gram edges at rank 128
    on float64's cluster instance against the two-stage kernel, in turns
    (parent-compatible: only the wrappers' routes are forced)."""
    import torch

    import tntorch_tpu_torch as tn

    rmax = BENCH["rmax"]
    t64 = tn.Tensor([c.double() for c in t.cores], batch=True)
    calls = []
    with recording_gram(calls):
        out = tn.round_tt(t64, rmax=rmax, algorithm="randgram")
    torch.cuda.synchronize()
    print("float64 sweep, Gram routes: " + "; ".join(
        f"{k.__name__} {tuple(a[1 if k.__name__ == 'proj2' else 0].shape)} ({gram_route(k, a)})"
        for k, a in calls))
    del calls
    ref = two_stage_gram(lambda: tn.round_tt(t64, rmax=rmax, algorithm="randgram"))
    dev = tn.relative_error(ref, out)
    print(f"float64 sweep against the two-stage route: rel err {dev.max().item():.3e} "
          f"(tol {MAIN_TOL})")
    if not (bool((dev <= MAIN_TOL).all()) and all(torch.isfinite(c).all() for c in out.cores)):
        raise AssertionError("the float64 sweep disagrees with its two-stage route")

    def sweep():
        tn.round_tt(t64, rmax=rmax, algorithm="randgram")

    variants = {"kernels": lambda fn: fn(), "kernels, two-stage gram_edge/wgram": two_stage_gram}
    runs = {v: [] for v in variants}
    for v in list(variants) + list(variants)[::-1]:
        runs[v].append(variants[v](lambda: cuda_time(sweep, reps=5, inner=3)))
    gain = min(runs["kernels, two-stage gram_edge/wgram"]) - min(runs["kernels"])
    print(f"float64 sweep time, B={BENCH['B']}, in turns: "
          + "; ".join(f"{v} {t} ms" for v, t in runs.items())
          + f"; the cluster instance's gain {gain:.3f} ms a sweep", flush=True)


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


def eval_data(cfg):
    """Phase 6's problem at ``cfg``'s N, I, R, B (NumPy): cores
    N(0, 1)/sqrt(R_k) in float32 and coordinates."""
    import numpy as np

    N, I, R, B = cfg["N"], cfg["I"], cfg["R"], cfg["B"]
    rng = np.random.default_rng(4)
    ranks = [1] + [R] * (N - 1) + [1]
    cores = [(rng.standard_normal((ranks[k], I, ranks[k + 1])) / np.sqrt(ranks[k]))
             .astype(np.float32) for k in range(N)]
    return cores, rng.integers(0, I, (B, N))


def eval_path():
    phase("6. evaluation path: tn.tt_eval and t[X].full(), N=4 I=1024 R=64 B=2^20 float32")
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    N, I, R, B = EVAL["N"], EVAL["I"], EVAL["R"], EVAL["B"]
    cores, X_np = eval_data(EVAL)
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


def train_data(cfg):
    """Phase 7's problem at ``cfg``'s N, I, R, B (NumPy, float32): uniform
    [0, 1) cores, as tn.rand draws them (benchmarks/bench_optimize.py),
    coordinates and normal targets."""
    import numpy as np

    N, I, R, B = cfg["N"], cfg["I"], cfg["R"], cfg["B"]
    rng = np.random.default_rng(5)
    ranks = [1] + [R] * (N - 1) + [1]
    cores = [rng.uniform(0, 1, (ranks[k], I, ranks[k + 1])).astype(np.float32) for k in range(N)]
    return cores, rng.integers(0, I, (B, N)), rng.standard_normal(B).astype(np.float32)


def train_path():
    T = TRAIN
    phase(f"7. training path: tn.optimize, {T['I']}^{T['N']} TT rank {T['R']}, "
          f"{T['B']} samples, Adam lr 1e-3, float32")
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    steps = T["steps"]
    cores, X_np, y_np = train_data(T)
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
    te.tt_eval_kernel = lambda cores, X, checked=False: te.tt_eval_plain(cores, X)
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


def rel(got, ref):
    """||got - ref|| / ||ref||, as a float."""
    import torch

    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def event_ms(fn):
    """(fn(), its time in ms by CUDA events): one call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def baseline_config1():
    phase("9a. BASELINE config 1: tn.randn(32, 32, 32, 32, ranks_tt=5), float64")
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    tn.set_policy("highest")
    t = tn.randn(32, 32, 32, 32, ranks_tt=5, dtype=torch.float64,
                 generator=torch.Generator(device="cuda").manual_seed(0))
    if t.device.type != "cuda":
        raise AssertionError(f"tn.randn landed on {t.device}")
    cpu = tn.Tensor([c.cpu() for c in t.cores])
    dense = t.full()
    X = torch.from_numpy(np.random.default_rng(9).integers(0, 32, (4096, 4)))
    checks = {
        "mean": (lambda t: t.mean(), lambda d: d.mean()),
        "sum": (lambda t: tn.sum(t), lambda d: d.sum()),
        "sum(dim=[1, 3])": (lambda t: tn.sum(t, dim=[1, 3]).full(), lambda d: d.sum(dim=(1, 3))),
        "var": (lambda t: t.var(), lambda d: d.var(correction=0)),
        "std": (lambda t: t.std(), lambda d: d.std(correction=0)),
        "norm": (lambda t: t.norm(), lambda d: torch.linalg.vector_norm(d)),
        "t[3, :, 5, 7:20]": (lambda t: t[3, :, 5, 7:20].full(), lambda d: d[3, :, 5, 7:20]),
        "t[X], 4096 coordinates": (lambda t: t[X.to(t.device)].full(),
                                   lambda d: d[tuple(X.to(d.device).T)]),
    }
    te.reset_launches()
    for name, (op, ref) in checks.items():
        got = op(t)
        err, err_cpu = rel(got, ref(dense)), rel(got.cpu(), op(cpu))
        print(f"{name}: rel err {err:.3e} against dense (tol {CONFIG1_TOL}), {err_cpu:.3e} "
              f"against the CPU (tol {CPU_TOL})")
        if not (err <= CONFIG1_TOL and err_cpu <= CPU_TOL):
            raise AssertionError(f"config 1: {name} disagrees")
    torch.cuda.synchronize()
    launches = {k.__name__.replace("_kernel", ""): k.launches for k in te.KERNELS}
    if launches["tt_eval"] != 1:
        raise AssertionError(f"t[X] launched tt_eval {launches['tt_eval']} times, not once")
    r, cold = event_ms(lambda: tn.round(t, eps=1e-6))
    r, ms = event_ms(lambda: tn.round(t, eps=1e-6))
    rc = tn.round(cpu, eps=1e-6)
    err, err_cpu = rel(r.full(), dense), rel(r.full().cpu(), rc.full())
    print(f"round(1e-6): ranks_tt {r.ranks_tt.tolist()}, ranks_tucker {r.ranks_tucker.tolist()}, "
          f"rel err {err:.3e} against dense, {err_cpu:.3e} against the CPU, {ms:.3f} ms "
          f"({cold:.3f} ms the first call)")
    if (r.ranks_tt.tolist() != rc.ranks_tt.tolist()
            or r.ranks_tucker.tolist() != rc.ranks_tucker.tolist()):
        raise AssertionError("config 1: round(1e-6) ranks differ between the card and the CPU")
    if not (err <= CONFIG1_TOL and err_cpu <= CPU_TOL):
        raise AssertionError("config 1: round(1e-6) disagrees")
    return launches


def baseline_config2():
    phase("9b. BASELINE config 2: TT-SVD + TT-Tucker of the 64^4 tensor 1/(i+j+k+l+1), "
          "float64")
    import torch

    import tntorch_tpu_torch as tn

    tn.set_policy("highest")
    i = torch.arange(64, device="cuda", dtype=torch.float64)
    x = 1 / (i[:, None, None, None] + i[None, :, None, None] + i[None, None, :, None]
             + i[None, None, None, :] + 1)
    xc = x.cpu()
    times = {}
    t, cold = event_ms(lambda: tn.Tensor(x, eps=CONFIG2_EPS))
    t, times["eps=1e-9"] = event_ms(lambda: tn.Tensor(x, eps=CONFIG2_EPS))
    ref = tn.Tensor(xc, eps=CONFIG2_EPS)
    err, err_cpu = rel(t.full(), x), rel(t.full().cpu(), ref.full())
    print(f"Tensor(x, eps=1e-9): ranks_tt {t.ranks_tt.tolist()}, ranks_tucker "
          f"{t.ranks_tucker.tolist()}, {t.numcoef()} coefficients (compression "
          f"{x.numel() / t.numcoef():.1f}x), rel err {err:.3e} against dense (tol {CONFIG2_EPS}), "
          f"{err_cpu:.3e} against the CPU (tol {DECOMP_TOL}); {times['eps=1e-9']:.3f} ms "
          f"({cold:.3f} ms the first call)")
    failed = []  # every variant prints its numbers; the phase then fails on any
    if (t.ranks_tt.tolist() != ref.ranks_tt.tolist()
            or t.ranks_tucker.tolist() != ref.ranks_tucker.tolist()):
        failed.append("eps=1e-9: ranks differ between the card and the CPU")
    if not (err <= CONFIG2_EPS and err_cpu <= DECOMP_TOL):
        failed.append("eps=1e-9: values disagree")
    r = 10
    variants = {
        "ranks_tt=10, ranks_tucker=10": dict(ranks_tt=r, ranks_tucker=r),
        "ranks_tt=10, 'gram'": dict(ranks_tt=r, algorithm="gram"),
        "ranks_tt=10, 'randomized'": dict(ranks_tt=r, algorithm="randomized"),
    }
    for name, kw in variants.items():
        ref = tn.Tensor(xc, **kw)
        ref_err = rel(ref.full(), xc)
        for dtype in (torch.float64, torch.float32) if "'" in name else (torch.float64,):
            xd = x.to(dtype)
            event_ms(lambda: tn.Tensor(xd, **kw))  # warm-up
            a, ms = event_ms(lambda: tn.Tensor(xd, **kw))
            key = f"{name}, {str(dtype)[6:]}"
            times[key] = ms
            full = a.full().double()
            err, err_cpu = rel(full, x), rel(full.cpu(), ref.full())
            print(f"{key}: ranks_tt {a.ranks_tt.tolist()}, ranks_tucker "
                  f"{a.ranks_tucker.tolist()}, rel err {err:.3e} against dense (CPU float64 "
                  f"{ref_err:.3e}), {err_cpu:.3e} against the CPU float64; {ms:.3f} ms")
            if a.ranks_tt.tolist() != ref.ranks_tt.tolist() or not torch.isfinite(full).all():
                failed.append(f"{key}: ranks differ from the CPU, or values not finite")
            if dtype == torch.float32:
                ok = err <= F32_DECOMP_TOL
            elif "randomized" in name:
                ok = err <= RAND_FACTOR * ref_err
            elif "gram" in name:
                ok = err_cpu <= GRAM_SHARE * ref_err
            else:
                ok = err_cpu <= DECOMP_TOL
            if not ok:
                failed.append(f"{key}: values disagree")
    print("config 2 times (ms, CUDA events): " + json.dumps(times))
    if failed:
        raise AssertionError("config 2: " + "; ".join(failed))


def tucker_ensemble():
    phase("9c. Tucker compression of the rounding ensemble: B=32 N=4 I=256, round_tt "
          "128->64 (randgram), then round_tucker(rmax=64), float32")
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import gram_kernels as gk

    tn.set_policy("high")
    t = tn.Tensor([torch.from_numpy(c) for c in bench_cores()], batch=True, device="cuda")
    gk.reset_launches()
    r = tn.round_tt(t, rmax=BENCH["rmax"], algorithm="randgram")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in gk.KERNELS}
    print(f"round_tt launches: {launches}")
    if launches != {"gram_edge": 2, "wgram": 2, "proj2": 2}:
        raise AssertionError(f"expected launches 2/2/2, got {launches}")
    u, cold = event_ms(lambda: tn.round_tucker(r, rmax=BENCH["rmax"]))
    if u.ranks_tucker.tolist() != [BENCH["rmax"]] * 4 or u.Us[0].device.type != "cuda":
        raise AssertionError(f"Tucker ranks {u.ranks_tucker.tolist()} on {u.Us[0].device}")
    if not all(torch.isfinite(x).all() for x in u.cores + u.Us):
        raise AssertionError("non-finite Tucker cores or factors")
    ms = cuda_time(lambda: tn.round_tucker(r, rmax=BENCH["rmax"]), reps=3, inner=1)
    host = [c[:2].double().cpu() for c in r.cores]
    ref = tn.round_tucker(tn.Tensor(host, batch=True), rmax=BENCH["rmax"])
    got = tn.Tensor([c[:2].double().cpu() for c in u.cores],
                    Us=[U[:2].double().cpu() for U in u.Us], batch=True)
    dev = tn.relative_error(ref, got)
    trunc = tn.relative_error(tn.Tensor(host, batch=True), ref)
    print(f"round_tucker(rmax=64), B={BENCH['B']}: {ms:.3f} ms ({cold:.3f} ms the first call); "
          f"Tucker ranks {u.ranks_tucker.tolist()}, {u.numcoef()} coefficients from "
          f"{r.numcoef()}; card f32 vs CPU f64, samples 0-1: rel err {dev.tolist()} "
          f"(tol {TUCKER_TOL}); Tucker truncation error {trunc.tolist()}")
    if not bool((dev <= TUCKER_TOL).all()):
        raise AssertionError("the Tucker stage disagrees with the CPU float64 run")
    return launches


def baseline_path():
    """Phase 9; returns each kernel's launches in it."""
    launches = baseline_config1()
    baseline_config2()
    launches.update(tucker_ensemble())
    return launches


def _sines(*xs):
    import torch

    return sum(torch.sin(x) for x in xs)


def _hilbert(*xs):
    return 1 / sum(xs)


def _axes(cfg):
    import numpy as np

    return [np.linspace(cfg["lo"], cfg["hi"], cfg["I"])] * cfg["N"]


def _cross(cfg, f, dtype, device=None, fuse=False, **kw):
    """``tn.cross`` of ``f`` on ``cfg``'s grid in ``dtype`` (torch's default
    dtype is what meshgrid casts the grid to), with the keywords ``kw``; its
    result, info and wall time in seconds, ending in a synchronize. The
    eager sweep unless ``fuse`` says otherwise (phase 18 runs the fused
    one)."""
    import torch

    import tntorch_tpu_torch as tn

    args = {k: cfg[k] for k in ("eps", "seed", "ranks_tt", "max_iter") if k in cfg}
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        if device is None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        t, info = tn.cross(function=f, domain=_axes(cfg), device=device, verbose=False,
                           return_info=True, suppress_warnings=True, fuse=fuse, **args, **kw)
        if device is None:
            torch.cuda.synchronize()
        return t, info, time.perf_counter() - t0
    finally:
        torch.set_default_dtype(prev)


def _held_out(cfg, n, device="cuda"):
    """``n`` random grid coordinates of ``cfg`` on ``device``."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(11).integers(0, cfg["I"], (n, cfg["N"]))).to(
        device)


def _inputs(cfg, dtype):
    """The cores of the input tensors a domain cross on ``cfg`` builds
    (``tn.meshgrid``), on the card in ``dtype``."""
    import tntorch_tpu_torch as tn

    return [[c.to(dtype) for c in t.cores] for t in tn.meshgrid(_axes(cfg), device="cuda")]


def plain_values(cores, X):
    """``tt_eval_plain(cores, X)`` in chunks of X whose gathered slices
    stay within 8 GiB (at 2^20 points a rank-129 float64 chain gathers 140
    GB); each value is computed as in one call."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    per = max(int(c.shape[0] * c.shape[2]) for c in cores) * cores[0].element_size()
    step = max(1, (8 << 30) // per)
    return torch.cat([te.tt_eval_plain(cores, X[i:i + step]) for i in range(0, X.shape[0], step)])


def hold_tt_eval(name, cases):
    """Each (tag, cores, X) of ``cases`` through the tt_eval kernel on both
    of its routes (the per-sample one alone below 3 modes), against the
    plain version on the same inputs, within KERNEL_TOL of max |plain|;
    prints the route that the cross path takes at each. The caller has
    read its launch counts: these launches are not the path's."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    failed, parts = [], []
    for tag, cores, X in cases:
        cores = [c.contiguous() for c in cores]  # as TTEval passes them
        dname = str(cores[0].dtype)[6:]
        want = plain_values(cores, X)
        ranks = [int(c.shape[0]) for c in cores] + [1]
        dims = [int(c.shape[1]) for c in cores]
        takes = ("grouped" if te._grouped(ranks, dims, X.shape[0], cores[0].element_size())
                 else "per-sample")
        rels = []
        # the grouped kernel takes N >= 3 modes
        for route in ("grouped", "per-sample")[0 if len(cores) >= 3 else 1:]:
            got = tt_path(route == "grouped", lambda: te.tt_eval_kernel(cores, X))
            rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)
            rels.append(f"{route} {rel:.2e}")
            if not bool(torch.isfinite(got).all()) or not rel <= KERNEL_TOL[dname]:
                failed.append(f"{tag} {dname} on the {route} kernel: rel {rel:.3e}")
        parts.append(f"{tag} {dname} ranks {max(ranks)} B={X.shape[0]} (the path takes {takes}): "
                     + ", ".join(rels))
    print(f"{name}, tt_eval kernel vs plain (tol {KERNEL_TOL}): " + "; ".join(parts))
    if failed:
        raise AssertionError(f"{name}: tt_eval disagrees with its plain version: "
                             + "; ".join(failed))


def cross_checks(name, cfg, f, exact):
    """Phase 10a/10b: a warm timed cross on the card in float32 and float64,
    each held to val_eps < eps and to a held-out error against ``exact``
    (float64 values of the function at (P, N) grid coordinates), the
    float64 run's rank schedule to the port's on the CPU, and the tt_eval
    kernel to its plain version at the shapes the run gave it. Returns its
    tt_eval launches."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    ref = _cross(cfg, f, torch.float64, device="cpu")[1]
    X = _held_out(cfg, HELD_OUT)
    X_val = _held_out(cfg, VAL_SIZE)
    want = exact(torch.tensor(_axes(cfg)[0], device="cuda"), X)
    launches, failed = 0, []
    for dtype, tol in ((torch.float32, CROSS_F32_TOL), (torch.float64, cfg["eps"])):
        te.reset_launches()
        _cross(cfg, f, dtype)  # warm-up
        t, info, sec = _cross(cfg, f, dtype)
        torch.cuda.synchronize()
        per_call = te.tt_eval_kernel.launches // 2
        got = t[X].full()
        torch.cuda.synchronize()
        launches += te.tt_eval_kernel.launches
        err = rel(got.double(), want)
        key = str(dtype)[6:]
        Rs = [int(r) for r in info["Rs"]]
        print(f"{name}, {key}: {len(info['val_epss'])} iterations, ranks {Rs}, "
              f"{info['nsamples']} f-evals, val_eps {info['val_eps']:.3e} (tol {cfg['eps']}), "
              f"held-out rel err at {HELD_OUT} points {err:.3e} (tol {tol}); "
              f"{sec * 1e3:.1f} ms, {info['nsamples'] / sec:.4g} f-evals/s; tt_eval launches "
              f"per cross {per_call}; on {t.device}, {t.dtype}")
        hold_tt_eval(f"{name}, {key}", [("inputs", _inputs(cfg, dtype)[0], X_val),
                                         ("approximation", t.cores, X_val),
                                         ("approximation", t.cores, X)])
        if t.device.type != "cuda" or t.dtype != dtype:
            failed.append(f"{key}: the result is on {t.device}, {t.dtype}")
        if not info["val_eps"] < cfg["eps"]:
            failed.append(f"{key}: val_eps {info['val_eps']:.3e} is not below {cfg['eps']}")
        if not err <= tol:
            failed.append(f"{key}: held-out error {err:.3e} above {tol}")
        if per_call != cfg["N"] + len(info["val_epss"]):
            failed.append(f"{key}: {per_call} tt_eval launches per cross, expected one per input "
                          "and one per iteration")
        if dtype == torch.float64:
            cpu = ([int(r) for r in ref["Rs"]], ref["nsamples"], len(ref["val_epss"]))
            print(f"{name}, the port on the CPU, float64: ranks {cpu[0]}, {cpu[1]} f-evals, "
                  f"{cpu[2]} iterations, val_eps {ref['val_eps']:.3e}")
            if (Rs, info["nsamples"], len(info["val_epss"])) != cpu:
                failed.append("float64: the rank schedule differs from the CPU's")
    if failed:
        raise AssertionError(f"{name}: " + "; ".join(failed))
    return launches


def hold_maxvol():
    """10c: `maxvol_device` alone at the throughput shape's 25600 x 100 (past
    the LU tournament's block), on an orthonormal matrix as the sweep gives
    it: in float64 the card's rows equal the port's on the CPU and C stays
    within MAXVOL_TOL of a fresh solve at those rows; in float32 it
    converges (max |C| <= 1.05) with C within MAXVOL_TOL of the float64
    solve at its rows."""
    import importlib

    import numpy as np
    import torch

    mv = importlib.import_module("tntorch_tpu_torch.maxvol")
    n, r = CROSS_FIXED["I"] * CROSS_FIXED["ranks_tt"], CROSS_FIXED["ranks_tt"]
    A = torch.linalg.qr(torch.from_numpy(np.random.default_rng(13).standard_normal((n, r))))[0]
    cpu_rows = mv.maxvol_device(A, 1.05, 1000)[0]
    Ad = A.cuda()
    failed, parts = [], []
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype)[6:]
        rows, C = mv.maxvol_device(Ad.to(dtype), 1.05, 1000)
        fresh = torch.linalg.solve(Ad[rows].T, Ad.T).T
        drift = float((C.double() - fresh).abs().max())
        top = float(C.abs().max())
        same = torch.equal(rows.cpu(), cpu_rows)
        parts.append(f"{dname}: rows {'equal to' if same else 'differ from'} the CPU's, max |C| "
                     f"{top:.6f}, C vs a float64 solve at its rows {drift:.2e} "
                     f"(tol {MAXVOL_TOL[dname]})")
        if dtype == torch.float64 and not same:
            failed.append("float64 rows differ from the CPU's")
        if not top <= 1.05 or not drift <= MAXVOL_TOL[dname]:
            failed.append(f"{dname}: max |C| {top:.6f}, drift {drift:.3e}")
    print(f"10c, maxvol_device at {n} x {r}: " + "; ".join(parts))
    if failed:
        raise AssertionError("10c maxvol_device: " + "; ".join(failed))


def counted_maxvol(run):
    """``run()`` with every `maxvol_device` call of the cross module counted
    and, under CUDA's sync debug mode, the host syncs inside those calls and
    outside them; returns (run's result, {calls, syncs inside, syncs
    outside, lu_rows and maxvol_swaps launches}, the places outside that
    synchronized)."""
    import importlib
    import warnings

    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    cr = importlib.import_module("tntorch_tpu_torch.cross")
    maxvol_device = cr.maxvol_device
    counts = {"calls": 0, "inside": 0}

    def counted(*args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = maxvol_device(*args, **kwargs)
        counts["inside"] += sum("synchroniz" in str(w.message) for w in caught)
        counts["calls"] += 1
        return out

    lu0, sw0 = mk.lu_rows.launches, mk.maxvol_swaps.launches
    torch.cuda.synchronize()
    cr.maxvol_device = counted
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        cr.maxvol_device = maxvol_device
    where = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    counts.update(outside=len(where), lu_rows=mk.lu_rows.launches - lu0,
                  maxvol_swaps=mk.maxvol_swaps.launches - sw0)
    return out, counts, where


def hold_maxvol_kernels(name, cases):
    """Each (tag, Q, max_iters) of ``cases`` (Q on the card, as a sweep gave
    it to `maxvol_device`) through both maxvol kernels against their plain
    versions on the same inputs: ``lu_rows`` on Q's LU pivots (every row of
    the permutation equal), then ``maxvol_swaps`` from those rows (rows
    equal, C within MAXVOL_TOL). The caller has read its launch counts.
    Returns the largest C difference per dtype."""
    import importlib

    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    mv = importlib.import_module("tntorch_tpu_torch.maxvol")
    failed, parts, worst = [], [], {}
    for tag, Q, iters in cases:
        n, r = Q.shape
        dname = str(Q.dtype)[6:]
        piv = mv._lu_pivots(Q)[None]
        rows = mk.lu_rows(piv, n, n)
        same_rows = torch.equal(rows.cpu(), mk.lu_rows_plain(piv, n, n).cpu())
        idx = rows[0, :r].contiguous()
        C = torch.linalg.solve_ex(Q[idx].T, Q.T)[0].T.contiguous()
        want_C, want_idx = mk.maxvol_swaps_plain(C.clone(), idx.clone(), 1.05, iters)
        got_C, got_idx = mk.maxvol_swaps(C.clone(), idx.clone(), 1.05, iters)
        torch.cuda.synchronize()
        err = float((got_C - want_C).abs().max())
        worst[dname] = max(worst.get(dname, 0.0), err)
        same_idx = torch.equal(got_idx, want_idx)
        route = "/".join(map(str, swap_route(n, r, Q.element_size())))
        parts.append(f"{tag} {dname} {n}x{r} ({route}): "
                     f"LU rows {'equal' if same_rows else 'DIFFER'}, swap rows "
                     f"{'equal' if same_idx else 'DIFFER'}, C {err:.1e}")
        if not (same_rows and same_idx and err <= MAXVOL_TOL[dname]):
            failed.append(f"{tag} {dname} {n}x{r}")
    print(f"{name}, maxvol kernels vs plain (C tol {MAXVOL_TOL}): " + "; ".join(parts))
    if failed:
        raise AssertionError(f"{name}: a maxvol kernel disagrees with its plain version: "
                             + "; ".join(failed))
    return worst


def cross_fixed():
    """Phase 10c: the fixed-rank throughput shape on the eager sweep in
    float32 (f-evals/s, val_eps and the held-out error within
    CROSS_FIXED_TOL, the tt_eval kernel against its plain version at the
    run's shapes), then a counted run: maxvol calls, their kernels'
    launches and the host syncs inside them (none) and outside (one an
    iteration); a float64 run against the port's on the CPU,
    `maxvol_device` alone at the shape, both maxvol kernels against their
    plain versions there, and a profile of one iteration by span."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    cfg = CROSS_FIXED
    te.reset_launches()
    _cross(cfg, _hilbert, torch.float32)  # warm-up
    launches = te.tt_eval_kernel.launches
    t, info, sec = _cross(cfg, _hilbert, torch.float32)
    per_call = te.tt_eval_kernel.launches - launches
    _, counts, where = counted_maxvol(lambda: _cross(cfg, _hilbert, torch.float32))
    X = _held_out(cfg, HELD_OUT)
    X_val = _held_out(cfg, VAL_SIZE)
    ax = torch.tensor(_axes(cfg)[0], device="cuda")
    err = rel(t[X].full().double(), 1 / ax[X].sum(1))
    iters = len(info["val_epss"])
    steps = (2 * cfg["N"] - 2) * iters
    print(f"10c: ranks {[int(r) for r in info['Rs']]}, {info['nsamples']} f-evals "
          f"({iters} iterations of at most {cfg['max_iter']}), val_eps {info['val_eps']:.3e}, "
          f"held-out rel err at {HELD_OUT} points {err:.3e} (tol {CROSS_FIXED_TOL} for both), "
          f"{sec * 1e3:.1f} ms, {info['nsamples'] / sec:.4g} f-evals/s; tt_eval launches "
          f"{per_call}; a counted run: {counts['calls']} maxvol calls ({steps} expected), "
          f"lu_rows {counts['lu_rows']} and maxvol_swaps {counts['maxvol_swaps']} launches, "
          f"{counts['inside']} host syncs inside maxvol_device (target 0), {counts['outside']} "
          f"outside (the grid's upload and one read an iteration: {where})")
    if t.device.type != "cuda" or per_call != cfg["N"] + iters:
        raise AssertionError(f"10c: the fixed-rank cross left the card or launched tt_eval "
                             f"{per_call} times")
    if not info["val_eps"] <= CROSS_FIXED_TOL or not err <= CROSS_FIXED_TOL:
        raise AssertionError(f"10c: val_eps {info['val_eps']:.3e} or held-out error {err:.3e} "
                             f"above {CROSS_FIXED_TOL}")
    if counts["inside"] or counts["calls"] != steps or not counts["lu_rows"] \
            or counts["maxvol_swaps"] != steps:
        raise AssertionError(f"10c: maxvol counts {counts}")
    # float64: one iteration reaches eps; the card's run against the CPU's
    t64, info64, sec64 = _cross(cfg, _hilbert, torch.float64)
    err64 = rel(t64[X].full(), 1 / ax.double()[X].sum(1))
    launches = te.tt_eval_kernel.launches
    cpu = _cross(cfg, _hilbert, torch.float64, device="cpu")[1]
    print(f"10c, float64: {len(info64['val_epss'])} iteration(s), {info64['nsamples']} f-evals, "
          f"val_eps {info64['val_eps']:.3e}, held-out rel err {err64:.3e} (tol "
          f"{CROSS_FIXED_F64_TOL}), {sec64 * 1e3:.1f} ms; the port on the CPU: "
          f"{len(cpu['val_epss'])} iteration(s), {cpu['nsamples']} f-evals, val_eps "
          f"{cpu['val_eps']:.3e}")
    if (len(info64["val_epss"]), info64["nsamples"]) != (len(cpu["val_epss"]), cpu["nsamples"]) \
            or not err64 <= CROSS_FIXED_F64_TOL:
        raise AssertionError("10c float64: iterations or samples differ from the CPU's, or the "
                             f"held-out error {err64:.3e} is above {CROSS_FIXED_F64_TOL}")
    hold_tt_eval("10c", [("inputs", _inputs(cfg, torch.float32)[0], X_val),
                         ("approximation", t.cores, X_val), ("approximation", t.cores, X),
                         ("approximation", t64.cores, X_val)])
    hold_maxvol()
    n, r = cfg["I"] * cfg["ranks_tt"], cfg["ranks_tt"]
    Q = torch.linalg.qr(torch.randn(n, r, dtype=torch.float64, device="cuda",
                                    generator=torch.Generator("cuda").manual_seed(13)))[0]
    hold_maxvol_kernels("10c", [("Q", Q, 100), ("Q", Q.float(), 100)])
    return launches + cross_profile("10c", dict(cfg, max_iter=1), _hilbert)


def cross_profile(name, cfg, f):
    """One float32 cross on ``cfg`` under torch.profiler (`profile_cross`).
    Returns its tt_eval launches."""
    import torch

    return profile_cross(name, lambda: _cross(cfg, f, torch.float32)[1:])


def profile_cross(name, run):
    """``run()`` (a cross: it returns its info and wall time in seconds)
    under torch.profiler: its wall time, the device's busy time and idle
    share, and the host and device time of each of the sweep's spans
    (fibers with f, QR, LU pivots, swaps, solves, interfaces, validation).
    Returns its tt_eval launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tntorch_tpu_torch.ops import tt_eval as te

    te.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        info, sec = run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("tn.")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("tn."):
            dev = getattr(e, "device_time_total", None)
            dev = e.cuda_time_total if dev is None else dev
            n, host, d = spans.get(e.name, (0, 0.0, 0.0))
            spans[e.name] = (n + 1, host + e.cpu_time_total / 1e3, d + dev / 1e3)
    wall = sec * 1e3
    print(f"{name}, {len(info['val_epss'])} iteration(s) profiled: wall {wall:.1f} ms, device "
          f"busy {busy:.1f} ms (idle share {max(0.0, 1 - busy / wall):.3f}); host gaps (wall - "
          f"device busy) {wall - busy:.1f} ms; by span (count, host ms, device ms):")
    for span, (n, host, d) in sorted(spans.items(), key=lambda x: -x[1][1]):
        print(f"  {span:22s} x{n:<4d} host {host:9.2f}  device {d:9.2f}")
    tt = sum(e.self_device_time_total for e in kernels if "tt_eval" in e.key) / 1e3
    # the maxvol kernels launch through ctypes, outside any torch op, so
    # the profiler gives their time to no span: it is read by kernel name
    mv = {k: (sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3,
              sum(e.count for e in kernels if k in e.key)) for k in ("lu_rows", "swaps_")}
    print(f"  maxvol kernels: lu_rows device {mv['lu_rows'][0]:.3f} ms x{mv['lu_rows'][1]}, "
          f"maxvol_swaps device {mv['swaps_'][0]:.3f} ms x{mv['swaps_'][1]}: "
          f"{(mv['lu_rows'][0] + mv['swaps_'][0]) / max(busy, 1e-9):.4f} of the device's busy time")
    print(f"  tt_eval kernels: device {tt:.3f} ms; top kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} {e.key[:80]}")
    return te.tt_eval_kernel.launches


def cross_path():
    """Phase 10; returns each kernel's launches in it."""
    import torch

    import tntorch_tpu_torch as tn

    tn.set_policy("highest")
    phase("10a. BASELINE config 3: tn.cross of a 10-D sum of sines on 32^10, eps=1e-6, "
          "seed=0, float32 and float64")
    launches = cross_checks("config 3", CROSS3, _sines, lambda ax, X: torch.sin(ax[X]).sum(1))
    launches += cross_profile("10a", CROSS3, _sines)
    phase("10b. the reference's tutorial cross: 1/sum(x) on 32^5, eps=1e-6, seed=7, float32 "
          "and float64")
    launches += cross_checks("5-D Hilbert", HILBERT5, _hilbert, lambda ax, X: 1 / ax[X].sum(1))
    phase("10c. fixed-rank throughput: 1/sum(x) on 256^5, ranks_tt=100, max_iter=2, seed=0, "
          "float32")
    launches += cross_fixed()
    return {"tt_eval": launches}


# Phase 11: the elementwise family, the minimizing cross and cross_forward.
# BASELINE config 1's size (benchmarks/bench_cross.py's neighbours in
# BASELINE.json: configs[0], a 32^4 TT of rank 5) for the family and the
# replay; the separable 5-D function of tests/test_cross.py:116-140 on 32^5
# and config 3's 10-D sum of sines for the minimizing cross.
CONFIG1 = dict(N=4, I=32, R=5)
SEPARABLE = dict(N=5, I=32, shifts=(0.3, -0.1, 0.0, 0.7, -0.5))
# ops whose domain is (-0.9, 0.9) (acos, asin, erfinv) or that a positive
# input would put across a pole (tan at pi/2): they take u - 0.5, u in [0, 1]
SYMMETRIC_OPS = ("acos", "asin", "erfinv", "tan")


def _dense_fns():
    """Each unary op of `tn.ops` as a torch function of dense values."""
    import torch

    return {
        "abs": torch.abs, "acos": torch.arccos, "asin": torch.arcsin, "atan": torch.arctan,
        "cos": torch.cos, "cosh": torch.cosh, "erf": torch.special.erf,
        "erfinv": torch.special.erfinv, "exp": torch.exp, "log": torch.log,
        "log10": torch.log10, "log2": torch.log2, "reciprocal": lambda x: 1 / x,
        "rsqrt": torch.rsqrt, "sigmoid": torch.sigmoid, "sin": torch.sin, "sinh": torch.sinh,
        "sqrt": torch.sqrt, "tan": torch.tan, "tanh": torch.tanh,
    }


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _config1(seed, dtype, device):
    """BASELINE config 1, ``tn.randn(32, 32, 32, 32, ranks_tt=5)``, drawn on
    the host from ``seed`` (the same numbers on every device)."""
    import torch

    import tntorch_tpu_torch as tn

    return tn.randn(*[CONFIG1["I"]] * CONFIG1["N"], ranks_tt=CONFIG1["R"],
                    generator=torch.Generator().manual_seed(seed), device=device, dtype=dtype)


def _unit_tt(seed, dtype, device):
    """Config 1's shape and rank, ``tn.rand`` (positive cores) drawn on the
    host from ``seed``, mapped affinely onto [0, 1] by its dense min and max
    (a TT of rank R + 1)."""
    import torch

    import tntorch_tpu_torch as tn

    gen = torch.Generator().manual_seed(seed)
    u = tn.rand(*[CONFIG1["I"]] * CONFIG1["N"], ranks_tt=CONFIG1["R"], generator=gen,
                device=device, dtype=dtype)
    x = u.full()
    lo, hi = x.min(), x.max()
    return (u - lo) * (1 / (hi - lo))


def family_checks(dtype, device="cuda"):
    """11a for one dtype: every name of ``tn.ops.__all__``, ``/``, ``**``,
    ``skew`` and ``kurtosis`` on config 1's size, each against the same
    function of the dense tensor (FAMILY_TOL, relative in norm; the
    moments, of config 1's own randn TT, relative to their value, kurtosis
    within KURTOSIS_TOL).
    Positive inputs are 1.5 + u (the JAX package's own test takes rand +
    1.5), the others u - 0.5. Returns the results' (name, cores) and the
    failures."""
    import torch

    import tntorch_tpu_torch as tn

    u, u2 = _unit_tt(0, dtype, device), _unit_tt(1, dtype, device)
    pos, pos2, sym = 1.5 + u, 1.5 + u2, u - 0.5
    x, y, z = (t.full().double() for t in (pos, pos2, sym))
    fns = _dense_fns()
    cases = [(name, (lambda n=name: getattr(tn, n)(sym if n in SYMMETRIC_OPS else pos)),
              fns[name](z if name in SYMMETRIC_OPS else x)) for name in fns]
    cases += [
        ("add", lambda: tn.add(pos, pos2), x + y),
        ("atan2", lambda: tn.atan2(sym, pos), torch.arctan2(z, x)),
        ("div", lambda: tn.div(pos, pos2), x / y),
        ("mul", lambda: tn.mul(pos, pos2), x * y),
        ("pow", lambda: tn.pow(pos, pos2), x ** y),
        ("t / t2", lambda: pos / pos2, x / y),
        ("2.0 / t", lambda: 2.0 / pos, 2.0 / x),
        ("t ** 2", lambda: pos ** 2, x ** 2),
        ("2.0 ** t", lambda: 2.0 ** pos, 2.0 ** x),
    ]
    for dim in (1, 3):
        cases += [(f"cumsum({dim})", lambda d=dim: tn.cumsum(pos, d), torch.cumsum(x, dim)),
                  (f"cumprod({dim})", lambda d=dim: tn.cumprod(pos, d), torch.cumprod(x, dim))]
    failed, outs, parts = [], [], []
    for name, compute, want in cases:
        t0 = time.perf_counter()
        out = compute()
        _sync(device)
        sec = time.perf_counter() - t0
        err = rel(out.full().double(), want)
        parts.append(f"{name} {err:.1e} (rank {max(int(r) for r in out.ranks_tt)}, "
                     f"{sec * 1e3:.0f} ms)")
        outs.append((name, out.cores))
        if out.device.type != torch.device(device).type or out.dtype != dtype \
                or not err <= FAMILY_TOL:
            failed.append(f"{name}: rel err {err:.3e} on {out.device}, {out.dtype}")
    w = _config1(0, dtype, device)
    xc = w.full().double()
    xc = xc - xc.mean()
    moments = {"skew": (tn.skew(w), (xc ** 3).mean() / xc.pow(2).mean() ** 1.5, FAMILY_TOL),
               "kurtosis": (tn.kurtosis(w), (xc ** 4).mean() / xc.pow(2).mean() ** 2 - 3,
                            KURTOSIS_TOL)}
    for name, (got, want, tol) in moments.items():
        err = abs(float(got) - float(want)) / abs(float(want))
        parts.append(f"{name} {float(got):.6g} vs dense {float(want):.6g}: {err:.1e} (tol {tol})")
        if not err <= tol:
            failed.append(f"{name}: rel err {err:.3e}")
    print(f"11a, {str(dtype)[6:]}, {len(cases) + 2} results against dense (tol {FAMILY_TOL}): "
          + "; ".join(parts))
    return outs, failed


def family_on_config3(device="cuda"):
    """11a: ``tn.exp`` and ``tn.sqrt`` of config 3's cross result t3 (the
    sqrt of t3 + 11, which is positive: |t3| <= 10), float64, at the
    held-out points against exp and sqrt of t3[X]. Returns (cases for
    hold_tt_eval, failures)."""
    import torch

    import tntorch_tpu_torch as tn

    t3 = _cross(CROSS3, _sines, torch.float64, device=device)[0]
    X = _held_out(CROSS3, HELD_OUT, device)
    base = t3[X].full()
    failed, parts, cases = [], [], []
    for name, out, want in (("exp", tn.exp(t3), torch.exp(base)),
                            ("sqrt(t + 11)", tn.sqrt(t3 + 11), torch.sqrt(base + 11))):
        err = rel(out[X].full(), want)
        parts.append(f"{name}: rank {max(int(r) for r in out.ranks_tt)}, held-out rel err "
                     f"{err:.2e}")
        cases.append((f"config 3 {name}", out.cores, X))
        if not err <= FAMILY_TOL:
            failed.append(f"config 3 {name}: held-out rel err {err:.3e}")
    print(f"11a, config 3's result (32^10) at {HELD_OUT} held-out points (tol {FAMILY_TOL}): "
          + "; ".join(parts))
    return cases, failed


def _separable_problem(device):
    """The separable 5-D function on 32^5: its input tensors, the
    function, the dense minimum and the grid."""
    import torch

    import tntorch_tpu_torch as tn

    grid = torch.linspace(-1, 1, SEPARABLE["I"], dtype=torch.float64)
    tensors = tn.meshgrid([grid] * SEPARABLE["N"], device=device)

    def f(*xs):
        return sum((x - s) ** 2 for x, s in zip(xs, SEPARABLE["shifts"]))

    dense_min = float(sum(((grid - s) ** 2).min() for s in SEPARABLE["shifts"]))
    return tensors, f, dense_min, grid


def minimize_checks(device="cuda"):
    """11b: the minimizing cross, float64. The separable function on 32^5
    (device path and record_samples host path) within MIN_OPT_TOL of the
    dense optimum, with its coordinates; config 1's randn TT (minimum,
    argmin, maximum, argmax) and config 3's sum of sines against the port
    on the CPU (MIN_CPU_TOL, argmins equal); the host reads per iteration;
    warm times. Returns (cases for hold_tt_eval, failures)."""
    import torch

    import tntorch_tpu_torch as tn

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # meshgrid's dtype
    try:
        failed, cases = [], []
        tensors, f, dense_min, grid = _separable_problem(device)
        tn.minimum(function=f, tensors=tensors, seed=0, fuse=False)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        m = tn.minimum(function=f, tensors=tensors, seed=0, fuse=False)
        _sync(device)
        sec5 = time.perf_counter() - t0
        am = tn.argmin(function=f, tensors=tensors, seed=0, fuse=False)
        _, info = tn.cross(function=f, tensors=tensors, rmax=10, max_iter=10, verbose=False,
                           seed=0, return_info=True, record_samples=True, _minimize=True)
        found = [float(f(*[grid[c] for c in a])) for a in (am, info["argmin"])]
        print(f"11b, separable 5-D on 32^5: minimum {m:.15g} (device path, {sec5 * 1e3:.1f} ms "
              f"warm), {info['min']:.15g} (record_samples host path, {info['nsamples']} samples "
              f"recorded), dense {dense_min:.15g}; f at the argmins {found} (tol {MIN_OPT_TOL})")
        if not all(abs(v - dense_min) <= MIN_OPT_TOL for v in [m, info["min"]] + found):
            failed.append("the separable optimum was missed")
        if len(info["sample_values"]) != info["nsamples"]:
            failed.append("record_samples kept another count than nsamples")
        cases.append(("separable input", [c for c in tensors[0].cores], _held_out(
            dict(N=SEPARABLE["N"], I=SEPARABLE["I"]), VAL_SIZE, device)))

        w = _config1(0, torch.float64, device)
        x = w.full()
        got = {name: getattr(tn, name)(w, seed=0, fuse=False)
               for name in ("minimum", "argmin", "maximum", "argmax")}
        cpu = {name: getattr(tn, name)(w.clone().to("cpu"), seed=0) for name in got}
        print(f"11b, config 1 randn 32^4 rank 5: minimum {got['minimum']:.15g} at "
              f"{got['argmin']} (CPU {cpu['minimum']:.15g} at {cpu['argmin']}; dense "
              f"{float(x.min()):.15g}), maximum {got['maximum']:.15g} at {got['argmax']} (CPU "
              f"{cpu['maximum']:.15g} at {cpu['argmax']}; dense {float(x.max()):.15g})")
        for name in ("minimum", "maximum"):
            if not abs(got[name] - cpu[name]) <= MIN_CPU_TOL * abs(cpu[name]):
                failed.append(f"config 1 {name} differs from the CPU's")
        for name in ("argmin", "argmax"):
            if got[name] != cpu[name]:
                failed.append(f"config 1 {name} differs from the CPU's")
        cases.append(("config 1 randn", w.cores, _held_out(
            dict(N=CONFIG1["N"], I=CONFIG1["I"]), VAL_SIZE, device)))

        sines = dict(function=_sines, domain=_axes(CROSS3), seed=CROSS3["seed"], fuse=False)
        tn.minimum(**sines, device=device)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        m3 = tn.minimum(**sines, device=device)
        _sync(device)
        sec10 = time.perf_counter() - t0
        m3_cpu = tn.minimum(**sines, device="cpu")
        dense3 = CROSS3["N"] * float(torch.sin(torch.tensor(_axes(CROSS3)[0])).min())
        print(f"11b, config 3 sum of sines on 32^10: minimum {m3:.15g} ({sec10 * 1e3:.1f} ms "
              f"warm; CPU {m3_cpu:.15g}; dense {dense3:.15g})")
        if not abs(m3 - m3_cpu) <= MIN_CPU_TOL * abs(m3_cpu):
            failed.append("config 3 minimum differs from the CPU's")
        if torch.device(device).type == "cuda":
            failed += host_reads(tensors, f)
        return cases, failed
    finally:
        torch.set_default_dtype(prev)


def host_reads(tensors, f):
    """11b: the host's synchronizing operations per iteration of the
    minimizing cross's eager sweep on 32^5, by CUDA's sync debug mode: two
    runs one iteration apart, both past the last rank increase (rmax 10
    from rank 1 by kickrank 3: iteration 4), so the difference is one
    iteration's. The target: one outside maxvol_device, none inside it (its
    LU rows and swap loop are kernels)."""
    import importlib
    import warnings

    import torch

    import tntorch_tpu_torch as tn

    cr = importlib.import_module("tntorch_tpu_torch.cross")
    maxvol_device = cr.maxvol_device
    inside = {"syncs": 0, "calls": 0}

    def counted(*args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = maxvol_device(*args, **kwargs)
        inside["syncs"] += sum("synchroniz" in str(w.message) for w in caught)
        inside["calls"] += 1
        return out

    runs = []
    cr.maxvol_device = counted
    torch.cuda.set_sync_debug_mode(1)
    try:
        for max_iter in (6, 7):
            inside.update(syncs=0, calls=0)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tn.minimum(function=f, tensors=tensors, seed=0, max_iter=max_iter, fuse=False)
            outside = sum("synchroniz" in str(w.message) for w in caught)
            runs.append((outside, inside["syncs"], inside["calls"]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
        cr.maxvol_device = maxvol_device
    outside, syncs, calls = (b - a for a, b in zip(*runs))
    print(f"11b, host syncs in one iteration of the minimizing cross's eager sweep on 32^5 "
          f"(runs of 6 and 7 iterations: {runs}): {outside} outside maxvol_device (target 1), "
          f"{calls} maxvol calls with {syncs} syncs (target 0)")
    return [] if (outside, syncs) == (1, 0) else [
        f"{outside} host syncs per iteration outside maxvol, {syncs} inside"]


def forward_checks(device="cuda"):
    """11c: ``cross_forward`` with autograd on config 1's size, float64: a
    cross of x**2 on a 32^4 rank-5 randn TT w, replayed by cross_forward
    from its info with w's cores as leaves; the forward within FORWARD_TOL
    of the cross's result, the gradient of normsq within GRAD_TOL
    (relative to its largest entry) of the same replay on the CPU, and the
    forward + backward's warm time. Returns (cases for hold_tt_eval,
    failures)."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch import interop

    w = _config1(2, torch.float64, device)
    t2, info = tn.cross(lambda x: x ** 2, tensors=[w], verbose=False, return_info=True, seed=0)

    def replay(dev, info):
        leaf = tn.Tensor([c.to(dev) for c in w.cores], requires_grad=True)
        out = tn.cross_forward(info, lambda x: x ** 2, tensors=[leaf])
        tn.normsq(out).backward()
        return out, [c.grad for c in leaf.cores]

    replay(device, info)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    out, grads = replay(device, info)
    _sync(device)
    sec = time.perf_counter() - t0
    _, grads_cpu = replay("cpu", interop.cross_info_from_arrays(info, device="cpu"))
    fwd = rel(out.full().detach(), t2.full())
    gerr = max(float((g.cpu() - gc).abs().max() / gc.abs().max())
               for g, gc in zip(grads, grads_cpu))
    print(f"11c, cross_forward of x**2 on a 32^4 rank-5 TT: ranks {[int(r) for r in info['Rs']]}, "
          f"forward vs the cross {fwd:.2e} (tol {FORWARD_TOL}), gradient of normsq vs the CPU "
          f"{gerr:.2e} (tol {GRAD_TOL}); forward + backward {sec * 1e3:.1f} ms warm")
    failed = []
    if not fwd <= FORWARD_TOL:
        failed.append(f"forward {fwd:.3e} from the cross")
    if not gerr <= GRAD_TOL:
        failed.append(f"gradient {gerr:.3e} from the CPU's")
    X = _held_out(dict(N=CONFIG1["N"], I=CONFIG1["I"]), VAL_SIZE, device)
    return [("cross_forward input", w.cores, X),
            ("cross_forward output", [c.detach() for c in out.cores], X)], failed


def exp_rate(device="cuda"):
    """11a's time: f-evals/s of a warm ``tn.exp`` on config 1's size
    (float32 and float64, seed 0), the wall ending in a synchronize."""
    import torch

    parts = []
    for dtype in (torch.float32, torch.float64):
        _exp_run(dtype, device)  # warm-up
        info, sec = _exp_run(dtype, device)
        parts.append(f"{str(dtype)[6:]} {info['nsamples']} f-evals in {sec * 1e3:.1f} ms, "
                     f"{info['nsamples'] / sec:.4g} f-evals/s, {len(info['val_epss'])} "
                     f"iterations, ranks {[int(r) for r in info['Rs']]}")
    print("11a, tn.exp on config 1's size, warm: " + "; ".join(parts))


def elementwise_path():
    """Phase 11; returns each kernel's launches in it."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    tn.set_policy("highest")
    phase("11a. the elementwise family on BASELINE config 1's size (32^4, rank 5), float32 and "
          "float64, and on config 3's cross result")
    te.reset_launches()
    failed, holds = [], []
    for dtype in (torch.float64, torch.float32):
        outs, bad = family_checks(dtype)
        failed += bad
        X_val = _held_out(dict(N=CONFIG1["N"], I=CONFIG1["I"]), VAL_SIZE)
        holds += [(f"11a {name}", cores, X_val) for name, cores in outs[::6]]
    cases, bad = family_on_config3()
    failed, holds = failed + bad, holds + cases
    exp_rate()
    phase("11b. the minimizing cross: separable 5-D on 32^5, config 1's randn, config 3's sines")
    cases, bad = minimize_checks()
    failed, holds = failed + bad, holds + cases
    phase("11c. cross_forward with autograd on config 1's size, float64")
    cases, bad = forward_checks()
    failed, holds = failed + bad, holds + cases
    torch.cuda.synchronize()
    launches = te.tt_eval_kernel.launches
    print(f"11, tt_eval launches: {launches}")
    hold_tt_eval("11", holds)
    launches += profile_cross("11a tn.exp, float32", lambda: _exp_run(torch.float32))
    if failed:
        raise AssertionError("phase 11: " + "; ".join(failed))
    return {"tt_eval": launches}


def _exp_run(dtype, device="cuda"):
    """A warm-started ``tn.exp`` on config 1's size: its info and wall time."""
    import tntorch_tpu_torch as tn

    pos = 1.5 + _unit_tt(0, dtype, device)
    _sync(device)
    t0 = time.perf_counter()
    _, info = tn.exp(pos, seed=0, return_info=True)
    _sync(device)
    return info, time.perf_counter() - t0


# Phase 12: BASELINE config 4 (tensor completion and regression: ALS and
# autodiff on sparse samples, exponential machines), at the repo's own
# sizes (bench.py:609-671, examples/exponential_machines.py,
# examples/classification.py, examples/pce.py, tests/test_interpolation.py)
ALS4 = dict(P=20000, N=4, I=32, R=3, niter=5)
OPT4 = dict(N=3, I=64, R=8, P=20000, gt_rank=4, steps=640, block=64)
EXPM = dict(N=10, P=2000, R=4, steps=2000, block=64, lr=1e-2)
LEARN = dict(steps=300, cpu_steps=10, regressor_P=1 << 16, regressor_N=4)
SPARSE_DENSE = dict(shape=(32, 32, 32, 32), R=3, slices=6)
SPARSE_TALL = dict(shape=(16384, 32, 32), R=4, slices=60, eps=1e-7, rmax=16)
PCE = dict(P=200, N=5, ticks=32, p=3)
# Tolerances of phase 12, each with its reason:
# - the same float64 computation on the card and on the CPU (ALS from one
#   x0 over 5 sweeps, dense reconstructions; the first 20 losses of a
#   gradient fit; the learners' losses over their steps): the two sum in
#   other orders, and each sweep's or step's roundoff is carried by the
#   next (Adam normalizes each gradient entry, so an entry near zero may
#   step either way); 1e-8, the limit the CPU tests hold the port to
#   against the JAX package (tests/test_torch_{interpolation,learners}.py).
# - sparse TT-SVD at its samples, float64: the planted tensors are exactly
#   rank 3 and 4 and every kept direction is resolved, 1e-7, the JAX
#   package's own limit (tests/test_interpolation.py:82).
# - LARS on the card against the NumPy oracle, PCE's predictions and
#   to_tensor against the CPU, the tools against the dense tensor on the
#   card, float64: 1e-10 (roundoff of a few hundred sums and a few
#   eigendecompositions).
# - convolve against scipy.signal.convolve: 1e-6, the JAX package's own
#   limit (tests/test_tools.py:131; three crosses at eps 1e-9).
# - sample: each empirical marginal within 5 standard deviations of the
#   PMF's, sqrt(p (1 - p) / P) each.
# - exponential machines: train R^2 above 0.9 (the example's model fits
#   the planted interactions; the CPU reaches ~0.997).
CPU4_TOL, SPARSE4_TOL, EXACT4_TOL, CONV4_TOL, R2_MIN = 1e-8, 1e-7, 1e-10, 1e-6, 0.9


@contextlib.contextmanager
def _default_dtype(name):
    """torch's default dtype set to ``torch.<name>`` for the block (or the
    function it decorates): what the port's ALS, sparse TT-SVD, PCE and
    learners cast their data to, as the JAX package casts to its own
    default."""
    import torch

    prev = torch.get_default_dtype()
    torch.set_default_dtype(getattr(torch, name))
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _cores(rng, shape, R, lo=0.0, hi=1.0):
    """Uniform [lo, hi) TT cores of rank R (as ``tn.rand`` draws them), as
    float64 NumPy arrays."""
    ranks = [1] + [R] * (len(shape) - 1) + [1]
    return [rng.uniform(lo, hi, (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _tensor(cores, dtype, device, **kw):
    import torch

    import tntorch_tpu_torch as tn

    return tn.Tensor([torch.from_numpy(c).to(device=device, dtype=dtype) for c in cores], **kw)


def _als_problem(A=ALS4):
    """12a's problem (or another size ``A``): the shape, the ground truth's
    and x0's cores, the sampled coordinates, and the generator that drew
    them."""
    import numpy as np

    rng = np.random.default_rng(1)
    shape = [A["I"]] * A["N"]
    gt_cores, x0_cores = _cores(rng, shape, A["R"]), _cores(rng, shape, A["R"])
    return shape, gt_cores, x0_cores, rng.integers(0, A["I"], (A["P"], A["N"])), rng


def als_checks(device="cuda"):
    """12a: ALS completion at bench.py's ``bench_als_completion`` shape (a
    32^4 rank-3 TT, 20,000 samples, every slice sampled, 5 sweeps) in
    float64 and float32 from one x0: the training eps, the error at 10^5
    held-out points against the ground truth, samples/s (P * niter over the
    call's wall), the float64 run's dense reconstruction against the port on
    the CPU from the same x0. Returns (cases for hold_tt_eval, failures)."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    A = ALS4
    shape, gt_cores, x0_cores, X, rng = _als_problem()
    Xh = torch.from_numpy(rng.integers(0, A["I"], (HELD_OUT, A["N"]))).to(device)
    failed, cases, dense = [], [], {}
    if any(len(np.unique(X[:, n])) != A["I"] for n in range(A["N"])):
        failed.append("a slice of the ALS problem is not sampled")
    gt = _tensor(gt_cores, torch.float64, device)
    y = gt[X].full()  # the samples, on the evaluation kernel
    want = gt[Xh].full()

    def run(dtype, dev, niter):
        x0 = _tensor(x0_cores, dtype, dev)
        with _default_dtype(str(dtype)[6:]):  # what als_completion casts y to
            _sync(dev)
            t0 = time.perf_counter()
            t, eps = tn.als_completion(X, y.to(dev), ranks_tt=A["R"], shape=shape, x0=x0,
                                       niter=niter, verbose=False, _return_eps=True)
            _sync(dev)
        return t, eps, time.perf_counter() - t0

    for dtype in (torch.float64, torch.float32):
        run(dtype, device, 1)  # warm-up: the dtype's first solves load their kernels
        t, eps, sec = run(dtype, device, A["niter"])
        got = t[Xh].full()
        err = rel(got.double(), want)
        key = str(dtype)[6:]
        dense[key] = t.full()
        cases += [(f"12a ALS {key}, held-out", t.cores, Xh)]
        print(f"12a ALS completion {key}: 32^4 rank {A['R']}, {A['P']} samples, {A['niter']} "
              f"sweeps in {sec * 1e3:.1f} ms, {A['P'] * A['niter'] / sec:.4g} samples/s; training "
              f"eps {eps:.3e}, held-out rel err at {HELD_OUT} points {err:.3e}; on {t.device}")
        if t.device.type != torch.device(device).type or not np.isfinite([eps, err]).all():
            failed.append(f"ALS {key}: not finite, or off the device")
    cpu = run(torch.float64, "cpu", A["niter"])[0].full()
    err = rel(dense["float64"].cpu(), cpu)
    print(f"12a ALS float64, dense reconstruction vs the port on the CPU from the same x0: rel "
          f"{err:.3e} (tol {CPU4_TOL})")
    if not err <= CPU4_TOL:
        failed.append(f"ALS float64 is {err:.3e} from the CPU's")
    return cases, failed


def _fit(cores, X, y, steps, block, lr, dtype, device, tol=None):
    """``tn.optimize`` (Adam) of a TT from ``cores`` on mean((t[X] - y)^2):
    the tensor, its losses and the wall time in seconds."""
    import torch

    import tntorch_tpu_torch as tn

    t = _tensor(cores, dtype, device, requires_grad=True)
    Xd = torch.from_numpy(X).to(device)
    yd = torch.from_numpy(y).to(device, dtype)
    _sync(device)
    t0 = time.perf_counter()
    hist = tn.optimize([t], lambda t: torch.mean((t[Xd].full() - yd) ** 2), tol=tol,
                       max_iter=steps - 1, block_iters=block, verbose=False,
                       optimizer=lambda ps: torch.optim.Adam(ps, lr=lr))
    _sync(device)
    return t, hist, time.perf_counter() - t0


def _check_fit(name, t, hist, sec, ref, failed):
    import numpy as np

    err = float(np.max(np.abs(np.array(hist[:len(ref)]) - ref) / np.abs(ref)))
    print(f"{name}: {len(hist)} steps in {sec * 1e3:.1f} ms, {len(hist) / sec:.1f} iters/s; loss "
          f"{hist[0]:.6g} -> {hist[-1]:.6g}; first {len(ref)} losses vs the port on the CPU, "
          f"float64: max rel {err:.3e} (tol {CPU4_TOL}); on {t.device}")
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        failed.append(f"{name}: the loss did not fall")
    if not err <= CPU4_TOL:
        failed.append(f"{name}: the losses are {err:.3e} from the CPU's")


def gradient_checks(device="cuda"):
    """12b: gradient completion by ``tn.optimize`` at bench.py's
    ``bench_optimize`` shape (64^3, rank 8, 20,000 samples of a rank-4
    ground truth, Adam lr 1e-3, 640 steps, block_iters 64) and exponential
    machines at examples/exponential_machines.py's size (10 binary
    features, 2000 samples, rank 4, cores x 0.3, Adam lr 1e-2, block_iters
    64, up to 2000 steps, tol 1e-7), float64: a falling loss, the first 20
    losses against the port on the CPU, iters/s, the machine's train R^2
    and its launches. Returns (cases, failures, the machine's problem)."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    failed, cases = [], []
    O = OPT4
    rng = np.random.default_rng(0)
    shape = [O["I"]] * O["N"]
    gt = _tensor(_cores(rng, shape, O["gt_rank"]), torch.float64, "cpu")
    X = rng.integers(0, O["I"], (O["P"], O["N"]))
    y = gt[X].full().numpy()
    init = _cores(rng, shape, O["R"])
    _, ref, _ = _fit(init, X, y, 20, 1, 1e-3, torch.float64, "cpu")
    t, hist, sec = _fit(init, X, y, O["steps"], O["block"], 1e-3, torch.float64, device)
    _check_fit(f"12b optimize, 64^3 rank {O['R']}, {O['P']} samples, float64", t, hist, sec, ref,
               failed)
    cases.append(("12b optimize 64^3", [c.detach() for c in t.cores],
                  torch.from_numpy(X).to(device)))
    t32, hist32, sec32 = _fit(init, X, y, O["steps"], O["block"], 1e-3, torch.float32, device)
    print(f"12b optimize, the same in float32: {len(hist32)} steps in {sec32 * 1e3:.1f} ms, "
          f"{len(hist32) / sec32:.1f} iters/s; loss {hist32[0]:.6g} -> {hist32[-1]:.6g}")
    if not (np.isfinite(hist32).all() and hist32[-1] < hist32[0]):
        failed.append("12b optimize float32: the loss did not fall")

    machine = _machine()
    Xb, yb, w0 = machine
    _, ref, _ = _fit(w0, Xb, yb, 20, 1, EXPM["lr"], torch.float64, "cpu")
    launches = [k.launches for k in te.KERNELS]
    w, hist, sec = _fit(w0, Xb, yb, EXPM["steps"], EXPM["block"], EXPM["lr"], torch.float64,
                        device, tol=1e-7)
    launched = [k.launches - n for k, n in zip(te.KERNELS, launches)]
    _check_fit("12b exponential machines, 2^10 weights rank 4, float64", w, hist, sec, ref, failed)
    with torch.no_grad():
        pred = w[torch.from_numpy(Xb).to(device)].full().cpu().numpy()
    r2 = 1 - float(((pred - yb) ** 2).sum() / ((yb - yb.mean()) ** 2).sum())
    print(f"12b exponential machines: train R^2 {r2:.6f} (above {R2_MIN}); launches (forward, "
          f"backward) {launched} for {len(hist)} steps")
    if not r2 > R2_MIN:
        failed.append(f"exponential machines: train R^2 {r2:.4f}")
    if torch.device(device).type == "cuda" and launched != [len(hist), len(hist)]:
        failed.append(f"exponential machines: launches {launched}, expected one forward and one "
                      f"backward a step")
    cases.append(("12b exponential machines", [c.detach() for c in w.cores],
                  torch.from_numpy(Xb).to(device)))
    return cases, failed


def _machine():
    """examples/exponential_machines.py's problem: binary features, planted
    interactions, noise; its initial cores (uniform x 0.3)."""
    import numpy as np

    rng = np.random.default_rng(0)
    N, P = EXPM["N"], EXPM["P"]
    Xb = rng.integers(0, 2, (P, N))
    y = (1.5 * Xb[:, 0] - 2.0 * Xb[:, 1] + 0.8 * Xb[:, 2] * Xb[:, 3]
         - 1.2 * Xb[:, 1] * Xb[:, 4] * Xb[:, 5] + 0.1 * rng.standard_normal(P))
    return Xb, y, [0.3 * c for c in _cores(rng, [2] * N, EXPM["R"])]


def _spiral_data():
    """examples/classification.py's Swiss roll: two spirals of 100 points,
    permuted; the first 75% train, the rest test."""
    import numpy as np

    rng = np.random.default_rng(0)
    r = rng.uniform(2, 10, 100)[:, None]
    c0 = np.concatenate([r * np.cos(r), r * np.sin(r)], axis=1)
    c0 += rng.standard_normal(c0.shape) / 1.5
    X = np.concatenate([c0, -c0])
    y = np.concatenate([np.zeros(100), np.ones(100)])
    idx = rng.permutation(len(X))
    return X[idx], y[idx], int(len(X) * 0.75)


def _smooth_data(P=LEARN["regressor_P"]):
    """A smooth function of 4 features on [-1, 1]^4, 2^16 (or ``P``)
    samples."""
    import numpy as np

    rng = np.random.default_rng(2)
    X = rng.uniform(-1, 1, (P, LEARN["regressor_N"]))
    return X, np.sin(2 * X[:, 0]) * np.cos(X[:, 1]) + X[:, 2] * X[:, 3] ** 2


@_default_dtype("float64")
def learner_checks(device="cuda"):
    """12c: `TTClassifier` on the Swiss roll (nticks 128, ranks_tt 10,
    ranks_tucker 6, the default Adam lr 1e-3; single and 4 bagged members)
    and `TTRegressor` on a smooth 4-feature function at 2^16 samples
    (nticks 64, ranks_tt 10, ranks_tucker 8 (DCT) and None (a plain TT: the
    evaluation kernels), Adam lr 1e-2), LEARN['steps'] steps each, float64,
    timed. Each is held to the same fit on the CPU (an int key: the same
    initial tensor and rows): losses within CPU4_TOL and the test score
    within CPU4_TOL, over all its steps for the classifiers and over the
    first LEARN['cpu_steps'] for the regressors (a fit of 2^16 samples
    costs the CPU 0.1-0.5 s a step). Returns (cases, failures)."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    failed, cases = [], []
    Xs, ys, ntrain = _spiral_data()
    Xr, yr = _smooth_data()
    adam2 = dict(optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2))
    steps, short = LEARN["steps"], LEARN["cpu_steps"]
    runs = [
        ("TTClassifier single", tn.TTClassifier, dict(nticks=128, ranks_tt=10, ranks_tucker=6),
         steps, Xs[:ntrain], ys[:ntrain], Xs[ntrain:], ys[ntrain:]),
        ("TTClassifier 4 bagged", tn.TTClassifier,
         dict(nticks=128, ranks_tt=10, ranks_tucker=6, n_estimators=4),
         steps, Xs[:ntrain], ys[:ntrain], Xs[ntrain:], ys[ntrain:]),
        ("TTRegressor DCT", tn.TTRegressor, dict(nticks=64, ranks_tt=10, ranks_tucker=8, **adam2),
         short, Xr, yr, Xr[::64], yr[::64]),
        ("TTRegressor plain TT", tn.TTRegressor,
         dict(nticks=64, ranks_tt=10, ranks_tucker=None, **adam2), short, Xr, yr, Xr[::64],
         yr[::64]),
    ]

    def fit(cls, kw, n, dev, X, y, Xt, yt):
        learner = cls(key=0, device=dev, max_iter=n - 1, tol=0.0, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        learner.fit(X, y)
        _sync(dev)
        return learner, time.perf_counter() - t0, learner.score(Xt, yt)

    for name, cls, kw, n_cpu, X, y, Xt, yt in runs:
        lrn, sec, score = fit(cls, kw, steps, device, X, y, Xt, yt)
        held = lrn if n_cpu == steps else fit(cls, kw, n_cpu, device, X, y, Xt, yt)[0]
        ref = fit(cls, kw, n_cpu, "cpu", X, y, Xt, yt)[0]
        err = float(np.max(np.abs(np.array(held.losses_) - ref.losses_)
                           / np.abs(ref.losses_)))
        s_err = abs(held.score(Xt, yt) - ref.score(Xt, yt))
        metric = "accuracy" if "Class" in name else "R^2"
        print(f"12c {name}: {len(lrn.losses_)} steps, fit {sec * 1e3:.1f} ms "
              f"({len(lrn.losses_) / sec:.1f} iters/s), loss {lrn.losses_[0]:.5g} -> "
              f"{lrn.losses_[-1]:.5g}, test {metric} {score:.6f}; over {n_cpu} steps vs the "
              f"CPU: losses max rel {err:.3e}, {metric} {s_err:.1e} apart (tol {CPU4_TOL}); "
              f"on {lrn.tensor_.device}")
        if not (err <= CPU4_TOL and s_err <= CPU4_TOL and lrn.losses_[-1] < lrn.losses_[0]):
            failed.append(f"12c {name}: off the CPU's run, or the loss did not fall")
        if kw["ranks_tucker"] is None:
            cases.append((f"12c {name}", [c.detach() for c in lrn.tensor_.cores],
                          lrn._indices(X)))
    return cases, failed


def _sliced(shape, R, slices, seed):
    """Complete slices (along mode 0) of a planted rank-R TT: unique
    coordinates whose zero-filled tensor keeps rank R."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cores = _cores(rng, shape, R)
    S = np.sort(rng.choice(shape[0], slices, replace=False))
    rest = np.stack(np.meshgrid(*[np.arange(s) for s in shape[1:]], indexing="ij"),
                    axis=-1).reshape(-1, len(shape) - 1)
    X = np.concatenate([np.repeat(S, len(rest))[:, None], np.tile(rest, (slices, 1))], axis=1)
    return cores, X


@_default_dtype("float64")
def sparse_checks(device="cuda"):
    """12d: sparse TT-SVD on its dense path (complete slices of a planted
    rank-3 32^4 TT, 196,608 unique samples) and its sketched path
    (tests/test_interpolation.py's tall 16384 x 32 x 32 rank-4 case at full
    size, 61,440 samples), float64: ranks as on the CPU and the error at
    the samples; `lars_path` on the card against the NumPy oracle; the
    PCE surrogate at examples/pce.py's size (fit, predict, to_tensor)
    against the CPU. Returns (cases, failures)."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch import interpolation as interp

    failed, cases = [], []
    for name, cfg, kw in (("dense path", SPARSE_DENSE, dict(eps=1e-10)),
                          ("sketched path", SPARSE_TALL,
                           dict(eps=SPARSE_TALL["eps"], rmax=SPARSE_TALL["rmax"]))):
        cores, X = _sliced(cfg["shape"], cfg["R"], cfg["slices"], seed=3)
        gt = _tensor(cores, torch.float64, device)
        Xd = torch.from_numpy(X).to(device)
        y = gt[Xd].full()
        ranks = {}
        for dev in (device, "cpu"):
            _sync(dev)
            t0 = time.perf_counter()
            t = tn.sparse_tt_svd(X, y.to(dev), shape=cfg["shape"], **kw)
            _sync(dev)
            ranks[dev] = ([int(r) for r in t.ranks_tt], time.perf_counter() - t0, t)
        (Rs, sec, t), cpu_Rs = ranks[device], ranks["cpu"][0]
        err = rel(t[Xd].full(), y)
        print(f"12d sparse TT-SVD, {name}: shape {list(cfg['shape'])}, {len(X)} samples, ranks "
              f"{Rs} (CPU {cpu_Rs}) in {sec * 1e3:.1f} ms; rel err at the samples {err:.3e} "
              f"(tol {SPARSE4_TOL}); on {t.device}")
        if Rs != cpu_Rs or max(Rs) > cfg["R"] or not err <= SPARSE4_TOL:
            failed.append(f"12d sparse TT-SVD {name}: ranks {Rs} (CPU {cpu_Rs}), err {err:.3e}")
        cases.append((f"12d sparse TT-SVD {name}", t.cores, Xd))

    rng = np.random.default_rng(5)
    A = rng.standard_normal((400, 60))
    beta = np.zeros(60)
    beta[rng.choice(60, 8, replace=False)] = rng.standard_normal(8)
    b = A @ beta + 0.05 * rng.standard_normal(400)
    _sync(device)
    t0 = time.perf_counter()
    path = tn.lars_path(torch.from_numpy(A).to(device), torch.from_numpy(b).to(device))
    sec = time.perf_counter() - t0
    host = interp._lars_path_host(A, b)
    err = (float(np.abs(path - host).max() / np.abs(host).max()) if path.shape == host.shape
           else float("inf"))
    print(f"12d lars_path on the card, 400 x 60: {path.shape[1] - 1} steps in {sec * 1e3:.1f} ms; "
          f"vs the NumPy oracle: max rel {err:.3e} (tol {EXACT4_TOL})")
    if not err <= EXACT4_TOL:
        failed.append(f"12d lars_path is {err:.3e} from the oracle")

    rng = np.random.default_rng(0)
    X = rng.integers(0, PCE["ticks"], (PCE["P"], PCE["N"])).astype(np.float64)
    y = (X ** 2) @ rng.uniform(size=PCE["N"])
    y += rng.standard_normal(PCE["P"]) * y.std() / 10
    Xt = rng.uniform(0, PCE["ticks"] - 1, (1000, PCE["N"]))
    out = {}
    for dev in (device, "cpu"):
        pce = tn.PCEInterpolator(device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        pce.fit(X, y, p=PCE["p"], verbose=False)
        pred = pce.predict(Xt)
        t = pce.to_tensor(domain=64, eps=1e-6, verbose=False)
        _sync(dev)
        idx = rng.integers(0, 64, (1000, PCE["N"])) if dev == device else idx
        out[dev] = (pce, pred.cpu(), t, t[idx].full().cpu(), time.perf_counter() - t0)
    (pce, pred, t, vals, sec), (cpce, cpred, ct, cvals, _) = out[device], out["cpu"]
    e_pred, e_tt = rel(pred, cpred), rel(vals, cvals)
    fit_err = float(np.linalg.norm(out[device][0].predict(X).cpu().numpy() - y)
                    / np.linalg.norm(y))
    print(f"12d PCE, P={PCE['P']} N={PCE['N']} p={PCE['p']}: {len(pce.coef)} terms (CPU "
          f"{len(cpce.coef)}), training rel err {fit_err:.3e}; fit + predict + to_tensor "
          f"{sec * 1e3:.1f} ms; to_tensor ranks {[int(r) for r in t.ranks_tt]} (CPU "
          f"{[int(r) for r in ct.ranks_tt]}); vs the CPU: predict {e_pred:.3e}, to_tensor at "
          f"1000 grid points {e_tt:.3e} (tol {EXACT4_TOL})")
    if (not np.array_equal(pce.coords, cpce.coords) or not e_pred <= EXACT4_TOL
            or not e_tt <= EXACT4_TOL or list(t.ranks_tt) != list(ct.ranks_tt)):
        failed.append("12d PCE differs from the CPU's")
    return cases, failed


def tools_checks(device="cuda"):
    """12e: the tools on BASELINE config 1's size (``tn.randn(32, 32, 32,
    32, ranks_tt=5)``, float64), each against the dense tensor on the card
    (EXACT4_TOL): cat, transpose, the partial dot, flip, unbind, pad, mask,
    reduce (64 rank-5 TTs, eps 1e-10), shift_mode (eps 1e-12 against the
    permuted tensor; 'same' against the CPU), hash (the TT, its round_tt(1e-14)
    and a Tucker form), sample (10^6 points of a rand TT: marginals within
    5 sigma), convolve (64 x 64 rank 4 with 8 x 8, the three modes, against
    scipy), generate_basis (every name, equal to the CPU's). Returns
    failures."""
    import operator

    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    failed, errs = [], {}
    t = _config1(0, torch.float64, device)
    t2 = _config1(1, torch.float64, device)
    x, x2 = t.full(), t2.full()
    checks = {
        "cat": (lambda: tn.cat([t, t2], dim=1), lambda: torch.cat([x, x2], dim=1)),
        "transpose": (lambda: tn.transpose(t), lambda: x.permute(3, 2, 1, 0)),
        "partial dot": (lambda: tn.dot(t, t2, k=2), lambda: torch.einsum("abcd,abef->dcef", x, x2)),
        "flip": (lambda: tn.flip(t, [0, 2]), lambda: torch.flip(x, [0, 2])),
        "unbind": (lambda: tn.unbind(t, 3)[7], lambda: x[..., 7]),
        "pad": (lambda: tn.pad(t, 40, dim=1), lambda: torch.cat([x, 0 * x[:, :8]], dim=1)),
    }
    keep = torch.zeros(32, dtype=torch.float64, device=device)
    keep[::3] = 1
    m = tn.Tensor([keep[None, :, None], *[torch.ones((1, 32, 1), dtype=torch.float64,
                                                     device=device)] * 3])
    checks["mask"] = (lambda: tn.mask(t, m), lambda: x * keep[:, None, None, None])
    ts = [_config1(10 + i, torch.float64, device) for i in range(64)]
    checks["reduce"] = (lambda: tn.reduce(ts, operator.add, eps=1e-10),
                        lambda: sum(s.full() for s in ts))
    checks["shift_mode 1e-12"] = (lambda: tn.shift_mode(t.clone(), 0, 2, eps=1e-12),
                                  lambda: x.permute(1, 2, 0, 3))
    for name, (fn, dense) in checks.items():
        _sync(device)
        t0 = time.perf_counter()
        got = fn()
        _sync(device)
        sec = time.perf_counter() - t0
        errs[name] = (rel(got.full(), dense()), sec * 1e3)
    same = tn.shift_mode(t.clone(), 0, 2, eps="same")
    same_cpu = tn.shift_mode(_config1(0, torch.float64, "cpu"), 0, 2, eps="same")
    errs["shift_mode same vs CPU"] = (rel(same.full().cpu(), same_cpu.full()), 0.0)
    tucker = t.clone()
    tucker.round_tucker(eps=1e-14)
    rounded = tn.round_tt(t, eps=1e-14)
    h = [float(tn.hash(s)) for s in (t, rounded, tucker)]
    errs["hash"] = (max(abs(v - h[0]) for v in h) / abs(h[0]), 0.0)
    print("12e tools on config 1's size vs dense on the card (rel err, ms): " + "; ".join(
        f"{k} {e:.2e} ({ms:.1f})" for k, (e, ms) in errs.items()) + f" (tol {EXACT4_TOL}); "
        f"hash {h[0]:.15g}, Tucker ranks {[int(r) for r in tucker.ranks_tucker]}")
    failed += [f"12e {k}: {e:.3e}" for k, (e, _) in errs.items() if not e <= EXACT4_TOL]

    u = tn.rand(*[CONFIG1["I"]] * CONFIG1["N"], ranks_tt=CONFIG1["R"], device=device,
                dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    P = 10 ** 6
    _sync(device)
    t0 = time.perf_counter()
    Xs = tn.sample(u, P=P, seed=0)
    _sync(device)
    sec = time.perf_counter() - t0
    dense = u.full()
    worst = 0.0
    for n in range(CONFIG1["N"]):
        p = dense.sum(dim=[d for d in range(CONFIG1["N"]) if d != n]) / dense.sum()
        emp = torch.bincount(Xs[:, n], minlength=CONFIG1["I"]).double() / P
        worst = max(worst, float(((emp - p).abs() / torch.sqrt(p * (1 - p) / P)).max()))
    print(f"12e sample: {P} points in {sec * 1e3:.1f} ms on {Xs.device}; worst marginal "
          f"deviation {worst:.2f} sigma (limit 5)")
    if not worst <= 5 or Xs.device.type != torch.device(device).type:
        failed.append(f"12e sample: a marginal {worst:.2f} sigma off")

    from scipy.signal import convolve as spconv

    g = torch.Generator().manual_seed(3)
    a = tn.rand([64, 64], ranks_tt=4, dtype=torch.float64, device=device, generator=g)
    b = tn.rand([8, 8], ranks_tt=4, dtype=torch.float64, device=device, generator=g)
    parts = []
    for mode in ("full", "same", "valid"):
        _sync(device)
        t0 = time.perf_counter()
        c = tn.convolve(a, b, mode=mode, eps=1e-9, verbose=False, seed=0)
        _sync(device)
        want = spconv(a.numpy(), b.numpy(), mode=mode)
        err = float(np.linalg.norm(c.numpy() - want) / np.linalg.norm(want))
        parts.append(f"{mode} {tuple(c.shape)} {err:.2e} ({(time.perf_counter() - t0) * 1e3:.1f}"
                     " ms)")
        if tuple(c.shape) != want.shape or not err <= CONV4_TOL:
            failed.append(f"12e convolve {mode}: {err:.3e}")
    print(f"12e convolve 64x64 rank 4 by 8x8 vs scipy.signal.convolve: " + "; ".join(parts)
          + f" (tol {CONV4_TOL})")
    for name in ("dct", "legendre", "chebyshev", "hermite", "identity"):
        got = tn.generate_basis(name, (64, 8), dtype=torch.float64, device=device)
        if not torch.equal(got.cpu(), tn.generate_basis(name, (64, 8), dtype=torch.float64,
                                                        device="cpu")):
            failed.append(f"12e generate_basis {name} differs from the CPU's")
    return failed


def config4_path():
    """Phase 12; returns each kernel's launches in it."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import tt_eval as te

    tn.set_policy("highest")
    te.reset_launches()
    phase("12a. BASELINE config 4: ALS completion, 32^4 rank 3, 20,000 samples")
    holds, failed = als_checks()
    phase("12b. gradient completion and exponential machines (tn.optimize)")
    cases, bad = gradient_checks()
    holds, failed = holds + cases, failed + bad
    phase("12c. the learners: TTClassifier on the Swiss roll, TTRegressor at 2^16 samples")
    cases, bad = learner_checks()
    holds, failed = holds + cases, failed + bad
    phase("12d. sparse TT-SVD (dense and sketched paths), LARS, PCE")
    cases, bad = sparse_checks()
    holds, failed = holds + cases, failed + bad
    phase("12e. the tools on BASELINE config 1's size")
    failed += tools_checks()
    print("profile, one block of 64 exponential-machines steps (float64):")
    Xb, yb, w0 = _machine()
    profile_device(lambda: _fit(w0, Xb, yb, EXPM["block"], EXPM["block"], EXPM["lr"],
                                torch.float64, "cuda"), steps=EXPM["block"])
    print("profile, one ALS sweep (32^4 rank 3, 20,000 samples, float64):")
    shape, gt_cores, x0_cores, X, _ = _als_problem()
    y = _tensor(gt_cores, torch.float64, "cuda")[X].full()
    with _default_dtype("float64"):
        profile_device(lambda: tn.als_completion(X, y, ranks_tt=ALS4["R"], shape=shape, niter=1,
                                                 x0=_tensor(x0_cores, torch.float64, "cuda"),
                                                 verbose=False), steps=1)
    torch.cuda.synchronize()
    launches = {"tt_eval": te.tt_eval_kernel.launches,
                "tt_eval_backward": te.tt_eval_backward_kernel.launches}
    print(f"12, launches (forward, backward): {launches}")
    if not all(launches.values()):
        failed.append(f"a kernel of the path was not launched: {launches}")
    hold_tt_eval("12", holds)
    if failed:
        raise AssertionError("phase 12: " + "; ".join(failed))
    return launches


# Phase 13: CP tensors and BASELINE config 5 (ANOVA/Sobol on a 20-D
# surrogate and batched 3-D vector-field calculus), at full size.
# - CP-ALS of benchmarks/bench_cp_als.py's 128^3 analytic field at rank 3
#   (BASELINE.md row 10); the tensor ops at config 1's size (32^4, CP rank
#   and TT rank 5); t[X] at 2^20 coordinates
CP13 = dict(I=128, R=3, ops_I=32, ops_N=4, ops_R=5, points=1 << 20)
# - the 20-D Sobol g-function of examples/sobol_indices.py on a grid of 32,
#   and a randn TT of that shape at rank 10
SOBOL13 = dict(N=20, I=32, R=10)
# - B potentials on I^3 at TT rank R, their divergence rounded back to rmax
#   (two fields checked densely: the first and the last)
FIELDS13 = dict(B=32, I=256, R=16, rmax=16, chunk=8)
# - a 4096 x 4096 operator in the (8, 8, 8, 8) layout, a sum of R
#   Kronecker products, applied to a batch of TT vectors
OPERATOR13 = dict(dims=(8, 8, 8, 8), R=4, vectors=16, vector_rank=4)
# Tolerances of phase 13, each with its reason:
# - float64 on the card against the port on the CPU, or against a closed
#   form computed in float64 (CP-ALS reconstructions, Sobol indices,
#   derivatives, the operators' products): the same sums in other orders,
#   1e-10 relative (the CPU tests hold the port to the JAX package at 1e-10
#   for these, tests/test_torch_{anova,derivatives,matrix}.py).
# - CP and CP+TT tensor ops against the dense tensor on the card, float64:
#   contractions of a few hundred terms, 1e-12.
# - CP-ALS against the data: the reference notebook's error class, within
#   twice its 9.9e-4 (decompositions.ipynb cell 10; the port on the CPU
#   reaches 9.3e-4 in float64 and 1.2e-3 in float32).
# - tn.exp of a CP tensor by cross against dense: FAMILY_TOL (phase 11).
# - div grad phi - laplacian phi and curl grad phi: the central differences
#   commute exactly in this representation (each mode's core is differenced
#   on its own), so both vanish to roundoff: 1e-10 relative to the
#   Laplacian and to the first term of each curl component.
# - the divergence rounded by 'gram' on the card against the CPU: the Gram
#   method squares the condition number, so the two libraries' rank-16
#   subspaces may differ by more than roundoff; held within GRAM_SHARE of
#   the truncation error, as phase 9 holds TT-SVD. Float32 'randgram': its
#   truncation error within RANDGRAM_FACTOR of float64 'gram''s (randomized
#   edges are quasi-optimal: the port on the CPU gives 1.20x at B=4, 16^3,
#   rank 4, and the card 1.00x at the full size).
# - CPMatrix of an operator of exact CP rank R: its fit within 1e-3 (CP-ALS
#   stops once a sweep gains less than tol = 1e-4; the port on the CPU
#   reaches 2.6e-7 in 4 sweeps at this size).
CP_REF_ERR, CP_ERR_FACTOR, CP13_TOL, OPS13_TOL, ROUNDOFF13 = 9.9e-4, 2.0, 1e-10, 1e-12, 1e-10
RANDGRAM_FACTOR, CPFIT13_TOL = 1.5, 1e-3


def _cp_field(I):
    """benchmarks/bench_cp_als.py's analytic field on I^3, float64 NumPy."""
    import numpy as np

    X, Y, Z = np.meshgrid(range(I), range(I), range(I))
    return np.sqrt(np.sqrt(X) * (Y + Z) + Y * Z ** 2) * (X + np.sin(Y) * np.cos(Z))


@contextlib.contextmanager
def _counted_sweeps():
    """Counts the CP-ALS sweeps run in the block (the port's
    `tensor._cp_als_iter`, wrapped): yields the list that collects them."""
    import importlib

    ttensor = importlib.import_module("tntorch_tpu_torch.tensor")
    real, sweeps = ttensor._cp_als_iter, []

    def counted(*args, **kwargs):
        sweeps.append(1)
        return real(*args, **kwargs)

    ttensor._cp_als_iter = counted
    try:
        yield sweeps
    finally:
        ttensor._cp_als_iter = real


def _timed(fn, device):
    """(fn(), its wall in ms) after one warm-up call, synchronized."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def cp_checks(device="cuda", cfg=CP13):
    """13a: CP-ALS of the 128^3 field at rank 3 (float64, float32: warm
    wall, sweeps, error to the data; float64 against the CPU), ``randn``
    with ``ranks_cp`` at 32^4, CP + TT arithmetic, ``dot``, ``full`` and
    slicing against dense, ``t[X]`` at 2^20 coordinates, ``tn.exp`` by
    cross. Returns (cases for hold_tt_eval, failures)."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    failed, cases = [], []
    data = torch.from_numpy(_cp_field(cfg["I"]))
    R = cfg["R"]
    dense = {}
    with _counted_sweeps() as sweeps:
        for dtype in (torch.float64, torch.float32):
            x = data.to(device, dtype)
            sweeps.clear()
            t, ms = _timed(lambda: tn.Tensor(x, ranks_cp=R), device)
            n = len(sweeps) // 2  # _timed calls twice
            err = rel(t.full().double(), data.to(device))
            key = str(dtype)[6:]
            dense[key] = t.full().double()
            print(f"13a CP-ALS {key}, {cfg['I']}^3 rank {R}: warm wall {ms:.2f} ms, {n} sweeps, "
                  f"rel err to the data {err:.4e} (the reference notebook: 9.9e-4); "
                  f"ranks {t.ranks_tt.tolist()} on {t.device}")
            if not err <= CP_ERR_FACTOR * CP_REF_ERR or t.device.type != torch.device(device).type:
                failed.append(f"CP-ALS {key}: rel err {err:.3e} on {t.device}")
        cpu = tn.Tensor(data, ranks_cp=R).full()
    err = rel(dense["float64"].cpu(), cpu)
    print(f"13a CP-ALS float64 vs the port on the CPU: rel {err:.3e} (tol {CP13_TOL})")
    if not err <= CP13_TOL:
        failed.append(f"CP-ALS float64 is {err:.3e} from the CPU's")

    N, I, r = cfg["ops_N"], cfg["ops_I"], cfg["ops_R"]
    gen = torch.Generator().manual_seed(13)  # drawn on the host: the same numbers anywhere
    cp, ms = _timed(lambda: tn.randn(*[I] * N, ranks_cp=r, generator=gen.manual_seed(13),
                                     device=device, dtype=torch.float64), device)
    tt = tn.randn(*[I] * N, ranks_tt=r, generator=gen.manual_seed(0), device=device,
                  dtype=torch.float64)  # config 1 at full size
    cp_cpu = tn.randn(*[I] * N, ranks_cp=r, generator=gen.manual_seed(13), device="cpu",
                      dtype=torch.float64)
    xc, xt = cp.full(), tt.full()
    own = torch.einsum("ir,jr,kr,lr->ijkl", *cp.cores) if N == 4 else xc
    checks = {"randn(ranks_cp) vs the CPU's": (xc.cpu(), cp_cpu.full()),
              "full vs its factors' einsum": (xc, own),
              "cp + tt": ((cp + tt).full(), xc + xt), "cp * tt": ((cp * tt).full(), xc * xt),
              "cp - 2 cp": ((cp - 2 * cp).full(), -xc),
              "dot(cp, tt)": (tn.dot(cp, tt), (xc * xt).sum()),
              "norm(cp)": (tn.norm(cp), torch.linalg.vector_norm(xc)),
              "cp[3, :, 5:20, ::2]": (cp[3, :, 5:20, ::2].full(), xc[3, :, 5:20, ::2]),
              "(cp + tt)[..., 7]": ((cp + tt)[..., 7].full(), (xc + xt)[..., 7])}
    parts = []
    for name, (got, want) in checks.items():
        err = rel(got.reshape(-1), want.reshape(-1))
        parts.append(f"{name} {err:.1e}")
        if not err <= OPS13_TOL:
            failed.append(f"13a {name}: rel {err:.3e}")
    print(f"13a CP (randn {I}^{N}, rank {r}, {ms:.2f} ms) and CP+TT against dense (tol "
          f"{OPS13_TOL}): " + "; ".join(parts))

    X = torch.from_numpy(np.random.default_rng(13).integers(0, I, (cfg["points"], N))).to(device)
    vals, ms = _timed(lambda: cp[X].full().reshape(-1), device)
    err = rel(vals, xc[tuple(X.T)])
    print(f"13a cp[X] at {cfg['points']} coordinates: {ms:.3f} ms warm, "
          f"{cfg['points'] / ms * 1e3:.4g} evals/s, rel {err:.1e} against dense")
    if not err <= OPS13_TOL:
        failed.append(f"13a cp[X]: rel {err:.3e}")
    cases.append(("13a cp[X]", cp.tt().cores, X))

    u = tn.rand(*[I] * N, ranks_cp=2, generator=gen.manual_seed(14), device=device,
                dtype=torch.float64) * 0.5
    e, ms = _timed(lambda: tn.exp(u), device)
    err = rel(e.full(), torch.exp(u.full()))
    print(f"13a tn.exp of a CP tensor (rank 2, values in [0, 1)) by cross: {ms:.1f} ms warm, "
          f"ranks {e.ranks_tt.tolist()}, rel {err:.1e} against dense (tol {FAMILY_TOL})")
    if not err <= FAMILY_TOL:
        failed.append(f"13a exp of a CP tensor: rel {err:.3e}")
    return cases, failed


def _g_function(N, I, device):
    """examples/sobol_indices.py's g-function on a grid of I per mode: the
    rank-1 TT of g_n(x) = (|4x - 2| + a_n) / (1 + a_n), a_n = (n - 1) / 2,
    and the closed forms of its Sobol indices from the grid's own moments:
    V_n = var(g_n) / mean(g_n)^2, D = prod(1 + V) - 1; first-order S_n =
    V_n / D, total S^T_n = V_n prod_{m != n}(1 + V_m) / D, the mean
    dimension sum S^T, and the share of order k, e_k(V) / D."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    x = np.linspace(0, 1, I)
    gs = [(np.abs(4 * x - 2) + (n - 1) / 2) / (1 + (n - 1) / 2) for n in range(1, N + 1)]
    V = np.array([g.var() / g.mean() ** 2 for g in gs])
    D = np.prod(1 + V) - 1
    total = np.array([V[n] * np.prod(np.delete(1 + V, n)) for n in range(N)]) / D
    e = np.array([1.0])
    for v in V:  # the coefficients of prod(1 + V_n z)
        e = np.concatenate([e, [0.0]]) + np.concatenate([[0.0], v * e])
    t = tn.Tensor([torch.from_numpy(g)[None, :, None].to(device) for g in gs])
    return t, dict(first=V / D, total=total, mean_dimension=total.sum(),
                   distribution=e[1:] / D)


def _sobol_suite(t, syms, n_first):
    """The Sobol calls of 13b on ``t``: first-order indices of the first
    ``n_first`` variables, the total index of variable 0, the closed index
    of {0, 1}, the mean dimension and the dimension distribution; each
    result a float64 tensor on the host."""
    import torch

    import tntorch_tpu_torch as tn

    def host(x):
        return torch.as_tensor(x).double().cpu().reshape(-1)

    return {"first": torch.cat([host(tn.sobol(t, tn.only(syms[n]))) for n in range(n_first)]),
            "total_0": host(tn.sobol(t, syms[0])),
            "closed_01": host(tn.sobol(t, tn.only(syms[0] | syms[1]))),
            "mean_dimension": host(tn.mean_dimension(t)),
            "distribution": host(tn.dimension_distribution(t))}


def sobol_checks(device="cuda", cfg=SOBOL13):
    """13b: BASELINE config 5's sensitivity analysis. The 20-D g-function's
    Sobol indices, mean dimension and dimension distribution against their
    closed forms; the same calls on a 20-D randn TT of rank 10 against the
    port on the CPU; logic formulas, ``accepted_inputs`` and a mask-Tensor
    key on the card against the CPU. Each call's warm wall. Returns the
    failures."""
    import itertools

    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    failed = []
    N, I = cfg["N"], cfg["I"]
    kw = dict(device=device, dtype=torch.float64)
    syms = tn.symbols(N, **kw)
    g, closed = _g_function(N, I, device)
    walls = {}
    for name, call in (("sobol(only(x0))", lambda: tn.sobol(g, tn.only(syms[0]))),
                       ("sobol(x0) (total)", lambda: tn.sobol(g, syms[0])),
                       ("mean_dimension", lambda: tn.mean_dimension(g)),
                       ("dimension_distribution", lambda: tn.dimension_distribution(g))):
        walls[name] = _timed(call, device)[1]
    got = _sobol_suite(g, syms, N)
    want = {"first": closed["first"], "total_0": closed["total"][:1],
            "closed_01": None, "mean_dimension": closed["mean_dimension"],
            "distribution": closed["distribution"]}
    parts = []
    for key, w in want.items():
        if w is None:
            continue
        err = rel(got[key], torch.as_tensor(np.atleast_1d(w), dtype=torch.float64))
        parts.append(f"{key} {err:.1e}")
        if not err <= CP13_TOL:
            failed.append(f"13b g-function {key}: rel {err:.3e} from the closed form")
    print(f"13b the {N}-D g-function on {I}^{N}: S_0..3 = "
          f"{[round(float(v), 6) for v in got['first'][:4]]}, mean dimension "
          f"{float(got['mean_dimension']):.6f}, orders 1-3 "
          f"{[round(float(v), 6) for v in got['distribution'][:3]]}; against the closed form "
          f"(tol {CP13_TOL}): " + "; ".join(parts))
    print("13b warm walls (ms): " + "; ".join(f"{k} {v:.2f}" for k, v in walls.items()))

    gen = torch.Generator()
    t = tn.randn(*[I] * N, ranks_tt=cfg["R"], generator=gen.manual_seed(20), **kw)
    t_cpu = tn.randn(*[I] * N, ranks_tt=cfg["R"], generator=gen.manual_seed(20), device="cpu",
                     dtype=torch.float64)
    card, ms = _timed(lambda: _sobol_suite(t, syms, 4), device)
    cpu = _sobol_suite(t_cpu, tn.symbols(N, device="cpu", dtype=torch.float64), 4)
    parts = []
    for key in card:
        err = rel(card[key], cpu[key])
        parts.append(f"{key} {err:.1e}")
        if not err <= CP13_TOL:
            failed.append(f"13b randn TT {key}: rel {err:.3e} from the CPU's")
    print(f"13b randn TT {I}^{N} rank {cfg['R']}: the suite in {ms:.1f} ms warm; mean dimension "
          f"{float(card['mean_dimension']):.6f}; card vs CPU (tol {CP13_TOL}): " + "; ".join(parts))

    f = (syms[0] & syms[1]) | ~syms[2]
    checks = {"relevant_symbols": (tn.relevant_symbols(f), [0, 1, 2]),
              "De Morgan": (tn.equiv(syms[0] | syms[3], ~(~syms[0] & ~syms[3])), True),
              "implies": (tn.implies(syms[0] & syms[1], syms[1]), True),
              "satisfiable": (tn.is_satisfiable(syms[4] & ~syms[4]), False)}
    (acc, ms) = _timed(lambda: tn.accepted_inputs(tn.weight_mask(N, 2, **kw)), device)
    want_acc = [[int(n in pair) for n in range(N)] for pair in
                itertools.combinations(range(N), 2)]
    checks["accepted_inputs(weight_mask(N, 2))"] = (
        sorted(acc.cpu().tolist()), sorted(want_acc))
    for name, (got_v, want_v) in checks.items():
        if got_v != want_v:
            failed.append(f"13b {name}: {got_v} != {want_v}")
    a = tn.anova_decomposition(t)
    key = tn.presence(N, [0, 5], **kw) & tn.absence(N, [n for n in range(N) if n not in (0, 5)],
                                                    **kw)
    term, ms_key = _timed(lambda: a[key], device)
    a_cpu = tn.anova_decomposition(t_cpu)
    key_cpu = tn.presence(N, [0, 5], device="cpu", dtype=torch.float64) & tn.absence(
        N, [n for n in range(N) if n not in (0, 5)], device="cpu", dtype=torch.float64)
    err = rel(term.full().cpu(), a_cpu[key_cpu].full())
    print(f"13b logic: {', '.join(f'{k} ok' for k in checks)}; accepted_inputs "
          f"{tuple(acc.shape)} in {ms:.2f} ms; the ANOVA term f_(0,5) by a mask key: "
          f"{tuple(term.shape)} in {ms_key:.2f} ms, rel {err:.1e} from the CPU's")
    if not err <= CP13_TOL:
        failed.append(f"13b mask key: rel {err:.3e}")
    return failed


def _np_central(x, axis, step):
    """Central differences along ``axis`` with the ends extrapolated
    linearly, in NumPy: the JAX package's convention (its
    tests/test_derivatives.py reference)."""
    import numpy as np

    x = np.moveaxis(x, axis, 0)
    out = np.empty_like(x)
    out[1:-1] = x[2:] - x[:-2]
    out[0] = 2 * (x[1] - x[0])  # (x1 - (x0 - (x1 - x0)))
    out[-1] = 2 * (x[-1] - x[-2])
    return np.moveaxis(out / step, 0, axis)


def _chunked_ratio(pairs, B, chunk):
    """max over ``pairs`` of ||a|| / ||b|| over the whole batch, each pair
    (a, b) of batch Tensors decompressed ``chunk`` samples at a time."""
    import torch

    worst = 0.0
    for a, b in pairs:
        num = den = 0.0
        for b0 in range(0, B, chunk):
            num += float(torch.sum(a[b0:b0 + chunk].full() ** 2))
            den += float(torch.sum(b[b0:b0 + chunk].full() ** 2))
        worst = max(worst, (num / den) ** 0.5)
    return worst


def field_checks(device="cuda", cfg=FIELDS13):
    """13c: B potentials phi on I^3 at TT rank R, float64, one batch:
    gradient, divergence, curl, laplacian; fields 0 and B - 1 against
    NumPy's differences and against the port on the CPU (the check of the
    difference stencils); div grad phi - laplacian phi and curl grad phi at
    roundoff over the batch (a check of the rank sums only); the divergence
    rounded to rmax by 'gram' (float64) and 'randgram' (float32), the
    first and last fields against the CPU. Returns (the divergence's middle
    core, the one the Gram kernels take, failures, the chain to
    profile)."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    failed = []
    B, I, R, rmax = cfg["B"], cfg["I"], cfg["R"], cfg["rmax"]
    phi = tn.randn(B, I, I, I, ranks_tt=R, batch=True, generator=torch.Generator().manual_seed(30),
                   device=device, dtype=torch.float64)

    def derivatives():
        g = tn.gradient(phi)
        return g, tn.divergence(g), tn.curl(g), tn.laplacian(phi)

    (g, div, curl, lap), ms = _timed(derivatives, device)
    print(f"13c {B} potentials on {I}^3, rank {R}, float64: gradient + divergence + curl + "
          f"laplacian {ms:.2f} ms warm; divergence ranks {div.ranks_tt.tolist()}, curl "
          f"{curl[0].ranks_tt.tolist()}")
    # Both sides of these two run the same central differences on the same
    # cores, so they vanish whether or not the stencil is right: they check
    # the sums of ranks (TT + and - over the batch) on the card. The stencil
    # is checked against NumPy below
    commute = _chunked_ratio([(div - lap, lap)], B, cfg["chunk"])
    firsts = [tn.partial(g[2], 1), tn.partial(g[0], 2), tn.partial(g[1], 0)]
    curl_err = _chunked_ratio(list(zip(curl, firsts)), B, cfg["chunk"])
    print(f"13c over the batch: |div grad - laplacian| / |laplacian| {commute:.2e}, "
          f"|curl grad| / |its first term| {curl_err:.2e} (tol {ROUNDOFF13})")
    if not (commute <= ROUNDOFF13 and curl_err <= ROUNDOFF13):
        failed.append(f"13c div grad - laplacian {commute:.3e}, curl grad {curl_err:.3e}")

    # Two fields against NumPy's differences and the port on the CPU
    step = I / (I + 1) * 2  # partial's default bounds [0, I]
    pick = [0, B - 1]
    sub = tn.Tensor([c[pick].cpu() for c in phi.cores], batch=True)
    g_cpu = tn.gradient(sub)
    div_cpu, lap_cpu = tn.divergence(g_cpu), tn.laplacian(sub)
    worst_np = worst_cpu = 0.0
    for i, b in enumerate(pick):
        x = phi[b].full().cpu().numpy()
        gn = [_np_central(x, n, step) for n in range(3)]
        want = {"gradient": gn, "divergence": [sum(_np_central(gn[n], n, step)
                                                   for n in range(3))],
                "laplacian": [sum(_np_central(_np_central(x, n, step), n, step)
                                  for n in range(3))]}
        got = {"gradient": [t[b].full().cpu().numpy() for t in g],
               "divergence": [div[b].full().cpu().numpy()],
               "laplacian": [lap[b].full().cpu().numpy()]}
        cpu = {"gradient": [t[i].full().numpy() for t in g_cpu],
               "divergence": [div_cpu[i].full().numpy()], "laplacian": [lap_cpu[i].full().numpy()]}
        for key in got:
            for u, v, w in zip(got[key], want[key], cpu[key]):
                worst_np = max(worst_np, np.linalg.norm(u - v) / np.linalg.norm(v))
                worst_cpu = max(worst_cpu, np.linalg.norm(u - w) / np.linalg.norm(w))
    print(f"13c fields {pick}: against NumPy's differences rel {worst_np:.2e}, against the port on "
          f"the CPU rel {worst_cpu:.2e} (tol {CP13_TOL})")
    if not (worst_np <= CP13_TOL and worst_cpu <= CP13_TOL):
        failed.append(f"13c fields vs NumPy {worst_np:.3e}, vs the CPU {worst_cpu:.3e}")

    # The divergences rounded: float64 'gram' and float32 'randgram', on the
    # Gram kernels
    rounded, ms64 = _timed(lambda: tn.round_tt(div, rmax=rmax, algorithm="gram"), device)
    div32 = tn.Tensor([c.float() for c in div.cores], batch=True)
    rounded32, ms32 = _timed(lambda: tn.round_tt(div32, rmax=rmax, algorithm="randgram"), device)
    trunc = tn.relative_error(div, rounded)
    trunc32 = tn.relative_error(div, tn.Tensor([c.double() for c in rounded32.cores], batch=True))
    sub_div = tn.Tensor([c[pick].cpu() for c in div.cores], batch=True)
    ref = tn.round_tt(sub_div, rmax=rmax, algorithm="gram")
    got = tn.Tensor([c[pick].cpu() for c in rounded.cores], batch=True)
    dev = tn.relative_error(ref, got)
    ref_trunc = tn.relative_error(sub_div, ref)
    worst32 = float((trunc32 / trunc).max())
    print(f"13c round_tt(rmax={rmax}) of the divergences: 'gram' float64 {ms64:.2f} ms warm "
          f"({B / ms64 * 1e3:.1f} fields/s), truncation err {float(trunc.min()):.3e}.."
          f"{float(trunc.max()):.3e}; 'randgram' float32 {ms32:.2f} ms warm, its error over "
          f"float64's at most {worst32:.3f} (tol {RANDGRAM_FACTOR}); fields {pick} against the "
          f"CPU {dev.tolist()} (tol {GRAM_SHARE} x the CPU's truncation error {ref_trunc.tolist()})")
    if not bool((dev <= GRAM_SHARE * ref_trunc).all()) or not worst32 <= RANDGRAM_FACTOR:
        failed.append(f"13c rounding: card vs CPU {dev.tolist()}, randgram {worst32:.3f}")
    calls = []
    with recording_gram(calls):
        tn.round_tt(div, rmax=rmax, algorithm="gram")
        tn.round_tt(div32, rmax=rmax, algorithm="randgram")
    print("13c the two roundings' Gram calls and their routes: " + "; ".join(
        f"{k.__name__} {str(a[0].dtype)[6:]} C {tuple((a[1] if k.__name__ == 'proj2' else a[0]).shape)}"
        f" ({gram_route(k, a)})" for k, a in calls))

    def chain():
        g = tn.gradient(phi)
        d = tn.divergence(g)
        tn.curl(g)
        return tn.round_tt(d, rmax=rmax, algorithm="gram")

    _, ms = _timed(chain, device)
    print(f"13c the chain gradient + divergence + curl + round_tt('gram'): {ms:.2f} ms warm, "
          f"{B / ms * 1e3:.1f} fields/s")
    return div.cores[1], failed, chain


def _kron(bs):
    import torch

    k = bs[0]
    for b in bs[1:]:
        k = torch.kron(k, b)
    return k


def _operator(cfg, rng, device):
    """13d's operator: the sum of R Kronecker products of seeded blocks
    (drawn from ``rng``), dense on ``device``."""
    import numpy as np
    import torch

    dims, R = list(cfg["dims"]), cfg["R"]
    blocks = torch.from_numpy(rng.standard_normal((R, len(dims), dims[0], dims[0])) /
                              np.sqrt(dims[0])).to(device)
    return sum(_kron(blocks[r]) for r in range(R))


def operator_checks(device="cuda", cfg=OPERATOR13):
    """13d: a 4096 x 4096 operator, the sum of R Kronecker products of
    8 x 8 blocks, as a TTMatrix (TT-SVD to ranks R) and a CPMatrix (CP-ALS
    to rank R) in the (8, 8, 8, 8) layout, applied by ``tt_multiply`` and
    ``cp_multiply`` to a batch of TT vectors against the dense product; a
    Kronecker TTMatrix's determinant, log-determinant and inverse against
    torch.linalg on the dense matrix. Returns the failures."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    failed = []
    dims, R = list(cfg["dims"]), cfg["R"]
    rng = np.random.default_rng(40)
    M = _operator(cfg, rng, device)
    x = tn.randn(cfg["vectors"], *dims, ranks_tt=cfg["vector_rank"], batch=True,
                 generator=torch.Generator().manual_seed(41), device=device, dtype=torch.float64)
    V = x.full().reshape(cfg["vectors"], -1)
    want = V @ M
    ttm, ms_tt = _timed(lambda: tn.TTMatrix(M, [R] * (len(dims) - 1), dims, dims), device)
    y, ms_ttmul = _timed(lambda: tn.tt_multiply(ttm, V), device)
    cpm, ms_cp = _timed(lambda: tn.CPMatrix(M, R, dims, dims), device)
    z, ms_cpmul = _timed(lambda: tn.cp_multiply(cpm, V), device)
    fit = rel(cpm.full(), M)
    errs = {"tt_multiply vs V @ M": rel(y, want), "TTMatrix.full vs M": rel(ttm.full(), M),
            "cp_multiply vs V @ CPMatrix.full": rel(z, V @ cpm.full())}
    print(f"13d operator {M.shape[0]}x{M.shape[1]} (sum of {R} Kronecker products), "
          f"{cfg['vectors']} TT vectors: TTMatrix {ms_tt:.1f} ms, tt_multiply {ms_ttmul:.3f} ms, "
          f"CPMatrix {ms_cp:.1f} ms (CP fit rel err {fit:.2e}), cp_multiply {ms_cpmul:.3f} ms; "
          + "; ".join(f"{k} {v:.1e}" for k, v in errs.items()) + f" (tol {CP13_TOL})")
    for k, v in errs.items():
        if not v <= CP13_TOL:
            failed.append(f"13d {k}: rel {v:.3e}")
    if not fit <= CPFIT13_TOL:
        failed.append(f"13d CP fit of an exact rank-{R} operator: rel {fit:.3e}")

    # A Kronecker TTMatrix of SPD blocks with eigenvalues in [0.9, 1.1]
    Qs = [torch.linalg.qr(torch.from_numpy(rng.standard_normal((d, d))))[0] for d in dims]
    As = [(Q * torch.from_numpy(rng.uniform(0.9, 1.1, d))) @ Q.T for Q, d in zip(Qs, dims)]
    K = tn.TTMatrix([A[None, :, :, None].to(device) for A in As], None, dims, dims)
    Kd = _kron([A.to(device) for A in As])
    (sign, logdet), ms_ld = _timed(K.slog_determinant, device)
    det, _ = _timed(K.determinant, device)
    inv, ms_inv = _timed(lambda: K.inv().full(), device)
    want_sign, want_ld = torch.linalg.slogdet(Kd)
    errs = {"logdet": abs(float(logdet) - float(want_ld)) / abs(float(want_ld)),
            "det": abs(float(det) - float(torch.exp(want_ld))) / float(torch.exp(want_ld)),
            "inv": rel(inv, torch.linalg.inv(Kd))}
    print(f"13d Kronecker TTMatrix {Kd.shape[0]}^2: slog_determinant {ms_ld:.3f} ms (sign "
          f"{float(sign):+.0f}, logdet {float(logdet):.6f}), inv().full() {ms_inv:.2f} ms; "
          + "; ".join(f"{k} {v:.1e}" for k, v in errs.items()) + f" (tol {CP13_TOL})")
    if float(sign) != float(want_sign) or not all(v <= CP13_TOL for v in errs.values()):
        failed.append(f"13d Kronecker operations: {errs}, sign {float(sign)}")
    return failed


def hold_gram(name, C, r):
    """The three Gram kernels on the rounding's middle core ``C`` (B, Rl,
    I, Rr), float64 and float32, with seeded G and W (B x Rr x Rr, Rl x Rl,
    positive semidefinite) and projectors Y (B, r, Rl), X (B, Rr, r), as
    the sweep gives them: each against its plain version (KERNEL_TOL of max
    |plain|), then the kernel and the plain version timed in turns, with
    its bound (float64 at the FP64 peak) and one einsum. The caller has
    read the launch counts."""
    import torch

    from tntorch_tpu_torch.ops import gram_kernels as gk

    gen = torch.Generator(device=C.device).manual_seed(13)
    cases = {}
    for dtype in (torch.float64, torch.float32):
        B, Rl, I, Rr = C.shape

        def rn(*shape):
            return torch.randn(*shape, generator=gen, dtype=torch.float64,
                               device=C.device).to(dtype)

        def psd(n):
            A = rn(B, n, n)
            return (A @ A.mT / n).contiguous()

        Cd = C.to(dtype).contiguous()
        cases[("gram_edge", dtype)] = (Cd, psd(Rr))
        cases[("wgram", dtype)] = (Cd, psd(Rl))
        cases[("proj2", dtype)] = (rn(B, r, Rl).contiguous(), Cd, rn(B, Rr, r).contiguous())
    kernels = {k.__name__: k for k in gk.KERNELS}
    failed, report = [], {}
    for (kname, dtype), args in cases.items():
        kernel, plain = kernels[kname], gk.PLAIN[kernels[kname]]
        got, want = kernel(*args), plain(*args)
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)
        dname = str(dtype)[6:]
        C = args[1] if kname == "proj2" else args[0]
        B, Rl, I, Rr = C.shape
        r1, r2 = (args[0].shape[1], args[2].shape[2]) if kname == "proj2" else (0, 0)
        turns = in_turns({"kernel": lambda: kernel(*args), "plain": lambda: plain(*args)})
        ms, plain_ms = min(turns["kernel"]), min(turns["plain"])
        library_ms = cuda_time(lambda: gram_library(kname, *args))
        peak = PEAK_FP64 if dtype == torch.float64 else PEAK_FP32
        bound, by = bound_ms(gram_flops(kname, B, Rl, I, Rr, r1, r2), nbytes(*args, got), peak)
        report[(kname, dname)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, err=err)
        print(f"{name} {kname} {dname} B,Rl,I,Rr={tuple(C.shape)}"
              + (f" r1,r2={r1},{r2}" if kname == "proj2" else "")
              + f" ({gram_route(kernel, args)})"
              + f": rel {err:.2e} against plain (tol {KERNEL_TOL[dname]}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, one einsum {library_ms:.3f} ms, bound {bound:.4f} ms "
              f"({by}); in turns {turns}")
        if not bool(torch.isfinite(got).all()) or not err <= KERNEL_TOL[dname]:
            failed.append(f"{kname} {dname}: rel {err:.3e}")
    if failed:
        raise AssertionError(f"{name}: a Gram kernel disagrees with its plain version: "
                             + "; ".join(failed))
    return report


def time_tt_eval(name, cores, X):
    """The tt_eval kernel on both of its routes and its plain version, timed
    in turns at one of the phase's shapes, beside the forward's bound
    (float64 at the FP64 peak). The caller has read the launch counts."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    cores = [c.contiguous() for c in cores]
    turns = {"grouped": [], "per-sample": []}
    for route in ("grouped", "per-sample", "per-sample", "grouped"):
        turns[route].append(tt_path(route == "grouped", lambda: cuda_time(
            lambda: te.tt_eval_kernel(cores, X))))
    plain_ms = cuda_time(lambda: te.tt_eval_plain(cores, X), reps=3, inner=3)
    peak = PEAK_FP64 if cores[0].dtype == torch.float64 else PEAK_FP32
    bound, by = bound_ms(tt_work(cores, X)[0], nbytes(*cores, X, te.tt_eval_kernel(cores, X)),
                         peak)
    print(f"{name} tt_eval {str(cores[0].dtype)[6:]} ranks {[int(c.shape[0]) for c in cores]} "
          f"I={cores[0].shape[1]} B={X.shape[0]}: in turns (ms) {turns}; plain {plain_ms:.3f} "
          f"ms; bound {bound:.4f} ms ({by})")


def config5_path():
    """Phase 13; returns each kernel's launches in it."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import gram_kernels as gk
    from tntorch_tpu_torch.ops import tt_eval as te

    tn.set_policy("highest")  # 'gram' takes exact eigh edges
    te.reset_launches()
    gk.reset_launches()
    phase("13a. CP: CP-ALS of the 128^3 field at rank 3, CP tensors at config 1's size")
    holds, failed = cp_checks()
    phase("13b. BASELINE config 5: Sobol indices of the 20-D g-function, logic, automata")
    failed += sobol_checks()
    phase("13c. BASELINE config 5: 32 potentials on 256^3, gradient/divergence/curl/laplacian")
    core, bad, chain = field_checks()
    failed += bad
    phase("13d. TTMatrix and CPMatrix of a 4096 x 4096 operator")
    failed += operator_checks()
    torch.cuda.synchronize()
    launches = {"tt_eval": te.tt_eval_kernel.launches,
                **{k.__name__: k.launches for k in gk.KERNELS}}
    print(f"13, launches: {launches}")
    if not all(launches.values()):
        failed.append(f"a kernel of the path was not launched: {launches}")
    print("profile, the field chain (gradient, divergence, curl, round_tt 'gram'):")
    profile_device(chain, steps=1)
    hold_tt_eval("13", holds)
    time_tt_eval("13", *holds[0][1:])
    hold_gram("13", core, FIELDS13["rmax"])
    if failed:
        raise AssertionError("phase 13: " + "; ".join(failed))
    return launches


# Phase 14: the modules ported last, each at the size of the phase whose
# path it extends:
# - assignment at the evaluation design shape (phases 3b and 6): a slab of
#   mode 1 from a rank-1 TT, a scalar at repeated rows of mode 0, and a
#   rank-1 TT at a negative int key of mode 1; each raises the middle ranks
#   from R to R + R + 1 = 129, which the grouped kernel's shared-memory
#   block holds in float64 (up to 147)
ASSIGN14 = dict(N=4, I=1024, R=64, B=1 << 20, slab=(5, 9), rows=(3, 700, 3), row=-2,
                value=2.5)
# - serialization of the rounding ensemble (phase 4), a Tucker and a CP
#   tensor on 64^3, and 13d's TTMatrix and CPMatrix
SERIAL14 = dict(shape=(64, 64, 64), R=8, tucker=16, cp=5)
# Tolerances of phase 14, each with its reason:
# - assignment, the assigned tensor at 2^20 points: outside the assigned
#   region against the original's values, inside against the value's, max
#   |diff| over the largest of both: float64 1e-12 (the subtracted chunk
#   cancels the original's values to roundoff, ~1e-16 relative through a
#   rank-129 chain of 4 modes), float32 EVAL_TOL.
ASSIGN_TOL = {"float64": 1e-12, "float32": EVAL_TOL}
# - the bf16 rounding of the B=32 ensemble: its truncation error (against
#   the unrounded input) within 5x the float32 sweep's (the cut of a flat
#   spectrum to 64 of 128 directions leaves ~0.83 of the norm, and bf16's
#   2^-8 roundoff moves it by far less); against the port's bf16 body on
#   the CPU, samples 0-1, 2e-2 relative (tests/test_torch_bf16.py: where
#   two sums differ in their last bit, a bf16 re-rounding flips).
BF16_FACTOR, BF16_CPU_TOL = 5.0, 2e-2


def _random_tt(shape, R, seed, dtype, device):
    """A TT of ``shape`` at rank R, cores N(0, 1)/sqrt(R_left) from a NumPy
    seed."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    rng = np.random.default_rng(seed)
    ranks = [1] + [R] * (len(shape) - 1) + [1]
    return tn.Tensor([torch.from_numpy(rng.standard_normal((ranks[k], s, ranks[k + 1]))
                                       / np.sqrt(ranks[k])).to(device, dtype)
                      for k, s in enumerate(shape)])


def assignment_checks(device="cuda", cfg=ASSIGN14):
    """14a: three assignments into a clone of a rank-R TT, each evaluated
    at B points through ``t[X]`` forced onto the grouped kernel: outside
    the assigned region it must give the original's values, inside the
    value's (ASSIGN_TOL), float64 and float32. Prints each assignment's
    wall and ranks and the warm wall of its ``t[X]``. Returns the (tag,
    cores, X) to hold and the failures."""
    import numpy as np
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    N, I, R, B = (cfg[k] for k in ("N", "I", "R", "B"))
    a, b = cfg["slab"]
    rows, row, value = list(cfg["rows"]), cfg["row"], cfg["value"]
    X = torch.from_numpy(np.random.default_rng(140).integers(0, I, (B, N))).to(device)
    Xs = X.clone()
    Xs[:, 1] -= a
    rest = [0] + list(range(2, N))
    holds, failed = [], []
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype)[6:]
        t = _random_tt([I] * N, R, 141, dtype, device)
        v = _random_tt([I, b - a] + [I] * (N - 2), 1, 142, dtype, device)
        w = _random_tt([I] * (N - 1), 1, 143, dtype, device)
        orig = tt_path(True, lambda: t[X].full())
        cases = {
            f"t[:, {a}:{b}] = v": ((slice(None), slice(a, b)), v, (X[:, 1] >= a) & (X[:, 1] < b),
                                   lambda m: te.tt_eval_plain(v.cores, Xs[m])),
            f"t[{rows}] = {value}": ((rows,), value,
                                     torch.isin(X[:, 0], torch.tensor(rows, device=device)),
                                     lambda m: torch.full((int(m.sum()),), value, dtype=dtype,
                                                          device=device)),
            f"t[:, {row}] = w": ((slice(None), row), w, X[:, 1] == I + row,
                                 lambda m: te.tt_eval_plain(w.cores, X[m][:, rest])),
        }
        for name, (key, val, inside, values_inside) in cases.items():
            t2 = t.clone()
            _sync(device)
            t0 = time.perf_counter()
            t2[key] = val
            _sync(device)
            wall = (time.perf_counter() - t0) * 1e3
            got, eval_ms = _timed(lambda: tt_path(True, lambda: t2[X].full()), device)
            want = orig.clone()
            want[inside] = values_inside(inside)
            scale = max(float(want.abs().max()), 1e-300)
            err_out = float((got - want)[~inside].abs().max()) / scale
            err_in = float((got - want)[inside].abs().max()) / scale
            tol = ASSIGN_TOL[dname]
            # t[X]'s bound: its forward FLOPs at the assigned ranks (FP64 on
            # the tensor cores for float64), or its bytes, whichever is larger
            bound, by = bound_ms(tt_work(t2.cores, X)[0], nbytes(*t2.cores, X, got),
                                 PEAK_FP64 if dtype == torch.float64 else PEAK_FP32)
            print(f"14a {name}, {dname}: {wall:.2f} ms, ranks {t.ranks_tt.tolist()} -> "
                  f"{t2.ranks_tt.tolist()}; t[X] {eval_ms:.3f} ms (warm, the grouped kernel; "
                  f"bound {bound:.4f} ms, {by}), at {B} points ({int(inside.sum())} inside): "
                  f"outside {err_out:.2e} from the original, inside {err_in:.2e} from the "
                  f"value (tol {tol})")
            if not (err_out <= tol and err_in <= tol and bool(torch.isfinite(got).all())):
                failed.append(f"14a {name} {dname}: outside {err_out:.3e}, inside {err_in:.3e}")
            holds.append((name, t2.cores, X))
    return holds, failed


@contextlib.contextmanager
def _spying(module, record):
    """Within the block, each kernel wrapper of ``module`` (its ``KERNELS``)
    is replaced, under its module-level name, by a spy that calls
    ``record(wrapper, args)`` and then the wrapper."""

    class Spy:
        # A wrapper counts its launches (and grouped calls) on its
        # module-level name, which is this spy while the block runs: the
        # counts go to the wrapper
        launches = property(lambda self: self.kernel.launches,
                            lambda self, n: setattr(self.kernel, "launches", n))
        grouped = property(lambda self: self.kernel.grouped,
                           lambda self, n: setattr(self.kernel, "grouped", n))

        def __init__(self, kernel):
            self.kernel = kernel

        def __call__(self, *args):
            record(self.kernel, args)
            return self.kernel(*args)

    kernels = {k.__name__: k for k in module.KERNELS}
    for name, kernel in kernels.items():
        setattr(module, name, Spy(kernel))
    try:
        yield
    finally:
        for name, kernel in kernels.items():
            setattr(module, name, kernel)


@contextlib.contextmanager
def recording_gram(calls):
    """Within the block, every call of a Gram kernel's wrapper is recorded in
    ``calls`` as (wrapper, args) and then made: the shapes a path gives the
    kernels, to hold them there afterwards."""
    from tntorch_tpu_torch.ops import gram_kernels as gk

    with _spying(gk, lambda kernel, args: calls.append((kernel, args))):
        yield calls


def hold_gram_calls(name, calls):
    """Each recorded Gram call (``recording_gram``) on its kernel against
    the plain version on the same arguments, within KERNEL_TOL of max
    |plain|. The caller has read its launch counts."""
    import torch

    from tntorch_tpu_torch.ops import gram_kernels as gk

    failed, parts = [], []
    for kernel, args in calls:
        got, want = kernel(*args), gk.PLAIN[kernel](*args)
        dname = str(want.dtype)[6:]
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)
        C = args[1] if kernel.__name__ == "proj2" else args[0]
        parts.append(f"{kernel.__name__} {dname} {tuple(C.shape)} ({gram_route(kernel, args)}) "
                     f"{err:.1e}")
        if not bool(torch.isfinite(got).all()) or not err <= KERNEL_TOL[dname]:
            failed.append(f"{kernel.__name__} {dname} {tuple(C.shape)}: rel {err:.3e}")
    print(f"{name}, Gram kernels vs plain at the path's {len(calls)} calls (tol {KERNEL_TOL}): "
          + "; ".join(parts))
    if failed:
        raise AssertionError(f"{name}: a Gram kernel disagrees with its plain version: "
                             + "; ".join(failed))


def serialization_checks(device="cuda", cores=None, cfg=SERIAL14, op=OPERATOR13, rmax=64):
    """14b: save and load, through a temporary directory, the batch of
    ``cores`` (the rounding ensemble), a Tucker and a CP tensor and 13d's
    TTMatrix and CPMatrix: loaded arrays bitwise equal, on ``device``;
    then ``round_tt(rmax, 'randgram')`` of the loaded batch bitwise equal to
    the rounding of the batch before saving, with 2/2/2 Gram launches on
    the card. Prints the walls and sizes. Returns the failures."""
    import tempfile

    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import gram_kernels as gk

    tn.set_policy("high")
    batch = tn.Tensor([torch.from_numpy(c) for c in cores], batch=True, device=device)
    g = torch.Generator().manual_seed(144)
    kw = dict(generator=g, device=device, dtype=torch.float64)
    tucker = tn.randn(*cfg["shape"], ranks_tt=cfg["R"], ranks_tucker=cfg["tucker"], **kw)
    tucker.frozen_Us = {1}
    cp = tn.randn(*cfg["shape"], ranks_cp=cfg["cp"], **kw)
    dims, R = list(op["dims"]), op["R"]
    M = _operator(op, np.random.default_rng(40), device)
    objects = {"the B=32 ensemble": (batch, tn.save, tn.load),
               "a Tucker tensor": (tucker, tn.save, tn.load),
               "a CP tensor": (cp, tn.save, tn.load),
               "13d's TTMatrix": (tn.TTMatrix(M, [R] * (len(dims) - 1), dims, dims),
                                  tn.save_matrix, tn.load_matrix),
               "13d's CPMatrix": (tn.CPMatrix(M, R, dims, dims), tn.save_matrix,
                                  tn.load_matrix)}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, (name, (obj, save, load)) in enumerate(objects.items()):
            path = os.path.join(tmp, f"{k}.npz")
            _sync(device)
            t0 = time.perf_counter()
            save(obj, path)
            t1 = time.perf_counter()
            back = load(path, device=device)
            _sync(device)
            t2 = time.perf_counter()
            arrays = [list(x.cores) + list(getattr(x, "Us", [])) for x in (obj, back)]
            same = (len(arrays[0]) == len(arrays[1])
                    and all((x is None and y is None) or (x is not None and y is not None
                                                          and x.dtype == y.dtype
                                                          and y.device == x.device
                                                          and torch.equal(x, y))
                            for x, y in zip(*arrays)))
            if isinstance(obj, tn.Tensor):
                same = same and back.batch == obj.batch and back.frozen_Us == obj.frozen_Us
            print(f"14b {name}: save {(t1 - t0) * 1e3:.1f} ms, load {(t2 - t1) * 1e3:.1f} ms, "
                  f"{os.path.getsize(path) / 2**20:.2f} MiB, loaded bitwise equal: {same}")
            if not same:
                failed.append(f"14b {name}: the loaded arrays differ from the saved ones")
            if k == 0:
                loaded = back
    ref = tn.round_tt(batch, rmax=rmax, algorithm="randgram")
    before = {k.__name__: k.launches for k in gk.KERNELS}
    out = tn.round_tt(loaded, rmax=rmax, algorithm="randgram")
    _sync(device)
    launches = {k.__name__: k.launches - before[k.__name__] for k in gk.KERNELS}
    equal = all(torch.equal(x, y) for x, y in zip(ref.cores, out.cores))
    print(f"14b round_tt(rmax={rmax}, 'randgram') of the loaded ensemble: launches {launches}, "
          f"ranks {out.ranks_tt.tolist()}, bitwise equal to the rounding before saving: {equal}")
    if not equal:
        failed.append("14b: the loaded ensemble rounds to other cores")
    if torch.device(device).type == "cuda" and launches != {"gram_edge": 2, "wgram": 2,
                                                           "proj2": 2}:
        failed.append(f"14b: expected launches 2/2/2, got {launches}")
    return failed


def bf16_checks(device="cuda", cores=None, rmax=64, cpu_samples=2):
    """14c: the bf16 Gram rounding (``set_policy('bf16')``) of the batch of
    ``cores`` against the float32 'randgram' sweep on its kernels, the port
    on the CPU in float64 and the port's bf16 body on the CPU (samples
    0-1). Returns the failures and a function that times both sweeps in
    turns."""
    import torch

    import tntorch_tpu_torch as tn

    t = tn.Tensor([torch.from_numpy(c) for c in cores], batch=True, device=device)
    cpu_in = tn.Tensor([torch.from_numpy(c[:cpu_samples]) for c in cores], batch=True,
                       device="cpu")

    def sweep(policy, x):
        tn.set_policy(policy)
        try:
            return tn.round_tt(x, rmax=rmax, algorithm="randgram")
        finally:
            tn.set_policy("high")

    f32, bf = sweep("high", t), sweep("bf16", t)
    bf_cpu = sweep("bf16", cpu_in)
    ref64 = sweep("high", tn.Tensor([c.double() for c in cpu_in.cores], batch=True))

    def head(x):  # the first samples, float64 on the CPU
        return tn.Tensor([c[:cpu_samples].double().cpu() for c in x.cores], batch=True)

    trunc = {k: tn.relative_error(t, x) for k, x in (("bf16", bf), ("float32", f32))}
    ratio = float((trunc["bf16"] / trunc["float32"]).max())
    d = {"bf16 vs CPU float64": tn.relative_error(ref64, head(bf)).max(),
         "float32 vs CPU float64": tn.relative_error(ref64, head(f32)).max(),
         "bf16 vs float32 sweep": tn.relative_error(f32, bf).max(),
         "bf16 vs CPU bf16": tn.relative_error(head(bf_cpu), head(bf)).max()}
    print(f"14c bf16 rounding of the B={len(cores[0])} ensemble {rmax}: ranks "
          f"{bf.ranks_tt.tolist()}, {bf.dtype}; truncation error bf16 "
          f"{float(trunc['bf16'].max()):.6f}, float32 {float(trunc['float32'].max()):.6f}, "
          f"ratio {ratio:.4f} (at most {BF16_FACTOR}); "
          + ", ".join(f"{k} {float(v):.3e}" for k, v in d.items())
          + f" (bf16 vs CPU bf16 tol {BF16_CPU_TOL})")
    failed = []
    if not ratio <= BF16_FACTOR or not all(bool(torch.isfinite(c).all()) for c in bf.cores):
        failed.append(f"14c: bf16 truncation error {ratio:.3f}x the float32 sweep's")
    if not float(d["bf16 vs CPU bf16"]) <= BF16_CPU_TOL:
        failed.append(f"14c: bf16 on the card vs the CPU {float(d['bf16 vs CPU bf16']):.3e}")
    if bf.dtype != t.dtype or bf.ranks_tt.tolist() != [1] + [rmax] * (len(cores) - 1) + [1]:
        failed.append(f"14c: ranks {bf.ranks_tt.tolist()}, dtype {bf.dtype}")

    def timing():
        runs = in_turns({"bf16 (torch ops)": lambda: sweep("bf16", t),
                         "float32 kernels": lambda: sweep("high", t)})
        print(f"14c sweep time in turns, B={len(cores[0])} (ms, CUDA events): {runs}; bf16 / "
              f"float32 {min(runs['bf16 (torch ops)']) / min(runs['float32 kernels']):.3f}")

    return failed, timing


def _np_sines(*xs):
    import numpy as np

    return sum(np.sin(x) for x in xs)


def host_cpu():
    """The host CPU: ``lscpu``'s model name (``/proc/cpuinfo``'s where there
    is no ``lscpu``), its vendor, family and model numbers where the name is
    not known (a kernel may report it as unknown), the architecture that the
    host library's ``-march=native`` compiles for, the count of CPUs, and
    NumPy's and SciPy's versions. The host sweep's and maxvol's times are
    this CPU's."""
    import numpy as np
    import scipy

    from tntorch_tpu_torch import _build

    fields = {}
    for cmd in (["lscpu"], ["cat", "/proc/cpuinfo"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout
        except OSError:
            continue
        for line in out.splitlines():
            if ":" in line:
                key, value = line.split(":", 1)
                fields.setdefault(key.strip().lower().replace("_", " "), value.strip())
    model = fields.get("model name", "unknown")
    if model == "unknown":
        model = "model name unknown, " + ", ".join(
            f"{k} {fields[k]}" for k in ("vendor id", "cpu family", "model") if k in fields)
    march = re.search(r"-march=\s+(\S+)", _build._host_target(_build.CXX, tuple(_build.CXX_FLAGS)))
    return (f"{model}; -march=native is {march.group(1) if march else 'unknown'}; "
            f"{os.cpu_count()} CPUs; numpy {np.__version__}, scipy {scipy.__version__}")


@contextlib.contextmanager
def host_pivots(plain, spent, shapes, counts, keep=None):
    """Within the block the host sweep pivots (``cross_host._host_maxvol``)
    with the host `maxvol` (on the host library) or, with ``plain``, with
    the NumPy loop `maxvol._maxvol_plain`: each call's time goes into
    ``spent`` and into ``shapes`` by (rows, columns, dtype), ``keep`` (a
    dict) keeps the first matrix met of each (rows, columns, dtype), and
    ``counts`` gets, after the block, the library's calls and the NumPy
    loop's."""
    import importlib

    host = importlib.import_module("tntorch_tpu_torch.cross_host")
    mv = importlib.import_module("tntorch_tpu_torch.maxvol")
    from tntorch_tpu_torch import _native

    real_pivot, real_plain = host._host_maxvol, mv._maxvol_plain
    ran_plain = [0]

    def counted_plain(*args, **kw):
        ran_plain[0] += 1
        return real_plain(*args, **kw)

    base = counted_plain if plain else mv.maxvol

    def timed(A, *args):
        t0 = time.perf_counter()
        out = base(A, *args)
        sec = time.perf_counter() - t0
        spent.append(sec)
        shapes.setdefault((*A.shape, A.dtype.name), []).append(sec)
        if keep is not None:
            keep.setdefault((*A.shape, A.dtype.name), A.copy())
        return out

    _native.reset_calls()
    host._host_maxvol, mv._maxvol_plain = timed, counted_plain
    try:
        yield
    finally:
        host._host_maxvol, mv._maxvol_plain = real_pivot, real_plain
        counts.update(library=sum(_native.calls.values()), plain=ran_plain[0])


def host_sweep_turns(tag, cfg, f_np, f_torch, order, X, want, tols, keep, device=None):
    """The host sweep, ``cross(fuse='host')`` of the NumPy ``f_np``, pivoting
    on the host library ("library") and on `maxvol._maxvol_plain` ("plain"),
    and the eager device sweep of ``f_torch`` ("device"), all in float64,
    run in the turns ``order``: walls, f-evals/s, maxvol's share of each
    host sweep and its time per call at each shape. Each sweep is held to
    ``tols[sweep]`` on val_eps and on the held-out points X (``t[X]`` on the
    card against ``want``), the three to equal ranks, the library run to
    pivots on the library only and the plain run to NumPy only; ``keep``
    gets the library run's first pivot matrix of each shape. ``device``
    None is the card. Returns the (tag, cores, X) to hold, the failures and
    the least wall of each sweep."""
    import torch

    runs = {sweep: [] for sweep in order}
    results, counts = {}, {}
    shapes = {"library": {}, "plain": {}}
    for sweep in order:
        spent = []
        if sweep == "device":
            t, info, sec = _cross(cfg, f_torch, torch.float64, device)
        else:
            with host_pivots(sweep == "plain", spent, shapes[sweep], counts.setdefault(sweep, {}),
                             keep if sweep == "library" else None):
                t, info, sec = _cross(cfg, f_np, torch.float64, device, fuse="host")
        runs[sweep].append((sec, info["nsamples"] / sec, sum(spent) / sec))
        results[sweep] = (t, info)
    failed, holds = [], []
    for sweep, (t, info) in results.items():
        err = rel(t[X].full(), want)
        Rs = [int(r) for r in info["Rs"]]
        best = min(runs[sweep])
        print(f"14d {tag}, {sweep} {'sweep' if sweep == 'device' else 'host sweep'} (host_sweep "
              f"{info['host_sweep']}): {len(info['val_epss'])} iterations, ranks {Rs}, "
              f"{info['nsamples']} f-evals, val_eps {info['val_eps']:.3e}, held-out rel err at "
              f"{X.shape[0]} points {err:.3e} (tol {tols[sweep]}); on {t.device}, {t.dtype}; in "
              f"turns (s, f-evals/s" + (")" if sweep == "device" else ", maxvol share)") + ": "
              + "; ".join(f"{r[0]:.4f} s {r[1]:.4g}" + ("" if sweep == "device" else f" {r[2]:.3f}")
                          for r in runs[sweep])
              + f"; best {best[0]:.4f} s, {best[1]:.4g} f-evals/s"
              + (f"; pivots: {counts[sweep]['library']} library calls, {counts[sweep]['plain']} "
                 "of the NumPy loop" if sweep != "device" else ""))
        if not (info["val_eps"] <= tols[sweep] and err <= tols[sweep]):
            failed.append(f"14d {tag} {sweep}: val_eps {info['val_eps']:.3e}, held-out {err:.3e}")
        if t.device.type != (device or "cuda") or t.dtype != torch.float64:
            failed.append(f"14d {tag} {sweep}: the result is on {t.device}, {t.dtype}")
        if info["host_sweep"] != (sweep != "device"):
            failed.append(f"14d {tag}: the {sweep} sweep ran on the other path")
        holds.append((f"{tag} {sweep} sweep", t.cores, X))
    if len({tuple(int(r) for r in info["Rs"]) for _, info in results.values()}) != 1:
        failed.append(f"14d {tag}: the sweeps reach other ranks")
    if not (counts["library"]["library"] > 0 and counts["library"]["plain"] == 0):
        failed.append(f"14d {tag}: the library sweep's pivots {counts['library']}")
    if not (counts["plain"]["library"] == 0 and counts["plain"]["plain"] > 0):
        failed.append(f"14d {tag}: the plain sweep's pivots {counts['plain']}")
    walls = {sweep: min(r[0] for r in runs[sweep]) for sweep in runs}
    print(f"14d {tag}: host sweep wall, library over the NumPy loop (least of the turns) "
          f"{walls['library'] / walls['plain']:.3f}; maxvol by shape (rows, columns, dtype: "
          "calls, median ms a call, library / NumPy loop): "
          + "; ".join(f"{k}: {len(v)}, {1e3 * sorted(v)[len(v) // 2]:.3f} / "
                      + (f"{1e3 * sorted(shapes['plain'][k])[len(shapes['plain'][k]) // 2]:.3f}"
                         if k in shapes["plain"] else "none")
                      for k, v in sorted(shapes["library"].items())))
    return holds, failed, walls


def maxvol_parts(A, iters=100):
    """The host `maxvol`'s library path on A taken apart, as it runs there
    (the LU start, inv(A[rows]), the product A inv(A[rows]), the C++ swap
    loop), and the NumPy loop's coefficients by a solve
    (`maxvol._coefficients`) at the same rows: the seconds of each."""
    import importlib
    import warnings

    import scipy.linalg

    mv = importlib.import_module("tntorch_tpu_torch.maxvol")
    from tntorch_tpu_torch import _native

    t0 = time.perf_counter()
    rows = mv._initial_pivots(A, A.shape[0])[:A.shape[1]].copy()
    t1 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
        inv = scipy.linalg.inv(A[rows], check_finite=False)
    t2 = time.perf_counter()
    C = A @ inv
    t3 = time.perf_counter()
    _native.native_maxvol_iterate(C, rows, 1.05, iters)
    t4 = time.perf_counter()
    mv._coefficients(A, rows)
    return t1 - t0, t2 - t1, t3 - t2, t4 - t3, time.perf_counter() - t4


def time_host_maxvol(cases, turns=3):
    """Each (tag, A, hold) of ``cases``: the host `maxvol` (on the host
    library) against `maxvol._maxvol_plain` on A, one call each in turns
    (the order alternating), ``turns`` times: the median ms a call of each,
    and of the library path's parts (`maxvol_parts`, in the same turns).
    Where ``hold``, both give the same rows and C within MAXVOL_TOL of each
    other (both keep |C| <= 1.05); so does the host `rect_maxvol` with maxK
    = r (the host pivots of a minimizing cross with ``record_samples``)
    against `maxvol._rect_maxvol_plain`. Returns the failures."""
    import importlib

    import numpy as np

    mv = importlib.import_module("tntorch_tpu_torch.maxvol")
    from tntorch_tpu_torch import _native

    failed = []
    for tag, A, hold in cases:
        times = {"library": [], "plain": []}
        fns = {"library": mv.maxvol, "plain": mv._maxvol_plain}
        parts = []
        _native.reset_calls()
        for k in range(turns):
            for name in (("library", "plain") if k % 2 == 0 else ("plain", "library")):
                t0 = time.perf_counter()
                out = fns[name](A, 1.05, 100)
                times[name].append(time.perf_counter() - t0)
                if name == "library":
                    rows, C = out
                else:
                    prows, pC = out
        calls = dict(_native.calls)
        for _ in range(turns):
            parts.append(maxvol_parts(A))
        med = {k: 1e3 * sorted(v)[len(v) // 2] for k, v in times.items()}
        split = [1e3 * sorted(p[i] for p in parts)[turns // 2] for i in range(5)]
        tol = MAXVOL_TOL[A.dtype.name]
        same = bool(np.array_equal(rows, prows))
        diff = float(np.abs(C.astype(np.float64) - pC).max())
        line = (f"14d maxvol alone, {tag} ({A.shape[0]} x {A.shape[1]} {A.dtype.name}): library "
                f"{med['library']:.3f} ms a call, NumPy loop {med['plain']:.3f} ms (median of "
                f"{turns}, in turns), {med['plain'] / med['library']:.2f}x; rows equal {same}, "
                f"max |C - C_plain| {diff:.2e}, max |C| {float(np.abs(C).max()):.6f}; the "
                f"library path's parts (median ms): LU start {split[0]:.3f}, inv(A[rows]) "
                f"{split[1]:.3f}, A inv(A[rows]) {split[2]:.3f}, C++ swap loop {split[3]:.3f} "
                f"(the NumPy loop's solve for C {split[4]:.3f}); library calls {calls}")
        if hold:
            krows, KC = mv.rect_maxvol(A, maxK=A.shape[1])
            prow2, pKC = mv._rect_maxvol_plain(A, maxK=A.shape[1])
            kdiff = float(np.abs(KC.astype(np.float64) - pKC).max())
            line += (f"; rect_maxvol(maxK=r) rows equal {bool(np.array_equal(krows, prow2))}, "
                     f"max |C - C_plain| {kdiff:.2e} (tol {tol})")
            if not (same and diff <= tol and np.array_equal(krows, prow2) and kdiff <= tol):
                failed.append(f"14d maxvol alone {tag}: the library and the NumPy loop part")
            if _native.calls["rect_maxvol"] != 1:
                failed.append(f"14d maxvol alone {tag}: rect_maxvol missed the library")
        if calls["maxvol_iterate"] != turns:
            failed.append(f"14d maxvol alone {tag}: {calls} library calls in {turns} turns")
        print(line)
    return failed


def host_cross_checks(device=None, cfg=CROSS3, rounds=2, fixed=CROSS_FIXED, turns=3):
    """14d: ``tn.cross(fuse='host')`` of config 3 with a NumPy function,
    pivoting on the host library and on the NumPy loop, and the same cross
    on the eager device sweep with the torch function, in float64, timed in
    turns: equal ranks, val_eps below eps and 10^5 held-out points
    (``t[X]``, on the tt_eval kernel on the card) within eps; f-evals/s of
    each and the host sweeps' time in maxvol. Then the fixed-rank 256^5
    cross at ranks 100 (``fixed``, where maxvol meets 25600 x 100) the same
    way, and maxvol alone at 25600 x 100 (float64 and float32) and at config
    3's largest pivot matrix, the library against the NumPy loop
    (`time_host_maxvol`). ``device`` None is the card; the CPU rehearses
    at small sizes. Returns the (tag, cores, X) to hold and the failures."""
    import numpy as np
    import torch

    where = device or "cuda"
    print(f"14d host CPU: {host_cpu()}; card: {_smi_line() if where == 'cuda' else 'none'}")
    X = _held_out(cfg, HELD_OUT, where)
    want = torch.sin(torch.tensor(_axes(cfg)[0], device=where)[X]).sum(1)
    met = {}
    order = ("library", "plain", "device", "device", "plain", "library") * rounds
    holds, failed, walls = host_sweep_turns("config 3", cfg, _np_sines, _sines, order, X, want,
                                            dict.fromkeys(order, cfg["eps"]), met, device)
    largest = max(met.values(), key=lambda A: A.size)
    met = {}
    Xf = _held_out(fixed, HELD_OUT, where)
    wantf = 1 / torch.tensor(_axes(fixed)[0], device=where)[Xf].sum(1)
    tols = {"library": HOST_FIXED_TOL, "plain": HOST_FIXED_TOL, "device": CROSS_FIXED_F64_TOL}
    order = ("device", "library", "plain", "library")
    more, bad, fixed_walls = host_sweep_turns("256^5 ranks 100", fixed, _hilbert, _hilbert, order,
                                              Xf, wantf, tols, met, device)
    holds += more
    failed += bad
    print(f"14d the library's gain on the host sweep's wall: config 3 "
          f"{1 - walls['library'] / walls['plain']:.3f}, 256^5 ranks 100 "
          f"{1 - fixed_walls['library'] / fixed_walls['plain']:.3f} (least walls of the turns)")
    n, r = fixed["I"] * fixed["ranks_tt"], fixed["ranks_tt"]
    Q = np.linalg.qr(np.random.default_rng(13).standard_normal((n, r)))[0]
    swept = [("the 256^5 sweep's first pivot matrix of its shape", A, False)
             for key, A in sorted(met.items()) if key[0] in (fixed["I"], n) and key[1] == r]
    failed += time_host_maxvol([("an orthonormal Q", Q, True),
                                ("an orthonormal Q", Q.astype(np.float32), True),
                                ("config 3's largest pivot matrix", largest, False)] + swept,
                               turns)
    return holds, failed


def _smi_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def host_sweep_path():
    """Phase 14d alone: the host sweeps and maxvol (`host_cross_checks`),
    then ``tt_eval`` (both routes) held at their shapes."""
    import tntorch_tpu_torch as tn

    tn.set_policy("highest")
    phase("14d. the host sweep, cross(fuse='host'), on the host library and on the NumPy loop, "
          "at BASELINE config 3 (32^10) and 256^5 ranks 100, float64, and the eager device sweep")
    holds, failed = host_cross_checks()
    hold_tt_eval("14d", holds)
    if failed:
        raise AssertionError("phase 14d: " + "; ".join(failed))


def missing_modules_path():
    """Phase 14; returns each kernel's launches in it."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import gram_kernels as gk
    from tntorch_tpu_torch.ops import tt_eval as te

    tn.set_policy("highest")
    te.reset_launches()
    gk.reset_launches()
    phase("14a. assignment at the evaluation design shape (N=4, I=1024, R=64): t[key] = value, "
          "then t[X] at 2^20 points on the grouped tt_eval kernel, float64 and float32")
    holds, failed = assignment_checks()
    if te.tt_eval_kernel.grouped != te.tt_eval_kernel.launches:
        failed.append(f"14a: {te.tt_eval_kernel.launches} tt_eval launches, "
                      f"{te.tt_eval_kernel.grouped} grouped")
    phase("14b. serialization: save and load the B=32 ensemble, Tucker, CP, TTMatrix, "
          "CPMatrix; round_tt of the loaded ensemble on the Gram kernels")
    cores = bench_cores()
    calls = []
    with recording_gram(calls):
        failed += serialization_checks(cores=cores)
    phase("14c. the bf16 Gram variant at the rounding shape (B=32, N=4, I=256, 128 -> 64)")
    bad, bf16_timing = bf16_checks(cores=cores)
    failed += bad
    phase("14d. the host sweep, cross(fuse='host'), on the host library and on the NumPy loop, "
          "at BASELINE config 3 (32^10) and 256^5 ranks 100, float64, and the eager device sweep")
    tn.set_policy("highest")
    cross_holds, bad = host_cross_checks()
    failed += bad
    torch.cuda.synchronize()
    launches = {"tt_eval": te.tt_eval_kernel.launches,
                **{k.__name__: k.launches for k in gk.KERNELS}}
    print(f"14, launches: {launches} (grouped tt_eval {te.tt_eval_kernel.grouped})")
    if not all(launches.values()):
        failed.append(f"a kernel of the path was not launched: {launches}")
    hold_tt_eval("14", holds + cross_holds)
    hold_gram_calls("14b", calls)
    bf16_timing()
    if failed:
        raise AssertionError("phase 14: " + "; ".join(failed))
    return launches


# Phase 15: the tutorials of tntorch_tpu_torch/examples/, each through its
# main() as a user runs it, held to expected.check (the JAX tutorials'
# figures and the tutorials' claims): the eight analytic ones in float64,
# the JAX scripts' analysis mode (float64 is also what sends vector_fields'
# batched 'gram' rounding to the Gram kernels; float32 under the 'highest'
# policy takes the SVD sweep), the four training ones in float32 at their
# own sizes and iteration counts, uncapped.


@contextlib.contextmanager
def recording_tt_eval(calls):
    """Within the block, every call of the tt_eval kernels' wrappers is
    recorded in ``calls`` as (wrapper, cores, X, *rest) and then made; the
    cores and weights are copied, since training updates the cores in
    place."""
    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    def record(kernel, args):
        cores, X, *rest = args
        calls.append((kernel, [c.detach().clone() for c in cores], X,
                      *(r.detach().clone() if isinstance(r, torch.Tensor) else r for r in rest)))

    with _spying(te, record):
        yield calls


def hold_tt_eval_calls(name, calls, tags, chunk=256):
    """Each recorded tt_eval and tt_eval_backward call (`recording_tt_eval`;
    ``tags[i]`` names the tutorial of call i) on its kernel, by the route
    the call took, against the plain version on the same arguments: max
    |diff| within KERNEL_TOL of the largest sum of magnitudes that an output
    entry adds up (the plain version on |cores| and |g|). Against max |plain|
    a fitted optimum's gradient would not do: its sums cancel to ~1e-4 of
    their terms, while float32 rounds each term. Both ratios are printed.
    Calls with one X and one set of shapes are compared ``chunk`` at a time,
    the plain versions by one ``torch.func.vmap`` over their cores (exact:
    the same operations on each call's operands). The caller has read its
    launch counts."""
    import collections

    import torch

    from tntorch_tpu_torch.ops import tt_eval as te

    def flat(outs):  # (calls, entries) from a (calls, B) tensor or a list of them
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        return torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)

    groups = collections.defaultdict(list)
    for tag, (kernel, cores, X, *rest) in zip(tags, calls):
        groups[(tag, kernel, id(X), tuple(tuple(c.shape) for c in cores))].append(
            (cores, X, rest))
    worst, count = {}, collections.Counter()
    for (tag, kernel, _, _), group in groups.items():
        plain, X = te.PLAIN[kernel], group[0][1]
        backward = kernel is te.tt_eval_backward_kernel

        def plains(cores, gs):
            if backward:
                return torch.func.vmap(lambda g, *cs: plain(list(cs), X, g))(gs, *cores)
            return torch.func.vmap(lambda *cs: plain(list(cs), X))(*cores)

        for i in range(0, len(group), chunk):
            part = group[i:i + chunk]
            got = [kernel(cores, X, *rest) for cores, X, rest in part]
            got = [torch.stack(o) for o in zip(*got)] if backward else torch.stack(got)
            cores = [torch.stack(c) for c in zip(*(cores for cores, _, _ in part))]
            gs = torch.stack([rest[0] for _, _, rest in part]) if backward else None
            want = flat(plains(cores, gs))
            terms = flat(plains([c.abs() for c in cores], gs.abs() if backward else None))
            diff = (flat(got) - want).abs().amax(1).nan_to_num(nan=float("inf"))
            errs = torch.stack([diff / terms.abs().amax(1).clamp(min=1e-300),
                                diff / want.abs().amax(1).clamp(min=1e-300)]).amax(1)
            key = (kernel.__name__, str(want.dtype)[6:], tag)
            worst[key] = torch.maximum(worst[key], errs) if key in worst else errs
            count[key] += len(part)
    failed, parts = [], []
    for key, errs in worst.items():
        err, err_plain = errs.tolist()
        parts.append(f"{key[0]} {key[1]} in {key[2]} at {count[key]} calls: worst {err:.1e} "
                     f"of the terms' magnitude, {err_plain:.1e} of max |plain|")
        if not err <= KERNEL_TOL[key[1]]:
            failed.append(f"{key[0]} {key[1]} in {key[2]}: rel {err:.3e}")
    print(f"{name}, tt_eval kernels vs plain at every call of the path (tol {KERNEL_TOL}): "
          + "; ".join(parts))
    if failed:
        raise AssertionError(f"{name}: a tt_eval kernel disagrees with its plain version: "
                             + "; ".join(failed))


@contextlib.contextmanager
def recording_roundings(routes):
    """Within the block, each ``Tensor.round_tt`` call appends to ``routes``
    the route it took: its algorithm, dtype, and the Gram kernels'
    launches it made (none: the SVD or eigh sweep)."""
    import inspect

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import gram_kernels as gk

    real = tn.Tensor.round_tt
    signature = inspect.signature(real)

    def spy(self, *args, **kwargs):
        algorithm = signature.bind(self, *args, **kwargs).arguments.get("algorithm", "svd")
        before = sum(k.launches for k in gk.KERNELS)
        out = real(self, *args, **kwargs)
        n = sum(k.launches for k in gk.KERNELS) - before
        routes.append(f"'{algorithm}' {str(self.dtype)[6:]}{' batch' if self.batch else ''}: "
                      + (f"the Gram kernels ({n} launches)" if n else "a sweep without them"))
        return out

    tn.Tensor.round_tt = spy
    try:
        yield routes
    finally:
        tn.Tensor.round_tt = real


def tutorials_path(device="cuda", caps=None):
    """Phase 15; returns each kernel's launches in it. On the CPU
    (``device="cpu"``, a rehearsal) the training tutorials take ``caps``
    (``expected.CPU_CAPS``) and are held to the capped thresholds."""
    import collections
    import importlib

    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.examples import NAMES, expected
    from tntorch_tpu_torch.ops import gram_kernels as gk
    from tntorch_tpu_torch.ops import tt_eval as te

    def counts():
        return {"tt_eval": te.tt_eval_kernel.launches,
                "tt_eval_backward": te.tt_eval_backward_kernel.launches,
                **{g.__name__: g.launches for g in gk.KERNELS}}

    tn.set_policy("highest")  # the package's default, as a user runs the tutorials
    caps = caps or {}
    te.reset_launches()
    gk.reset_launches()
    start = time.perf_counter()
    failed, results, tt_calls, tags, gram_calls, samples = [], {}, [], [], [], []
    for k, name in enumerate(n for n in NAMES if n != "multichip"):  # phase 16c runs it
        dtype = torch.float64 if k < 8 else torch.float32
        phase(f"15.{k + 1}. tutorial {name} on {device}, {str(dtype)[6:]}")
        module = importlib.import_module(f"tntorch_tpu_torch.examples.{name}")
        before, grouped = counts(), te.tt_eval_kernel.grouped
        first, routes = len(tt_calls), []
        with recording_roundings(routes), recording_tt_eval(tt_calls), \
                recording_gram(gram_calls):
            t0 = time.perf_counter()
            out = module.main(device=device, dtype=dtype, **caps.get(name, {}))
            _sync(device)
            wall = time.perf_counter() - t0
        launches = {key: n - before[key] for key, n in counts().items()}
        bad = expected.check(name, out, dtype, capped=name in caps)
        results[name] = out
        print(f"15 {name}: wall {wall:.3f} s, launches {launches} (grouped tt_eval "
              f"{te.tt_eval_kernel.grouped - grouped}); roundings: "
              + (", ".join(f"{r} x{n}" for r, n in collections.Counter(routes).items())
                 or "none")
              + f"; held to the JAX figures and its claims: {'ok' if not bad else bad}")
        failed += bad
        tags += [name] * (len(tt_calls) - first)
        fwd = next((c for c in tt_calls[first:] if c[0] is te.tt_eval_kernel), None)
        if fwd is not None:  # one forward call of each tutorial on both routes
            samples.append((name, fwd[1], fwd[2]))
    _sync(device)
    launches = counts()
    print(f"15, launches: {launches} (grouped tt_eval {te.tt_eval_kernel.grouped}); the 12 "
          f"tutorials {time.perf_counter() - start:.1f} s")
    if torch.device(device).type == "cuda" and not all(launches.values()):
        failed.append(f"a kernel of the path was not launched: {launches}")
    if failed:
        for name, out in results.items():
            if any(f.startswith(f"{name}:") for f in failed):
                print(f"15 {name}'s figures: {out}")
        raise AssertionError("phase 15: " + "; ".join(failed))
    hold_tt_eval_calls("15", tt_calls, tags)
    hold_tt_eval("15", samples)
    hold_gram_calls("15", gram_calls)
    if torch.device(device).type == "cuda":
        # 64 steps of each fit: exponential machines has one (in one block),
        # classification three (its tensor, TTClassifier, the ensemble of 4)
        for name, steps in (("exponential_machines", 64), ("classification", 192)):
            module = importlib.import_module(f"tntorch_tpu_torch.examples.{name}")
            print(f"profile, {name} at 64 steps a fit (float32):")
            profile_device(lambda: module.main(device=device, dtype=torch.float32,
                                               max_iter=63), steps=steps)
    print(f"15: the phase {time.perf_counter() - start:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the parallel layer (tntorch_tpu_torch/parallel)
# ---------------------------------------------------------------------------
# 16a runs each case on one rank of an NCCL process group (mesh (1, 1)) at
# full size; 16b on four ranks that share the one card in a gloo process
# group (NCCL refuses two ranks on one card; the port stages each gloo
# collective of card tensors through host memory), on meshes (1, 4),
# (2, 2) and (4, 1); 16c runs the multichip tutorial on its own four ranks.
# Every wall of phase 16 is that of ranks sharing one card, their
# collectives through host memory: not a multi-card number.
#
# The cases, each at the size of the phase it borrows from: 'round',
# round_tt_gram_sharded of phase 4's first TT (N=4, I=256, rank 128 -> 64,
# 'eigh' edges) with its modes sharded over tp; 'batch',
# round_tt_batch_sharded of phase 4's B=32 ensemble over dp; 'forward',
# tt_forward_sharded at phase 6's design shape (N=4, I=1024, R=64,
# B=2^20) over dp, and at tp > 1 on the first fwd_tp_B rows: there the
# alternating layout's einsums gather (R, B/dp, R/tp) per core, 4 GiB a
# core and rank at (2, 2) and B=2^20, which four ranks sharing the card's
# 80 GB hold one core at a time (a smaller fwd_tp_B where they would not);
# 'optimize', phase 7's training (256^3 rank 16, 8192 samples, 20 steps,
# Adam lr 1e-3, its loss closure unchanged) with mesh=.
SIZES16 = dict(round=BENCH, fwd=EVAL, fwd_tp_B=1 << 20, train=TRAIN)
CASES16 = (("round", (1, 4), "float32"), ("round", (2, 2), "float32"),
           ("round", (1, 4), "float64"), ("batch", (4, 1), "float32"),
           ("forward", (4, 1), "float32"), ("forward", (2, 2), "float32"),
           ("optimize", (4, 1), "float32"))
# Tolerances of phase 16, each with its reason:
# - sharded Gram rounding against the single-process port on the card,
#   relative error of the dense results (`_f64_dist`): the sharded sums run
#   in another order, and the rank-64 cut of phase 4's flat random spectrum
#   amplifies float32 roundoff: each float32 sweep on the card lies
#   1.25e-4 to 1.36e-4 from the CPU's float64 rounding, and the sharded
#   and single-process float32 sweeps 3.8e-5 to 5.1e-5 apart (one TT) and
#   1.75e-4 (the worst of the B=32 batch, whose kernels split the work by
#   B); 1e-3. Float64: roundoff, 1e-10. Against the CPU's float64 rounding:
#   MAIN_TOL (phase 4), per sample for the batch.
ROUND16_TOL = {"float32": 1e-3, "float64": 1e-10}
# - the sharded forward against tn.tt_eval on the card, max |diff| over
#   max |value|: float32 rank-64 chains summed in another order (the tp
#   all-reduces; at tp=1 the same kernel): 1e-6. Against the CPU's float64
#   values at the first 4096 rows: EVAL_TOL (phase 6).
FWD16_TOL = 1e-6
# - dp training, the 20 losses against the single-process run on the card
#   and against the CPU's float64 run, max relative difference: TRAIN_TOL
#   (phase 7); the trained cores against the single-process ones, max
#   |diff| over max |core|: 1e-4 (20 Adam steps of lr 1e-3 on float32
#   gradients summed in another order).
CORES16_TOL = 1e-4


@functools.lru_cache(maxsize=1)
def _bench16(**cfg):
    """`bench_cores`, drawn once per process: the phase's cases share them."""
    return tuple(bench_cores(cfg))


def _inputs16(case, cfg, dtype, device):
    """The data of one case of phase 16 on ``device``, from the NumPy seeds
    of the phase it borrows from."""
    import torch

    def put(x, dt=dtype):
        return torch.from_numpy(x).to(device, dt)

    if case in ("round", "batch"):
        cores = _bench16(**{k: cfg["round"][k] for k in ("N", "I", "R", "B")})
        return [put(c[0] if case == "round" else c) for c in cores]
    if case == "forward":
        cores, X = eval_data(cfg["fwd"])
        return [put(c) for c in cores], put(X, torch.int64)
    cores, X, y = train_data(cfg["train"])
    return [put(c) for c in cores], put(X, torch.int64), put(y)


def _call16(case, cfg, data, mesh=None):
    """One case's call on its data: the sharded entry point over ``mesh``
    (the data placed first, and not timed), or without a mesh the
    single-process port."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch import parallel as par
    from tntorch_tpu_torch.ops import rounding as tr

    rmax = cfg["round"]["rmax"]
    if case == "optimize":
        cores, X, y = data
        if mesh is not None:
            X, y = par.shard_array(X, mesh), par.shard_array(y, mesh)

        def fit():
            t = tn.Tensor([c.clone() for c in cores], requires_grad=True)
            hist = tn.optimize([t], lambda t: torch.mean((t[X].full() - y) ** 2), tol=None,
                               max_iter=cfg["train"]["steps"] - 1, verbose=False, mesh=mesh)
            return hist, t.cores
        return fit
    if case == "forward":
        cores, X = data
        if mesh is not None:
            if mesh.size(mesh.mesh_dim_names.index("tp")) > 1:
                X = X[:cfg["fwd_tp_B"]]
            cores, X = par.replicate_pytree(cores, mesh), par.shard_array(X, mesh)
            return lambda: par.tt_forward_sharded(cores, X, mesh)
        return lambda: tn.tt_eval(cores, X)
    if mesh is None:
        if case == "round":
            return lambda: tr.round_tt_gram(data, rmax, edge_solver="eigh")
        return lambda: tr.round_tt_gram_batched(data, rmax, "eigh")
    if case == "round":
        placed = [par.place(c, mesh, (None, "tp")) for c in data]
        return lambda: par.round_tt_gram_sharded(placed, rmax, mesh)
    placed = [par.place(c, mesh, ("dp",)) for c in data]
    return lambda: par.round_tt_batch_sharded(placed, rmax, mesh)


def rank16(case, shape, dtype_name, cfg, repeats, device="cuda"):
    """One case of phase 16 on this rank of the running process group:
    the case's data and mesh, one recorded call (each kernel's launches,
    every collective with its size, the Gram and tt_eval calls), then
    ``repeats`` timed calls, each after a barrier, then the recorded kernel
    calls held to their plain versions. Returns the counts, the walls, what
    the rank printed, and on rank 0 the whole result (gathered)."""
    import io

    import torch
    import torch.distributed as dist

    from tntorch_tpu_torch import parallel as par
    from tntorch_tpu_torch.ops import gram_kernels as gk
    from tntorch_tpu_torch.ops import tt_eval as te

    rank, log = dist.get_rank(), io.StringIO()
    with contextlib.redirect_stdout(log):
        mesh = par.make_mesh(shape, device=device)
        t0 = time.perf_counter()
        call = _call16(case, cfg, _inputs16(case, cfg, getattr(torch, dtype_name), device), mesh)
        _sync(device)
        setup = time.perf_counter() - t0
        gram_calls, tt_calls = [], []
        dist.barrier()
        gk.reset_launches()
        te.reset_launches()
        with par.counting_collectives() as calls, recording_gram(gram_calls), \
                recording_tt_eval(tt_calls):
            t0 = time.perf_counter()
            out = call()
            _sync(device)
            first = time.perf_counter() - t0
        launches = {**{k.__name__: k.launches for k in gk.KERNELS},
                    **{k.__name__.replace("_kernel", ""): k.launches for k in te.KERNELS}}
        grouped = te.tt_eval_kernel.grouped
        walls = []
        for _ in range(repeats):
            dist.barrier()
            t0 = time.perf_counter()
            call()
            _sync(device)
            walls.append(time.perf_counter() - t0)
        if gram_calls:
            hold_gram_calls(f"16 {case} rank {rank}", gram_calls)
        if tt_calls:
            hold_tt_eval_calls(f"16 {case} rank {rank}", tt_calls, [case] * len(tt_calls))
        if case == "optimize":
            whole = (out[0], [par.gather(c.detach()) for c in out[1]])
        elif case == "forward":
            whole = par.gather(out)
        else:
            whole = [par.gather(c) for c in out]
    return dict(rank=rank, launches=launches, grouped=grouped, collectives=calls, setup=setup,
                first=first, walls=walls, log=log.getvalue(), whole=whole if rank == 0 else None)


def _f64_dist(got, want, batch=False):
    """||got - want|| / ||want|| of two TTs (lists of cores), the largest
    over the samples of a batch, in float64 on the CPU: each norm from a QR
    sweep over the cores (of the difference: its TT of doubled rank), so
    the distance is accurate to float64 roundoff, not to the square root of
    it as the dot expansion of tn.relative_error is."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops.rounding import _left_orthogonalize_sweep

    def norm(t):
        cores = [c if batch else c[None] for c in t.cores]
        last = _left_orthogonalize_sweep(cores)[-1]
        return torch.linalg.vector_norm(last.reshape(last.shape[0], -1), dim=-1)

    def tt(cores):
        return tn.Tensor([c.double().cpu() for c in cores], batch=batch)

    return float((norm(tt(got) - tt(want)) / norm(tt(want))).max())


def _check16(case, dtype, cfg, whole, data, single, device):
    """The failures of one case's gathered result ``whole`` against the
    single-process port's ``single`` on the card and the CPU in float64;
    prints each distance."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    failed, d = [], str(dtype)[6:]
    if case in ("round", "batch"):
        batch = case == "batch"
        err = _f64_dist(whole, single, batch)
        cpu_in = [c.double().cpu()[:2] if batch else c.double().cpu() for c in data]
        cpu = _call16(case, cfg, cpu_in)()
        got = [c[:2] for c in whole] if batch else whole
        err_cpu = _f64_dist(got, cpu, batch)
        equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(whole, single))
        print(f"  vs the single-process port on the card: rel {err:.3e} (tol "
              f"{ROUND16_TOL[d]}; bitwise equal: {equal}); vs the CPU's float64 rounding"
              f"{' (samples 0-1)' if batch else ''}: rel {err_cpu:.3e} (tol {MAIN_TOL})")
        if not (err <= ROUND16_TOL[d] and err_cpu <= MAIN_TOL):
            failed.append(f"{case} {d}: rel {err:.3e} vs the card, {err_cpu:.3e} vs the CPU")
    elif case == "forward":
        cores, X = data
        want = single[:whole.shape[0]]
        err = float((whole.cpu() - want.cpu()).abs().max() / want.abs().max())
        rows = min(4096, whole.shape[0])
        ref = tn.tt_eval([c.double().cpu() for c in cores], X[:rows].cpu())
        err_cpu = float((whole[:rows].double().cpu() - ref).abs().max() / ref.abs().max())
        print(f"  vs tn.tt_eval on the card: max |diff| / max |value| {err:.3e} (tol {FWD16_TOL}; "
              f"bitwise equal: {torch.equal(whole.cpu(), want.cpu())}); vs the CPU's float64 at "
              f"{rows} rows: {err_cpu:.3e} (tol {EVAL_TOL})")
        if not (err <= FWD16_TOL and err_cpu <= EVAL_TOL):
            failed.append(f"forward: rel {err:.3e} vs the card, {err_cpu:.3e} vs the CPU")
    else:
        hist, cores = whole
        ref_hist, ref_cores = single
        cores_in, X, y = data
        cpu_hist, _ = _call16(case, cfg, ([c.double().cpu() for c in cores_in], X.cpu(),
                                          y.double().cpu()))()
        err = float(np.max(np.abs(np.array(hist) - ref_hist) / np.abs(ref_hist)))
        err_cpu = float(np.max(np.abs(np.array(hist) - cpu_hist) / np.abs(cpu_hist)))
        err_c = max(float((a.cpu() - b.detach().cpu()).abs().max() / b.detach().abs().max())
                    for a, b in zip(cores, ref_cores))
        print(f"  {len(hist)} losses {hist[0]:.6f} -> {hist[-1]:.6f}; vs the single-process run "
              f"on the card: max rel {err:.3e}, cores {err_c:.3e} (tol {TRAIN_TOL}, "
              f"{CORES16_TOL}); vs the CPU's float64 run: {err_cpu:.3e} (tol {TRAIN_TOL})")
        if not (err <= TRAIN_TOL and err_c <= CORES16_TOL and err_cpu <= TRAIN_TOL
                and hist[-1] < hist[0]):
            failed.append(f"optimize: rel {err:.3e}/{err_c:.3e} vs the card, {err_cpu:.3e} vs "
                          "the CPU, or the loss did not fall")
    return failed


def _expected16(case, shape, cfg):
    """Each rank's launches of each kernel and its collectives (name,
    count, largest size) in one call of a case on a mesh of ``shape``."""
    gram = {"gram_edge": 2, "wgram": 2, "proj2": 2}  # the Rr=1 edge: a batched product
    none = dict.fromkeys(gram, 0)
    dp, tp = shape
    if case == "round":
        R = cfg["round"]["R"]
        return {**gram, "tt_eval": 0, "tt_eval_backward": 0}, (
            [("all_reduce", 2 * (cfg["round"]["N"] - 1), R * R)] if tp > 1 else [])
    if case == "batch":
        return {**gram, "tt_eval": 0, "tt_eval_backward": 0}, []
    if case == "forward":
        if tp > 1:  # the alternating layout: an all-reduce after each odd core
            f = cfg["fwd"]
            return {**none, "tt_eval": 0, "tt_eval_backward": 0}, [
                ("all_reduce", f["N"] // 2, cfg["fwd_tp_B"] // dp * f["R"])]
        return {**none, "tt_eval": 1, "tt_eval_backward": 0}, []
    T = cfg["train"]
    R, I, steps = T["R"], T["I"], T["steps"]
    # a step: one all-reduce of each core's gradient and one of the loss
    return {**none, "tt_eval": steps, "tt_eval_backward": steps}, (
        [("all_reduce", steps * (T["N"] + 1), R * I * R)] if dp > 1 else [])


def _collectives(calls):
    """(name, count, largest size) of each kind of collective in ``calls``."""
    kinds = {}
    for name, size in calls:
        n, top = kinds.get(name, (0, 0))
        kinds[name] = (n + 1, max(top, size))
    return [(name, n, top) for name, (n, top) in sorted(kinds.items())]


def report16(group, tag, case, shape, dtype_name, cfg, device, repeats, total):
    """One case of phase 16 on every rank of ``group`` against the
    single-process port; adds its launches to ``total`` and returns its
    failures."""
    import torch

    dtype = getattr(torch, dtype_name)
    outs = group.run(rank16, case, shape, dtype_name, cfg, repeats, device)
    data = _inputs16(case, cfg, dtype, device)
    call = _call16(case, cfg, data)
    single = call()
    _sync(device)
    single_walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        _sync(device)
        single_walls.append(time.perf_counter() - t0)
    want_launches, want_calls = _expected16(case, shape, cfg)
    failed = []
    print(f"{tag} {case} mesh {shape} {dtype_name}, {len(outs)} rank(s):")
    if case == "forward" and shape[1] > 1:
        f = cfg["fwd"]
        print(f"  on {cfg['fwd_tp_B']} of the {f['B']} rows: the alternating layout gathers "
              f"(R, B/dp, R/tp) for each core, "
              f"{f['R'] * cfg['fwd_tp_B'] // shape[0] * f['R'] // shape[1] * 4 / 2**30:.1f} GiB "
              "a core and rank at this B, the four ranks sharing the card's memory")
    for o in outs:
        kinds = _collectives(o["collectives"])
        wall = (f"first {o['first'] * 1e3:.3f} ms, then "
                + ", ".join(f"{w * 1e3:.3f}" for w in o["walls"]) + " ms")
        print(f"  rank {o['rank']}: launches {o['launches']} (grouped tt_eval {o['grouped']}), "
              f"collectives {kinds or 'none'} (name, count, largest in elements); setup "
              f"{o['setup']:.3f} s; {wall}")
        for line in o["log"].splitlines():
            print(f"    {line}")
        if torch.device(device).type == "cuda" and o["launches"] != want_launches:
            failed.append(f"{case} {shape} rank {o['rank']}: launches {o['launches']}, "
                          f"expected {want_launches}")
        if [k for k in kinds if k[0] != "broadcast"] != want_calls:
            failed.append(f"{case} {shape} rank {o['rank']}: collectives {kinds}, "
                          f"expected {want_calls}")
        for name, n in o["launches"].items():
            total[name] = total.get(name, 0) + n
    if case != "optimize":
        slowest = [max(o["walls"][i] for o in outs) * 1e3 for i in range(repeats)]
        print(f"  wall of the call (slowest rank; ranks sharing one card, not a multi-card "
              f"number): {', '.join(f'{w:.3f}' for w in slowest)} ms; the single-process port "
              f"on the card: "
              f"{', '.join(f'{w * 1e3:.3f}' for w in single_walls)} ms")
    else:
        steps = cfg["train"]["steps"]
        print(f"  wall a step (slowest rank, {steps} steps a fit; ranks sharing one card, not a "
              "multi-card number): "
              + ", ".join(f"{max(o['walls'][i] for o in outs) / steps * 1e3:.3f}"
                          for i in range(repeats))
              + " ms; the single-process port on the card: "
              + ", ".join(f"{w / steps * 1e3:.3f}" for w in single_walls) + " ms")
    return failed + _check16(case, dtype, cfg, outs[0]["whole"], data, single, device)


def parallel_path(device="cuda", cfg=SIZES16, repeats=2, smi=None):
    """Phase 16; returns each kernel's launches in it, summed over the
    ranks. On the CPU (``device="cpu"``, a rehearsal at the small sizes
    ``cfg`` gives) 16a takes gloo, and no launches are counted."""
    import torch

    from tntorch_tpu_torch.examples import expected, multichip
    from tntorch_tpu_torch.parallel import launch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()  # the ranks share the card with this process
        smi = smi or subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    start, failed, total = time.perf_counter(), [], {}
    print(f"16: on {smi or device}; every wall below is of ranks sharing this one card, "
          "their gloo collectives through host memory: not a multi-card number")
    phase("16a. one rank, NCCL, mesh (1, 1), at full size")
    with launch.Group(1, "nccl" if cuda else "gloo", device=device) as group:
        for case in ("round", "batch", "forward", "optimize"):
            failed += report16(group, "16a", case, (1, 1), "float32", cfg, device, repeats, total)
    phase("16b. four ranks on the one card, gloo: meshes (1, 4), (2, 2), (4, 1)")
    with launch.Group(4, "gloo", device=device) as group:
        for case, shape, dtype_name in CASES16:
            failed += report16(group, "16b", case, shape, dtype_name, cfg, device, repeats,
                               total)
    phase("16c. the multichip tutorial on four ranks of the card, float32")
    t0 = time.perf_counter()
    dtype = torch.float32 if cuda else torch.float64
    out = multichip.main(device=device, dtype=dtype)
    bad = expected.check("multichip", out, dtype, capped=not cuda)
    print(f"16c multichip: wall {time.perf_counter() - t0:.3f} s (the spawn of its ranks "
          f"included); held to the JAX figures and its claims: {'ok' if not bad else bad}")
    failed += bad
    if cuda and not all(total.values()):
        failed.append(f"a kernel of the path was not launched: {total}")
    print(f"16, launches summed over the ranks: {total}; the phase "
          f"{time.perf_counter() - start:.1f} s")
    if failed:
        raise AssertionError("phase 16: " + "; ".join(failed))
    return total


# Phase 17: the last mesh= paths and the checkpoints, on four gloo ranks
# sharing the card through parallel.launch (as 16b), each case against the
# single-process port on the card, at the size of the phase it borrows
# from:
# - 'cross3' (float64 and float32): BASELINE config 3, phase 10a's 10-D sum
#   of sines on 32^10 (eps 1e-6, seed 0), fiber-parallel over dp=4;
# - 'fixed' (float32): phase 10c's fixed-rank cross of 1/sum(x) on 256^5
#   at ranks 100 (2 iterations), whose 2.56M-point fibers are where fiber
#   parallelism is real;
# - 'minimize' (float64): phase 11b's separable 5-D function on 32^5 as a
#   batch of B=8 rank-2 TTs, other shifts per sample, the batch over dp=4;
# - 'als' (float64): BASELINE config 4's ALS, phase 12a's (32^4 rank 3,
#   20,000 samples, 5 sweeps), its slice solves over dp=4;
# - 'regressor', 'ensemble', 'classifier' (float64): phase 12c's
#   TTRegressor at 2^16 samples as a plain TT (the tt_eval kernels forward
#   and backward each step; its samples over dp) and as an 8-member DCT
#   ensemble (its members over dp), and the 4-member TTClassifier ensemble
#   on the Swiss roll, steps[...] steps each;
# - 'checkpoint' (float32): phase 14b's B=32 ensemble (1 GiB) batch-sharded
#   over dp=4 (8 TTs a rank): save_orbax_sharded, load_orbax_sharded onto
#   the mesh, then round_tt_batch_sharded of the restored shards (phase
#   16b's batch case); the single process saves and loads the same ensemble
#   by save_orbax/load_orbax, by .npz, and loads the sharded checkpoint
#   without a mesh.
SIZES17 = dict(cross3=CROSS3, fixed=CROSS_FIXED, separable=dict(N=5, I=32, B=8), als=ALS4,
               learn=dict(P=LEARN["regressor_P"], nticks=64, clf_nticks=128, ranks_tt=10,
                          ranks_tucker=8, clf_tucker=6, members=8, clf_members=4),
               steps=dict(regressor=40, ensemble=40, classifier=60), round=BENCH)
CASES17 = (("cross3", "float64"), ("cross3", "float32"), ("fixed", "float32"),
           ("cross3f", "float64"), ("minimize", "float64"), ("minimize1", "float64"),
           ("als", "float64"), ("regressor", "float64"),
           ("ensemble", "float64"), ("classifier", "float64"), ("checkpoint", "float32"))
# Tolerances of phase 17, each with its reason:
# - the crosses against the single process on the card: each rank evaluates
#   the function on its chunk of a step's fibers, and every rank then runs
#   the same QR, maxvol and solves on the gathered values, which are the
#   single process's bitwise (an elementwise function of the same inputs):
#   the rank schedule, the sample count and every rank's index sets equal,
#   the approximations within 1e-12 (float64) and 1e-5 (float32, CROSS_F32_TOL)
#   relative in norm (`_f64_dist`), and config 3's val_eps below 1e-6;
# - the batched minimize: the same per-sample crosses as the single
#   process, minima and argmins equal, and within MIN_OPT_TOL of the dense
#   optimum;
# - ALS: each rank solves its slices with the single process's operations,
#   so only the gathered slices' layout differs: 1e-10 relative (the float64
#   reconstructions);
# - the learners: the predictions within rtol 1e-6 and atol 1e-9 of the
#   single process (the JAX package's own limit, tests/test_parallel.py:
#   294-321): the loss is summed over the ranks in another order;
# - the checkpoints: bitwise (the same bytes written and read), and the
#   restored shards' rounding bitwise equal to that of the shards placed
#   before saving.
ALS17_TOL = 1e-10
CROSS17_TOL = {"float64": 1e-12, "float32": CROSS_F32_TOL}
PRED17_RTOL, PRED17_ATOL = 1e-6, 1e-9


def _separable17(cfg, device):
    """11b's separable function sum_n (x_n - s_n)^2 on [-1, 1]^N (I points a
    mode) as a batch of B rank-2 TTs, the shifts s drawn per sample; and
    its terms g (B x N x I, NumPy): each sample's dense optimum is the sum
    of its terms' optima, at their coordinates."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    B, N, I = cfg["B"], cfg["N"], cfg["I"]
    grid = np.linspace(-1, 1, I)
    g = (grid[None, None, :] - np.random.default_rng(17).uniform(-0.9, 0.9, (B, N))[..., None]) ** 2
    one, zero = np.ones((B, I)), np.zeros((B, I))
    cores = [np.stack([g[:, 0], one], axis=-1)[:, None]]  # (B, 1, I, 2): [g_0, 1]
    for n in range(1, N - 1):  # [[1, 0], [g_n, 1]]
        cores.append(np.stack([np.stack([one, zero], -1), np.stack([g[:, n], one], -1)], 1))
    cores.append(np.stack([one, g[:, -1]], axis=1)[..., None])  # (B, 2, I, 1): [1; g_last]
    t = tn.Tensor([torch.from_numpy(c).to(device) for c in cores], batch=True)
    return t, g


def _case17(case, dtype_name, cfg, device, mesh=None):
    """One case of phase 17 on ``device``: the data, placed first where the
    case places any, and the call, the sharded entry point over ``mesh`` or
    without a mesh the single process. The call returns the host results
    that `_check17` compares."""
    import numpy as np
    import torch

    import tntorch_tpu_torch as tn

    dtype = getattr(torch, dtype_name)
    kw = {} if mesh is None else dict(mesh=mesh)

    def sets(info):
        return {k: [np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in info[k]]
                for k in ("lsets", "rsets", "left_locals")}

    if case in ("cross3", "cross3f", "fixed"):
        # cross3f: config 3 on the fused sweep (True: fused on the CPU too)
        c = cfg["cross3" if case == "cross3f" else case]
        f = _hilbert if case == "fixed" else _sines

        def call():
            t, info, _ = _cross(c, f, dtype, device=None if device == "cuda" else device,
                                fuse=case == "cross3f", **kw)
            return dict(cores=[x.double().cpu() for x in t.cores], Rs=[int(r) for r in info["Rs"]],
                        nsamples=info["nsamples"], val_eps=info["val_eps"],
                        iters=len(info["val_epss"]), sets=sets(info))
        return call
    if case in ("minimize", "minimize1"):
        # the per-sample crosses (fuse=False), or the one stream (fuse=True)
        t, g = _separable17(cfg["separable"], device)
        fuse = case == "minimize1"

        def call():
            m = tn.minimum(t, seed=0, fuse=fuse, **kw)
            return dict(min=m.cpu().numpy(), argmin=tn.argmin(t, seed=0, fuse=fuse, **kw),
                        dense=g.min(-1).sum(-1))
        return call
    if case == "als":
        A = cfg["als"]
        shape, gt_cores, x0_cores, X, _ = _als_problem(A)
        gt = _tensor(gt_cores, dtype, device)
        y = gt[X].full()

        def call():
            with _default_dtype(dtype_name):
                t, eps = tn.als_completion(X, y, ranks_tt=A["R"], shape=shape,
                                           x0=_tensor(x0_cores, dtype, device), niter=A["niter"],
                                           verbose=False, _return_eps=True, **kw)
            return dict(full=t.full().cpu(), eps=eps)
        return call
    L, steps = cfg["learn"], cfg["steps"][case]
    common = dict(key=0, device=device, max_iter=steps - 1, tol=0.0, **kw)
    adam2 = dict(optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2))
    if case == "regressor":
        X, y = _smooth_data(L["P"])
        make = lambda: tn.TTRegressor(nticks=L["nticks"], ranks_tt=L["ranks_tt"],  # noqa: E731
                                      ranks_tucker=None, **adam2, **common)
        Xt = X[::64]
    elif case == "ensemble":
        X, y = _smooth_data(L["P"])
        make = lambda: tn.TTRegressor(nticks=L["nticks"], ranks_tt=L["ranks_tt"],  # noqa: E731
                                      ranks_tucker=L["ranks_tucker"], n_estimators=L["members"],
                                      **adam2, **common)
        Xt = X[::64]
    else:
        Xs, ys, ntrain = _spiral_data()
        X, y, Xt = Xs[:ntrain], ys[:ntrain], Xs[ntrain:]
        make = lambda: tn.TTClassifier(nticks=L["clf_nticks"], ranks_tt=L["ranks_tt"],  # noqa: E731
                                       ranks_tucker=L["clf_tucker"], n_estimators=L["clf_members"],
                                       **common)

    def call():
        with _default_dtype(dtype_name):
            lrn = make().fit(X, y)
            pred = lrn.predict_proba(Xt) if case == "classifier" else lrn.predict(Xt)
        return dict(losses=lrn.losses_, pred=pred.cpu().numpy())
    return call


def _checkpoint17(cfg, device, mesh, path):
    """17d on a rank: the ensemble batch-sharded over dp (rank 0's copy),
    save_orbax_sharded to ``path`` and load_orbax_sharded onto the mesh
    (walls), the restored shards against the placed ones, and
    round_tt_batch_sharded of the restored shards (recorded: launches and
    collectives counted by the caller) and of the placed ones. Returns the
    call to record and what to print."""
    import torch
    import torch.distributed as dist

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch import parallel as par

    cores = bench_cores(cfg["round"])
    placed = par.shard_batch(tn.Tensor([torch.from_numpy(c).to(device) for c in cores],
                                       batch=True), mesh)
    del cores
    dist.barrier()
    t0 = time.perf_counter()
    tn.save_orbax_sharded(placed, path)
    _sync(device)
    save = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    back = tn.load_orbax_sharded(path, mesh=mesh)
    _sync(device)
    load = time.perf_counter() - t0
    same = all(list(a.placements) == list(b.placements) and torch.equal(a.to_local(), b.to_local())
               for a, b in zip(back.cores, placed.cores)) and back.batch
    rmax = cfg["round"]["rmax"]
    ref = par.round_tt_batch_sharded(placed.cores, rmax, mesh)

    def call():
        out = par.round_tt_batch_sharded(back.cores, rmax, mesh)
        return dict(equal=all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(out, ref)),
                    restored=same, save=save, load=load,
                    MiB=sum(c.to_local().numel() * 4 for c in placed.cores) / 2 ** 20)
    return call


def rank17(case, dtype_name, cfg, repeats, device, path):
    """One case of phase 17 on this rank of the running process group: its
    data and mesh (dp over every rank), one recorded call (each kernel's
    launches, every collective with its size, the Gram and tt_eval calls),
    then ``repeats`` timed calls, each after a barrier, then the recorded
    kernel calls held to their plain versions. Returns the counts, the
    walls, what the rank printed and its results."""
    import io

    import torch.distributed as dist

    from tntorch_tpu_torch import parallel as par
    from tntorch_tpu_torch.ops import gram_kernels as gk
    from tntorch_tpu_torch.ops import tt_eval as te

    rank, log = dist.get_rank(), io.StringIO()
    with contextlib.redirect_stdout(log):
        mesh = par.make_mesh((dist.get_world_size(), 1), device=device)
        t0 = time.perf_counter()
        if case == "checkpoint":
            call = _checkpoint17(cfg, device, mesh, path)
        else:
            call = _case17(case, dtype_name, cfg, device, mesh)
        _sync(device)
        setup = time.perf_counter() - t0
        gram_calls, tt_calls = [], []
        dist.barrier()
        gk.reset_launches()
        te.reset_launches()
        with par.counting_collectives() as calls, recording_gram(gram_calls), \
                recording_tt_eval(tt_calls):
            t0 = time.perf_counter()
            out = call()
            _sync(device)
            first = time.perf_counter() - t0
        launches = {**{k.__name__: k.launches for k in gk.KERNELS},
                    **{k.__name__.replace("_kernel", ""): k.launches for k in te.KERNELS}}
        walls = []
        for _ in range(repeats if case != "checkpoint" else 0):
            dist.barrier()
            t0 = time.perf_counter()
            call()
            _sync(device)
            walls.append(time.perf_counter() - t0)
        if gram_calls:
            hold_gram_calls(f"17 {case} rank {rank}", gram_calls)
        if tt_calls:
            hold_tt_eval_calls(f"17 {case} rank {rank}", tt_calls, [case] * len(tt_calls))
    if rank:  # rank 0's approximation stands for all: their index sets are compared
        out.pop("cores", None)
    return dict(rank=rank, launches=launches, collectives=calls, setup=setup, first=first,
                walls=walls, log=log.getvalue(), out=out)


def _expected17(case, cfg, out, world):
    """A rank's launches of each kernel (None: some tt_eval launches) and
    its collectives (name, count, largest size; a size of None is not
    checked) in one call of a case, from what the call reports (``out``:
    a cross's ranks and iterations)."""
    none = {"gram_edge": 0, "wgram": 0, "proj2": 0, "tt_eval": 0, "tt_eval_backward": 0}
    if case in ("cross3", "cross3f", "fixed"):
        c = cfg["cross3" if case == "cross3f" else case]
        N, I, iters = c["N"], c["I"], out["iters"]
        if case == "cross3f":  # every iteration the chunks ran, speculative ones too
            iters = _chunk_runs(iters, c.get("max_iter", 25))
        # one validation evaluation per input and per iteration; every step's
        # fibers (a multiple of I points) divide over the ranks
        P = max(out["Rs"][n] * I * out["Rs"][n + 1] for n in range(N))
        return {**none, "tt_eval": N + iters}, [("all_gather", (2 * N - 1) * iters,
                                                  None if case == "cross3f" else P)]
    if case == "minimize":
        B, N = cfg["separable"]["B"], cfg["separable"]["N"]
        return None, [("all_gather", 4, B * N)]  # minimum's and argmin's
    if case == "minimize1":  # a chunk's read each (10 iterations: 2), then the minima, argmins
        return None, [("all_gather", 2 * (2 + 2), None)]
    if case == "als":
        A = cfg["als"]
        N, I, R = A["N"], A["I"], A["R"]
        return none, [("all_gather", (2 * N - 2) * A["niter"], -(-I // world) * world * R * R),
                      ("all_reduce", A["niter"], 1), ("broadcast", N, I * R * R)]
    if case == "checkpoint":  # the rounding of the restored shards
        return {**none, "gram_edge": 2, "wgram": 2, "proj2": 2}, []
    # the rows' two broadcasts and the 4 parameters' replication, then one
    # all-reduce a gradient and one of the loss a step
    steps = cfg["steps"][case]
    calls = [("all_reduce", 5 * steps, None), ("broadcast", 6, None)]
    if case == "regressor":  # a step's forward and backward; then predict's forward
        return {**none, "tt_eval": steps + 1, "tt_eval_backward": steps}, calls
    return none, calls


def _calls_match(kinds, want):
    """Whether the collectives ``kinds`` ((name, count, largest), by name)
    are ``want``'s, where a largest size of None matches any."""
    want = sorted(want, key=lambda c: c[0])
    return len(kinds) == len(want) and all(
        k[:2] == w[:2] and (w[2] is None or k[2] == w[2]) for k, w in zip(kinds, want))


def _check17(case, dtype_name, cfg, outs, single):
    """The failures of a case's results on the ranks (``outs``) against the
    single process's ``single``; prints each distance."""
    import numpy as np

    failed, got = [], outs[0]["out"]
    if case in ("cross3", "cross3f", "fixed"):
        tol = CROSS17_TOL[dtype_name]
        same = all(o["out"]["Rs"] == single["Rs"] and o["out"]["nsamples"] == single["nsamples"]
                   for o in outs)
        sets = all(all(np.array_equal(a, b) for a, b in zip(o["out"]["sets"][k], single["sets"][k]))
                   and len(o["out"]["sets"][k]) == len(single["sets"][k])
                   for o in outs for k in single["sets"])
        err = _f64_dist(got["cores"], single["cores"])
        eps_tol = CROSS_FIXED_TOL if case == "fixed" else cfg["cross3"]["eps"]
        print(f"  ranks {got['Rs']}, {got['nsamples']} f-evals, {got['iters']} iterations, "
              f"val_eps {got['val_eps']:.3e} (tol {eps_tol}); the single process: ranks "
              f"{single['Rs']}, {single['nsamples']} f-evals, val_eps {single['val_eps']:.3e}; "
              f"rank schedule and samples equal on every rank: {same}; every rank's lsets, rsets "
              f"and left_locals equal to the single process's: {sets}; approximation vs the "
              f"single process: rel {err:.3e} (tol {tol})")
        if not (same and sets and err <= tol and got["val_eps"] <= eps_tol):
            failed.append(f"{case} {dtype_name}: schedule {same}, sets {sets}, rel {err:.3e}, "
                          f"val_eps {got['val_eps']:.3e}")
    elif case in ("minimize", "minimize1"):
        equal = all(np.array_equal(o["out"]["min"], single["min"])
                    and o["out"]["argmin"] == single["argmin"] for o in outs)
        opt = float(np.abs(got["min"] - got["dense"]).max())
        print(f"  minima {got['min'].tolist()}; equal with their argmins to the single process's "
              f"on every rank: {equal}; vs the dense optima: max |diff| {opt:.3e} "
              f"(tol {MIN_OPT_TOL})")
        if not (equal and opt <= MIN_OPT_TOL):
            failed.append(f"minimize: equal {equal}, off the optimum by {opt:.3e}")
    elif case == "als":
        err = max(rel(o["out"]["full"], single["full"]) for o in outs)
        print(f"  training eps {got['eps']:.6e} (single process {single['eps']:.6e}); dense "
              f"reconstruction vs the single process: rel {err:.3e} (tol {ALS17_TOL}), the "
              "worst rank")
        if not err <= ALS17_TOL:
            failed.append(f"als: rel {err:.3e}")
    elif case == "checkpoint":
        ok = all(o["out"]["restored"] and o["out"]["equal"] for o in outs)
        print("  per rank: " + "; ".join(
            f"rank {o['rank']} save_orbax_sharded {o['out']['save'] * 1e3:.1f} ms, "
            f"load_orbax_sharded {o['out']['load'] * 1e3:.1f} ms ({o['out']['MiB']:.0f} MiB)"
            for o in outs)
              + f"; restored shards and placements equal, and their rounding bitwise equal to "
              f"the placed shards': {ok}")
        if not ok:
            failed.append("checkpoint: the restored shards or their rounding differ")
    else:
        pred = np.abs(got["pred"] - single["pred"])
        ok = all(np.allclose(o["out"]["pred"], single["pred"], rtol=PRED17_RTOL,
                             atol=PRED17_ATOL) for o in outs)
        loss = float(np.max(np.abs(np.array(got["losses"]) - single["losses"])
                            / np.abs(single["losses"])))
        print(f"  {len(got['losses'])} steps, loss {got['losses'][0]:.6g} -> "
              f"{got['losses'][-1]:.6g}; losses vs the single process: max rel {loss:.3e}; "
              f"predictions: max |diff| {float(pred.max()):.3e} (rtol {PRED17_RTOL}, atol "
              f"{PRED17_ATOL}) on every rank: {ok}")
        if not (ok and got["losses"][-1] < got["losses"][0]):
            failed.append(f"{case}: predictions off the single process's, or the loss did not "
                          "fall")
    return failed


def report17(group, case, dtype_name, cfg, device, repeats, total, path):
    """One case of phase 17 on every rank of ``group`` against the single
    process; adds its launches to ``total`` and returns its failures."""
    import torch

    outs = group.run(rank17, case, dtype_name, cfg, repeats, device, path)
    print(f"17 {case} {dtype_name}, dp={len(outs)}:")
    failed = []
    for o in outs:
        kinds = _collectives(o["collectives"])
        want_launches, want_calls = _expected17(case, cfg, o["out"], len(outs))
        wall = (f"first {o['first'] * 1e3:.1f} ms"
                + (", then " + ", ".join(f"{w * 1e3:.1f}" for w in o["walls"]) + " ms"
                   if o["walls"] else ""))
        print(f"  rank {o['rank']}: launches {o['launches']}, collectives {kinds or 'none'} (name, "
              f"count, largest in elements); setup {o['setup']:.3f} s; {wall}")
        for line in o["log"].splitlines():
            print(f"    {line}")
        if torch.device(device).type == "cuda":
            if want_launches is not None and o["launches"] != want_launches:
                failed.append(f"{case} rank {o['rank']}: launches {o['launches']}, expected "
                              f"{want_launches}")
            if want_launches is None and not o["launches"]["tt_eval"]:
                failed.append(f"{case} rank {o['rank']}: no tt_eval launch")
        if not _calls_match(kinds, want_calls):
            failed.append(f"{case} rank {o['rank']}: collectives {kinds}, expected "
                          f"{want_calls}")
        for name, n in o["launches"].items():
            total[name] = total.get(name, 0) + n
    if case == "checkpoint":
        return failed + _check17(case, dtype_name, cfg, outs, None)
    call = _case17(case, dtype_name, cfg, device)
    single = call()
    _sync(device)
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        _sync(device)
        walls.append(time.perf_counter() - t0)
    slowest = [max(o["walls"][i] for o in outs) * 1e3 for i in range(repeats)]
    print(f"  wall (slowest rank; ranks sharing one card, not a multi-card number): "
          f"{', '.join(f'{w:.1f}' for w in slowest)} ms; the single process on the card: "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms")
    return failed + _check17(case, dtype_name, cfg, outs, single)


def _whole_checkpoints17(cfg, device, path):
    """17d in the single process: the ensemble by save_orbax/load_orbax and
    by save/load (.npz), walls and bitwise equality, and the ranks'
    sharded checkpoint at ``path`` loaded without a mesh, bitwise."""
    import tempfile

    import torch

    import tntorch_tpu_torch as tn

    t = tn.Tensor([torch.from_numpy(c).to(device) for c in bench_cores(cfg["round"])],
                  batch=True)
    failed, walls = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, save, load, where in (
                ("save_orbax/load_orbax", tn.save_orbax, tn.load_orbax, "orbax"),
                ("save/load (.npz)", tn.save, tn.load, "t.npz"),
                ("load_orbax_sharded without a mesh", None, tn.load_orbax_sharded, None)):
            target = os.path.join(tmp, where) if where else path
            _sync(device)
            t0 = time.perf_counter()
            if save is not None:
                save(t, target)
            t1 = time.perf_counter()
            back = load(target, device=device)
            _sync(device)
            t2 = time.perf_counter()
            same = back.batch and all(a.device == b.device and torch.equal(a, b)
                                      for a, b in zip(back.cores, t.cores))
            walls[name] = ((t1 - t0) if save else None, t2 - t1)
            print(f"17 checkpoint, the single process: {name}: "
                  + (f"save {(t1 - t0) * 1e3:.1f} ms, " if save else "")
                  + f"load {(t2 - t1) * 1e3:.1f} ms, loaded bitwise equal: {same}")
            if not same:
                failed.append(f"checkpoint {name}: the loaded ensemble differs")
            del back
    return failed


def mesh_paths_path(device="cuda", cfg=SIZES17, repeats=1, smi=None):
    """Phase 17; returns each kernel's launches in it, summed over the
    ranks. On the CPU (``device="cpu"``, a rehearsal at the small sizes
    ``cfg`` gives) no launches are counted."""
    import tempfile

    import torch

    from tntorch_tpu_torch.parallel import launch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()  # the ranks share the card with this process
        smi = smi or subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    start, failed, total = time.perf_counter(), [], {}
    print(f"17: on {smi or device}; every wall below is of ranks sharing this one card, their "
          "gloo collectives through host memory: not a multi-card number")
    with tempfile.TemporaryDirectory() as tmp, launch.Group(4, "gloo", device=device) as group:
        path = os.path.join(tmp, "sharded")
        for case, dtype_name in CASES17:
            phase(f"17 {case} {dtype_name} on four ranks of the card, gloo, mesh (4, 1)")
            failed += report17(group, case, dtype_name, cfg, device, repeats, total, path)
        failed += _whole_checkpoints17(cfg, device, path)
    if cuda and not all(total.values()):
        failed.append(f"a kernel of the path was not launched: {total}")
    print(f"17, launches summed over the ranks: {total}; the phase "
          f"{time.perf_counter() - start:.1f} s")
    if failed:
        raise AssertionError("phase 17: " + "; ".join(failed))
    return total


# ---------------------------------------------------------------------------
# Phase 18: the fused cross tier (cross(fuse="auto") on the card: chunks of
# 6, then 4, iterations with one read each) on the maxvol kernels, each run
# against the same call on the eager sweep (fuse=False), in turns:
# - BASELINE config 3 (10a's 10-D sines on 32^10, eps 1e-6), float64 and
#   float32; 10b's 5-D Hilbert tensor on 32^5; 10c's fixed-rank 256^5 cross
#   at ranks 100 (2 iterations: one chunk), float32 and float64, whose
#   25600 x 100 Q take the resident grid of the swap kernel;
# - 11b's minimizing cross of the separable 5-D function on 32^5;
# - tn.exp on config 1's size (11a's input 1.5 + u), float32.
# The grids' axes are on the card before each call, so every host sync
# that CUDA's sync debug mode sees in a counted run is the sweep's own.
# Tolerances of phase 18: the crosses' existing ones (10a-10c: the
# reported validation error below eps, the held-out error within
# CROSS_F32_TOL in float32 and eps in float64, 10c's CROSS_FIXED_TOL and
# CROSS_FIXED_F64_TOL); the minimizing cross within MIN_OPT_TOL of the
# dense optimum; tn.exp within FAMILY_TOL of the dense exp; the maxvol
# kernels against their plain versions: rows equal, C within MAXVOL_TOL
# (the update rounds as the plain version's, so equal rows leave only the
# argmax reduction's order, which the total order makes exact: 0 in a
# float64 rehearsal of the same arithmetic).
SIZES18 = dict(cross3=CROSS3, hilbert=HILBERT5, fixed=CROSS_FIXED, separable=SEPARABLE,
               exp=CONFIG1, turns=2)


def _chunks(iters):
    """The reads of a fused run that kept ``iters`` iterations: chunks of
    6, then 4 (cross._CHUNK_DEPTH_FIRST, _CHUNK_DEPTH_NEXT)."""
    return 1 + max(0, -(-(iters - 6) // 4))


def _chunk_runs(kept, max_iter):
    """The iterations a fused run ran, speculative ones included, to keep
    ``kept``: chunks of 6, then 4, up to ``max_iter``."""
    ran = 0
    while ran < kept:
        ran += min(6 if ran == 0 else 4, max_iter - ran)
    return ran


def _axes_on(cfg, dtype, device):
    """``cfg``'s grid axes as tensors on ``device``."""
    import torch

    return [torch.tensor(a, dtype=dtype, device=device) for a in _axes(cfg)]


def _fused_call(cfg, f, dtype, device, fuse, axes=None):
    """The cross of phase 18 on ``cfg``'s grid in ``dtype``, its axes put
    on ``device`` first (or ``axes``, already there): its result, info and
    wall (s), ending in a synchronize."""
    import torch

    import tntorch_tpu_torch as tn

    args = {k: cfg[k] for k in ("eps", "seed", "ranks_tt", "max_iter") if k in cfg}
    axes = _axes_on(cfg, dtype, device) if axes is None else axes
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        _sync(device)
        t0 = time.perf_counter()
        t, info = tn.cross(function=f, domain=axes, verbose=False, return_info=True,
                           suppress_warnings=True, fuse=fuse, **args)
        _sync(device)
        return t, info, time.perf_counter() - t0
    finally:
        torch.set_default_dtype(prev)


def recording_maxvol(qs):
    """A context in which every `maxvol_device` call of the cross module
    keeps a copy of its Q in ``qs`` by (n, r, dtype, max_iters), the first
    call of each shape."""
    import importlib

    cr = importlib.import_module("tntorch_tpu_torch.cross")

    @contextlib.contextmanager
    def ctx():
        maxvol_device = cr.maxvol_device

        def spy(Q, tol=1.05, max_iters=100):
            key = (tuple(Q.shape), str(Q.dtype)[6:], max_iters)
            qs.setdefault(key, Q.detach().clone())
            return maxvol_device(Q, tol, max_iters)

        cr.maxvol_device = spy
        try:
            yield
        finally:
            cr.maxvol_device = maxvol_device

    return ctx()


def _turns18(call, turns):
    """``call(fuse)`` for fuse "auto" (the card; True on the CPU) and False
    in turns (fused, eager, eager, fused, ...): each one's walls and the
    last result of each."""
    walls, last = {"fused": [], "eager": []}, {}
    for k in range(turns):
        for name in (("fused", "eager") if k % 2 == 0 else ("eager", "fused")):
            out = call(name)
            walls[name].append(out[-1])
            last[name] = out
    return walls, last


def fused_cross_checks(name, cfg, f, exact, dtypes, tols, device, turns, failed):
    """18a-c: one configuration's crosses, fused against eager in turns, in
    each of ``dtypes``: val_eps within ``tols[dtype][0]``, the held-out
    error against ``exact`` within ``tols[dtype][1]``, float64 ranks,
    samples and iterations equal to the eager run's, and ``fused`` set.
    Returns the reads to count (tag, cfg, f, dtype) and nothing else."""
    import torch

    fuse = "auto" if torch.device(device).type == "cuda" else True
    X = _held_out(cfg, HELD_OUT, device)
    want = exact(torch.tensor(_axes(cfg)[0], device=device), X)
    for dtype in dtypes:
        dname = str(dtype)[6:]
        walls, last = _turns18(
            lambda which: _fused_call(cfg, f, dtype, device, fuse if which == "fused" else False),
            turns)
        (t, info, _), (te_, einfo, _) = last["fused"], last["eager"]
        err = rel(t[X].full().double(), want)
        Rs, eRs = [int(r) for r in info["Rs"]], [int(r) for r in einfo["Rs"]]
        its = len(info["val_epss"])
        rate = {k: last[k][1]["nsamples"] / last[k][2] for k in last}
        print(f"18 {name}, {dname}: fused {info['fused']}, {its} iterations in {_chunks(its)} "
              f"chunk(s), ranks {Rs}, {info['nsamples']} f-evals, val_eps {info['val_eps']:.3e}, "
              f"held-out rel err {err:.3e}; eager: {len(einfo['val_epss'])} iterations, ranks "
              f"{eRs}; walls in turns (ms) fused {[round(w * 1e3, 1) for w in walls['fused']]}, "
              f"eager {[round(w * 1e3, 1) for w in walls['eager']]}; second calls' f-evals/s "
              f"fused {rate['fused']:.4g}, eager {rate['eager']:.4g}")
        eps_tol, held_tol = tols[dname]
        if not info["fused"] or einfo["fused"]:
            failed.append(f"18 {name} {dname}: fused {info['fused']}, eager {einfo['fused']}")
        if not info["val_eps"] <= eps_tol or not err <= held_tol:
            failed.append(f"18 {name} {dname}: val_eps {info['val_eps']:.3e}, held-out {err:.3e}")
        if dtype == torch.float64 and (Rs, info["nsamples"], its) != (
                eRs, einfo["nsamples"], len(einfo["val_epss"])):
            failed.append(f"18 {name} float64: the fused run's schedule differs from the eager "
                          "run's")
    return [(name, cfg, f, dtypes[-1])]


def fused_minimize_checks(device, cfg, turns, failed):
    """18d: the minimizing cross of 11b's separable function, fused and
    eager in turns: both within MIN_OPT_TOL of the dense optimum, with
    equal minima and argmins."""
    import torch

    import tntorch_tpu_torch as tn

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # meshgrid's dtype
    try:
        shifts = SEPARABLE["shifts"][:cfg["N"]]
        grid = torch.linspace(-1, 1, cfg["I"], dtype=torch.float64)
        tensors = tn.meshgrid([grid] * cfg["N"], device=device)

        def f(*xs):
            return sum((x - s) ** 2 for x, s in zip(xs, shifts))

        dense = float(sum(((grid - s) ** 2).min() for s in shifts))
        fuse = "auto" if torch.device(device).type == "cuda" else True

        def call(which):
            _sync(device)
            t0 = time.perf_counter()
            _, info = tn.cross(function=f, tensors=tensors, rmax=10, max_iter=10, verbose=False,
                               seed=0, return_info=True, _minimize=True,
                               fuse=fuse if which == "fused" else False)
            _sync(device)
            return info, time.perf_counter() - t0

        walls, last = _turns18(call, turns)
        info, einfo = last["fused"][0], last["eager"][0]
        at = float(f(*[grid[c] for c in info["argmin"]]))
        print(f"18 minimize, separable {cfg['N']}-D on {cfg['I']}^{cfg['N']}: fused "
              f"{info['fused']}, minimum {info['min']:.15g} at {info['argmin']} (f there "
              f"{at:.15g}); "
              f"eager {einfo['min']:.15g} at {einfo['argmin']}; dense {dense:.15g}; walls in turns "
              f"(ms) fused {[round(w * 1e3, 1) for w in walls['fused']]}, eager "
              f"{[round(w * 1e3, 1) for w in walls['eager']]}")
        if not info["fused"] or not all(abs(v - dense) <= MIN_OPT_TOL
                                        for v in (info["min"], at, einfo["min"])):
            failed.append("18 minimize: the optimum was missed or the run was not fused")
        if (info["min"], info["argmin"]) != (einfo["min"], einfo["argmin"]):
            failed.append("18 minimize: the fused and eager minima differ")
        return tensors, f
    finally:
        torch.set_default_dtype(prev)


def fused_exp_checks(device, cfg, turns, failed):
    """18e: ``tn.exp`` of 11a's input 1.5 + u on config 1's size, float32,
    fused (its default on the card) against ``fuse=False`` in turns, each
    within FAMILY_TOL of the dense exp."""
    import torch

    import tntorch_tpu_torch as tn

    pos = 1.5 + _unit_tt(0, torch.float32, device)
    want = torch.exp(pos.full())
    fuse = "auto" if torch.device(device).type == "cuda" else True

    def call(which):
        _sync(device)
        t0 = time.perf_counter()
        out, info = tn.exp(pos, seed=0, return_info=True, fuse=fuse if which == "fused" else False)
        _sync(device)
        return out, info, time.perf_counter() - t0

    walls, last = _turns18(call, turns)
    for which in ("fused", "eager"):
        out, info, sec = last[which]
        err = rel(out.full(), want)
        print(f"18 tn.exp, {which}: fused {info['fused']}, {len(info['val_epss'])} iterations, "
              f"ranks {[int(r) for r in info['Rs']]}, {info['nsamples']} f-evals, rel err vs dense "
              f"{err:.2e} (tol {FAMILY_TOL}); walls in turns (ms) "
              f"{[round(w * 1e3, 1) for w in walls[which]]}, {info['nsamples'] / sec:.4g} "
              "f-evals/s (second call)")
        if not err <= FAMILY_TOL or info["fused"] != (which == "fused"):
            failed.append(f"18 tn.exp {which}: rel err {err:.3e}, fused {info['fused']}")
    return pos


def count_reads18(device, counted, failed):
    """18f: each counted run (tag, run returning an info) under CUDA's sync
    debug mode: host syncs outside maxvol_device equal to the chunks the
    run read (one each), none inside it."""
    parts = []
    for tag, run in counted:
        info, counts, where = counted_maxvol(run)
        chunks = _chunks(len(info["val_epss"]))
        parts.append(f"{tag}: {len(info['val_epss'])} iterations, {chunks} chunk(s), "
                     f"{counts['outside']} host reads ({where}), {counts['calls']} maxvol calls "
                     f"with {counts['inside']} syncs, lu_rows {counts['lu_rows']}, maxvol_swaps "
                     f"{counts['maxvol_swaps']} launches")
        if counts["outside"] != chunks or counts["inside"] or not counts["maxvol_swaps"]:
            failed.append(f"18 reads, {tag}: {counts}, {chunks} chunk(s)")
    print("18, host reads per fused run (one per chunk): " + "; ".join(parts))


def _sms():
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def swap_route(n, r, item, plan=None):
    """The swap kernel's (route, CTAs) for C (n x r): ``plan`` if forced,
    else ``_swap_plan``'s on this card (a package without ``_swap_plan``,
    as 18p may be given, picks its own)."""
    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    if plan:
        return tuple(plan)
    return mk._swap_plan(n, r, item, _sms()) if hasattr(mk, "_swap_plan") else ("its own", "its")


@contextlib.contextmanager
def forced_plan(plan):
    """``maxvol_swaps`` on the (route, CTAs) ``plan`` while the block runs,
    by replacing ``_swap_plan``, which the wrapper looks up at each call
    (None: the planned route)."""
    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    planned = getattr(mk, "_swap_plan", None)
    if plan:
        mk._swap_plan = lambda *shape: tuple(plan)
    try:
        yield
    finally:
        if plan:
            mk._swap_plan = planned


def last_n(route, r, item):
    """The most rows of r columns that ``_swap_plan`` sends to ``route``
    on this card (the routes follow each other as n grows)."""
    lo, hi = 1, 1 << 24
    order = ("cluster", "resident", "streamed")
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if order.index(swap_route(mid, r, item)[0]) <= order.index(route):
            lo = mid
        else:
            hi = mid - 1
    return lo


def swap_input(n, r, dtype, seed=0):
    """An orthonormal Q (n x r) on the card, as the sweep gives maxvol one
    (QR of a seeded normal matrix with columns of unequal scale)."""
    import numpy as np
    import torch

    A = np.random.default_rng(seed).standard_normal((n, r)) * np.geomspace(1, 1e3, r)
    return torch.linalg.qr(torch.from_numpy(A).cuda())[0].to(dtype).contiguous()


def swap_start(Q):
    """Q's LU pivots (1 x r), their rows and C = Q inv(Q[rows]), as
    `maxvol_device` starts the swap loop."""
    import importlib

    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    mv = importlib.import_module("tntorch_tpu_torch.maxvol")
    piv = mv._lu_pivots(Q)[None]
    idx = mk.lu_rows(piv, Q.shape[0], Q.shape[1])[0].contiguous()
    return piv, idx, torch.linalg.solve_ex(Q[idx].T, Q.T)[0].T.contiguous()


def kernel_ms(fn, name, calls=10):
    """`device_ms` of the kernels named ``name``, or None where the profiler
    saw none of their launches (a session now and then records no device
    events): the kernel's own time is a figure beside the call's, not a
    check."""
    try:
        return device_ms(fn, name, calls)[0]
    except AssertionError:
        return None


def _ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def time_swaps(tag, Q, iters, plan=None):
    """``maxvol_swaps`` on Q's C (the route ``plan`` forces, else the
    planned one) in turns with its plain version by CUDA events (the call,
    less the copy of C it starts from), and the kernel's device time
    (torch.profiler); held to the plain version (rows equal, C's max
    difference); its bound by bytes (C read and written once) and
    operations (3 n r a swap). Returns the numbers."""
    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    (n, r), item = Q.shape, Q.element_size()
    piv, idx, C = swap_start(Q)
    its = swaps_needed(C, idx, iters)
    work = C.clone()
    run = lambda: mk.maxvol_swaps(work.copy_(C), idx.clone(), 1.05, iters)  # noqa: E731
    with forced_plan(plan):
        copy_ms = cuda_time(lambda: work.copy_(C))
        turns = in_turns({"kernel": run,
                          "plain": lambda: mk.maxvol_swaps_plain(C, idx, 1.05, iters)})
        ms, plain_ms = sorted(turns["kernel"])[0] - copy_ms, sorted(turns["plain"])[0]
        dev = kernel_ms(run, "swaps_")
        got_C, got_idx = mk.maxvol_swaps(C.clone(), idx.clone(), 1.05, iters)
    want_C, want_idx = mk.maxvol_swaps_plain(C, idx, 1.05, iters)
    err, same = float((got_C - want_C).abs().max()), torch.equal(got_idx, want_idx)
    bound, by = bound_ms(its * 3 * n * r, 2 * n * r * item + 2 * r * 8,
                         PEAK_FP32 if item == 4 else PEAK_FP64)
    route = swap_route(n, r, item, plan)
    print(f"18g maxvol_swaps, {tag} ({n} x {r}, {str(Q.dtype)[6:]}, {route[0]} on {route[1]} "
          f"CTAs; {its} swaps of at most {iters}): call {ms:.4f} ms (turns "
          f"{[round(t, 4) for t in turns['kernel']]}, less the copy's {copy_ms:.4f}), kernel "
          f"{_ms(dev)} of device time"
          f"{'' if dev is None else f' ({dev / max(its, 1) * 1e3:.2f} us a swap)'}, plain "
          f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({by}); rows "
          f"{'equal' if same else 'DIFFER'}, C max difference {err:.1e}")
    return dict(ms=ms, kernel_ms=dev, plain_ms=plain_ms, bound_ms=bound, bound_by=by, its=its,
                max_abs_err=err, same=same)


def time_lu_rows(tag, piv, n, k):
    """``lu_rows`` on LAPACK pivots ``piv`` (1 x npiv) for k of n rows in
    turns with its plain version (CUDA events), its kernel's device time
    (torch.profiler), and ``torch.lu_unpack``'s permutation matrix (the
    one-call yardstick), held to the plain version."""
    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    npiv = piv.shape[1]
    turns = in_turns({"kernel": lambda: mk.lu_rows(piv, n, k),
                      "plain": lambda: mk.lu_rows_plain(piv, n, k)})
    ms, plain_ms = sorted(turns["kernel"])[0], sorted(turns["plain"])[0]
    dev = kernel_ms(lambda: mk.lu_rows(piv, n, k), "lu_rows")
    same = torch.equal(mk.lu_rows(piv, n, k).cpu(), mk.lu_rows_plain(piv, n, k).cpu())
    LU = torch.zeros((n, npiv), dtype=torch.float32, device=piv.device)
    lib_ms = cuda_time(lambda: torch.lu_unpack(LU, piv[0], unpack_data=False))
    bound, by = bound_ms(0, npiv * 4 + k * 8)
    print(f"18g lu_rows, {tag} ({npiv} pivots, {k} of {n} rows): call {ms:.4f} ms, kernel "
          f"{_ms(dev)} of device time, plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}), "
          f"torch.lu_unpack's permutation matrix {lib_ms:.4f} ms; rows "
          f"{'equal' if same else 'DIFFER'}")
    return dict(ms=ms, kernel_ms=dev, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, same=same)


def hold_swap_routes(failed):
    """18g: every route of ``maxvol_swaps``, planned or forced, held to the
    plain version bitwise (rows equal, C's max difference 0), with
    ``lu_rows`` at every Q's full permutation (k = n) and its first r rows:
    at the last shape of each route and the first of the next (float32 and
    float64, r = 100), each route forced on small shapes (with CTAs left
    without rows), and ties and a NaN on every route."""
    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    sms, cases = _sms(), []
    for dtype in (torch.float32, torch.float64):
        item = torch.finfo(dtype).bits // 8
        for route in ("cluster", "resident"):
            edge = last_n(route, 100, item)
            cases += [(dtype, edge, 100, None), (dtype, edge + 1, 100, None)]
    cases += [(torch.float64, 64, 2, ("cluster", 1)), (torch.float32, 17, 5, ("cluster", 16)),
              (torch.float32, 1024, 46, None), (torch.float64, 640, 20, None),
              (torch.float64, 300, 20, ("resident", min(sms, 300))),
              (torch.float32, last_n("cluster", 100, 4), 100, ("resident", sms)),
              (torch.float32, 2000, 7, ("streamed", sms)),
              (torch.float64, 25600, 100, ("streamed", sms))]
    parts, worst = [], 0.0
    for dtype, n, r, plan in cases:
        Q = swap_input(n, r, dtype, seed=n)
        piv, idx, C = swap_start(Q)
        rows = torch.equal(mk.lu_rows(piv, n, n).cpu(), mk.lu_rows_plain(piv, n, n).cpu()) and \
            torch.equal(idx.cpu(), mk.lu_rows_plain(piv, n, r)[0].cpu())
        want_C, want_idx = mk.maxvol_swaps_plain(C.clone(), idx.clone(), 1.05, 100)
        with forced_plan(plan):
            got_C, got_idx = mk.maxvol_swaps(C.clone(), idx.clone(), 1.05, 100)
        err = float((got_C - want_C).abs().max())
        worst = max(worst, err)
        route = swap_route(n, r, Q.element_size(), plan)
        parts.append(f"{str(dtype)[6:]} {n}x{r} {route[0]}/{route[1]}{' forced' if plan else ''}"
                     f": {err:.1e}")
        if not (rows and torch.equal(got_idx, want_idx) and err == 0):
            failed.append(f"18g maxvol kernels at {n} x {r} {dtype} on {route}")
    # ties go to the lowest row-major index, a NaN ends the loop, on every route
    for plan in (("cluster", 1), ("cluster", 3), ("resident", 40), ("streamed", 40)):
        for dtype in (torch.float32, torch.float64):
            C = torch.zeros((40, 3), dtype=dtype, device="cuda")
            C[9, 0] = C[3, 1] = C[7, 2] = -5.0
            idx = torch.arange(3, device="cuda")
            want = mk.maxvol_swaps_plain(C.clone(), idx.clone(), 1.05, 1)
            with forced_plan(plan):
                got = mk.maxvol_swaps(C.clone(), idx.clone(), 1.05, 1)
            C = torch.full((40, 3), 2.0, dtype=dtype, device="cuda")
            C[5, 1], C[30, 2] = float("nan"), float("inf")
            with forced_plan(plan):
                nan = mk.maxvol_swaps(C.clone(), idx.clone(), 1.05, 10)
            if not (got[1].tolist() == [0, 3, 2] and torch.equal(got[1], want[1])
                    and torch.equal(got[0], want[0]) and torch.equal(nan[1], idx)
                    and torch.equal(nan[0].isnan(), C.isnan())):
                failed.append(f"18g ties or NaN on {plan}, {dtype}")
    torch.cuda.synchronize()
    print(f"18g, maxvol_swaps on every route against the plain version (C max difference; "
          f"ties and a NaN on 4 plans, 2 dtypes): " + "; ".join(parts))
    return worst


def swaps_needed(C, idx, iters):
    """The swaps the guarded loop makes on C (at most ``iters``) before
    max|C| <= 1.05, by the plain iteration."""
    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    eye, its = torch.eye(C.shape[1], dtype=C.dtype, device=C.device), 0
    while its < iters and bool(C.abs().max() > 1.05):
        C, idx = mk._swap(C, idx, 1.05, eye)
        its += 1
    return its


def swap_crossover():
    """18x, off by default (``--only 18x``): the cluster route on 16 CTAs
    against the resident grid (one CTA per SM), forced on the same C and
    timed in turns by the kernels' device time (torch.profiler), float32
    and float64 at r = 100: from an eighth of what 16 CTAs hold to all of
    it, and at ``_CLUSTER_MAX_BYTES`` and a quarter past it, each with its
    swaps and the time a swap. Where the grid wins sets
    ``_CLUSTER_MAX_BYTES``."""
    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    phase("18x. the swap kernel's cluster route against its resident grid, in turns")
    sms = _sms()
    for dtype in (torch.float32, torch.float64):
        item = torch.finfo(dtype).bits // 8
        edge = 16 * mk._cta_rows(100, item, 32)  # 16 CTAs full
        limit = mk._CLUSTER_MAX_BYTES // (100 * item)
        for n in sorted({edge // 8, edge // 4, limit, limit * 5 // 4, edge // 2, edge}):
            Q = swap_input(n, 100, dtype, seed=n)
            _, idx, C = swap_start(Q)
            its, work = swaps_needed(C, idx, 100), C.clone()
            plans = {"cluster": ("cluster", 16), "resident": ("resident", min(sms, n))}
            ms = {k: [] for k in plans}
            for k in list(plans) + list(plans)[::-1]:
                with forced_plan(plans[k]):
                    ms[k].append(kernel_ms(lambda: mk.maxvol_swaps(
                        work.copy_(C), idx.clone(), 1.05, 100), "swaps_", calls=5))
            best = {k: min((t for t in v if t is not None), default=None) for k, v in ms.items()}
            per = {k: "not measured" if t is None else f"{t / max(its, 1) * 1e3:.2f} us"
                   for k, t in best.items()}
            ahead = "not measured" if None in best.values() else min(best, key=best.get)
            print(f"18x {str(dtype)[6:]} {n} x 100 ({n * 100 * item / 2**20:.2f} MiB, {its} "
                  f"swaps): cluster 16 CTAs {list(map(_ms, ms['cluster']))}, resident "
                  f"{plans['resident'][1]} {list(map(_ms, ms['resident']))}; a swap: cluster "
                  f"{per['cluster']}, resident {per['resident']}; ahead: {ahead}")


# 18p's Qs (n, r, dtype): config 3's and the tutorials' small ones, the 5-D
# Hilbert cross's, 11a's 1024 x 46, the 256^5 cross's 25600 x 100
SHAPES18P = ((128, 4, "float32"), (32, 4, "float64"), (224, 7, "float64"), (320, 10, "float64"),
             (512, 16, "float64"), (1024, 46, "float32"), (25600, 100, "float32"))


def maxvol_profiles():
    """18p, off by default (``--only 18p``): 18f's profiles (`profile18`:
    the maxvol kernels' device time and share of the busy time) and the
    swap kernel at the sweep's Q shapes (`time_swaps`). To compare two
    trees on one card, copy this file into the other's checkout (for the
    parent, ``git archive`` unpacked into a directory .gitignore lists) and
    run ``--only 18p`` there and here in turns, other, this, this, other,
    one process each: each measures the package beside its file."""
    import torch

    phase("18p. the maxvol kernels in 18's profiles and at the sweep's Q shapes")
    profile18()
    for n, r, dtype in SHAPES18P:
        time_swaps("compared", swap_input(n, r, getattr(torch, dtype), seed=n), 100)


def time_maxvol_kernels(qs, failed):
    """18g: each route of ``maxvol_swaps`` timed at a shape of its own, in
    turns with its plain version: the cluster at the phase's most common
    one-CTA Q (1024 x 46) and at its last shape (16 CTAs), the resident
    grid at the 256^5 cross's 25600 x 100 Q (float32 and float64), the
    streamed grid just past the resident grid's last shape; ``lu_rows`` at
    the 25600 x 100 and 1024 x 46 Qs' pivots and at the tournament's k = n;
    then every route held bitwise (`hold_swap_routes`). Returns the
    kernels' entries of the result line (at the float32 25600 x 100 Q)."""
    import torch

    f32 = lambda k: k[1] == "float32"  # noqa: E731
    big = max((k for k in qs if f32(k)), key=lambda k: k[0][0] * k[0][1])
    big64 = max((k for k in qs if not f32(k)), key=lambda k: k[0][0] * k[0][1])
    # C, a row and a 1024-row tile in 200 KB: one CTA's shared memory
    one_cta = max((k for k in qs if f32(k) and (k[0][0] * k[0][1] + k[0][1] + 1024) * 4
                   <= 200 * 1024), key=lambda k: k[0][0] * k[0][1])
    swaps = {}
    for tag, key in (("the sweep's largest Q", big), ("the sweep's float64 largest Q", big64),
                     ("the sweep's largest one-CTA Q", one_cta)):
        swaps[tag] = time_swaps(tag, qs[key], key[2])
    for tag, route in (("16 CTAs", "cluster"), ("past the resident grid", "resident")):
        n = last_n(route, 100, 4) + (route == "resident")
        swaps[tag] = time_swaps(tag, swap_input(n, 100, torch.float32, seed=1), 100)
    lus = {}
    for tag, key in (("the largest Q", big), ("the one-CTA Q", one_cta)):
        piv = swap_start(qs[key])[0]
        lus[tag] = time_lu_rows(tag, piv, *qs[key].shape)
        lus[tag + ", whole"] = time_lu_rows(tag + ", whole", piv, qs[key].shape[0],
                                            qs[key].shape[0])
    n, r = big[0]
    m = -(-n // max(r, (1 << 20) // r))  # the tournament's blocks: its last LU is m r x r
    piv = swap_start(swap_input(m * r, r, torch.float32, seed=2))[0]
    lus["tournament"] = time_lu_rows("the tournament's last LU", piv, m * r, m * r)
    if not all(v["same"] for v in list(swaps.values()) + list(lus.values())) or \
            any(v["max_abs_err"] for v in swaps.values()):
        failed.append("18g: a maxvol kernel differs from its plain version")
    worst = hold_swap_routes(failed)
    keys = ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")
    sw, lu = swaps["the sweep's largest Q"], lus["the largest Q"]
    return {"maxvol_swaps": {"max_abs_err": max(worst, sw["max_abs_err"]), "library_ms": None,
                             **{k: sw[k] for k in keys}},
            "lu_rows": {"max_abs_err": 0.0, "library_ms": lu["library_ms"],
                        **{k: lu[k] for k in keys}}}


def profile18(cfg=SIZES18):
    """18f's profiles: the fused config-3 and 256^5 crosses in float32 on
    the card (`profile_cross`: spans, idle share, the maxvol kernels'
    share of the device time)."""
    import torch

    for tag, c, f in (("config 3", cfg["cross3"], _sines), ("fixed rank", cfg["fixed"], _hilbert)):
        profile_cross(f"18 {tag}, float32, fused",
                      lambda c=c, f=f: _fused_call(c, f, torch.float32, "cuda", "auto")[1:])


def fused_path(device="cuda", cfg=SIZES18):
    """Phase 18; returns each kernel's launches in it and the maxvol
    kernels' entries of the result line (none on the CPU, which rehearses
    the phase on the plain versions with ``fuse=True``)."""
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import maxvol_kernels as mk
    from tntorch_tpu_torch.ops import tt_eval as te

    cuda = torch.device(device).type == "cuda"
    start = time.perf_counter()
    tn.set_policy("highest")
    phase("18. the fused cross tier: cross(fuse='auto') against fuse=False in turns, on the "
          "maxvol kernels")
    failed, counted, qs = [], [], {}
    te.reset_launches()
    mk.reset_launches()
    exact3 = lambda ax, X: torch.sin(ax[X]).sum(1)  # noqa: E731
    hilbert = lambda ax, X: 1 / ax[X].sum(1)  # noqa: E731
    f64, f32 = torch.float64, torch.float32
    eps_tols = {"float64": (cfg["cross3"]["eps"], cfg["cross3"]["eps"]),
                "float32": (cfg["cross3"]["eps"], CROSS_F32_TOL)}
    fixed_tols = {"float64": (CROSS_FIXED_F64_TOL, CROSS_FIXED_F64_TOL),
                  "float32": (CROSS_FIXED_TOL, CROSS_FIXED_TOL)}
    with recording_maxvol(qs):
        counted += fused_cross_checks("config 3", cfg["cross3"], _sines, exact3, (f64, f32),
                                      eps_tols, device, cfg["turns"], failed)
        counted += fused_cross_checks("5-D Hilbert", cfg["hilbert"], _hilbert, hilbert, (f64, f32),
                                      eps_tols, device, cfg["turns"], failed)
        counted += fused_cross_checks("fixed rank", cfg["fixed"], _hilbert, hilbert, (f64, f32),
                                      fixed_tols, device, cfg["turns"], failed)
        tensors, fsep = fused_minimize_checks(device, cfg["separable"], cfg["turns"], failed)
        pos = fused_exp_checks(device, cfg["exp"], cfg["turns"], failed)
    _sync(device)
    launches = {"tt_eval": te.tt_eval_kernel.launches, "lu_rows": mk.lu_rows.launches,
                "maxvol_swaps": mk.maxvol_swaps.launches}
    print(f"18, launches on the main path: {launches}")
    if cuda and not all(launches.values()):
        failed.append(f"a kernel of the fused path was not launched: {launches}")
    report = {}
    if cuda:
        # the axes go up before each counted run: its syncs are the sweep's
        runs = [(f"{tag} {str(dtype)[6:]}",
                 lambda c=c, f=f, dtype=dtype, axes=_axes_on(c, dtype, device):
                 _fused_call(c, f, dtype, device, "auto", axes)[1])
                for tag, c, f, dtype in counted]
        runs.append(("minimize", lambda: tn.cross(function=fsep, tensors=tensors, rmax=10,
                                                  max_iter=10, verbose=False, seed=0,
                                                  return_info=True, _minimize=True)[1]))
        runs.append(("tn.exp", lambda: tn.exp(pos, seed=0, return_info=True)[1]))
        count_reads18(device, runs, failed)
        profile18(cfg)
        report = time_maxvol_kernels(qs, failed)
    # every recorded shape's first Q (up to 4 of each dtype and route)
    picked, seen = [], {}
    for (shape, dname, iters), Q in sorted(qs.items(), key=lambda kv: -kv[0][0][0] * kv[0][0][1]):
        route = (dname, iters, mk._swap_plan(*shape, Q.element_size())[0])
        if seen.get(route, 0) < 4:
            seen[route] = seen.get(route, 0) + 1
            picked.append((f"Q max_iters {iters}", Q, iters))
    if cuda:
        hold_maxvol_kernels("18", picked)
    print(f"18, {len(qs)} distinct maxvol shapes recorded, {len(picked)} held; the phase "
          f"{time.perf_counter() - start:.1f} s")
    if failed:
        raise AssertionError("phase 18: " + "; ".join(failed))
    return launches, report


# ---------------------------------------------------------------------------
# Phase 19: the one-stream batched minimize (tn.minimum, argmin, maximum and
# argmax of a batch: every sample's minimizing cross as one stream of
# chunks, 6 then 4 iterations with one read each, on one launch of each
# maxvol kernel a step for the batch and one tt_eval launch an iteration),
# each against the per-sample loop (fuse=False) in turns, at full width:
# - phase 17's B=8 separable 32^5 batch (rank-2 TTs), whose dense optima
#   are known, float64;
# - phase 4's B=32 rounding ensemble (N=4, I=256, rank 128) rounded to rank
#   64 (``round_tt(rmax=64, 'randgram')``), the ensemble users hold (about
#   270 MB in float32), float32 and float64.
# Tolerances of phase 19: the separable optima within MIN_OPT_TOL of the
# dense ones, its argmins and argmaxes the dense ones; the ensemble's
# minima equal to t[argmin] within KERNEL_TOL (relative to max(1, |t|): the
# sweep's fiber value against the tt_eval kernel's, one TT contracted in
# two orders, and the atan transform's round trip); the float64 run against
# the same call on the CPU (the plain versions) within MIN_CPU_TOL relative,
# argmins and argmaxes equal, the CPU taking the card's QR basis at
# rank-deficient steps only (cpu_search_on_card_bases); the batched swap
# kernel bitwise equal to its plain version at every shape the runs gave it.
SIZES19 = dict(separable=SIZES17["separable"], ensemble=BENCH, turns=1)


def _ensemble19(cfg, dtype, device):
    """Phase 4's ensemble in ``dtype`` on ``device``, rounded to rank
    ``cfg["rmax"]`` by 'randgram'."""
    import torch

    import tntorch_tpu_torch as tn

    t = tn.Tensor([torch.from_numpy(c).to(device=device, dtype=dtype) for c in bench_cores(cfg)],
                  batch=True)
    return tn.round_tt(t, rmax=cfg["rmax"], algorithm="randgram")


def recording_batched_swaps(calls):
    """A context in which every batched `maxvol_swaps` call of the device
    maxvol keeps a copy of its inputs (C, idx, max_iters) in ``calls`` by
    (shape, dtype), the first call of each."""
    import importlib

    mv = importlib.import_module("tntorch_tpu_torch.maxvol")

    @contextlib.contextmanager
    def ctx():
        swaps = mv.maxvol_swaps

        def spy(C, idx, tol, max_iters, block=4):
            if C.ndim == 3:
                calls.setdefault((tuple(C.shape), str(C.dtype)[6:]),
                                 (C.clone(), idx.clone(), max_iters))
            return swaps(C, idx, tol, max_iters, block)

        mv.maxvol_swaps = spy
        try:
            yield
        finally:
            mv.maxvol_swaps = swaps

    return ctx()


# A fiber matrix V of a search step that is rank-deficient leaves the
# columns of its QR's Q past the rank to roundoff: there the card's and the
# CPU's Q differ by O(1) and their searches may part, wherever the rest
# agrees. Phase 19's float64 ensemble meets such steps: at one step of its
# searches, 2560 x 10 fiber matrices of six samples have sigma_min /
# sigma_max ~ 1e-18, whichever Gram kernel rounded the ensemble.
# RANK_DEFICIENT is where a step counts as such.
RANK_DEFICIENT = 1e-12


def cpu_search_on_card_bases(t, tc, function, failed):
    """The minimizing cross of ``function`` of the float64 batch ``tc`` on
    the CPU (one stream, the plain versions), its QR bases recorded from the
    same search of ``t`` on the card: at each step where a sample's fiber
    matrix is rank-deficient, the CPU takes the card's Q for that sample,
    after holding the card's V to the CPU's (MIN_CPU_TOL) and its Q to an
    orthonormal basis whose span holds V; every other step is the CPU's own.
    Returns ((minima, argmins), [(call, sample, sigma ratio) replayed])."""
    import importlib

    import torch

    cr = importlib.import_module("tntorch_tpu_torch.cross")
    qr, rec = cr._qr_q, []

    def record(V):
        Q = qr(V)
        rec.append((V.cpu(), Q.cpu()))
        return Q

    cr._qr_q = record
    try:
        cr._minimize_all(t, function, 10, 10, False, dict(seed=0, fuse="auto"))
    finally:
        cr._qr_q = qr
    calls, replayed = iter(enumerate(rec)), []

    def replay(V0):
        Q0 = qr(V0)
        k, (Vc, Qc) = next(calls, (None, (None, None)))
        if V0.dim() != 3 or Vc is None or Vc.shape != V0.shape:
            return Q0
        s = torch.linalg.svdvals(V0)
        for b in torch.nonzero(s[:, -1] <= RANK_DEFICIENT * s[:, 0]).flatten().tolist():
            Vb, Qb = Vc[b], Qc[b]
            scale = float(V0[b].abs().max())
            eye = torch.eye(Qb.shape[-1], dtype=Qb.dtype)
            if not (float((Vb - V0[b]).abs().max()) <= MIN_CPU_TOL * scale
                    and float((Qb.mT @ Qb - eye).abs().max()) <= MIN_CPU_TOL
                    and float((Qb @ (Qb.mT @ Vb) - Vb).abs().max()) <= MIN_CPU_TOL * scale):
                failed.append(f"19: the card's QR at call {k}, sample {b}, is no basis of its "
                              "fibers, or its fibers are not the CPU's")
                continue
            Q0[b] = Qb
            replayed.append((k, b, float(f"{float(s[b, -1] / s[b, 0]):.1e}")))
        return Q0

    cr._qr_q = replay
    try:
        out = cr._minimize_all(tc, function, 10, 10, False, dict(seed=0, fuse=True))
    finally:
        cr._qr_q = qr
    return out, replayed


def one_stream19(tag, t, device, turns, failed, swaps):
    """19: one batch's minimum, one stream against the per-sample loop
    (fuse=False) in turns, ``turns`` loops each between two one-stream
    calls (walls; each one's launches), then a counted
    one-stream run (CUDA's sync debug mode on the card: its host reads; its
    launches of tt_eval, lu_rows and maxvol_swaps against the batched
    maxvol calls and iterations it made), then argmin, maximum and argmax
    on the one stream, their batched swap calls recorded into ``swaps``. Returns
    the minima, argmins, maxima and argmaxes (host) and the launches of
    all these runs."""
    import importlib
    import warnings

    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import maxvol_kernels as mk
    from tntorch_tpu_torch.ops import tt_eval as te

    cr = importlib.import_module("tntorch_tpu_torch.cross")
    cuda = torch.device(device).type == "cuda"
    fuse = "auto" if cuda else True
    B = t.cores[0].shape[0]

    def counts():
        return {"tt_eval": te.tt_eval_kernel.launches, "lu_rows": mk.lu_rows.launches,
                "maxvol_swaps": mk.maxvol_swaps.launches}

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()}

    walls, seen, first = {"one stream": [], "loop": []}, {}, counts()
    tn.minimum(t, seed=0, fuse=fuse)  # warm-up
    # in turns, the one stream before and after each loop: the loop's B
    # crosses take 5-15 times as long
    for which in ["one stream", "loop"] * turns + ["one stream"]:
        before = counts()
        _sync(device)
        t0 = time.perf_counter()
        tn.minimum(t, seed=0, fuse=fuse if which == "one stream" else False)
        _sync(device)
        walls[which].append(time.perf_counter() - t0)
        seen[which] = delta(before)
    steps, batched = [], cr._maxvol_device_batched

    def counted_maxvol(Q, tol, iters):
        steps.append(tuple(Q.shape))
        return batched(Q, tol, iters)

    before = counts()
    _sync(device)
    cr._maxvol_device_batched = counted_maxvol
    if cuda:
        torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = tn.minimum(t, seed=0, fuse=fuse)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
        cr._maxvol_device_batched = batched
    launches = delta(before)
    stats = dict(cr._BATCHED_MIN_STATS)
    reads = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    runs = min(10, 6 + 4 * (stats["chunks"] - 1))  # the chunks of max_iter 10
    with recording_batched_swaps(swaps):
        am = tn.argmin(t, seed=0, fuse=fuse)
        M = tn.maximum(t, seed=0, fuse=fuse)
        aM = tn.argmax(t, seed=0, fuse=fuse)
    ms = {k: [round(w * 1e3, 1) for w in v] for k, v in walls.items()}
    print(f"19 {tag}, B={B}: one stream {stats}, {runs} iterations run, {len(steps)} batched "
          f"maxvol calls (Q shapes {sorted(set(steps))}), launches {launches}, host reads "
          f"{len(reads) if cuda else 'not counted on the CPU'} {reads}; the loop (fuse=False) "
          f"launched {seen['loop']} against the one stream's {seen['one stream']}; walls in "
          f"turns (ms) one stream {ms['one stream']}, loop {ms['loop']}; the loop over the one "
          f"stream {min(walls['loop']) / min(walls['one stream']):.2f}x (least of each)")
    if not stats["onestream"]:
        failed.append(f"19 {tag}: the one stream did not run")
    if cuda:
        # one tt_eval launch for the input's validation values, then one an
        # iteration; one lu_rows and one maxvol_swaps launch a maxvol step
        want = {"tt_eval": 1 + runs, "lu_rows": len(steps), "maxvol_swaps": len(steps)}
        if launches != want or not len(steps):
            failed.append(f"19 {tag}: launches {launches}, expected {want} (one a step or an "
                          "iteration for the batch)")
        if len(reads) != stats["chunks"]:
            failed.append(f"19 {tag}: {len(reads)} host reads in {stats['chunks']} chunks: {reads}")
    return m.cpu().numpy(), am, M.cpu().numpy(), aM, delta(first)


def hold_batched_swaps(swaps, failed):
    """19: every recorded batched ``maxvol_swaps`` call (C: B x n x r) held
    bitwise to the plain version (rows and C), with its launches (one on
    the cluster route); at the largest shape of each B and dtype one
    batched call timed in turns against B single launches and the plain
    loop (CUDA events, less the copy of C and idx both start from), with
    the kernel's device time (torch.profiler) and its bound: bytes (C read
    and written once) and operations (3 n r a swap, the swaps the plain
    loop makes). Returns the timings by (B, dtype)."""
    import torch

    from tntorch_tpu_torch.ops import maxvol_kernels as mk

    parts, times = [], {}
    largest = {}
    for (shape, dname), v in swaps.items():
        key = (shape[0], dname)
        if key not in largest or shape[1] * shape[2] > largest[key][0][1] * largest[key][0][2]:
            largest[key] = (shape, v)
    for (shape, dname), (C, idx, iters) in sorted(swaps.items()):
        B, n, r = shape
        want_C, want_idx = mk.maxvol_swaps_plain(C.clone(), idx.clone(), 1.05, iters)
        before = mk.maxvol_swaps.launches
        got_C, got_idx = mk.maxvol_swaps(C.clone(), idx.clone(), 1.05, iters)
        torch.cuda.synchronize()
        launched = mk.maxvol_swaps.launches - before
        route = swap_route(n, r, C.element_size())
        same = torch.equal(got_C, want_C) and torch.equal(got_idx, want_idx)
        parts.append(f"{B}x{n}x{r} {dname} {route[0]}/{route[1]}: {'equal' if same else 'DIFFER'}"
                     f", {launched} launch(es)")
        if not same or launched != (1 if route[0] == "cluster" else B):
            failed.append(f"19 batched maxvol_swaps at {shape} {dname}: equal {same}, "
                          f"{launched} launches on {route}")
    print("19, every batched maxvol_swaps shape against the plain version: " + "; ".join(parts))
    for (B, dname), (shape, (C, idx, iters)) in sorted(largest.items()):
        _, n, r = shape
        work, wi = C.clone(), idx.clone()

        def reset():
            work.copy_(C)
            wi.copy_(idx)

        def singles():
            reset()
            for b in range(B):
                mk.maxvol_swaps(work[b], wi[b], 1.05, iters)

        copy_ms = cuda_time(reset)
        turns = in_turns({"batched": lambda: (reset(), mk.maxvol_swaps(work, wi, 1.05, iters)),
                          "single": singles,
                          "plain": lambda: mk.maxvol_swaps_plain(C, idx, 1.05, iters)})
        best = {k: sorted(v)[0] - (copy_ms if k != "plain" else 0) for k, v in turns.items()}
        dev = kernel_ms(lambda: (reset(), mk.maxvol_swaps(work, wi, 1.05, iters)), "swaps_")
        its = sum(swaps_needed(C[b], idx[b], iters) for b in range(B))
        item = C.element_size()
        bound, by = bound_ms(its * 3 * n * r, B * (2 * n * r * item + 2 * r * 8),
                             PEAK_FP32 if item == 4 else PEAK_FP64)
        times[(B, dname)] = dict(ms=best["batched"], single_ms=best["single"],
                                 plain_ms=best["plain"], kernel_ms=dev, bound_ms=bound, bound_by=by,
                                 swaps=its, shape=shape)
        print(f"19 maxvol_swaps, B={B} {dname} at {n} x {r} ({its} swaps in all, "
              f"{swap_route(n, r, item)[0]} route): one batched launch {best['batched']:.4f} ms "
              f"(kernel {_ms(dev)} of device time), {B} single launches {best['single']:.4f} ms, "
              f"plain loop {best['plain']:.4f} ms, bound {bound:.6f} ms ({by}); turns "
              f"{ {k: [round(x, 4) for x in v] for k, v in turns.items()} }, less the copies' "
              f"{copy_ms:.4f} ms")
    return times


def one_stream_path(device="cuda", cfg=SIZES19):
    """Phase 19; returns each kernel's launches in its main-path runs (the
    turns and the counted runs; on the CPU, a rehearsal at the small sizes
    ``cfg`` gives, none are counted)."""
    import importlib

    import numpy as np
    import torch

    import tntorch_tpu_torch as tn
    from tntorch_tpu_torch.ops import maxvol_kernels as mk
    from tntorch_tpu_torch.ops import tt_eval as te

    cr = importlib.import_module("tntorch_tpu_torch.cross")
    cuda = torch.device(device).type == "cuda"
    start = time.perf_counter()
    phase("19. the one-stream batched minimize against the per-sample loop, in turns")
    failed, swaps = [], {}
    launches = {"tt_eval": 0, "lu_rows": 0, "maxvol_swaps": 0}

    def add(ran):
        for k, n in ran.items():
            launches[k] += n

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        t, g = _separable17(cfg["separable"], device)
        m, am, _, aM, ran = one_stream19(f"separable {cfg['separable']['N']}-D on "
                                      f"{cfg['separable']['I']}^{cfg['separable']['N']}, float64",
                                      t, device, cfg["turns"], failed, swaps)
        add(ran)
        dense = g.min(-1).sum(-1)
        want_am = [tuple(int(i) for i in row) for row in g.argmin(-1)]
        want_aM = [tuple(int(i) for i in row) for row in g.argmax(-1)]
        opt = float(np.abs(m - dense).max())
        print(f"19 separable: minima {m.tolist()}, vs the dense optima max |diff| {opt:.3e} (tol "
              f"{MIN_OPT_TOL}); argmins the dense ones: {am == want_am}; argmaxes the dense "
              f"ones: {aM == want_aM}")
        if not (opt <= MIN_OPT_TOL and am == want_am and aM == want_aM):
            failed.append(f"19 separable: off the optima by {opt:.3e}, argmins {am == want_am}, "
                          f"argmaxes {aM == want_aM}")
        del t
        E = cfg["ensemble"]
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            gram_calls = []
            with recording_gram(gram_calls):
                t = _ensemble19(E, dtype, device)
            if dtype == torch.float64:
                print("19 ensemble float64, the Gram routes of its rounding: " + "; ".join(
                    f"{k.__name__} {tuple(a[1 if k.__name__ == 'proj2' else 0].shape)} "
                    f"({gram_route(k, a)})" for k, a in gram_calls))
            del gram_calls
            m, am, M, aM, ran = one_stream19(f"ensemble N={E['N']} I={E['I']} rank "
                                             f"{E['rmax']}, {dname}", t, device, cfg["turns"],
                                             failed, swaps)
            add(ran)

            def at(args):  # t at each sample's own coordinates, one tt_eval launch
                rows = cr._batched_rows(np.array(args), len(args), list(t.shape)[1:])
                return cr._batched_values(t.cores, cr._index(rows, device)).diagonal().double().cpu()

            err = max(float(((torch.from_numpy(v).double() - at(a)).abs()
                             / at(a).abs().clamp(min=1)).max()) for v, a in ((m, am), (M, aM)))
            print(f"19 ensemble {dname}: minima {np.round(m[:4], 6).tolist()}..., maxima "
                  f"{np.round(M[:4], 6).tolist()}..., each against t at its argmin or argmax: "
                  f"max rel {err:.3e} (tol {KERNEL_TOL[dname]})")
            if not err <= KERNEL_TOL[dname]:
                failed.append(f"19 ensemble {dname}: optima off t at their coordinates by "
                              f"{err:.3e}")
            if dtype == torch.float64:
                tc = tn.Tensor([c.cpu() for c in t.cores], batch=True)
                t0 = time.perf_counter()
                (cm, cam), rmin = cpu_search_on_card_bases(t, tc, lambda x: x, failed)
                caM, rmax_ = cpu_search_on_card_bases(t, tc, cr._negated(lambda x: x), failed)
                caM = caM[1]
                sec = time.perf_counter() - t0
                print(f"19 ensemble float64: rank-deficient steps whose card bases the CPU's "
                      f"search took (call, sample, sigma_min / sigma_max): minimum {rmin}, "
                      f"maximum {rmax_}")
                rel_cpu = float(((torch.from_numpy(m) - cm).abs() / cm.abs()).max())
                apart = [b for b in range(len(aM)) if aM[b] != caM[b]]
                print(f"19 ensemble float64 against the CPU's one stream ({sec:.1f} s there): "
                      f"minima max rel {rel_cpu:.3e} (tol {MIN_CPU_TOL}), argmins equal "
                      f"{am == cam}; argmaxes equal in {len(aM) - len(apart)} of {len(aM)} "
                      f"samples, t there: " + ", ".join(
                          f"sample {b} card {at([aM[b]] * len(aM))[b]:.15g} CPU "
                          f"{at([caM[b]] * len(aM))[b]:.15g}" for b in apart))
                if not (rel_cpu <= MIN_CPU_TOL and am == cam and not apart):
                    failed.append(f"19 ensemble float64 vs the CPU: rel {rel_cpu:.3e}, argmins "
                                  f"{am == cam}, argmaxes apart in samples {apart}")
            del t
    finally:
        torch.set_default_dtype(prev)
    print(f"19, launches on the main path: {launches}")
    if cuda:
        if not all(launches.values()):
            failed.append(f"a kernel of the one-stream path was not launched: {launches}")
        hold_batched_swaps(swaps, failed)
    print(f"19, {len(swaps)} batched swap shapes recorded; the phase "
          f"{time.perf_counter() - start:.1f} s")
    if failed:
        raise AssertionError("phase 19: " + "; ".join(failed))
    return launches


PHASES = {"3": "check_kernels", "3g": "time_gram_routes", "3b": "check_tt_kernels", "3s": "hold_per_sample_plans",
          "3n": "check_half_and_long",
          "3t": "time_per_sample", "3h": "time_host", "3x": "plan_choices", "4": "main_path",
          "5": "nonbatch_pass", "6": "eval_path", "7": "train_path", "8": "train_design_path",
          "9": "baseline_path", "10": "cross_path", "11": "elementwise_path",
          "12": "config4_path", "13": "config5_path", "14": "missing_modules_path",
          "14d": "host_sweep_path",
          "15": "tutorials_path", "16": "parallel_path", "17": "mesh_paths_path",
          "18": "fused_path", "18x": "swap_crossover", "18p": "maxvol_profiles",
          "19": "one_stream_path"}


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
    baselines = baseline_path()
    crosses = cross_path()
    elementwise = elementwise_path()
    config4 = config4_path()
    config5 = config5_path()
    missing = missing_modules_path()
    tutorials = tutorials_path()
    parallel = parallel_path(smi=smi)
    mesh_paths = mesh_paths_path(smi=smi)
    fused, maxvol_report = fused_path()
    report.update(maxvol_report)
    one_stream = one_stream_path()
    launches.update({k: evals[k] + trains[k] + designs[k] for k in evals})
    launches.update(lu_rows=0, maxvol_swaps=0)
    launches = {k: n + sum(p.get(k, 0) for p in (baselines, crosses, elementwise, config4,
                                                         config5, missing, tutorials, parallel,
                                                         mesh_paths, fused, one_stream))
                for k, n in launches.items()}

    import torch

    replaces = {
        "gram_edge": "tntorch_tpu/ops/pallas_gram.py:125",
        "wgram": "tntorch_tpu/ops/pallas_gram.py:187",
        "proj2": "tntorch_tpu/ops/pallas_gram.py:254",
        "tt_eval": "tntorch_tpu/ops/pallas_tt.py:89",
        "tt_eval_backward": "no TPU kernel: XLA's gradient of tntorch_tpu/parallel/mesh.py:150",
        "lu_rows": "no TPU kernel: jax.lax.linalg.lu's permutation, tntorch_tpu/maxvol.py:185",
        "maxvol_swaps": "no TPU kernel: the lax.while_loop of tntorch_tpu/maxvol.py:242",
    }
    sources = {"tt_eval": "tt_eval.cu", "tt_eval_backward": "tt_eval.cu",
               "lu_rows": "maxvol_device.cu", "maxvol_swaps": "maxvol_device.cu"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"tntorch_tpu_torch/csrc/{sources.get(name, 'gram_kernels.cu')}",
         "replaces": replaces[name], "launches": launches[name], **report[name]}
        for name in replaces
    ]
    print(phase_times())
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
