"""The work model's counts at the cells' shapes, against figures worked
out by hand."""

import pytest

from portbench.workmodel.counts import bound_s, gram_flops, gram_work, tt_eval_flops, tt_eval_work
from portbench.workmodel.peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def test_peaks():
    assert PEAK_FLOPS == {"float32": 67e12, "float64": 67e12}
    assert HBM_BYTES_PER_S == 3.35e12


def sweep_calls(B, R, I, r):
    """The Gram calls of one randgram sweep of B TTs, ranks [1, R, R, R, 1]:
    two right Grams, two left Grams, two projections."""
    C = (B, R, I, R)
    return [("gram_edge", [C, (B, R, R)])] * 2 + [("wgram", [C, (B, R, R)])] * 2 + \
        [("proj2", [(B, r, R), C, (B, R, r)])] * 2


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gram_counts_at_the_round_cells(dtype):
    # gram_edge: 2 B I (Rl Rr^2 + Rl^2 Rr) = 2 * 128 * 256 * 2 * 128^3
    assert gram_flops("gram_edge", 128, 128, 256, 128) == 2 * 128 * 256 * 2 * 128 ** 3
    assert gram_flops("wgram", 128, 128, 256, 128) == 274877906944.0
    # proj2: 2 B I (r1 Rl Rr + r1 Rr r2) = 2 * 128 * 256 * (64 * 128 * 128 + 64 * 128 * 64)
    assert gram_flops("proj2", 128, 128, 256, 128, 64, 64) == 103079215104.0
    item = 4 if dtype == "float32" else 8
    flops, nbytes = gram_work("gram_edge", [(128, 128, 256, 128), (128, 128, 128)], dtype)
    assert nbytes == item * (128 * 128 * 256 * 128 + 2 * 128 ** 3)
    flops, nbytes = gram_work("proj2", [(128, 64, 128), (128, 128, 256, 128), (128, 128, 64)],
                              dtype)
    assert nbytes == item * (2 * 128 * 64 * 128 + 128 * 128 * 256 * 128 + 128 * 64 * 256 * 64)
    # a Gram is bound by its operations, 4.1029 ms; a projection by them in
    # float32 (1.5385 ms), by its 5.39 GB in float64 (1.6076 ms)
    sweep = sum(bound_s(*gram_work(n, s, dtype), dtype) for n, s in sweep_calls(128, 128, 256, 64))
    proj2 = (103079215104 / 67e12 if dtype == "float32" else
             8 * (2 * 128 * 64 * 128 + 128 * 128 * 256 * 128 + 128 * 64 * 256 * 64) / 3.35e12)
    assert sweep == pytest.approx(4 * 274877906944 / 67e12 + 2 * proj2, rel=1e-12)
    assert sweep == pytest.approx({"float32": 19.4876e-3, "float64": 19.6258e-3}[dtype], abs=1e-7)


def test_gram_bound_at_b32_is_the_recorded_one():
    # PERF.md's bound for the B=32 f32 sweep: 2 x (1.026 + 1.026 + 0.385) ms
    sweep = sum(bound_s(*gram_work(n, s, "float32"), "float32")
                for n, s in sweep_calls(32, 128, 256, 64))
    assert sweep == pytest.approx(4.872e-3, abs=1e-6)


def test_tt_eval_counts_at_the_design_shape():
    ranks, B = [1, 64, 64, 64, 1], 1 << 20
    fwd, bwd = tt_eval_flops(ranks, B)
    assert fwd == 2 * B * (64 + 64 * 64 + 64 * 64 + 64)  # 17.4 GFLOP
    assert bwd == 2 * B * ((64 + 2 * 4096) + 8320 + (2 * 4096 + 64))  # 52.1 GFLOP
    shapes = [(1, 1024, 64), (64, 1024, 64), (64, 1024, 64), (64, 1024, 1)]
    cores = 4 * (2 * 65536 + 2 * 4194304)
    f, b = tt_eval_work(shapes, (B, 4), "float32", "int64", backward=False)
    assert (f, b) == (fwd, cores + 8 * 4 * B + 4 * B)
    assert bound_s(f, b, "float32") == pytest.approx(0.26042e-3, abs=1e-8)
    f, b = tt_eval_work(shapes, (B, 4), "float32", "int64", backward=True)
    assert (f, b) == (bwd, 2 * cores + 8 * 4 * B + 4 * B)
    assert bound_s(f, b, "float32") == pytest.approx(0.77726e-3, abs=1e-8)

