"""The port's per-sample TT-evaluation kernels (tntorch_tpu_torch/ops/tt_eval.py:
`_per_sample_plan`, csrc/tt_eval.cu: ``tt_eval_kernel`` and
``tt_eval_backward_kernel``) against the JAX package: the Pallas kernel in
interpret mode (f32), ``tt_batch_forward`` and ``jax.grad`` (f64).

The CUDA kernels cannot run here, so a plain-PyTorch emulation follows
their arithmetic from the wrapper's own plan: a lane group of W lanes per
sample, lane w holding entries w, w + W, ... of each interface; coordinates
loaded W modes at a time and handed to the group by shuffle; each mode's
rows broadcast by shuffle in increasing order; the backward's right
interface summed across the group by a butterfly; and the gradients of
privatized cores summed per block of the persistent grid, then added in
block order. The kernels themselves are compared with the plain versions on
the card (chip_smoke.py phase 3b, and the `cuda`-marked test below)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntorch_tpu.ops.pallas_tt import pallas_tt_eval
from tntorch_tpu.parallel.mesh import tt_batch_forward as jax_tt_batch_forward
from tntorch_tpu_torch.ops import tt_eval as te


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _problem(ranks, dims, B, seed, negative=False, dtype=np.float64):
    """Cores (R_k, I_k, R_{k+1}), coordinates (B, N) and weights (B,), as numpy."""
    rng = np.random.default_rng(seed)
    cores = [(rng.standard_normal((ranks[k], I, ranks[k + 1])) / np.sqrt(ranks[k])).astype(dtype)
             for k, I in enumerate(dims)]
    X = np.stack([rng.integers(-I if negative else 0, I, B) for I in dims], axis=1)
    return cores, X, rng.standard_normal(B).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _plan(ranks, dims, itemsize=8, B=1 << 40, **force):
    return te._per_sample_plan(tuple(ranks), tuple(dims), B, itemsize, **force)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_plan_lane_width_and_columns_per_rank(itemsize):
    # W: the smallest power of two >= the widest carried interface, at most
    # 32; columns a lane, backward: 1, 2 or 4, else 0 (the interface in
    # shared memory); forward: 1, else 0
    for R, W, fwd, bwd in ((1, 1, 1, 1), (4, 4, 1, 1), (5, 8, 1, 1), (16, 16, 1, 1),
                           (32, 32, 1, 1), (33, 32, 0, 2), (100, 32, 0, 4), (128, 32, 0, 4),
                           (129, 32, 0, 0), (257, 32, 0, 0)):
        plan = _plan([1, R, 1], [3, 3], itemsize)
        assert (plan.W, plan.fwd_cols, plan.bwd_cols) == (W, fwd, bwd), R
        for cols in (plan.fwd_cols, plan.bwd_cols):
            assert plan.W * cols >= R or (cols == 0 and plan.W == 32)
    assert _plan([5, 1], [7], itemsize).W == 8  # R_0 is carried (ones(R_0))
    assert _plan([1, 64], [7], itemsize).W == 1  # R_N is not: only column 0 of the last mode
    assert _plan([2, 5, 3, 7, 3], [9, 4, 11, 5], itemsize).W == 8
    # a wider group may be forced, a narrower one may not
    assert _plan([1, 5, 1], [3, 3], itemsize, W=32)[:2] == (32, 1)
    assert _plan([1, 5, 1], [3, 3], itemsize, shared=True)[:3] == (32, 0, 0)
    with pytest.raises(ValueError, match="do not carry"):
        _plan([1, 5, 1], [3, 3], itemsize, W=4)
    with pytest.raises(ValueError, match="do not carry"):
        _plan([1, 5, 1], [3, 3], itemsize, W=12)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_plan_stages_the_cores_up_to_the_budget(itemsize):
    held = te._HELD_BYTES // itemsize  # elements, each core rounded up to 4
    assert _plan([1, 1], [held], itemsize).staged
    assert not _plan([1, 1], [held + 1], itemsize).staged
    assert _plan([1, 1], [held], itemsize).fwd_smem == held * itemsize
    assert _plan([1, 1], [held + 1], itemsize).fwd_smem == 0
    # cp[X] at phase 13's size: 1920 values; training's 73728 are not staged
    p13 = _plan([1, 5, 5, 5, 1], [32] * 4, itemsize)
    assert p13.staged and p13.fwd_smem == 1920 * itemsize
    assert not _plan([1, 16, 16, 1], [256] * 3, itemsize).staged
    # and only at _STAGE_MIN samples per staged element: cp[X] at 2^20, not
    # OPT4 (B = 20000, 5140 elements) or two modes at B = 5000
    assert _plan([1, 5, 5, 5, 1], [32] * 4, itemsize, B=te._STAGE_MIN * 1920).staged
    assert not _plan([1, 5, 5, 5, 1], [32] * 4, itemsize, B=te._STAGE_MIN * 1920 - 1).staged
    assert _plan([1, 5, 5, 5, 1], [32] * 4, itemsize, B=1 << 20).staged
    assert not _plan([1, 8, 8, 1], [64] * 3, itemsize, B=20000).staged
    assert not _plan([1, 16, 1], [128, 128], itemsize, B=5000).staged
    # forced either way; forced on beyond a block's shared memory, the
    # forward does not fit (0 warps); and only with the interface in
    # registers, up to rank 32
    assert not _plan([1, 5, 5, 5, 1], [32] * 4, itemsize, staged=False).staged
    assert _plan([1, 1], [held + 1], itemsize, staged=True).fwd_smem == (held + 4) * itemsize
    over = _plan([1, 16, 16, 1], [256] * 3, itemsize, staged=True)  # 288 KB in float32
    assert (over.fwd_warps, over.fwd_smem) == (0, 0) and over.bwd_warps == 8
    assert _plan([1, 32, 1], [2, 2], itemsize, staged=True).staged
    assert not _plan([1, 33, 1], [2, 2], itemsize, staged=True).staged
    assert not _plan([1, 5, 1], [2, 2], itemsize, staged=True, shared=True).staged


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_plan_privatizes_gradients_in_mode_order(itemsize):
    # training's cores (4096, 65536, 4096 values) at B/I = 256: the middle
    # one never fits; in float64 the first takes 32 KB of the 48 and leaves
    # no room for the last
    B = te._PRIV_MIN * 256
    training = _plan([1, 16, 16, 1], [256] * 3, itemsize, B=B)
    assert training.private == {4: (True, False, True), 8: (True, False, False)}[itemsize]
    assert training.bwd_smem == {4: 8192 * 4, 8: 4096 * 8}[itemsize] + 8 * 2 * 33 * itemsize
    # below _PRIV_MIN samples per slice nothing is privatized: the training
    # step's B = 8192 (32 a slice), and one sample short of the limit
    for b in (8192, B - 1):
        assert _plan([1, 16, 16, 1], [256] * 3, itemsize, B=b).private == (False,) * 3
    assert _plan([1, 5, 5, 5, 1], [32] * 4, itemsize, B=4095).private == (False,) * 4
    assert all(_plan([1, 5, 5, 5, 1], [32] * 4, itemsize).private)  # cp[X]: 1920 values
    assert all(_plan([1, 8, 8, 1], [64] * 3, itemsize, B=20000).private)  # OPT4: 40 KB in f64
    assert _plan([1, 8, 8, 1], [64] * 3, itemsize, private=False).private == (False,) * 3
    held, big = te._HELD_BYTES // itemsize, 1 << 40
    assert _plan([1, 1, 1], [held - 4, 4], itemsize, B=big).private == (True, True)
    assert _plan([1, 1, 1], [held - 3, 4], itemsize, B=big).private == (True, False)
    assert _plan([1, 1, 1], [held - 3, 4], itemsize, private=True).private == (True, True)


def test_plan_left_interfaces_and_warps():
    # the left interfaces in the group's slice of shared memory: 32 / W
    # samples a warp, sum(R_0..R_{N-1}) each, 8 warps, after the privatized
    # cores (config 3's held-out points: 4352 values)
    config3 = _plan([1] + [4] * 9 + [1], [32] * 10, B=10 ** 5)
    assert (config3.W, config3.bwd_warps, config3.fwd_warps) == (4, 8, 8)
    assert config3.bwd_smem == 4352 * 8 + 8 * 8 * 37 * 8
    assert config3.fwd_smem == 0  # 4352 values: more than B / _STAGE_MIN, not staged
    # the interface in shared memory: two buffers a warp (forward), plus
    # the left interfaces (backward); warps halved until they fit
    wide = _plan([1, 3000, 1], [2, 2], B=1 << 30)
    assert (wide.fwd_cols, wide.bwd_cols, wide.fwd_warps, wide.fwd_smem) == (0, 0, 4, 4 * 6000 * 8)
    assert wide.private == (True, False)  # 6000 values: 48000 bytes of the 49152
    assert (wide.bwd_warps, wide.bwd_smem) == (2, (6000 + 2 * 9001) * 8)
    for backward in (False, True):
        with pytest.raises(ValueError, match="shared memory"):
            te._plan_for("tt_eval", (1, 15000, 1), (2, 2), 1 << 30, 8, backward)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_plan_refuses_only_the_kernel_that_does_not_fit(itemsize):
    # N = 120 at rank 250: one warp's left interfaces (29751 values) and two
    # interfaces fit a block in float32 (121 KB), not in float64 (242 KB),
    # where the backward keeps the left interfaces in device memory
    # (bwd_spill) and a block holds 8 warps' two interfaces; the forward's
    # two interfaces (4 KB) fit in both, so t[X] and its gradient are served
    ranks, dims = (1,) + (250,) * 119 + (1,), (2,) * 120
    fwd = te._plan_for("tt_eval", ranks, dims, 64, itemsize, False)
    assert (fwd.W, fwd.fwd_cols, fwd.fwd_warps, fwd.fwd_smem) == (32, 0, 8, 8 * 500 * itemsize)
    bwd = te._plan_for("tt_eval_backward", ranks, dims, 64, itemsize, True)
    if itemsize == 4:
        assert (bwd.bwd_warps, bwd.bwd_smem, bwd.bwd_spill) == (1, (29751 + 500) * 4, False)
    else:
        assert (bwd.bwd_warps, bwd.bwd_smem, bwd.bwd_spill) == (8, 8 * 500 * 8, True)
    # a kernel whose own buffers exceed a block is still refused: one warp's
    # two interfaces at rank 15000 in float64 (240 KB), spilled or not
    for backward in (False, True):
        with pytest.raises(ValueError, match="exceed a block's shared"):
            te._plan_for("tt_eval", (1, 15000, 1), (2, 2), 64, 8, backward)


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def _coords(X, dims, W):
    """The kernels' coordinates: lane w of a sample's group loads mode kw +
    w (kw a multiple of W), wraps it into [0, I) or marks it -1 when out of
    range; mode k reaches the group by shuffle from lane k - kw."""
    B, N = X.shape
    out = torch.empty((B, N), dtype=torch.int64)
    for kw in range(0, N, W):
        window = torch.zeros((B, W), dtype=torch.int64)
        for w in range(min(W, N - kw)):
            x, I = X[:, kw + w], dims[kw + w]
            window[:, w] = torch.where((x < -I) | (x >= I), -1, torch.remainder(x, I))
        for k in range(kw, min(kw + W, N)):
            out[:, k] = window[:, k - kw]  # the shuffle
    return out


def _lanes(v, W, slots):
    """An interface (B, R) as a group's registers (B, W, slots): lane w,
    slot j holds entry w + W j."""
    pad = torch.zeros((v.shape[0], W * slots), dtype=v.dtype)
    pad[:, :v.shape[1]] = v
    return pad.view(-1, slots, W).transpose(1, 2)


def _entries(lanes, n):
    """The first n entries of an interface held as (B, W, slots)."""
    return lanes.transpose(1, 2).reshape(lanes.shape[0], -1)[:, :n]


def _slots(cols, ranks):
    return cols or -(-max(ranks[:-1]) // 32)  # cols 0: one warp a sample, W = 32


def _step(v, core, x, Rr, W, slots):
    """One mode: out[s] = sum_r shfl(v, r) C[r, x, s], r in increasing order."""
    out = torch.zeros_like(v)
    for r in range(core.shape[0]):
        a = v[:, r % W, r // W]  # the shuffle from lane r % W, slot r // W
        out = out + a[:, None, None] * _lanes(core[r, x, :Rr], W, slots)
    return out


def _butterfly(part, W):
    """The group's sum of its lanes' parts (B, W): at each step lane w adds
    lane w ^ off's part, off = W / 2, ..., 1."""
    off = W // 2
    while off:
        part = part + part[:, torch.arange(W) ^ off]
        off //= 2
    return part


def _last(v, core, x, W):
    """The last mode, column 0 only, read from device memory: lane w sums
    v[r] C[r, x, 0] over its rows r = w + W j, then the group's butterfly.
    (Staged in shared memory, the last mode is a `_step` of one column.)"""
    part = torch.zeros((v.shape[0], W), dtype=v.dtype)
    for r in range(core.shape[0]):
        part[:, r % W] = part[:, r % W] + v[:, r % W, r // W] * core[r, x, 0]
    return _butterfly(part, W)[:, 0]


def _forward(cores, X, plan):
    """tt_eval_kernel's values and flag."""
    ranks = [cores[0].shape[0]] + [c.shape[2] for c in cores]
    W, slots, N = plan.W, _slots(plan.fwd_cols, ranks), len(cores)
    xs = _coords(X, [c.shape[1] for c in cores], W)
    x = xs.clamp(min=0)
    v = _lanes(torch.ones((X.shape[0], ranks[0]), dtype=cores[0].dtype), W, slots)
    for k in range(N - 1):
        v = _step(v, cores[k], x[:, k], ranks[k + 1], W, slots)
    if plan.staged:
        value = _step(v, cores[-1], x[:, -1], 1, W, slots)[:, 0, 0]
    else:
        value = _last(v, cores[-1], x[:, -1], W)
    bad = (xs < 0).any(1)
    return torch.where(bad, torch.nan, value), bool(bad.any())


def _blocks(B, plan, nblocks):
    """The block of the persistent grid of `nblocks` blocks that takes each
    sample: sample b is in unit b // (32 / W) (a warp's samples), unit u in
    block (u // warps) mod nblocks (grid-stride)."""
    units = torch.arange(B) // (32 // plan.W)
    return (units // plan.bwd_warps) % nblocks


def _backward(cores, X, g, plan, nblocks=3):
    """tt_eval_backward_kernel's gradients and flag: a sample with an
    out-of-range coordinate flags and adds nothing; the outer products of a
    privatized core are summed per block, the blocks' sums then added in
    block order; the others are added sample by sample."""
    ranks = [cores[0].shape[0]] + [c.shape[2] for c in cores]
    W, slots, N, B = plan.W, _slots(plan.bwd_cols, ranks), len(cores), X.shape[0]
    xs = _coords(X, [c.shape[1] for c in cores], W)
    bad = (xs < 0).any(1)
    x = xs.clamp(min=0)
    gb = torch.where(bad, 0.0, g)  # inactive groups run the loops and add nothing
    lefts = [_lanes(torch.ones((B, ranks[0]), dtype=g.dtype), W, slots)]
    for k in range(N - 1):
        lefts.append(_step(lefts[-1], cores[k], x[:, k], ranks[k + 1], W, slots))
    block = _blocks(B, plan, nblocks)
    grads = [torch.zeros_like(c) for c in cores]
    for k in reversed(range(N)):
        Rl, ncols = ranks[k], 1 if k == N - 1 else ranks[k + 1]
        outer = torch.zeros((B, Rl, ncols), dtype=g.dtype)
        rn = torch.zeros_like(lefts[0])
        for r in range(Rl):
            a = gb * lefts[k][:, r % W, r // W]  # L_k[r], a shared-memory broadcast
            if k == N - 1:  # column 0 only (Rt_N = e_0): Rt_{N-1}[r] = C[r, x, 0]
                outer[:, r, 0] = a  # (a row a lane, or a row at a time into a held copy:
                rn[:, r % W, r // W] = cores[k][r, x[:, k], 0]  # the same sums)
                continue
            outer[:, r] = a[:, None] * _entries(rt, ncols)
            if k:  # lane w's part over its slots, then the butterfly
                part = torch.zeros((B, W), dtype=g.dtype)
                for j in range(slots):
                    s = torch.arange(W) + W * j
                    keep = s < ncols
                    c = torch.zeros((B, W), dtype=g.dtype)
                    c[:, keep] = cores[k][r, x[:, k]][:, s[keep]] * rt[:, keep, j]
                    part = part + c
                rn[:, r % W, r // W] = _butterfly(part, W)[:, r % W]
        rt = rn
        target = grads[k][:, :, :ncols]
        if plan.private[k]:
            for i in range(nblocks):
                copy = torch.zeros_like(target)
                mine = block == i
                copy.index_add_(1, x[mine, k], outer[mine].permute(1, 0, 2))
                target += copy
        else:
            target.index_add_(1, x[:, k], outer.permute(1, 0, 2))
    return grads, bool(bad.any())


def _jax_grads(cores, X, w):
    jX, jw = jnp.asarray(X), jnp.asarray(w)
    return jax.grad(lambda cs: jnp.sum(jw * jax_tt_batch_forward(cs, jX)))(
        [jnp.asarray(c) for c in cores])


# (ranks, dims, B, negative): ragged R_0/R_N; ranks > 32 (2 and 4 columns a
# lane, and the interface in shared memory); N = 1, 2, 3, 5, 10; B = 1 and
# B not a multiple of 32 / W
CASES = {
    "ragged_negative": ([2, 5, 3, 7, 3], [9, 4, 11, 5], 41, True),
    "ranks_33_40": ([1, 40, 33, 1], [5, 6, 4], 7, False),
    "ranks_100": ([1, 100, 1], [3, 4], 9, True),
    "ranks_300": ([2, 300, 1], [2, 3], 5, False),
    "one_mode_one_sample": ([3, 4], [13], 1, True),
    "two_modes": ([1, 16, 2], [6, 5], 30, True),
    "five_modes": ([1, 3, 4, 2, 5, 1], [4, 5, 3, 6, 2], 50, False),
    "ten_modes": ([1] + [3] * 9 + [1], [3] * 10, 33, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_jax_f64(case):
    ranks, dims, B, negative = CASES[case]
    cores, X, g = _problem(ranks, dims, B, seed=31, negative=negative)
    cs, Xt, gt = [torch.from_numpy(c) for c in cores], torch.from_numpy(X), torch.from_numpy(g)
    want = np.asarray(jax_tt_batch_forward([jnp.asarray(c) for c in cores], jnp.asarray(X)))
    want_grads = _jax_grads(cores, X, g)
    plan = _plan(ranks, dims)
    forced = [plan, _plan(ranks, dims, W=32, staged=False, private=False),
              _plan(ranks, dims, shared=True)]
    if not all(plan.private):
        forced.append(_plan(ranks, dims, private=True))
    for p in forced:
        got, flag = _forward(cs, Xt, p)
        assert not flag and _rel(got.numpy(), want) <= 1e-12, p
        grads, flag = _backward(cs, Xt, gt, p)
        assert not flag
        for a, b in zip(grads, want_grads):
            assert _rel(a.numpy(), np.asarray(b)) <= 1e-12, p


def test_emulation_matches_pallas_interpret_f32():
    # The Pallas kernel's gates: R_0 = R_N = 1, B a multiple of 128, f32
    cores, X, _ = _problem([1, 8, 6, 1], [16, 12, 10], 256, seed=32, dtype=np.float32)
    want = np.asarray(pallas_tt_eval(tuple(jnp.asarray(c) for c in cores),
                                     jnp.asarray(X, jnp.int32), interpret=True))
    plan = _plan([1, 8, 6, 1], [16, 12, 10], 4)
    got, flag = _forward([torch.from_numpy(c) for c in cores], torch.from_numpy(X), plan)
    assert not flag and _rel(got.numpy(), want) <= 1e-5


def test_emulation_flags_out_of_range_and_leaves_the_sample_out():
    ranks, dims = [2, 5, 3, 7, 3], [9, 4, 11, 5]
    cores, X, g = _problem(ranks, dims, 41, seed=33, negative=True)
    X[6, 2] = 11  # out of range in mode 2 (I = 11); X[7, 0] = -9 wraps to 0
    X[7, 0] = -9
    cs, Xt, gt = [torch.from_numpy(c) for c in cores], torch.from_numpy(X), torch.from_numpy(g)
    plan = _plan(ranks, dims)
    got, flag = _forward(cs, Xt, plan)
    keep = np.arange(41) != 6
    assert flag and torch.isnan(got[6]) and not torch.isnan(got[keep]).any()
    assert _rel(got.numpy()[keep], te.tt_eval_plain(cs, Xt[keep]).numpy()) <= 1e-12
    grads, flag = _backward(cs, Xt, gt, plan)
    want = te.tt_eval_backward_plain(cs, Xt[keep], gt[keep])
    assert flag and all(_rel(a.numpy(), b.numpy()) <= 1e-12 for a, b in zip(grads, want))


def test_emulation_keeps_an_infinite_entry_where_the_plain_version_does():
    # an infinite entry in the last column of a middle core whose rank (5)
    # is not a multiple of the lane width (8): the lanes past it leave it
    # out of their parts, so no 0 x inf reaches the right interface
    ranks, dims = [1, 5, 5, 5, 1], [4] * 4
    cores, X, g = _problem(ranks, dims, 64, seed=36)
    cores[1][2, 1, 4] = np.inf
    cs, Xt, gt = [torch.from_numpy(c) for c in cores], torch.from_numpy(X), torch.from_numpy(g)
    plan = _plan(ranks, dims)
    assert plan.W == 8
    got, _ = _forward(cs, Xt, plan)
    grads, _ = _backward(cs, Xt, gt, plan)
    want = [te.tt_eval_plain(cs, Xt), *te.tt_eval_backward_plain(cs, Xt, gt)]
    for a, b in zip([got, *grads], want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a[torch.isinf(b)], b[torch.isinf(b)])
        finite = torch.isfinite(b)
        assert not finite.any() or _rel(a[finite].numpy(), b[finite].numpy()) <= 1e-12
    assert not all(bool(torch.isfinite(d).all()) for d in grads)


def test_emulation_of_privatized_sums_is_the_sum_in_any_block_count():
    # the blocks' copies add up to the sample-by-sample sum, whatever the grid
    ranks, dims = [1, 5, 5, 5, 1], [8] * 4
    cores, X, g = _problem(ranks, dims, 300, seed=34)
    cs, Xt, gt = [torch.from_numpy(c) for c in cores], torch.from_numpy(X), torch.from_numpy(g)
    want = te.tt_eval_backward_plain(cs, Xt, gt)
    plan = _plan(ranks, dims)
    assert all(plan.private)
    for nblocks in (1, 2, 7, 1000):
        grads, _ = _backward(cs, Xt, gt, plan, nblocks)
        assert all(_rel(a.numpy(), b.numpy()) <= 1e-12 for a, b in zip(grads, want))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_every_lane_width_and_staging_choice_matches_plain_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    plan = te._per_sample_plan
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-12)):
        for ranks, dims, B, negative in CASES.values():
            cores, X, g = _problem(ranks, dims, B, seed=35, negative=negative, dtype=dtype)
            cs = [torch.from_numpy(c).cuda() for c in cores]
            Xt, gt = torch.from_numpy(X).cuda(), torch.from_numpy(g).cuda()
            want = te.tt_eval_plain(cs, Xt).cpu()
            want_grads = [d.cpu() for d in te.tt_eval_backward_plain(cs, Xt, gt)]
            need = plan(tuple(ranks), tuple(dims), B, cs[0].element_size()).W
            for W in (w for w in (1, 2, 4, 8, 16, 32) if w >= need):
                for staged in (False, True):
                    force = dict(W=W, staged=staged, private=staged)
                    monkeypatch.setattr(te, "_per_sample_plan",
                                        lambda r, d, b, i, f=force: plan(r, d, b, i, **f))
                    try:
                        got, again = te.tt_eval_kernel(cs, Xt), te.tt_eval_kernel(cs, Xt)
                        grads = te.tt_eval_backward_kernel(cs, Xt, gt)
                    except ValueError:  # staging forced beyond a block's shared memory
                        assert staged
                        continue
                    torch.cuda.synchronize()
                    assert torch.equal(got, again)
                    assert _rel(got.cpu(), want) <= tol
                    assert all(_rel(a.cpu(), b) <= tol for a, b in zip(grads, want_grads))
            monkeypatch.setattr(te, "_per_sample_plan", plan)
