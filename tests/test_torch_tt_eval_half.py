"""The port's TT evaluation of bfloat16 and float16 cores, and of chains of
more than ``MAX_MODES`` (128) modes (tntorch_tpu_torch/ops/tt_eval.py),
against the JAX package's chain (``tntorch_tpu.ops.pallas_tt.tt_eval``,
which takes ``tt_batch_forward`` for such inputs) and ``jax.grad`` of it.

The tolerance. Both chains round every interface to the cores' dtype after
its mode, so both err against the float64 evaluation of the same rounded
cores (and rounded weights), u the dtype's unit roundoff (2^-8 bfloat16,
2^-11 float16, 2^-24 float32). At N = 4 each output (the values, each
core's gradient) is held to its own scale:
the port's error at most the JAX chain's plus 2 u max|reference| of that
output. The port's plain backward rounds once more than JAX's gradient
(g L_k, before the outer product with Rt_{k+1}), so its gradients get that
rounding's own bound on top, u max T_k, T_k the sums of |g_b L_k[b]|
(outer) |Rt_{k+1}[b]| over the samples of each slice in the float64 chain.
Seeds 0-19 of `_case`: the port's plain gradients pass the JAX chain's
error by at most 1.40 (bfloat16) and 2.65 (float16, seed 1) u max|ref_k|,
within 2 u max|ref_k| + 0.44 u max T_k; the kernels' arithmetic
(`_kernel_arithmetic`) by at most 0.17 u max|ref_k|, with no allowance.

Over 130 modes the two chains' rounding errors are independent walks (the
float32 forwards also sum in other orders), so neither bounds the other
output by output: over seeds 0-19 the per-core excess reaches 36.1 u
max|ref_k| in bfloat16 (seed 2; 5.67 at seed 0) and 1.2e4 u in float32.
There the outputs are held together, with
one scale over the list: values within once the JAX chain's error plus 2 u
max|value| (float32 needs up to 4.14 times it over seeds 0-19, seed 17; 0.67
at seed 0; bfloat16 at most once), gradients within twice it (float32 up to
2.77, seed 19; 1.64 at seed 0; bfloat16 up to 1.51). These 130-mode bounds
hold at the seed tested, not at every seed.

The kernels cannot run here. `_kernel_arithmetic` follows their half
semantics (float32 inside a mode, each interface rounded after its mode,
the gradients summed in float32 and rounded once) and is held to the same
tolerance. The dispatch tests take the card's branch on the CPU (`_on_cpu`
patched to False, `_launch` a spy that runs no kernel) and show that half
cores and long chains reach the kernels through `TTEval` from ``tn.tt_eval``,
``t[X]``, ``tt_batch_forward`` and ``tn.optimize``, and never the plain
versions. The kernels themselves are held to their plain versions on the
card (chip_smoke.py phase 3b, and the `cuda`-marked test below)."""

import contextlib
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu_torch as tn
from tntorch_tpu.ops.pallas_tt import tt_eval as jax_tt_eval
from tntorch_tpu_torch import interop
from tntorch_tpu_torch.ops import tt_eval as te


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


JAX_DTYPES = {"bfloat16": jnp.bfloat16, "float16": jnp.float16, "float32": jnp.float32}
UNIT = {"bfloat16": 2.0**-8, "float16": 2.0**-11, "float32": 2.0**-24}
# (ranks, I, B): a half-precision shape (6^4, ranks 4) and a 130-mode chain
# (5^130, ranks 3), past MAX_MODES
SHAPES = {"N4": ([1, 4, 4, 4, 1], 6, 200), "N130": ([1] + [3] * 129 + [1], 5, 64)}


def _torch_dtype(name):
    return getattr(torch, name)


@functools.lru_cache(maxsize=None)
def _case(dtype, shape):
    """Cores, coordinates and weights from a numpy seed, rounded to
    ``dtype`` (float64 arrays holding the rounded values); the float64
    reference values and gradients of those rounded inputs; the JAX chain's
    values and gradients in ``dtype``, as float64 arrays."""
    ranks, I, B = SHAPES[shape]
    rng = np.random.default_rng(0)
    N = len(ranks) - 1
    jd = JAX_DTYPES[dtype]
    cores = [np.asarray(jnp.asarray(rng.standard_normal((ranks[k], I, ranks[k + 1]))
                                    / np.sqrt(ranks[k]), jd)).astype(np.float64)
             for k in range(N)]
    X = rng.integers(0, I, (B, N))
    w = np.asarray(jnp.asarray(rng.standard_normal(B), jd)).astype(np.float64)
    jX = jnp.asarray(X)

    def values_and_grads(cs, weights):
        values = jax_tt_eval(cs, jX)
        grads = jax.grad(lambda cs: jnp.sum(weights * jax_tt_eval(cs, jX)))(cs)
        return (np.asarray(values).astype(np.float64),
                [np.asarray(g).astype(np.float64) for g in grads])

    ref = values_and_grads([jnp.asarray(c) for c in cores], jnp.asarray(w))
    got = values_and_grads([jnp.asarray(c, jd) for c in cores], jnp.asarray(w, jd))
    return cores, X, w, ref, got


def _err(got, ref):
    return max(float(np.abs(np.asarray(a, np.float64) - b).max()) for a, b in zip(got, ref))


def _assert_within(port, jaxs, ref, dtype, factor):
    """|port - ref| <= factor |jax - ref| + 2 u max|ref| (max over all
    entries of the lists, one scale over them)."""
    scale = max(float(np.abs(r).max()) for r in ref)
    err, jerr = _err(port, ref), _err(jaxs, ref)
    assert err <= factor * jerr + 2 * UNIT[dtype] * scale, (err, jerr, scale)


def _assert_each_within(port, jaxs, ref, dtype, extra=None):
    """Output by output, each at its own scale: |port_k - ref_k| <=
    |jax_k - ref_k| + 2 u max|ref_k| (+ u max extra_k)."""
    u = UNIT[dtype]
    for k, (a, j, r) in enumerate(zip(port, jaxs, ref)):
        allow = 2 * u * float(np.abs(r).max()) + (0 if extra is None else u * extra[k].max())
        err, jerr = _err([a], [r]), _err([j], [r])
        assert err <= jerr + allow, (k, err, jerr, allow)


def _term_sums(cores, X, w):
    """T_k = sum over the samples of each slice of |g_b L_k[b]| (outer)
    |Rt_{k+1}[b]|, from the float64 chain: the magnitudes that the plain
    backward's rounding of g L_k scales."""
    cs = [torch.from_numpy(c) for c in cores]
    Xt, g = torch.from_numpy(X), torch.from_numpy(w).abs()
    lefts = [torch.ones((X.shape[0], cs[0].shape[0]), dtype=torch.float64)]
    for k in range(len(cs) - 1):
        lefts.append(torch.einsum("br,rbs->bs", lefts[-1], cs[k][:, Xt[:, k], :]))
    right = torch.zeros((X.shape[0], cs[-1].shape[-1]), dtype=torch.float64)
    right[:, 0] = 1
    sums = [None] * len(cs)
    for k in reversed(range(len(cs))):
        outer = (g[:, None] * lefts[k].abs())[:, :, None] * right.abs()[:, None, :]
        sums[k] = torch.zeros_like(cs[k]).index_add_(1, Xt[:, k], outer.permute(1, 0, 2)).numpy()
        right = torch.einsum("rbs,bs->br", cs[k][:, Xt[:, k], :], right)
    return sums


def _port(dtype, shape):
    """The port's values and gradients through ``tn.tt_eval`` (`TTEval`; on
    the CPU its plain versions), as float64 arrays, after checking that
    both come back in the cores' dtype."""
    cores, X, w, _, _ = _case(dtype, shape)
    td = _torch_dtype(dtype)
    params = [torch.from_numpy(c).to(td).requires_grad_() for c in cores]
    values = tn.tt_eval(params, X)
    (torch.from_numpy(w).to(td) * values).sum().backward()
    assert values.dtype == td and all(p.grad.dtype == td for p in params)
    return (values.detach().double().numpy(), [p.grad.double().numpy() for p in params])


def _kernel_arithmetic(cores, X, w, td):
    """The per-sample kernels' half semantics: products and sums in float32
    inside a mode, each left and right interface rounded to ``td`` after its
    mode, the value rounded to ``td``; the gradients' terms g_b L_k[r]
    Rt_{k+1}[s] summed in float32 and rounded to ``td`` once."""
    def rnd(t):
        return t.to(td).float()

    cs = [torch.from_numpy(c).float() for c in cores]
    Xt, g = torch.from_numpy(X), torch.from_numpy(w).float()
    B, N = X.shape
    lefts = [torch.ones((B, cs[0].shape[0]))]
    for k in range(N - 1):
        lefts.append(rnd(torch.einsum("br,rbs->bs", lefts[-1], cs[k][:, Xt[:, k], :])))
    values = rnd(torch.einsum("br,rb->b", lefts[-1], cs[-1][:, Xt[:, -1], 0]))
    grads = [torch.zeros_like(c) for c in cs]
    right = torch.zeros((B, cs[-1].shape[-1]))
    right[:, 0] = 1
    for k in reversed(range(N)):
        outer = (g[:, None] * lefts[k])[:, :, None] * right[:, None, :]
        grads[k].index_add_(1, Xt[:, k], outer.permute(1, 0, 2))
        if k:  # Rt_{N-1} = C_{N-1}[:, x, 0] is a core's entries: rounding keeps it
            right = rnd(torch.einsum("rbs,bs->br", cs[k][:, Xt[:, k], :], right))
    return values.double().numpy(), [rnd(d).double().numpy() for d in grads]


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_values_and_gradient_match_jax(dtype):
    cores, X, w, ref, got = _case(dtype, "N4")
    values, grads = _port(dtype, "N4")
    _assert_each_within([values], [got[0]], [ref[0]], dtype)
    _assert_each_within(grads, got[1], ref[1], dtype, extra=_term_sums(cores, X, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_chain_matches_jax(dtype):
    cores, X, _, ref, got = _case(dtype, "N130")
    assert len(cores) > te.MAX_MODES
    values, grads = _port(dtype, "N130")
    _assert_within([values], [got[0]], [ref[0]], dtype, 1)
    _assert_within(grads, got[1], ref[1], dtype, 2)


@pytest.mark.parametrize("dtype, shape", [("bfloat16", "N4"), ("float16", "N4"),
                                          ("bfloat16", "N130")])
def test_kernel_arithmetic_matches_jax(dtype, shape):
    cores, X, w, ref, got = _case(dtype, shape)
    values, grads = _kernel_arithmetic(cores, X, w, _torch_dtype(dtype))
    if shape == "N4":
        _assert_each_within([values, *grads], [got[0], *got[1]], [ref[0], *ref[1]], dtype)
    else:
        _assert_within([values], [got[0]], [ref[0]], dtype, 1)
        _assert_within(grads, got[1], ref[1], dtype, 2)


# ---------------------------------------------------------------------------
# The plan and the mode table
# ---------------------------------------------------------------------------

def _plan(ranks, dims, itemsize, B=1 << 40, **force):
    return te._per_sample_plan(tuple(ranks), tuple(dims), B, itemsize, **force)


def test_plan_half_cores_hold_two_byte_copies_and_four_byte_interfaces():
    # staged cores in the cores' 2 bytes: twice float32's elements fit the
    # held budget; cp[X]'s 1920 staged values take 3840 bytes
    held = te._HELD_BYTES // 2
    assert _plan([1, 1], [held], 2).staged and not _plan([1, 1], [held + 1], 2).staged
    assert _plan([1, 1], [held], 2).fwd_smem == held * 2
    assert _plan([1, 5, 5, 5, 1], [32] * 4, 2).fwd_smem == 1920 * 2
    # the interfaces in float32: rank 64 keeps two a warp in shared memory
    wide = _plan([1, 64, 64, 1], [8] * 3, 2, B=4096)
    assert (wide.fwd_cols, wide.fwd_warps, wide.fwd_smem) == (0, 8, 8 * 2 * 64 * 4)
    assert wide.fwd_smem == _plan([1, 64, 64, 1], [8] * 3, 4, B=4096).fwd_smem
    # privatized gradients and the left interfaces in float32, as for
    # float32 cores: training's cores at B/I = 256
    B = te._PRIV_MIN * 256
    half, single = (_plan([1, 16, 16, 1], [256] * 3, s, B=B) for s in (2, 4))
    assert half.private == single.private == (True, False, True)
    assert half.bwd_smem == single.bwd_smem == 8192 * 4 + 8 * 2 * 33 * 4
    for itemsize in (2, 4, 8):
        assert te._acc_itemsize(itemsize) == max(itemsize, 4)


def test_grouped_paths_refuse_half_cores():
    design = ([1, 64, 64, 64, 1], [1024] * 4)
    for itemsize, want in ((2, False), (4, True), (8, True)):
        assert te._grouped(*design, 1 << 20, itemsize) is want
        assert te._grouped_backward(*design, 1 << 20, itemsize) is want


def test_grouped_routes_need_their_floor_of_bytes_a_middle_mode_past_two():
    # N = 3 and 4 keep the floors measured there; 200 modes scale them by 99
    for floor in (te._GROUP_MIN_BYTES, te._BWD_MIN_BYTES):
        assert te._floor_bytes(floor, 3) == te._floor_bytes(floor, 4) == floor
        assert te._floor_bytes(floor, 200) == 99 * floor
    # at 2^16 samples: 200 modes of rank 8 in float32 (16 MiB of slices a
    # mode) per sample, 512 modes of rank 64 in float64 (2 GiB a mode)
    # grouped, as their times on the card say
    n200 = ((1,) + (8,) * 199 + (1,), (2,) * 200)
    n512 = ((1,) + (64,) * 511 + (1,), (2,) * 512)
    for pick in (te._grouped, te._grouped_backward):
        assert not pick(*n200, 1 << 16, 4) and pick(*n512, 1 << 16, 8)
        # 198 middle slices of 256 bytes a sample reach 99 GiB at 2^21 samples
        assert pick(*n200, 1 << 21, 4) and not pick(*n200, (1 << 21) - 1, 4)


def test_plan_long_chains_spill_the_backward_lefts_only_where_they_do_not_fit():
    # 512 modes of rank 64 in float64: a sample's left interfaces (32705
    # values, 256 KB) exceed a block, so the backward keeps them in device
    # memory and its block holds nothing a warp (two columns a lane); the
    # forward holds its two interfaces a warp
    ranks, dims = (1,) + (64,) * 511 + (1,), (2,) * 512
    plan = te._plan_for("tt_eval_backward", ranks, dims, 1 << 16, 8, True)
    assert (plan.W, plan.bwd_cols, plan.bwd_spill, plan.bwd_warps) == (32, 2, True, 8)
    assert plan.private[0] and not plan.private[-1]  # the general instance holds no last core
    held = sum(te._round4(ranks[k] * 2 * ranks[k + 1]) for k in range(512) if plan.private[k])
    assert plan.bwd_smem == held * 8
    assert te._lefts_elems(plan.W, plan.bwd_cols, sum(ranks[:-1])) == 32705
    assert te._plan_for("tt_eval", ranks, dims, 1 << 16, 8, False).fwd_smem == 8 * 2 * 64 * 8
    # 200 modes of rank 8 (4 samples a warp, 1593 values each): in shared
    # memory in every dtype
    ranks, dims = (1,) + (8,) * 199 + (1,), (2,) * 200
    for itemsize in (2, 4, 8):
        plan = te._plan_for("tt_eval_backward", ranks, dims, 1 << 16, itemsize, True)
        assert not plan.bwd_spill and plan.bwd_warps >= 1
        per_warp = te._warp_elems(True, plan.W, plan.bwd_cols, 8, 1593)
        assert per_warp == 4 * 1593
        assert plan.bwd_smem <= te._SMEM
    # past MAX_MODES the kernels take their general instances, which stage
    # no cores and privatize no last core; up to it the same chain of tiny
    # cores stages and privatizes them all
    long, short = (_plan([1] * (N + 1), [2] * N, 4, B=1 << 20) for N in (130, 128))
    assert not long.staged and long.private == (True,) * 129 + (False,)
    assert short.staged and short.private == (True,) * 128
    # the interface in shared memory (rank 300): two interfaces stay in the
    # block whether the left ones spill or not
    assert te._warp_elems(True, 32, 0, 300, 5000, spill=True) == 600
    assert te._warp_elems(True, 32, 0, 300, 5000) == 5600
    assert te._warp_elems(False, 32, 0, 300, 5000) == 600


def test_mode_rows_lay_out_each_mode_in_32_bytes():
    ranks, dims = [2, 3, 5, 1], [7, 4, 6]
    rows = te._mode_rows([1 << 40, 12345, 7], [0, 99, 1 << 33], ranks, dims, [True, False, True])
    assert rows.shape == (3, 4) and rows.dtype == np.int64 and rows.nbytes == 3 * 32
    assert rows[:, 0].tolist() == [1 << 40, 12345, 7] and rows[:, 1].tolist() == [0, 99, 1 << 33]
    ints = rows.view(np.int32).reshape(3, 8)
    assert ints[:, 4].tolist() == [2, 3, 5] and ints[:, 5].tolist() == [3, 5, 1]
    assert ints[:, 6].tolist() == [7, 4, 6]
    # held cores at their places in the shared copy, each rounded up to 4
    assert ints[:, 7].tolist() == [0, -1, 44]


# ---------------------------------------------------------------------------
# The card's branch, taken on the CPU
# ---------------------------------------------------------------------------

_ITEMSIZE = {0: 4, 1: 8, 2: 2, 3: 2}


@pytest.fixture
def card_branch(monkeypatch):
    """`tt_eval`'s card branch on CPU tensors: `_on_cpu` False, `_launch` a
    spy that records each launch and runs no kernel (it zeroes the
    forward's values), the mode table built on the host, the plain versions
    raising. Yields the recorded launches (name, dtype code, N, table)."""
    calls = []

    def launch(fn, *args):
        if fn == "tnt_tt_eval":
            table, B, out = args[6], args[8], args[9]
            ctypes.memset(out.value, 0, B * _ITEMSIZE[args[0]])
        else:
            table = args[7]
        calls.append((fn, args[0], args[2], table.value))

    def plain(*args, **kwargs):
        raise AssertionError("the card's branch reached a plain version")

    def mode_table(cores, grads, ranks, dims, held):
        return torch.from_numpy(te._mode_rows(
            [c.data_ptr() for c in cores],
            [0] * len(cores) if grads is None else [d.data_ptr() for d in grads], ranks, dims,
            held))

    monkeypatch.setattr(te, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(te, "_launch", launch)
    monkeypatch.setattr(te, "_mode_table", mode_table)
    monkeypatch.setattr(te, "tt_eval_plain", plain)
    monkeypatch.setattr(te, "tt_eval_backward_plain", plain)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    te.reset_launches()
    yield calls
    te.reset_launches()


DISPATCH = [("bfloat16", "N4"), ("float16", "N4"), ("float32", "N130"), ("bfloat16", "N130")]


def _dispatch_cores(dtype, shape):
    ranks, I, B = SHAPES[shape]
    rng = np.random.default_rng(1)
    cores = [torch.from_numpy(rng.standard_normal((ranks[k], I, ranks[k + 1])))
             .to(_torch_dtype(dtype)) for k in range(len(ranks) - 1)]
    return cores, torch.from_numpy(rng.integers(0, I, (B, len(cores))))


@pytest.mark.parametrize("dtype, shape", DISPATCH)
def test_tt_eval_and_its_gradient_launch_the_per_sample_kernels(card_branch, dtype, shape):
    cores, X = _dispatch_cores(dtype, shape)
    params = [c.requires_grad_() for c in cores]
    values = tn.tt_eval(params, X)
    values.sum().backward()
    code, N = te._DTYPES[_torch_dtype(dtype)], len(cores)
    assert [c[:3] for c in card_branch] == [("tnt_tt_eval", code, N),
                                           ("tnt_tt_eval_backward", code, N)]
    # a table in device memory past MAX_MODES (the general instances), none
    # up to it
    assert all((table is not None) == (N > te.MAX_MODES) for *_, table in card_branch)
    assert (te.tt_eval_kernel.launches, te.tt_eval_backward_kernel.launches) == (1, 1)
    assert te.tt_eval_kernel.grouped == te.tt_eval_backward_kernel.grouped == 0
    # the values and gradients in the cores' dtype (the backward's float32
    # scratch rounded once)
    assert values.dtype == cores[0].dtype and all(p.grad.dtype == cores[0].dtype for p in params)


@pytest.mark.parametrize("dtype, shape", DISPATCH)
def test_indexing_tt_batch_forward_and_optimize_launch_the_kernels(card_branch, dtype, shape):
    cores, X = _dispatch_cores(dtype, shape)
    t = tn.Tensor(cores, device="cpu")
    assert t[X].full().dtype == cores[0].dtype
    te.tt_batch_forward(cores, X)
    assert te.tt_eval_kernel.launches == 2 and len(card_branch) == 2
    t = tn.Tensor([c.clone() for c in cores], device="cpu", requires_grad=True)
    y = torch.zeros(X.shape[0], dtype=cores[0].dtype)
    hist = tn.optimize([t], lambda t: torch.mean((t[X].full() - y) ** 2), tol=None, max_iter=2,
                       verbose=False)
    assert len(hist) == 3
    assert (te.tt_eval_kernel.launches, te.tt_eval_backward_kernel.launches) == (5, 3)
    assert {c[1] for c in card_branch} == {te._DTYPES[cores[0].dtype]}
    assert te.tt_eval_kernel.grouped == te.tt_eval_backward_kernel.grouped == 0


def test_half_backward_sums_in_a_float32_scratch_rounded_once(card_branch, monkeypatch):
    # the backward launches into a float32 gradient buffer and returns it
    # rounded to the cores' dtype
    cores, X = _dispatch_cores("bfloat16", "N4")
    seen = []

    def launch(fn, *args):
        grads = args[4]  # the gradients' addresses: fill the first entry of each
        for k in range(len(cores)):
            seen.append(grads[k])
            ctypes.c_float.from_address(grads[k]).value = 1 + 2.0**-10 + k

    monkeypatch.setattr(te, "_launch", launch)
    g = torch.ones(X.shape[0], dtype=torch.bfloat16)
    grads = te.tt_eval_backward_kernel(cores, X, g)
    assert len(seen) == len(cores)
    for k, d in enumerate(grads):
        assert d.dtype == torch.bfloat16 and d.shape == cores[k].shape
        assert float(d.flatten()[0]) == float(torch.tensor(1 + 2.0**-10 + k).to(torch.bfloat16))
        assert not d.flatten()[1:].any()


def test_long_chain_backward_gets_a_bounded_spill(card_branch, monkeypatch):
    # 512 modes of rank 64 in float64 on the per-sample kernel (at 2^14
    # samples `_grouped_backward` would take the grouped path): the spill
    # holds one slot of left interfaces a warp of the grid, at most
    # _SPILL_BYTES, whatever B
    monkeypatch.setattr(te, "_grouped_backward", lambda *args: False)
    ranks = [1] + [64] * 511 + [1]
    cores = [torch.zeros((ranks[k], 2, ranks[k + 1]), dtype=torch.float64) for k in range(512)]
    sizes = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        if kw.get("dtype") == torch.float64 and t.numel() % 32705 == 0 and t.numel():
            sizes.append(t.numel() // 32705)
        return t

    monkeypatch.setattr(te.torch, "empty", spy)
    for B in (64, 1 << 14):
        X = torch.zeros((B, 512), dtype=torch.int64)
        te.tt_eval_backward_kernel(cores, X, torch.ones(B, dtype=torch.float64))
        launch = card_branch[-1]
        assert launch[0] == "tnt_tt_eval_backward" and launch[3] is not None
    slots = te._SPILL_BYTES // (32705 * 8)
    assert sizes == [64, slots] and slots * 32705 * 8 <= te._SPILL_BYTES


# ---------------------------------------------------------------------------
# Weights carried from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tensor_from_arrays_keeps_half_dtypes(dtype):
    rng = np.random.default_rng(2)
    arrays = [np.asarray(jnp.asarray(rng.standard_normal(s), JAX_DTYPES[dtype]))
              for s in [(1, 4, 3), (3, 5, 2), (2, 6, 1)]]
    t = interop.tensor_from_arrays(arrays, device="cpu")
    for c, a in zip(t.cores, arrays):
        assert c.dtype == _torch_dtype(dtype)
        assert np.array_equal(c.float().numpy(), a.astype(np.float32))
    X = np.stack([rng.integers(0, I, 9) for I in (4, 5, 6)], axis=1)
    want = np.asarray(jax_tt_eval([jnp.asarray(a) for a in arrays], jnp.asarray(X)))
    got = t[X].full()
    assert got.dtype == _torch_dtype(dtype)
    err = np.abs(got.double().numpy().ravel() - want.astype(np.float64)).max()
    assert err <= 2 * UNIT[dtype] * np.abs(want.astype(np.float64)).max()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_half_and_long_chain_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for dtype, shape in DISPATCH:
        cores, X, w, _, _ = _case(dtype, shape)
        td = _torch_dtype(dtype)
        cs = [torch.from_numpy(c).to("cuda", td) for c in cores]
        Xt, g = torch.from_numpy(X).cuda(), torch.from_numpy(w).to("cuda", td)
        ref = (te.tt_eval_plain([c.double() for c in cs], Xt).cpu().numpy(),
               [d.cpu().numpy() for d in te.tt_eval_backward_plain([c.double() for c in cs], Xt,
                                                                  g.double())])
        plain = (te.tt_eval_plain(cs, Xt).cpu().double().numpy(),
                 [d.cpu().double().numpy() for d in te.tt_eval_backward_plain(cs, Xt, g)])
        te.reset_launches()
        got = te.tt_eval_kernel(cs, Xt)
        grads = te.tt_eval_backward_kernel(cs, Xt, g)
        torch.cuda.synchronize()
        assert (te.tt_eval_kernel.launches, te.tt_eval_backward_kernel.launches) == (1, 1)
        assert got.dtype == td and all(d.dtype == td for d in grads)
        got = [got.cpu().double().numpy()] + [d.cpu().double().numpy() for d in grads]
        if dtype == "float32":
            _assert_within(got[:1], [plain[0]], [ref[0]], dtype, 1)
            _assert_within(got[1:], plain[1], ref[1], dtype, 2)
        else:  # output by output against the plain version of the kernels' arithmetic
            want = _kernel_arithmetic(cores, X, w, td)
            _assert_each_within(got, [want[0], *want[1]], [ref[0], *ref[1]], dtype)
