"""Indexing of the port's Tensor (tntorch_tpu_torch/tensor.py) against the
JAX package's: the same numpy cores, the same keys, dense results compared
(f64, only summation order differs: 1e-12 relative). A key of coordinate
arrays for every mode goes through TTEval, whose gradient is held against
jax.grad. Also the device default: data without a device goes to the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _cores(seed, batch=0, ranks=(1, 3, 4, 2, 1), shape=(5, 6, 7, 4)):
    rng = np.random.default_rng(seed)
    b = (batch,) if batch else ()
    return [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _pair(seed, batch=0, **kw):
    cores = _cores(seed, batch, **kw)
    return (interop.tensor_from_arrays(cores, batch=bool(batch), device="cpu"),
            jtn.Tensor([jnp.asarray(c) for c in cores], batch=bool(batch)))


def _dense(x):
    if hasattr(x, "cores"):
        x = x.full()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-12):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


_IDX = np.array([4, 0, -1, 2, 2])
KEYS = {
    "int": (2,),
    "negative_ints": (-1, -2),
    "all_ints": (1, 2, 3, 0),
    "negative_all_ints": (-5, 0, -1, 3),
    "slices_with_steps": (slice(1, None, 2), slice(None, None, -2), slice(0, 5, 3)),
    "int_and_slice": (slice(None), 3, slice(1, 4)),
    "one_index_array": (_IDX,),
    "index_array_mid": (slice(None), np.array([5, 1, -6])),
    "several_index_arrays": (np.array([0, 1, 4]), np.array([5, 0, 2])),
    "index_arrays_then_int": (np.array([0, 1]), np.array([5, 0]), 3),
    "int_then_index_arrays": (2, np.array([0, 1, 5]), np.array([5, 0, 6])),
    "list_index": ([0, 3, 3],),
    "none": (None, 1),
    "none_mid": (slice(None), None, 2, None),
    "ellipsis": (Ellipsis, 1),
    "ellipsis_mid": (0, Ellipsis, slice(1, 3)),
    "all_index_arrays": (np.array([0, 4, -1]), np.array([5, 0, 2]), np.array([1, 1, 6]),
                         np.array([3, -4, 0])),
    # a boolean array as long as its mode is a mask over it, as in NumPy
    "bool_mask": (np.array([True, False, True, True, False]),),
    "bool_mask_mid": (slice(None), np.array([True, False, False, True, True, False])),
    "bool_mask_after_ellipsis": (Ellipsis, np.array([False, True, True, False])),
    "bool_mask_with_index_array": (np.array([True, False, True, False, True]),
                                   np.array([5, 0, 2])),
}


@pytest.mark.parametrize("key", KEYS, ids=list(KEYS))
def test_getitem_matches_jax(key):
    t, jt = _pair(1)
    _close(t[KEYS[key]], jt[KEYS[key]])


def test_coordinate_matrix_keys_match_jax_and_run_tteval():
    t, jt = _pair(2)
    rng = np.random.default_rng(3)
    X = np.stack([rng.integers(-s, s, 30) for s in t.shape], axis=1)
    want = jt[jnp.asarray(X)]
    for key in (X, torch.from_numpy(X), torch.from_numpy(X).int(), list(X.T), tuple(X.T)):
        got = t[key]
        assert [tuple(c.shape) for c in got.cores] == [tuple(c.shape) for c in want.cores] \
            == [(1, 30, 1)]
        _close(got, want)
    # the (1, P, 1) core comes from TTEval: its gradient node is TTEval's
    p, _ = _pair(2)
    p.cores = [c.requires_grad_() for c in p.cores]
    view = p[X].cores[0].grad_fn  # the reshape of TTEval's (P,) values
    assert type(view.next_functions[0][0]).__name__ == "TTEvalBackward"
    # boundary ranks other than 1 keep the JAX package's (R_0, P, R_N) core
    b, jb = _pair(4, ranks=(2, 3, 4, 2, 3))
    got, want = b[X], jb[jnp.asarray(X)]
    assert got.cores[0].shape == want.cores[0].shape == (2, 30, 3)
    _close(got, want)


BATCH_KEYS = {
    "sample": (1,),
    "negative_sample": (-1,),
    "sample_slice": (slice(0, 2),),
    "sample_and_ints": (0, 2, 3),
    "all_ints": (2, 1, 0, 3, 1),
    "slice_then_int": (slice(None), 4),
    "slice_then_index_arrays": (slice(None), np.array([0, 4]), np.array([1, 5])),
    "index_batch": (np.array([2, 0]),),
    "index_batch_then_int": (np.array([2, 0]), 3),
    "none": (slice(None), None, 1),
    "ellipsis": (Ellipsis, 2),
    "sample_ellipsis": (1, Ellipsis, slice(0, 2)),
    "slice_then_bool_mask": (slice(None), np.array([True, False, True, True, False])),
    "bool_mask_mid": (slice(None), slice(None), np.array([False, True, True, False, True, True])),
}


@pytest.mark.parametrize("key", BATCH_KEYS, ids=list(BATCH_KEYS))
def test_batch_getitem_matches_jax(key):
    t, jt = _pair(5, batch=3)
    got, want = t[BATCH_KEYS[key]], jt[BATCH_KEYS[key]]
    assert getattr(got, "batch", None) == getattr(want, "batch", None)
    _close(got, want)


ERRORS = {
    "too_many_entries": ((0, 0, 0, 0, 0), IndexError, "Too many index entries"),
    "two_ellipses": ((Ellipsis, 0, Ellipsis), IndexError, "Only one ellipsis"),
    "non_contiguous_arrays": ((np.array([0, 1]), 0, np.array([1, 2])), IndexError,
                              "contiguously"),
    "different_lengths": ((np.array([0, 1]), np.array([1, 2, 3])), ValueError, "same length"),
    "different_lengths_all_modes": (tuple(np.array([0] * n) for n in (2, 2, 2, 3)), ValueError,
                                    "same length"),
    "float_key": ((1.5,), IndexError, None),
    "out_of_range_array": ((np.array([0, 5]),), IndexError, "out of range"),
    "out_of_range_coordinates": (np.array([[0, 0, 0, 4]]), IndexError, None),
    "bool_mask_of_another_length": ((np.array([True, False]),), IndexError, "boolean index"),
    "two_dimensional_bool": ((np.ones((5, 1), bool),), IndexError, "boolean index"),
}


@pytest.mark.parametrize("case", ERRORS, ids=list(ERRORS))
def test_getitem_errors(case):
    key, error, match = ERRORS[case]
    t, _ = _pair(6)
    with pytest.raises(error, match=match):
        t[key]


@pytest.mark.parametrize("key, match", [
    ((slice(None), np.array([0, 1]), np.array([0, 1])), None),
    ((np.array([0, 1]), np.array([0, 1])), "Advanced indexing is prohibited"),
    ((None, 0), "Cannot change batch dimension"),
], ids=["allowed", "batch_and_mode_arrays", "none_before_batch"])
def test_batch_getitem_errors_match_jax(key, match):
    t, jt = _pair(7, batch=3)
    if match is None:
        _close(t[key], jt[key])
        return
    for x in (t, jt):
        with pytest.raises(ValueError, match=match):
            x[key]


def test_bool_masks_on_every_mode_follow_numpy():
    # Several masks select their coordinates jointly, as in NumPy; the JAX
    # package raises here (it compares a mask's length, not its count of
    # True, with the arrays before it), so the dense tensor is the reference
    t, jt = _pair(9, shape=(5, 5, 5, 5))
    rng = np.random.default_rng(10)
    masks = tuple(np.isin(np.arange(5), rng.choice(5, 3, replace=False)) for _ in range(4))
    _close(t[masks], _dense(jt)[masks])
    with pytest.raises(ValueError, match="same length"):
        jt[masks]


def test_mask_tensor_key_is_not_ported():
    """Assigning through a mask-Tensor key (ported with every assignment)
    writes where reading through it selects; the JAX package's assignment
    fails on such a key with a TypeError."""
    t, jt = _pair(8)
    key = tn.presence(4, [0, 2], device="cpu", dtype=t.dtype) & tn.absence(
        4, [1, 3], device="cpu", dtype=t.dtype)
    # with the default idxs, symbol 1 is every coordinate but 0
    want = t.numpy()
    want[1:, 0, 1:, 0] = 0.0
    t[key] = 0.0
    _close(t.numpy(), want)
    with pytest.raises(TypeError):
        jt[jtn.presence(4, [0, 2]) & jtn.absence(4, [1, 3])] = 0.0


def test_mask_tensor_key_matches_jax():
    """A mask-Tensor key with one accepted string selects as in the JAX
    package (tests/test_torch_logic.py holds more of them), and a tensor
    that is not such a mask is refused as the JAX package refuses it."""
    t, jt = _pair(8)
    with pytest.raises(ValueError, match="exactly 1 accepting string"):
        t[t]
    key = tn.presence(4, [0, 2], device="cpu", dtype=t.dtype) & tn.absence(
        4, [1, 3], device="cpu", dtype=t.dtype)
    # with the default idxs, symbol 1 is every coordinate but 0
    _close(t[key], jt[jtn.presence(4, [0, 2]) & jtn.absence(4, [1, 3])])
    _close(t[key], _dense(jt)[1:, 0, 1:, 0])


def test_gradient_through_indexing_matches_jax_grad():
    cores = _cores(9)
    rng = np.random.default_rng(10)
    X = np.stack([rng.integers(-s, s, 25) for s in (5, 6, 7, 4)], axis=1)
    w = rng.standard_normal(25)

    def jloss(cs):
        return jnp.sum(jnp.asarray(w) * jtn.Tensor(cs)[jnp.asarray(X)].full())

    want = jax.grad(jloss)([jnp.asarray(c) for c in cores])
    t = tn.Tensor([torch.from_numpy(c) for c in cores], requires_grad=True)
    assert t.requires_grad and all(c.is_leaf and c.requires_grad for c in t.cores)
    (torch.from_numpy(w) * t[X].full()).sum().backward()
    for c, g in zip(t.cores, want):
        _close(c.grad, g)
    # a slice-and-int key differentiates through the plain gathers
    t.cores = [c.detach().requires_grad_() for c in t.cores]
    jt = jax.grad(lambda cs: jnp.sum(jtn.Tensor(cs)[1, :, -2].full() ** 2))(
        [jnp.asarray(c) for c in cores])
    (t[1, :, -2].full() ** 2).sum().backward()
    for c, g in zip(t.cores, jt):
        _close(c.grad, g)


def test_data_without_a_device_goes_to_the_card():
    x = np.ones((2, 3))
    cores = _cores(11, ranks=(1, 2, 1), shape=(3, 4))
    makers = (lambda: tn.Tensor(x), lambda: tn.Tensor([c for c in cores]),
              lambda: interop.tensor_from_arrays(cores), lambda: tn.utils.asarray(x),
              lambda: tn.utils.seed(0), lambda: tn.rand([3, 4], ranks_tt=2))
    assert tn.utils.default_device() == "cuda"
    if torch.cuda.is_available():
        for make in makers:
            made = make()
            assert made.device.type == "cuda"
    else:  # no silent CPU fallback
        for make in makers:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
    # an explicit device, or a torch tensor's own, is kept
    assert tn.Tensor(x, device="cpu").device.type == "cpu"
    assert tn.Tensor(torch.from_numpy(x)).device.type == "cpu"
    assert interop.tensor_from_arrays(cores, device="cpu").device.type == "cpu"
    assert tn.utils.seed(0, device="cpu").device.type == "cpu"
