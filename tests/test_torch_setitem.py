"""Assignment ``t[key] = value`` in the port (tntorch_tpu_torch/tensor.py,
``Tensor.__setitem__``) against the JAX package's, on the same NumPy inputs
in float64 on the CPU.

Assignment is algebra (``t - old + new``), so the ranks grow and the cores
are a gauge apart: the tests compare dense reconstructions, to 1e-12
relative, and each against NumPy's assignment on the dense array. The
cases mirror the JAX package's own (tests/test_defect_fixes.py,
tests/test_batch_lift.py): batch keys, trailing and non-trailing int keys,
repeated and negative indices, CP and Tucker targets, Tensor and array
values, and trainability kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import interop

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _tt(seed, shape, R=2, batch=0):
    rng = np.random.default_rng(seed)
    b = (batch,) if batch else ()
    ranks = [1] + [R] * (len(shape) - 1) + [1]
    return [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _cp(seed, shape, R=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, R)) for s in shape]


def _pair(cores, batch=False, Us=None):
    t = interop.tensor_from_arrays(cores, Us=Us, batch=batch, device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=batch,
                    Us=None if Us is None else [None if U is None else jnp.asarray(U)
                                                for U in Us])
    return t, jt


def _rng_array(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= TOL * max(np.linalg.norm(want), 1.0)


# name -> (target: (cores, batch, Us), key, value: a scalar, an array, or
# ("tensor", cores, batch, Us) for a Tensor value)
CASES = {
    "batch_int_key": ((_tt(1, (4, 5), batch=3), True, None), (1, slice(None), slice(None)),
                      _rng_array(2, (4, 5))),
    "batch_trailing_int_key": ((_tt(3, (4, 5), batch=3), True, None),
                               (slice(None), slice(None), 2), _rng_array(4, (3, 4))),
    "batch_np_integer_key": ((_tt(5, (5, 5), batch=3), True, None), np.int64(0),
                             np.ones((5, 5))),
    "batch_slice_tensor_value": ((_tt(6, (4, 5), batch=2), True, None),
                                 (slice(None), slice(1, 3)),
                                 ("tensor", _tt(7, (2, 5), batch=2), True, None)),
    "repeated_rows_tensor_value": ((_tt(8, (5, 6, 7), R=3), False, None), [0, 2, 0],
                                   ("tensor", _tt(9, (3, 6, 7)), False, None)),
    "repeated_rows_array_value": ((_tt(10, (4, 5, 6)), False, None), [1, 1],
                                  _rng_array(11, (2, 5, 6))),
    "repeated_negative_scalar": ((_tt(12, (5, 4)), False, None), [1, -1, 1], 3.14),
    "negative_int_scalar": ((_tt(13, (4, 5, 6)), False, None), -1, 0.0),
    "leading_int_array": ((_tt(14, (5, 5)), False, None), 1, np.zeros(5)),
    "middle_int_array": ((_tt(15, (4, 5, 6)), False, None), (slice(None), 2, slice(None)),
                         np.ones((4, 6))),
    "two_int_keys": ((_tt(16, (4, 5, 6)), False, None), (2, 3), np.ones(6)),
    "negative_middle_int": ((_tt(17, (4, 5, 6)), False, None), (slice(None), -2),
                            _rng_array(18, (4, 6))),
    "negative_int_tensor_value": ((_tt(32, (4, 5, 6), R=3), False, None), (slice(None), -2),
                                  ("tensor", _tt(33, (4, 6), R=1), False, None)),
    "slab_rank1_tensor": ((_tt(19, (4, 6, 5), R=3), False, None),
                          (slice(None), slice(1, 4), slice(None)),
                          ("tensor", _tt(20, (4, 3, 5), R=1), False, None)),
    "cp_target": ((_cp(21, (5, 5)), False, None), 1, np.ones(5)),
    "cp_target_cp_value": ((_cp(22, (4, 5, 6)), False, None), (slice(1, 3),),
                           ("tensor", _cp(23, (2, 5, 6), R=2), False, None)),
    "tucker_target": ((_tt(24, (3, 4, 3)), False, [_rng_array(25, (6, 3)), None,
                                                   _rng_array(26, (5, 3))]),
                      (slice(None), slice(0, 2), 4), _rng_array(27, (6, 2))),
    "tucker_value": ((_tt(28, (6, 4, 5)), False, None), (slice(2, 4),),
                     ("tensor", _tt(29, (2, 3, 5)), False,
                      [None, _rng_array(30, (4, 3)), None])),
    "fancy_bool_mask": ((_tt(31, (5, 4)), False, None),
                        (np.array([True, False, True, False, False]),), 2.5),
}


# The JAX package rebuilds a value densely where an int key dropped a
# middle mode, which changes the value's ranks between two of its cores: a
# low-rank Tensor value then fails its constructor's rank check (ROADMAP.md,
# known faults in the reference). The port inserts a singleton mode instead
JAX_FAILS = {"negative_int_tensor_value": "Core ranks do not match"}


def _value(spec, package):
    if isinstance(spec, tuple) and spec and spec[0] == "tensor":
        t, jt = _pair(*spec[1:])
        return t if package == "port" else jt
    return spec


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_assignment_matches_jax_and_numpy(case):
    (cores, batch, Us), key, spec = CASES[case]
    t, jt = _pair(cores, batch, Us)
    want = np.array(jt.numpy())
    value = _value(spec, "port")
    dense_value = value.numpy() if isinstance(value, tn.Tensor) else value
    want[key] = dense_value
    t[key] = value
    _close(t.numpy(), want)
    assert t.device.type == "cpu" and t.dtype == torch.float64
    if case in JAX_FAILS:
        with pytest.raises(ValueError, match=JAX_FAILS[case]):
            jt[key] = _value(spec, "jax")
        return
    jt[key] = _value(spec, "jax")
    _close(t.numpy(), np.asarray(jt.numpy()))


def test_assignment_keeps_trainability_and_factors_frozen():
    cores = _tt(40, (5, 6), R=2)
    Us = [_rng_array(41, (5, 3)), _rng_array(42, (6, 3))]
    t = tn.Tensor([torch.from_numpy(c[:, :3]) for c in cores], Us=[torch.from_numpy(U)
                                                                       for U in Us],
                  requires_grad=True)
    jt = jtn.Tensor([jnp.asarray(c[:, :3]) for c in cores], Us=[jnp.asarray(U) for U in Us],
                    requires_grad=True)
    t.set_factors("legendre")
    jt.set_factors("legendre")
    t[0, :] = 1.0
    jt[0, :] = 1.0
    _close(t.numpy(), np.asarray(jt.numpy()))
    assert t.requires_grad and jt.requires_grad
    assert t.frozen_Us == jt.frozen_Us == {0, 1}
    # the new cores are leaves again, as the constructor makes them
    assert all(c.is_leaf and c.requires_grad for c in t.cores)
    tn.normsq(t).backward()
    assert all(c.grad is not None and bool(torch.isfinite(c.grad).all()) for c in t.cores)


def test_gradient_flows_through_the_scatters():
    # Cores that are not the tensor's leaves: the assignment's index writes
    # keep them in the graph. The gradient of sum(t) after t[1] = 2 is the
    # gradient of the dense sum with row 1 masked out
    cores = [torch.from_numpy(c).requires_grad_() for c in _tt(43, (4, 5, 3), R=3)]
    t = tn.Tensor(list(cores))
    t[1] = 2.0
    t.full().sum().backward()
    ref = [c.detach().clone().requires_grad_() for c in cores]
    mask = torch.ones(4, 5, 3, dtype=torch.float64)
    mask[1] = 0
    (tn.Tensor(ref).full() * mask).sum().backward()
    for c, r in zip(cores, ref):
        _close(c.grad.numpy(), r.grad.numpy())


def test_dimension_mismatch_raises_the_jax_message():
    t, jt = _pair(_tt(44, (4, 5, 6)))
    value = np.ones((4, 5, 3))
    with pytest.raises(ValueError) as mine:
        t[:, :, 0:2] = value
    with pytest.raises(ValueError) as theirs:
        jt[:, :, 0:2] = value
    assert str(mine.value) == str(theirs.value) == (
        "2-th dimension mismatch in tensor assignment: 2 (lhs) != 3 (rhs)")
