"""Saving and loading in the port (tntorch_tpu_torch/serialization.py)
against the JAX package's (tntorch_tpu/serialization.py): one ``.npz``
layout, so each package loads the other's files. Both directions are
checked, the loaded arrays bitwise equal to the saved ones: TT, Tucker,
CP, a batch, ``idxs``, ``frozen_Us``, ``TTMatrix`` and ``CPMatrix``.

The orbax checkpoints are directories of torch.distributed.checkpoint in
the port, and of orbax in the JAX package: each package's round trip gives
the same inputs back bitwise, the sharded pair's sidecars agree, and
neither loads the other's directory. Placed tensors on 4 ranks:
tests/test_torch_parallel_paths.py.
"""

import json

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


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


# name -> (cores, Us, batch, idxs, frozen_Us)
TENSORS = {
    "tt": (_arrays(1, [(1, 4, 2), (2, 5, 3), (3, 6, 1)]), None, False, None, ()),
    "tucker_frozen": (_arrays(2, [(1, 3, 2), (2, 4, 2), (2, 3, 1)]),
                      _arrays(3, [(5, 3), (6, 4)]) + [None], False, None, (0,)),
    "cp": (_arrays(4, [(4, 3), (5, 3), (6, 3)]), None, False, None, ()),
    "cp_tt_hybrid": (_arrays(5, [(4, 2), (2, 5, 3), (6, 3)]), None, False, None, ()),
    "batch": (_arrays(6, [(2, 1, 4, 2), (2, 2, 5, 1)]), None, True, None, ()),
    "batch_tucker": (_arrays(7, [(2, 1, 3, 2), (2, 2, 4, 1)]),
                     [_arrays(8, [(2, 5, 3)])[0], None], True, None, (0,)),
    "idxs": (_arrays(9, [(1, 4, 2), (2, 3, 1)]), None, False,
             [np.array([3, 1, 0, 2]), np.array([0, 1, 1])], ()),
}


def _pair(case):
    cores, Us, batch, idxs, frozen = TENSORS[case]
    t = interop.tensor_from_arrays(cores, Us=Us, batch=batch, device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=batch, idxs=idxs,
                    Us=None if Us is None else [None if U is None else jnp.asarray(U)
                                                for U in Us])
    if idxs is not None:
        t.idxs = [np.asarray(i) for i in idxs]
    t.frozen_Us, jt.frozen_Us = set(frozen), set(frozen)
    return t, jt


def _same(got, want):
    """Two tensors (either package) hold bitwise the same arrays and state."""
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    assert got.batch == want.batch and got.frozen_Us == want.frozen_Us
    assert len(got.cores) == len(want.cores)
    for a, b in zip(list(got.cores) + list(got.Us), list(want.cores) + list(want.Us)):
        assert (a is None) == (b is None)
        if a is not None:
            a, b = host(a), host(b)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    for a, b in zip(got.idxs, want.idxs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", TENSORS, ids=list(TENSORS))
def test_each_package_loads_the_others_file(case, tmp_path):
    t, jt = _pair(case)
    jtn.save(jt, tmp_path / "from_jax.npz")
    got = tn.load(tmp_path / "from_jax.npz", device="cpu")
    assert all(c.device.type == "cpu" for c in got.cores)
    _same(got, jt)
    tn.save(t, tmp_path / "from_port")  # .npz appended, as np.savez does
    _same(jtn.load(tmp_path / "from_port"), t)
    _same(tn.load(tmp_path / "from_port", device="cpu"), t)
    # the two packages contract the same arrays in their own orders
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.numpy()), rtol=0, atol=1e-13)


def test_matrices_cross_load(tmp_path):
    rng = np.random.default_rng(10)
    tt_cores = [rng.standard_normal(s) for s in [(1, 2, 3, 2), (2, 4, 2, 1)]]
    M = rng.standard_normal((8, 6))
    for kind, jm in (("tt", jtn.TTMatrix([jnp.asarray(c) for c in tt_cores], None, [2, 4],
                                         [3, 2])),
                     ("cp", jtn.CPMatrix(jnp.asarray(M), 2, [2, 4], [3, 2]))):
        jtn.save_matrix(jm, tmp_path / f"{kind}_jax.npz")
        m = tn.load_matrix(tmp_path / f"{kind}_jax.npz", device="cpu")
        assert type(m).__name__ == type(jm).__name__
        tn.save_matrix(m, tmp_path / f"{kind}_port.npz")
        back = jtn.load_matrix(tmp_path / f"{kind}_port.npz")
        for a, b, c in zip(m.cores, jm.cores, back.cores):
            assert a.dtype == torch.float64 and a.device.type == "cpu"
            assert np.array_equal(a.numpy(), np.asarray(b))
            assert np.array_equal(np.asarray(c), np.asarray(b))
        for other in (m, back):
            assert list(other.input_dims) == [2, 4] and list(other.output_dims) == [3, 2]
        if kind == "cp":
            assert m.rank == back.rank == 2 and m.batch_size == back.batch_size == 1
        np.testing.assert_allclose(m.numpy(), np.asarray(jm.numpy()), rtol=0, atol=1e-13)
    with pytest.raises(TypeError, match="TTMatrix or CPMatrix"):
        tn.save_matrix(object(), tmp_path / "bad.npz")


def test_bfloat16_is_refused_and_loads_land_on_the_card(tmp_path):
    t = tn.Tensor([torch.ones(1, 3, 1, dtype=torch.bfloat16)])
    with pytest.raises(TypeError, match="bfloat16"):
        tn.save(t, tmp_path / "bf16.npz")
    assert not (tmp_path / "bf16.npz").exists()
    tn.save(tn.Tensor([torch.ones(1, 3, 1)]), tmp_path / "f32.npz")
    if torch.cuda.is_available():
        assert tn.load(tmp_path / "f32.npz").device.type == "cuda"
    else:  # no card here: the default device is the card, and moving there raises
        with pytest.raises((AssertionError, RuntimeError)):
            tn.load(tmp_path / "f32.npz")


@pytest.mark.parametrize("case", ["tucker_frozen", "batch", "batch_tucker", "idxs"])
def test_orbax_round_trips_match_jax(case, tmp_path):
    t, jt = _pair(case)
    jtn.save_orbax(jt, tmp_path / "jax")
    jback = jtn.load_orbax(tmp_path / "jax")
    tn.save_orbax(t, tmp_path / "port")
    back = tn.load_orbax(tmp_path / "port", device="cpu")
    for got in (jback, back):
        _same(got, jt)
        _same(got, t)
    assert all(c.device.type == "cpu" for c in back.cores)
    with pytest.raises(ValueError, match="neither package loads the other's"):
        tn.load_orbax(tmp_path / "jax", device="cpu")
    with pytest.raises(Exception):  # orbax finds no checkpoint of its own there
        jtn.load_orbax(tmp_path / "port")


def test_orbax_sharded_without_a_mesh_matches_jax(tmp_path):
    t, jt = _pair("batch_tucker")
    jtn.save_orbax_sharded(jt, tmp_path / "jax")
    tn.save_orbax_sharded(t, tmp_path / "port")
    with open(tmp_path / "jax.specs.json") as a, open(tmp_path / "port.specs.json") as b:
        sidecar = json.load(b)
        assert sidecar == json.load(a)
    assert sidecar["core_specs"] == [None, None]  # plain tensors: not placed
    _same(tn.load_orbax_sharded(tmp_path / "port", device="cpu"), t)
    _same(jtn.load_orbax_sharded(tmp_path / "jax"), jt)
    with pytest.raises(ValueError, match="neither package loads the other's"):
        tn.load_orbax_sharded(tmp_path / "jax", device="cpu")
    with pytest.raises(ValueError, match="no save_orbax payload"):
        tn.load_orbax(tmp_path / "port", device="cpu")
    if not torch.cuda.is_available():  # the default device is the card: moving there raises
        tn.save_orbax(t, tmp_path / "whole")
        for load, where in ((tn.load_orbax_sharded, "port"), (tn.load_orbax, "whole")):
            with pytest.raises((AssertionError, RuntimeError)):
                load(tmp_path / where)
