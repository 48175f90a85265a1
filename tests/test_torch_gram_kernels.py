"""The port's Gram-sweep kernels (tntorch_tpu_torch/ops/gram_kernels.py)
against the JAX package's Pallas kernels (tntorch_tpu/ops/pallas_gram.py).

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are compared with those versions on the card (chip_smoke.py, and
the `cuda`-marked test below)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntorch_tpu.ops.pallas_gram import pallas_gram_edge, pallas_proj2, pallas_wgram
from tntorch_tpu_torch import _build
from tntorch_tpu_torch.ops import gram_kernels as gk


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _inputs(shape, dtype, seed):
    """C, a PSD G and W, Y and X for shape (B, Rl, I, Rr, r1, r2), as numpy."""
    rng = np.random.default_rng(seed)
    B, Rl, I, Rr, r1, r2 = shape

    def psd(n):
        A = rng.standard_normal((B, n, n))
        return A @ np.swapaxes(A, -1, -2) / n

    arrays = {
        "C": rng.standard_normal((B, Rl, I, Rr)),
        "G": psd(Rr),
        "W": psd(Rl),
        "Y": rng.standard_normal((B, r1, Rl)),
        "X": rng.standard_normal((B, Rr, r2)),
    }
    return {k: v.astype(dtype) for k, v in arrays.items()}


ARGS = {"gram_edge": ("C", "G"), "wgram": ("C", "W"), "proj2": ("Y", "C", "X")}


def _port(name, a):
    return getattr(gk, name)(*(torch.from_numpy(a[k]) for k in ARGS[name])).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["gram_edge", "wgram", "proj2"])
def test_plain_version_matches_pallas_interpret(name):
    # f32 at a shape the Pallas gates accept (Rr 128-aligned, Rl and r1
    # multiples of 8); r2=24 makes pallas_proj2 pad to 128 lanes. Both sides
    # sum up to I*Rr = 4096 f32 terms per output in different orders:
    # within 1e-4 of max|ref|, the JAX package's own tolerance.
    a = _inputs((2, 16, 32, 128, 8, 24), np.float32, seed=21)
    pallas = {"gram_edge": pallas_gram_edge, "wgram": pallas_wgram, "proj2": pallas_proj2}[name]
    want = np.asarray(pallas(*(jnp.asarray(a[k]) for k in ARGS[name]), interpret=True))
    got = _port(name, a)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4


JAX_EINSUM = {
    "gram_edge": lambda C, G: jnp.einsum("zaic,zdic->zad", jnp.einsum("zaib,zbc->zaic", C, G), C),
    "wgram": lambda C, W: jnp.einsum("zaib,zad,zdic->zbc", C, W, C),
    "proj2": lambda Y, C, X: jnp.einsum("zra,zaib,zbc->zric", Y, C, X),
}


@pytest.mark.parametrize("shape", [
    (2, 16, 32, 128, 8, 24),
    (3, 5, 37, 3, 4, 3),  # odd ranks, I not a multiple of any tile
    (2, 5, 37, 1, 3, 1),  # Rr = 1, as on the last right edge
])
@pytest.mark.parametrize("name", ["gram_edge", "wgram", "proj2"])
def test_plain_version_matches_jax_einsum_f64(name, shape):
    # f64 against the einsum equivalences the Pallas kernels' docstrings
    # state: only summation order differs, within 1e-12 relative
    a = _inputs(shape, np.float64, seed=5)
    want = np.asarray(JAX_EINSUM[name](*(jnp.asarray(a[k]) for k in ARGS[name])))
    assert _rel(_port(name, a), want) <= 1e-12


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    a = _inputs((2, 5, 7, 3, 4, 2), np.float64, seed=1)
    before = [k.launches for k in gk.KERNELS]
    for name, kernel in zip(ARGS, gk.KERNELS):
        args = [torch.from_numpy(a[k]) for k in ARGS[name]]
        assert torch.equal(kernel(*args), gk.PLAIN[kernel](*args))
    assert [k.launches for k in gk.KERNELS] == before == [0, 0, 0]


def test_wrappers_refuse_other_devices_instead_of_falling_back():
    C = torch.zeros((1, 2, 3, 2), device="meta")
    G = torch.zeros((1, 2, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        gk.gram_edge(C, G)
    with pytest.raises(ValueError, match="different devices"):
        gk.wgram(C, torch.zeros((1, 2, 2)))


def test_build_needs_nvcc_and_keys_the_library_on_the_source(monkeypatch):
    import hashlib

    import torch.utils.cpp_extension as cpp

    assert sorted(_build.SOURCES) == ["gram_kernels", "tt_eval"]
    for name, source in _build.SOURCES.items():  # one library per source
        digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
        assert _build.library_path(name).name == f"{name}_{digest}.so"
        assert _build.library_path(name).parent == _build.BUILD_DIR
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-12)):
        for shape in [(4, 64, 40, 64, 32, 32), (3, 5, 37, 3, 4, 3), (2, 5, 37, 1, 3, 1)]:
            a = _inputs(shape, dtype, seed=3)
            for name, kernel in zip(ARGS, gk.KERNELS):
                args = [torch.from_numpy(a[k]).cuda() for k in ARGS[name]]
                before = kernel.launches
                got = kernel(*args)
                torch.cuda.synchronize()
                assert kernel.launches == before + 1
                want = gk.PLAIN[kernel](*args)
                assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= tol, (name, shape, dtype)
