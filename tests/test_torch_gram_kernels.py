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
    (3, 49, 37, 49, 16, 16),  # P13's ranks (config 5's fields, rank 49 -> 16)
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


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ranks, tiles", [
    ((64, 128, 128, 64), ((64, 128), (64, 128))),   # the bench sweep's middle cores
    ((3, 5, 3, 2), ((16, 256), (16, 256))),         # small ragged ranks
    ((64, 128, 1, 1), ((64, 128), (64, 128))),      # Rr = 1
    ((128, 256, 256, 128), (None, None)),           # r = 128 outgrows every tile
    ((65, 128, 128, 64), (None, None)),             # r1 one over
    ((64, 128, 129, 64), (None, None)),             # Rr one over the r = 64 segment
    ((64, 1024, 128, 64), (None, None)),            # Y^T outgrows shared memory
])
def test_proj2_kernel_choice_by_shared_memory(ranks, tiles, itemsize):
    r1, Rl, Rr, r2 = ranks
    tile = tiles[itemsize == 8]
    assert gk._proj2_tile(r1, Rl, Rr, r2, itemsize) == tile
    if tile is not None:
        assert gk._proj2_smem(tile, Rl, Rr, itemsize) <= gk._SMEM_MAX


@pytest.mark.parametrize("itemsize, largest", [(4, 320), (8, 128)])
def test_proj2_resident_limit_in_Rl(itemsize, largest):
    # The largest Rl whose Y^T, X, intermediate and ring fit 227 KB at r =
    # 64, Rr = 128 (float32: the resident-projector kernel, float64: its
    # DMMA instance); csrc's resident_smem and P2Tile::smem are the same sums
    assert gk._proj2_tile(64, largest, 128, 64, itemsize) == (64, 128)
    assert gk._proj2_tile(64, largest + 1, 128, 64, itemsize) is None


@pytest.mark.parametrize("Rl, Rr, itemsize, tile", [
    (128, 128, 4, 128),   # the bench sweep's middle edges
    (128, 128, 8, 128),   # float64 above 64 takes the cluster instance
    (97, 83, 8, 128),
    (129, 129, 8, None),  # float64 beyond it takes the two-stage kernel
    (64, 64, 8, 64),      # float64 on DMMA up to 64
    (49, 49, 8, 64),      # P13
    (49, 49, 4, 64),
    (5, 3, 4, 32),        # small ragged ranks
    (5, 3, 8, 32),
    (128, 1, 4, 128),     # Rr = 1
    (1, 128, 4, 128),     # Rl = 1
    (127, 127, 4, 128),
    (129, 128, 4, None),  # Rl one over the largest tile
    (128, 129, 4, None),  # Rr one over it
    (70, 130, 4, None),
    (256, 256, 4, None),
])
def test_gram_kernel_choice_by_tile_and_dtype(Rl, Rr, itemsize, tile):
    assert gk._gram_tile(Rl, Rr, itemsize) == tile


def _plan_items(B, I, blocks):
    """Each sample's items (z, i) in the order the plan sums them: by slot,
    and within a slot's block run by i."""
    run, first, sample = gk._gram_plan(B, I, blocks)
    by_slot = {}
    for j in range(blocks):
        for u in range(run[j], run[j + 1]):
            z, i = divmod(u, I)
            by_slot.setdefault(first[j] + z - run[j] // I, []).append((z, i))
    return run, first, sample, by_slot


@pytest.mark.parametrize("I, blocks", [(1, 1), (37, 7), (256, 132), (5, 264)])
@pytest.mark.parametrize("B", [1, 3, 32, 300])
def test_gram_plan_covers_each_item_once_in_a_fixed_order(B, I, blocks):
    blocks = min(blocks, B * I)
    run, first, sample, by_slot = _plan_items(B, I, blocks)
    assert run[0] == 0 and run[-1] == B * I
    assert all(a < b for a, b in zip(run, run[1:]))  # no empty run
    assert first[0] == 0 and all(a < b for a, b in zip(first, first[1:]))
    assert sorted(by_slot) == list(range(sample[B]))  # every slot written once
    assert sample[0] == 0 and all(a < b for a, b in zip(sample, sample[1:]))
    for z in range(B):
        slots = range(sample[z], sample[z + 1])
        items = [it for s in slots for it in by_slot[s]]
        assert all(it[0] == z for it in items)          # a slot holds one sample
        assert items == [(z, i) for i in range(I)]      # each i once, in order
    # At most one slot per block and sample: a block's run spans samples
    # run[j] // I .. (run[j+1] - 1) // I
    assert sample[B] == sum((run[j + 1] - 1) // I - run[j] // I + 1 for j in range(blocks))
    assert gk._gram_plan(B, I, blocks) == (run, first, sample)  # a pure function


def test_gram_plan_refuses_empty_runs():
    with pytest.raises(ValueError):
        gk._gram_plan(2, 3, 7)
    with pytest.raises(ValueError):
        gk._gram_plan(2, 3, 0)


@pytest.mark.parametrize("name", ["gram_edge", "wgram"])
def test_gram_plan_partials_sum_to_the_plain_version(name):
    # The resident kernel's reduction in float64 on the CPU: each block sums
    # its run's items per sample into its slots, then each sample's slots
    # are added in slot order
    B, Rl, I, Rr = 3, 5, 37, 4
    a = _inputs((B, Rl, I, Rr, 1, 1), np.float64, seed=8)
    C = torch.from_numpy(a["C"])
    Q = torch.from_numpy(a["G" if name == "gram_edge" else "W"])
    plain = gk.PLAIN[getattr(gk, name)]
    blocks = 7
    _, _, sample, by_slot = _plan_items(B, I, blocks)
    parts = []
    for s in range(sample[B]):
        acc = 0
        for z, i in by_slot[s]:
            acc = acc + plain(C[z:z + 1, :, i:i + 1], Q[z:z + 1])[0]
        parts.append(acc)
    got = torch.stack([sum(parts[sample[z] + 1:sample[z + 1]], parts[sample[z]])
                       for z in range(B)])
    want = plain(C, Q)
    assert _rel(got.numpy(), want.numpy()) <= 1e-12


def test_build_needs_nvcc_and_keys_the_library_on_the_source(monkeypatch):
    import hashlib

    import torch.utils.cpp_extension as cpp

    assert sorted(_build.SOURCES) == ["gram_kernels", "maxvol_device", "tt_eval"]
    for name, source in _build.SOURCES.items():  # one library per source
        digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
        assert _build.library_path(name).name == f"{name}_{digest}.so"
        assert _build.library_path(name).parent == _build.BUILD_DIR
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    # (2, 70, 37, 130, 65, 3) is beyond every tile: the wrappers take the
    # two-stage kernel there and a tile instance elsewhere; (300, 7, 3, 9,
    # 2, 2) makes block runs cross samples; (32, 49, 64, 49, 16, 16) has
    # P13's ranks; (2, 97, 37, 83, 16, 16) takes float64's cluster instance
    # at ragged ranks. Every instance that takes a shape is forced there too
    shapes = [(4, 64, 40, 64, 32, 32), (3, 5, 37, 3, 4, 3), (2, 5, 37, 1, 3, 1),
              (2, 70, 37, 130, 65, 3), (300, 7, 3, 9, 2, 2), (2, 128, 33, 128, 8, 8),
              (32, 49, 64, 49, 16, 16), (2, 33, 37, 17, 17, 5), (2, 97, 37, 83, 16, 16)]
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-12)):
        item = np.dtype(dtype).itemsize
        for shape in shapes:
            a = _inputs(shape, dtype, seed=3)
            B, Rl, I, Rr, r1, r2 = shape
            for name, kernel in zip(ARGS, gk.KERNELS):
                args = [torch.from_numpy(a[k]).cuda() for k in ARGS[name]]
                before = kernel.launches
                got = kernel(*args)
                torch.cuda.synchronize()
                assert kernel.launches == before + 1
                want = gk.PLAIN[kernel](*args)
                assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= tol, (name, shape, dtype)
                route, tiles = (("_proj2_tile", gk._proj2_tiles_for(r1, Rl, Rr, r2, item))
                                if name == "proj2" else
                                ("_gram_tile", gk._gram_tiles_for(Rl, Rr, item)))
                for tile in tiles + [None]:  # None: the two-stage kernel
                    with monkeypatch.context() as m:
                        m.setattr(gk, route, lambda *_, t=tile: t)
                        forced = kernel(*args)
                        again = kernel(*args)
                    assert torch.equal(forced, again), (name, shape, tile, "two calls differ")
                    assert _rel(forced.cpu().numpy(), want.cpu().numpy()) <= tol, (name, shape, tile)
