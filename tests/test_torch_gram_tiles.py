"""The rank-sized tiles of the port's Gram-sweep kernels
(tntorch_tpu_torch/ops/gram_kernels.py, csrc/gram_kernels.cu): the pure
route functions `_gram_tile` and `_proj2_tile` at their boundaries, and a
CPU emulation of each instance's blocking against what the JAX package
computes at ranks its Pallas gates refuse (its einsum branch).

The emulation follows the kernels' own bookkeeping: operands zero-padded to
the chosen tile, the Gram kernels' units (z, i) walked in the runs that
`_gram_plan` gives and their partials summed in slot order; proj2's units
of `_proj2_group` consecutive mode indices, C read per row as one segment,
stage 1 summed over ring slices of `_RING_ROWS` rows in order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntorch_tpu_torch.ops import gram_kernels as gk

RANKS = [1, 16, 17, 32, 33, 49, 64, 65, 128, 129]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _smallest_at_least(r, sizes):
    bigger = [s for s in sizes if s >= r]
    return min(bigger) if bigger else None


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("R", RANKS)
def test_gram_tile_is_the_smallest_covering_instance(R, itemsize):
    tiles = {4: (32, 64, 128), 8: (32, 64, 128)}[itemsize]
    want = _smallest_at_least(R, tiles)
    for Rl, Rr in ((R, R), (R, 1), (1, R), (R, max(1, R - 1))):
        assert gk._gram_tile(Rl, Rr, itemsize) == want
        if want is not None:
            assert gk._gram_tiles_for(Rl, Rr, itemsize)[0] == want
            assert gk._gram_smem(want, itemsize) <= gk._SMEM_MAX
        else:  # beyond every tile: the two-stage kernel
            assert gk._gram_tiles_for(Rl, Rr, itemsize) == []


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("r", RANKS)
def test_proj2_tile_is_the_smallest_covering_instance(r, itemsize):
    # r1 = r2 = r on a 64 x 64 core, and r1, r2 apart
    want = _smallest_at_least(r, (16, 32, 64))
    for r1, r2 in ((r, r), (r, 1), (1, r)):
        tile = gk._proj2_tile(r1, 64, 64, r2, itemsize)
        assert (tile[0] if tile else None) == want
        if tile is not None:
            assert tile == gk._proj2_tiles_for(r1, 64, 64, r2, itemsize)[0]
            assert gk._proj2_smem(tile, 64, 64, itemsize) <= gk._SMEM_MAX


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("Rr", RANKS + [256, 257])
def test_proj2_tile_segment_bounds_Rr(Rr, itemsize):
    # At r = 16 every instance whose segment NSEG holds a row of C_i takes it
    tile = gk._proj2_tile(16, 32, Rr, 16, itemsize)
    fits = [t for t in gk._PROJ2_TILES[itemsize] if Rr <= t[1]]
    assert tile == (fits[0] if fits else None)
    if tile is not None:
        assert gk._proj2_group(37, Rr, tile, itemsize) >= 1


def _largest_Rl(tile, Rr, itemsize):
    Rl = 1
    while gk._proj2_smem(tile, Rl + 1, Rr, itemsize) <= gk._SMEM_MAX:
        Rl += 1
    return Rl


@pytest.mark.parametrize("itemsize", [4, 8])
def test_every_instance_fits_shared_memory_to_its_largest_Rl(itemsize):
    # Each instance at its widest Rr: some Rl >= its rank tile fits, the
    # route takes it up to the largest Rl that fits and no further
    for tile in gk._PROJ2_TILES[itemsize]:
        Rr = tile[1]
        largest = _largest_Rl(tile, Rr, itemsize)
        assert largest >= tile[0]
        assert tile in gk._proj2_tiles_for(tile[0], largest, Rr, tile[0], itemsize)
        assert tile not in gk._proj2_tiles_for(tile[0], largest + 1, Rr, tile[0], itemsize)
    for tile in gk._GRAM_TILES[itemsize]:
        assert gk._gram_smem(tile, itemsize) <= gk._SMEM_MAX


# ---------------------------------------------------------------------------
# CPU emulation of the blocking against the JAX package
# ---------------------------------------------------------------------------

SHAPE = (3, 49, 37, 49, 16, 16)  # P13's ranks (rank 49, r = 16) at a small B and I


@pytest.fixture(scope="module")
def p13():
    rng = np.random.default_rng(23)
    B, Rl, I, Rr, r1, r2 = SHAPE

    def psd(n):
        A = rng.standard_normal((B, n, n))
        return A @ np.swapaxes(A, -1, -2) / n

    a = {"C": rng.standard_normal((B, Rl, I, Rr)), "G": psd(Rr), "W": psd(Rl),
         "Y": rng.standard_normal((B, r1, Rl)), "X": rng.standard_normal((B, Rr, r2))}
    C = jnp.asarray(a["C"])
    # gram_edge as tntorch_tpu/ops/rounding.py's einsum branch computes it;
    # wgram and proj2 as the einsums the Pallas kernels' docstrings state
    T = jnp.einsum("zaib,zbc->zaic", C, jnp.asarray(a["G"]))
    jax_out = {
        "gram_edge": np.asarray(jnp.einsum("zaic,zdic->zad", T, jnp.conj(C))),
        "wgram": np.asarray(jnp.einsum("zaib,zad,zdic->zbc", C, jnp.asarray(a["W"]), C)),
        "proj2": np.asarray(jnp.einsum("zra,zaib,zbc->zric", jnp.asarray(a["Y"]), C,
                                       jnp.asarray(a["X"]))),
    }
    return {k: torch.from_numpy(v) for k, v in a.items()}, jax_out


def _pad(t, shape):
    out = t.new_zeros(shape)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def _emulate_gram(edge, C, Q, tile, blocks):
    """gram_tile_kernel's blocking: each unit's two products on operands
    padded to tile x tile, the sum over a block's run in its registers,
    partials written at sample ends and summed in slot order."""
    B, Rl, I, Rr = C.shape
    M = Rl if edge == "gram_edge" else Rr
    Cp = _pad(C, (B, tile, I, tile))
    Qp = _pad(Q, (B, tile, tile))
    run, first, sample = gk._gram_plan(B, I, blocks)
    part = [None] * sample[B]
    for j in range(blocks):
        z0 = run[j] // I
        o = torch.zeros((tile, tile), dtype=C.dtype)
        for u in range(run[j], run[j + 1]):
            z, i = divmod(u, I)
            Ci = Cp[z, :, i, :]
            if edge == "gram_edge":
                o = o + (Ci @ Qp[z]) @ Ci.T
            else:
                o = o + Ci.T @ (Qp[z] @ Ci)
            if i + 1 == I or u + 1 == run[j + 1]:
                part[first[j] + z - z0] = o[:M, :M]
                o = torch.zeros_like(o)
    out = []
    for z in range(B):
        s = part[sample[z]]
        for q in range(sample[z] + 1, sample[z + 1]):
            s = s + part[q]
        out.append(s)
    return torch.stack(out)


def _emulate_proj2(Y, C, X, tile, itemsize):
    """proj2_tile_kernel's blocking (and the resident-projector kernel's,
    whose unit is two mode indices): per unit a segment of ip mode indices
    of each row of C, stage 1 over ring slices of KS rows in order, stage 2
    per mode index, operands zero-padded to the tile."""
    B, Rl, I, Rr = C.shape
    r1, r2 = Y.shape[1], X.shape[2]
    rt = tile[0]
    ks = gk._RING_ROWS[itemsize]  # the resident-projector kernel's slices are 16 deep too
    krl, kr2 = -(-Rl // ks) * ks, -(-Rr // 8) * 8
    ip = gk._proj2_group(I, Rr, tile, itemsize)
    Yp, Xp = _pad(Y, (B, rt, krl)), _pad(X, (B, kr2, rt))
    out = torch.empty((B, r1, I, r2), dtype=C.dtype)
    for z in range(B):
        for i0 in range(0, I, ip):
            ipu = min(ip, I - i0)
            seg = _pad(C[z, :, i0:i0 + ipu, :].reshape(Rl, ipu * Rr), (krl, ipu * Rr))
            T = 0
            for k0 in range(0, krl, ks):
                T = T + Yp[z, :, k0:k0 + ks] @ seg[k0:k0 + ks]
            for ii in range(ipu):
                Tb = _pad(T[:, ii * Rr:(ii + 1) * Rr], (rt, kr2))
                out[z, :, i0 + ii, :] = (Tb @ Xp[z])[:r1, :r2]
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("edge", ["gram_edge", "wgram"])
def test_gram_tile_blocking_matches_jax(p13, edge, itemsize):
    a, want = p13
    B, Rl, I, Rr = a["C"].shape
    tiles = gk._gram_tiles_for(Rl, Rr, itemsize)
    assert tiles[0] == gk._gram_tile(Rl, Rr, itemsize) == 64
    for tile in tiles:  # every instance that takes rank 49 (float32: 64 and 128)
        got = _emulate_gram(edge, a["C"], a["G" if edge == "gram_edge" else "W"], tile, blocks=7)
        assert _rel(got.numpy(), want[edge]) <= 1e-12, tile


@pytest.mark.parametrize("itemsize", [4, 8])
def test_proj2_tile_blocking_matches_jax(p13, itemsize):
    a, want = p13
    B, Rl, I, Rr = a["C"].shape
    tiles = gk._proj2_tiles_for(16, Rl, Rr, 16, itemsize)
    assert tiles[0] == gk._proj2_tile(16, Rl, Rr, 16, itemsize) == (16, 256)
    assert len(tiles) == 3  # the instances at r = 32 and 64 take r = 16 too
    for tile in tiles:
        got = _emulate_proj2(a["Y"], a["C"], a["X"], tile, itemsize)
        assert _rel(got.numpy(), want["proj2"]) <= 1e-12, tile



# ---------------------------------------------------------------------------
# CPU emulation of float64's cluster instance at ranks 65-128 against JAX
# ---------------------------------------------------------------------------

PAIR_SHAPES = [(3, 97, 37, 83), (2, 128, 5, 128), (2, 65, 7, 128)]


def test_pair_instance_is_a_cluster_that_fits_shared_memory():
    # Float64 at 128 runs as a cluster: each CTA holds its share of G or W
    # (64 x 136 doubles) and two unit buffers of its share of C_i (128 x 72)
    assert gk._gram_ctas(128, 8) == gk._PAIR_CTAS == 2
    assert gk._gram_smem(128, 8) == 8 * (64 * 136 + 2 * 128 * 72) <= gk._SMEM_MAX
    assert [gk._gram_ctas(t, 8) for t in (32, 64)] == [1, 1]
    assert [gk._gram_ctas(t, 4) for t in (32, 64, 128)] == [1, 1, 1]


def _pair_shares(K, ctas):
    """Each CTA's share of the contracted rank K padded to 8, as csrc's
    Pair::start splits it: whole blocks of 8, as evenly as they go."""
    nb = -(-K // 8)
    starts = [8 * (nb * q // ctas) for q in range(ctas + 1)]
    return list(zip(starts, starts[1:]))


def _k_order():
    """The order in which the cluster instance's two stages read each block
    of 8 of the contracted index, from the m16n8k8 DMMA register layouts:
    lane (g, t) holds the accumulators c0..c3 = T[g][2t], T[g][2t+1],
    T[g+8][2t], T[g+8][2t+1] and passes (c0, c2, c1, c3) as stage 2's A
    fragment, which the instruction reads as A[g][t], A[g+8][t], A[g][t+4],
    A[g+8][t+4]. Returns order[slot], the column of the block in k-slot
    `slot`."""
    def acc(t):  # (row, column) of c0..c3
        return [(0, 2 * t), (0, 2 * t + 1), (8, 2 * t), (8, 2 * t + 1)]

    def a_slot(t):  # (row, k-slot) the instruction reads a0..a3 as
        return [(0, t), (8, t), (0, t + 4), (8, t + 4)]

    order = [None] * 8
    for t in range(4):
        for e, c in enumerate((0, 2, 1, 3)):
            (row_c, col), (row_a, slot) = acc(t)[c], a_slot(t)[e]
            assert row_c == row_a  # the register holds the row of T the slot wants
            assert order[slot] in (None, col)
            order[slot] = col
        # B fragment (B[t][g], B[t+4][g]): columns 2t, 2t + 1 of one row of
        # C_i (or G, W), one 16-byte load in the same order
        assert (order[t], order[t + 4]) == (2 * t, 2 * t + 1)
    return order


def test_pair_k_order_is_a_permutation_of_each_block():
    assert _k_order() == [0, 2, 4, 6, 1, 3, 5, 7]
    for K in (65, 83, 97, 128):
        shares = _pair_shares(K, 2)
        assert shares[0][0] == 0 and shares[-1][1] == -(-K // 8) * 8
        assert all(s0 % 8 == 0 and s1 % 8 == 0 and s1 - s0 <= 64 for s0, s1 in shares)


def _emulate_pair(edge, C, Q, blocks, ctas):
    """The cluster instance's blocking: the plan's runs go to clusters; CTA
    r of a cluster owns share r of the contracted rank K (padded to 8). Per
    unit it computes its columns of T over every share of k in turn (its
    peers' shares of C_i too), blocks of 8 in the k order above, then adds
    T's share by its own share of C_i, block by block in the same order, to
    its partial; each CTA writes its own slot, the plan's slots doubled, and
    each sample's slots are summed in slot order."""
    B, Rl, I, Rr = C.shape
    ge = edge == "gram_edge"
    K, M = (Rr, Rl) if ge else (Rl, Rr)
    kp = -(-K // 8) * 8
    order = torch.tensor(_k_order())
    # Cx[z, i][x][k]: C_i with the contracted index along its columns (C_i^T
    # for wgram); Qk[z][k][h]: stage 1's B (G, or W^T)
    Cx = _pad(C.permute(0, 2, 1, 3) if ge else C.permute(0, 2, 3, 1), (B, I, M, kp))
    Qk = _pad(Q if ge else Q.transpose(1, 2), (B, kp, kp))
    shares = _pair_shares(K, ctas)
    run, first, sample = gk._gram_plan(B, I, blocks)
    part = [None] * (ctas * sample[B])
    for j in range(blocks):
        z0 = run[j] // I
        for r, (s0, s1) in enumerate(shares):
            o = torch.zeros((M, M), dtype=C.dtype)
            for u in range(run[j], run[j + 1]):
                z, i = divmod(u, I)
                A = Cx[z, i]
                T = torch.zeros((M, s1 - s0), dtype=C.dtype)
                for q0, q1 in shares:
                    for k in range(q0, q1, 8):
                        ks = k + order
                        T = T + A[:, ks] @ Qk[z][ks][:, s0:s1]
                for h in range(0, s1 - s0, 8):
                    hs = h + order
                    o = o + T[:, hs] @ A[:, s0 + hs].T
                if i + 1 == I or u + 1 == run[j + 1]:
                    part[ctas * (first[j] + z - z0) + r] = o if ge else o.T
                    o = torch.zeros_like(o)
    out = []
    for z in range(B):
        slots = range(ctas * sample[z], ctas * sample[z + 1])
        s = part[slots[0]]
        for q in slots[1:]:
            s = s + part[q]
        out.append(s)
    return torch.stack(out)


@pytest.mark.parametrize("edge", ["gram_edge", "wgram"])
@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_pair_instance_blocking_matches_jax(shape, edge):
    rng = np.random.default_rng(24)
    B, Rl, I, Rr = shape
    n = Rr if edge == "gram_edge" else Rl
    A = rng.standard_normal((B, n, n))
    C, Q = rng.standard_normal(shape), A @ np.swapaxes(A, -1, -2) / n
    assert gk._gram_tile(Rl, Rr, 8) == 128
    Cj, Qj = jnp.asarray(C), jnp.asarray(Q)
    if edge == "gram_edge":  # as the einsum branch of tntorch_tpu/ops/rounding.py
        want = jnp.einsum("zaic,zdic->zad", jnp.einsum("zaib,zbc->zaic", Cj, Qj), Cj)
    else:
        want = jnp.einsum("zaib,zad,zdic->zbc", Cj, Qj, Cj)
    got = _emulate_pair(edge, torch.from_numpy(C), torch.from_numpy(Q), blocks=7,
                        ctas=gk._gram_ctas(128, 8))
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12
