"""The three contractions of the batched Gram-rounding sweep, each as a
hand-written CUDA kernel for Hopper (``csrc/gram_kernels.cu``) with its plain
PyTorch version beside it.

They replace the Pallas TPU kernels of ``tntorch_tpu/ops/pallas_gram.py``:

- ``gram_edge`` <- ``pallas_gram_edge``: right-Gram edge
  ``G'[a,d] = sum_i sum_c (C_i G)[a,c] C_i[d,c]``;
- ``wgram`` <- ``pallas_wgram``: weighted left Gram ``sum_i C_i^T W C_i``;
- ``proj2`` <- ``pallas_proj2``: double-sided projection ``Y C_i X`` per i.

What bounds them on an H100: at the bench shape (B=32, Rl=Rr=128, I=256,
f32) an edge does ~128 FLOP per byte of C it reads, far above the ~20 FLOP/B
ridge of FP32 FMA against HBM, so in exact f32 they are compute-bound, not
memory-bound as on the TPU. At the ranks users run (5-64) the Gram edges
stay compute-bound and ``proj2`` at r = 16 (~5 FLOP/B) is bound by reading
C once. In float64 only the tensor cores (DMMA: IEEE double FMAs at the
FP64 peak, about twice FFMA64's rate) approach the bound. The kernels keep
the intermediate (T = C G, W C, Y C) in shared memory as the TPU kernels
kept it in VMEM.

Each wrapper runs the tile instance that a pure function of the ranks and
the item size picks, the smallest that serves the ranks, or beyond every
instance the two-stage kernel (I split across blocks until a wave is
full, the splits summed in a fixed order):

- ``gram_edge`` and ``wgram`` (`_gram_tile`): Rl, Rr <= 32 or 64, float32
  (exact FFMA) and float64 (DMMA), on ``gram_tile_kernel``; float32 to 128
  on the resident-Gram kernel. One wave of persistent blocks, each walking
  the contiguous run of the B x I items (z, i) that `_gram_plan` gives it,
  G (or W) loaded once per sample, C_i brought on chip once per i, the sum
  over i held in registers; each block writes one partial per sample its
  run touches, and a second pass sums each sample's partials in a fixed
  order (no atomics, deterministic).
- Float64 ``gram_edge`` and ``wgram`` at 64 < max(Rl, Rr) <= 128 (tile
  128) on ``gram_pair_kernel``, in place of the two-stage kernel: G (or W),
  T and C_i at 128 x 132 doubles do not fit one block twice over, so a
  cluster of `_PAIR_CTAS` CTAs splits the contracted rank. Each CTA holds
  its share of G (or W) and of C_i, reads its peer's share of C_i through
  distributed shared memory for stage 1, keeps its share of T = C_i G in
  the DMMA accumulators as stage 2's operand (no trip through shared
  memory), and writes its own partial per sample: the plan's runs go to
  clusters and its slots are doubled. At the rounding shape this is 68.7
  GFLOP against the FP64 tensor peak: compute-bound. Ranks above 128 take
  the two-stage kernel.
- ``proj2`` (`_proj2_tile`): r1, r2 <= RT = 16 or 32 with Rr <= NSEG on
  ``proj2_tile_kernel`` (a work unit is NSEG // Rr consecutive mode indices,
  one contiguous segment per row of C, streamed once through a
  ``cp.async`` ring), float64 also at RT = 64 (NSEG 128); float32 at
  RT = 64 with Rr <= 128 on the resident-projector kernel (Rl <= 320). Y
  and X are loaded once per sample.

Tests and ``chip_smoke.py`` force an instance by replacing `_gram_tile` or
`_proj2_tile` (the wrappers look them up at call time); None forces the
two-stage kernel.

Each wrapper takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it checks device, dtype (float32 or float64), shape
and contiguity, launches its kernel on the current stream, and raises on any
failure: it never falls back. Each wrapper counts its launches in a plain
integer attribute (``gram_edge.launches``), which only a launch of the
kernel raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPES = {torch.float32: 0, torch.float64: 1}
# Output tile of a two-stage block (csrc/gram_kernels.cu): 64 rows by 128
# columns for gram_edge and wgram, by 64 columns for proj2
_TM, _TN_GRAM, _TN_PROJ = 64, 128, 64
_MAX_GRID_YZ = 65535
_SMEM_MAX = 232448  # the shared memory a block may use

# The Gram kernels' tile instances per item size, smallest first: a tile
# serves Rl, Rr <= tile. Float32 at 128 is the resident-Gram kernel (fixed
# 224 KB); float64 at 128 the cluster instance gram_pair_kernel, whose
# _PAIR_CTAS CTAs each hold their share of the contracted rank: of G or W
# (share x 136 doubles) and of C_i in two unit buffers (128 x (share + 8));
# the others are gram_tile_kernel (G or W, T and 3 buffers of C_i, each
# tile x (tile + 4))
_GRAM_TILES = {4: (32, 64, 128), 8: (32, 64, 128)}
_GRAM_RESIDENT_SMEM = 4 * (2 * 128 * 128 + 12 * 16 * 128)
_PAIR_CTAS = 2
_UNIT_BUFFERS = 3

# proj2's tile instances per item size, smallest first, as (RT, NSEG): an
# instance serves r1, r2 <= RT and Rr <= NSEG, the segment of C a work unit
# reads per row (NSEG // Rr mode indices). Float32 at RT = 64 is the
# resident-projector kernel (Rr <= 128); the others are proj2_tile_kernel
_PROJ2_TILES = {4: ((16, 256), (32, 256), (64, 128)), 8: ((16, 256), (32, 128), (64, 128))}
# proj2_tile_kernel: ring stages, and rows of C per ring slice by item size
_RING_STAGES = 3
_RING_ROWS = {4: 16, 8: 8}
# The resident-projector kernel (float32): mode indices per work unit and
# k-slice depth
_RES_UNIT = (2, 16)


def _gram_ctas(tile: int, itemsize: int) -> int:
    """CTAs a Gram tile instance runs as one cluster: _PAIR_CTAS on the
    float64 instance at 128, one elsewhere."""
    return _PAIR_CTAS if itemsize == 8 and tile == 128 else 1


def _gram_smem(tile: int, itemsize: int) -> int:
    """Shared bytes of a Gram tile instance (a CTA's, on a cluster)."""
    if itemsize == 4 and tile == 128:
        return _GRAM_RESIDENT_SMEM
    ctas = _gram_ctas(tile, itemsize)
    if ctas > 1:
        share = tile // ctas
        return itemsize * (share * (tile + 8) + 2 * tile * (share + 8))
    return itemsize * (2 + _UNIT_BUFFERS) * tile * (tile + 4)


def _gram_tiles_for(Rl: int, Rr: int, itemsize: int) -> list:
    """Every Gram tile instance that serves these ranks, smallest first."""
    return [t for t in _GRAM_TILES.get(itemsize, ()) if max(Rl, Rr) <= t]


def _gram_tile(Rl: int, Rr: int, itemsize: int):
    """The tile instance gram_edge and wgram of these ranks run (the
    smallest that covers both ranks), or None for the two-stage kernel."""
    tiles = _gram_tiles_for(Rl, Rr, itemsize)
    return tiles[0] if tiles else None


def _proj2_smem(tile, Rl: int, Rr: int, itemsize: int) -> int:
    """Shared bytes of a proj2 instance (RT, NSEG) at Rl, Rr; csrc's
    P2Tile::smem and resident_smem are the same sums."""
    rt, seg = tile
    if itemsize == 4 and rt == 64:  # the resident-projector kernel
        ip, ks = _RES_UNIT
        krl = -(-Rl // ks) * ks
        return itemsize * (krl * 64 + 128 * 64 + 128 * ip * 64 + _RING_STAGES * ks * ip * 128)
    ks, v = _RING_ROWS[itemsize], 16 // itemsize
    krl, kr2 = -(-Rl // ks) * ks, -(-Rr // 8) * 8
    return itemsize * ((krl + kr2) * (rt + 4) + rt * (seg + 4) + _RING_STAGES * ks * (seg + 2 * v))


def _proj2_tiles_for(r1: int, Rl: int, Rr: int, r2: int, itemsize: int) -> list:
    """Every proj2 instance that serves these ranks and fits a block's
    shared memory, smallest first."""
    return [t for t in _PROJ2_TILES.get(itemsize, ())
            if max(r1, r2) <= t[0] and Rr <= t[1] and _proj2_smem(t, Rl, Rr, itemsize) <= _SMEM_MAX]


def _proj2_tile(r1: int, Rl: int, Rr: int, r2: int, itemsize: int):
    """The instance (RT, NSEG) proj2 of these ranks runs (the smallest that
    serves them), or None for the two-stage kernel."""
    tiles = _proj2_tiles_for(r1, Rl, Rr, r2, itemsize)
    return tiles[0] if tiles else None


def _proj2_group(I: int, Rr: int, tile, itemsize: int) -> int:
    """Mode indices per work unit of a proj2 instance: two on the
    resident-projector kernel, NSEG // Rr on proj2_tile_kernel."""
    if itemsize == 4 and tile[0] == 64:
        return _RES_UNIT[0]
    return min(tile[1] // Rr, I)


def _gram_plan(B: int, I: int, blocks: int):
    """A Gram tile kernel's work plan for `blocks` blocks over the
    B x I items (z, i), numbered z * I + i: block j walks items
    [run[j], run[j + 1]) in order and writes the partial sum of each sample
    its run touches, the first into slot first[j] and one slot further for
    each sample after; sample z's partials are slots [sample[z],
    sample[z + 1]), in block order, and are summed in that order. Returns
    the three lists (run, first, sample)."""
    units = B * I
    if not 1 <= blocks <= units:
        raise ValueError(f"need 1 <= blocks <= B * I = {units}, got {blocks}")
    run = [units * j // blocks for j in range(blocks + 1)]
    first, sample = [], [None] * B + [0]
    slots = 0
    for j in range(blocks):
        first.append(slots)
        z_first, z_last = run[j] // I, (run[j + 1] - 1) // I
        for z in range(z_first, z_last + 1):
            if sample[z] is None:
                sample[z] = slots + z - z_first
        slots += z_last - z_first + 1
    sample[B] = slots
    return run, first, sample


@functools.lru_cache(maxsize=64)
def _plan_on(B: int, I: int, blocks: int, device_index: int):
    """`_gram_plan` as one int64 tensor on the card, made once per shape,
    and its number of slots."""
    run, first, sample = _gram_plan(B, I, blocks)
    plan = torch.tensor(run + first + sample, dtype=torch.int64,
                        device=torch.device("cuda", device_index))
    return plan, sample[-1]


def _gram_tile_launch(code: int, edge: int, tile: int, C, Q, out):
    """gram_edge (edge 0) or wgram (edge 1) on a Gram tile instance: the
    plan's runs go to blocks, or to clusters, each CTA of which writes its
    own slots."""
    B, Rl, I, Rr = C.shape
    M = out.shape[-1]
    blocks = min(B * I, _tile_wave(code, edge, tile, C.device.index))
    plan, slots = _plan_on(B, I, blocks, C.device.index)
    part = torch.empty((slots * _gram_ctas(tile, C.element_size()), M, M), dtype=C.dtype,
                       device=C.device)
    _launch("tnt_gram_tile", code, edge, tile, _ptr(C), _ptr(Q), _ptr(out), _ptr(part), _ptr(plan),
            B, Rl, I, Rr, blocks)


# ---------------------------------------------------------------------------
# Plain versions: the einsum equivalences the TPU kernels' docstrings state
# ---------------------------------------------------------------------------

def gram_edge_plain(C, G):
    """(B, Rl, I, Rr), (B, Rr, Rr) -> (B, Rl, Rl)."""
    return torch.einsum("zaic,zdic->zad", torch.einsum("zaib,zbc->zaic", C, G), C)


def wgram_plain(C, W):
    """(B, Rl, I, Rr), (B, Rl, Rl) -> (B, Rr, Rr): einsum('zaib,zad,zdic->zbc')."""
    return torch.einsum("zaib,zaic->zbc", C, torch.einsum("zad,zdic->zaic", W, C))


def proj2_plain(Y, C, X):
    """(B, r1, Rl), (B, Rl, I, Rr), (B, Rr, r2) -> (B, r1, I, r2)."""
    return torch.einsum("zrib,zbc->zric", torch.einsum("zra,zaib->zrib", Y, C), X)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*ts) -> bool:
    """True when every operand is on the CPU; raises on a device mix or on a
    device the kernels do not serve."""
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(name, ts, shapes):
    dtype = ts[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: kernel takes float32 or float64, got {dtype}")
    for t, want in zip(ts, shapes):
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: expected shape {tuple(want)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if any(s <= 0 for want in shapes for s in want):
        raise ValueError(f"{name}: empty operand")
    if shapes[0][0] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: batch {shapes[0][0]} exceeds the grid limit")
    return _DTYPES[dtype]


def _resident(n: int, fn: str) -> int:
    if n <= 0:
        raise RuntimeError(f"{fn}: CUDA error {-n}" if n else f"{fn}: the kernel fits no SM")
    return n


def _per_sm(per_sm: int, fn: str, device_index: int) -> int:
    return _resident(per_sm, fn) * torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _wave(code: int, kernel: int, device_index: int) -> int:
    """Blocks of a two-stage kernel that the card holds at once (occupancy
    x SMs). Kernels: 0 Gram, 1 proj2."""
    from tntorch_tpu_torch._build import library

    return _per_sm(library("gram_kernels").tnt_occupancy(code, kernel), "tnt_occupancy",
                   device_index)


@functools.lru_cache(maxsize=None)
def _tile_wave(code: int, kind: int, tile: int, device_index: int, Rl: int = 0, Rr: int = 0) -> int:
    """Blocks of a tile instance that the card holds at once, or clusters on
    a cluster instance. Kinds: 0 gram_edge, 1 wgram, 2 proj2 (sized for its
    shared memory at Rl, Rr)."""
    from tntorch_tpu_torch._build import library

    n = library("gram_kernels").tnt_tile_occupancy(code, kind, tile, Rl, Rr)
    if kind < 2 and _gram_ctas(tile, 8 if code else 4) > 1:  # clusters, not blocks per SM
        return _resident(n, "tnt_tile_occupancy")
    return _per_sm(n, "tnt_tile_occupancy", device_index)


def _pieces(code: int, kernel: int, blocks: int, I: int, device) -> int:
    """Pieces to cut I into so that blocks x pieces fills one wave of
    resident blocks, never more: a partial second wave would run at a
    fraction of the card."""
    return max(1, min(I, _wave(code, kernel, device.index) // blocks, _MAX_GRID_YZ))


def _tiles(m: int, n: int, tn: int) -> int:
    return -(-m // _TM) * -(-n // tn)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _launch(fn, *args):
    from tntorch_tpu_torch._build import library

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library("gram_kernels"), fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")


def gram_edge(C, G):
    """Right-Gram edge (B, Rl, I, Rr), (B, Rr, Rr) -> (B, Rl, Rl). On the
    card it runs the instance `_gram_tile` picks, or the two-stage kernel."""
    if _on_cpu(C, G):
        return gram_edge_plain(C, G)
    B, Rl, I, Rr = C.shape
    code = _check("gram_edge", (C, G), ((B, Rl, I, Rr), (B, Rr, Rr)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, Rl, Rl), dtype=C.dtype, device=C.device)
        tile = _gram_tile(Rl, Rr, C.element_size())
        if tile is not None:
            _gram_tile_launch(code, 0, tile, C, G, out)
        else:
            splits = _pieces(code, 0, B * _tiles(Rl, Rl, _TN_GRAM), I, C.device)
            scratch = torch.empty((splits, B, Rl, Rl), dtype=C.dtype, device=C.device) if splits > 1 else None
            _launch("tnt_gram_edge", code, _ptr(C), _ptr(G), _ptr(out), _ptr(scratch),
                    B, Rl, I, Rr, splits)
    gram_edge.launches += 1
    return out


def wgram(C, W):
    """Weighted left Gram (B, Rl, I, Rr), (B, Rl, Rl) -> (B, Rr, Rr). On the
    card it runs the instance `_gram_tile` picks, or the two-stage kernel."""
    if _on_cpu(C, W):
        return wgram_plain(C, W)
    B, Rl, I, Rr = C.shape
    code = _check("wgram", (C, W), ((B, Rl, I, Rr), (B, Rl, Rl)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, Rr, Rr), dtype=C.dtype, device=C.device)
        tile = _gram_tile(Rl, Rr, C.element_size())
        if tile is not None:
            _gram_tile_launch(code, 1, tile, C, W, out)
        else:
            splits = _pieces(code, 0, B * _tiles(Rr, Rr, _TN_GRAM), I, C.device)
            scratch = torch.empty((splits, B, Rr, Rr), dtype=C.dtype, device=C.device) if splits > 1 else None
            _launch("tnt_wgram", code, _ptr(C), _ptr(W), _ptr(out), _ptr(scratch),
                    B, Rl, I, Rr, splits)
    wgram.launches += 1
    return out


def proj2(Y, C, X):
    """Double-sided projection (B, r1, Rl), (B, Rl, I, Rr), (B, Rr, r2) ->
    (B, r1, I, r2). On the card it runs the instance `_proj2_tile` picks,
    or the two-stage kernel."""
    if _on_cpu(Y, C, X):
        return proj2_plain(Y, C, X)
    B, Rl, I, Rr = C.shape
    r1, r2 = Y.shape[-2], X.shape[-1]
    code = _check("proj2", (C, Y, X), ((B, Rl, I, Rr), (B, r1, Rl), (B, Rr, r2)))
    with torch.cuda.device(C.device):
        out = torch.empty((B, r1, I, r2), dtype=C.dtype, device=C.device)
        item = C.element_size()
        tile = _proj2_tile(r1, Rl, Rr, r2, item)
        if tile is not None:
            units = B * -(-I // _proj2_group(I, Rr, tile, item))
            blocks = min(units, _tile_wave(code, 2, tile[0], C.device.index, Rl, Rr))
            _launch("tnt_proj2_tile", code, tile[0], _ptr(Y), _ptr(C), _ptr(X), _ptr(out),
                    B, r1, Rl, I, Rr, r2, blocks)
        else:
            chunks = _pieces(code, 1, B * _tiles(r1, r2, _TN_PROJ), I, C.device)
            _launch("tnt_proj2", code, _ptr(Y), _ptr(C), _ptr(X), _ptr(out),
                    B, r1, Rl, I, Rr, r2, chunks)
    proj2.launches += 1
    return out


gram_edge.launches = 0
wgram.launches = 0
proj2.launches = 0

KERNELS = (gram_edge, wgram, proj2)
PLAIN = {gram_edge: gram_edge_plain, wgram: wgram_plain, proj2: proj2_plain}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
