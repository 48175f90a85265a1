// Hand-written Hopper (sm_90a) kernels of the device maxvol,
// tntorch_tpu_torch.ops.maxvol_kernels (lu_rows, maxvol_swaps), which
// tntorch_tpu_torch/maxvol.py:maxvol_device runs for CUDA tensors.
//
// Neither replaces a Pallas kernel. Each replaces an XLA construct of the
// JAX package's device maxvol (tntorch_tpu/maxvol.py):
//
// lu_rows_kernel replaces the permutation output of jax.lax.linalg.lu in
// _device_lu_pivots (maxvol.py:185-216). torch.linalg.lu_factor_ex returns
// LAPACK's pivots instead: npiv successive row swaps, 1-based. The kernel
// gives the first k rows of each block's row permutation on the device, so
// the host reads nothing back. One CTA per permutation, no scratch beyond
// the pivots in shared memory: the value at a position x is found by
// tracing x back through the swaps, last to first (x meets swap t: it came
// from o_t if x == t, from t if x == o_t). Each of the first npiv positions
// is traced by its own thread. A position at or beyond npiv was touched only
// if it is some o_s: the block writes the identity there, then traces the
// touched ones. So the work is npiv^2 compare-selects across the block's
// threads, in parallel, where a dependent chain of loads and stores in
// global memory used to be; launch latency bounds it.
//
// maxvol_swaps replaces the lax.while_loop of _maxvol_device_body
// (maxvol.py:242-263). While it < max_iters and max|C| > tol: take the flat
// argmax (i, j) of |C|, ties going to the lowest row-major index (as
// jnp.argmax and torch.argmax do; a NaN counts as the largest, so it ends
// the loop as it ends the plain version's), then
//   C <- C - outer(C[:, j] / C[i, j], C[i, :] - e_j),   idx[j] = i.
// The update rounds as the plain version does (the quotient, then torch's
// outer product, then the subtraction) by __fdiv_rn/__fmul_rn/__fsub_rn
// (__ddiv_rn/__dmul_rn/__dsub_rn), which nvcc does not contract into an
// FMA: C follows the plain version bit for bit, and so do the pivots at
// near-ties. Each swap touches all of C once, and the swaps depend on each
// other, so what bounds the loop is swaps x (one exchange across the CTAs
// that hold C + one pass over a CTA's share of C), not C's bytes.
//
// Every route works the same way. The CTAs split C's rows into contiguous
// ranges, and each CTA's threads split its rows (`split_of`): a thread owns
// whole rows, or, where the CTA has fewer rows than threads, one block of
// columns of one row, the lanes of a warp on neighbouring rows at the same
// columns. So an entry's row and column are known without a division,
// the pivot row's entry is one broadcast read for the warp, the quotient
// C[a, j] / piv is one division for 32 rows, and C's rows, at an odd
// stride in shared memory, meet no bank conflict. Where a row is split,
// every block reads C[a, j] before a block barrier and its owner writes it
// after. Each thread keeps its best entry as an integer key and position:
// the key is the bit pattern of |C| with every NaN mapped to one value
// above +inf, so a larger key is a larger |C|, and one integer compare per
// entry keeps the thread's first maximum (a thread visits its entries in
// increasing flat index). The warp and block reductions order (key, row,
// col) totally: the larger key, then the lower row, then the lower column.
// After its update a CTA publishes its best (key, row, col, C[row, col])
// and that row less e_col; every CTA then picks the same pivot from the
// candidates and takes the pivot row from its owner's copy. The candidates
// are double-buffered, so one barrier across the CTAs a swap suffices.
// Three routes, chosen by the wrapper from (n, r, itemsize)
// (ops/maxvol_kernels.py: _swap_plan):
// - cluster (swaps_cluster_kernel): a thread block cluster of 1-16 CTAs;
//   each holds its rows of C in shared memory for the whole loop (the plan
//   sends it C up to 1 MiB, where it is ahead of the grid; 16 CTAs hold
//   ~3.4 MB). A CTA pushes its candidate into an inbox in every
//   CTA's shared memory (distributed shared memory stores) before the
//   cluster barrier, so each CTA then picks from its own shared memory;
//   one more cluster barrier, before the first push, waits until every
//   CTA of the cluster has started.
// - resident (swaps_grid_kernel<T, true>): a cooperative grid of one CTA
//   per SM, each holding its rows in shared memory (to ~29 MB on 132 SMs);
//   the candidates go through device memory, with one grid.sync() a swap,
//   and warp 0 of each CTA reads them and the winner's row through L2.
// - streamed (swaps_grid_kernel<T, false>): the same grid with C left in
//   device memory (L2 holds 50 MB), for C beyond the resident route: a
//   row belongs to a group of lanes, so its reads and writes coalesce.
// A batch of matrices (C: batch x n x r, idx: batch x r, each matrix on
// the route its own shape plans) takes one launch on the cluster route: a
// grid of batch clusters, cluster b on matrix b (blockIdx.x / CTAs); the
// clusters share nothing and may run in waves. The grid routes, whose
// cooperative grid takes every SM, take one launch per matrix, in stream
// order, reusing one scratch.
// A launch that the card cannot co-schedule (a cluster, or a cooperative
// grid) is refused, and the wrapper raises.
// Each C entry point launches on the stream it is given (PyTorch's current
// stream), does not synchronize, allocates nothing, and returns the launch's
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kLuThreads = 128;
constexpr int kSwapThreads = 512;
constexpr int kWarps = kSwapThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kStaticSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// The key of |c|: its bits, every NaN one key above +inf. Keys order as
// |C| does, with every NaN first.
__device__ __forceinline__ int key_of(float c) {
  return min(__float_as_int(fabsf(c)), 0x7f800001);
}
__device__ __forceinline__ long long key_of(double c) {
  return min(__double_as_longlong(fabs(c)), 0x7ff0000000000001LL);
}
__device__ __forceinline__ float value_of(int k) { return __int_as_float(k); }
__device__ __forceinline__ double value_of(long long k) { return __longlong_as_double(k); }

template <typename T> struct KeyOf;
template <> struct KeyOf<float> { using type = int; };
template <> struct KeyOf<double> { using type = long long; };

// A candidate pivot: key of |C|, row, column. No entry: key -1.
template <typename K>
struct Best {
  K key;
  int row, col;
};

template <typename K>
__device__ __forceinline__ Best<K> none() { return {K(-1), INT_MAX, INT_MAX}; }

// (k, r, c) into b if it comes first: the larger key, then the lower row,
// then the lower column. A total order, so any reduction tree picks the
// same winner.
template <typename K>
__device__ __forceinline__ void take(Best<K>& b, K k, int r, int c) {
  if (k != b.key ? k > b.key : (r != b.row ? r < b.row : c < b.col)) b = {k, r, c};
}

// The warp's best, in every lane
template <typename K>
__device__ __forceinline__ void warp_best(Best<K>& b) {
  for (int off = 16; off > 0; off >>= 1) {
    const K k = __shfl_xor_sync(kFull, b.key, off);
    const int r = __shfl_xor_sync(kFull, b.row, off);
    const int c = __shfl_xor_sync(kFull, b.col, off);
    take(b, k, r, c);
  }
}

// The block's best, in every lane of every warp. The caller's next block
// barrier frees wk, wr, wc.
template <typename K>
__device__ __forceinline__ Best<K> block_best(Best<K> b, K* wk, int* wr, int* wc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(b);
  if (lane == 0) { wk[warp] = b.key; wr[warp] = b.row; wc[warp] = b.col; }
  __syncthreads();
  b = lane < kWarps ? Best<K>{wk[lane], wr[lane], wc[lane]} : none<K>();
  warp_best(b);
  return b;
}

// Row stride of C in shared memory: odd, so that the lanes of a warp, on
// rows next to each other at one column, meet no bank twice.
__device__ __forceinline__ int smem_stride(int r) { return r | 1; }

// How a CTA's threads share its `rows` rows of C in shared memory: rt
// row lanes (a multiple of 32) times cb blocks of cw columns (a multiple of
// 4). A CTA with fewer rows than threads splits each row into column
// blocks, one row per thread; else a thread takes whole rows. The lanes of
// a warp share their column block.
struct Split {
  int rt, cb, cw;
};

__device__ __forceinline__ Split split_of(int rows, int r) {
  const int rt = min(kSwapThreads, max(32, (rows + 31) & ~31));
  const int cb = max(1, min(kSwapThreads / rt, (r + 3) / 4));
  const int cw = ((r + cb - 1) / cb + 3) & ~3;
  return {rt, (r + cw - 1) / cw, cw};
}

// A CTA's rows [0, rows) of C (global rows from a0) read from device
// memory (src, stride r) into shared memory (Cs, stride rs) where Cs is
// given; each thread's best entry. The threads walk C flat, four loads in
// flight each (one row a warp would wait on one load after another when r
// is small), so a thread reads its entries in increasing flat index.
// store_rows writes them back.
template <typename T, typename K>
__device__ Best<K> load_rows(const T* src, T* Cs, int rs, int rows, int a0, int r) {
  const int total = rows * r, step = blockDim.x;
  Best<K> b = none<K>();
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * step) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = e0 + u * step < total ? src[e0 + u * step] : T(0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * step;
      if (e < total) {
        const int la = e / r, c = e - la * r;
        if (Cs) Cs[(size_t)la * rs + c] = v[u];
        const K k = key_of(v[u]);
        if (k > b.key) b = {k, a0 + la, c};
      }
    }
  }
  return b;
}

template <typename T>
__device__ void store_rows(T* dst, const T* Cs, int rs, int rows, int r) {
  for (int e = threadIdx.x; e < rows * r; e += blockDim.x) {
    const int la = e / r;
    dst[e] = Cs[(size_t)la * rs + (e - la * r)];
  }
}

// Columns [c0, c1) of one row Ra updated with quotient q against `row`
// (C[i, :] - e_j), four at a time; (bk, bc) the thread's first maximum.
template <typename T, typename K>
__device__ __forceinline__ void sweep(T* Ra, T q, int c0, int c1, const T* row, K& bk, int& bc) {
  int c = c0;
  for (; c + 4 <= c1; c += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T v = sub_rn(Ra[c + u], mul_rn(q, row[c + u]));
      Ra[c + u] = v;
      const K k = key_of(v);
      if (k > bk) { bk = k; bc = c + u; }
    }
  }
  for (; c < c1; ++c) {
    const T v = sub_rn(Ra[c], mul_rn(q, row[c]));
    Ra[c] = v;
    const K k = key_of(v);
    if (k > bk) { bk = k; bc = c; }
  }
}

// The rows of C in shared memory (Cs, stride rs) updated by one swap,
// C[a, b] -= (C[a, j] / piv) * row[b], row = C[i, :] - e_j; the thread's
// best updated entry. A thread owns its rows (or its column block of one
// row), so no lane waits on another; where a row is split, every block
// reads C[a, j] before the barrier and its owner writes it after.
template <typename T, typename K>
__device__ Best<K> update_smem(T* Cs, int rs, int rows, int a0, int r, Split sp, int j, T piv,
                               const T* row) {
  const int t = threadIdx.x;
  K bk = K(-1);
  int bc = -1, ba = 0;
  if (sp.cb > 1) {
    const int la = t % sp.rt, blk = t / sp.rt;
    const bool on = blk < sp.cb && la < rows;
    T* Ra = Cs + (size_t)(on ? la : 0) * rs;
    const T q = div_rn(on ? Ra[j] : T(0), piv);
    __syncthreads();
    if (on) sweep<T, K>(Ra, q, blk * sp.cw, min(r, blk * sp.cw + sp.cw), row, bk, bc);
    ba = la;
  } else {
    for (int la = t; la < rows; la += sp.rt) {
      T* Ra = Cs + (size_t)la * rs;
      const K before = bk;
      sweep<T, K>(Ra, div_rn(Ra[j], piv), 0, r, row, bk, bc);
      if (bk != before) ba = la;  // keys only grow: the best is in this row
    }
  }
  return bc < 0 ? none<K>() : Best<K>{bk, a0 + ba, bc};
}

// Rows [0, rows) of R (row stride r, in device memory) updated by one swap
// as update_smem does, for C beyond shared memory: a row belongs to a
// group of lanes of one warp (32, or the power of two at or above r) and a
// column to a lane of it, so reads and writes of a row coalesce. The group
// reads C[a, j] before any lane writes the row: the __syncwarp. Every lane
// of a warp runs the same iterations, so the warp stays whole.
template <typename T, typename K>
__device__ Best<K> update_rows(T* R, int rows, int a0, int r, int j, T piv, const T* row) {
  int G = 1;
  while (G < r && G < 32) G <<= 1;
  const int lane = threadIdx.x & 31, per_warp = 32 / G, lg = lane & (G - 1);
  const int groups = kWarps * per_warp, g = (threadIdx.x >> 5) * per_warp + lane / G;
  Best<K> b = none<K>();
  for (int base = 0; base < rows; base += groups) {
    const int la = base + g;
    const bool on = la < rows;
    T* Ra = R + (size_t)(on ? la : 0) * r;
    const T cj = on ? Ra[j] : T(0);
    __syncwarp();
    if (on) {
      const T q = div_rn(cj, piv);
      for (int c = lg; c < r; c += G) {
        const T v = sub_rn(Ra[c], mul_rn(q, row[c]));
        Ra[c] = v;
        const K k = key_of(v);
        if (k > b.key) b = {k, a0 + la, c};
      }
    }
  }
  return b;
}

__device__ __forceinline__ int trace(const int* o, int x, int from) {
  for (int t = from; t >= 0; --t) {
    const int ot = o[t];
    x = x == t ? ot : (x == ot ? t : x);
  }
  return x;
}

__global__ void __launch_bounds__(kLuThreads)
lu_rows_kernel(const int* __restrict__ piv, int npiv, int n, int k, long long* __restrict__ rows) {
  extern __shared__ int o[];  // the swaps' second positions, 0-based
  const long long b = blockIdx.x;
  const int* p = piv + b * npiv;
  long long* out = rows + b * k;
  for (int s = threadIdx.x; s < npiv; s += blockDim.x) {
    const int t = p[s] - 1;  // LAPACK's 1-based row swapped with row s
    o[s] = t >= 0 && t < n ? t : s;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < k; x += blockDim.x) out[x] = x < npiv ? trace(o, x, npiv - 1) : x;
  __syncthreads();  // the identity beyond npiv is written before the touched positions
  for (int s = threadIdx.x; s < npiv; s += blockDim.x) {
    const int x = o[s];
    if (x >= npiv && x < k) out[x] = trace(o, x, npiv - 1);  // repeated targets write one value
  }
}

// The cluster's exchange, in each CTA's shared memory: slot [buf][k] holds
// CTA k's candidate (key, row, column, C[row, column]) and, in the dynamic
// part, its row less e_column. Each CTA pushes its own into every CTA's
// inbox before the cluster barrier, so after it every pick is local.
template <typename T, typename K>
struct Inbox {
  K key[2][kMaxCluster];
  int row[2][kMaxCluster], col[2][kMaxCluster];
  T piv[2][kMaxCluster];
};

template <typename T>
__global__ void __launch_bounds__(kSwapThreads, 1)
swaps_cluster_kernel(T* __restrict__ C, long long* __restrict__ idx, int n, int r, double tol,
                     int max_iters, int rows_per_cta) {
  using K = typename KeyOf<T>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  // This cluster's matrix of the batch
  const size_t mat = blockIdx.x / ctas;
  C += mat * n * r;
  idx += mat * r;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rs = smem_stride(r);
  T* Cs = reinterpret_cast<T*>(smem_raw);
  T* in_rows = Cs + (size_t)rows_per_cta * rs;  // [2][ctas][r]
  __shared__ Inbox<T, K> in;
  __shared__ K wk[kWarps];
  __shared__ int wr[kWarps], wc[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T ttol = (T)tol;  // compared in C's type, as the plain version's tensor > float
  const int a0 = min(n, rank * rows_per_cta);
  const int rows = min(n, a0 + rows_per_cta) - a0;
  const Split sp = split_of(rows, r);

  // This CTA's best into every CTA's inbox slot [buf][rank] (warp k writes
  // CTA k's), then the cluster barrier; a cluster of one CTA writes its own
  // and needs only the block barrier, which costs less
  auto publish = [&](Best<K> b, int buf) {
    b = block_best(b, wk, wr, wc);
    if (warp < ctas) {
      Inbox<T, K>* dst = ctas == 1 ? &in : cluster.map_shared_rank(&in, (unsigned)warp);
      T* drow = (ctas == 1 ? in_rows : cluster.map_shared_rank(in_rows, (unsigned)warp)) +
                ((size_t)buf * ctas + rank) * r;
      if (b.row != INT_MAX) {
        const T* src = Cs + (size_t)(b.row - a0) * rs;
        for (int c = lane; c < r; c += 32) drow[c] = c == b.col ? sub_rn(src[c], T(1)) : src[c];
        if (lane == 0) dst->piv[buf][rank] = src[b.col];
      }
      if (lane == 0) {
        dst->key[buf][rank] = b.key;
        dst->row[buf][rank] = b.row;
        dst->col[buf][rank] = b.col;
      }
    }
    if (ctas == 1) {
      __syncthreads();
    } else {
      cluster.sync();
    }
  };

  const Best<K> first = load_rows<T, K>(C + (size_t)a0 * r, Cs, rs, rows, a0, r);
  // Every CTA of the cluster has started, and its shared memory exists,
  // before any CTA writes into another's
  if (ctas > 1) cluster.sync();
  publish(first, 0);
  int buf = 0;
  for (int it = 0;; ++it) {
    // Every warp picks the pivot from its own inbox: the same one in all
    Best<K> b = lane < ctas ? Best<K>{in.key[buf][lane], in.row[buf][lane], in.col[buf][lane]}
                            : none<K>();
    warp_best(b);
    if (!(it < max_iters && value_of(b.key) > ttol)) break;  // the same in every warp and CTA
    const int w = b.row / rows_per_cta;
    if (rank == 0 && threadIdx.x == 0) idx[b.col] = b.row;
    const Best<K> mine = update_smem<T, K>(Cs, rs, rows, a0, r, sp, b.col, in.piv[buf][w],
                                           in_rows + ((size_t)buf * ctas + w) * r);
    buf ^= 1;
    publish(mine, buf);
  }
  store_rows(C + (size_t)a0 * r, Cs, rs, rows, r);
}

// A grid candidate in device memory: the key, then the row and column in
// one word, 16 bytes read in one load; its row copy (row less e_column,
// then C[row, column]) beside it in cand_rows, r + 1 entries.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kSwapThreads, 1)
swaps_grid_kernel(T* __restrict__ C, long long* __restrict__ idx, int n, int r, double tol,
                  int max_iters, int rows_per_block, longlong2* cand, T* cand_rows) {
  using K = typename KeyOf<T>::type;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rs = smem_stride(r);
  T* row = reinterpret_cast<T*>(smem_raw);  // the pivot row less e_j, then C[i, j]
  T* Cs = row + (r + 1);
  __shared__ K wk[kWarps];
  __shared__ int wr[kWarps], wc[kWarps];
  __shared__ int s_col, s_go;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blocks = gridDim.x;
  const T ttol = (T)tol;
  const int a0 = min(n, (int)blockIdx.x * rows_per_block);
  const int rows = min(n, a0 + rows_per_block) - a0;
  const Split sp = split_of(rows, r);
  T* Cg = C + (size_t)a0 * r;  // this block's rows in device memory

  // This block's best into slot `buf` of the candidates, then the grid barrier
  auto publish = [&](Best<K> b, int buf) {
    b = block_best(b, wk, wr, wc);
    if (warp == 0) {
      const int slot = buf * blocks + blockIdx.x;
      if (lane == 0)
        cand[slot] = make_longlong2((long long)b.key, (long long)b.col << 32 | (unsigned)b.row);
      if (b.row != INT_MAX) {
        const T* src = kResident ? Cs + (size_t)(b.row - a0) * rs : Cg + (size_t)(b.row - a0) * r;
        T* dst = cand_rows + (size_t)slot * (r + 1);
        for (int c = lane; c < r; c += 32) dst[c] = c == b.col ? sub_rn(src[c], T(1)) : src[c];
        if (lane == 0) dst[r] = src[b.col];
      }
    }
    grid.sync();
  };

  publish(load_rows<T, K>(Cg, kResident ? Cs : nullptr, rs, rows, a0, r), 0);
  int buf = 0;
  for (int it = 0;; ++it) {
    if (warp == 0) {
      // Warp 0 picks from every block's candidate and copies the winner's
      // row, both through L2 (the L1 may hold a stale line of these buffers)
      Best<K> b = none<K>();
      for (int k = lane; k < blocks; k += 32) {
        const longlong2 c = __ldcg(cand + buf * blocks + k);
        take(b, (K)c.x, (int)(unsigned)c.y, (int)(c.y >> 32));
      }
      warp_best(b);
      const bool go = it < max_iters && value_of(b.key) > ttol;
      if (go) {
        const T* src = cand_rows + ((size_t)buf * blocks + b.row / rows_per_block) * (r + 1);
        for (int c = lane; c <= r; c += 32) row[c] = __ldcg(src + c);
        if (blockIdx.x == 0 && lane == 0) idx[b.col] = b.row;
      }
      if (lane == 0) { s_go = go; s_col = b.col; }
    }
    __syncthreads();
    if (!s_go) break;  // uniform over the grid: no block waits at a sync alone
    const Best<K> mine =
        kResident ? update_smem<T, K>(Cs, rs, rows, a0, r, sp, s_col, row[r], row)
                  : update_rows<T, K>(Cg, rows, a0, r, s_col, row[r], row);
    buf ^= 1;
    publish(mine, buf);
  }
  if (kResident) store_rows(Cg, Cs, rs, rows, r);
}

// Dynamic shared memory of a swap CTA holding `rows` rows of C (r
// columns), at an odd row stride, and `extra` rows more: the inbox's 2 x
// ctas row copies on a cluster, the pivot row (r + 1) on a grid
// (ops/maxvol_kernels.py: _cta_bytes)
template <typename T>
size_t swap_smem(int rows, int r, int extra) {
  return ((size_t)rows * (r | 1) + (size_t)extra * (r + 1)) * sizeof(T);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int swaps_cluster(T* C, long long* idx, int batch, int n, int r, double tol, int max_iters,
                  int ctas, cudaStream_t s) {
  if (ctas < 1 || ctas > kMaxCluster) return (int)cudaErrorInvalidValue;
  int rows_per_cta = (n + ctas - 1) / ctas;
  const size_t smem = swap_smem<T>(rows_per_cta, r, 2 * ctas);
  auto kernel = swaps_cluster_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (ctas == 1) {  // a plain launch (a CTA is a cluster of one): no occupancy query
    kernel<<<batch, kSwapThreads, smem, s>>>(C, idx, n, r, tol, max_iters, rows_per_cta);
    return (int)cudaGetLastError();
  }
  if (ctas > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * ctas);
  cfg.blockDim = dim3(kSwapThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;  // no GPC holds the cluster
  err = cudaLaunchKernelEx(&cfg, kernel, C, idx, n, r, tol, max_iters, rows_per_cta);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool kResident>
int swaps_grid(T* C, long long* idx, int n, int r, double tol, int max_iters, int blocks,
               longlong2* cand, T* cand_rows, cudaStream_t s) {
  int rows_per_block = (n + blocks - 1) / blocks;
  const size_t smem = swap_smem<T>(kResident ? rows_per_block : 0, r, 1);
  cudaError_t err = allow_smem(swaps_grid_kernel<T, kResident>, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&C, &idx, &n, &r, &tol, &max_iters, &rows_per_block, &cand, &cand_rows};
  err = cudaLaunchCooperativeKernel((const void*)swaps_grid_kernel<T, kResident>, dim3(blocks),
                                    dim3(kSwapThreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int swaps(int route, T* C, long long* idx, int batch, int n, int r, double tol, int max_iters,
          int ctas, longlong2* cand, T* cand_rows, cudaStream_t s) {
  if (route == 0) return swaps_cluster(C, idx, batch, n, r, tol, max_iters, ctas, s);
  for (int b = 0; b < batch; ++b) {  // a cooperative grid a matrix, in stream order
    T* Cb = C + (size_t)b * n * r;
    long long* ib = idx + (size_t)b * r;
    const int err =
        route == 1 ? swaps_grid<T, true>(Cb, ib, n, r, tol, max_iters, ctas, cand, cand_rows, s)
                   : swaps_grid<T, false>(Cb, ib, n, r, tol, max_iters, ctas, cand, cand_rows, s);
    if (err != (int)cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// The first k rows of each of `batch` row permutations of n rows, from
// their LAPACK pivots (batch x npiv, int32, 1-based) into rows (batch x k,
// int64).
int tnt_lu_rows(const void* piv, int batch, int npiv, int n, int k, void* rows, void* stream) {
  if (batch <= 0 || n <= 0 || k < 0 || k > n || npiv < 0 || npiv > n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)npiv * sizeof(int);
  const cudaError_t err = allow_smem(lu_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lu_rows_kernel<<<batch, kLuThreads, smem, (cudaStream_t)stream>>>((const int*)piv, npiv, n, k,
                                                                     (long long*)rows);
  return (int)cudaGetLastError();
}

// The guarded swap loop on each of `batch` matrices C (batch x n x r,
// row-major) and their idx (batch x r, int64), in place, on `ctas` CTAs a
// matrix. route 0: a cluster of ctas (1-16) CTAs a matrix, C in their
// shared memory, one launch for the batch (cand, cand_rows unused); route
// 1: a cooperative grid of ctas blocks, C in their shared memory; route 2:
// the same grid, C in device memory; routes 1-2 launch once a matrix and
// take cand (2 x ctas x 16 bytes) and cand_rows (2 x ctas x (r + 1), C's
// type) as their scratch.
int tnt_maxvol_swaps(int dtype, int route, void* C, void* idx, int batch, int n, int r,
                     double tol, int max_iters, int ctas, void* cand, void* cand_rows,
                     void* stream) {
  if (batch <= 0 || n <= 0 || r <= 0 || ctas <= 0 || ctas > n || route < 0 || route > 2 ||
      (route == 0 && (long long)batch * ctas > INT_MAX))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long* ix = (long long*)idx;
  longlong2* cd = (longlong2*)cand;
  if (dtype == 0)
    return swaps(route, (float*)C, ix, batch, n, r, tol, max_iters, ctas, cd, (float*)cand_rows, s);
  return swaps(route, (double*)C, ix, batch, n, r, tol, max_iters, ctas, cd, (double*)cand_rows, s);
}


}  // extern "C"
