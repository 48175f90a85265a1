// Hand-written Hopper (sm_90a) kernels of the device maxvol,
// tntorch_tpu_torch.ops.maxvol_kernels (lu_rows, maxvol_swaps), which
// tntorch_tpu_torch/maxvol.py:maxvol_device runs for CUDA tensors.
//
// Neither replaces a Pallas kernel. Each replaces an XLA construct of the
// JAX package's device maxvol (tntorch_tpu/maxvol.py):
//
// lu_rows_kernel replaces the permutation output of jax.lax.linalg.lu in
// _device_lu_pivots (maxvol.py:185-216). torch.linalg.lu_factor_ex returns
// LAPACK's pivots instead: r successive row swaps, 1-based. The kernel
// composes them into the first k rows of each block's row permutation, on
// the device, so the host reads nothing back. One CTA per block: its
// threads fill an arange(n) in a global scratch row, one thread applies
// the r swaps in their order (each depends on the last), and the threads
// write the first k entries. What bounds it: a few microseconds of launch
// and one pass over the n-entry scratch row; the swaps touch 2r entries.
//
// maxvol_swaps replaces the lax.while_loop of _maxvol_device_body
// (maxvol.py:242-263). While it < max_iters and max|C| > tol: take the flat
// argmax (i, j) of |C|, ties going to the lowest row-major index (as
// jnp.argmax and torch.argmax do; a NaN counts as the largest, so it ends
// the loop as it ends the plain version's), then
//   C <- C - outer(C[:, j] / C[i, j], C[i, :] - e_j),   idx[j] = i.
// Each iteration reads and writes all of C once, so bytes bound it:
// 2 n r itemsize per iteration. The update rounds as the plain version
// does (the quotient, then torch's outer product, then the subtraction) by
// __fdiv_rn/__fmul_rn/__fsub_rn (__ddiv_rn/__dmul_rn/__dsub_rn), which nvcc
// does not contract into an FMA: the kernel's C follows the plain
// version's bit for bit, and so do its pivots at near-ties.
// Two launch shapes, chosen by the wrapper from (n, r, itemsize)
// (ops/maxvol_kernels.py: _swap_route):
// - resident (swaps_resident_kernel): one CTA holds C in shared memory (up
//   to ~200 KB) for the whole loop. One pass over C per iteration updates
//   it and finds the next argmax, then one block reduction.
// - grid (swaps_grid_kernel): a cooperative launch of at most the blocks
//   the card holds at once (occupancy x SMs); a launch the card cannot
//   co-schedule is refused and the wrapper raises. Each block owns a
//   contiguous range of C's rows, which stays in device memory (L2 holds
//   C up to 50 MB). Per iteration a block updates its rows, reduces their
//   argmax, and publishes its candidate (|C|, flat index) with a copy of
//   that row; after one grid.sync() every block reduces all candidates by
//   the same total order, so each picks the same (i, j), and reads row i
//   from the winner's copy. The candidates are double-buffered, so one
//   grid sync per iteration suffices.
// Each C entry point launches on the stream it is given (PyTorch's current
// stream), does not synchronize, allocates nothing, and returns the launch's
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kLuThreads = 256;
constexpr int kResidentThreads = 512;
constexpr int kGridThreads = 256;
// Rows whose column-j entries a block snapshots before it updates them
// (csrc and ops/maxvol_kernels.py: _TILE)
constexpr int kTile = 1024;
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Whether candidate (va, ia) beats (vb, ib): the larger |C| (a NaN beats
// every number), then the lower flat index. A total order, so any
// reduction tree picks the same winner.
template <typename T>
__device__ __forceinline__ bool better(T va, long long ia, T vb, long long ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return na && (!nb || ia < ib);
  if (va != vb) return va > vb;
  return ia < ib;
}

// The block's best (v, i), returned to every thread. blockDim.x is a
// multiple of 32; sv and si hold 32 entries.
template <typename T>
__device__ void block_argmax(T& v, long long& i, T* sv, long long* si) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const long long oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    v = lane < warps ? sv[lane] : T(-1);
    i = lane < warps ? si[lane] : LLONG_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, v, off);
      const long long oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sv[0] = v; si[0] = i; }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();  // sv, si free for the next reduction
}

// Rows [a_begin, a_end) of C (row stride r, flat indices from 0) updated
// by one swap: C[a, b] -= (C[a, j] / piv) * row[b], row = C[i, :] - e_j,
// with the rows' column-j entries snapshot into q a tile at a time before
// any is written; (v, best) gathers the updated entries' argmax of |C|.
template <typename T>
__device__ void update_rows(T* C, int a_begin, int a_end, int r, int j, T piv, const T* row,
                            T* q, T& v, long long& best) {
  for (int a0 = a_begin; a0 < a_end; a0 += kTile) {
    const int rows = min(kTile, a_end - a0);
    for (int t = threadIdx.x; t < rows; t += blockDim.x)
      q[t] = div_rn(C[(long long)(a0 + t) * r + j], piv);
    __syncthreads();
    const long long base = (long long)a0 * r, count = (long long)rows * r;
    for (long long e = threadIdx.x; e < count; e += blockDim.x) {
      const int t = (int)(e / r), b = (int)(e - (long long)t * r);
      const T c = sub_rn(C[base + e], mul_rn(q[t], row[b]));
      C[base + e] = c;
      const T a = abs_t(c);
      if (better(a, base + e, v, best)) { v = a; best = base + e; }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kLuThreads)
lu_rows_kernel(const int* __restrict__ piv, int npiv, int n, int k, int* __restrict__ scratch,
               long long* __restrict__ rows) {
  const long long b = blockIdx.x;
  int* perm = scratch + b * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) perm[t] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int* p = piv + b * npiv;
    for (int s = 0; s < npiv; ++s) {
      const int o = p[s] - 1;  // LAPACK's 1-based row swapped with row s
      if (o != s && o >= 0 && o < n) {
        const int tmp = perm[s];
        perm[s] = perm[o];
        perm[o] = tmp;
      }
    }
  }
  __syncthreads();  // thread 0's global writes are visible to the block after it
  for (int t = threadIdx.x; t < k; t += blockDim.x) rows[b * k + t] = perm[t];
}

template <typename T>
__global__ void __launch_bounds__(kResidentThreads)
swaps_resident_kernel(T* __restrict__ C, long long* __restrict__ idx, int n, int r, double tol,
                      int max_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);
  T* row = Cs + (long long)n * r;
  T* q = row + r;
  __shared__ T sv[32];
  __shared__ long long si[32];
  const T ttol = (T)tol;  // compared in C's type, as the plain version's tensor > float
  const long long total = (long long)n * r;
  T v = T(-1);
  long long best = LLONG_MAX;
  for (long long e = threadIdx.x; e < total; e += blockDim.x) {
    const T c = C[e];
    Cs[e] = c;
    if (better(abs_t(c), e, v, best)) { v = abs_t(c); best = e; }
  }
  block_argmax(v, best, sv, si);
  for (int it = 0; it < max_iters && v > ttol; ++it) {
    const int i = (int)(best / r), j = (int)(best - (long long)i * r);
    const T piv = Cs[best];
    for (int b = threadIdx.x; b < r; b += blockDim.x) {
      const T c = Cs[(long long)i * r + b];
      row[b] = b == j ? sub_rn(c, T(1)) : c;
    }
    if (threadIdx.x == 0) idx[j] = i;
    __syncthreads();
    v = T(-1);
    best = LLONG_MAX;
    update_rows(Cs, 0, n, r, j, piv, row, q, v, best);
    block_argmax(v, best, sv, si);
  }
  for (long long e = threadIdx.x; e < total; e += blockDim.x) C[e] = Cs[e];
}

// The block's candidate into slot `slot` of the published ones: (|C|,
// flat index) and a copy of that row.
template <typename T>
__device__ void publish(const T* C, int r, T v, long long best, int slot, T* cand_v,
                        long long* cand_i, T* cand_rows) {
  if (threadIdx.x == 0) {
    cand_v[slot] = v;
    cand_i[slot] = best;
  }
  if (best != LLONG_MAX) {
    const long long a = best / r;
    for (int b = threadIdx.x; b < r; b += blockDim.x)
      cand_rows[(long long)slot * r + b] = C[a * r + b];
  }
}

template <typename T>
__global__ void __launch_bounds__(kGridThreads)
swaps_grid_kernel(T* __restrict__ C, long long* __restrict__ idx, int n, int r, double tol,
                  int max_iters, int rows_per_block, T* cand_v, long long* cand_i,
                  T* cand_rows) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = reinterpret_cast<T*>(smem_raw);
  T* q = row + r;
  __shared__ T sv[32];
  __shared__ long long si[32];
  const T ttol = (T)tol;
  const int blocks = gridDim.x;
  const int a_begin = min(n, (int)blockIdx.x * rows_per_block);
  const int a_end = min(n, a_begin + rows_per_block);
  T v = T(-1);
  long long best = LLONG_MAX;
  for (long long e = (long long)a_begin * r + threadIdx.x; e < (long long)a_end * r;
       e += blockDim.x) {
    const T a = abs_t(C[e]);
    if (better(a, e, v, best)) { v = a; best = e; }
  }
  block_argmax(v, best, sv, si);
  int buf = 0;
  publish(C, r, v, best, blockIdx.x, cand_v, cand_i, cand_rows);
  grid.sync();
  for (int it = 0; it < max_iters; ++it) {
    // Every block reduces the same candidates by the same order
    v = T(-1);
    best = LLONG_MAX;
    for (int k = threadIdx.x; k < blocks; k += blockDim.x) {
      const T cv = cand_v[buf * blocks + k];
      const long long ci = cand_i[buf * blocks + k];
      if (better(cv, ci, v, best)) { v = cv; best = ci; }
    }
    block_argmax(v, best, sv, si);
    if (!(v > ttol)) break;  // uniform over the grid: no block waits at a sync alone
    const int i = (int)(best / r), j = (int)(best - (long long)i * r);
    const T* src = cand_rows + ((long long)buf * blocks + i / rows_per_block) * r;
    const T piv = src[j];
    for (int b = threadIdx.x; b < r; b += blockDim.x) row[b] = b == j ? sub_rn(src[b], T(1)) : src[b];
    if (blockIdx.x == 0 && threadIdx.x == 0) idx[j] = i;
    __syncthreads();
    v = T(-1);
    best = LLONG_MAX;
    update_rows(C, a_begin, a_end, r, j, piv, row, q, v, best);
    block_argmax(v, best, sv, si);
    buf ^= 1;
    publish(C, r, v, best, buf * blocks + blockIdx.x, cand_v, cand_i, cand_rows);
    grid.sync();
  }
}

template <typename T>
size_t resident_smem(int n, int r) {
  return ((size_t)n * r + r + kTile) * sizeof(T);
}

template <typename T>
size_t grid_smem(int r) {
  return ((size_t)r + kTile) * sizeof(T);
}

template <typename T>
int swaps_resident(T* C, long long* idx, int n, int r, double tol, int max_iters,
                   cudaStream_t s) {
  const size_t smem = resident_smem<T>(n, r);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        swaps_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  swaps_resident_kernel<T><<<1, kResidentThreads, smem, s>>>(C, idx, n, r, tol, max_iters);
  return (int)cudaGetLastError();
}

template <typename T>
int grid_occupancy(int r) {
  const size_t smem = grid_smem<T>(r);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        swaps_grid_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, swaps_grid_kernel<T>, kGridThreads, smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

template <typename T>
int swaps_grid(T* C, long long* idx, int n, int r, double tol, int max_iters, int blocks,
               T* cand_v, long long* cand_i, T* cand_rows, cudaStream_t s) {
  const size_t smem = grid_smem<T>(r);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        swaps_grid_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int rows_per_block = (n + blocks - 1) / blocks;
  void* args[] = {&C, &idx, &n, &r, &tol, &max_iters, &rows_per_block, &cand_v, &cand_i,
                  &cand_rows};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)swaps_grid_kernel<T>, dim3(blocks), dim3(kGridThreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The first k rows of each of `batch` row permutations of n rows, from
// their LAPACK pivots (batch x npiv, int32, 1-based) into rows (batch x k,
// int64); scratch holds batch x n int32.
int tnt_lu_rows(const void* piv, int batch, int npiv, int n, int k, void* scratch, void* rows,
                void* stream) {
  if (batch <= 0 || n <= 0 || k < 0 || k > n || npiv < 0) return (int)cudaErrorInvalidValue;
  lu_rows_kernel<<<batch, kLuThreads, 0, (cudaStream_t)stream>>>(
      (const int*)piv, npiv, n, k, (int*)scratch, (long long*)rows);
  return (int)cudaGetLastError();
}

// Blocks of the grid-synchronised swap kernel that one SM holds at once
// for rank r (dtype 0 float32, 1 float64); a negative value is
// -cudaError_t.
int tnt_maxvol_grid_occupancy(int dtype, int r) {
  return dtype == 0 ? grid_occupancy<float>(r) : grid_occupancy<double>(r);
}

// The guarded swap loop on C (n x r, row-major) and idx (r, int64), in
// place. route 0: the resident kernel (cand_* unused, blocks ignored);
// route 1: the grid-synchronised kernel on `blocks` blocks, with cand_v
// (2 x blocks), cand_i (2 x blocks, int64) and cand_rows (2 x blocks x r)
// as its scratch.
int tnt_maxvol_swaps(int dtype, int route, void* C, void* idx, int n, int r, double tol,
                     int max_iters, int blocks, void* cand_v, void* cand_i, void* cand_rows,
                     void* stream) {
  if (n <= 0 || r <= 0 || (route == 1 && (blocks <= 0 || blocks > n)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long* ix = (long long*)idx;
  if (dtype == 0) {
    if (route == 0) return swaps_resident((float*)C, ix, n, r, tol, max_iters, s);
    return swaps_grid((float*)C, ix, n, r, tol, max_iters, blocks, (float*)cand_v,
                      (long long*)cand_i, (float*)cand_rows, s);
  }
  if (route == 0) return swaps_resident((double*)C, ix, n, r, tol, max_iters, s);
  return swaps_grid((double*)C, ix, n, r, tol, max_iters, blocks, (double*)cand_v,
                    (long long*)cand_i, (double*)cand_rows, s);
}

}  // extern "C"
