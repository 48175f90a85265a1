// Hand-written Hopper (sm_90a) kernels of TT evaluation and its gradient,
// tntorch_tpu_torch.ops.tt_eval (tt_eval, TTEval, tt_batch_forward).
//
// tnt_tt_eval replaces the Pallas TPU kernel tntorch_tpu/ops/pallas_tt.py:89
// pallas_tt_eval (body _kernel :42): the value of a TT with cores C_k
// (R_k, I_k, R_{k+1}) at B integer coordinate rows X (B, N),
//   v <- ones(R_0);  v <- v . C_k[:, X[b,k], :] for k = 0..N-1;  out[b] = v[0]
// (column 0 of the last interface, as tt_batch_forward returns it).
//
// tnt_tt_eval_backward has no Pallas counterpart: JAX differentiates
// tt_batch_forward in XLA. Given the upstream gradient g (B,), it adds
//   dC_k[:, x_bk, :] += g_b * L_k[b] (outer) Rt_{k+1}[b]
// into zeroed gradient cores, with L_k the left interface before mode k and
// Rt_{k+1} the right interface after it (Rt_N = e_0).
//
// What bounds them on this card. Each sample gathers its own R x R slice of
// every core, a row-major block whose rows are contiguous in the last index.
// At the design shape (N=4, I=1024, R=64, B=2^20, f32) the forward does
// 17.4 GFLOP, a 0.26 ms FP32 bound (67 TFLOP/s), and reads its inputs in
// ~0.02 ms at 3.35 TB/s; but the gathered slices come to 16 KB per sample
// per middle mode, ~34 GB through L2 in all. So the simple kernel is bound
// by L2 traffic of the gathered slices, far above the FP32 bound. Reusing a
// slice across the samples that share a coordinate (sorting by X) is the
// redesign that would close the gap; it is later work.
//
// Design. The TPU kernel had no gather, so it selected the slice with a
// one-hot lane mask and folded it back with a fold matrix; here one warp
// owns one sample at a time and gathers C_k[:, x, :] directly. The warp's
// lanes form G groups of W lanes (W the smallest power of two >= the
// slice's column count, at most 32): a group's lanes run over the columns s,
// so they read neighbouring addresses of one row, and the groups split the
// rows r; warp shuffles sum the groups. The running interface stays in
// shared memory (two buffers of max rank per warp), as the TPU kept it in
// VMEM. Only column 0 of the last mode is computed. Any B (grid-stride over
// samples), any ranks including R_0 and R_N > 1, any I, float32 and float64,
// int32 and int64 coordinates; negative coordinates wrap as in NumPy, and an
// out-of-range one sets *flag (the caller raises IndexError), writes NaN and
// touches no memory out of bounds.
//
// The backward recomputes a sample's left interfaces L_0..L_{N-1} into the
// warp's shared memory, then sweeps right to left: at mode k it adds the
// outer product g_b L_k Rt_{k+1} into dC_k's slice with atomicAdd (rows
// contiguous, so each warp's atomics are coalesced) and, from the same
// loads of C_k's slice, computes Rt_k = C_k[:, x, :] Rt_{k+1}. The atomics
// make the gradient's summation order change from run to run: it is not
// bitwise reproducible (float32 agrees with the plain version to ~1e-6 of
// its largest entry, float64 to ~1e-15).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_MODES = 128;  // ops/tt_eval.py: MAX_MODES
constexpr int WARPS = 8;        // warps per block when shared memory allows
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct TT {
  const T* core[MAX_MODES];
  T* grad[MAX_MODES];  // backward only
  int rank[MAX_MODES + 1];
  int dim[MAX_MODES];
  int N;
  int maxr;   // max of rank[0..N]
  int lsize;  // rank[0] + ... + rank[N-1]: the backward's left interfaces
};

// The warp's lanes as G groups of W lanes for a slice ncols wide.
struct Lanes {
  int W, G, w, g;
};

__device__ __forceinline__ Lanes lanes_for(int ncols, int lane) {
  const int W = ncols >= 32 ? 32 : 1 << (32 - __clz(ncols - 1));
  return {W, 32 / W, lane & (W - 1), lane / W};
}

template <typename T>
__device__ __forceinline__ T nan_of() {
  return sizeof(T) == 4 ? (T)nanf("") : (T)nan("");
}

// Coordinate of mode k wrapped into [0, I), or -1 when out of range.
template <typename Idx>
__device__ __forceinline__ int64_t coord(const Idx* xb, int k, int I) {
  int64_t x = (int64_t)xb[k];
  if (x < -(int64_t)I || x >= (int64_t)I) return -1;
  return x < 0 ? x + I : x;
}

// vout[s] = sum_r vin[r] C[r*rs + s] for r < nrows, s < ncols: one warp.
template <typename T>
__device__ __forceinline__ void vecmat(const T* vin, T* vout,
                                       const T* __restrict__ C, int64_t rs,
                                       int nrows, int ncols, int lane) {
  const Lanes ln = lanes_for(ncols, lane);
  for (int s0 = 0; s0 < ncols; s0 += ln.W) {
    const int s = s0 + ln.w;
    T acc = 0;
    if (s < ncols) {
#pragma unroll 4
      for (int r = ln.g; r < nrows; r += ln.G) acc += vin[r] * __ldg(C + r * rs + s);
    }
    for (int off = ln.W; off < 32; off <<= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (ln.g == 0 && s < ncols) vout[s] = acc;
  }
  __syncwarp();
}

// dC[r*rs + s] += g L[r] rt[s] for r < nrows, s < ncols and, when `next`,
// rn[r] = sum_s C[r*rs + s] rt[s]: one warp.
template <typename T>
__device__ __forceinline__ void outer_matvec(const T* L, T g, const T* rt, T* rn,
                                             const T* __restrict__ C, T* dC,
                                             int64_t rs, int nrows, int ncols,
                                             bool next, int lane) {
  const Lanes ln = lanes_for(ncols, lane);
  for (int r0 = 0; r0 < nrows; r0 += ln.G) {
    const int r = r0 + ln.g;
    T acc = 0;
    if (r < nrows) {
      const T gl = g * L[r];
      for (int s = ln.w; s < ncols; s += ln.W) {
        const T t = rt[s];
        atomicAdd(dC + r * rs + s, gl * t);
        if (next) acc += __ldg(C + r * rs + s) * t;
      }
    }
    if (next) {
      for (int off = 1; off < ln.W; off <<= 1) acc += __shfl_xor_sync(FULL, acc, off);
      if (ln.w == 0 && r < nrows) rn[r] = acc;
    }
  }
  __syncwarp();
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(WARPS * 32)
    tt_eval_kernel(const __grid_constant__ TT<T> tt, const Idx* __restrict__ X,
                   int64_t B, T* __restrict__ out, int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  T* const va = reinterpret_cast<T*>(smem_raw) + (int64_t)warp * 2 * tt.maxr;
  T* const vb = va + tt.maxr;
  for (int64_t b = (int64_t)blockIdx.x * wpb + warp; b < B; b += (int64_t)gridDim.x * wpb) {
    const Idx* xb = X + b * tt.N;
    T* v = va;
    T* w = vb;
    for (int r = lane; r < tt.rank[0]; r += 32) v[r] = T(1);
    __syncwarp();
    bool ok = true;
    for (int k = 0; k < tt.N; ++k) {
      const int64_t x = coord(xb, k, tt.dim[k]);  // the same for every lane
      if (x < 0) {
        ok = false;
        break;
      }
      const int Rr = tt.rank[k + 1];
      vecmat(v, w, tt.core[k] + x * Rr, (int64_t)tt.dim[k] * Rr, tt.rank[k],
             k == tt.N - 1 ? 1 : Rr, lane);
      T* t = v;
      v = w;
      w = t;
    }
    if (lane == 0) {
      out[b] = ok ? v[0] : nan_of<T>();
      if (!ok) atomicOr(flag, 1);
    }
    __syncwarp();
  }
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(WARPS * 32)
    tt_eval_backward_kernel(const __grid_constant__ TT<T> tt,
                            const Idx* __restrict__ X, const T* __restrict__ g,
                            int64_t B, int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  T* const Lb = reinterpret_cast<T*>(smem_raw) +
                (int64_t)warp * (tt.lsize + 2 * tt.maxr);  // L_k at sum_{j<k} rank[j]
  T* const ra = Lb + tt.lsize;
  T* const rb = ra + tt.maxr;
  const int N = tt.N;
  for (int64_t b = (int64_t)blockIdx.x * wpb + warp; b < B; b += (int64_t)gridDim.x * wpb) {
    const Idx* xb = X + b * N;
    bool ok = true;
    for (int k = 0; k < N; ++k) ok = ok && coord(xb, k, tt.dim[k]) >= 0;
    if (!ok) {  // the same for every lane
      if (lane == 0) atomicOr(flag, 1);
      continue;
    }
    for (int r = lane; r < tt.rank[0]; r += 32) Lb[r] = T(1);
    __syncwarp();
    int off = 0;
    for (int k = 0; k < N - 1; ++k) {
      const int Rr = tt.rank[k + 1];
      vecmat(Lb + off, Lb + off + tt.rank[k], tt.core[k] + coord(xb, k, tt.dim[k]) * Rr,
             (int64_t)tt.dim[k] * Rr, tt.rank[k], Rr, lane);
      off += tt.rank[k];
    }
    const T gb = g[b];
    T* rt = ra;
    T* rn = rb;
    if (lane == 0) rt[0] = T(1);  // Rt_N = e_0: only column 0 of the last mode
    __syncwarp();
    int ncols = 1;
    for (int k = N - 1; k >= 0; --k) {
      const int Rr = tt.rank[k + 1];
      const int64_t at = coord(xb, k, tt.dim[k]) * Rr;
      outer_matvec(Lb + off, gb, rt, rn, tt.core[k] + at, tt.grad[k] + at,
                   (int64_t)tt.dim[k] * Rr, tt.rank[k], ncols, k > 0, lane);
      T* t = rt;
      rt = rn;
      rn = t;
      ncols = tt.rank[k];
      if (k > 0) off -= tt.rank[k - 1];
    }
  }
}

template <typename T>
TT<T> make_tt(int N, const void* const* cores, void* const* grads, const int* ranks,
              const int* dims) {
  TT<T> tt;
  tt.N = N;
  tt.maxr = 0;
  tt.lsize = 0;
  for (int k = 0; k <= N; ++k) {
    tt.rank[k] = ranks[k];
    tt.maxr = ranks[k] > tt.maxr ? ranks[k] : tt.maxr;
  }
  for (int k = 0; k < N; ++k) {
    tt.core[k] = (const T*)cores[k];
    tt.grad[k] = grads ? (T*)grads[k] : nullptr;
    tt.dim[k] = dims[k];
    tt.lsize += ranks[k];
  }
  return tt;
}

// Launch `kernel` with one warp per sample in flight: WARPS warps a block
// (fewer when a warp's shared memory, `per_warp` bytes, needs it) and a grid
// of at most 16 blocks per SM, striding over the samples.
template <typename K, typename... Args>
int launch(K kernel, size_t per_warp, int64_t B, cudaStream_t stream, Args... args) {
  const size_t max_smem = 227 * 1024;
  if (per_warp > max_smem) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int wpb = WARPS;
  while (wpb > 1 && wpb * per_warp > max_smem) wpb >>= 1;
  const size_t smem = wpb * per_warp;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int64_t need = (B + wpb - 1) / wpb;
  const int64_t cap = (int64_t)sms * 16;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  kernel<<<blocks, wpb * 32, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = float64;
// itype: 0 = int32, 1 = int64 coordinates. cores/grads are N device
// pointers to contiguous (ranks[k], dims[k], ranks[k+1]) cores, N <=
// MAX_MODES; X is (B, N) row-major; *flag (zeroed by the caller) is set when
// a coordinate is out of range. Each returns the cudaError_t of its launch
// (0 on success) and neither synchronises nor allocates.
extern "C" {

int tnt_tt_eval(int dtype, int itype, int N, const void* const* cores, const int* ranks,
                const int* dims, const void* X, long long B, void* out, int* flag,
                void* stream) {
  if (N < 1 || N > MAX_MODES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const TT<float> tt = make_tt<float>(N, cores, nullptr, ranks, dims);
    const size_t per = 2 * (size_t)tt.maxr * sizeof(float);
    if (itype == 0)
      return launch(tt_eval_kernel<float, int32_t>, per, B, s, tt, (const int32_t*)X,
                    (int64_t)B, (float*)out, flag);
    return launch(tt_eval_kernel<float, int64_t>, per, B, s, tt, (const int64_t*)X,
                  (int64_t)B, (float*)out, flag);
  }
  const TT<double> tt = make_tt<double>(N, cores, nullptr, ranks, dims);
  const size_t per = 2 * (size_t)tt.maxr * sizeof(double);
  if (itype == 0)
    return launch(tt_eval_kernel<double, int32_t>, per, B, s, tt, (const int32_t*)X,
                  (int64_t)B, (double*)out, flag);
  return launch(tt_eval_kernel<double, int64_t>, per, B, s, tt, (const int64_t*)X,
                (int64_t)B, (double*)out, flag);
}

int tnt_tt_eval_backward(int dtype, int itype, int N, const void* const* cores,
                         void* const* grads, const int* ranks, const int* dims,
                         const void* X, const void* g, long long B, int* flag,
                         void* stream) {
  if (N < 1 || N > MAX_MODES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const TT<float> tt = make_tt<float>(N, cores, grads, ranks, dims);
    const size_t per = ((size_t)tt.lsize + 2 * (size_t)tt.maxr) * sizeof(float);
    if (itype == 0)
      return launch(tt_eval_backward_kernel<float, int32_t>, per, B, s, tt,
                    (const int32_t*)X, (const float*)g, (int64_t)B, flag);
    return launch(tt_eval_backward_kernel<float, int64_t>, per, B, s, tt,
                  (const int64_t*)X, (const float*)g, (int64_t)B, flag);
  }
  const TT<double> tt = make_tt<double>(N, cores, grads, ranks, dims);
  const size_t per = ((size_t)tt.lsize + 2 * (size_t)tt.maxr) * sizeof(double);
  if (itype == 0)
    return launch(tt_eval_backward_kernel<double, int32_t>, per, B, s, tt,
                  (const int32_t*)X, (const double*)g, (int64_t)B, flag);
  return launch(tt_eval_backward_kernel<double, int64_t>, per, B, s, tt,
                (const int64_t*)X, (const double*)g, (int64_t)B, flag);
}

}  // extern "C"
