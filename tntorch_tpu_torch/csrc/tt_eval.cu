// Hand-written Hopper (sm_90a) kernels of TT evaluation and its gradient,
// tntorch_tpu_torch.ops.tt_eval (tt_eval, TTEval, tt_batch_forward).
//
// tnt_tt_eval replaces the Pallas TPU kernel tntorch_tpu/ops/pallas_tt.py:89
// pallas_tt_eval (body _kernel :42): the value of a TT with cores C_k
// (R_k, I_k, R_{k+1}) at B integer coordinate rows X (B, N),
//   v <- ones(R_0);  v <- v . C_k[:, X[b,k], :] for k = 0..N-1;  out[b] = v[0]
// (column 0 of the last interface, as tt_batch_forward returns it).
//
// The backward has no Pallas counterpart: JAX differentiates
// tt_batch_forward in XLA. Given the upstream gradient g (B,), it computes
//   dC_k[:, i, :] = sum over b with x_bk = i of g_b * L_k[b] (outer) Rt_{k+1}[b]
// with L_k the left interface before mode k and Rt_{k+1} the right
// interface after it (Rt_N = e_0). It too has two paths; the wrapper
// (ops/tt_eval.py: _grouped_backward) picks one per call.
//
// The forward has two kernels; the wrapper (ops/tt_eval.py: _grouped) picks
// one per call.
//
// tt_eval_grouped_kernel, for N >= 3 and many samples per slice. What
// bounds TT evaluation on this card is the reuse of the core slices: at the
// design shape (N=4, I=1024, R=64, B=2^20, f32) each slice C_k[:, i, :]
// (16 KB) serves ~1024 samples, and the FP32 work is 17.4 GFLOP, a 0.26 ms
// bound at 67 TFLOP/s. The wrapper sorts each middle mode's coordinates
// (torch.sort: index bookkeeping the TPU kernel never did) and launches this
// kernel once per middle mode k = 1..N-2. A block takes 128 consecutive
// sorted positions: it reads their input rows (the interface before mode
// k) through the sort's permutation into shared memory, transposed; for
// each run of equal coordinates in the tile it loads the slice once into
// shared memory (64 columns at a time) and multiplies the run's rows by it
// with 8x4 register tiles per thread, in plain FP32 (or FP64) FMAs. Rows
// go back to their samples' places in an interface buffer V (B, R_{k+1})
// in device memory. Mode 0 needs no pass: for k = 1 a row is a row of
// C_0's sum over R_0, looked up by the sample's mode-0 coordinate. For
// k = N-2 the epilogue dots each row with C_{N-1}[:, x, 0] and writes the
// value, so the last mode needs no pass either. What bounds it: the FMAs
// (8.6 GFLOP per middle mode at the design shape, 0.13 ms at the FP32
// peak), then V's round trip through device memory (256 MiB each way per
// interface, ~0.08 ms at 3.35 TB/s) and a tile's extra passes where it
// meets more than one run (~12% of tiles at the design shape; at few
// samples per slice a tile meets many runs, which is slow but right). It
// reaches ~0.45 ms a launch there, 28% of the FP32 peak; staging its
// gathers in registers or double-buffering tiles with cp.async did not
// move that, so the gathers' latency is not the gap (PERF.md). Each
// output is a sum over r in a fixed order and never depends on where its
// sample lands in the sort, so the grouped path is bitwise reproducible run
// to run.
//
// tt_eval_kernel (per sample) serves every other shape: N <= 2, few
// samples per slice (the training shape, B/I = 32), and shapes whose tile
// would not fit shared memory. One warp owns one sample and gathers its own
// R x R slice of every core through L2 (at the design shape 16 KB per
// sample per middle mode, ~34 GB in all: L2 traffic, not FMAs, sets its
// time). The TPU kernel had no gather, so it selected the slice with a
// one-hot lane mask and folded it back with a fold matrix; here the warp's
// lanes form G groups of W lanes (W the smallest power of two >= the
// slice's column count, at most 32): a group's lanes run over the columns s,
// so they read neighbouring addresses of one row, and the groups split the
// rows r; warp shuffles sum the groups. The running interface stays in
// shared memory (two buffers of max rank per warp), as the TPU kept it in
// VMEM. Only column 0 of the last mode is computed. Any B (grid-stride over
// samples), any ranks including R_0 and R_N > 1, any I, float32 and float64,
// int32 and int64 coordinates; negative coordinates wrap as in NumPy, and an
// out-of-range one sets *flag (the caller raises IndexError), writes NaN and
// touches no memory out of bounds. (The grouped kernel takes coordinates
// that the wrapper has already wrapped and checked.)
//
// The grouped backward (tnt_tt_eval_slice_grad, for N >= 3 and at least 64
// samples per slice of every middle mode, the shapes where its ~1 ms of
// fixed cost pays). The wrapper sorts every mode's coordinates with a
// stable torch.sort and finds each slice's run of sorted positions; the
// grouped forward kernel writes the left interfaces L_2..L_{N-1} and, on
// each middle core transposed, the right ones Rt_{N-2}..Rt_1 to device
// memory (L_1 and Rt_{N-1} are lookups by coordinate). Then
// slice_grad_kernel, once per mode, reduces each slice over its run: a
// block takes up to 1024 consecutive sorted positions, streams their g_b
// L_k[b] and Rt_{k+1}[b] rows into shared memory (cp.async, two tiles of 32
// positions in flight) and sums the outer products of each run in 4x4
// register tiles per thread, 64x64 slice entries per block. Each slice is
// written once with plain stores: by its block where its run lies inside
// one, else as partials that a sum pass adds in block order; an empty slice
// gets zeros. No atomics: every entry is summed in a fixed order (positions
// in increasing b, which the stable sort keeps within a run), so the
// gradient is bitwise reproducible run to run; a skewed coordinate that
// holds most samples is split across blocks, not left to one. What bounds
// it at the design shape (f32, 52.1 GFLOP, a 0.78 ms bound): the four
// interface launches (~0.42 ms each, the forward kernel's 28% of the FP32
// peak), then the middle reductions (8.6 GFLOP and 512 MiB of gathered
// rows each, ~0.40 ms, 32% of the peak with 2 blocks per SM at 106
// registers), then the sorts; the call takes ~3.9-4.3 ms on an H100
// (700 W) against ~36 ms per sample (PERF.md).
//
// The per-sample backward (tt_eval_backward_kernel, every other shape: the
// training step's B/I = 32 among them) gives each sample a warp that
// recomputes its left interfaces L_0..L_{N-1} into shared memory, then
// sweeps right to left: at mode k it adds the outer product g_b L_k
// Rt_{k+1} into dC_k's slice with atomicAdd (rows contiguous, so each
// warp's atomics are coalesced) and, from the same loads of C_k's slice,
// computes Rt_k = C_k[:, x, :] Rt_{k+1}. The atomics set its time where many
// samples share a slice (8.7e9 of them at the design shape), and their
// order changes from run to run: it is not bitwise reproducible (float32
// agrees with the plain version to ~1e-6 of its largest entry, float64 to
// ~1e-15).

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

// ---------------------------------------------------------------------------
// The grouped kernel: one middle mode, samples in sorted order
// ---------------------------------------------------------------------------

constexpr int GT = 128;       // sorted positions per block (ops/tt_eval.py: _GROUP_TILE)
constexpr int GTHREADS = 256;  // 16 row groups of 8 rows x 16 column groups of 4 columns
constexpr int GCOLS = 64;     // output columns per pass over the tile (_GROUP_COLS)
constexpr int GPAD = 4;       // pad of a transposed input row in shared memory (_GROUP_PAD)

// Shared memory of one block: the tile's permutation and keys, its input
// rows transposed (Rl x (GT + GPAD)) and one slice's columns (Rl x GCOLS).
// ops/tt_eval.py: _grouped_smem mirrors it.
__host__ __device__ constexpr size_t grouped_smem(int Rl, size_t itemsize) {
  return (size_t)GT * (sizeof(int64_t) + sizeof(int)) + (size_t)Rl * (GT + GPAD + GCOLS) * itemsize;
}

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Mode k of the chain for the samples in sorted positions [p0, p0 + GT):
//   y_b = x_b . core[:, keys[p], :]  (Rl -> Rr) for b = perm[p],
// with x_b row b of src (or, when src_idx is set, row src_idx[b * xs] of
// src); then y_b goes to row b of dst, or, when dst is null, out[b] =
// y_b . last[last_idx[b * xs], :]. Keys are in [0, I) and sorted.
template <typename T>
__global__ void __launch_bounds__(GTHREADS)
    tt_eval_grouped_kernel(const T* __restrict__ core, int Rl, int I, int Rr,
                           const int* __restrict__ keys, const int64_t* __restrict__ perm,
                           int64_t B, const T* __restrict__ src, const int* __restrict__ src_idx,
                           T* __restrict__ dst, const T* __restrict__ last,
                           const int* __restrict__ last_idx, int xs, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* const sperm = reinterpret_cast<int64_t*>(smem_raw);
  int* const skeys = reinterpret_cast<int*>(sperm + GT);
  T* const At = reinterpret_cast<T*>(skeys + GT);  // At[r * AS + p]
  T* const S = At + (size_t)Rl * (GT + GPAD);      // S[r * GCOLS + c]
  constexpr int AS = GT + GPAD;
  const int tid = threadIdx.x;
  const int64_t p0 = (int64_t)blockIdx.x * GT;
  const int n = (int)(B - p0 < GT ? B - p0 : GT);

  for (int p = tid; p < GT; p += GTHREADS) {
    sperm[p] = p < n ? perm[p0 + p] : 0;
    skeys[p] = p < n ? keys[p0 + p] : 0;
  }
  __syncthreads();

  // The tile's input rows, transposed; zero past the end of the batch.
  // 16-byte copies where rows allow: eight neighbouring positions take one
  // 4-wide column block, so the transposed stores meet at most 2-way
  // bank conflicts
  if (Rl % 4 == 0 && aligned16(src)) {
    const int nq = Rl / 4;
    for (int idx = tid; idx < GT * nq; idx += GTHREADS) {
      const int rest = idx >> 3, q = rest % nq, p = (rest / nq) * 8 + (idx & 7);
      T v[4] = {T(0), T(0), T(0), T(0)};
      if (p < n) {
        const int64_t b = sperm[p];
        const int64_t row = src_idx ? (int64_t)src_idx[b * xs] : b;
        ld4(src + row * Rl + 4 * q, v);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) At[(4 * q + j) * AS + p] = v[j];
    }
  } else {
    for (int idx = tid; idx < GT * Rl; idx += GTHREADS) {
      const int p = idx / Rl, r = idx % Rl;
      T v = T(0);
      if (p < n) {
        const int64_t b = sperm[p];
        const int64_t row = src_idx ? (int64_t)src_idx[b * xs] : b;
        v = src[row * Rl + r];
      }
      At[r * AS + p] = v;
    }
  }

  const int cg = tid & 15, r0 = (tid >> 4) * 8;  // this thread's 4 columns and 8 rows
  const int wlo = (tid >> 5) * 16;                // this warp's 16 rows
  const int64_t rs = (int64_t)I * Rr;            // stride of r in the core
  const bool vec_core = Rr % 4 == 0 && aligned16(core);
  const bool vec_out = Rr % 4 == 0 && aligned16(dst ? (const void*)dst : (const void*)last);
  T dot[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dot[i] = T(0);

  for (int c0 = 0; c0 < Rr; c0 += GCOLS) {
    const int nc = Rr - c0 < GCOLS ? Rr - c0 : GCOLS;
    const int c = 4 * cg;  // this thread's first column in the pass
    for (int s = 0; s < n;) {
      // The run [s, e) of key skeys[s]: the same bounds in every thread
      const int key = skeys[s];
      int lo = s + 1, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (skeys[mid] <= key) lo = mid + 1;
        else hi = mid;
      }
      const int e = lo;
      __syncthreads();  // the last run's reads of S (and, first time, At's stores) are done
      const T* const cs = core + (int64_t)key * Rr + c0;
      if (vec_core) {
        for (int idx = tid; idx < Rl * (GCOLS / 4); idx += GTHREADS) {
          const int r = idx / (GCOLS / 4), q = 4 * (idx % (GCOLS / 4));
          T v[4] = {T(0), T(0), T(0), T(0)};
          if (q < nc) ld4(cs + r * rs + q, v);
          st4(S + r * GCOLS + q, v);
        }
      } else {
        for (int idx = tid; idx < Rl * GCOLS; idx += GTHREADS) {
          const int r = idx / GCOLS, q = idx % GCOLS;
          S[idx] = q < nc ? cs[r * rs + q] : T(0);
        }
      }
      __syncthreads();
      if (wlo < e && wlo + 16 > s) {  // the warp holds rows of this run
        T acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
#pragma unroll 4
        for (int r = 0; r < Rl; ++r) {
          T a[8], w[4];
          ld4(At + r * AS + r0, a);
          ld4(At + r * AS + r0 + 4, a + 4);
          ld4(S + r * GCOLS + c, w);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], w[j], acc[i][j]);
        }
        if (dst) {  // rows of this run to their samples' rows of V
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int p = r0 + i;
            if (p < s || p >= e || c >= nc) continue;
            T* const d = dst + sperm[p] * Rr + c0 + c;
            if (vec_out) {
              st4(d, acc[i]);
            } else {
              for (int j = 0; j < 4 && c + j < nc; ++j) d[j] = acc[i][j];
            }
          }
        } else {  // the last mode: dot with C_{N-1}[:, x, 0], 16 lanes a row
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int p = r0 + i;
            T part = T(0);
            if (p >= s && p < e && c < nc) {
              const T* const l = last + (int64_t)last_idx[sperm[p] * xs] * Rr + c0 + c;
              T w[4];
              if (vec_out) {
                ld4(l, w);
              } else {
                for (int j = 0; j < 4; ++j) w[j] = c + j < nc ? l[j] : T(0);
              }
              for (int j = 0; j < 4; ++j) part = fma(acc[i][j], w[j], part);
            }
            for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
            dot[i] += part;
          }
        }
      }
      s = e;
    }
  }
  if (!dst && cg == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (r0 + i < n) out[sperm[r0 + i]] = dot[i];
  }
}

// ---------------------------------------------------------------------------
// The grouped backward's reduction: one mode, one gradient slice per run
// ---------------------------------------------------------------------------

constexpr int ST = 32;       // sorted positions per staged tile (two tiles in flight)
constexpr int SR = 64;       // output rows and columns of a block: 16 x 16 threads of 4 x 4
constexpr int SMAXP = 1024;  // most positions a block takes (ops/tt_eval.py: _slice_block)
constexpr int SQ = ST * (SR / 4) / 256;  // 4-wide pieces of each operand a thread stages

// Shared memory of one slice-gradient block taking P positions: two
// stages of row and column operands (ST x SR each), then per position its
// operand rows, weight and key.
__host__ __device__ constexpr size_t slice_grad_smem(int P, size_t itemsize) {
  return 4 * (size_t)ST * SR * itemsize +
         (size_t)P * (2 * sizeof(int64_t) + sizeof(int) + itemsize);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage columns [q, q + 4) of an operand's slab (its columns o0 + q ..) for
// one position into dst: from row `row` of tab by a 16-byte cp.async where
// rows allow (vec), else by plain loads and stores; ones where tab is null;
// zeros past column nq. `w` scales what is stored by plain stores (the
// copies are scaled once they land).
template <typename T>
__device__ __forceinline__ void stage4(T* dst, const T* __restrict__ tab, int64_t row,
                                       int width, int o0, int q, int nq, bool vec, T w) {
  if (tab && vec && q < nq) {
    const T* src = tab + row * width + o0 + q;
#pragma unroll
    for (int h = 0; h < (int)(4 * sizeof(T)) / 16; ++h) cp_async16(dst + h * 16 / sizeof(T),
                                                                  src + h * 16 / sizeof(T));
    return;
  }
  T v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = q + j >= nq ? T(0) : tab ? w * tab[row * width + o0 + q + j] : w;
  st4(dst, v);
}

// The gradient of one mode, dC[:, i, :] = sum over the run of slice i of
// (g_b a_b) (outer) c_b, as a rows x cols product per slice. Block x takes
// sorted positions [x P, min(B, (x + 1) P)); block y one 64 x 64 tile of
// the slices. The block first reads its positions' keys, weights and
// operand rows into shared memory, then streams the rows ST positions at a
// time, the next tile's copies in flight while the current tile's FMAs
// run. For each run of equal keys (one slice) that meets its positions,
// in order, it sums the outer products in registers in position order,
// then writes the sum once: straight into the slice when the run lies
// inside the block, else into partial slot 2x (the block's first run) or
// 2x + 1 (its last), which the sum pass adds up. Row operand a_b: row b of
// A (or A[aidx[b xs]]), ones where A is null; column operand c_b likewise
// from C. Entry (r, c) of slice i goes to out[i os + r orow + c ocol]; a
// partial slot holds rows x cols entries, row-major.
// ops/tt_eval.py: _slice_plan is the same plan in Python.
template <typename T>
__global__ void __launch_bounds__(256)
    slice_grad_kernel(int rows, int cols, const int64_t* __restrict__ bounds,
                      const int* __restrict__ keys, const int64_t* __restrict__ perm,
                      const T* __restrict__ g, int64_t B, int P, const T* __restrict__ A,
                      const int* __restrict__ aidx, const T* __restrict__ C,
                      const int* __restrict__ cidx, int xs, T* __restrict__ out, int64_t os,
                      int64_t orow, int64_t ocol, T* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);  // stage s: A at buf + 2 s ST SR, then C
  int64_t* const arow = reinterpret_cast<int64_t*>(buf + 4 * ST * SR);
  int64_t* const crow = arow + P;
  T* const sg = reinterpret_cast<T*>(crow + P);
  int* const skeys = reinterpret_cast<int*>(sg + P);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int rtiles = (rows + SR - 1) / SR;
  const int r0 = (blockIdx.y % rtiles) * SR, c0 = (blockIdx.y / rtiles) * SR;
  const int nr = rows - r0 < SR ? rows - r0 : SR, nc = cols - c0 < SR ? cols - c0 : SR;
  const int64_t pb = (int64_t)blockIdx.x * P;
  const int np = (int)(pb + P < B ? P : B - pb);
  const bool avec = A && rows % 4 == 0 && aligned16(A);
  const bool cvec = C && cols % 4 == 0 && aligned16(C);
  const bool active = (tid >> 5) * 8 < nr;  // the warp holds rows of the tile

  for (int p = tid; p < np; p += 256) {
    const int64_t b = perm[pb + p];
    skeys[p] = keys[pb + p];
    sg[p] = g[b];
    arow[p] = aidx ? (int64_t)aidx[b * xs] : b;
    crow[p] = cidx ? (int64_t)cidx[b * xs] : b;
  }
  __syncthreads();

  // This thread's pieces of a tile: position p_u, columns [q, q + 4)
  const int q = 4 * (tid % (SR / 4));
  auto stage = [&](int t) {
    T* const As = buf + (t & 1) * 2 * ST * SR;
    T* const Cs = As + ST * SR;
#pragma unroll
    for (int u = 0; u < SQ; ++u) {
      const int p = (tid + 256 * u) / (SR / 4), at = t * ST + p;
      if (at >= np) continue;
      stage4(As + p * SR + q, A, arow[at], rows, r0, q, nr, avec, sg[at]);
      stage4(Cs + p * SR + q, C, crow[at], cols, c0, q, nc, cvec, T(1));
    }
  };

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
  const int tiles = (np + ST - 1) / ST;
  stage(0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of tile t landed
    } else {
      cp_async_wait<0>();
    }
    T* const As = buf + (t & 1) * 2 * ST * SR;
    const T* const Cs = As + ST * SR;
    if (avec && q < nr) {  // scale the row pieces this thread copied by g_b
#pragma unroll
      for (int u = 0; u < SQ; ++u) {
        const int p = (tid + 256 * u) / (SR / 4), at = t * ST + p;
        if (at >= np) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) As[p * SR + q + j] *= sg[at];
      }
    }
    __syncthreads();
    const int64_t t0 = pb + (int64_t)t * ST;
    const int n = np - t * ST < ST ? np - t * ST : ST;
    for (int s = 0; s < n;) {
      // The run of slice `key` from s to the tile's end or the run's end
      const int key = skeys[t * ST + s];
      const int64_t lo = bounds[key], hi = bounds[key + 1];
      const int e = (int)(hi - t0 < n ? hi - t0 : n);
      if (active) {
#pragma unroll 4
        for (int p = s; p < e; ++p) {
          T a[4], c[4];
          ld4(As + p * SR + 4 * ty, a);
          ld4(Cs + p * SR + 4 * tx, c);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], c[j], acc[i][j]);
        }
      }
      if (t0 + e == hi || t0 + e == pb + np) {  // the run, or the block's share of it, ends
        const bool whole = lo >= pb && hi <= pb + np;
        T* const dst = whole ? out + key * os
                             : part + (2 * (int64_t)blockIdx.x + (lo > pb)) * rows * cols;
        const int64_t sr = whole ? orow : cols, sc = whole ? ocol : 1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = 4 * ty + i, c = 4 * tx + j;
            if (r < nr && c < nc) dst[(r0 + r) * sr + (c0 + c) * sc] = acc[i][j];
            acc[i][j] = T(0);
          }
        }
      }
      s = e;
    }
    __syncthreads();  // every read of this stage is done before it is refilled
  }
}

// The slices that slice_grad_kernel did not write whole: slice i (block x)
// whose run crosses blocks of P positions gets the sum of its partial
// slots in block order; an empty slice gets zeros.
template <typename T>
__global__ void __launch_bounds__(256)
    slice_grad_sum_kernel(int rows, int cols, const int64_t* __restrict__ bounds, int P,
                          const T* __restrict__ part, T* __restrict__ out, int64_t os,
                          int64_t orow, int64_t ocol) {
  const int64_t i = blockIdx.x;
  const int e = blockIdx.y * 256 + threadIdx.x;
  if (e >= rows * cols) return;
  const int64_t lo = bounds[i], hi = bounds[i + 1];
  if (hi > lo && lo / P == (hi - 1) / P) return;  // written whole by its block
  T sum = T(0);
  if (hi > lo) {
    for (int64_t x = lo / P; x <= (hi - 1) / P; ++x)
      sum += part[(2 * x + (lo > x * P)) * rows * cols + e];
  }
  out[i * os + (e / cols) * orow + (e % cols) * ocol] = sum;
}

template <typename T>
int slice_grad(int I, int rows, int cols, const int64_t* bounds, const int* keys,
               const int64_t* perm, const T* g, int64_t B, int P, const T* A, const int* aidx,
               const T* C, const int* cidx, int xs, T* out, int64_t os, int64_t orow,
               int64_t ocol, T* part, cudaStream_t s) {
  if (P > SMAXP) return (int)cudaErrorInvalidValue;
  const size_t smem = slice_grad_smem(P, sizeof(T));
  auto kernel = slice_grad_kernel<T>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (int64_t)((rows + SR - 1) / SR) * ((cols + SR - 1) / SR);
  const int64_t sums = ((int64_t)rows * cols + 255) / 256;
  if (tiles > 65535 || sums > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const dim3 grid((unsigned)((B + P - 1) / P), (unsigned)tiles);
    kernel<<<grid, 256, smem, s>>>(rows, cols, bounds, keys, perm, g, B, P, A, aidx, C, cidx, xs,
                                   out, os, orow, ocol, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  slice_grad_sum_kernel<T><<<dim3((unsigned)I, (unsigned)sums), 256, 0, s>>>(
      rows, cols, bounds, P, part, out, os, orow, ocol);
  return (int)cudaGetLastError();
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

// One middle mode k of the grouped forward (see tt_eval_grouped_kernel):
// core (Rl, I, Rr); keys (B,) int32 sorted, in [0, I); perm (B,) int64;
// src (B, Rl), or with src_idx a (rows, Rl) table looked up by src_idx[b *
// xs] (int32); dst (B, Rr), or null with last (rows, Rr), last_idx and out
// (B,) for the last middle mode.
int tnt_tt_eval_grouped(int dtype, const void* core, int Rl, int I, int Rr, const void* keys,
                        const void* perm, long long B, const void* src, const void* src_idx,
                        void* dst, const void* last, const void* last_idx, int xs, void* out,
                        void* stream) {
  if (Rl < 1 || I < 1 || Rr < 1 || (!dst && (!last || !last_idx || !out)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = grouped_smem(Rl, dtype == 0 ? sizeof(float) : sizeof(double));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const unsigned blocks = (unsigned)((B + GT - 1) / GT);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (dtype == 0) {
    auto kernel = tt_eval_grouped_kernel<float>;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, GTHREADS, smem, s>>>(
        (const float*)core, Rl, I, Rr, (const int*)keys, (const int64_t*)perm, (int64_t)B,
        (const float*)src, (const int*)src_idx, (float*)dst, (const float*)last,
        (const int*)last_idx, xs, (float*)out);
  } else {
    auto kernel = tt_eval_grouped_kernel<double>;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, GTHREADS, smem, s>>>(
        (const double*)core, Rl, I, Rr, (const int*)keys, (const int64_t*)perm, (int64_t)B,
        (const double*)src, (const int*)src_idx, (double*)dst, (const double*)last,
        (const int*)last_idx, xs, (double*)out);
  }
  return (int)cudaGetLastError();
}

// One mode of the grouped backward (see slice_grad_kernel): the I slices of
// rows x cols entries, out[i os + r orow + c ocol]. bounds (I + 1,) int64
// run starts of the sorted keys (B,) int32; perm (B,) int64; g (B,); A
// (B, rows) or, with aidx, a table looked up by aidx[b xs] (int32), or
// null for ones; C likewise (B, cols); P sorted positions per block; part
// 2 ceil(B / P) slots of rows x cols scratch. Two launches: the slices and
// the sum pass.
int tnt_tt_eval_slice_grad(int dtype, int I, int rows, int cols, const void* bounds,
                           const void* keys, const void* perm, const void* g, long long B, int P,
                           const void* A, const void* aidx, const void* C, const void* cidx,
                           int xs, void* out, long long os, long long orow, long long ocol,
                           void* part, void* stream) {
  if (I < 1 || rows < 1 || cols < 1 || P < 1 || B < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return slice_grad<float>(I, rows, cols, (const int64_t*)bounds, (const int*)keys,
                             (const int64_t*)perm, (const float*)g, B, P, (const float*)A,
                             (const int*)aidx, (const float*)C, (const int*)cidx, xs,
                             (float*)out, os, orow, ocol, (float*)part, s);
  return slice_grad<double>(I, rows, cols, (const int64_t*)bounds, (const int*)keys,
                            (const int64_t*)perm, (const double*)g, B, P, (const double*)A,
                            (const int*)aidx, (const double*)C, (const int*)cidx, xs,
                            (double*)out, os, orow, ocol, (double*)part, s);
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
