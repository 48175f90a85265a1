// Hand-written Hopper (sm_90a) kernels of the batched Gram-rounding sweep,
// tntorch_tpu_torch.ops.rounding.round_tt_gram_batched.
//
// They replace the Pallas TPU kernels of tntorch_tpu/ops/pallas_gram.py:
//   gram_edge <- pallas_gram_edge (_gram_edge_kernel)
//                out[a,d] = sum_i sum_c (sum_b C[a,i,b] G[b,c]) C[d,i,c]
//   wgram     <- pallas_wgram (_wgram_kernel)
//                out[b,d] = sum_i sum_a C[a,i,b] (sum_a' W[a,a'] C[a',i,d])
//   proj2     <- pallas_proj2 (_proj2_kernel)
//                out[r,i,c] = sum_b (sum_a Y[r,a] C[a,i,b]) X[b,c]
// with C (B, Rl, I, Rr) and every matrix row-major, batch sample z.
//
// What bounds them on this card: at the bench shape (B=32, Rl=Rr=128,
// I=256, f32) one sample's middle edge is ~2.15 GFLOP over a 16 MiB read of
// C, ~128 FLOP/B, far above the H100's FP32-FMA ridge (~67 TFLOP/s over
// 3.35 TB/s, ~20 FLOP/B). In exact f32 they are bound by FMA issue and the
// shared-memory traffic that feeds it, not by HBM. The TPU kernels' point
// (keep the intermediate T = C.G out of device memory) holds here for free;
// the design spends its effort on the inner product. Tensor cores (3xTF32
// or TF32 wgmma) are later work.
//
// Design. All three are one pattern, run by one kernel template with the
// operands' strides as parameters: per mode index i,
//   stage 1: t[m][n] = sum_k P_i[m][k] Q_i[k][n]   (the intermediate)
//   stage 2: acc[m][j] += sum_n t[m][n] R_i[n][j]
// A block owns a 64-row output tile and 128 (gram_edge, wgram) or 64
// (proj2) of its columns, so at rank 128 the intermediate of a row tile is
// computed once, never once per column tile. 256 threads each hold a 4 x 8
// (or 4 x 4) register tile over 4 contiguous rows and groups of 4 contiguous
// columns, read from shared memory as 16-byte vectors. Operands stream
// through shared memory in 16-deep k-slices; the intermediate passes
// through one shared tile of 128 of its n index at a time, so shared memory
// is fixed (48 KB in f32, 95 KB in f64) whatever the ranks.
// The TPU ran the i axis as a sequential grid dimension and carried the sum
// in the output block; Hopper's blocks run in no order. So gram_edge and
// wgram split I across blocks until B x tiles x splits fills one wave of
// resident blocks (the caller sizes it from tnt_occupancy), each
// split writes its partial tile to scratch that the caller allocates, and a
// second small pass sums the splits in a fixed order: no atomics, the result
// is deterministic. proj2 has no sum over i: a block walks its own chunk of
// i. Ragged edges are masked (loads outside read 0, stores outside are
// skipped) and offsets are 64-bit, so any shape runs, Rr = 1 included.
// The TPU's 128-lane pad of proj2's r2 is gone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // output tile rows
constexpr int KS = 16;   // depth of one streamed k-slice
constexpr int CN = 128;  // chunk of the intermediate's n index
constexpr int NT = 256;  // threads per block, seen as 16 x 16
constexpr int PAD = 4;   // shared rows padded by 4 elements (16 B for f32)

// Shared row stride of a slice or tile W columns wide.
template <int W>
constexpr int LD = W + PAD;

// Element (m, n) of a strided operand, batch sample z, mode index i, is
// p[z * sz + i * si + m * sm + n * sn].
template <typename T>
struct Operand {
  const T* p;
  int64_t sz, si, sm, sn;
};

template <typename T>
struct TwoStage {
  Operand<T> P, Q, R;  // stage 1: P (M x K) Q (K x N); stage 2: (.) R (N x J)
  T* out;
  int64_t oz, oi, om, oj, osplit;  // strides of out (osplit: between splits)
  int M, K, N, J, I, i_chunk;
};

template <typename T>
__device__ __forceinline__ const T* at(const Operand<T>& o, int z, int i) {
  return o.p + z * o.sz + i * o.si;
}

// S[k][m] = src[k * sk + m * sm] for k < kn, m < mn, else 0: a KS x W slice.
// Consecutive threads walk the operand's contiguous index.
template <int W, typename T>
__device__ __forceinline__ void load_slice(T* S, const T* __restrict__ src,
                                           int64_t sk, int64_t sm, int kn,
                                           int mn) {
  const int tid = threadIdx.x;
  if (sk == 1) {
#pragma unroll
    for (int p = 0; p < KS * W / NT; ++p) {
      const int idx = tid + p * NT;
      const int k = idx % KS, m = idx / KS;
      S[k * LD<W> + m] = (k < kn && m < mn) ? src[k * sk + m * sm] : T(0);
    }
  } else {
#pragma unroll
    for (int p = 0; p < KS * W / NT; ++p) {
      const int idx = tid + p * NT;
      const int m = idx % W, k = idx / W;
      S[k * LD<W> + m] = (k < kn && m < mn) ? src[k * sk + m * sm] : T(0);
    }
  }
}

// Four contiguous values from shared memory as 16-byte loads.
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(double (&v)[4], const double* p) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
}

// A thread's register tile covers rows row0() + r (r < 4) and columns
// col(s) = 64 (s / 4) + col0() + s % 4.
__device__ __forceinline__ int row0() { return (threadIdx.x / 16) * 4; }
__device__ __forceinline__ int col0() { return (threadIdx.x % 16) * 4; }
__device__ __forceinline__ int col(int s) { return 64 * (s / 4) + col0() + s % 4; }

// acc[r][s] += sum_{k < KS} A[k][row r] * B[k][col s]; A is TM wide, B
// 16 SN wide, both k-major in shared memory.
template <int SN, typename T>
__device__ __forceinline__ void mac(T (&acc)[4][SN], const T* A, const T* B) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    T a[4], b[SN / 4][4];
    load4(a, A + k * LD<TM> + row0());
#pragma unroll
    for (int g = 0; g < SN / 4; ++g) load4(b[g], B + k * LD<16 * SN> + 64 * g + col0());
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < SN; ++s) acc[r][s] += a[r] * b[s / 4][s % 4];
  }
}

template <int SN, typename T>
__device__ __forceinline__ void zero(T (&t)[4][SN]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < SN; ++s) t[r][s] = T(0);
}

// out[m][j] (strides om, oj) = acc, masked to m < mn, j < jn.
template <int SN, typename T>
__device__ __forceinline__ void write_tile(T* out, int64_t om, int64_t oj,
                                           const T (&acc)[4][SN], int mn,
                                           int jn) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < SN; ++s) {
      const int m = row0() + r, j = col(s);
      if (m < mn && j < jn) out[m * om + j * oj] = acc[r][s];
    }
}

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (KS * LD<TM> + KS * LD<CN> + CN * LD<TM>);
}

// grid (row tiles x column tiles, pieces of I, B). PER_I writes out per i
// (proj2); otherwise the sum over the block's piece of I goes to that
// piece's partial output.
template <typename T, int SN2, bool PER_I>
__global__ void __launch_bounds__(NT) two_stage_kernel(const TwoStage<T> p) {
  constexpr int TJ = 16 * SN2;  // output tile columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // KS x TM: P slices
  T* Bs = As + KS * LD<TM>;               // KS x CN: Q slices, then R slices
  T* Ts = Bs + KS * LD<CN>;               // CN x TM: the intermediate, n-major

  const int ncol = (p.J + TJ - 1) / TJ;
  const int m0 = (blockIdx.x / ncol) * TM, j0 = (blockIdx.x % ncol) * TJ;
  const int mn = min(TM, p.M - m0), jn = min(TJ, p.J - j0);
  const int z = blockIdx.z;
  const int i_begin = blockIdx.y * p.i_chunk;
  const int i_end = min(p.I, i_begin + p.i_chunk);

  T acc[4][SN2];
  zero(acc);
  for (int i = i_begin; i < i_end; ++i) {
    const T* P = at(p.P, z, i) + m0 * p.P.sm;
    const T* Q = at(p.Q, z, i);
    const T* R = at(p.R, z, i) + j0 * p.R.sn;
    for (int n0 = 0; n0 < p.N; n0 += CN) {
      const int nn = min(CN, p.N - n0);
      // Stage 1: t[m][n] = sum_k P[m0+m][k] Q[k][n0+n]
      T t[4][CN / 16];
      zero(t);
      for (int k0 = 0; k0 < p.K; k0 += KS) {
        const int kn = min(KS, p.K - k0);
        load_slice<TM>(As, P + k0 * p.P.sn, p.P.sn, p.P.sm, kn, mn);
        load_slice<CN>(Bs, Q + k0 * p.Q.sm + n0 * p.Q.sn, p.Q.sm, p.Q.sn, kn, nn);
        __syncthreads();
        mac(t, As, Bs);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)  // Ts[n][m] = t[m][n]
#pragma unroll
        for (int s = 0; s < CN / 16; ++s) Ts[col(s) * LD<TM> + row0() + r] = t[r][s];
      __syncthreads();
      // Stage 2: acc[m][j] += sum_n t[m][n] R[n0+n][j0+j]
      for (int k0 = 0; k0 < nn; k0 += KS) {
        load_slice<TJ>(Bs, R + (n0 + k0) * p.R.sm, p.R.sm, p.R.sn, min(KS, nn - k0), jn);
        __syncthreads();
        mac(acc, Ts + k0 * LD<TM>, Bs);
        __syncthreads();
      }
    }
    if (PER_I) {
      write_tile(p.out + z * p.oz + i * p.oi + m0 * p.om + j0 * p.oj, p.om, p.oj, acc,
                 mn, jn);
      zero(acc);
    }
  }
  if (!PER_I)
    write_tile(p.out + blockIdx.y * p.osplit + z * p.oz + m0 * p.om + j0 * p.oj, p.om,
               p.oj, acc, mn, jn);
}

// out[j] = sum_p part[p * n + j], summed in split order.
template <typename T>
__global__ void sum_splits_kernel(const T* __restrict__ part,
                                  T* __restrict__ out, int64_t n, int splits) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    T s = part[j];
    for (int p = 1; p < splits; ++p) s += part[p * n + j];
    out[j] = s;
  }
}

// Launches the two-stage kernel over `pieces` pieces of I. For a sum over
// I with more than one piece, the partials land in scratch and a second
// pass sums them into the output.
template <typename T, int SN2, bool PER_I>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(two_stage_kernel<T, SN2, PER_I>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<T>());
}

// Resident blocks per SM of a kernel instance, or -cudaError_t.
template <typename T, int SN2, bool PER_I>
int occupancy() {
  cudaError_t e = allow_smem<T, SN2, PER_I>();
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, two_stage_kernel<T, SN2, PER_I>, NT, smem_bytes<T>());
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, int SN2, bool PER_I>
int launch(TwoStage<T> p, int B, int pieces, T* scratch, cudaStream_t stream) {
  p.i_chunk = (p.I + pieces - 1) / pieces;
  pieces = (p.I + p.i_chunk - 1) / p.i_chunk;  // no empty piece
  const bool split = !PER_I && pieces > 1;
  if (split && scratch == nullptr) return (int)cudaErrorInvalidValue;
  T* out = p.out;
  if (split) p.out = scratch;
  cudaError_t e = allow_smem<T, SN2, PER_I>();
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((p.M + TM - 1) / TM) * ((p.J + 16 * SN2 - 1) / (16 * SN2));
  two_stage_kernel<T, SN2, PER_I>
      <<<dim3(tiles, pieces, B), NT, smem_bytes<T>(), stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return (int)e;
  const int64_t n = p.osplit;
  const int64_t blocks = (n + 255) / 256;
  sum_splits_kernel<T><<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                         stream>>>(scratch, out, n, pieces);
  return (int)cudaGetLastError();
}

template <typename T>
int gram_edge(const T* C, const T* G, T* out, T* scratch, int B, int Rl, int I,
              int Rr, int splits, cudaStream_t stream) {
  const int64_t sA = (int64_t)I * Rr;  // stride of C's left-rank index
  TwoStage<T> p;
  p.P = {C, Rl * sA, Rr, sA, 1};          // P[a][b] = C[a, i, b]
  p.Q = {G, (int64_t)Rr * Rr, 0, Rr, 1};  // Q[b][c] = G[b, c]
  p.R = {C, Rl * sA, Rr, 1, sA};          // R[c][d] = C[d, i, c]
  p.out = out;
  p.oz = (int64_t)Rl * Rl, p.oi = 0, p.om = Rl, p.oj = 1;
  p.osplit = (int64_t)B * Rl * Rl;
  p.M = Rl, p.K = Rr, p.N = Rr, p.J = Rl, p.I = I;
  return launch<T, 8, false>(p, B, splits, scratch, stream);
}

template <typename T>
int wgram(const T* C, const T* W, T* out, T* scratch, int B, int Rl, int I,
          int Rr, int splits, cudaStream_t stream) {
  const int64_t sA = (int64_t)I * Rr;
  TwoStage<T> p;  // computes out transposed: rows d, columns b
  p.P = {C, Rl * sA, Rr, 1, sA};          // P[d][a'] = C[a', i, d]
  p.Q = {W, (int64_t)Rl * Rl, 0, 1, Rl};  // Q[a'][a] = W[a, a']
  p.R = {C, Rl * sA, Rr, sA, 1};          // R[a][b] = C[a, i, b]
  p.out = out;
  p.oz = (int64_t)Rr * Rr, p.oi = 0, p.om = 1, p.oj = Rr;
  p.osplit = (int64_t)B * Rr * Rr;
  p.M = Rr, p.K = Rl, p.N = Rl, p.J = Rr, p.I = I;
  return launch<T, 8, false>(p, B, splits, scratch, stream);
}

template <typename T>
int proj2(const T* Y, const T* C, const T* X, T* out, int B, int r1, int Rl,
          int I, int Rr, int r2, int chunks, cudaStream_t stream) {
  const int64_t sA = (int64_t)I * Rr;
  TwoStage<T> p;
  p.P = {Y, (int64_t)r1 * Rl, 0, Rl, 1};  // P[r][a] = Y[r, a]
  p.Q = {C, Rl * sA, Rr, sA, 1};          // Q[a][b] = C[a, i, b]
  p.R = {X, (int64_t)Rr * r2, 0, r2, 1};  // R[b][c] = X[b, c]
  p.out = out;
  p.oz = (int64_t)r1 * I * r2, p.oi = r2, p.om = (int64_t)I * r2, p.oj = 1;
  p.osplit = 0;
  p.M = r1, p.K = Rl, p.N = Rr, p.J = r2, p.I = I;
  return launch<T, 4, true>(p, B, chunks, nullptr, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = float64.
// Each returns the cudaError_t of its launches (0 on success); none
// synchronises or allocates.
extern "C" {

// Resident blocks per SM of the Gram kernel (kernel 0: gram_edge, wgram) or
// the projection kernel (kernel 1: proj2); a negative value is -cudaError_t.
int tnt_occupancy(int dtype, int kernel) {
  if (dtype == 0)
    return kernel == 0 ? occupancy<float, 8, false>() : occupancy<float, 4, true>();
  return kernel == 0 ? occupancy<double, 8, false>() : occupancy<double, 4, true>();
}

int tnt_gram_edge(int dtype, const void* C, const void* G, void* out,
                  void* scratch, int B, int Rl, int I, int Rr, int splits,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return gram_edge((const float*)C, (const float*)G, (float*)out,
                     (float*)scratch, B, Rl, I, Rr, splits, s);
  return gram_edge((const double*)C, (const double*)G, (double*)out,
                   (double*)scratch, B, Rl, I, Rr, splits, s);
}

int tnt_wgram(int dtype, const void* C, const void* W, void* out,
              void* scratch, int B, int Rl, int I, int Rr, int splits,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return wgram((const float*)C, (const float*)W, (float*)out,
                 (float*)scratch, B, Rl, I, Rr, splits, s);
  return wgram((const double*)C, (const double*)W, (double*)out,
               (double*)scratch, B, Rl, I, Rr, splits, s);
}

int tnt_proj2(int dtype, const void* Y, const void* C, const void* X,
              void* out, int B, int r1, int Rl, int I, int Rr, int r2,
              int chunks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return proj2((const float*)Y, (const float*)C, (const float*)X,
                 (float*)out, B, r1, Rl, I, Rr, r2, chunks, s);
  return proj2((const double*)Y, (const double*)C, (const double*)X,
               (double*)out, B, r1, Rl, I, Rr, r2, chunks, s);
}

}  // extern "C"
