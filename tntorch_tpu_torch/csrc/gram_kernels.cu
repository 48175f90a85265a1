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
// Routes. A pure function of the ranks and the dtype picks an instance
// (ops/gram_kernels.py: _gram_tile, _proj2_tile), the smallest that serves
// the ranks; ranks beyond every instance take two_stage_kernel:
//   gram_edge, wgram  f32: gram_tile_kernel<float, GE, 32 | 64>, then
//                          gram_resident_kernel (GR = 128);
//                     f64: gram_tile_kernel<double, GE, 32 | 64> (DMMA),
//                          then gram_pair_kernel<GE> (128: DMMA on a
//                          cluster of two CTAs), which replaces
//                          two_stage_kernel there;
//   proj2             f32: proj2_tile_kernel<float, 16 | 32, 256>, then
//                          proj2_resident_kernel (r <= 64, Rr <= 128);
//                     f64: proj2_tile_kernel<double, 16, 256 | 32, 128 |
//                          64, 128> (DMMA).
//
// What bounds them on this card. At the bench shape (B=32, Rl=Rr=128,
// I=256, f32) one sample's middle edge is ~2.15 GFLOP over a 16 MiB read of
// C, ~128 FLOP/B, far above the H100's FP32-FMA ridge (~67 TFLOP/s over
// 3.35 TB/s, ~20 FLOP/B): in exact f32 they are bound by FMA issue and the
// shared-memory traffic that feeds it, not by HBM. At the ranks users run
// (5-64) the Gram kernels stay compute-bound (rank 49: ~24 FLOP/B, at the
// FP64 ridge before the padding to a tile), while proj2 at r = 16 does ~5
// FLOP per byte of C and is bound by streaming C once. In float64 only the
// tensor cores (DMMA, mma.sync .f64: IEEE double FMAs at the 67 TFLOP/s
// FP64 peak, about twice FFMA64's rate) can approach the bound. The TPU
// kernels' point (keep the intermediate T = C.G out of device memory)
// holds here for free; TF32 or 3xTF32 for f32 are later work.
//
// gram_tile_kernel (Rl, Rr <= GR = 32 or 64, both dtypes):
// - persistent blocks, one wave sized from tnt_tile_occupancy, each walking
//   the contiguous run of (z, i) units _gram_plan gives it; a warp per
//   16 x 32 region of the GR x GR output, (GR / 4)^2 threads, the sum over
//   i in registers, partials per sample to the plan's slots and a second
//   pass (sum_slots_kernel) in slot order: no atomics, bitwise repeatable;
// - G (or W transposed) resident in shared memory per sample; C_i through 3
//   whole-unit buffers of element cp.async copies (C's rows, Rr long, are
//   16-byte aligned only by chance), two units ahead; T between the stages;
//   every operand k-major with rows GR + 4 long (4 mod 16 doubles: each DMMA
//   fragment load takes the two wavefronts its 256 bytes need);
// - shared memory zeroed once: the padding past the ranks stays 0, so the
//   products run over the tile, k rounded to 8, and warps whose region lies
//   past the ranks skip it;
// - float32: a lane holds 4 x 4 of its warp's region, 16-byte loads, exact
//   FFMA; float64: four m16n8k8 DMMA fragments a warp.
// At rank 49 the tile is 64: the padding costs (64 / 49)^2 in operations.
//
// gram_pair_kernel (float64, 64 < max(Rl, Rr) <= 128): a call at the
// rounding shape (B=32, Rl=Rr=128, I=256) is 68.7 GFLOP, ~64 FLOP per byte
// of C: compute-bound against the FP64 tensor peak (1.03 ms), which only
// DMMA reaches. But G (or W), T and C_i at 128 x 132 doubles
// are 135 KB each against a block's 227 KB, so one block cannot hold a unit.
// - A thread block cluster of two CTAs splits the contracted rank K (Rr for
//   gram_edge, Rl for wgram), padded to 8, into two shares of whole blocks
//   of 8. Each CTA holds its share of G (or W), 64 x 136 doubles, and its
//   share of C_i in two unit buffers of 128 x 72, 212 KB in all: the next
//   unit's share loads while this one's is multiplied, and each pair reads
//   C_i from device memory once.
// - Stage 1, T = C_i G (gram_edge) or U^T = C_i^T W^T (wgram) restricted to
//   the CTA's share of columns, contracts over all of K: its own share of
//   C_i from its shared memory, the peer's share through distributed shared
//   memory (cg::this_cluster().map_shared_rank). Stage 2 adds T's share
//   times the CTA's share of C_i to the CTA's partial: the two partials sum
//   to the output.
// - T never goes to shared memory: a warp owns a 16-row strip of the
//   output (64 doubles a lane) and computes its strip of T in two passes of
//   half the share (16 doubles a lane each; the whole strip at once spilled
//   registers). Both stages read each block of 8 of k in the order 0 2 4 6
//   1 3 5 7, so that the stage-1 accumulators are stage 2's A fragment as
//   they stand, and every other fragment is a 16-byte load (row strides 8
//   mod 16 doubles: four wavefronts a warp, the least). No barrier or
//   transposing store between the stages; one cluster barrier a unit.
// - A cluster of two, not four: four CTAs (a quarter of K each) hold fewer
//   registers but read three quarters of C_i remotely and leave more SMs
//   out of whole clusters; on the H100 they ran slower.
// - The sum over i as in gram_tile_kernel: persistent clusters, one wave
//   (cudaOccupancyMaxActiveClusters), each walking _gram_plan's run; each
//   CTA writes its own partial per sample, the plan's slots doubled, and
//   sum_slots_kernel adds them in slot order.
//
// proj2_tile_kernel (r1, r2 <= RT, Rr <= NSEG): a unit is a sample z and
// NSEG / Rr consecutive mode indices, so that each row a of C_z over them
// is one contiguous segment and stage 1 is one product Y (RT x Rl) by the
// segments (Rl x NSEG); stage 2 multiplies each mode index's block of T by
// X. Persistent blocks (one wave) walk contiguous runs of units; C streams
// once through a 3-stage ring of 8-row (f64) or 16-row (f32) slices of
// 16-byte cp.async copies taken from each row's 16-byte boundary below its
// segment (the shift, the first element's offset mod 16 bytes, is added
// back by the readers; the tail copy is trimmed to the segment and rows
// past Rl are zero-filled), the ring running on across units; Y^T and X
// resident per sample; stage 1 in float32 by lanes along the segment
// (conflict-free scalar loads), in float64 by DMMA fragments; stage 2
// masks T's entries past Rr, which belong to the next mode index.
//
// Design of two_stage_kernel (gram_edge and wgram outside that tile, proj2
// beyond its resident tile): one pattern with the operands' strides as
// parameters: per mode index i,
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
// is deterministic. Ragged edges are masked (loads outside read 0, stores
// outside are skipped) and offsets are 64-bit, so any shape runs, Rr = 1
// included. The TPU's 128-lane pad of proj2's r2 is gone.
//
// proj2 has no sum over i, and at the bench shape (r1 = r2 = 64, Rl = Rr =
// 128) its ~38 FLOP per byte of C is only ~2x the ridge: the two-stage
// kernel, which reloads Y and X for every i and waits on each k-slice,
// reached 31% of the FP32 peak there (NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py phase 3). In float32 where 32 < max(r1, r2) <= 64, Rr <=
// 128 and Y, X, the intermediate and the ring fit the 227 KB a block may
// use (Rl <= 320), proj2 runs proj2_resident_kernel:
// - persistent blocks, one wave sized by the caller from
//   tnt_tile_occupancy, each walking a contiguous run of the B x ceil(I / 2)
//   work units (z, a pair of consecutive i);
// - Y (transposed) and X resident in shared memory, reloaded only when the
//   block's sample z changes;
// - C streamed in k-slices (rows a of C_i) through a ring of 3 stages of
//   16-byte cp.async.cg copies (element copies where a row is not 16-byte
//   aligned), slice s + 2 in flight while slice s is multiplied, one
//   barrier per slice; the ring runs on across work units, so the next
//   unit's first slices load during this unit's stage 2;
// - T = Y C_i kept in shared memory between the stages, b-major with an
//   XOR swizzle of 4-element chunks that makes its transposed store free of
//   bank conflicts;
// - register tiles of 8 x 8 (stage 1, both i of a pair) and 8 x 4 (stage
//   2) per thread, fed by 16-byte shared loads; exact FP32 FMAs (no TF32).
// Shapes outside every instance take two_stage_kernel<T, 4, true> unchanged.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
// (proj2 at shapes beyond the resident kernel's tile); otherwise the sum over the block's piece of I goes to that
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

// ---------------------------------------------------------------------------
// proj2 with resident projectors (see the design notes at the top)
// ---------------------------------------------------------------------------

constexpr int RT = 64;    // the tile's r1 and r2
constexpr int RB = 128;   // the tile's Rr
constexpr int RSTAGES = 3;
constexpr size_t SMEM_MAX = 232448;  // the shared memory a block may use

// Mode indices per work unit, depth of a k-slice (float32 only)
template <typename T>
struct Res;
template <>
struct Res<float> {
  static constexpr int IP = 2, KS = 16;
};

template <typename T>
constexpr size_t resident_smem(int Rl) {
  using R = Res<T>;
  const size_t krl = (size_t)(Rl + R::KS - 1) / R::KS * R::KS;
  return sizeof(T) * (krl * RT + (size_t)RB * RT + (size_t)RB * R::IP * RT +
                      (size_t)RSTAGES * R::KS * R::IP * RB);
}

template <typename T>
struct Proj2Args {
  const T* Y;
  const T* C;
  const T* X;
  T* out;
  int B, r1, Rl, I, Rr, r2;
  int vec_c, vec_out;  // rows of C, of out, are 16-byte aligned
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(N), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Column of element (b, m) of the intermediate in its b-major shared tile:
// chunks of 4 along m are XORed with bits 2-4 of b, so that the 8 lanes of a
// quarter warp, which store b = 4l + j, hit 8 distinct bank groups.
__device__ __forceinline__ int swz(int b, int m) { return m ^ (((b >> 2) & 7) << 2); }

template <typename T>
__global__ void __launch_bounds__(NT, 1) proj2_resident_kernel(const Proj2Args<T> p) {
  using R = Res<T>;
  constexpr int IP = R::IP, KS = R::KS;
  constexpr int CW = IP * RB;        // width of a C slice: IP rows C_i[a, :] side by side
  constexpr int TW = IP * RT;        // rows of a unit's intermediate, (i', r)
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  static_assert(KS * CW % (V * NT) == 0 && KS * CW % NT == 0, "slice copies");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int krl = (p.Rl + KS - 1) / KS * KS;
  T* Ys = reinterpret_cast<T*>(smem_raw);  // krl x RT: Ys[a][r] = Y[r, a]
  T* Xs = Ys + (size_t)krl * RT;           // RB x RT: Xs[b][c] = X[b, c]
  T* Ts = Xs + RB * RT;                    // RB x TW, swizzled: T[(i', r), b] at b
  T* Cs = Ts + RB * TW;                    // RSTAGES x KS x CW: the ring

  const int tid = threadIdx.x;
  const int npair = (p.I + IP - 1) / IP;
  const int64_t units = (int64_t)p.B * npair;
  const int64_t u0 = units * blockIdx.x / gridDim.x;
  const int64_t u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int nk = krl / KS;
  const int64_t sA = (int64_t)p.I * p.Rr;  // stride of C's a index
  const int z0 = (int)(u0 / npair), i00 = (int)(u0 % npair) * IP;

  // The producer's place: the next slice to issue is k-slice pk of the unit
  // (pz, pi0), number pu of the block's units, into ring stage pst. Each
  // call issues that slice, Cs[k][i' RB + b] = C[z, k0 + k, i0 + i', b]
  // (0 outside), and commits one group, empty past the block's last slice.
  int64_t pu = u0;
  int pz = z0, pi0 = i00, pk = 0, pst = 0;
  // With 16-byte copies a thread copies the same column of every slice, in
  // rows vk, vk + KQ, ...: its offsets are fixed once here
  constexpr int KQ = NT / (CW / V);
  static_assert(NT % (CW / V) == 0, "16-byte copies: whole rows per pass");
  const int vk = tid / (CW / V), vcol = tid % (CW / V) * V;
  const int vip = vcol / RB, vb = vcol % RB;
  const int64_t voff = vk * sA + (int64_t)vip * p.Rr + vb;
  auto issue = [&]() {
    if (pu < u1) {
      const int z = pz, i0 = pi0, k0 = pk * KS;
      T* dst = Cs + pst * (KS * CW);
      const T* src = p.C + ((int64_t)z * p.Rl + k0) * sA + (int64_t)i0 * p.Rr;
      if (p.vec_c) {
        const bool col_ok = vb < p.Rr && i0 + vip < p.I;
#pragma unroll
        for (int q = 0; q < KS / KQ; ++q) {
          const bool ok = col_ok && k0 + vk + q * KQ < p.Rl;
          cp_async16(dst + (vk + q * KQ) * CW + vcol, ok ? src + voff + q * KQ * sA : p.C,
                     ok ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int q = 0; q < KS * CW / NT; ++q) {
          const int idx = tid + q * NT;
          const int k = idx / CW, col = idx % CW;
          const int ip = col / RB, b = col % RB;
          const bool ok = k0 + k < p.Rl && i0 + ip < p.I && b < p.Rr;
          cp_async<sizeof(T)>(dst + k * CW + col,
                              ok ? src + k * sA + (int64_t)ip * p.Rr + b : p.C,
                              ok ? (int)sizeof(T) : 0);
        }
      }
      if (++pk == nk) {  // on to the next unit
        pk = 0, ++pu, pi0 += IP;
        if (pi0 >= p.I) pi0 = 0, ++pz;
      }
    }
    cp_async_commit();
    pst = pst == RSTAGES - 1 ? 0 : pst + 1;
  };

  for (int s = 0; s < RSTAGES - 1; ++s) issue();
  const int w = tid / 32, l = tid % 32;    // stage 1: rows 8w.., columns i' RB + 4l..
  const int rg = tid / 16, cg = tid % 16;  // stage 2: rows 4 IP rg.., columns 4 cg..
  int zcur = -1, cst = 0;                  // cst: the ring stage of the next slice
  int z = z0, i0 = i00 - IP;
  for (int64_t u = u0; u < u1; ++u) {
    i0 += IP;
    if (i0 >= p.I) i0 = 0, ++z;
    if (z != zcur) {
      __syncthreads();  // every thread is done with the last sample's Y and X
      const T* Yz = p.Y + (int64_t)z * p.r1 * p.Rl;
      for (int q = tid; q < krl * RT; q += NT) {
        const int a = q % krl, r = q / krl;
        Ys[a * RT + r] = (a < p.Rl && r < p.r1) ? Yz[(int64_t)r * p.Rl + a] : T(0);
      }
      const T* Xz = p.X + (int64_t)z * p.Rr * p.r2;
      for (int q = tid; q < RB * RT; q += NT) {
        const int b = q / RT, c = q % RT;
        Xs[q] = (b < p.Rr && c < p.r2) ? Xz[(int64_t)b * p.r2 + c] : T(0);
      }
      zcur = z;  // the first slice's barrier below publishes Ys and Xs
    }

    // Stage 1: t[(i', r), b] = sum_a Y[r, a] C[a, i0 + i', b]
    T acc[8][4 * IP];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 4 * IP; ++s) acc[r][s] = T(0);
    for (int kk = 0; kk < nk; ++kk) {
      cp_async_wait<RSTAGES - 2>();  // this thread's copies of this slice landed
      __syncthreads();  // everyone's landed, and everyone left the last slice's stage
      issue();          // RSTAGES - 1 slices ahead, into the last slice's stage
      const T* Cb = Cs + cst * (KS * CW);
      cst = cst == RSTAGES - 1 ? 0 : cst + 1;
      const T* Yb = Ys + kk * KS * RT + 8 * w;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        T a[2][4], b[IP][4];
        load4(a[0], Yb + k * RT);
        load4(a[1], Yb + k * RT + 4);
#pragma unroll
        for (int ip = 0; ip < IP; ++ip) load4(b[ip], Cb + k * CW + ip * RB + 4 * l);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s2 = 0; s2 < 4 * IP; ++s2) acc[r][s2] += a[r / 4][r % 4] * b[s2 / 4][s2 % 4];
      }
    }
    // t to shared memory, b-major (the ring's barrier above ordered this
    // after every thread's stage 2 of the previous unit)
#pragma unroll
    for (int s2 = 0; s2 < 4 * IP; ++s2) {
      const int b = 4 * l + s2 % 4, m = (s2 / 4) * RT + 8 * w;
      store4(Ts + b * TW + swz(b, m), acc[0][s2], acc[1][s2], acc[2][s2], acc[3][s2]);
      store4(Ts + b * TW + swz(b, m + 4), acc[4][s2], acc[5][s2], acc[6][s2], acc[7][s2]);
    }
    __syncthreads();

    // Stage 2: out[(i', r), c] = sum_b t[(i', r), b] X[b, c]
    T o[4 * IP][4];
#pragma unroll
    for (int r = 0; r < 4 * IP; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] = T(0);
#pragma unroll 4
    for (int b = 0; b < p.Rr; ++b) {
      T a[IP][4], x[4];
#pragma unroll
      for (int g = 0; g < IP; ++g) load4(a[g], Ts + b * TW + swz(b, 4 * IP * rg + 4 * g));
      load4(x, Xs + b * RT + 4 * cg);
#pragma unroll
      for (int r = 0; r < 4 * IP; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] += a[r / 4][r % 4] * x[c];
    }
    const int c0 = 4 * cg;
#pragma unroll
    for (int q = 0; q < 4 * IP; ++q) {
      const int m = 4 * IP * rg + q, r = m % RT, i = i0 + m / RT;
      if (r >= p.r1 || i >= p.I || c0 >= p.r2) continue;
      T* dst = p.out + (((int64_t)z * p.r1 + r) * p.I + i) * p.r2 + c0;
      if (p.vec_out && c0 + 4 <= p.r2) {
        store4(dst, o[q][0], o[q][1], o[q][2], o[q][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < p.r2) dst[c] = o[q][c];
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none in flight
}

template <typename T>
cudaError_t allow_resident(int Rl) {
  return cudaFuncSetAttribute(proj2_resident_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)resident_smem<T>(Rl));
}

template <typename T>
int resident_occupancy(int Rl) {
  if (resident_smem<T>(Rl) > SMEM_MAX) return -(int)cudaErrorInvalidValue;
  cudaError_t e = allow_resident<T>(Rl);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, proj2_resident_kernel<T>, NT,
                                                      resident_smem<T>(Rl));
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T>
int proj2_resident(const T* Y, const T* C, const T* X, T* out, int B, int r1, int Rl,
                   int I, int Rr, int r2, int blocks, cudaStream_t stream) {
  if (r1 > RT || r2 > RT || Rr > RB || resident_smem<T>(Rl) > SMEM_MAX || blocks < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const bool c16 = (uintptr_t)C % 16 == 0, o16 = (uintptr_t)out % 16 == 0;
  const Proj2Args<T> p{Y, C, X, out, B, r1, Rl, I, Rr, r2, Rr % V == 0 && c16,
                       r2 % V == 0 && o16};
  cudaError_t e = allow_resident<T>(Rl);
  if (e != cudaSuccess) return (int)e;
  proj2_resident_kernel<T><<<blocks, NT, resident_smem<T>(Rl), stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gram_edge and wgram with G or W resident (see the design notes at the top)
// ---------------------------------------------------------------------------

constexpr int GR = 128;     // the tile: Rl, Rr <= 128, a 128 x 128 output per sample
constexpr int GKS = 16;     // depth of a ring slice
constexpr int GSLOTS = 12;  // ring slots
constexpr int GAHEAD = 4;   // slices in flight ahead of the one being multiplied
// A unit's slices stay in the ring through its stage 2 while the next
// unit's first GAHEAD slices load
static_assert(GSLOTS - GAHEAD >= GR / GKS, "ring too small for a unit");
constexpr size_t GRAM_SMEM = sizeof(float) * (2 * GR * GR + GSLOTS * GKS * GR);

template <typename T>
struct GramArgs {
  const T* C;
  const T* Q;  // G (gram_edge) or W (wgram)
  T* part;     // the partial sums, slot by slot, each M x M
  T* out;
  const int64_t* run;     // block j walks the units [run[j], run[j + 1]) ...
  const int64_t* first;   // ... and writes its partials from slot first[j] on
  const int64_t* sample;  // sample z's partials: slots [sample[z], sample[z + 1])
  int B, Rl, I, Rr;
  int vec;  // rows of C are 16-byte aligned (wgram's copies; float32 at tile 128)
};

// Column of element (k, x) of a tile stored transposed (k-major, filled by
// 4-byte copies that walk 8 k by 4 x per warp): chunks of 4 along x are
// XORed with k's low 3 bits, so those copies hit 32 distinct banks.
__device__ __forceinline__ int tsw(int k, int x) { return x ^ ((k & 7) << 2); }

// One block per SM walks a contiguous run of the B x I units (z, i) and
// keeps a 128 x 128 output tile in registers (8 x 8 per thread, rows 4 ty +
// r and 64 + 4 ty + r, columns 4 tx + c and 64 + 4 tx + c). Per unit, with
// K the contracted rank (Rr for gram_edge, Rl for wgram) and Ck the unit's
// C_i as K k-major rows in the ring:
//   gram_edge: Ck[b][a] = C[a, i, b] (transposed by the copies)
//     stage 1  T[a][c] = sum_b Ck[b][a] G[b][c]      (A: ring, B: Qs = G)
//     stage 2  o[a][d] += sum_c T[a][c] Ck[c][d]     (A: Ts = T^T, B: ring)
//   wgram: Ck[a][b] = C[a, i, b]
//     stage 1  T[a][d] = sum_a' W[a][a'] Ck[a'][d]   (A: Qs = W^T, B: ring)
//     stage 2  o[b][d] += sum_a Ck[a][b] T[a][d]     (A: ring, B: Ts = T)
// The ring's slices run on across units: slice g goes to slot g % GSLOTS,
// GAHEAD slices ahead of the one multiplied, one barrier per slice.
template <bool GE>
__global__ void __launch_bounds__(NT, 1) gram_resident_kernel(const GramArgs<float> p) {
  constexpr int SL = GKS * GR;  // floats per slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // GR x GR, k-major
  float* Ts = Qs + GR * GR;                        // GR x GR, k-major (stage 2's k)
  float* Cs = Ts + GR * GR;                        // the ring: GSLOTS x GKS x GR

  // A warp holds 4 x 8 threads of the 16 x 16: each A load asks shared
  // memory for 4 distinct float4, each B load for 8
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int ty = (w / 2) * 4 + l / 8, tx = (w % 2) * 8 + l % 8;
  const int K = GE ? p.Rr : p.Rl, M = GE ? p.Rl : p.Rr;
  const int nk = (K + GKS - 1) / GKS;
  const int64_t sA = (int64_t)p.I * p.Rr;  // stride of C's left-rank index
  const int64_t u0 = p.run[blockIdx.x], u1 = p.run[blockIdx.x + 1];
  const int z0 = (int)(u0 / p.I), i00 = (int)(u0 % p.I);
  float* part = p.part + p.first[blockIdx.x] * M * M;

  // The producer's place: k-slice pk of unit pu = (pz, pi) of C, whose
  // C[pz, 0, pi, 0] is psrc, into slot pst. copy(q) issues part q of 8 of
  // that slice (0 outside C; nothing past the block's last slice); next()
  // commits the slice as one group and moves on. Stage 1 spreads a slice's
  // parts over its k-steps, so the copies never queue up all at once.
  int64_t pu = u0;
  int pz = z0, pi = i00, pk = 0, pst = 0;
  const float* psrc = p.C + ((int64_t)z0 * p.Rl * p.I + i00) * p.Rr;
  auto copy = [&](int q) {
    if (pu >= u1) return;
    float* dst = Cs + pst * SL;
    const int k0 = pk * GKS;
    if (GE) {  // dst[k][tsw(k, a)] = C[pz, a, pi, k0 + k]; a warp copies 8 k x 4 a
      const int k = (tid & 7) + 8 * (q >> 2), a = (tid >> 3) + 32 * (q & 3);
      const bool ok = a < p.Rl && k0 + k < p.Rr;
      cp_async<4>(dst + k * GR + tsw(k, a), ok ? psrc + a * sA + k0 + k : p.C, ok ? 4 : 0);
    } else if (p.vec) {  // dst[k][b] = C[pz, k0 + k, pi, b], 16 bytes a copy, parts 0 and 1
      if (q >= SL / (4 * NT)) return;
      const int k = tid / 32 + 8 * q, b = tid % 32 * 4;
      const bool ok = k0 + k < p.Rl && b < p.Rr;
      cp_async16(dst + k * GR + b, ok ? psrc + (k0 + k) * sA + b : p.C, ok ? 16 : 0);
    } else {  // the same, 4 bytes a copy
      const int k = tid / GR + 2 * q, b = tid % GR;
      const bool ok = k0 + k < p.Rl && b < p.Rr;
      cp_async<4>(dst + k * GR + b, ok ? psrc + (k0 + k) * sA + b : p.C, ok ? 4 : 0);
    }
  };
  auto next = [&]() {
    if (pu < u1 && ++pk == nk) {  // on to the next unit
      pk = 0, ++pu, psrc += p.Rr;
      if (++pi == p.I) pi = 0, ++pz, psrc = p.C + (int64_t)pz * p.Rl * sA;
    }
    cp_async_commit();
    pst = pst == GSLOTS - 1 ? 0 : pst + 1;
  };
  static_assert(SL / NT == 8, "8 copy parts a slice");

  for (int s = 0; s < GAHEAD; ++s) {
#pragma unroll
    for (int q = 0; q < 8; ++q) copy(q);
    next();
  }
  float o[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[r][c] = 0.f;
  int z = z0, i = i00, zq = -1, cst = 0;  // cst: the slot of the next slice
  for (int64_t u = u0; u < u1; ++u) {
    if (z != zq) {
      // Q of sample z; the last reads of Qs (stage 1 of the last unit) are
      // behind the barrier that published T, and the first slice's barrier
      // below publishes this
      if (GE) {  // Qs[b][c] = G[z, b, c]
        const float* G = p.Q + (int64_t)z * p.Rr * p.Rr;
#pragma unroll 8
        for (int e = tid; e < GR * GR; e += NT) {
          const int b = e / GR, c = e % GR;
          Qs[e] = b < p.Rr && c < p.Rr ? G[b * p.Rr + c] : 0.f;
        }
      } else {  // Qs[a'][tsw(a', a)] = W[z, a, a']
        const float* W = p.Q + (int64_t)z * p.Rl * p.Rl;
        const int kb = tid & 7, ab = tid >> 3;
#pragma unroll 8
        for (int q = 0; q < GR * GR / NT; ++q) {
          const int k = kb + 8 * (q >> 2), a = ab + 32 * (q & 3);
          Qs[k * GR + tsw(k, a)] = a < p.Rl && k < p.Rl ? W[a * p.Rl + k] : 0.f;
        }
      }
      zq = z;
    }

    // Stage 1: t = T's tile, over the unit's nk slices as they land
    float t[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) t[r][c] = 0.f;
    const int cst0 = cst;
    for (int kk = 0; kk < nk; ++kk) {
      cp_async_wait<GAHEAD - 1>();  // this thread's copies of this slice landed
      __syncthreads();  // everyone's landed, and every earlier read of the slot refilled next is done
      const float* Cb = Cs + cst * SL;
      cst = cst == GSLOTS - 1 ? 0 : cst + 1;
      const float* Ab = GE ? Cb : Qs + kk * SL;  // transposed (tsw)
      const float* Bb = GE ? Qs + kk * SL : Cb;
#pragma unroll
      for (int k = 0; k < GKS; ++k) {
        if (k % 2 == 0) copy(k / 2);  // the slice GAHEAD ahead, into a slot read 8 slices ago
        float a[2][4], b[2][4];
        load4(a[0], Ab + k * GR + tsw(k, 4 * ty));
        load4(a[1], Ab + k * GR + tsw(k, 64 + 4 * ty));
        load4(b[0], Bb + k * GR + 4 * tx);
        load4(b[1], Bb + k * GR + 64 + 4 * tx);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) t[r][c] += a[r / 4][r % 4] * b[c / 4][c % 4];
      }
      next();
    }
    // T to shared memory, k-major for stage 2: wgram's k is T's row, stored
    // as is; gram_edge's is T's column, stored transposed with swz
    if (GE) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = (c / 4) * 64 + 4 * tx + c % 4;
        store4(Ts + n * GR + swz(n, 4 * ty), t[0][c], t[1][c], t[2][c], t[3][c]);
        store4(Ts + n * GR + swz(n, 64 + 4 * ty), t[4][c], t[5][c], t[6][c], t[7][c]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = (r / 4) * 64 + 4 * ty + r % 4;
        store4(Ts + m * GR + 4 * tx, t[r][0], t[r][1], t[r][2], t[r][3]);
        store4(Ts + m * GR + 64 + 4 * tx, t[r][4], t[r][5], t[r][6], t[r][7]);
      }
    }
    __syncthreads();

    // Stage 2: o += over the same slices, still in the ring
    int st = cst0;
    for (int kk = 0; kk < nk; ++kk) {
      const float* Cb = Cs + st * SL;
      st = st == GSLOTS - 1 ? 0 : st + 1;
      const float* Tb = Ts + kk * SL;
#pragma unroll
      for (int k = 0; k < GKS; ++k) {
        float a[2][4], b[2][4];
        if (GE) {
          const int kg = kk * GKS + k;
          load4(a[0], Tb + k * GR + swz(kg, 4 * ty));
          load4(a[1], Tb + k * GR + swz(kg, 64 + 4 * ty));
          load4(b[0], Cb + k * GR + tsw(k, 4 * tx));
          load4(b[1], Cb + k * GR + tsw(k, 64 + 4 * tx));
        } else {
          load4(a[0], Cb + k * GR + 4 * ty);
          load4(a[1], Cb + k * GR + 64 + 4 * ty);
          load4(b[0], Tb + k * GR + 4 * tx);
          load4(b[1], Tb + k * GR + 64 + 4 * tx);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) o[r][c] += a[r / 4][r % 4] * b[c / 4][c % 4];
      }
    }

    // At the end of a sample's units in this run, its partial to its slot
    const int zn = i + 1 == p.I ? z + 1 : z;
    if (zn != z || u + 1 == u1) {
      float* dst = part + (int64_t)(z - z0) * M * M;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = (r / 4) * 64 + 4 * ty + r % 4;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = (c / 4) * 64 + 4 * tx + c % 4;
          if (m < M && n < M) dst[m * M + n] = o[r][c];
          o[r][c] = 0.f;
        }
      }
    }
    i = i + 1 == p.I ? 0 : i + 1;
    z = zn;
  }
  cp_async_wait<0>();  // only empty groups remain; leave none in flight
}

// out[z][j] = the sum of part[s][j] over sample z's slots, in slot order;
// each slot of the plan is `per` slots here (one a CTA of a cluster).
template <typename T>
__global__ void sum_slots_kernel(const T* __restrict__ part, const int64_t* __restrict__ sample,
                                 T* __restrict__ out, int B, int64_t n, int per) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < B * n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t z = e / n, j = e % n, s0 = sample[z] * per, s1 = sample[z + 1] * per;
    T s = part[s0 * n + j];
    for (int64_t q = s0 + 1; q < s1; ++q) s += part[q * n + j];
    out[e] = s;
  }
}

// The second pass of a Gram kernel with a plan: each sample's slots summed
template <typename T, bool GE>
int sum_slots(const GramArgs<T>& p, int per, cudaStream_t stream) {
  const int64_t n = GE ? (int64_t)p.Rl * p.Rl : (int64_t)p.Rr * p.Rr;
  const int64_t grid = (p.B * n + 255) / 256;
  sum_slots_kernel<T><<<(unsigned)(grid < 4096 ? grid : 4096), 256, 0, stream>>>(p.part, p.sample,
                                                                                p.out, p.B, n, per);
  return (int)cudaGetLastError();
}

template <bool GE>
cudaError_t allow_gram_resident() {
  return cudaFuncSetAttribute(gram_resident_kernel<GE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GRAM_SMEM);
}

int gram_resident_occupancy() {
  int n = 0;
  cudaError_t e = allow_gram_resident<false>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gram_resident_kernel<false>, NT,
                                                      GRAM_SMEM);
  return e == cudaSuccess ? n : -(int)e;
}

template <bool GE>
int gram_resident(const GramArgs<float>& p, int blocks, cudaStream_t stream) {
  cudaError_t e = allow_gram_resident<GE>();
  if (e != cudaSuccess) return (int)e;
  gram_resident_kernel<GE><<<blocks, NT, GRAM_SMEM, stream>>>(p);
  e = cudaGetLastError();
  return e != cudaSuccess ? (int)e : sum_slots<float, GE>(p, 1, stream);
}

// ---------------------------------------------------------------------------
// Rank-sized tiles (see the design notes at the top): gram_tile_kernel for
// gram_edge and wgram at tiles GR = 32 and 64, proj2_tile_kernel for proj2
// at r1, r2 <= RT = 16, 32 or 64; float32 on exact FFMA, float64 on DMMA
// ---------------------------------------------------------------------------

// D (16 x 8) += A (16 x 8) B (8 x 8) in float64 on the tensor cores, one
// m16n8k8 DMMA (IEEE double FMAs; only the order of the sums is the
// instruction's). With lane = 4 g + t of the warp:
//   a = {A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]},
//   b = {B[t][g], B[t + 4][g]},
//   c = {D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]}.
// The m16n8 shapes of sm_90 run at the FP64 tensor peak; pairs of the
// older m8n8k4 at half of it.
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// acc += sum_{k < kp} At[k][m] Bt[k][n] over a warp's 16 x 32 region at
// (m0, n0); At and Bt are k-major with row strides la and lb, 0 past the
// ranks, and kp is a multiple of 8. Element e of a lane's acc[e / 4][e % 4]
// lies at (m0, n0) + region_at<T>(e).
//   float:  acc[r][c] at (4 (l / 8) + r, 4 (l % 8) + c): 16-byte loads, a
//           warp asking for 4 (A) and 8 (B) distinct vectors, exact FFMA;
//   double: acc[j][q] at (g + 8 (q / 2), 8 j + 2 t + q % 2), four DMMA
//           fragments; strides of 4 mod 16 doubles make every fragment
//           load take the two wavefronts its 256 bytes need.
__device__ __forceinline__ void region_mma(float (&acc)[4][4], const float* At, int la,
                                           const float* Bt, int lb, int m0, int n0, int kp) {
  const int l = threadIdx.x % 32;
  At += m0 + 4 * (l / 8);
  Bt += n0 + 4 * (l % 8);
#pragma unroll 8
  for (int k = 0; k < kp; ++k) {
    float a[4], b[4];
    load4(a, At + k * la);
    load4(b, Bt + k * lb);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
  }
}
__device__ __forceinline__ void region_mma(double (&acc)[4][4], const double* At, int la,
                                           const double* Bt, int lb, int m0, int n0, int kp) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  At += t * la + m0 + g;
  Bt += t * lb + n0 + g;
#pragma unroll 2
  for (int k = 0; k < kp; k += 8) {
    const double* A = At + k * la;
    const double* Bk = Bt + k * lb;
    const double a[4] = {A[0], A[8], A[4 * la], A[4 * la + 8]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double b[2] = {Bk[8 * j], Bk[4 * lb + 8 * j]};
      dmma(acc[j], a, b);
    }
  }
}

template <typename T>
__device__ __forceinline__ int2 region_at(int e) {
  const int l = threadIdx.x % 32;
  if constexpr (sizeof(T) == 4) return make_int2(4 * (l / 8) + e / 4, 4 * (l % 8) + e % 4);
  return make_int2(l / 4 + 8 * (e % 4 / 2), 8 * (e / 4) + 2 * (l % 4) + e % 2);
}

template <typename T>
__device__ __forceinline__ void zero16(T (&acc)[4][4]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e / 4][e % 4] = T(0);
}

constexpr int TBUF = 3;  // C_i buffers: two units load while one is multiplied

template <int GR>
__host__ __device__ constexpr int gram_tile_threads() {
  return GR * GR / 16;  // a warp per 16 x 32 region of the GR x GR output
}
template <typename T, int GR>
__host__ __device__ constexpr size_t gram_tile_smem() {
  return sizeof(T) * (2 + TBUF) * GR * (GR + 4);
}
template <typename T, int GR>
__host__ __device__ constexpr int gram_tile_min_blocks() {
  return GR == 64 ? (sizeof(T) == 8 ? 1 : 2) : 8;
}

// gram_edge (GE) or wgram with Rl, Rr <= GR. Per unit (z, i), with K the
// contracted rank (Rr for gram_edge, Rl for wgram), every operand k-major:
//   gram_edge: Cb[b][a] = C[a, i, b] (transposed by the copies)
//     stage 1  T[a][c] = sum_b Cb[b][a] G[b][c]       (At: Cb, Bt: Qs = G)
//     stage 2  o[a][d] += sum_c Ts[c][a] Cb[c][d]     (Ts = T transposed)
//   wgram: Cb[a][b] = C[a, i, b]
//     stage 1  T[a][d] = sum_a' Qs[a'][a] Cb[a'][d]   (Qs = W transposed)
//     stage 2  o[b][d] += sum_a Cb[a][b] Ts[a][d]     (Ts = T)
// Shared memory is zeroed once; the copies, Q and the warps' stores touch
// the same in-range entries for every unit, so the padding stays 0 and the
// products over a tile padded to 8 in k are exact. Warps whose region lies
// past the ranks skip it.
template <typename T, bool GE, int GR>
__global__ void __launch_bounds__(gram_tile_threads<GR>(), gram_tile_min_blocks<T, GR>())
    gram_tile_kernel(const GramArgs<T> p) {
  constexpr int NTT = gram_tile_threads<GR>(), LDG = GR + 4, TS = GR * LDG;
  constexpr int WC = GR / 32;  // warp regions across the tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ts = Qs + TS;
  T* Cs = Ts + TS;  // TBUF unit buffers

  const int tid = threadIdx.x, w = tid / 32;
  const int m0 = 16 * (w / WC), n0 = 32 * (w % WC);
  const int K = GE ? p.Rr : p.Rl, M = GE ? p.Rl : p.Rr;
  const int kp = (K + 7) / 8 * 8;
  const bool stage1 = m0 < p.Rl && n0 < p.Rr, stage2 = m0 < M && n0 < M;
  const int64_t sA = (int64_t)p.I * p.Rr;  // stride of C's left-rank index
  const int64_t u0 = p.run[blockIdx.x], u1 = p.run[blockIdx.x + 1];
  const int z0 = (int)(u0 / p.I);
  T* part = p.part + p.first[blockIdx.x] * M * M;

  for (int e = tid; e < (2 + TBUF) * TS; e += NTT) Qs[e] = T(0);
  __syncthreads();

  // Unit u's C_i into its buffer as one group of element copies (empty
  // past the run): C's rows are Rr long, 16-byte aligned only by chance
  auto issue = [&](int64_t u) {
    if (u < u1) {
      const int z = (int)(u / p.I), i = (int)(u % p.I);
      T* dst = Cs + (int)((u - u0) % TBUF) * TS;
      const T* src = p.C + (int64_t)z * p.Rl * sA + (int64_t)i * p.Rr;
      for (int e = tid; e < p.Rl * p.Rr; e += NTT) {
        const int a = e / p.Rr, b = e % p.Rr;
        cp_async<sizeof(T)>(dst + (GE ? b * LDG + a : a * LDG + b), src + a * sA + b,
                            (int)sizeof(T));
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < TBUF - 1; ++s) issue(u0 + s);

  T o[4][4];
  zero16(o);
  int zq = -1;
  for (int64_t u = u0; u < u1; ++u) {
    const int z = (int)(u / p.I), i = (int)(u % p.I);
    if (z != zq) {
      // Q of sample z; the last reads of Qs (stage 1 of the last unit) are
      // behind the barrier that published T, and the barrier below
      // publishes this
      if (GE) {  // Qs[b][c] = G[z, b, c]
        const T* G = p.Q + (int64_t)z * p.Rr * p.Rr;
        for (int e = tid; e < p.Rr * p.Rr; e += NTT) Qs[(e / p.Rr) * LDG + e % p.Rr] = G[e];
      } else {  // Qs[a'][a] = W[z, a, a']
        const T* W = p.Q + (int64_t)z * p.Rl * p.Rl;
        for (int e = tid; e < p.Rl * p.Rl; e += NTT) Qs[(e % p.Rl) * LDG + e / p.Rl] = W[e];
      }
      zq = z;
    }
    cp_async_wait<TBUF - 2>();  // this thread's copies of unit u landed
    __syncthreads();  // everyone's landed, and everyone is past stage 2 of the last unit
    issue(u + TBUF - 1);  // into the last unit's buffer
    const T* Cb = Cs + (int)((u - u0) % TBUF) * TS;

    if (stage1) {
      T t[4][4];
      zero16(t);
      region_mma(t, GE ? Cb : Qs, LDG, GE ? Qs : Cb, LDG, m0, n0, kp);
#pragma unroll
      for (int e = 0; e < 16; ++e) {  // k-major for stage 2
        const int2 mn = region_at<T>(e);
        const int m = m0 + mn.x, n = n0 + mn.y;
        Ts[GE ? n * LDG + m : m * LDG + n] = t[e / 4][e % 4];
      }
    }
    __syncthreads();
    if (stage2) region_mma(o, GE ? Ts : Cb, LDG, GE ? Cb : Ts, LDG, m0, n0, kp);

    // At the end of a sample's units in this run, its partial to its slot
    if (i + 1 == p.I || u + 1 == u1) {
      T* dst = part + (int64_t)(z - z0) * M * M;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int2 mn = region_at<T>(e);
        const int m = m0 + mn.x, n = n0 + mn.y;
        if (m < M && n < M) dst[m * M + n] = o[e / 4][e % 4];
      }
      zero16(o);
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none in flight
}

template <typename T, bool GE, int GR>
cudaError_t allow_gram_tile() {
  return cudaFuncSetAttribute(gram_tile_kernel<T, GE, GR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)gram_tile_smem<T, GR>());
}

template <typename T, bool GE, int GR>
int gram_tile_occupancy() {
  int n = 0;
  cudaError_t e = allow_gram_tile<T, GE, GR>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gram_tile_kernel<T, GE, GR>,
                                                      gram_tile_threads<GR>(),
                                                      gram_tile_smem<T, GR>());
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, bool GE, int GR>
int gram_tile(const GramArgs<T>& p, int blocks, cudaStream_t stream) {
  if (p.Rl > GR || p.Rr > GR) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_gram_tile<T, GE, GR>();
  if (e != cudaSuccess) return (int)e;
  gram_tile_kernel<T, GE, GR>
      <<<blocks, gram_tile_threads<GR>(), gram_tile_smem<T, GR>(), stream>>>(p);
  e = cudaGetLastError();
  return e != cudaSuccess ? (int)e : sum_slots<T, GE>(p, 1, stream);
}

// ---------------------------------------------------------------------------
// float64 gram_edge and wgram at 64 < max(Rl, Rr) <= 128: a cluster of PCL
// CTAs that splits the contracted rank, T in the DMMA accumulators (see the
// design notes at the top)
// ---------------------------------------------------------------------------

constexpr int PCL = 2;                            // CTAs a cluster
constexpr int PX = 128;                           // the tile: Rl, Rr <= 128
constexpr int PH = PX / PCL;                      // a CTA's share of the contracted rank, at most
constexpr int PLDQ = PX + 8, PLDC = PH + 8;       // row strides, 8 mod 16 doubles
constexpr size_t PAIR_SMEM = sizeof(double) * ((size_t)PH * PLDQ + 2 * (size_t)PX * PLDC);
static_assert(PAIR_SMEM <= SMEM_MAX, "the pair instance fits a block");

// The first column of CTA q's share of the contracted rank padded to kp (a
// multiple of 8): whole blocks of 8, split as evenly as they go
__device__ __forceinline__ int pair_start(int q, int kp) { return 8 * ((kp / 8) * q / PCL); }

__device__ __forceinline__ void ld2(double& x, double& y, const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x = v.x, y = v.y;
}

// CTA r of cluster c walks the units [run[c], run[c + 1]) with K the
// contracted rank (Rr for gram_edge, Rl for wgram), M the other one, and
// its share S_r of K; every operand has the contracted index along its rows:
//   gram_edge: Qs[h][b] = G[b][c], Cs[a][h] = C[a, i, c]  (c = S_r's h-th)
//   wgram:     Qs[h][a'] = W[a][a'], Cs[d][h] = C[a, i, d]  (a = S_r's h-th)
//   stage 1  T[x][h] = sum_k Cs_q[x][k] Qs[h][k] over every CTA q's share of
//            k, the peers' Cs through distributed shared memory;
//   stage 2  o[x][y] += sum_h T[x][h] Cs[y][h] over S_r
// which is out[a][d] (gram_edge) or out[d][b] transposed (wgram), summed
// over the cluster's CTAs. A warp owns rows 16w.. of T and of o: T stays in
// its stage-1 accumulators and is stage 2's A fragment as it is. Both stages
// read each block of 8 in the k order 0 2 4 6 1 3 5 7 (slot t holds column
// 2t, slot t + 4 column 2t + 1), in A and in B alike: lane (g, t)'s
// accumulators {c0, c1, c2, c3} = T[g][2t], T[g][2t+1], T[g+8][2t],
// T[g+8][2t+1] are then the A fragment {c0, c2, c1, c3}, and every B
// fragment, like every stage-1 A fragment, is two adjacent doubles of a row:
// one 16-byte load.
template <bool GE>
__global__ void __launch_bounds__(NT, 1) gram_pair_kernel(const GramArgs<double> p) {
  constexpr int X = PX, LDQ = PLDQ, LDC = PLDC, NJ = PH / 8, CB = X * LDC;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cid = blockIdx.x / PCL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* Qs = reinterpret_cast<double*>(smem_raw);  // PH x LDQ
  double* Cs = Qs + PH * LDQ;                         // 2 unit buffers, X x LDC each

  const int tid = threadIdx.x, w = tid / 32, l = tid % 32, g = l / 4, t = l % 4;
  const int K = GE ? p.Rr : p.Rl, M = GE ? p.Rl : p.Rr;
  const int kp = (K + 7) / 8 * 8;
  const int k0 = pair_start(rank, kp), nj = (pair_start(rank + 1, kp) - k0) / 8;
  const int kr = max(0, min(K - k0, 8 * nj));  // the share's columns within K
  const int m0 = 16 * w, ny = (M + 7) / 8;
  const int64_t sA = (int64_t)p.I * p.Rr;  // stride of C's left-rank index
  const int64_t u0 = p.run[cid], u1 = p.run[cid + 1];
  const int z0 = (int)(u0 / p.I);
  double* part = p.part + (p.first[cid] * PCL + rank) * M * M;

  for (int e = tid; e < PH * LDQ + 2 * CB; e += NT) Qs[e] = 0.0;

  // Unit u's share of C_i into buffer (u - u0) % 2, one group of element
  // copies (empty past the run); wgram's transposing copies walk 8 a by 4 d
  // a warp, so that their stores hit distinct banks
  auto issue = [&](int64_t u) {
    if (u < u1) {
      const int z = (int)(u / p.I), i = (int)(u % p.I);
      double* dst = Cs + (int)((u - u0) % 2) * CB;
      const double* src = p.C + (int64_t)z * p.Rl * sA + (int64_t)i * p.Rr;
      if (GE) {  // a warp copies a row
        for (int a = w; a < M; a += NT / 32)
          for (int h = l; h < kr; h += 32) cp_async<8>(dst + a * LDC + h, src + a * sA + k0 + h, 8);
      } else {
        for (int q = w; q < NJ * (X / 4); q += NT / 32) {
          const int h = 8 * (q % NJ) + l % 8, d = 4 * (q / NJ) + l / 8;
          if (h < kr && d < M) cp_async<8>(dst + d * LDC + h, src + (k0 + h) * sA + d, 8);
        }
      }
    }
    cp_async_commit();
  };

  double o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[n][q] = 0.0;
  cluster.sync();  // every CTA's shared memory is zeroed before copies land in it
  issue(u0);
  int zq = -1;
  for (int64_t u = u0; u < u1; ++u) {
    const int z = (int)(u / p.I), i = (int)(u % p.I);
    cp_async_wait<0>();  // this thread's copies of unit u landed
    cluster.sync();      // every CTA's have, and every CTA is past unit u - 1
    issue(u + 1);        // into unit u - 1's buffer
    if (z != zq) {
      // The share of G or W of sample z (only this CTA reads its Qs, and
      // all its threads are past unit u - 1)
      if (GE) {  // Qs[h][b] = G[z, b, k0 + h]: a warp copies 8 b by 4 h
        const double* G = p.Q + (int64_t)z * p.Rr * p.Rr;
        for (int q = w; q < (X / 8) * (PH / 4); q += NT / 32) {
          const int b = 8 * (q % (X / 8)) + l % 8, h = 4 * (q / (X / 8)) + l / 8;
          if (b < K && h < kr) Qs[h * LDQ + b] = G[(int64_t)b * p.Rr + k0 + h];
        }
      } else {  // Qs[h][a'] = W[z, k0 + h, a']
        const double* W = p.Q + (int64_t)z * p.Rl * p.Rl;
        for (int h = w; h < kr; h += NT / 32)
          for (int a = l; a < K; a += 32) Qs[h * LDQ + a] = W[(int64_t)(k0 + h) * K + a];
      }
      zq = z;
      __syncthreads();
    }
    const double* Cb = Cs + (int)((u - u0) % 2) * CB;

    if (m0 < M) {
      // The share's blocks of 8 in two passes of NJP: per pass, stage 1
      // tt[j] = T's rows m0.., columns 8 (jb + j).. of the share, then stage
      // 2. Holding half of T's strip at a time leaves ptxas the registers
      // the loads need (with the whole strip both kernels spilled)
      constexpr int NJP = NJ / 2;
#pragma unroll 1
      for (int jb = 0; jb < nj; jb += NJP) {
        double tt[NJP][4];
#pragma unroll
        for (int j = 0; j < NJP; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) tt[j][q] = 0.0;
        const double* Bq = Qs + (8 * jb + g) * LDQ + 2 * t;
        auto stage1 = [&](const double* A, int qs, int nb) {
#pragma unroll 2
          for (int kb = 0; kb < nb; ++kb) {
            double a[4];
            ld2(a[0], a[2], A + 8 * kb);
            ld2(a[1], a[3], A + 8 * LDC + 8 * kb);
#pragma unroll
            for (int j = 0; j < NJP; ++j) {
              if (jb + j < nj) {
                double b[2];
                ld2(b[0], b[1], Bq + 8 * j * LDQ + qs + 8 * kb);
                dmma(tt[j], a, b);
              }
            }
          }
        };
        const int arow = (m0 + g) * LDC + 2 * t;
        for (int q = 0; q < PCL; ++q) {
          const int qs = pair_start(q, kp), nb = (pair_start(q + 1, kp) - qs) / 8;
          if (q == rank)
            stage1(Cb + arow, qs, nb);
          else
            stage1(cluster.map_shared_rank(Cb, q) + arow, qs, nb);
        }
        // Stage 2: o += this pass's columns of T by this CTA's Cs
        const double* Bc = Cb + g * LDC + 8 * jb + 2 * t;
#pragma unroll
        for (int j = 0; j < NJP; ++j) {
          if (jb + j < nj) {
            const double a[4] = {tt[j][0], tt[j][2], tt[j][1], tt[j][3]};
#pragma unroll
            for (int n = 0; n < 16; ++n) {
              if (n < ny) {
                double b[2];
                ld2(b[0], b[1], Bc + 8 * n * LDC + 8 * j);
                dmma(o[n], a, b);
              }
            }
          }
        }
      }
    }

    // At the end of a sample's units in this run, this CTA's partial to its
    // slot: slot s of the plan is PCL slots here, one a CTA
    if (i + 1 == p.I || u + 1 == u1) {
      double* dst = part + (int64_t)(z - z0) * PCL * M * M;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = m0 + g + 8 * (q / 2), y = 8 * n + 2 * t + q % 2;
          if (x < M && y < M) dst[GE ? x * M + y : y * M + x] = o[n][q];
          o[n][q] = 0.0;
        }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none in flight
  cluster.sync();      // no CTA leaves while a peer may still read its shared memory
}

cudaLaunchConfig_t pair_config(int clusters, cudaLaunchAttribute* attr, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * PCL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = PAIR_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool GE>
cudaError_t allow_gram_pair() {
  return cudaFuncSetAttribute(gram_pair_kernel<GE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)PAIR_SMEM);
}

// Clusters of the pair instance that the card holds at once, or -cudaError_t
template <bool GE>
int gram_pair_clusters() {
  cudaError_t e = allow_gram_pair<GE>();
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = pair_config(1, attr, 0);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, gram_pair_kernel<GE>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <bool GE>
int gram_pair(const GramArgs<double>& p, int clusters, cudaStream_t stream) {
  if (p.Rl > PX || p.Rr > PX) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_gram_pair<GE>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = pair_config(clusters, attr, stream);
  e = cudaLaunchKernelEx(&cfg, gram_pair_kernel<GE>, p);
  if (e == cudaSuccess) e = cudaGetLastError();
  return e != cudaSuccess ? (int)e : sum_slots<double, GE>(p, PCL, stream);
}

// proj2 at r1, r2 <= RT and Rr <= NSEG. A unit is (z, ip consecutive mode
// indices i0..): row a of C_z over those indices is one contiguous segment
// of L = ip Rr elements, so
//   stage 1  T[r][n] = sum_a Y[r, a] C[z, a, i0 + n / Rr, n % Rr]   (n < L)
//   stage 2  out[r, i0 + i', c] = sum_b T[r][i' Rr + b] X[b, c]
// C streams through a ring of KS-row slices (RSTAGES deep, across units)
// as 16-byte copies of each row's segment from the 16-byte boundary below
// it: row a lands shifted by s_a = its first element's offset mod 16 B,
// which the readers add back. The segment's tail is trimmed, so no copy
// reads past it; rows past Rl are zero-filled.
template <typename T, int RT, int NSEG>
struct P2Tile {
  static constexpr int V = 16 / (int)sizeof(T);  // elements per 16-byte copy
  static constexpr int KS = sizeof(T) == 8 ? 8 : 16;  // rows of C per ring slice
  static constexpr int LDC = NSEG + 2 * V;   // a ring row: a shift and a trimmed chunk
  static constexpr int LDT = NSEG + 4, LDY = RT + 4;
  static constexpr int MINB = RT == 64 ? 1 : 2;  // blocks an SM holds
  static size_t smem(int Rl, int Rr) {
    const size_t krl = (size_t)(Rl + KS - 1) / KS * KS, kr2 = (size_t)(Rr + 7) / 8 * 8;
    return sizeof(T) * ((krl + kr2) * LDY + (size_t)RT * LDT + (size_t)RSTAGES * KS * LDC);
  }
};

template <typename T, int RT, int NSEG>
__global__ void __launch_bounds__(NT, (P2Tile<T, RT, NSEG>::MINB))
    proj2_tile_kernel(const Proj2Args<T> p, int ip) {
  using P = P2Tile<T, RT, NSEG>;
  constexpr int V = P::V, KS = P::KS, LDC = P::LDC, LDT = P::LDT, LDY = P::LDY;
  constexpr int CH = LDC / V;  // 16-byte chunks of a ring row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int krl = (p.Rl + KS - 1) / KS * KS, kr2 = (p.Rr + 7) / 8 * 8;
  T* Ys = reinterpret_cast<T*>(smem_raw);  // krl x LDY: Ys[a][r] = Y[z, r, a]
  T* Xs = Ys + krl * LDY;                  // kr2 x LDY: Xs[b][c] = X[z, b, c]
  T* Ts = Xs + kr2 * LDY;                  // RT x LDT: T[r][n]
  T* Cs = Ts + RT * LDT;                   // RSTAGES x KS x LDC: the ring

  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int ngrp = (p.I + ip - 1) / ip;
  const int64_t units = (int64_t)p.B * ngrp;
  const int64_t u0 = units * blockIdx.x / gridDim.x;
  const int64_t u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int nk = krl / KS;
  const int64_t sA = (int64_t)p.I * p.Rr;  // stride of C's a index
  const int dA = (int)(sA & (V - 1));      // how a row's shift moves from row to row

  for (int e = tid; e < (krl + kr2) * LDY + RT * LDT + RSTAGES * KS * LDC; e += NT) Ys[e] = T(0);
  __syncthreads();

  // The producer's place: k-slice pk of unit pu = (pz, group pg), into ring
  // stage pst; each call issues that slice and commits one group (empty
  // past the block's last slice)
  int64_t pu = u0;
  int pz = (int)(u0 / ngrp), pg = (int)(u0 % ngrp), pk = 0, pst = 0;
  auto issue = [&]() {
    if (pu < u1) {
      const int i0 = pg * ip, L = min(ip, p.I - i0) * p.Rr;
      T* dst = Cs + pst * (KS * LDC);
      const int64_t e0 = ((int64_t)pz * p.Rl * p.I + i0) * p.Rr + (int64_t)pk * KS * sA;
      if (p.vec_c) {
        for (int q = tid; q < KS * CH; q += NT) {
          const int k = q / CH, ch = q % CH;
          T* d = dst + k * LDC + ch * V;
          if (pk * KS + k >= p.Rl) {
            cp_async16(d, p.C, 0);  // zero rows past Rl
            continue;
          }
          const int64_t e = e0 + k * sA;
          const int off = ch * V - (int)(e & (V - 1));  // the chunk's first element, from e
          if (off < L) cp_async16(d, p.C + e + off, min(16, (L - off) * (int)sizeof(T)));
        }
      } else {  // C itself is not 16-byte aligned: element copies, no shift
        for (int q = tid; q < KS * NSEG; q += NT) {
          const int k = q / NSEG, n = q % NSEG;
          const bool row = pk * KS + k < p.Rl;
          if (!row || n < L)
            cp_async<sizeof(T)>(dst + k * LDC + n, row ? p.C + e0 + k * sA + n : p.C,
                                row ? (int)sizeof(T) : 0);
        }
      }
      if (++pk == nk) {  // on to the next unit
        pk = 0, ++pu;
        if (++pg == ngrp) pg = 0, ++pz;
      }
    }
    cp_async_commit();
    pst = pst == RSTAGES - 1 ? 0 : pst + 1;
  };
  for (int s = 0; s < RSTAGES - 1; ++s) issue();

  // Stage 1's layout. float: thread (ty, tx) holds rows 4 ty + r and
  // columns tx + TX j; double: warp w a 16 x WN region of DMMA fragments
  constexpr int TY = RT / 4, TX = NT / TY, CPT = NSEG / TX;
  constexpr int WN = RT * NSEG / (16 * (NT / 32)), NFR = WN / 8, WX = NSEG / WN;
  static_assert(sizeof(T) == 4 ? TX % 32 == 0 && NSEG % TX == 0 : WN % 8 == 0, "stage-1 layout");
  constexpr int ACC_R = sizeof(T) == 4 ? 4 : NFR, ACC_C = sizeof(T) == 4 ? CPT : 4;
  const int ty = tid / TX, tx = tid % TX;
  const int m0 = 16 * (w / WX), n0 = WN * (w % WX);
  const int g = l / 4, t = l % 4;

  int zcur = -1, cst = 0;  // cst: the ring stage of the next slice
  for (int64_t u = u0; u < u1; ++u) {
    const int z = (int)(u / ngrp), i0 = (int)(u % ngrp) * ip;
    const int ipu = min(ip, p.I - i0), L = ipu * p.Rr;
    if (z != zcur) {
      __syncthreads();  // every thread is done with the last sample's Ys and Xs
      const T* Yz = p.Y + (int64_t)z * p.r1 * p.Rl;
      for (int q = tid; q < krl * RT; q += NT) {
        const int a = q % krl, r = q / krl;
        Ys[a * LDY + r] = (a < p.Rl && r < p.r1) ? Yz[(int64_t)r * p.Rl + a] : T(0);
      }
      const T* Xz = p.X + (int64_t)z * p.Rr * p.r2;
      for (int q = tid; q < kr2 * RT; q += NT) {
        const int b = q / RT, c = q % RT;
        Xs[b * LDY + c] = (b < p.Rr && c < p.r2) ? Xz[(int64_t)b * p.r2 + c] : T(0);
      }
      zcur = z;  // the first slice's barrier below publishes Ys and Xs
    }
    // Row a's shift: its first element's offset mod V, from e(a) = ez + a sA
    const int sz = p.vec_c ? (int)((((int64_t)z * p.Rl * p.I + i0) * p.Rr) & (V - 1)) : 0;
    const int da = p.vec_c ? dA : 0;

    // Stage 1, over the unit's nk slices as they land
    T acc[ACC_R][ACC_C];
#pragma unroll
    for (int r = 0; r < ACC_R; ++r)
#pragma unroll
      for (int c = 0; c < ACC_C; ++c) acc[r][c] = T(0);
    const bool active = sizeof(T) == 4 || (m0 < p.r1 && n0 < L);
    for (int kk = 0; kk < nk; ++kk) {
      cp_async_wait<RSTAGES - 2>();  // this thread's copies of this slice landed
      __syncthreads();  // everyone's landed, and everyone left the last slice's stage
      issue();          // RSTAGES - 1 slices ahead, into the last slice's stage
      const T* Cb = Cs + cst * (KS * LDC);
      cst = cst == RSTAGES - 1 ? 0 : cst + 1;
      const T* Yb = Ys + kk * KS * LDY;
      const int a0 = kk * KS;
      if constexpr (sizeof(T) == 4) {
#pragma unroll 4
        for (int k = 0; k < KS; ++k) {
          const int s = (sz + (a0 + k) * da) & (V - 1);
          T a[4];
          load4(a, Yb + k * LDY + 4 * ty);
          const T* cr = Cb + k * LDC + s + tx;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const T b = cr[TX * j];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][j] += a[r] * b;
          }
        }
      } else if (active) {
        const int s0 = (sz + (a0 + t) * da) & (V - 1), s1 = (sz + (a0 + t + 4) * da) & (V - 1);
        const T a[4] = {Yb[t * LDY + m0 + g], Yb[t * LDY + m0 + 8 + g],
                        Yb[(t + 4) * LDY + m0 + g], Yb[(t + 4) * LDY + m0 + 8 + g]};
        const T* c0 = Cb + t * LDC + s0 + n0 + g;
        const T* c1 = Cb + (t + 4) * LDC + s1 + n0 + g;
#pragma unroll
        for (int j = 0; j < NFR; ++j) {
          const T b[2] = {c0[8 * j], c1[8 * j]};
          dmma(acc[j], a, b);
        }
      }
    }
    // T to shared memory (the ring's barrier above ordered this after every
    // thread's stage 2 of the previous unit)
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) Ts[(4 * ty + r) * LDT + tx + TX * j] = acc[r][j];
    } else if (active) {
#pragma unroll
      for (int j = 0; j < NFR; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          Ts[(m0 + g + 8 * (q / 2)) * LDT + n0 + 8 * j + 2 * t + q % 2] = acc[j][q];
    }
    __syncthreads();

    // Stage 2: out[r, i0 + i', c] = sum_b T[r][i' Rr + b] X[b, c]
    T* outz = p.out + (int64_t)z * p.r1 * p.I * p.r2;
    if constexpr (sizeof(T) == 4) {
      // A thread: 4 columns of two rows, m and m + RP, sharing X's loads
      constexpr int CG = RT / 4, RP = NT / CG;
      const int rr = tid / CG, c0 = 4 * (tid % CG), m2 = ipu * RT;
      for (int m = rr; m < m2 && c0 < p.r2; m += 2 * RP) {
        const int ma = m, mb = m + RP < m2 ? m + RP : m;
        const bool use_a = ma % RT < p.r1, use_b = mb != ma && mb % RT < p.r1;
        const T* ta = Ts + (ma % RT) * LDT + ma / RT * p.Rr;
        const T* tb = Ts + (mb % RT) * LDT + mb / RT * p.Rr;
        T oa[4] = {T(0), T(0), T(0), T(0)}, ob[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
        for (int b = 0; b < p.Rr; ++b) {
          T x[4];
          load4(x, Xs + b * LDY + c0);
          const T va = ta[b], vb = tb[b];
#pragma unroll
          for (int c = 0; c < 4; ++c) oa[c] += va * x[c], ob[c] += vb * x[c];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? use_b : use_a)) continue;
          const int mm = h ? mb : ma;
          T* dst = outz + ((int64_t)(mm % RT) * p.I + i0 + mm / RT) * p.r2 + c0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < p.r2) dst[c] = h ? ob[c] : oa[c];
        }
      }
    } else {
      // A warp item: one 16-row block (one mode index) by half of the
      // columns, so that the 8 warps share even a single mode index's rows
      constexpr int NFH = RT / 16;  // DMMA fragments of a half
      for (int it = w; it < ipu * RT / 16 * 2; it += NT / 32) {
        const int mb = it / 2, j0 = (it % 2) * NFH;
        const int ii = mb * 16 / RT, r0 = mb * 16 % RT;
        if (r0 >= p.r1 || 8 * j0 >= p.r2) continue;
        const T* tr = Ts + (r0 + g) * LDT + ii * p.Rr;
        T o2[NFH][4];
#pragma unroll
        for (int j = 0; j < NFH; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) o2[j][q] = T(0);
        for (int b = 0; b < kr2; b += 8) {
          const bool k0 = b + t < p.Rr, k1 = b + t + 4 < p.Rr;  // T's next index is not X's
          const T a[4] = {k0 ? tr[b + t] : T(0), k0 ? tr[8 * LDT + b + t] : T(0),
                          k1 ? tr[b + t + 4] : T(0), k1 ? tr[8 * LDT + b + t + 4] : T(0)};
#pragma unroll
          for (int j = 0; j < NFH; ++j) {
            const int c = 8 * (j0 + j) + g;
            const T x[2] = {Xs[(b + t) * LDY + c], Xs[(b + t + 4) * LDY + c]};
            dmma(o2[j], a, x);
          }
        }
#pragma unroll
        for (int j = 0; j < NFH; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = r0 + g + 8 * (q / 2), c = 8 * (j0 + j) + 2 * t + q % 2;
            if (r < p.r1 && c < p.r2) outz[((int64_t)r * p.I + i0 + ii) * p.r2 + c] = o2[j][q];
          }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none in flight
}

template <typename T, int RT, int NSEG>
int proj2_tile_occupancy(int Rl, int Rr) {
  const size_t smem = P2Tile<T, RT, NSEG>::smem(Rl, Rr);
  if (smem > SMEM_MAX) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(proj2_tile_kernel<T, RT, NSEG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, proj2_tile_kernel<T, RT, NSEG>, NT, smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, int RT, int NSEG>
int proj2_tile(const T* Y, const T* C, const T* X, T* out, int B, int r1, int Rl, int I, int Rr,
               int r2, int blocks, cudaStream_t stream) {
  const size_t smem = P2Tile<T, RT, NSEG>::smem(Rl, Rr);
  if (r1 > RT || r2 > RT || Rr > NSEG || smem > SMEM_MAX || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int ip = min(NSEG / Rr, I);
  const Proj2Args<T> p{Y, C, X, out, B, r1, Rl, I, Rr, r2, (uintptr_t)C % 16 == 0, 0};
  cudaError_t e = cudaFuncSetAttribute(proj2_tile_kernel<T, RT, NSEG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  proj2_tile_kernel<T, RT, NSEG><<<blocks, NT, smem, stream>>>(p, ip);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = float64.
// Each returns the cudaError_t of its launches (0 on success); none
// synchronises or allocates.
extern "C" {

// Resident blocks per SM of the two-stage Gram kernel (kernel 0: gram_edge,
// wgram beyond the tiles) or the two-stage projection kernel (kernel 1:
// proj2 beyond the tiles); a negative value is -cudaError_t.
int tnt_occupancy(int dtype, int kernel) {
  if (dtype == 0) return kernel == 0 ? occupancy<float, 8, false>() : occupancy<float, 4, true>();
  return kernel == 0 ? occupancy<double, 8, false>() : occupancy<double, 4, true>();
}

// Resident blocks per SM of a tile instance (kind 0: gram_edge, 1: wgram,
// 2: proj2) at these ranks (proj2's shared memory grows with Rl and Rr);
// for float64 gram_edge and wgram at tile 128, the cluster instance, the
// clusters the whole card holds at once. A negative value is -cudaError_t;
// -cudaErrorInvalidValue for an instance that does not exist or does not fit.
int tnt_tile_occupancy(int dtype, int kind, int tile, int Rl, int Rr) {
  const int bad = -(int)cudaErrorInvalidValue;
  if (kind == 2) {
    if (dtype == 0)
      return tile == 16 ? proj2_tile_occupancy<float, 16, 256>(Rl, Rr)
           : tile == 32 ? proj2_tile_occupancy<float, 32, 256>(Rl, Rr)
           : tile == 64 ? resident_occupancy<float>(Rl) : bad;
    return tile == 16 ? proj2_tile_occupancy<double, 16, 256>(Rl, Rr)
         : tile == 32 ? proj2_tile_occupancy<double, 32, 128>(Rl, Rr)
         : tile == 64 ? proj2_tile_occupancy<double, 64, 128>(Rl, Rr) : bad;
  }
  if (dtype == 0 && tile == 128) return gram_resident_occupancy();
  if (tile == 128) return kind == 0 ? gram_pair_clusters<true>() : gram_pair_clusters<false>();
  if (kind == 0)
    return dtype == 0 ? (tile == 32 ? gram_tile_occupancy<float, true, 32>()
                         : tile == 64 ? gram_tile_occupancy<float, true, 64>() : bad)
                      : (tile == 32 ? gram_tile_occupancy<double, true, 32>()
                         : tile == 64 ? gram_tile_occupancy<double, true, 64>() : bad);
  return dtype == 0 ? (tile == 32 ? gram_tile_occupancy<float, false, 32>()
                       : tile == 64 ? gram_tile_occupancy<float, false, 64>() : bad)
                    : (tile == 32 ? gram_tile_occupancy<double, false, 32>()
                       : tile == 64 ? gram_tile_occupancy<double, false, 64>() : bad);
}

// proj2 on the tile instance for r1, r2 <= tile (16, 32 or 64) on `blocks`
// persistent blocks: proj2_tile_kernel, or in float32 at tile 64 the
// resident-projector kernel. cudaErrorInvalidValue for ranks outside the
// instance or shared memory beyond a block's.
int tnt_proj2_tile(int dtype, int tile, const void* Y, const void* C, const void* X, void* out,
                   int B, int r1, int Rl, int I, int Rr, int r2, int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const float *y = (const float*)Y, *c = (const float*)C, *x = (const float*)X;
    float* o = (float*)out;
    if (tile == 16) return proj2_tile<float, 16, 256>(y, c, x, o, B, r1, Rl, I, Rr, r2, blocks, s);
    if (tile == 32) return proj2_tile<float, 32, 256>(y, c, x, o, B, r1, Rl, I, Rr, r2, blocks, s);
    if (tile == 64) return proj2_resident(y, c, x, o, B, r1, Rl, I, Rr, r2, blocks, s);
    return (int)cudaErrorInvalidValue;
  }
  const double *y = (const double*)Y, *c = (const double*)C, *x = (const double*)X;
  double* o = (double*)out;
  if (tile == 16) return proj2_tile<double, 16, 256>(y, c, x, o, B, r1, Rl, I, Rr, r2, blocks, s);
  if (tile == 32) return proj2_tile<double, 32, 128>(y, c, x, o, B, r1, Rl, I, Rr, r2, blocks, s);
  if (tile == 64) return proj2_tile<double, 64, 128>(y, c, x, o, B, r1, Rl, I, Rr, r2, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// gram_edge (edge 0: Q = G) or wgram (edge 1: Q = W) on the tile instance
// for Rl, Rr <= tile (32, 64 or 128: in float32 the resident-Gram kernel,
// in float64 the cluster instance) on `blocks` persistent blocks (clusters
// on the cluster instance), then the sum of each sample's partials.
// plan: run (blocks + 1), first (blocks), sample (B + 1), int64, on the
// card; part: the plan's slots of M x M elements, times the CTAs of a
// cluster on the cluster instance. cudaErrorInvalidValue for a rank above
// the tile or an instance that does not exist; a cluster launch the card
// refuses returns its error.
int tnt_gram_tile(int dtype, int edge, int tile, const void* C, const void* Q, void* out,
                  void* part, const void* plan, int B, int Rl, int I, int Rr, int blocks,
                  void* stream) {
  if (Rl > tile || Rr > tile || blocks < 1) return (int)cudaErrorInvalidValue;
  const int64_t* run = (const int64_t*)plan;
  const int64_t *first = run + blocks + 1, *sample = run + 2 * blocks + 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const GramArgs<float> p{(const float*)C, (const float*)Q, (float*)part, (float*)out,
                            run, first, sample, B, Rl, I, Rr,
                            Rr % 4 == 0 && (uintptr_t)C % 16 == 0};
    if (tile == 128) return edge == 0 ? gram_resident<true>(p, blocks, s) : gram_resident<false>(p, blocks, s);
    if (tile == 64) return edge == 0 ? gram_tile<float, true, 64>(p, blocks, s) : gram_tile<float, false, 64>(p, blocks, s);
    if (tile == 32) return edge == 0 ? gram_tile<float, true, 32>(p, blocks, s) : gram_tile<float, false, 32>(p, blocks, s);
    return (int)cudaErrorInvalidValue;
  }
  const GramArgs<double> p{(const double*)C, (const double*)Q, (double*)part, (double*)out,
                           run, first, sample, B, Rl, I, Rr, 0};
  if (tile == 128) return edge == 0 ? gram_pair<true>(p, blocks, s) : gram_pair<false>(p, blocks, s);
  if (tile == 64) return edge == 0 ? gram_tile<double, true, 64>(p, blocks, s) : gram_tile<double, false, 64>(p, blocks, s);
  if (tile == 32) return edge == 0 ? gram_tile<double, true, 32>(p, blocks, s) : gram_tile<double, false, 32>(p, blocks, s);
  return (int)cudaErrorInvalidValue;
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
