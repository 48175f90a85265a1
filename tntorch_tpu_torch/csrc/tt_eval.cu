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
// tt_eval_kernel (per sample) serves every other shape: N <= 2, few samples
// per slice (the training step's B/I = 32, cp[X], completion, the cross
// validations), and shapes whose tile would not fit shared memory. The TPU
// kernel had no gather: it selected each slice with a one-hot lane mask and
// folded it back with a fold matrix. Here each sample has a lane group of W
// lanes, W the smallest power of two >= the widest interface the chain
// carries (max of R_0..R_{N-1}), at most 32, so a warp holds 32 / W samples
// (8 at ranks 3-4, 2 at rank 16). Lane s keeps column s of the running
// interface in a register, and a mode is
//   v'[s] = sum_r shfl(v, r) C_k[r, x, s],
// the group's lanes reading neighbouring columns of row r, no load waiting on
// another, no shared-memory round trip and no __syncwarp per mode. Ranks
// beyond 32 keep the interface in shared memory, one warp a sample, in the
// same kernel family: there it measured faster on this card than 2 or 4
// columns a lane in registers (PERF.md). A warp loads its samples'
// coordinates W modes at a time, lane w of a group mode kw + w of its sample
// (neighbouring lanes on neighbouring addresses), wraps and checks them, and
// hands the group each mode's by shuffle. Where the interface is in
// registers, all the cores fit the held budget (ops/tt_eval.py: _HELD_BYTES;
// 7.6 KB at cp[X]'s N=4 I=32 ranks 5 in float32) and _STAGE_MIN samples or
// more share each staged element (a block first waits for its copy), a block
// copies them into shared memory with cp.async and reads slices there;
// elsewhere (training's 256 KB middle core) through L1 (__ldg). The grid is
// persistent, one wave, grid-stride over the warps' groups of samples. What
// bounds it on this card: the least time is X's bytes (B x N coordinates, 8
// bytes each in int64, against 4 bytes of output per sample: ~10 us of device
// memory at B = 2^20, N = 4), but at small ranks each warp's instructions set
// it, a mode's setup (~50) before its R_k shuffle-FMA rows, so its time
// follows the warps, not the lanes (PERF.md); at large ranks the L2 gathers
// of each sample's R x R slices (16 KB a sample and middle mode at R = 64),
// which the grouped kernel, not this one, removes. The last mode, only column
// 0, is a row a lane and a butterfly where the core is read from device
// memory, and the row loop where it is staged (its reads are then
// broadcasts). The plan (W, columns, staging, warps, shared memory) is
// ops/tt_eval.py: _per_sample_plan, which the wrapper passes in. Any B, any
// ranks including R_0 and R_N > 1, any I, any N, float32, float64,
// bfloat16 and float16 cores (see "Half precision" and "Long chains"
// below), int32 and int64 coordinates; negative coordinates wrap as in NumPy, and an
// out-of-range one sets *flag (the caller raises IndexError), writes NaN and
// reads no memory out of bounds. Only column 0 of the last mode is computed;
// each value is summed in a fixed order, so the forward is bitwise
// reproducible. (The grouped kernel takes coordinates that the wrapper has
// already wrapped and checked.)
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
// training step's B/I = 32 among them) takes the forward's lane groups and
// coordinate windows, and keeps its right interface in registers up to rank
// 128 (2 or 4 columns a lane above 32, a template parameter: there it
// measured faster than in shared memory, PERF.md). A sample checks its
// coordinates, recomputes its left interfaces L_0..L_{N-1} into the group's
// slice of shared memory (kept in registers, as a stack shifted each mode,
// they measured slower on the card: PERF.md), then sweeps right to left with
// Rt in registers: at mode k lane s adds g_b L_k[r] Rt_{k+1}[s] into
// dC_k[r, x, s], L_k[r] a shared-memory broadcast, and the same loads of
// C_k's slice give Rt_k, each row summed across the group by a butterfly.
// What bounded the one-warp-a-sample kernel it replaces was global atomics:
// at cp[X]'s shape every slice of 25 entries is shared by 32768 samples, and
// they serialize in L2. So a core whose gradient fits the held budget
// (_HELD_BYTES: cp[X]'s 800-entry cores, OPT4's 8 x 64 x 8 core in float64)
// and has at least _PRIV_MIN samples a slice is privatized: the block sums
// into its own copy in shared memory with shared-memory atomics (a
// compare-and-swap loop on this card, which has no shared float add) and adds
// the copy's nonzero entries once to dC. The other cores (training's 16 x 256
// x 16, at 32 samples a slice) take global atomics without a return value
// (RED). What bounds it now: the instructions of each row (an atomic, a load,
// a butterfly of log2 W shuffles) and the shared atomics' retries where
// samples of a block share a slice. The order of the atomics changes from run
// to run, so it is not bitwise reproducible (float32 agrees with the plain
// version to ~1e-6 of its largest entry, float64 to ~1e-15).
//
// Half precision. The per-sample kernels take bfloat16 and float16
// cores as well: a storage type S (the cores', the values', g's) and an
// arithmetic type acc_t<S> (float for the half types, S itself otherwise).
// Inside a mode every product and sum is in float32; after each mode the
// interface, left or right, is rounded to S, as each einsum of the chain
// both packages run (ops/tt_eval.py: tt_eval_plain; the JAX package's
// tt_batch_forward) rounds its output, and the value is S. The backward
// sums its gradients in float32, privatized copies and global atomics
// alike (no half-precision atomics), into a float32 scratch that the
// wrapper rounds to S once, at the end. A staged core is held in S (2
// bytes), the interfaces in float32 (4): the plan gives the held copy and
// the per-warp buffers each their own item size. What bounds the half
// instances is what bounds float32's: each mode's instructions, then the
// gathers, which move half the bytes. The grouped kernel and
// slice_grad_kernel take float32 and float64 only (ops/tt_eval.py:
// _grouped), so half cores take these kernels at every shape.
//
// Long chains. Up to MAX_MODES modes the mode table (each core's
// pointer, ranks, size, place in the shared copy) travels in the kernel's
// parameter struct TT<S>; a longer chain's table is read from device
// memory (Mode<S>, one row of 32 bytes a mode, written by the wrapper:
// ops/tt_eval.py: _mode_table), so a chain may have any number of modes. A
// chain's left interfaces grow with N (sum of R_k a sample); where the
// backward's do not fit a block's shared memory even at one warp, the plan
// keeps them in a device-memory scratch, one slot a warp of the persistent
// grid (`spill`; ops/tt_eval.py: Plan.bwd_spill), so its size is bounded
// by the grid, not by B. Both take the kernels' GENERAL instances (a
// template parameter: the table, and the left interfaces through a generic
// pointer), which the wrapper picks only for such chains: checking for a
// table at every mode, or reaching shared memory through a generic
// pointer, cost the other instances registers and 5-20% of their time on
// the card (PERF.md). The general instances stage no cores and privatize
// no last core, so there are 7 forward and 9 backward ones a type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <vector>

namespace {

constexpr int MAX_MODES = 128;  // ops/tt_eval.py: MAX_MODES, the modes the parameter struct holds
constexpr int WARPS = 8;        // per-sample warps per block, fewer where buffers need it (_WARPS)
constexpr unsigned FULL = 0xffffffffu;

// The arithmetic type of a storage type: float for the half types
template <typename S>
struct Acc {
  using type = S;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};
template <>
struct Acc<__half> {
  using type = float;
};
template <typename S>
using acc_t = typename Acc<S>::type;

__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

// acc_t<S> rounded to the nearest S
template <typename S>
__device__ __forceinline__ S narrow(acc_t<S> x) {
  if constexpr (std::is_same_v<S, acc_t<S>>) return x;
  else if constexpr (std::is_same_v<S, __half>) return __float2half_rn(x);
  else return __float2bfloat16_rn(x);
}

// An interface entry rounded to the cores' dtype after its mode, as the
// chain's einsums round their outputs (no-op for float32 and float64)
template <typename S>
__device__ __forceinline__ acc_t<S> round_to(acc_t<S> x) {
  if constexpr (std::is_same_v<S, acc_t<S>>) return x;
  else return widen(narrow<S>(x));
}

// A core element through L1, as its arithmetic type
template <typename S>
__device__ __forceinline__ acc_t<S> ldg(const S* p) {
  return widen(__ldg(p));
}

// One mode of a chain, as the kernels see it: the core, the gradient
// (backward), R_k, R_{k+1}, I_k, and the core's place in the block's shared
// copy (elements, -1 if not held). The row layout of a long chain's table
// in device memory (ops/tt_eval.py: _mode_table writes it).
template <typename S>
struct alignas(16) Mode {
  const S* core;
  acc_t<S>* grad;
  int Rl, Rr, dim, at;
};
static_assert(sizeof(Mode<float>) == 32, "ops/tt_eval.py: _mode_table writes 32-byte rows");

template <typename S>
struct TT {
  const S* core[MAX_MODES];
  acc_t<S>* grad[MAX_MODES];  // backward only
  int rank[MAX_MODES + 1];
  int dim[MAX_MODES];
  int at[MAX_MODES];   // core k's place in the block's shared copy (elements), -1 if not held
  const Mode<S>* table;  // N > MAX_MODES: the modes in device memory, the arrays above unused
  int N;
  int maxr;            // max of rank[0..N-1]: the widest interface a sample carries
  int lsize;           // rank[0] + ... + rank[N-1]: one sample's left interfaces
  int held;            // elements of the shared copy, rounded up to 4

  // Mode k from the device-memory table (GENERAL) or the arrays above
  template <bool GENERAL>
  __device__ __forceinline__ Mode<S> mode(int k) const {
    if constexpr (GENERAL) return table[k];
    else return Mode<S>{core[k], grad[k], rank[k], rank[k + 1], dim[k], at[k]};
  }
  template <bool GENERAL>
  __device__ __forceinline__ int dim_of(int k) const {
    if constexpr (GENERAL) return table[k].dim;
    else return dim[k];
  }
  template <bool GENERAL>
  __device__ __forceinline__ int rank_of(int k) const {
    if constexpr (GENERAL) return table[k].Rl;
    else return rank[k];
  }
};

// The per-sample kernels' shared memory (ops/tt_eval.py: _per_sample_smem):
// the held copy (staged cores in S, or privatized gradients in acc_t<S>,
// each rounded up to 4 elements), then `warps` per-warp buffers of
// `per_warp` elements of acc_t<S>.
__host__ __device__ constexpr int64_t round4(int64_t n) { return (n + 3) & ~(int64_t)3; }
__host__ __device__ constexpr size_t per_sample_smem(int64_t held, size_t held_size, int warps,
                                                     int64_t per_warp, size_t warp_size) {
  return (size_t)held * held_size + (size_t)(warps * per_warp) * warp_size;
}
// Elements of one sample's left interfaces kept by one warp: those of its
// 32 / W samples, or of its one sample with the interface in shared memory
__host__ __device__ constexpr int64_t lefts_elems(int W, int cols, int lsize) {
  return (cols == 0 ? 1 : (int64_t)(32 / W)) * lsize;
}
// Elements of one warp's shared buffers (ops/tt_eval.py: _warp_elems):
// with the interface in shared memory (cols 0, one sample a warp) two
// interfaces; backward, the left interfaces too, unless they are spilled to
// device memory.
__host__ __device__ constexpr int64_t warp_elems(bool backward, int W, int cols, int maxr,
                                                 int lsize, bool spill) {
  return (cols == 0 ? 2 * (int64_t)maxr : 0) +
         (backward && !spill ? lefts_elems(W, cols, lsize) : 0);
}

template <typename T>
__device__ __forceinline__ T nan_of() {
  return sizeof(T) == 4 ? (T)nanf("") : (T)nan("");
}

// A lane group's coordinates. Lane w of the group holds the wrapped
// coordinate of mode kw + w of the group's sample (-1 when out of range),
// loaded W modes at a time: the warp's lanes read neighbouring addresses of
// their samples' rows of X. at(k) hands the group mode k's by shuffle; the
// window moves with k (forwards or backwards), the same for every lane.
template <typename S, bool GENERAL>
struct Coords {
  const TT<S>& tt;
  const void* X;
  int64_t row;  // b * N
  bool wide, live;
  int w, W, kw, xw;

  __device__ __forceinline__ int at(int k) {
    if (k < kw || k >= kw + W) {
      kw = k & ~(W - 1);
      const int m = kw + w;
      xw = 0;
      if (live && m < tt.N) {
        const int64_t x = wide ? __ldg((const long long*)X + row + m)
                               : (int64_t)__ldg((const int*)X + row + m);
        const int I = tt.template dim_of<GENERAL>(m);
        xw = x < -(int64_t)I || x >= I ? -1 : (int)(x < 0 ? x + I : x);
      }
    }
    return __shfl_sync(FULL, xw, k - kw, W);
  }
};

// A load of element o of a slice, as its arithmetic type: from shared
// memory (SH) or through L1.
template <typename S, bool SH>
__device__ __forceinline__ acc_t<S> load(const S* p, int64_t o) {
  if constexpr (SH) return widen(p[o]);
  else return ldg(p + o);
}

// Mode k's slice at coordinate x: of the core, of the block's shared copy
// of type H (the staged core, S, or the privatized gradient, acc_t<S>) and
// of the gradient.
template <typename S, typename H, bool GENERAL>
struct Slice {
  const S* C;
  H* sh;
  acc_t<S>* dC;
  int64_t rs;  // stride of r
  int Rl, Rr;
  bool held;
  __device__ __forceinline__ Slice(const TT<S>& tt, H* copy, int k, int x) {
    if constexpr (GENERAL) {
      const Mode<S> m = tt.table[k];
      Rl = m.Rl;
      Rr = m.Rr;
      rs = (int64_t)m.dim * Rr;
      const int64_t o = (int64_t)x * Rr;
      C = m.core + o;
      sh = copy + m.at + o;
      dC = m.grad ? m.grad + o : nullptr;
      held = m.at >= 0;
    } else {  // the fields read one by one from the parameter struct
      Rl = tt.rank[k];
      Rr = tt.rank[k + 1];
      rs = (int64_t)tt.dim[k] * Rr;
      const int64_t o = (int64_t)x * Rr;
      C = tt.core[k] + o;
      sh = copy + tt.at[k] + o;
      dC = tt.grad[k] ? tt.grad[k] + o : nullptr;
      held = tt.at[k] >= 0;
    }
  }
};

// One mode of a lane group's chain, the interface in registers:
//   out[s] = sum_{r < Rl} in[r] C[r rs + s]  for s < Rr,
// lane w holding entries w + W j (j < CPL) of in and out. in[r] comes from
// lane r % W by shuffle; neighbouring lanes read neighbouring columns of row
// r, and no load waits on another. A lane past Rr reads column Rr - 1 and
// computes a value that no one reads, so the loop has no branch. Each
// out[s] sums r in increasing order. C in shared memory when SH.
template <typename S, int W, int CPL, bool SH, typename T = acc_t<S>>
__device__ __forceinline__ void step(const T (&in)[CPL], T (&out)[CPL], const S* C, int64_t rs,
                                     int Rl, int Rr, int w) {
  int col[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    out[j] = T(0);
    col[j] = min(w + j * W, Rr - 1);
  }
#pragma unroll
  for (int jr = 0; jr < CPL; ++jr) {
    const S* p = C + (int64_t)jr * W * rs;
#pragma unroll 4  // fully unrolled, the hoisted loads take twice the registers
    for (int src = 0; src < W; ++src, p += rs) {
      if (jr * W + src >= Rl) break;  // the same for every lane
      const T a = __shfl_sync(FULL, in[jr], src, W);
#pragma unroll
      for (int jc = 0; jc < CPL; ++jc)
        if (jc == 0 || jc * W < Rr) out[jc] = fma(a, load<S, SH>(p, col[jc]), out[jc]);
    }
  }
}

// The last mode, only column 0, read from device memory: sum_r in[r]
// C[r rs]. Lane w takes rows w + W j, then the group sums by a butterfly;
// every lane ends with it. (From shared memory the row loop of `step` is
// faster: its reads are broadcasts and its shuffles do not wait on each
// other; PERF.md.)
template <typename S, int W, int CPL, typename T = acc_t<S>>
__device__ __forceinline__ T last_step(const T (&in)[CPL], const S* __restrict__ C, int64_t rs,
                                       int Rl, int w) {
  T part = T(0);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int r = w + j * W;
    if (j == 0 || j * W < Rl) {
      const T c = ldg(C + (int64_t)min(r, Rl - 1) * rs);
      if (r < Rl) part = fma(in[j], c, part);
    }
  }
#pragma unroll
  for (int off = W >> 1; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off, W);
  return part;
}

// The same with the interface in shared memory, one warp a sample (ranks
// beyond the register template): lane s computes columns s, s + 32, ...,
// each rounded to S
template <typename S, typename T = acc_t<S>>
__device__ __forceinline__ void step_shared(const T* in, T* out, const S* __restrict__ C,
                                            int64_t rs, int Rl, int Rr, int lane) {
  for (int s = lane; s < Rr; s += 32) {
    T acc = T(0);
#pragma unroll 4
    for (int r = 0; r < Rl; ++r) acc = fma(in[r], ldg(C + r * rs + s), acc);
    out[s] = round_to<S>(acc);
  }
  __syncwarp();
}

// last_step with the interface in shared memory: the warp's lanes take
// rows lane, lane + 32, ..., then sum by a butterfly.
template <typename S, typename T = acc_t<S>>
__device__ __forceinline__ T last_shared(const T* in, const S* __restrict__ C, int64_t rs, int Rl,
                                         int lane) {
  T part = T(0);
  for (int r = lane; r < Rl; r += 32) part = fma(in[r], ldg(C + r * rs), part);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
  return part;
}

// One mode of the backward's right sweep for a lane group, the right
// interface rt in registers (lane w: entries w + W j; zero past ncols):
//   dst[r rs + s] += g L[r] rt[s]  for r < Rl, s < ncols   (when `active`)
//   rn[r] = sum_s C[r rs + s] rt[s]                         (when `next`)
// L[r] from `left` (a broadcast from shared memory).
// Lane s adds each dst entry by a predicated atomic, into the block's
// shared copy (PRIV) or the gradient itself; the same loads of C give rn,
// each row summed across the group by a butterfly and kept by lane r % W.
// A lane past ncols reads column ncols - 1 and leaves it out of its part
// (its zero times an infinite entry would put a NaN in the row's sum).
// T: the arithmetic type of the cores' type S.
template <typename S, int W, int CPL, bool PRIV, typename Left, typename T = acc_t<S>>
__device__ __forceinline__ void right_step(const Left& left, T g, const T (&rt)[CPL],
                                           T (&rn)[CPL], const S* __restrict__ C, T* dst,
                                           int64_t rs, int Rl, int ncols, bool next, bool active,
                                           int w) {
  int col[CPL];
  bool in[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    rn[j] = T(0);
    col[j] = min(w + j * W, ncols - 1);
    in[j] = w + j * W < ncols;
  }
#pragma unroll
  for (int jr = 0; jr < CPL; ++jr) {
#pragma unroll(W < 8 ? W : 8)
    for (int src = 0; src < W; ++src) {
      if (jr * W + src >= Rl) break;  // the same for every lane
      const T a = g * left(jr, src);
      const int64_t o = (int64_t)(jr * W + src) * rs;
      T part = T(0);
#pragma unroll
      for (int jc = 0; jc < CPL; ++jc) {
        if (jc > 0 && jc * W >= ncols) break;  // the same for every lane; slot 0 always is
        if (active && in[jc]) atomicAdd(dst + o + col[jc], a * rt[jc]);
        const T c = ldg(C + o + col[jc]);
        part = in[jc] ? fma(c, rt[jc], part) : part;
      }
      if (next) {
#pragma unroll
        for (int off = W >> 1; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off, W);
        rn[jr] = w == src ? part : rn[jr];
      }
    }
  }
}

template <typename T, int W>
struct SharedLeft {  // L[r] of a left interface (in shared memory, or spilled to device memory)
  const T* L;
  __device__ __forceinline__ T operator()(int jr, int src) const { return L[jr * W + src]; }
};

// The backward's last mode, only column 0 (Rt_N = e_0), into the gradient
// in device memory: dC[r rs] += g L[r] and rn[r] = C[r rs], which is
// Rt_{N-1}; lane w takes rows w + W j, with no shuffle. (Into a privatized
// copy, right_step's one row at a time is faster: the rows' shared atomics
// then meet fewer others; PERF.md.)
template <typename S, int W, int CPL, typename T = acc_t<S>>
__device__ __forceinline__ void right_last(const T* L, T g, T (&rn)[CPL], const S* __restrict__ C,
                                           T* dC, int64_t rs, int Rl, bool next, bool active,
                                           int w) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int r = w + j * W, rc = min(r, Rl - 1);
    rn[j] = T(0);
    if (j == 0 || j * W < Rl) {
      if (active && r < Rl) atomicAdd(dC + rc * rs, g * L[rc]);
      if (next && r < Rl) rn[j] = ldg(C + rc * rs);
    }
  }
}

// Mode k of the right sweep, into the slice's shared copy where it is held,
// else into the gradient; the last mode by right_last in the instances
// whose last core is not held (LAST)
template <typename S, int W, int CPL, bool LAST, bool GENERAL, typename T = acc_t<S>>
__device__ __forceinline__ void right_mode(const T* L, T g, const T (&rt)[CPL], T (&rn)[CPL],
                                           const Slice<S, T, GENERAL>& sl, bool last, bool next,
                                           bool active, int w) {
  const SharedLeft<T, W> left{L};
  const int ncols = last ? 1 : sl.Rr;
  if (LAST && last)
    right_last<S, W, CPL>(L, g, rn, sl.C, sl.dC, sl.rs, sl.Rl, next, active, w);
  else if (sl.held)
    right_step<S, W, CPL, true>(left, g, rt, rn, sl.C, sl.sh, sl.rs, sl.Rl, ncols, next, active,
                                w);
  else
    right_step<S, W, CPL, false>(left, g, rt, rn, sl.C, sl.dC, sl.rs, sl.Rl, ncols, next, active,
                                 w);
}

// One element of a core into the block's shared copy: by cp.async where
// the element is 4 bytes or more, else (the half types, whose cores need
// not be 4-byte aligned) by a load and a store
template <typename S>
__device__ __forceinline__ void stage_elem(S* dst, const S* src) {
  if constexpr (sizeof(S) >= 4) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(sizeof(S)));
  } else {
    *dst = __ldg(src);
  }
}

// The value of the TT at each row of X: a lane group of W lanes per sample,
// 32 / W samples a warp, grid-stride over the warps' groups of samples.
// CPL = 1: the interface in registers, a column a lane; CPL = 0: in shared
// memory, one warp a sample. STAGED (CPL = 1 only): the block first copies
// every core into shared memory (cp.async) and reads the slices there;
// else through L1, the last mode by last_step. S: the cores' type; the
// interface is acc_t<S>, rounded to S after each mode. GENERAL: the modes
// from the device-memory table (a chain past MAX_MODES).
template <typename S, int W, int CPL, bool STAGED, bool GENERAL>
__global__ void __launch_bounds__(WARPS * 32)
    tt_eval_kernel(const __grid_constant__ TT<S> tt, const void* __restrict__ X, int wide,
                   int64_t B, S* __restrict__ out, int* flag) {
  static_assert(CPL == 0 || CPL == 1, "the forward keeps at most a column a lane");
  static_assert(!STAGED || CPL == 1, "staged cores go with the interface in registers");
  static_assert(!(STAGED && GENERAL), "the general instances stage no cores");
  using T = acc_t<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const held = reinterpret_cast<S*>(smem_raw);
  constexpr int G = 32 / W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int w = lane & (W - 1), N = tt.N;
  if constexpr (STAGED) {
    for (int k = 0; k < N; ++k) {
      const int64_t n = (int64_t)tt.rank[k] * tt.dim[k] * tt.rank[k + 1];
      for (int64_t e = threadIdx.x; e < n; e += blockDim.x)
        stage_elem(held + tt.at[k] + e, tt.core[k] + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  // CPL == 0: two interfaces a warp, after the held copy
  T* const va = reinterpret_cast<T*>(held + tt.held) + (int64_t)warp * 2 * tt.maxr;
  T* const vb = va + tt.maxr;
  const int64_t units = (B + G - 1) / G;
  for (int64_t u = (int64_t)blockIdx.x * warps + warp; u < units;
       u += (int64_t)gridDim.x * warps) {
    const int64_t b = u * G + lane / W;
    Coords<S, GENERAL> cx{tt, X, b * N, wide != 0, b < B, w, W, -W, 0};
    bool ok = true;
    T value;
    if constexpr (CPL > 0) {
      T v[CPL], nv[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) v[j] = T(1);  // ones(R_0); lanes past R_0 are never read
      for (int k = 0; k < N; ++k) {
        const int x = cx.at(k);  // the same for the group's lanes
        ok = ok && x >= 0;
        const Slice<S, S, GENERAL> sl(tt, held, k, max(x, 0));
        if (!STAGED && k == N - 1) {
          v[0] = last_step<S, W, CPL>(v, sl.C, sl.rs, sl.Rl, w);
          break;
        }
        const int Rr = k == N - 1 ? 1 : sl.Rr;
        if constexpr (STAGED) step<S, W, CPL, true>(v, nv, sl.sh, sl.rs, sl.Rl, Rr, w);
        else step<S, W, CPL, false>(v, nv, sl.C, sl.rs, sl.Rl, Rr, w);
#pragma unroll
        for (int j = 0; j < CPL; ++j) v[j] = round_to<S>(nv[j]);
      }
      value = v[0];
    } else {
      T* v = va;
      T* nv = vb;
      for (int r = lane; r < tt.template rank_of<GENERAL>(0); r += 32) v[r] = T(1);
      __syncwarp();
      for (int k = 0; k < N; ++k) {
        const int x = cx.at(k);
        ok = ok && x >= 0;
        const Slice<S, S, GENERAL> sl(tt, held, k, max(x, 0));
        if (k == N - 1) {
          value = last_shared(v, sl.C, sl.rs, sl.Rl, lane);
          break;
        }
        step_shared(v, nv, sl.C, sl.rs, sl.Rl, sl.Rr, lane);
        T* t = v;
        v = nv;
        nv = t;
      }
      __syncwarp();  // every lane has read v before the next sample writes
    }
    if (b < B && w == 0) {
      out[b] = narrow<S>(ok ? value : nan_of<T>());
      if (!ok) atomicOr(flag, 1);
    }
  }
}

// The cores' gradient of sum_b g_b value_b, with the lane groups of the
// forward. A sample first checks all its coordinates (one with any out of
// range sets *flag and adds nothing), sweeps left to right for L_0..L_{N-1},
// kept in the group's slice of shared memory (or, where the plan spills
// them, of the warp's slot of `spill` in device memory), then right to left
// (right_step) with Rt in registers. A core with at >= 0 sums into the
// block's shared copy, zeroed first and added once to the gradient at the
// end; the others take global atomics. LAST: the last core is not held, and
// its mode takes right_last. CPL = 0: every interface in shared memory, one
// warp a sample. Left and right interfaces are rounded to S after each
// mode; the gradients are summed in acc_t<S>. GENERAL: the modes from the
// device-memory table, and the left interfaces in `spill` where it is set.
template <typename S, int W, int CPL, bool LAST, bool GENERAL>
__global__ void __launch_bounds__(WARPS * 32)
    tt_eval_backward_kernel(const __grid_constant__ TT<S> tt, const void* __restrict__ X,
                            int wide, const S* __restrict__ g, int64_t B, int* flag,
                            acc_t<S>* __restrict__ spill) {
  static_assert(LAST || !GENERAL, "the general instances privatize no last core");
  using T = acc_t<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const held = reinterpret_cast<T*>(smem_raw);
  constexpr int G = 32 / W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int w = lane & (W - 1), N = tt.N;
  for (int e = threadIdx.x; e < tt.held; e += blockDim.x) held[e] = T(0);
  __syncthreads();
  const bool spilled = GENERAL && spill;
  T* const wbuf =
      held + tt.held + (int64_t)warp * warp_elems(true, W, CPL, tt.maxr, tt.lsize, spilled);
  // The warp's left interfaces: after its shared buffer's two interfaces
  // (CPL = 0) in shared memory, or in its slot of the device-memory spill
  T* const lefts = spilled ? spill + ((int64_t)blockIdx.x * warps + warp) *
                                         lefts_elems(W, CPL, tt.lsize)
                           : wbuf + (CPL == 0 ? 2 * tt.maxr : 0);
  const int64_t units = (B + G - 1) / G;
  for (int64_t u = (int64_t)blockIdx.x * warps + warp; u < units;
       u += (int64_t)gridDim.x * warps) {
    const int64_t b = u * G + lane / W;
    const bool live = b < B;
    Coords<S, GENERAL> cx{tt, X, b * N, wide != 0, live, w, W, -W, 0};
    bool ok = live;
    for (int k = 0; k < N; ++k) ok = (cx.at(k) >= 0) && ok;
    if (live && !ok && w == 0) atomicOr(flag, 1);
    const T gb = live ? widen(g[b]) : T(0);
    if constexpr (CPL > 0) {
      T v[CPL], nv[CPL], rt[CPL], rn[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        v[j] = T(1);
        rt[j] = w + j * W == 0 ? T(1) : T(0);  // Rt_N = e_0: only column 0 of the last mode
      }
      T* const Lg = lefts + (int64_t)(lane / W) * tt.lsize;  // L_k at rank[0] + .. + rank[k-1]
      const int R0 = tt.template rank_of<GENERAL>(0);
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (w + j * W < R0) Lg[w + j * W] = v[j];
      int off = 0;
      for (int k = 0; k + 1 < N; ++k) {
        const Slice<S, T, GENERAL> sl(tt, held, k, max(cx.at(k), 0));
        step<S, W, CPL, false>(v, nv, sl.C, sl.rs, sl.Rl, sl.Rr, w);
        off += sl.Rl;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          v[j] = round_to<S>(nv[j]);
          if (w + j * W < sl.Rr) Lg[off + w + j * W] = v[j];
        }
      }
      __syncwarp();
      for (int k = N - 1; k >= 0; --k) {
        const Slice<S, T, GENERAL> sl(tt, held, k, max(cx.at(k), 0));
        right_mode<S, W, CPL, LAST>(Lg + off, gb, rt, rn, sl, k == N - 1, k > 0, ok, w);
#pragma unroll
        for (int j = 0; j < CPL; ++j) rt[j] = round_to<S>(rn[j]);
        if (k > 0) off -= tt.template rank_of<GENERAL>(k - 1);
      }
      __syncwarp();  // the group's reads of Lg are done before the next sample writes
    } else {
      T* const Lb = lefts;  // L_k at rank[0] + .. + rank[k-1]
      T* ra = wbuf;
      T* rb = ra + tt.maxr;
      for (int r = lane; r < tt.template rank_of<GENERAL>(0); r += 32) Lb[r] = T(1);
      __syncwarp();
      int off = 0;
      for (int k = 0; k + 1 < N; ++k) {
        const Slice<S, T, GENERAL> sl(tt, held, k, max(cx.at(k), 0));
        step_shared(Lb + off, Lb + off + sl.Rl, sl.C, sl.rs, sl.Rl, sl.Rr, lane);
        off += sl.Rl;
      }
      if (lane == 0) ra[0] = T(1);  // Rt_N = e_0: only column 0 of the last mode
      __syncwarp();
      for (int k = N - 1; k >= 0; --k) {
        const Slice<S, T, GENERAL> sl(tt, held, k, max(cx.at(k), 0));
        if (LAST && k == N - 1) {  // as right_last: a row a lane
          for (int r = lane; r < sl.Rl; r += 32) {
            if (ok) atomicAdd(sl.dC + r * sl.rs, gb * Lb[off + r]);
            rb[r] = ldg(sl.C + r * sl.rs);
          }
          __syncwarp();
          T* t = ra;
          ra = rb;
          rb = t;
          if (k > 0) off -= tt.template rank_of<GENERAL>(k - 1);
          continue;
        }
        const int ncols = k == N - 1 ? 1 : sl.Rr;
        for (int r = 0; r < sl.Rl; ++r) {
          const T a = gb * Lb[off + r];
          T part = T(0);
          for (int s = lane; s < ncols; s += 32) {
            const T t = ra[s];
            const int64_t o = r * sl.rs + s;
            if (ok) {
              if (sl.held) atomicAdd(sl.sh + o, a * t);
              else atomicAdd(sl.dC + o, a * t);
            }
            part = fma(ldg(sl.C + o), t, part);
          }
          if (k > 0) {
            for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(FULL, part, d);
            if (lane == 0) rb[r] = round_to<S>(part);
          }
        }
        __syncwarp();
        T* t = ra;
        ra = rb;
        rb = t;
        if (k > 0) off -= tt.template rank_of<GENERAL>(k - 1);
      }
    }
  }
  __syncthreads();
  for (int k = 0; k < N; ++k) {  // the block's sums, once into each privatized gradient
    const Mode<S> m = tt.template mode<GENERAL>(k);  // GENERAL: one read of the table's row
    if (m.at < 0) continue;
    const int64_t n = (int64_t)m.Rl * m.dim * m.Rr;
    for (int64_t e = threadIdx.x; e < n; e += blockDim.x) {
      const T v = held[m.at + e];
      if (v != T(0)) atomicAdd(m.grad + e, v);
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

// The parameter struct of a chain: its mode table, or (the general
// instances, `table` set) a pointer to the table the wrapper wrote to device
// memory; the widest interface, one sample's left interfaces, and the held
// copy (the cores or gradients with held[k], each at its place in the copy)
template <typename S>
TT<S> make_tt(int N, const void* const* cores, void* const* grads, const int* ranks,
              const int* dims, const int* held, const void* table) {
  TT<S> tt;
  tt.N = N;
  tt.maxr = 0;
  tt.lsize = 0;
  tt.held = 0;
  tt.table = (const Mode<S>*)table;
  for (int k = 0; k < N; ++k) {
    tt.maxr = ranks[k] > tt.maxr ? ranks[k] : tt.maxr;
    tt.lsize += ranks[k];
    const int at = held && held[k] ? tt.held : -1;
    if (at >= 0) tt.held += (int)round4((int64_t)ranks[k] * dims[k] * ranks[k + 1]);
    if (table) continue;
    tt.core[k] = (const S*)cores[k];
    tt.grad[k] = grads ? (acc_t<S>*)grads[k] : nullptr;
    tt.rank[k] = ranks[k];
    tt.dim[k] = dims[k];
    tt.at[k] = at;
  }
  if (!table) tt.rank[N] = ranks[N];
  return tt;
}

// Whether W lanes a sample and `cols` interface columns a lane (0: the
// interface in shared memory, W = 32) carry ranks up to maxr; the forward
// keeps at most one column a lane.
bool plan_ok(int maxr, int W, int cols, int warps, bool backward) {
  if (W < 1 || W > 32 || (W & (W - 1)) || warps < 1 || warps > WARPS) return false;
  if (cols == 0) return W == 32;
  if (cols != 1 && (!backward || (cols != 2 && cols != 4))) return false;
  return (cols == 1 || W == 32) && (int64_t)W * cols >= maxr;
}

// The kernel instance of W lanes and `cols` columns a lane (plan_ok holds):
// W = 1..32 at one column -> 0..5, W = 32 at 2 and 4 columns -> 6, 7, and
// the interface in shared memory -> 8
int instance(int W, int cols) {
  return cols == 1 ? __builtin_ctz(W) : cols == 0 ? 8 : 5 + __builtin_ctz(cols);
}

// The blocks of `kernel` that the card holds at once, at `warps` warps and
// `smem` bytes a block: asked of the runtime once per kernel, shape and
// device and kept, since the queries cost more host time than a launch
struct Wave {
  const void* kernel;
  int warps, device;
  size_t smem;
  int64_t blocks;
};

template <typename K>
cudaError_t wave(K kernel, int warps, size_t smem, int64_t* blocks) {
  static std::mutex mutex;
  static std::vector<Wave> waves;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mutex);
  for (const Wave& w : waves) {
    if (w.kernel == (const void*)kernel && w.warps == warps && w.smem == smem &&
        w.device == device) {
      *blocks = w.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = (int64_t)sms * per_sm;
  waves.push_back({(const void*)kernel, warps, device, smem, *blocks});
  return cudaSuccess;
}

// Launch `kernel` on a persistent grid: `warps` warps a block, as many
// blocks as fit the card at once (fewer when the samples need fewer, and
// at most `max_blocks` when it is positive), each striding over the warps'
// groups of 32 / W samples.
template <typename K, typename... Args>
int launch(K kernel, int warps, size_t smem, int64_t units, int64_t max_blocks,
           cudaStream_t stream, Args... args) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int64_t cap = 0;
  if (e == cudaSuccess) e = wave(kernel, warps, smem, &cap);
  if (e != cudaSuccess) return (int)e;
  if (max_blocks > 0 && max_blocks < cap) cap = max_blocks;
  const int64_t need = (units + warps - 1) / warps;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  kernel<<<blocks, warps * 32, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename S>
int tt_eval_launch(int itype, int N, const void* const* cores, const int* ranks, const int* dims,
                   const void* table, const void* X, int64_t B, void* out, int* flag, int W,
                   int cols, int staged, int warps, cudaStream_t s) {
  if (staged && (cols != 1 || table)) return (int)cudaErrorInvalidValue;
  std::vector<int> held(N, staged ? 1 : 0);
  const TT<S> tt = make_tt<S>(N, cores, nullptr, ranks, dims, held.data(), table);
  if (!plan_ok(tt.maxr, W, cols, warps, false)) return (int)cudaErrorInvalidValue;
  const size_t smem = per_sample_smem(tt.held, sizeof(S), warps,
                                      warp_elems(false, W, cols, tt.maxr, tt.lsize, false),
                                      sizeof(acc_t<S>));
  using K = void (*)(TT<S>, const void*, int, int64_t, S*, int*);
  // [W][staged, or (cols 0 and 1 only) general]
#define TNT_FWD(W)                                                               \
  {                                                                              \
    tt_eval_kernel<S, W, 1, false, false>, tt_eval_kernel<S, W, 1, true, false>, \
        tt_eval_kernel<S, W, 1, false, true>                                     \
  }
  const K kernels[][3] = {TNT_FWD(1), TNT_FWD(2),  TNT_FWD(4),
                          TNT_FWD(8), TNT_FWD(16), TNT_FWD(32)};
#undef TNT_FWD
  const K kernel = cols == 0 ? (table ? tt_eval_kernel<S, 32, 0, false, true>
                                      : tt_eval_kernel<S, 32, 0, false, false>)
                             : kernels[instance(W, 1)][table ? 2 : staged != 0];
  return launch(kernel, warps, smem, (B + 32 / W - 1) / (32 / W), 0, s, tt, X, (int)(itype == 1),
                (int64_t)B, (S*)out, flag);
}

template <typename S>
int tt_eval_backward_launch(int itype, int N, const void* const* cores, void* const* grads,
                            const int* ranks, const int* dims, const void* table, const void* X,
                            const void* g, int64_t B, int* flag, int W, int cols,
                            const int* priv, int warps, void* spill, int64_t slots,
                            cudaStream_t s) {
  const TT<S> tt = make_tt<S>(N, cores, grads, ranks, dims, priv, table);
  const bool last_held = priv && priv[N - 1];
  if (!plan_ok(tt.maxr, W, cols, warps, true)) return (int)cudaErrorInvalidValue;
  if (spill && (slots < warps || !table)) return (int)cudaErrorInvalidValue;
  if (table && last_held) return (int)cudaErrorInvalidValue;
  const size_t smem =
      per_sample_smem(tt.held, sizeof(acc_t<S>), warps,
                      warp_elems(true, W, cols, tt.maxr, tt.lsize, spill != nullptr),
                      sizeof(acc_t<S>));
  using K = void (*)(TT<S>, const void*, int, const S*, int64_t, int*, acc_t<S>*);
  // [lane shape][the last core held, not held, general]
#define TNT_BWD(W, CPL)                                                                   \
  {                                                                                       \
    tt_eval_backward_kernel<S, W, CPL, false, false>,                                     \
        tt_eval_backward_kernel<S, W, CPL, true, false>,                                  \
        tt_eval_backward_kernel<S, W, CPL, true, true>                                    \
  }
  const K kernels[][3] = {TNT_BWD(1, 1),  TNT_BWD(2, 1),  TNT_BWD(4, 1),
                          TNT_BWD(8, 1),  TNT_BWD(16, 1), TNT_BWD(32, 1),
                          TNT_BWD(32, 2), TNT_BWD(32, 4), TNT_BWD(32, 0)};
#undef TNT_BWD
  return launch(kernels[instance(W, cols)][table ? 2 : !last_held], warps, smem,
                (B + 32 / W - 1) / (32 / W), spill ? slots / warps : 0, s, tt, X,
                (int)(itype == 1), (const S*)g, (int64_t)B, flag, (acc_t<S>*)spill);
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = float64,
// 2 = bfloat16, 3 = float16 (the per-sample entries; the grouped ones take
// 0 and 1); itype: 0 = int32, 1 = int64 coordinates. cores/grads are N
// device pointers to contiguous (ranks[k], dims[k], ranks[k+1]) cores (the
// gradients in float32 for the half types); `table`, null or the same modes
// in device memory as Mode rows (ops/tt_eval.py: _mode_table), takes the
// general instances, and is needed for N > MAX_MODES and with a spill (the
// general instances stage no cores and privatize no last core). X is (B,
// N) row-major; *flag (zeroed by
// the caller) is set when a coordinate is out of range. Each returns the
// cudaError_t of its launch (0 on success) and neither synchronises nor
// allocates. The per-sample entries take the plan of ops/tt_eval.py:
// _per_sample_plan: W lanes a sample, `cols` interface columns a lane (0:
// in shared memory; the forward keeps 1 or 0), `warps` a block; forward,
// `staged` cores; backward, per core, whether its gradient is privatized
// (priv, N ints), and `spill`, null or device scratch of `slots` warps'
// left interfaces (lefts_elems each, acc_t), which caps the grid.
extern "C" {

int tnt_tt_eval(int dtype, int itype, int N, const void* const* cores, const int* ranks,
                const int* dims, const void* table, const void* X, long long B, void* out,
                int* flag, int W, int cols, int staged, int warps, void* stream) {
  if (N < 1 || (N > MAX_MODES && !table)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return tt_eval_launch<float>(itype, N, cores, ranks, dims, table, X, B, out, flag, W, cols,
                                   staged, warps, s);
    case 1:
      return tt_eval_launch<double>(itype, N, cores, ranks, dims, table, X, B, out, flag, W, cols,
                                    staged, warps, s);
    case 2:
      return tt_eval_launch<__nv_bfloat16>(itype, N, cores, ranks, dims, table, X, B, out, flag,
                                           W, cols, staged, warps, s);
    case 3:
      return tt_eval_launch<__half>(itype, N, cores, ranks, dims, table, X, B, out, flag, W,
                                    cols, staged, warps, s);
  }
  return (int)cudaErrorInvalidValue;
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
  if ((dtype != 0 && dtype != 1) || Rl < 1 || I < 1 || Rr < 1 ||
      (!dst && (!last || !last_idx || !out)))
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
  if ((dtype != 0 && dtype != 1) || I < 1 || rows < 1 || cols < 1 || P < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
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
                         const void* table, const void* X, const void* g, long long B, int* flag,
                         int W, int cols, const int* priv, int warps, void* spill,
                         long long slots, void* stream) {
  if (N < 1 || (N > MAX_MODES && !table)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return tt_eval_backward_launch<float>(itype, N, cores, grads, ranks, dims, table, X, g, B,
                                            flag, W, cols, priv, warps, spill, slots, s);
    case 1:
      return tt_eval_backward_launch<double>(itype, N, cores, grads, ranks, dims, table, X, g, B,
                                             flag, W, cols, priv, warps, spill, slots, s);
    case 2:
      return tt_eval_backward_launch<__nv_bfloat16>(itype, N, cores, grads, ranks, dims, table, X,
                                                    g, B, flag, W, cols, priv, warps, spill,
                                                    slots, s);
    case 3:
      return tt_eval_backward_launch<__half>(itype, N, cores, grads, ranks, dims, table, X, g, B,
                                             flag, W, cols, priv, warps, spill, slots, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
