// Flash attention backward (GQA, causal or full, optionally a sliding
// window) on Hopper: dQ, dK and dV from q, k, v, the forward's output o,
// its row log-sum-exp lse and the output's gradient dO.
//
// Replaces no Pallas kernel one for one: the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: _flash_kernel
// is forward-only, and the JAX package trains by autodiff through the jnp
// attention (src/repro/models/layers.py: _sdpa).  On the card the forward
// of attention is the port's flash kernel (csrc/flash_attention.cu), so its
// gradient is this file.  It computes what autograd through the plain
// version (kernels/flash_attention/ref.py: attention) computes, by the
// FlashAttention-2 recompute scheme:
//   P     = exp(S * scale - lse)        (S = Q K^T; masked entries exactly 0)
//   delta = rowsum(dO o O)              (fp32)
//   dV    = P^T dO
//   dS    = P o (dP - delta),           dP = dO V^T
//   dQ    = dS K * scale,   dK = dS^T Q * scale
// with the forward's masks: causal (q_pos >= k_pos), optionally within
// `window` (q_pos - k_pos < window), or none.
//
// What bounds it on the H100: five products of 2 B H pairs D flop (pairs =
// S(S+1)/2 under causality), about 172 GFLOP at olmo-1b's
// (4, 16, 16, 2048, 128): 0.174 ms at the 989 TFLOP/s bf16 tensor-core
// peak, over the 0.080 ms its ~268 MB of bytes take.  No atomics are
// allowed (the ROADMAP's determinism rule: the train phase replays steps
// bit for bit), so dQ cannot be summed over key tiles by atomic adds as in
// FlashAttention-3; two passes own disjoint outputs instead and each
// recomputes S and dP, seven products for five: 0.243 ms at peak.  The
// first version ran every product on the fp32 FMA pipes (67 TFLOP/s) from
// fp32-staged shared memory: 13.8 ms of device time at that shape, 29x
// SDPA's backward (PERF.md, NVIDIA H100 80GB HBM3 at 700 W).
//
// bf16 runs on the tensor cores (the wgmma/TMA machinery of the forward,
// csrc/hopper.cuh), in three kernels on the caller's stream (four at
// D = 256, below):
//   1. flash_bwd_delta: delta per query row, one warp a row (bytes-bound,
//      ~34 MB at the training shape);
//   2. flash_bwd_dq_tc: a block owns 64 query rows of one (batch, head),
//      one consumer warpgroup, and loops over the key tiles the mask admits
//      (64 keys each):
//        S = Q K^T, dP = dO V^T   wgmma SS, both operands K-major;
//        dQ += dS K               wgmma RS, dS from registers, K MN-major;
//   3. flash_bwd_dkdv_tc: a block owns 64 keys of one (batch, KV head), one
//      consumer warpgroup, and loops over the H / KV query heads of its
//      group and the query tiles the mask admits (64 queries each):
//        S^T = K Q^T, dP^T = V dO^T   wgmma SS, both operands K-major;
//        dV += P^T dO, dK += dS^T Q   wgmma RS, P^T and dS^T from
//                                     registers, dO and Q MN-major;
//      lse (in log2 units) and delta of the streamed tile sit beside it in
//      shared memory, since they index the accumulator's columns.
// In both, the fp32 accumulator of S^T (or dP) cast pairwise to bf16 is
// the A fragment of the next product (the forward's pack_p identity), so P
// and dS never touch shared memory.  A block is one consumer warpgroup and
// one producer warp (160 threads), which brings the block's fixed tiles and
// a ring of 2-4 stages of streamed tiles in by TMA over 4-d tensor maps on
// the callers' strides (16-byte aligned: the wrapper checks), completed on
// mbarriers.  Registers set the rest: ptxas allots a block's registers as
// if its threads were rounded up to whole warpgroups, so this block has 255
// a thread and one of two consumers 168.  The dK/dV consumer holds dK and
// dV (two D-wide fp32 accumulators), S^T, dP^T and both fragments (224 at
// D = 128): one block an SM; it issues S^T(j) and dP^T(j) with the RS
// products of tile j-1, waits, and computes P and dS of tile j.  The dQ
// consumer issues S(j) with dQ += dS(j-1) K, computes P(j), and only then
// issues dP(j), so that it never holds S, dP and dS's fragments at once
// (~150 registers: two blocks an SM, the ring cut to fit).  ptxas reports
// no spills (chip_smoke.py checks).  exp is ex2 on log2(e)-scaled scores.
// The masks are applied only on tiles that cross the diagonal, the
// window's edge or a ragged end; tiles outside the band are never visited,
// and the longest blocks start first.
// P and dS enter their products in bf16, a rounding the fp32 plain version
// does not make (|P| <= 1: at most 2^-9 absolute; dS to 2^-9 relative); S,
// dP, the accumulators and delta stay fp32, and each gradient is rounded to
// bf16 once (ref.attention_backward_rounded is this arithmetic on the CPU).
// One visiting order and no atomics: the gradients are bit-identical from
// run to run.
//
// fp32 runs on the tensor cores too, every product a split TF32 product
// (tf32.cuh: each operand split into TF32 hi + lo, three TF32 products
// into fp32 accumulators, lo*lo dropped), which keeps the 2e-4 fp32 limit
// where one TF32 pass would break it; P and dS stay fp32 up to their split,
// and S, dP, delta and every accumulator are fp32
// (ref.attention_backward_split_tf32 is this arithmetic on the CPU).  The
// products are mma.sync m16n8k8 from fragments loaded by hand out of
// cp.async-filled fp32 tiles: wgmma takes 32-bit operands from shared
// memory only K-major, with no transpose bit, and four of the five
// products (dV += P^T dO, dK += dS^T Q, dQ += dS K and the forward's P V)
// take a B whose contiguous dim is D, not K.  Two kernels after the delta
// pass (flash_bwd_dq_split, flash_bwd_dkdv_split; their tiles below): a dQ
// pass whose two warps of a row group split each key tile, and a dK/dV
// pass whose 8 warps are 4 dV warps and 4 dK warps over the same 64 keys
// (P^T handed from one to the other through shared memory), so that no
// warp holds two D-wide accumulators at any D (D = 256 needs no separate
// passes).  Bound, as the forward's: operations at a third of the TF32
// rate, held to 0.13-0.2 of it by instruction issue (a load and a split
// per element a warp loads).  The same visiting order every run and no
// atomics: bit-identical from run to run.
//
// D = 256 (recurrentgemma's local attention: 10 query heads of 256 on one
// KV head, window 2048) runs on the tensor cores too, with the same tiles,
// roundings and rules.  One warpgroup's registers cannot hold dK and dV of
// 256 columns (2 x 128 a thread), and two consumers (or a second consumer
// beside the producer warp) would leave each at most 168 registers, so the
// dK/dV pass splits in two, each with one 128-register accumulator:
//   3a. flash_bwd_dkdv_tc<256, kDV>: S^T, P^T, dV += P^T dO (no V loaded);
//   3b. flash_bwd_dkdv_tc<256, kDK>: S^T, dP^T, dS^T, dK += dS^T Q.
// S^T is then computed three times and dP twice, eight products for five
// (0.52 ms at the bf16 peak at (2, 10, 1, 4096, 256) window 2048, against
// 0.46 for one dK/dV pass).  ptxas gives 3a 202 registers and 3b 234 (dK,
// S^T, dP^T and dS^T's fragments), no spill; one 160-thread block an SM.
// Shared memory fits: K and V (64 KB) and 2 stages of Q and dO (128 KB).
// The dQ pass at D = 256 also runs one block an SM (Q and dO 64 KB, 2 K/V
// stages of 64 KB), its consumer holding dQ (128), S, dP and dS's
// fragments: 218 registers, no spill.  With one KV head the dK/dV grids
// are B x Sk / 64 blocks (128 at the training shape), each walking 10
// heads x ~33 query tiles; each streams 64 KB of Q and dO a tile, mostly
// from L2 (PERF.md gives each pass's time).

#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using hopper::Strides;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// delta = rowsum(dO o O) in fp32, one warp a row; lanes take every 32nd
// column and a butterfly adds them in a fixed order
template <typename T>
__global__ void flash_bwd_delta(const T* __restrict__ o,
                                const T* __restrict__ dout,
                                float* __restrict__ delta, int rows, int H,
                                int Sq, int D, Strides ost, Strides dost) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int bh = row / Sq, qi = row % Sq;
  const int b = bh / H, h = bh % H;
  const T* orow = o + b * ost.b + h * ost.h + qi * ost.s;
  const T* drow = dout + b * dost.b + h * dost.h + qi * dost.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(ld(orow + d), ld(drow + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int H,
                 int Sq, int D, Strides ost, Strides dost,
                 cudaStream_t stream) {
  const int rows = B * H * Sq;
  flash_bwd_delta<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, rows, H, Sq, D, ost, dost);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the split-TF32 kernels (mma.sync on the tensor cores; tf32.cuh)
// ---------------------------------------------------------------------------

namespace fp32 {

using namespace tf32;
using hopper::ex2;

constexpr float kLog2e = 1.4426950408889634f;

// The dQ pass: 64 query rows a block (Q and dO staged once) and 8 warps,
// two a group of 16 rows, each of the two on half of every K/V tile's keys
// with its own 16 x D dQ accumulator, summed at the end; K/V tiles of Bk
// keys (64; 16 at D = 256, where Q and dO take 130 KB) in a ring of 2
// filled by cp.async.
template <int D>
struct QTile {
  static constexpr int kBq = 64;
  static constexpr int kBk = D <= 128 ? 64 : 16;
  static constexpr int kKw = kBk / 2;  // keys a warp a tile
  static constexpr int kRg = kBq / 16;  // row groups
  static constexpr int kThreads = 64 * kRg;
  static constexpr int kLd = D + 4;
  static constexpr int kQ = kBq * kLd;
  static constexpr int kKV = kBk * kLd;
  // Q | dO | K[2] | V[2]; after the loop K/V hold the second halves' dQ
  static constexpr int kSmem = 4 * (2 * kQ + 4 * kKV);
  static_assert(kSmem <= 232448, "tiles do not fit shared memory");
  static_assert(4 * kKV >= kBq * D, "no room for the dQ sum");
};

// The dK/dV pass: 64 keys a block (K and V staged once) in 4 groups of 16
// and 8 warps: warp w < 4 computes S^T and P^T of key group w and
// accumulates dV, warp w + 4 computes dP^T of the same keys, takes P^T
// from warp w through shared memory (a named barrier of the pair) and
// accumulates dK: four products, two a warp, and one D-wide accumulator a
// warp at every D (two would take 2 x D / 2 registers a thread).
// Streamed tiles of Bq queries (64; 16 at D = 256, where K and V take
// 130 KB) of Q and dO, with their rows' lse (log2 units) and delta, in a
// ring of 2.
template <int D>
struct KVTile {
  static constexpr int kBk = 64;
  static constexpr int kBq = D <= 128 ? 64 : 16;
  static constexpr int kThreads = 256;
  static constexpr int kLd = D + 4;
  static constexpr int kKV = kBk * kLd;
  static constexpr int kQ = kBq * kLd;
  static constexpr int kP = kBq / 2 * 32;  // one warp's P^T fragments
  // K | V | Q[2] | dO[2] | rows[2][2][kBq] | P^T[4]
  static constexpr int kSmem = 4 * (2 * kKV + 4 * kQ + 4 * kBq + 4 * kP);
  static_assert(kSmem <= 232448, "tiles do not fit shared memory");
};

template <int D>
__global__ void __launch_bounds__(QTile<D>::kThreads, 1)
flash_bwd_dq_split(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int H, int group, int Sq, int Sk, int causal, int window,
                   float scale, float scale_log2, Strides qst, Strides kst,
                   Strides vst, Strides dost, Strides dqst) {
  using T = QTile<D>;
  constexpr int Bq = T::kBq, Bk = T::kBk, Kw = T::kKw, L = T::kLd;
  constexpr int NB = Kw / 8, NT = T::kThreads;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + T::kQ;
  float* Ks = Os + T::kQ;
  float* Vs = Ks + 2 * T::kKV;

  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp % T::kRg, kh = warp / T::kRg;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  // the last query tiles see the most keys under causal: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Bq;
  const float* kb = k + b * kst.b + hk * kst.h;
  const float* vb = v + b * vst.b + hk * vst.h;

  int n_tiles = (Sk + Bk - 1) / Bk;
  if (causal) n_tiles = min(n_tiles, (min(q0 + Bq, Sq) - 1) / Bk + 1);
  // the first key any row of this block may see is q0 - window + 1
  const int t_first = window > 0 ? max(q0 - window + 1, 0) / Bk : 0;
  const int n_iter = max(n_tiles - t_first, 0);

  auto load_kv = [&](int j) {
    const int st = j & 1, k0 = (t_first + j) * Bk;
    load_rows<D, Bk, NT>(Ks + st * T::kKV, kb, kst.s, k0, Sk);
    load_rows<D, Bk, NT>(Vs + st * T::kKV, vb, vst.s, k0, Sk);
  };
  load_rows<D, Bq, NT>(Qs, q + b * qst.b + h * qst.h, qst.s, q0, Sq);
  load_rows<D, Bq, NT>(Os, dout + b * dost.b + h * dost.h, dost.s, q0, Sq);
  if (n_iter > 0) load_kv(0);
  cp_async_commit();

  const int qw0 = q0 + rg * 16;
  const int row0 = qw0 + g, row1 = row0 + 8;
  const int64_t rbase = ((int64_t)b * H + h) * Sq;
  const float l2_0 = row0 < Sq ? lse[rbase + row0] * kLog2e : 0.f;
  const float l2_1 = row1 < Sq ? lse[rbase + row1] * kLog2e : 0.f;
  const float dl_0 = row0 < Sq ? delta[rbase + row0] : 0.f;
  const float dl_1 = row1 < Sq ? delta[rbase + row1] : 0.f;
  const float* Qw = Qs + rg * 16 * L;
  const float* Ow = Os + rg * 16 * L;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_iter; ++j) {
    if (j + 1 < n_iter) {
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // this warp's keys of the tile
    const float* Kt = Ks + (j & 1) * T::kKV + kh * Kw * L;
    const float* Vt = Vs + (j & 1) * T::kKV + kh * Kw * L;
    const int k0 = (t_first + j) * Bk + kh * Kw;

    // S = Q K^T and dP = dO V^T
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = dp[n][r] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA aq, ao;
      load_a(aq, Qw + kk * 8, L, g, t);
      load_a(ao, Ow + kk * 8, L, g, t);
      mma_step<NB>(s, aq, Kt + kk * 8, L, g, t);
      mma_step<NB>(dp, ao, Vt + kk * 8, L, g, t);
    }
    // P = exp(S * scale - lse), masked entries exactly 0, and dS = P (dP -
    // delta) in place of dP; masks only where the warp's rows and keys
    // cross the diagonal, the window's edge or a ragged end
    const bool masked = qw0 + 16 > Sq || k0 + Kw > Sk ||
                        (causal && k0 + Kw - 1 > qw0) ||
                        (window > 0 && qw0 + 15 - k0 >= window);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r < 2 ? row0 : row1;
        const int key = k0 + 8 * n + 2 * t + (r & 1);
        float p = ex2(fmaf(s[n][r], scale_log2, -(r < 2 ? l2_0 : l2_1)));
        if (masked && !(row < Sq && key < Sk && (!causal || row >= key) &&
                        (window <= 0 || row - key < window)))
          p = 0.f;
        dp[n][r] = p * (dp[n][r] - (r < 2 ? dl_0 : dl_1));
      }
    // dQ += dS K
    FragA da[NB];
    acc_as_a<NB>(da, dp);
    mma_acc<NB, D / 8>(acc, da, Kt, L, g, t);
    __syncthreads();  // every warp is done with this stage
  }

  // the second key half's dQ of each row group through the K/V tiles'
  // memory (free after the loop's last barrier), added in fp32
  float* Xs = Ks;  // [64 rows][D]
  const int r0 = rg * 16 + g, r1 = r0 + 8;
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(Xs + r0 * D + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(Xs + r1 * D + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  if (kh == 1) return;
  float* dqb = dq + b * dqst.b + h * dqst.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(Xs + r0 * D + col);
    const float2 x1 = *reinterpret_cast<const float2*>(Xs + r1 * D + col);
    if (row0 < Sq)
      *reinterpret_cast<float2*>(dqb + row0 * dqst.s + col) =
          make_float2((acc[n][0] + x0.x) * scale, (acc[n][1] + x0.y) * scale);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(dqb + row1 * dqst.s + col) =
          make_float2((acc[n][2] + x1.x) * scale, (acc[n][3] + x1.y) * scale);
  }
}

// the pair's barrier: warp w < 4 arrives once its P^T is in shared memory,
// warp w + 4 waits for it (64 threads; barrier 0 is __syncthreads)
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_split(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int group, int Sq, int Sk,
                     int causal, int window, float scale, float scale_log2,
                     Strides qst, Strides kst, Strides vst, Strides dost,
                     Strides dkst, Strides dvst) {
  using T = KVTile<D>;
  constexpr int Bq = T::kBq, Bk = T::kBk, L = T::kLd;
  constexpr int NB = Bq / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T::kKV;
  float* Qs = Vs + T::kKV;      // [2][Bq][L]
  float* Os = Qs + 2 * T::kQ;   // [2][Bq][L]
  float* Rs = Os + 2 * T::kQ;   // [2][lse2, delta][Bq]
  float* Ps = Rs + 4 * Bq;      // [4 key groups][NB][4][32 lanes]

  const int tid = threadIdx.x, lane = tid % 32;
  // warp-uniform: the role and key group of this warp
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const bool dk_warp = warp >= 4;
  const int kg = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int KV = H / group;
  const int b = blockIdx.x / KV, hk = blockIdx.x % KV;
  const int k0 = blockIdx.y * Bk;  // key tile 0 sees the most queries: first

  // the query tiles that see a key of this block, for each head of the group
  const int nq = (Sq + Bq - 1) / Bq;
  const int i_first = causal ? k0 / Bq : 0;
  int i_end = nq;
  if (window > 0)
    i_end = min(nq, (min(k0 + Bk, Sk) - 1 + window - 1) / Bq + 1);
  const int n_q = max(i_end - i_first, 0);
  const int n_iter = group * n_q;

  auto load_q = [&](int j) {
    const int st = j & 1;
    const int h = hk * group + j / n_q;
    const int qt0 = (i_first + j % n_q) * Bq;
    load_rows<D, Bq, 256>(Qs + st * T::kQ, q + b * qst.b + h * qst.h, qst.s,
                          qt0, Sq);
    load_rows<D, Bq, 256>(Os + st * T::kQ, dout + b * dost.b + h * dost.h,
                          dost.s, qt0, Sq);
    // read by every warp only after the barrier that follows the wait
    const int64_t row = ((int64_t)b * H + h) * Sq + qt0;
    float* rs = Rs + st * 2 * Bq;
    for (int r = tid; r < Bq; r += 256) {
      const bool ok = qt0 + r < Sq;
      rs[r] = ok ? lse[row + r] * kLog2e : 0.f;
      rs[Bq + r] = ok ? delta[row + r] : 0.f;
    }
  };
  load_rows<D, Bk, 256>(Ks, k + b * kst.b + hk * kst.h, kst.s, k0, Sk);
  load_rows<D, Bk, 256>(Vs, v + b * vst.b + hk * vst.h, vst.s, k0, Sk);
  if (n_iter > 0) load_q(0);
  cp_async_commit();

  const int kw0 = k0 + kg * 16;
  const int key0 = kw0 + g, key1 = key0 + 8;
  // dV warps read K's rows, dK warps V's
  const float* Xw = (dk_warp ? Vs : Ks) + kg * 16 * L;
  float* Pw = Ps + kg * NB * 4 * 32 + lane;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_iter; ++j) {
    if (j + 1 < n_iter) {
      load_q(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = j & 1;
    const int qt0 = (i_first + j % n_q) * Bq;
    const float* Qt = Qs + st * T::kQ;
    const float* Ot = Os + st * T::kQ;
    const float* rs = Rs + st * 2 * Bq;

    // S^T = K Q^T (dV warp) or dP^T = V dO^T (dK warp): rows keys,
    // columns queries
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const float* Yt = dk_warp ? Ot : Qt;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA a;
      load_a(a, Xw + kk * 8, L, g, t);
      mma_step<NB>(s, a, Yt + kk * 8, L, g, t);
    }
    if (!dk_warp) {
      // P^T = exp(S^T * scale - lse), masked entries exactly 0 (not
      // exp(-lse), which may overflow); masks only where the tile crosses
      // the diagonal, the window's edge, Sq or Sk
      const bool masked = qt0 + Bq > Sq || kw0 + 16 > Sk ||
                          (causal && qt0 < kw0 + 15) ||
                          (window > 0 && qt0 + Bq - 1 - kw0 >= window);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = 8 * n + 2 * t + (r & 1);
          const int qi = qt0 + col, kj = r < 2 ? key0 : key1;
          float p = ex2(fmaf(s[n][r], scale_log2, -rs[col]));
          if (masked && !(qi < Sq && kj < Sk && (!causal || qi >= kj) &&
                          (window <= 0 || qi - kj < window)))
            p = 0.f;
          s[n][r] = p;
          Pw[(n * 4 + r) * 32] = p;
        }
      __threadfence_block();
      pair_arrive(1 + kg);
    } else {
      // dS^T = P^T (dP^T - delta), P^T from the pair's dV warp
      pair_sync(1 + kg);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s[n][r] = Pw[(n * 4 + r) * 32] *
                    (s[n][r] - rs[Bq + 8 * n + 2 * t + (r & 1)]);
    }
    // dV += P^T dO, or dK += dS^T Q
    FragA a[NB];
    acc_as_a<NB>(a, s);
    mma_acc<NB, D / 8>(acc, a, dk_warp ? Qt : Ot, L, g, t);
    __syncthreads();  // every warp is done with this stage and its P^T
  }

  float* out = dk_warp ? dk + b * dkst.b + hk * dkst.h
                       : dv + b * dvst.b + hk * dvst.h;
  const int64_t os = dk_warp ? dkst.s : dvst.s;
  const float f = dk_warp ? scale : 1.f;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (key0 < Sk)
      *reinterpret_cast<float2*>(out + key0 * os + col) =
          make_float2(acc[n][0] * f, acc[n][1] * f);
    if (key1 < Sk)
      *reinterpret_cast<float2*>(out + key1 * os + col) =
          make_float2(acc[n][2] * f, acc[n][3] * f);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
           int causal, int window, float scale, const Strides* st,
           cudaStream_t stream) {
  using QT = QTile<D>;
  using KT = KVTile<D>;
  const Strides &qst = st[0], &kst = st[1], &vst = st[2], &ost = st[3],
                &dost = st[4], &dqst = st[5], &dkst = st[6], &dvst = st[7];
  int err =
      launch_delta<float>(o, dout, delta, B, H, Sq, D, ost, dost, stream);
  if (err) return err;
  const float scale_log2 = scale * kLog2e;

  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QT::kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_split<D><<<dim3(B * H, (Sq + QT::kBq - 1) / QT::kBq),
                          QT::kThreads, QT::kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, H, H / KV, Sq, Sk, causal, window, scale,
      scale_log2, qst, kst, vst, dost, dqst);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(flash_bwd_dkdv_split<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           KT::kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_split<D><<<dim3(B * KV, (Sk + KT::kBk - 1) / KT::kBk),
                            KT::kThreads, KT::kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, H, H / KV, Sq, Sk, causal, window,
      scale, scale_log2, qst, kst, vst, dost, dkst, dvst);
  return (int)cudaGetLastError();
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (wgmma, TMA, mbarriers; sm_90a only)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kSmemMax = 232448;  // a block's dynamic shared memory
constexpr float kLog2e = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Both passes: threads 0-127 are the consumer warpgroup, 128-159 the
// producer warp.  A consumer thread holds the two rows warp*16 + lane/4
// (+ 8) of the tile's 64 and, of each 8-wide column chunk of an
// accumulator, columns 2*(lane%4) and 2*(lane%4) + 1.

// The dK/dV pass: 64 keys a block (K and V loaded once) and one consumer
// warpgroup, a ring of stages of one 64-query Q tile, one dO tile, and the
// tile's lse (log2 units) and delta.
template <int D>
struct KVTile {
  static constexpr int kBk = 64;
  static constexpr int kBq = 64;
  static constexpr int kThreads = 160;
  static constexpr int kKVBytes = kBk * D * 2;  // one K or V tile
  static constexpr int kQBytes = kBq * D * 2;   // one Q or dO tile
  static constexpr int kRowBytes = 2 * kBq * 4; // lse and delta of a tile
  static constexpr int kStages = cmin(
      4, (kSmemMax - 2 * kKVBytes - 2048) / (2 * kQBytes + kRowBytes));
  // K | V | Q[kStages] | dO[kStages] | rows[kStages] | mbarriers; every
  // tile 1024-byte aligned (the SWIZZLE_128B atom), the base aligned up at
  // run time
  static constexpr int kVOff = kKVBytes;
  static constexpr int kQOff = 2 * kKVBytes;
  static constexpr int kOOff = kQOff + kStages * kQBytes;
  static constexpr int kRowOff = kOOff + kStages * kQBytes;
  static constexpr int kBarOff = kRowOff + kStages * kRowBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "Q/dO ring does not fit");
};

// The dQ pass: 64 query rows a block (Q and dO loaded once) and one
// consumer warpgroup, a ring of stages of one 64-key K tile and one V tile,
// as many as let two blocks share an SM (up to 4); at D = 256, where Q and
// dO take 64 KB and a K/V stage 64 KB, one block an SM with 2 stages.
template <int D>
struct QTile {
  static constexpr int kBq = 64;
  static constexpr int kBk = 64;
  static constexpr int kThreads = 160;
  static constexpr int kBlocksPerSm = D <= 128 ? 2 : 1;
  static constexpr int kQBytes = kBq * D * 2;   // the Q or the dO tile
  static constexpr int kKVBytes = kBk * D * 2;  // one K or V tile
  static constexpr int kStages = cmin(
      4, (kSmemMax / kBlocksPerSm - 2 * kQBytes - 2048) / (2 * kKVBytes));
  static constexpr int kOOff = kQBytes;
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "K/V ring does not fit");
};

// P = exp(S * scale - lse) of one 64 x 64 tile for this thread's two rows,
// in place.  Rows are the accumulator's M (keys in the dK/dV pass, queries
// in the dQ pass); lse2(i) gives fragment i's lse (log2 units).  Masked
// gives masked entries probability exactly 0 (and so dS 0).
template <bool Masked, typename Lse, typename Valid>
__device__ __forceinline__ void probs(float (&s)[32], float scale_log2,
                                      Lse lse2, Valid valid) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, -lse2(i)));
    s[i] = Masked && !valid(i) ? 0.f : p;
  }
}

// dS = P (dP - delta) in place of dP; delta(i) gives fragment i's delta
template <typename Delta>
__device__ __forceinline__ void dscores(const float (&p)[32], float (&dp)[32],
                                        Delta dl) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = p[i] * (dp[i] - dl(i));
}

// the row and column (within the 64 x 64 tile) of accumulator fragment i
__device__ __forceinline__ int frag_col(int i) { return 8 * (i / 4) + (i % 2); }
__device__ __forceinline__ bool frag_row1(int i) { return (i % 4) >= 2; }

// What one dK/dV block computes: both gradients (D <= 128), or, at D = 256,
// where one warpgroup's registers cannot hold dK and dV of 256 columns, dV
// alone (S^T, P^T, dV += P^T dO) or dK alone (S^T, dP^T, dS^T, dK += dS^T Q)
constexpr int kBoth = 0, kDV = 1, kDK = 2;

template <int D, int Part>
__global__ void __launch_bounds__(KVTile<D>::kThreads, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap dmap,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int H, int group, int Sq,
                  int Sk, int causal, int window, float scale,
                  float scale_log2, Strides dkst, Strides dvst) {
  using T = KVTile<D>;
  constexpr int Bk = T::kBk, Bq = T::kBq, S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // lse (log2 units) and delta of each stage's tile: [S][2][Bq] fp32
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + T::kRowOff);
  const uint32_t sK = base, sV = base + T::kVOff, sQ = base + T::kQOff,
                 sO = base + T::kOOff;
  // mbarriers: K/V, then S each of full and empty
  const uint32_t bar_kv = base + T::kBarOff;
  const uint32_t bar_f = bar_kv + 8;
  const uint32_t bar_e = bar_f + 8 * S;

  const int tid = threadIdx.x;
  // warp-uniform, so that the compiler sees each role's wgmma as converged
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int KV = H / group;
  const int b = blockIdx.x / KV, hk = blockIdx.x % KV;
  const int k0 = blockIdx.y * Bk;  // key tile 0 sees the most queries: first

  // the query tiles that see a key of this block, for each head of the group
  const int nq = (Sq + Bq - 1) / Bq;
  const int i_first = causal ? k0 / Bq : 0;
  int i_end = nq;
  if (window > 0)
    i_end = min(nq, (min(k0 + Bk, Sk) - 1 + window - 1) / Bq + 1);
  const int n_q = max(i_end - i_first, 0);
  const int n_iter = group * n_q;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(bar_f + 8 * st, 32);         // every producer lane
      mbar_init(bar_e + 8 * st, 128);        // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {
    // the producer warp: lane 0 issues the copies; every lane writes two
    // rows' lse and delta into the stage before it arrives
    const int lane = tid % 32;
    if (n_iter > 0) {
      if (lane == 0) {
        // the dV pass reads no V
        mbar_expect_tx(bar_kv, (Part == kDV ? 1 : 2) * T::kKVBytes);
        copy_tile<D, Bk>(sK, &kmap, bar_kv, k0, hk, b);
        if (Part != kDV) copy_tile<D, Bk>(sV, &vmap, bar_kv, k0, hk, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(bar_e + 8 * st, (it / S - 1) & 1);
        const int h = hk * group + it / n_q;
        const int q0 = (i_first + it % n_q) * Bq;
        const int64_t row = ((int64_t)b * H + h) * Sq + q0;
        float* rs = rows + st * 2 * Bq;
        for (int r = lane; r < Bq; r += 32) {
          const bool ok = q0 + r < Sq;
          rs[r] = ok ? lse[row + r] * kLog2e : 0.f;
          rs[Bq + r] = ok ? delta[row + r] : 0.f;
        }
        const uint32_t bar = bar_f + 8 * st;
        if (lane == 0) {
          mbar_expect_tx(bar, 2 * T::kQBytes);
          copy_tile<D, Bq>(sQ + st * T::kQBytes, &qmap, bar, q0, h, b);
          copy_tile<D, Bq>(sO + st * T::kQBytes, &dmap, bar, q0, h, b);
        } else {
          mbar_arrive(bar);
        }
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int key0 = k0 + warp * 16 + lane / 4;
  const int key1 = key0 + 8;
  const int c0 = 2 * (lane % 4);

  constexpr bool kWithDV = Part != kDK, kWithDK = Part != kDV;
  float dka[D / 2], dva[D / 2], s[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = da[kk][r] = 0u;
  // a register fence keeps its array live, so a part fences only its own
  auto fence_all = [&] {
    fence_regs(s);
    if constexpr (kWithDK) fence_regs(dp);
    if constexpr (kWithDK) fence_regs(dka);
    if constexpr (kWithDV) fence_regs(dva);
    if constexpr (kWithDV) fence_regs(pa);
    if constexpr (kWithDK) fence_regs(da);
  };

  auto qaddr = [&](int j) { return sQ + (j % S) * T::kQBytes; };
  auto oaddr = [&](int j) { return sO + (j % S) * T::kQBytes; };
  // S^T(j) = K Q_j^T and dP^T(j) = V dO_j^T, one wgmma group; K's and
  // V's addresses are made opaque here, so that their 2 D / 16 descriptors
  // are rebuilt at each issue and not held in registers across the loop
  auto issue_ss = [&](int j) {
    mbar_wait(bar_f + 8 * (j % S), (j / S) & 1);
    uint32_t k_at = sK, v_at = sV;
    asm volatile("" : "+r"(k_at), "+r"(v_at));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(s, desc_kmajor<Bk>(k_at, kk),
                   desc_kmajor<Bq>(qaddr(j), kk), kk > 0);
    if constexpr (kWithDK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(dp, desc_kmajor<Bk>(v_at, kk),
                     desc_kmajor<Bq>(oaddr(j), kk), kk > 0);
    }
    wg_commit();
  };
  // dV += P^T(j) dO_j and dK += dS^T(j) Q_j, one wgmma group
  auto issue_rs = [&](int j) {
    if constexpr (kWithDV) {
#pragma unroll
      for (int kk = 0; kk < Bq / 16; ++kk)
        wgmma_rs<D>(dva, pa[kk], desc_mnmajor<Bq>(oaddr(j), kk));
    }
    if constexpr (kWithDK) {
#pragma unroll
      for (int kk = 0; kk < Bq / 16; ++kk)
        wgmma_rs<D>(dka, da[kk], desc_mnmajor<Bq>(qaddr(j), kk));
    }
    wg_commit();
  };
  // P^T and dS^T of tile j in place; masks only where the tile crosses the
  // diagonal, the window's edge, Sq or Sk (the keys past Sk of a ragged
  // last tile arrive as zeros and are never stored, but masked they give
  // P = 0 exactly, not exp(-lse), which may overflow)
  auto p_ds_tile = [&](int j) {
    const int q0 = (i_first + j % n_q) * Bq;
    const float* rs = rows + (j % S) * 2 * Bq + c0;
    auto lse2 = [&](int i) { return rs[frag_col(i)]; };
    auto dl = [&](int i) { return rs[Bq + frag_col(i)]; };
    auto valid = [&](int i) {
      const int qi = q0 + c0 + frag_col(i);
      const int kj = frag_row1(i) ? key1 : key0;
      return qi < Sq && kj < Sk && (!causal || qi >= kj) &&
             (window <= 0 || qi - kj < window);
    };
    if (q0 + Bq > Sq || k0 + Bk > Sk || (causal && q0 < k0 + Bk - 1) ||
        (window > 0 && q0 + Bq - 1 - k0 >= window))
      probs<true>(s, scale_log2, lse2, valid);
    else
      probs<false>(s, scale_log2, lse2, valid);
    if constexpr (kWithDK) dscores(s, dp, dl);
  };

  // tile j: S^T(j) and dP^T(j) with dV, dK += tile j-1's products (j > 0)
  // on the tensor cores, then P^T(j) and dS^T(j) as the next A fragments
  auto tile = [&](int j) {
    wg_fence();
    issue_ss(j);
    if (j > 0) issue_rs(j - 1);
    wg_wait<0>();
    fence_all();
    if (j > 0) mbar_arrive(bar_e + 8 * ((j - 1) % S));  // tile j-1 is done
    p_ds_tile(j);
    if constexpr (kWithDV) pack_p<64>(s, pa);
    if constexpr (kWithDK) pack_p<64>(dp, da);
  };

  if (n_iter > 0) {
    mbar_wait(bar_kv, 0);
    for (int j = 0; j < n_iter; ++j) tile(j);
    wg_fence();
    issue_rs(n_iter - 1);
    wg_wait<0>();
    if constexpr (kWithDK) fence_regs(dka);
    if constexpr (kWithDV) fence_regs(dva);
    mbar_arrive(bar_e + 8 * ((n_iter - 1) % S));
  }

  __nv_bfloat16* dkb = dk + b * dkst.b + hk * dkst.h;
  __nv_bfloat16* dvb = dv + b * dvst.b + hk * dvst.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + c0;
    if (key0 < Sk) {
      if constexpr (kWithDK)
        *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * dkst.s + col) =
            __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      if constexpr (kWithDV)
        *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * dvst.s + col) =
            __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
    }
    if (key1 < Sk) {
      if constexpr (kWithDK)
        *reinterpret_cast<__nv_bfloat162*>(dkb + key1 * dkst.s + col) =
            __floats2bfloat162_rn(dka[4 * j + 2] * scale,
                                  dka[4 * j + 3] * scale);
      if constexpr (kWithDV)
        *reinterpret_cast<__nv_bfloat162*>(dvb + key1 * dvst.s + col) =
            __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(QTile<D>::kThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap dmap,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int H, int group, int Sq,
                int Sk, int causal, int window, float scale,
                float scale_log2, Strides dqst) {
  using T = QTile<D>;
  constexpr int Bq = T::kBq, Bk = T::kBk, S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sO = base + T::kOOff, sK = base + T::kKOff,
                 sV = base + T::kVOff;
  // mbarriers: Q/dO, then S each of full and empty
  const uint32_t bar_q = base + T::kBarOff;
  const uint32_t bar_f = bar_q + 8;
  const uint32_t bar_e = bar_f + 8 * S;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  // the last query tiles see the most keys under causal: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Bq;

  int n_tiles = (Sk + Bk - 1) / Bk;
  if (causal) n_tiles = min(n_tiles, (min(q0 + Bq, Sq) - 1) / Bk + 1);
  // the first key any row of this block may see is q0 - window + 1
  const int t_first = window > 0 ? max(q0 - window + 1, 0) / Bk : 0;
  const int n_iter = max(n_tiles - t_first, 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(bar_f + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {
    if (tid == 128 && n_iter > 0) {
      mbar_expect_tx(bar_q, 2 * T::kQBytes);
      copy_tile<D, Bq>(sQ, &qmap, bar_q, q0, h, b);
      copy_tile<D, Bq>(sO, &dmap, bar_q, q0, h, b);
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(bar_e + 8 * st, (it / S - 1) & 1);
        const int kt = (t_first + it) * Bk;
        const uint32_t bar = bar_f + 8 * st;
        mbar_expect_tx(bar, 2 * T::kKVBytes);
        copy_tile<D, Bk>(sK + st * T::kKVBytes, &kmap, bar, kt, hk, b);
        copy_tile<D, Bk>(sV + st * T::kKVBytes, &vmap, bar, kt, hk, b);
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = q0 + warp * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int c0 = 2 * (lane % 4);
  const int64_t rbase = ((int64_t)b * H + h) * Sq;
  const float l2_0 = row0 < Sq ? lse[rbase + row0] * kLog2e : 0.f;
  const float l2_1 = row1 < Sq ? lse[rbase + row1] * kLog2e : 0.f;
  const float dl_0 = row0 < Sq ? delta[rbase + row0] : 0.f;
  const float dl_1 = row1 < Sq ? delta[rbase + row1] : 0.f;

  float dqa[D / 2], s[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) da[kk][r] = 0u;

  auto kaddr = [&](int j) { return sK + (j % S) * T::kKVBytes; };
  auto vaddr = [&](int j) { return sV + (j % S) * T::kKVBytes; };
  // S(j) = Q K_j^T and dP(j) = dO V_j^T (Q's and dO's descriptors rebuilt
  // at each issue, as in the dK/dV pass)
  auto issue_s = [&](int j) {
    mbar_wait(bar_f + 8 * (j % S), (j / S) & 1);
    uint32_t q_at = sQ;
    asm volatile("" : "+r"(q_at));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(s, desc_kmajor<Bq>(q_at, kk),
                   desc_kmajor<Bk>(kaddr(j), kk), kk > 0);
  };
  auto issue_dp = [&](int j) {
    uint32_t o_at = sO;
    asm volatile("" : "+r"(o_at));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(dp, desc_kmajor<Bq>(o_at, kk),
                   desc_kmajor<Bk>(vaddr(j), kk), kk > 0);
  };
  // dQ += dS(j) K_j, one wgmma group
  auto issue_rs = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < Bk / 16; ++kk)
      wgmma_rs<D>(dqa, da[kk], desc_mnmajor<Bk>(kaddr(j), kk));
    wg_commit();
  };
  auto lse2 = [&](int i) { return frag_row1(i) ? l2_1 : l2_0; };
  auto dl = [&](int i) { return frag_row1(i) ? dl_1 : dl_0; };
  auto p_tile = [&](int j) {
    const int kt = (t_first + j) * Bk;
    auto valid = [&](int i) {
      const int qi = frag_row1(i) ? row1 : row0;
      const int kj = kt + c0 + frag_col(i);
      return kj < Sk && (!causal || qi >= kj) &&
             (window <= 0 || qi - kj < window);
    };
    if (kt + Bk > Sk || (causal && kt + Bk - 1 > q0) ||
        (window > 0 && q0 + Bq - 1 - kt >= window))
      probs<true>(s, scale_log2, lse2, valid);
    else
      probs<false>(s, scale_log2, lse2, valid);
  };
  // tile j: S(j) with dQ += dS(j-1) K_{j-1} (j > 0), then P(j), then
  // dP(j) and dS(j).  dP is issued only once P is computed, so that S, dP
  // and dS's fragments are never live at once (issued with S, they spilled
  // with two consumers, and ran slower with one)
  auto tile = [&](int j) {
    wg_fence();
    issue_s(j);
    wg_commit();
    if (j > 0) issue_rs(j - 1);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dqa);
    fence_regs(da);
    if (j > 0) mbar_arrive(bar_e + 8 * ((j - 1) % S));  // tile j-1 is done
    p_tile(j);
    wg_fence();
    issue_dp(j);
    wg_commit();
    wg_wait<0>();
    fence_regs(dp);
    dscores(s, dp, dl);
    pack_p<64>(dp, da);
  };

  if (n_iter > 0) {
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_iter; ++j) tile(j);
    wg_fence();
    issue_rs(n_iter - 1);
    wg_wait<0>();
    fence_regs(dqa);
    mbar_arrive(bar_e + 8 * ((n_iter - 1) % S));
  }

  __nv_bfloat16* dqb = dq + b * dqst.b + h * dqst.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + c0;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row0 * dqst.s + col) =
          __floats2bfloat162_rn(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row1 * dqst.s + col) =
          __floats2bfloat162_rn(dqa[4 * j + 2] * scale,
                                dqa[4 * j + 3] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
           int causal, int window, float scale, const Strides* st,
           cudaStream_t stream) {
  using KT = KVTile<D>;
  using QT = QTile<D>;
  const Strides &qst = st[0], &kst = st[1], &vst = st[2], &ost = st[3],
                &dost = st[4], &dqst = st[5], &dkst = st[6], &dvst = st[7];
  // both passes copy 64-row boxes, so they share the tensor maps
  static_assert(QT::kBq == 64 && QT::kBk == 64 && KT::kBq == 64 &&
                KT::kBk == 64, "one box height for every map");
  CUtensorMap qmap, kmap, vmap, dmap;
  int err = make_map(&qmap, q, D, Sq, H, B, qst, 64);
  if (!err) err = make_map(&kmap, k, D, Sk, KV, B, kst, 64);
  if (!err) err = make_map(&vmap, v, D, Sk, KV, B, vst, 64);
  if (!err) err = make_map(&dmap, dout, D, Sq, H, B, dost, 64);
  if (!err) err = launch_delta<__nv_bfloat16>(o, dout, delta, B, H, Sq, D,
                                              ost, dost, stream);
  if (err) return err;
  const float scale_log2 = scale * kLog2e;

  auto dq_kernel = flash_bwd_dq_tc<D>;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, QT::kSmem);
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<dim3(B * H, (Sq + QT::kBq - 1) / QT::kBq), QT::kThreads,
              QT::kSmem, stream>>>(qmap, kmap, vmap, dmap, lse, delta,
                                   (__nv_bfloat16*)dq, H, H / KV, Sq, Sk,
                                   causal, window, scale, scale_log2, dqst);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // D <= 128: one dK/dV pass; D = 256: a dV pass, then a dK pass
  auto kv_pass = [&](auto kv_kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KT::kSmem);
    if (err != cudaSuccess) return err;
    kv_kernel<<<dim3(B * KV, (Sk + KT::kBk - 1) / KT::kBk), KT::kThreads,
                KT::kSmem, stream>>>(qmap, kmap, vmap, dmap, lse, delta,
                                     (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
                                     H, H / KV, Sq, Sk, causal, window,
                                     scale, scale_log2, dkst, dvst);
    return cudaGetLastError();
  };
  if constexpr (D <= 128) {
    e = kv_pass(flash_bwd_dkdv_tc<D, kBoth>);
  } else {
    e = kv_pass(flash_bwd_dkdv_tc<D, kDV>);
    if (e == cudaSuccess) e = kv_pass(flash_bwd_dkdv_tc<D, kDK>);
  }
  return (int)e;
}

}  // namespace tc

}  // namespace

// q, o, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, KV, Sk, D), each
// addressed by its (batch, head, seq) element strides, given in that order
// (q, k, v, o, dout, dq, dk, dv) as 24 int64 in `strides`, with a
// contiguous head dim; all of one dtype (is_bf16 ? bf16 : fp32).  lse:
// (B, H, Sq) fp32 contiguous, the forward's natural-log row log-sum-exp of
// the scaled scores; delta: (B, H, Sq) fp32 scratch.  D must be 64, 128 or
// 256.  Both types need 16-byte aligned q, k, v, dout pointers and
// strides (bf16: TMA; fp32: cp.async).
// Launches three kernels on `stream` (four for bf16 at D = 256); returns a
// CUDA error code (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int is_bf16, int B, int H, int KV, int Sq, int Sk, int D,
    int causal, int window, float scale, const int64_t* strides,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return is_bf16 ? tc::launch<64>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, H, KV, Sq, Sk, causal, window,
                                      scale, st, s)
                     : fp32::launch<64>(q, k, v, o, dout, lse, delta,
                                               dq, dk, dv, B, H, KV, Sq, Sk,
                                               causal, window, scale, st, s);
    case 128:
      return is_bf16 ? tc::launch<128>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, H, KV, Sq, Sk, causal, window,
                                       scale, st, s)
                     : fp32::launch<128>(q, k, v, o, dout, lse, delta,
                                                dq, dk, dv, B, H, KV, Sq, Sk,
                                                causal, window, scale, st, s);
    case 256:
      return is_bf16 ? tc::launch<256>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, H, KV, Sq, Sk, causal, window,
                                       scale, st, s)
                     : fp32::launch<256>(q, k, v, o, dout, lse, delta,
                                                dq, dk, dv, B, H, KV, Sq, Sk,
                                                causal, window, scale, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
