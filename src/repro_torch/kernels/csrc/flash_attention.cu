// Flash attention forward (GQA, causal or full, optionally a sliding
// window) on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: _flash_kernel
//   (pallas_call in flash_attention_pallas).
// Same function: online softmax over KV tiles with a running max m, a
// running denominator l and an fp32 output accumulator; causal mask
// q_pos >= k_pos with the masked score -1e30; output acc / max(l, 1e-30) in
// q's dtype; query head h reads KV head h / (H / KV).  The Pallas kernel has
// no window; the port adds one for RecurrentGemma's local attention
// (src/repro/models/layers.py, mode="local"): with window > 0 a causal
// query also needs q_pos - k_pos < window.
//
// What bounds it on the H100: causal attention does ~S/4 flop per byte of
// bf16 q/k/v/o, so at olmo-1b's prefill buckets (S = 256..512, D = 128) the
// card's bound is bytes (under the ~295 flop/byte bf16 ridge); from
// S ~ 1200 on, and for recurrentgemma-2b's 2048-key window at D = 256, it is
// the tensor cores' 989 TFLOP/s.  The first version of this file ran every
// product on the fp32 FMA pipes (67 TFLOP/s): 4.03 ms at (4,16,16,2048,128)
// causal, 2.76 ms at (1,10,1,3055,256) window 2048, 0.150 and 0.089 ms at
// olmo's 512 and 256 buckets, 25x, 3.7x and 3-5x SDPA's time (PERF.md,
// PR 12, NVIDIA H100 80GB HBM3 at 700 W).
//
// bf16 inputs run on the tensor cores (flash_fwd_tc below; its TMA,
// mbarrier, descriptor and wgmma helpers are csrc/hopper.cuh, shared with
// the backward):
//   * S = Q K^T is wgmma m64nBk k16 with Q and K read from shared memory
//     (both K-major); O += P V is wgmma m64nD k16 with P in registers and V
//     read from shared memory MN-major (the transpose 16-bit types allow);
//   * P never touches shared memory: the fp32 S accumulator fragment, cast
//     pairwise to bf16, is the A fragment of the PV product (the layouts
//     coincide for 16-bit types, as in FlashAttention-3);
//   * one producer warpgroup: a single thread loads Q once and the K/V
//     tiles by TMA into a ring of 2-4 stages completed on mbarriers, and
//     refills a stage when every consumer thread has arrived on its `empty`
//     mbarrier, so copies run ahead of the math; its other threads exit;
//   * consumers: 1 or 2 warpgroups of 64 query rows each (Bq = 64 or 128).
//     Registers set the tiles: with 384 threads a thread has 168, which
//     holds the 64 x D fp32 O accumulator, the 64 x Bk S accumulator and P
//     for D <= 128 with Bk = 64 (D = 64: Bk = 128); at D = 256 O alone
//     takes 128, so D = 256 runs one consumer (255 registers, Bk = 64).
//     Bq = 128 is taken where its grid covers the SMs once, else 64;
//   * each consumer phase issues S(j) and P(j-1) V back to back and runs
//     the softmax of S(j) while the PV product is still on the tensor
//     cores; exp is ex2 on log2(e)-scaled scores, one FFMA each;
//   * tensor maps are 4-d (D, S, heads, batch) over the strides the wrapper
//     passes (16-byte aligned: the wrapper checks), so the model's
//     (B, S, H, D) projections are read in place; a box is 64 columns
//     (128 bytes, the SWIZZLE_128B span), so a 128- or 256-wide head is 2
//     or 4 boxes side by side, and the descriptors step over them (K-major:
//     32 bytes per k16 slice inside a box, the next box after 4 slices;
//     MN-major V: the next box at the leading byte offset); out-of-bounds
//     rows of a box (the ragged Sq and Sk edges) arrive as zeros and are
//     masked;
//   * the masks are applied only on tiles that cross the diagonal, the
//     window's left edge or Sk; the KV loop stops at the causal diagonal and
//     starts at the first tile that holds a key at or right of
//     q_tile_start - window + 1; the longest query tiles start first;
//   * P enters the PV product in bf16, a rounding the fp32 plain version
//     does not make (|p| <= 1, so at most 2^-9 absolute per weight); m, l,
//     the S and O accumulators and the softmax stay fp32;
//   * no atomics and no split over keys: the KV tiles are visited in one
//     order, row sums reduce over the 4 lanes of a row by a butterfly, and
//     the output is bit-identical from run to run (and between Bq = 64 and
//     128: a tile wholly masked for a row leaves it unchanged).
// fp32 inputs run on the tensor cores too (flash_fwd_split below), each
// product as a split TF32 product (tf32.cuh: three TF32 products of the
// operands' hi and lo parts, fp32 accumulators), which keeps the 2e-4 fp32
// limit where one TF32 pass would break it; P stays fp32 up to its split.
// They are mma.sync products from fragments loaded by hand: wgmma takes
// 32-bit operands from shared memory only K-major, with no transpose, and
// P V (V's contiguous dim is D, not the keys) would need V transposed into
// shared memory.  Its bound is operations at a third of the 495 TFLOP/s
// TF32 rate; what holds it to ~0.2 of that is instruction issue: each
// element a warp loads costs its load and its split (3 ops) for three
// mma.  The model reference (chip_smoke.py) and fp32 models call it; bf16
// serve and train paths do not.
// Both kernels can also write each row's log-sum-exp of the scaled scores,
// m * scale + log(l), which the backward (csrc/flash_attention_bwd.cu)
// takes to recompute P; the serve path passes no lse buffer, and the
// output's bits are the same with or without one.

#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using hopper::Strides;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: the split-TF32 kernel (mma.sync on the tensor cores; tf32.cuh)
//   * a block owns 64 query rows of one (batch, head): 8 warps, two a
//     group of 16 rows, each of the two on half of every K/V tile's keys
//     with its own 16 x D fp32 O accumulator (D / 2 registers), merged at
//     the end; K/V tiles (Bk = 64 keys, 32 at D = 256 to fit shared
//     memory) in a ring of 2 filled by cp.async, the next tile's copies in
//     flight while this one's products run; Q staged once;
//   * S = Q K^T and O += P V are split products (tf32.cuh): Q, K, V and P
//     are each split into hi + lo as their fragments are loaded, P straight
//     from the S accumulator's registers (acc_as_a), so it never touches
//     shared memory and stays fp32 to the split;
//   * the online softmax, the masks, the tile range and the output are
//     those of the tensor-core kernel below, in fp32 (its softmax_tile
//     arithmetic on the same accumulator layout); one visiting order, no
//     atomics: the bits are the same from run to run.
// ---------------------------------------------------------------------------

namespace fp32 {

using namespace tf32;
using hopper::ex2;

template <int D>
struct Tile {
  static constexpr int kBq = 64;                  // query rows: 4 groups
  static constexpr int kBk = D <= 128 ? 64 : 32;  // keys a K/V tile
  static constexpr int kKw = kBk / 2;             // keys a warp a tile
  static constexpr int kThreads = 256;
  static constexpr int kLd = D + 4;               // padded row, floats
  static constexpr int kQ = kBq * kLd;
  static constexpr int kKV = kBk * kLd;
  // Q | K[2] | V[2]; after the loop K/V hold the merge's partial results
  static constexpr int kSmem = 4 * (kQ + 4 * kKV);
  static_assert(kSmem <= 232448, "tiles do not fit shared memory");
  static_assert(4 * kKV >= kBq * kLd + 2 * kBq, "no room for the merge");
};

// Warps w and w + 4 own the same 16 query rows (group w % 4) and take the
// first and the second half of each K/V tile's keys, each with its own
// online softmax (m, l) and O accumulator; at the end the second warp's
// (m, l, O) goes through shared memory to the first, which merges the two
// in fp32 and writes the rows.  Eight warps an SM at every grid size (the
// longest block of a one-wave grid, the serve prefill's, halves its walk).
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_fwd_split(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int H, int group, int Sq, int Sk,
                int causal, int window, float scale_log2, Strides qst,
                Strides kst, Strides vst, Strides ost) {
  using T = Tile<D>;
  constexpr int Bq = T::kBq, Bk = T::kBk, Kw = T::kKw, L = T::kLd;
  constexpr int NB = Kw / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + T::kQ;
  float* Vs = Ks + 2 * T::kKV;

  const int tid = threadIdx.x, lane = tid % 32;
  // warp-uniform: the row group and key half of this warp
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp % 4, kh = warp / 4;
  const int g = lane / 4, t = lane % 4;
  // the longest blocks (last query tiles under causal) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * Bq;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / group;
  const float* kb = k + b * kst.b + hk * kst.h;
  const float* vb = v + b * vst.b + hk * vst.h;

  int n_tiles = (Sk + Bk - 1) / Bk;
  if (causal) n_tiles = min(n_tiles, (min(q0 + Bq, Sq) - 1) / Bk + 1);
  // the first key any row of this block may see is q0 - window + 1
  const int t_first = window > 0 ? max(q0 - window + 1, 0) / Bk : 0;
  const int n_iter = max(n_tiles - t_first, 0);

  auto load_kv = [&](int j) {
    const int st = j & 1, k0 = (t_first + j) * Bk;
    load_rows<D, Bk, 256>(Ks + st * T::kKV, kb, kst.s, k0, Sk);
    load_rows<D, Bk, 256>(Vs + st * T::kKV, vb, vst.s, k0, Sk);
  };
  load_rows<D, Bq, 256>(Qs, q + b * qst.b + h * qst.h, qst.s, q0, Sq);
  if (n_iter > 0) load_kv(0);
  cp_async_commit();

  // this thread's rows row0 and row1 = row0 + 8 of the group's 16
  const int qw0 = q0 + rg * 16;
  const int row0 = qw0 + g, row1 = row0 + 8;
  const float* Qw = Qs + rg * 16 * L;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_iter; ++j) {
    if (j + 1 < n_iter) {
      load_kv(j + 1);  // into the stage tile j-1 left
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
    // keys all past Sk, right of the diagonal or left of the window for
    // every row of the warp: nothing to add (m, l and O stay as they are)
    const bool skip = k0 >= Sk || (causal && k0 > qw0 + 15) ||
                      (window > 0 && qw0 - (k0 + Kw - 1) >= window);
    if (!skip) {
      // S = Q K^T, raw scores
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA a;
        load_a(a, Qw + kk * 8, L, g, t);
        mma_step<NB>(s, a, Kt + kk * 8, L, g, t);
      }

      // the online softmax; masks only where the warp's keys cross the
      // diagonal, the window's left edge or Sk
      const bool masked = k0 + Kw > Sk || (causal && k0 + Kw - 1 > qw0) ||
                          (window > 0 && qw0 + 15 - k0 >= window);
      if (masked) {
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = r < 2 ? row0 : row1;
            const int key = k0 + 8 * n + 2 * t + (r & 1);
            if (!(key < Sk && (!causal || row >= key) &&
                  (window <= 0 || row - key < window)))
              s[n][r] = kNegInf;
          }
      }
      // the 4 lanes of a row agree on its max
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = ex2((m0 - mx0) * scale_log2);
      const float alpha1 = ex2((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p = ex2(fmaf(s[n][r], scale_log2, -(r < 2 ? mb0 : mb1)));
          if (masked && s[n][r] == kNegInf) p = 0.f;
          s[n][r] = p;
          if (r < 2) ps0 += p;
          else ps1 += p;
        }
      l0 = alpha0 * l0 + ps0;  // this lane's columns, summed at the end
      l1 = alpha1 * l1 + ps1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }

      // O += P V
      FragA pa[NB];
      acc_as_a<NB>(pa, s);
      mma_acc<NB, D / 8>(acc, pa, Vt, L, g, t);
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // the merge: the second key half's (m, l, O) of each row group through
  // the K/V tiles' memory (free after the loop's last barrier)
  float* Xs = Ks;                  // [64 rows][L]
  float* Ms = Xs + Bq * L;         // [64 rows] m, then [64 rows] l
  const int r0 = rg * 16 + g, r1 = r0 + 8;
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(Xs + r0 * L + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(Xs + r1 * L + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
    if (t == 0) {
      Ms[r0] = m0;
      Ms[r1] = m1;
      Ms[Bq + r0] = l0;
      Ms[Bq + r1] = l1;
    }
  }
  __syncthreads();
  if (kh == 1) return;
  const float mo0 = Ms[r0], mo1 = Ms[r1];
  const float mm0 = fmaxf(m0, mo0), mm1 = fmaxf(m1, mo1);
  const float f0 = ex2((m0 - mm0) * scale_log2);
  const float f1 = ex2((m1 - mm1) * scale_log2);
  const float fo0 = ex2((mo0 - mm0) * scale_log2);
  const float fo1 = ex2((mo1 - mm1) * scale_log2);
  l0 = l0 * f0 + Ms[Bq + r0] * fo0;
  l1 = l1 * f1 + Ms[Bq + r1] * fo1;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* ob = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(Xs + r0 * L + col);
    const float2 x1 = *reinterpret_cast<const float2*>(Xs + r1 * L + col);
    if (row0 < Sq)
      *reinterpret_cast<float2*>(ob + row0 * ost.s + col) =
          make_float2((acc[n][0] * f0 + x0.x * fo0) / d0,
                      (acc[n][1] * f0 + x0.y * fo0) / d0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(ob + row1 * ost.s + col) =
          make_float2((acc[n][2] * f1 + x1.x * fo1) / d1,
                      (acc[n][3] * f1 + x1.y * fo1) / d1);
  }
  // the rows' log-sum-exp of the scaled scores (natural log), for the
  // backward
  if (lse && t == 0) {
    float* lb = lse + ((int64_t)b * H + h) * Sq;
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < Sq)
      lb[row0] =
          l0 > 0.f ? (mm0 * scale_log2 + log2f(l0)) * kLn2 : -INFINITY;
    if (row1 < Sq)
      lb[row1] =
          l1 > 0.f ? (mm1 * scale_log2 + log2f(l1)) * kLn2 : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int Sq, int Sk, int causal, int window,
           float scale, Strides qst, Strides kst, Strides vst, Strides ost,
           cudaStream_t stream) {
  using T = Tile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + T::kBq - 1) / T::kBq, B * H);
  flash_fwd_split<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, H,
      H / KV, Sq, Sk, causal, window,
      scale * 1.4426950408889634f,  // log2(e): exp via ex2
      qst, kst, vst, ost);
  return (int)cudaGetLastError();
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma, TMA, mbarriers; sm_90a only)
// ---------------------------------------------------------------------------

namespace tc {

// Registers decide the tiles: 384 threads (two consumers and the producer
// warpgroup) leave 168 a thread, which holds a 64 x D fp32 O accumulator,
// the 64 x Bk S accumulator and P's fragments only for D <= 128 with
// Bk = 64 (D = 64 affords Bk = 128); at D = 256 the O accumulator alone
// takes 128, so D = 256 runs one consumer warpgroup (255 registers).
// Shared memory then takes as many K/V stages as fit, up to 4.
template <int D, int NWG>
struct Tile {
  static_assert(NWG == 1 || D <= 128, "two consumers only for D <= 128");
  static constexpr int kBq = 64 * NWG;             // query rows per block
  static constexpr int kBk = D >= 128 ? 64 : 128;  // keys per KV tile
  static constexpr int kThreads = 128 * (NWG + 1); // + a producer
  static constexpr int kQBytes = kBq * D * 2;
  static constexpr int kKVBytes = kBk * D * 2;     // one K or one V tile
  static constexpr int kStages =                   // K/V ring depth
      (232448 - 1024 - 128 - kQBytes) / (2 * kKVBytes) < 4
          ? (232448 - 1024 - 128 - kQBytes) / (2 * kKVBytes)
          : 4;
  // Q | K[kStages] | V[kStages] | mbarriers; every tile 1024-byte aligned
  // (the SWIZZLE_128B atom), the base aligned up at run time
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kStages >= 2 && kSmem <= 232448, "K/V ring does not fit");
};

using namespace hopper;

// Online softmax of one KV tile for this thread's two rows, on the raw
// scores s (the S accumulator fragment).  Masked marks masked scores as
// kNegInf first and gives them probability exactly 0.  On return s holds P
// (fp32), m and l are updated and alpha0/alpha1 are the factors by which
// the O accumulator must be rescaled before P V is added.
template <bool Masked, int Bk>
__device__ __forceinline__ void softmax_tile(
    float (&s)[Bk / 2], float& m0, float& m1, float& l0, float& l1,
    float& alpha0, float& alpha1, float scale_log2, int row0, int row1,
    int key0, int Sk, int causal, int window) {
  if (Masked) {
#pragma unroll
    for (int i = 0; i < Bk / 2; ++i) {
      const int row = (i % 4) < 2 ? row0 : row1;
      const int key = key0 + 8 * (i / 4) + (i % 2);
      const bool valid = key < Sk && (!causal || row >= key) &&
                         (window <= 0 || row - key < window);
      if (!valid) s[i] = kNegInf;
    }
  }
  // the 4 lanes of a row agree on its max
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < Bk / 2; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  alpha0 = ex2((m0 - mx0) * scale_log2);
  alpha1 = ex2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < Bk / 2; ++i) {
    const bool r0 = (i % 4) < 2;
    float p = ex2(fmaf(s[i], scale_log2, -(r0 ? mb0 : mb1)));
    if (Masked && s[i] == kNegInf) p = 0.f;
    s[i] = p;
    if (r0) ps0 += p;
    else ps1 += p;
  }
  l0 = alpha0 * l0 + ps0;  // this lane's columns; lanes summed at the end
  l1 = alpha1 * l1 + ps1;
}

// The products of one phase: S(j) = Q K_j^T (if S) and O += P(j-1) V_{j-1}
// (if PV), each committed as its own wgmma group.
template <bool DoS, bool DoPV, int D, int Bq, int Bk>
__device__ __forceinline__ void issue_phase(float (&s)[Bk / 2],
                                            float (&acc)[D / 2],
                                            const uint32_t (&pa)[Bk / 16][4],
                                            uint32_t sQw, uint32_t sKs,
                                            uint32_t sVs, uint32_t bar_k,
                                            uint32_t k_phase, uint32_t bar_v,
                                            uint32_t v_phase) {
  wg_fence();
  if (DoS) {
    mbar_wait(bar_k, k_phase);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<Bk>(s, desc_kmajor<Bq>(sQw, kk), desc_kmajor<Bk>(sKs, kk),
                   kk > 0);
    wg_commit();
  }
  if (DoPV) {
    mbar_wait(bar_v, v_phase);
#pragma unroll
    for (int kk = 0; kk < Bk / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk], desc_mnmajor<Bk>(sVs, kk));
    wg_commit();
  }
}

// Warpgroups 0..NWG-1 consume, 64 query rows each; warpgroup NWG produces:
// one of its threads issues every TMA copy and refills a stage once every
// consumer thread has arrived on its `empty` barrier.
//
// A consumer runs n_iter + 1 phases; phase j issues S(j) = Q K_j^T and
// O += P(j-1) V_{j-1} back to back, computes the softmax of S(j) while the
// PV product still runs, and only then rescales O and packs P(j).
template <int D, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
             int group, int Sq, int Sk, int causal, int window,
             float scale_log2, Strides ost) {
  using T = Tile<D, NWG>;
  constexpr int Bq = T::kBq, Bk = T::kBk, S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + T::kKOff, sV = base + T::kVOff;
  // mbarriers: q, then S each of k_full, v_full and empty
  const uint32_t bar_q = base + T::kBarOff;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_k + 8 * S;
  const uint32_t bar_e = bar_v + 8 * S;

  const int tid = threadIdx.x;
  // warp-uniform, so that the compiler sees each role's wgmma as converged
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // the longest blocks (last query tiles under causal) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * Bq;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / group;

  int n_tiles = (Sk + Bk - 1) / Bk;
  if (causal) n_tiles = min(n_tiles, (min(q0 + Bq, Sq) - 1) / Bk + 1);
  // the first key any row of this block may see is q0 - window + 1
  const int t_first = window > 0 ? max(q0 - window + 1, 0) / Bk : 0;
  const int n_iter = n_tiles - t_first;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    if (tid == 128 * NWG) {
      load_tile<D, Bq>(sQ, &qmap, bar_q, q0, h, b);
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(bar_e + 8 * st, (it / S - 1) & 1);
        const int k0 = (t_first + it) * Bk;
        load_tile<D, Bk>(sK + st * T::kKVBytes, &kmap, bar_k + 8 * st, k0,
                         hk, b);
        load_tile<D, Bk>(sV + st * T::kKVBytes, &vmap, bar_v + 8 * st, k0,
                         hk, b);
      }
    }
    return;
  }

  // this thread's two rows of the warpgroup's 64: row0 and row0 + 8; its
  // columns of each 8-wide chunk: c0 and c0 + 1
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int qw0 = q0 + wg * 64;
  const int row0 = qw0 + warp * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int c0 = 2 * (lane % 4);
  const uint32_t sQw = sQ + wg * 64 * 128;

  float s[Bk / 2];
  float acc[D / 2];
  uint32_t pa[Bk / 16][4];
#pragma unroll
  for (int i = 0; i < Bk / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Bk / 16; ++kk)
    pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float alpha0, alpha1;

  // softmax of S(j), in place; masks only where this warpgroup's rows cross
  // the diagonal, the window's left edge or Sk
  auto softmax = [&](int j) {
    const int k0 = (t_first + j) * Bk;
    if (k0 + Bk > Sk || (causal && k0 + Bk - 1 > qw0) ||
        (window > 0 && qw0 + 63 - k0 >= window))
      softmax_tile<true, Bk>(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2,
                             row0, row1, k0 + c0, Sk, causal, window);
    else
      softmax_tile<false, Bk>(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2,
                              row0, row1, k0 + c0, Sk, causal, window);
  };
  auto kaddr = [&](int j) { return sK + (j % S) * T::kKVBytes; };
  auto vaddr = [&](int j) { return sV + (j % S) * T::kKVBytes; };
  auto kbar = [&](int j) { return bar_k + 8 * (j % S); };
  auto vbar = [&](int j) { return bar_v + 8 * (j % S); };
  auto par = [&](int j) { return (uint32_t)((j / S) & 1); };

  if (n_iter > 0) {
    mbar_wait(bar_q, 0);
    // phase 0: S(0)
    issue_phase<true, false, D, Bq, Bk>(s, acc, pa, sQw, kaddr(0), 0,
                                        kbar(0), par(0), 0, 0);
    wg_wait<0>();
    fence_regs(s);
    softmax(0);
    pack_p<Bk>(s, pa);
    // phases 1 .. n_iter - 1: S(j) and P(j-1) V
    for (int j = 1; j < n_iter; ++j) {
      issue_phase<true, true, D, Bq, Bk>(s, acc, pa, sQw, kaddr(j),
                                         vaddr(j - 1), kbar(j), par(j),
                                         vbar(j - 1), par(j - 1));
      wg_wait<1>();  // S(j) is done, P(j-1) V may still run
      fence_regs(s);
      softmax(j);
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar_e + 8 * ((j - 1) % S));  // done with tile j-1's stage
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i % 4) < 2 ? alpha0 : alpha1;
      pack_p<Bk>(s, pa);
    }
    // phase n_iter: P(n_iter - 1) V
    issue_phase<false, true, D, Bq, Bk>(s, acc, pa, sQw, 0,
                                        vaddr(n_iter - 1), 0, 0,
                                        vbar(n_iter - 1), par(n_iter - 1));
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_e + 8 * ((n_iter - 1) % S));
  }

  // the 4 lanes of a row hold disjoint columns' sums: a butterfly gives
  // each the same total
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + c0;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * ost.s + col) =
          __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * ost.s + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
  // the rows' log-sum-exp of the scaled scores (natural log), for the
  // backward: m is in raw score units, l sums ex2((s - m) * scale_log2)
  if (lse && c0 == 0) {
    float* lb = lse + ((int64_t)b * H + h) * Sq;
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < Sq)
      lb[row0] = l0 > 0.f ? (m0 * scale_log2 + log2f(l0)) * kLn2 : -INFINITY;
    if (row1 < Sq)
      lb[row1] = l1 > 0.f ? (m1 * scale_log2 + log2f(l1)) * kLn2 : -INFINITY;
  }
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int Sq, int Sk, int causal, int window,
           float scale, Strides qst, Strides kst, Strides vst, Strides ost,
           cudaStream_t stream) {
  using T = Tile<D, NWG>;
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, q, D, Sq, H, B, qst, T::kBq);
  if (!err) err = make_map(&kmap, k, D, Sk, KV, B, kst, T::kBk);
  if (!err) err = make_map(&vmap, v, D, Sk, KV, B, vst, T::kBk);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + T::kBq - 1) / T::kBq, B * H);
  flash_fwd_tc<D, NWG><<<grid, T::kThreads, T::kSmem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, lse, H, H / KV, Sq, Sk, causal,
      window,
      scale * 1.4426950408889634f, ost);  // log2(e): exp via ex2
  return (int)cudaGetLastError();
}

// Bq = 128 where it exists (D <= 128) and its grid covers the SMs once;
// the bits are the same either way
bool wide_block(int D, int B, int H, int Sq) {
  if (D > 128) return false;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (long long)((Sq + 127) / 128) * B * H >= sms;
}

}  // namespace tc

// cvt.rna.tf32.f32 and the kernels' own rounding (tf32::rna) of n values:
// the card's checks hold the second, and ref.tf32_round (the rounding of
// the split-TF32 arithmetic on the CPU), to the first
__global__ void tf32_round_values(const float* __restrict__ in,
                                  float* __restrict__ out_cvt,
                                  float* __restrict__ out_rna, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out_cvt[i] = __uint_as_float(tf32::cvt_rna(in[i]));
    out_rna[i] = __uint_as_float(tf32::rna(in[i]));
  }
}

template <int D>
int dispatch(int is_bf16, const void* q, const void* k, const void* v,
             void* o, float* lse, int B, int H, int KV, int Sq, int Sk,
             int causal, int window, float scale, Strides qst, Strides kst,
             Strides vst, Strides ost, cudaStream_t stream) {
  if (!is_bf16)
    return fp32::launch<D>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window,
                           scale, qst, kst, vst, ost, stream);
  if constexpr (D <= 128)
    if (tc::wide_block(D, B, H, Sq))
      return tc::launch<D, 2>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal,
                              window, scale, qst, kst, vst, ost, stream);
  return tc::launch<D, 1>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window,
                          scale, qst, kst, vst, ost, stream);
}

}  // namespace

// q: (B, H, Sq, D), k/v: (B, KV, Sk, D), o: (B, H, Sq, D), each addressed by
// its (batch, head, seq) element strides with a contiguous head dim; all of
// one dtype (is_bf16 ? bf16 : fp32).  D must be 64, 128 or 256.  window > 0
// (causal only) keeps the keys with q_pos - k_pos < window.  Both types
// need 16-byte aligned pointers and strides (bf16: TMA; fp32: cp.async).
// lse, if not null, receives each row's natural-log log-sum-exp of the
// scaled scores as a contiguous (B, H, Sq) fp32 tensor (the backward's
// input; the output's bits do not depend on it).  Launches on `stream`;
// returns a CUDA error code (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int is_bf16,
    int B, int H, int KV, int Sq, int Sk, int D, int causal,
    int window, float scale, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return dispatch<64>(is_bf16, q, k, v, o, lse, B, H, KV, Sq, Sk,
                          causal, window, scale, qst, kst, vst, ost, s);
    case 128:
      return dispatch<128>(is_bf16, q, k, v, o, lse, B, H, KV, Sq, Sk,
                           causal, window, scale, qst, kst, vst, ost, s);
    case 256:
      return dispatch<256>(is_bf16, q, k, v, o, lse, B, H, KV, Sq, Sk,
                           causal, window, scale, qst, kst, vst, ost, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out_cvt[i] = cvt.rna.tf32.f32(in[i]) and out_rna[i] = the fp32 kernels'
// rounding of their operands' hi parts (tf32::rna), for the card's checks;
// returns a CUDA error code
extern "C" int flash_tf32_round(const float* in, float* out_cvt,
                                float* out_rna, int n, void* stream) {
  if (n <= 0) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  tf32_round_values<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      in, out_cvt, out_rna, n);
  return (int)cudaGetLastError();
}
