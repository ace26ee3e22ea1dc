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
// bf16 q/k/v/o, so at the serve path's prefill buckets (S = 256..512,
// D = 128) the card's bound is bytes (under the ~295 flop/byte bf16 ridge)
// and from S ~ 1200 on it is operations.  This first version keeps every
// product on the fp32 FMA pipes (67 TFLOP/s on the data sheet), not the
// tensor cores, so its own ceiling is operations at every size: it is
// simple and deterministic, and it serves fp32 inputs at full precision.
// wgmma/TMA tiles come in a later change.  What the design does about it:
//   * a block owns 64 query rows of one (batch, head); 256 threads as
//     16 x 16, each thread 4 query rows x (Bk / 16) keys of the score tile
//     and 4 rows x (D / 16) columns of the output accumulator, all in
//     registers, so each shared-memory read feeds 4 FMAs;
//   * the query tile is staged once; K/V tiles (Bk = 64, 32 at D = 256 to
//     fit shared memory) are staged per step, converted to fp32 on load,
//     rows padded so that the column reads hit distinct banks;
//   * under `causal` the KV loop stops at the diagonal tile, and under a
//     window it starts at the first tile that holds a key at or right of
//     q_tile_start - window + 1: tiles wholly outside the band are skipped;
//   * a masked score's probability is exactly 0, so a row whose first
//     visited tile lies wholly left of its window adds nothing;
//   * both ragged edges (Sq, Sk) are masked in the kernel: the wrapper pads
//     nothing, and arbitrary strides are taken, so (B, S, H, D) tensors
//     from the projections are read in place;
//   * row max and row sum are butterfly shuffles over the 16 lanes that
//     hold a row (every lane ends with the same bits), the PV sum runs over
//     keys in one fixed order, and nothing uses atomics: the output is
//     bit-identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBq = 64;        // query rows per block
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // query rows per thread (16 * 4 = kBq)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  int64_t b, h, s;  // elements; the head dim is contiguous
};

template <int D>
struct Cfg {
  static constexpr int kBk = D >= 256 ? 32 : 64;  // keys per tile
  static constexpr int kCols = kBk / 16;          // score columns per thread
  static constexpr int kOcols = D / 16;           // output columns per thread
  static constexpr int kKld = D + 1;              // padded Q/K row
  static constexpr int kPld = kBk + 4;            // padded P row
  static constexpr size_t kSmem =
      sizeof(float) * (kBq * kKld + kBk * kKld + kBk * D + kBq * kPld);
};

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int group,
                 int Sq, int Sk, int causal, int window, float scale,
                 Strides qst,
                 Strides kst, Strides vst, Strides ost) {
  using C = Cfg<D>;
  constexpr int Bk = C::kBk;
  extern __shared__ float smem[];
  float* Qs = smem;                // [kBq][kKld]
  float* Ks = Qs + kBq * C::kKld;  // [Bk][kKld]
  float* Vs = Ks + Bk * C::kKld;   // [Bk][D]
  float* Ps = Vs + Bk * D;         // [kBq][kPld]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / group;
  const int q0 = blockIdx.x * kBq;

  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + hk * kst.h;
  const T* vb = v + b * vst.b + hk * vst.h;
  T* ob = o + b * ost.b + h * ost.h;

  for (int idx = tid; idx < kBq * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    Qs[r * C::kKld + d] = qi < Sq ? to_f(qb[qi * qst.s + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][C::kOcols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kOcols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + Bk - 1) / Bk;
  if (causal) {
    const int q_last = min(q0 + kBq, Sq) - 1;
    n_tiles = min(n_tiles, q_last / Bk + 1);
  }
  // the first key any row of this block may see is q0 - window + 1
  const int t_first = window > 0 ? max(q0 - window + 1, 0) / Bk : 0;

  for (int t = t_first; t < n_tiles; ++t) {
    const int k0 = t * Bk;
    __syncthreads();  // the previous tile's PV reads are done
    for (int idx = tid; idx < Bk * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int kj = k0 + r;
      const bool ok = kj < Sk;
      Ks[r * C::kKld + d] = ok ? to_f(kb[kj * kst.s + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f(vb[kj * vst.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][C::kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[C::kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * C::kKld + d];
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) kv[j] = Ks[(tx + 16 * j) * C::kKld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < C::kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool valid = kj < Sk && (!causal || qi >= kj) &&
                           (window <= 0 || qi - kj < window);
        const float x = valid ? s[i][j] * scale : kNegInf;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], max16(rmax));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) {
        const float p = s[i][j] == kNegInf ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        rsum += p;
      }
      rsum = sum16(rsum);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::kOcols; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < C::kCols; ++j)
        Ps[(ty * kRows + i) * C::kPld + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    for (int j = 0; j < Bk; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * C::kPld + j];
#pragma unroll
      for (int c = 0; c < C::kOcols; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C::kOcols; ++c)
      ob[qi * ost.s + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Sk, int causal, int window, float scale,
           Strides qst, Strides kst, Strides vst, Strides ost,
           cudaStream_t stream) {
  const size_t smem = Cfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBq - 1) / kBq, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / KV, Sq, Sk,
      causal, window, scale, qst, kst, vst, ost);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int KV, int Sq, int Sk, int causal, int window,
               float scale, Strides qst, Strides kst, Strides vst, Strides ost,
               cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                           scale, qst, kst, vst, ost, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                            scale, qst, kst, vst, ost, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                            scale, qst, kst, vst, ost, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Sq, D), k/v: (B, KV, Sk, D), o: (B, H, Sq, D), each addressed by
// its (batch, head, seq) element strides with a contiguous head dim; all of
// one dtype (is_bf16 ? bf16 : fp32).  D must be 64, 128 or 256.  window > 0
// (causal only) keeps the keys with q_pos - k_pos < window.  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int KV, int Sq, int Sk, int D, int causal, int window, float scale,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KV, Sq, Sk, causal,
                                     window, scale, qst, kst, vst, ost, s);
  return dispatch_d<float>(D, q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                           scale, qst, kst, vst, ost, s);
}
