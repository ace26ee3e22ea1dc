// WKV6 linear recurrence (RWKV-6 "Finch" time mixing) on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan/kernel.py: _wkv6_kernel
//   (pallas_call in wkv6_pallas).
// Same function, per (batch, head), over tokens t with an N x N fp32 state:
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp(log_w_t)) S_{t-1} + k_t^T v_t
// and, unlike the Pallas kernel (which starts from zero and drops the final
// state), an optional entering state S0 and the final state S_T as an
// output: the model's prefill stores S_T in the decode cache.
//
// What bounds it on the H100: at the serve path's shapes (B = 1, H = 40,
// N = 64, T ~ 200..400) the work is ~4 N^2 flop per token and head against
// ~4 N input and N output elements, so the data-sheet bound is operations
// (fp32 FMA pipes) near ~1 us; the real limit of this first version is the
// recurrence itself: each token depends on the last, and only B * H blocks
// exist (40 on 132 SMs).  The Pallas kernel's chunked form (16-token chunks
// as small matrix products) trades the chain for tensor-core work; that is
// later work.  What this design does:
//   * one block of N threads per (batch, head); thread m owns column m of
//     the state in registers (N floats), so every column evolves on its own
//     and no thread talks to another:
//       o_m = sum_n r_n S[n, m] + v_m * sum_n r_n u_n k_n
//       S[n, m] <- w_n S[n, m] + k_n v_m
//   * 16 tokens of r, k, w = exp(log_w), v and r*u*k are staged in shared
//     memory per pass (one coalesced load each), then read as broadcasts;
//   * any T: the last pass covers the ragged tail, the wrapper pads nothing;
//   * inputs are read through (batch, head, token) strides, so the model's
//     (B, T, H, N) projections are read in place and the output is written
//     in the same layout;
//   * every sum runs over n in one fixed order with fmaf and no atomics:
//     the result is bit-identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // tokens staged per pass

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
  int64_t b, h, t;  // elements; the channel dim is contiguous
};

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ log_w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ o, float* __restrict__ s_out, int H, int T_len,
            Strides rst, Strides kst, Strides vst, Strides wst, Strides ost) {
  __shared__ float rs[kChunk][N];
  __shared__ float ks[kChunk][N];
  __shared__ float ws[kChunk][N];
  __shared__ float vs[kChunk][N];
  __shared__ float bs[kChunk][N];  // r * u * k, summed for the bonus term

  const int m = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const T* rb = r + b * rst.b + h * rst.h;
  const T* kb = k + b * kst.b + h * kst.h;
  const T* vb = v + b * vst.b + h * vst.h;
  const float* wb = log_w + b * wst.b + h * wst.h;
  T* ob = o + b * ost.b + h * ost.h;
  const float um = u[h * N + m];

  float S[N];  // column m of the state: S[n] = S[n, m]
  const size_t sbase = (size_t)blockIdx.x * N * N;
#pragma unroll
  for (int n = 0; n < N; ++n) S[n] = s0 ? s0[sbase + n * N + m] : 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int len = min(kChunk, T_len - t0);
    __syncthreads();  // the previous pass's reads are done
    for (int i = 0; i < len; ++i) {
      const int t = t0 + i;
      const float rv = to_f(rb[t * rst.t + m]);
      const float kv = to_f(kb[t * kst.t + m]);
      rs[i][m] = rv;
      ks[i][m] = kv;
      vs[i][m] = to_f(vb[t * vst.t + m]);
      ws[i][m] = expf(wb[t * wst.t + m]);
      bs[i][m] = rv * um * kv;
    }
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      const float vm = vs[i][m];
      float bonus = 0.f, acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        bonus += bs[i][n];
        acc = fmaf(rs[i][n], S[n], acc);
        S[n] = fmaf(ws[i][n], S[n], ks[i][n] * vm);
      }
      ob[(t0 + i) * ost.t + m] = from_f<T>(fmaf(bonus, vm, acc));
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) s_out[sbase + n * N + m] = S[n];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* o, float* s_out, int B,
           int H, int T_len, Strides rst, Strides kst, Strides vst,
           Strides wst, Strides ost, cudaStream_t stream) {
  wkv6_kernel<T, N><<<B * H, N, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, lw, u, s0, (T*)o, s_out, H,
      T_len, rst, kst, vst, wst, ost);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const float* lw, const float* u, const float* s0, void* o,
               float* s_out, int B, int H, int T_len, Strides rst,
               Strides kst, Strides vst, Strides wst, Strides ost,
               cudaStream_t stream) {
  switch (N) {
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s0, o, s_out, B, H, T_len, rst,
                           kst, vst, wst, ost, stream);
    case 128:
      return launch<T, 128>(r, k, v, lw, u, s0, o, s_out, B, H, T_len, rst,
                            kst, vst, wst, ost, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, o: (B, H, T, N) in one dtype (is_bf16 ? bf16 : fp32), log_w:
// (B, H, T, N) fp32, each addressed by its (batch, head, token) element
// strides with a contiguous channel dim; u: (H, N) fp32 contiguous; s0
// (may be null: zero state) and s_out: (B, H, N, N) fp32 contiguous.
// N must be 64 or 128.  Launches on `stream`; returns cudaGetLastError().
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* log_w, const float* u, const float* s0,
                        void* o, float* s_out, int is_bf16, int B, int H,
                        int T_len, int N, int64_t r_sb, int64_t r_sh,
                        int64_t r_st, int64_t k_sb, int64_t k_sh,
                        int64_t k_st, int64_t v_sb, int64_t v_sh,
                        int64_t v_st, int64_t w_sb, int64_t w_sh,
                        int64_t w_st, int64_t o_sb, int64_t o_sh,
                        int64_t o_st, void* stream) {
  if (B <= 0 || H <= 0 || T_len < 0) return (int)cudaErrorInvalidValue;
  const Strides rst{r_sb, r_sh, r_st}, kst{k_sb, k_sh, k_st},
      vst{v_sb, v_sh, v_st}, wst{w_sb, w_sh, w_st}, ost{o_sb, o_sh, o_st};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, log_w, u, s0, o, s_out, B,
                                     H, T_len, rst, kst, vst, wst, ost, s);
  return dispatch_n<float>(N, r, k, v, log_w, u, s0, o, s_out, B, H, T_len,
                           rst, kst, vst, wst, ost, s);
}
