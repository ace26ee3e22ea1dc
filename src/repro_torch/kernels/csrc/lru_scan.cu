// Gated linear recurrence h_t = a_t * h_{t-1} + b_t (RG-LRU) on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan/kernel.py: _lru_kernel
//   (pallas_call in lru_scan_pallas).
// Same function, per (batch, channel), with the state in fp32: h comes out
// in fp32 (as the model keeps it before its cast to the compute dtype),
// with an optional entering state h0 and the last state h_last as a second
// output, as in src/repro/kernels/rglru_scan/ref.py.
//
// What bounds it on the H100: bytes.  Each element of a and b is read once
// and each h written once, 12 bytes for 2 flops; at the serve path's
// (1, S, 2560) fp32 that is 3 * S * 2560 * 4 bytes over 3.35 TB/s.  What
// stands in the way is the chain along time: a thread's next step needs its
// last.  What this design does:
//   * one thread per (batch, channel) walks time with h in a register;
//     neighbouring threads take neighbouring channels, so every load and
//     store of a warp is one coalesced 128-byte line;
//   * loads do not depend on h, so they are issued kUnroll time steps
//     ahead into registers: kUnroll loads of a and of b are in flight per
//     thread while the chain of fmaf runs over the previous ones;
//   * no associative-scan tree: the sequential order is the deterministic
//     one, and nothing uses atomics, so the result is bit-identical from run
//     to run;
//   * any S and W: the ragged edges are masked here, the wrapper pads
//     nothing (the TPU wrapper pads to 8 x 128 x 128 tiles with a = 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ h,
                float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)bi * S * W + w;
  float hv = h0 ? h0[(size_t)bi * W + w] : 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      av[j] = a[base + (size_t)(t + j) * W];
      bv[j] = b[base + (size_t)(t + j) * W];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      hv = fmaf(av[j], hv, bv[j]);
      h[base + (size_t)(t + j) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const size_t i = base + (size_t)t * W;
    hv = fmaf(a[i], hv, b[i]);
    h[i] = hv;
  }
  h_last[(size_t)bi * W + w] = hv;
}

}  // namespace

// a, b, h: (B, S, W) fp32 contiguous; h0 (may be null: zero state) and
// h_last: (B, W) fp32 contiguous.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int lru_scan_fwd(const float* a, const float* b, const float* h0,
                            float* h, float* h_last, int B, int S, int W,
                            void* stream) {
  if (B <= 0 || S < 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  lru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, b, h0, h,
                                                               h_last, S, W);
  return (int)cudaGetLastError();
}
