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
// stands in the way is the chain along time.  The first version walked all
// of time in one thread per (batch, channel): at (1, 3055, 2560) that is
// 20 blocks of 128 threads on 132 SMs, each thread 3055 dependent fmaf, and
// it took 0.30 ms against a 0.028 ms bound (PERF.md, PR 12, NVIDIA H100
// 80GB HBM3 at 700 W).  This version cuts time into chunks of C steps and
// scans in two passes, so B * ceil(S / C) * ceil(W / 128) blocks run at
// once (480 at that shape with C = 128) and no chain is longer than
// C + S / C steps:
//   * pass 1 (lru_chunk_summary): each (batch, chunk, channel) composes its
//     chunk into one affine step, A_c = prod a and H_c = the chunk's scan
//     from 0, written to a (2, B, n_chunks, W) scratch the wrapper
//     allocates;
//   * pass 2 (lru_chunk_scan): each (batch, chunk, channel) folds the
//     summaries of the chunks before it, in order, into its carry-in,
//     starting from h0 (or 0), then re-runs its chunk from that carry-in
//     and writes h; the last chunk writes h_last;
//   * a and b are read twice, so the kernel moves ~20 bytes per element
//     against the bound's 12;
//   * neighbouring threads take neighbouring channels, so every load and
//     store of a warp is one coalesced 128-byte line, and loads (which do
//     not depend on h) are issued kUnroll steps ahead;
//   * no atomics and no flags between blocks, and one fixed order: the
//     result is bit-identical from run to run.  It differs from the
//     sequential order by fp32 rounding only (the products of a are taken
//     per chunk);
//   * any S and W: the ragged edges are masked here, the wrapper pads
//     nothing (the TPU wrapper pads to 8 x 128 x 128 tiles with a = 0).
//
// The backward (lru_scan_bwd, no Pallas counterpart: JAX differentiates
// its associative scan) is the same recurrence run backward in time with
// a shifted by one step: g_t = dh_t + a_{t+1} g_{t+1} from g past the end
// = dh_last, then db_t = g_t, da_t = g_t h_{t-1} (h before the first step
// = h0, or 0) and dh0 = a_1 g_1.  It reuses the two passes over chunks of
// C steps with time read in reverse (the summary of a chunk composes its
// steps from its last to its first; the carry-in of chunk c folds the
// summaries of chunks n-1 .. c+1), and reads the h the forward returned in
// fp32.  It moves a, dh read twice, h read once, da and db written: ~24
// bytes an element against the bound's 20.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

// the steps [t0, t1) of one channel from state hv; with Write, h is stored
// at every step; with Prod, the product of a is kept in *prod
template <bool Write, bool Prod>
__device__ __forceinline__ float run_chunk(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float* __restrict__ h, size_t base,
                                           int W, int t0, int t1, float hv,
                                           float* prod) {
  float ap = 1.f;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      av[j] = a[base + (size_t)(t + j) * W];
      bv[j] = b[base + (size_t)(t + j) * W];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      hv = fmaf(av[j], hv, bv[j]);
      if (Prod) ap *= av[j];
      if (Write) h[base + (size_t)(t + j) * W] = hv;
    }
  }
  for (; t < t1; ++t) {
    const size_t i = base + (size_t)t * W;
    const float at = a[i];
    hv = fmaf(at, hv, b[i]);
    if (Prod) ap *= at;
    if (Write) h[i] = hv;
  }
  if (Prod) *prod = ap;
  return hv;
}

// pass 1: summary (A_c, H_c) of chunk blockIdx.y of batch blockIdx.z; the
// last of the n chunks needs none
__global__ void __launch_bounds__(kThreads)
lru_chunk_summary(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ sA, float* __restrict__ sH, int S,
                  int W, int chunk, int n) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, bi = blockIdx.z;
  if (w >= W) return;
  const size_t base = (size_t)bi * S * W + w;
  const int t0 = c * chunk, t1 = min(t0 + chunk, S);
  float prod;
  const float hc = run_chunk<false, true>(a, b, nullptr, base, W, t0, t1,
                                          0.f, &prod);
  const size_t i = ((size_t)bi * n + c) * W + w;
  sA[i] = prod;
  sH[i] = hc;
}

// pass 2: carry-in from h0 and the summaries of chunks 0..c-1, then the
// chunk itself with h written
__global__ void __launch_bounds__(kThreads)
lru_chunk_scan(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ h0, const float* __restrict__ sA,
               const float* __restrict__ sH, float* __restrict__ h,
               float* __restrict__ h_last, int S, int W, int chunk,
               int n) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, bi = blockIdx.z;
  if (w >= W) return;
  float hv = h0 ? h0[(size_t)bi * W + w] : 0.f;
  const size_t sbase = (size_t)bi * n * W + w;
  for (int j = 0; j < c; ++j)
    hv = fmaf(sA[sbase + (size_t)j * W], hv, sH[sbase + (size_t)j * W]);
  const size_t base = (size_t)bi * S * W + w;
  const int t0 = c * chunk, t1 = min(t0 + chunk, S);
  hv = run_chunk<true, false>(a, b, h, base, W, t0, t1, hv, nullptr);
  if (c == n - 1) h_last[(size_t)bi * W + w] = hv;
}

// the reverse steps t = t1 - 1 .. t0 of one channel from carry g: the
// coefficient of step t is a_{t+1} (1 at t = S - 1, where the carry is
// dh_last); with Write, db = g and da = g h_{t-1} are stored; with Prod,
// the product of the coefficients is kept in *prod
template <bool Write, bool Prod>
__device__ __forceinline__ float run_chunk_rev(
    const float* __restrict__ a, const float* __restrict__ dh,
    const float* __restrict__ h, const float* __restrict__ h0,
    float* __restrict__ da, float* __restrict__ db, size_t base, int W,
    int S, int t0, int t1, float g, float* prod) {
  float ap = 1.f;
  int t = t1 - 1;
  for (; t - kUnroll + 1 >= t0; t -= kUnroll) {
    float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int tj = t - j;
      av[j] = tj + 1 < S ? a[base + (size_t)(tj + 1) * W] : 1.f;
      dv[j] = dh[base + (size_t)tj * W];
      if (Write)
        hv[j] = tj > 0 ? h[base + (size_t)(tj - 1) * W] : (h0 ? *h0 : 0.f);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      g = fmaf(av[j], g, dv[j]);
      if (Prod) ap *= av[j];
      if (Write) {
        const size_t i = base + (size_t)(t - j) * W;
        db[i] = g;
        da[i] = g * hv[j];
      }
    }
  }
  for (; t >= t0; --t) {
    const size_t i = base + (size_t)t * W;
    const float at = t + 1 < S ? a[i + W] : 1.f;
    g = fmaf(at, g, dh[i]);
    if (Prod) ap *= at;
    if (Write) {
      db[i] = g;
      da[i] = g * (t > 0 ? h[i - W] : (h0 ? *h0 : 0.f));
    }
  }
  if (Prod) *prod = ap;
  return g;
}

// backward pass 1: the summary of chunk blockIdx.y over its reverse steps;
// the first chunk needs none
__global__ void __launch_bounds__(kThreads)
lru_bwd_chunk_summary(const float* __restrict__ a,
                      const float* __restrict__ dh, float* __restrict__ sA,
                      float* __restrict__ sG, int S, int W, int chunk,
                      int n) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y + 1, bi = blockIdx.z;
  if (w >= W) return;
  const size_t base = (size_t)bi * S * W + w;
  const int t0 = c * chunk, t1 = min(t0 + chunk, S);
  float prod;
  const float gc = run_chunk_rev<false, true>(a, dh, nullptr, nullptr,
                                              nullptr, nullptr, base, W, S,
                                              t0, t1, 0.f, &prod);
  const size_t i = ((size_t)bi * n + c) * W + w;
  sA[i] = prod;
  sG[i] = gc;
}

// backward pass 2: carry-in from dh_last and the summaries of chunks
// n-1 .. c+1, then the chunk itself with da and db written; chunk 0 writes
// dh0
__global__ void __launch_bounds__(kThreads)
lru_bwd_chunk_scan(const float* __restrict__ a, const float* __restrict__ h,
                   const float* __restrict__ h0,
                   const float* __restrict__ dh,
                   const float* __restrict__ dh_last,
                   const float* __restrict__ sA,
                   const float* __restrict__ sG, float* __restrict__ da,
                   float* __restrict__ db, float* __restrict__ dh0, int S,
                   int W, int chunk, int n) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, bi = blockIdx.z;
  if (w >= W) return;
  float g = dh_last ? dh_last[(size_t)bi * W + w] : 0.f;
  const size_t sbase = (size_t)bi * n * W + w;
  for (int j = n - 1; j > c; --j)
    g = fmaf(sA[sbase + (size_t)j * W], g, sG[sbase + (size_t)j * W]);
  const size_t base = (size_t)bi * S * W + w;
  const float* h0p = h0 ? h0 + (size_t)bi * W + w : nullptr;
  const int t0 = c * chunk, t1 = min(t0 + chunk, S);
  g = run_chunk_rev<true, false>(a, dh, h, h0p, da, db, base, W, S, t0, t1,
                                 g, nullptr);
  if (c == 0 && dh0) dh0[(size_t)bi * W + w] = a[base] * g;
}

}  // namespace

// a, b, h: (B, S, W) fp32 contiguous, S >= 1; h0 (may be null: zero state)
// and h_last: (B, W) fp32 contiguous; scratch: 2 * B * ceil(S / chunk) * W
// fp32.  Launches both passes on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int lru_scan_fwd(const float* a, const float* b, const float* h0,
                            float* h, float* h_last, float* scratch, int B,
                            int S, int W, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || chunk <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n = (S + chunk - 1) / chunk;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  float* sA = scratch;
  float* sH = scratch + (size_t)B * n * W;
  const int wblocks = (W + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 1) {
    lru_chunk_summary<<<dim3(wblocks, n - 1, B), kThreads, 0, s>>>(
        a, b, sA, sH, S, W, chunk, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  lru_chunk_scan<<<dim3(wblocks, n, B), kThreads, 0, s>>>(
      a, b, h0, sA, sH, h, h_last, S, W, chunk, n);
  return (int)cudaGetLastError();
}

// Backward of lru_scan_fwd.  a, h, dh, da, db: (B, S, W) fp32 contiguous,
// S >= 1 (h the forward's output); h0 (may be null: zero state), dh_last
// (may be null: zero) and dh0 (may be null: not wanted): (B, W) fp32
// contiguous; scratch: 2 * B * ceil(S / chunk) * W fp32.  Launches both
// passes on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int lru_scan_bwd(const float* a, const float* h, const float* h0,
                            const float* dh, const float* dh_last,
                            float* da, float* db, float* dh0,
                            float* scratch, int B, int S, int W, int chunk,
                            void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || chunk <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n = (S + chunk - 1) / chunk;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  float* sA = scratch;
  float* sG = scratch + (size_t)B * n * W;
  const int wblocks = (W + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 1) {
    lru_bwd_chunk_summary<<<dim3(wblocks, n - 1, B), kThreads, 0, s>>>(
        a, dh, sA, sG, S, W, chunk, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  lru_bwd_chunk_scan<<<dim3(wblocks, n, B), kThreads, 0, s>>>(
      a, h, h0, dh, dh_last, sA, sG, da, db, dh0, S, W, chunk, n);
  return (int)cudaGetLastError();
}
