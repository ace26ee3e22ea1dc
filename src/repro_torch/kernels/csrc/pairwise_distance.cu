// Pairwise Euclidean distances for CRCH's triplet clustering, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/pairwise_affinity/kernel.py: pairwise_distance_kernel
//   (pallas_call in pairwise_distance_pallas).
// Same function, same formula: D[i,j] = sqrt(max(|x_i|^2 + |x_j|^2
// - 2 <x_i, x_j>, 0)) with every sum in fp32 (no TF32).
//
// What bounds it on the H100: bytes.  The input is N x F fp32 with F <= ~10
// (kept PCA components), the output N x N fp32; 2*N*N*F flops against
// 4*N*N bytes written is ~F/2 flop per byte, far under the card's ridge.
// The bound is writing the output once, so the design spends nothing on the
// Gram product and everything on wide, coalesced stores:
//   * one block per 64 x 128 output tile, 256 threads; each thread owns an
//     8-row x 4-column register tile and stores each row's 4 columns as
//     one float4, so a warp writes 512 contiguous bytes of a row;
//   * the tile's 64 row points and 128 column points are staged in shared
//     memory, transposed (feature-major), in chunks of 16 features, so any
//     F works and a thread reads its points as float4s; the ragged feature
//     edge is never read (no padding of F to 128 as on the TPU);
//   * each point's squared norm is computed once per block, by one thread,
//     into shared memory;
//   * the ragged N edge is masked at the store (float4 where N % 4 == 0,
//     else element by element), so the wrapper pads nothing;
//   * each sum runs over the features in one fixed order with fmaf, the
//     norms in the same order as the Gram product, so the diagonal is
//     exactly 0; no atomics: the result is bit-identical from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // output rows a block
constexpr int kCols = 128;    // output columns a block
constexpr int kThreads = 256;
constexpr int kTR = 8;        // rows a thread
constexpr int kTC = 4;        // columns a thread (one float4)
constexpr int kChunk = 16;    // features staged per pass
static_assert(kThreads == (kRows / kTR) * (kCols / kTC), "thread tiling");

__global__ void __launch_bounds__(kThreads)
pairwise_distance_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int n, int f) {
  __shared__ __align__(16) float xs[kChunk][kRows];   // row points
  __shared__ __align__(16) float ys[kChunk][kCols];   // column points
  __shared__ __align__(16) float xn[kRows];            // squared norms
  __shared__ __align__(16) float yn[kCols];
  const int tid = threadIdx.x;
  const int tx = tid % (kCols / kTC);   // columns 4 tx .. 4 tx + 3
  const int ty = tid / (kCols / kTC);   // rows 8 ty .. 8 ty + 7
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;

  float gram[kTR][kTC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) gram[i][j] = 0.f;
  float sq = 0.f;   // thread p < 64: row point p; p < 192: column point

  for (int f0 = 0; f0 < f; f0 += kChunk) {
    const int fe = min(kChunk, f - f0);
    for (int e = tid; e < kChunk * kRows; e += kThreads) {
      const int p = e % kRows, c = e / kRows, r = row0 + p;
      xs[c][p] = (r < n && c < fe) ? x[(int64_t)r * f + f0 + c] : 0.f;
    }
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int p = e % kCols, c = e / kCols, r = col0 + p;
      ys[c][p] = (r < n && c < fe) ? x[(int64_t)r * f + f0 + c] : 0.f;
    }
    __syncthreads();
    if (tid < kRows) {
      for (int c = 0; c < fe; ++c) sq = fmaf(xs[c][tid], xs[c][tid], sq);
    } else if (tid < kRows + kCols) {
      const int p = tid - kRows;
      for (int c = 0; c < fe; ++c) sq = fmaf(ys[c][p], ys[c][p], sq);
    }
    for (int c = 0; c < fe; ++c) {
      const float4 xa = *reinterpret_cast<const float4*>(&xs[c][kTR * ty]);
      const float4 xb =
          *reinterpret_cast<const float4*>(&xs[c][kTR * ty + 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&ys[c][kTC * tx]);
      const float xv[kTR] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float yw[kTC] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) gram[i][j] = fmaf(xv[i], yw[j], gram[i][j]);
    }
    __syncthreads();
  }
  if (tid < kRows) {
    xn[tid] = sq;
  } else if (tid < kRows + kCols) {
    yn[tid - kRows] = sq;
  }
  __syncthreads();

  const int col = col0 + kTC * tx;
  if (col >= n) return;
  const float4 ysq = *reinterpret_cast<const float4*>(&yn[kTC * tx]);
  const float yq[kTC] = {ysq.x, ysq.y, ysq.z, ysq.w};
  const bool vec = (n % 4) == 0;   // then col + 3 < n and rows are aligned
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int row = row0 + kTR * ty + i;
    if (row >= n) break;
    const float xq = xn[kTR * ty + i];
    float d[kTC];
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const float d2 = xq + yq[j] - 2.f * gram[i][j];
      d[j] = sqrtf(fmaxf(d2, 0.f));
    }
    float* p = out + (int64_t)row * n + col;
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTC; ++j)
        if (col + j < n) p[j] = d[j];
    }
  }
}

}  // namespace

// x: (n, f) fp32 row-major, out: (n, n) fp32 row-major and 16-byte aligned,
// both on the device.  Launches on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int pairwise_distance_f32(const void* x, void* out, int n, int f,
                                     void* stream) {
  if (n <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  pairwise_distance_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, f);
  return (int)cudaGetLastError();
}
