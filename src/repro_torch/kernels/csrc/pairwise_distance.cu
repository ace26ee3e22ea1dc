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
// So the design spends nothing on the Gram product and everything on
// writing the output once, coalesced:
//   * one block per 32 x 32 output tile, 32 x 8 threads, each thread
//     four outputs of one column;
//   * the tile's 32 row points and 32 column points are staged in shared
//     memory in chunks of 32 features (no padding of F to 128 as on the
//     TPU: the ragged feature edge is zero-filled in shared memory);
//   * the ragged N edge is masked at the store, so the wrapper pads nothing;
//   * each sum runs over the features in one fixed order with fmaf: no
//     atomics, the result is bit-identical from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;   // output tile edge
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTile / kRowsPerThread;   // 8
constexpr int kChunk = 32;  // features staged per pass (== blockDim.x)

__global__ void __launch_bounds__(kTile * kThreadsY)
pairwise_distance_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int n, int f) {
  __shared__ float xs[kTile][kChunk + 1];   // row points of the tile
  __shared__ float ys[kTile][kChunk + 1];   // column points of the tile
  const int tx = threadIdx.x;               // output column in the tile
  const int ty = threadIdx.y;               // first output row in the tile
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float gram[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float xsq[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float ysq = 0.f;

  for (int f0 = 0; f0 < f; f0 += kChunk) {
    const int c = f0 + tx;
    for (int i = ty; i < kTile; i += kThreadsY) {
      const int r = row0 + i;
      const int r2 = col0 + i;
      xs[i][tx] = (r < n && c < f) ? x[(int64_t)r * f + c] : 0.f;
      ys[i][tx] = (r2 < n && c < f) ? x[(int64_t)r2 * f + c] : 0.f;
    }
    __syncthreads();
    const int fe = min(kChunk, f - f0);
    for (int k = 0; k < fe; ++k) {
      const float yv = ys[tx][k];
      ysq = fmaf(yv, yv, ysq);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float xv = xs[ty + kThreadsY * j][k];
        gram[j] = fmaf(xv, yv, gram[j]);
        xsq[j] = fmaf(xv, xv, xsq[j]);
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= n) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = row0 + ty + kThreadsY * j;
    if (row < n) {
      const float d2 = xsq[j] + ysq - 2.f * gram[j];
      out[(int64_t)row * n + col] = sqrtf(fmaxf(d2, 0.f));
    }
  }
}

}  // namespace

// x: (n, f) fp32 row-major, out: (n, n) fp32 row-major, both on the device.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pairwise_distance_f32(const void* x, void* out, int n, int f,
                                     void* stream) {
  if (n <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTile, kThreadsY);
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  pairwise_distance_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, f);
  return (int)cudaGetLastError();
}
