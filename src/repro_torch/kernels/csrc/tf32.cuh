// Split-TF32 building blocks of the fp32 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): fp32 products on the
// tensor cores at fp32 accuracy ("3xTF32").
//
// One TF32 product keeps 10 of an operand's 23 mantissa bits (~5e-4
// relative), which breaks the fp32 limit (2e-4).  Each operand is split
// instead, x = hi + lo, and a product is taken as a_lo b_hi + a_hi b_lo +
// a_hi b_hi into fp32 accumulators (the small terms first); the lo*lo term
// (~2^-22 relative) is dropped.
//   * hi = tf32(x), rounded to nearest, ties away from zero: the result of
//     cvt.rna.tf32.f32, so hi is a TF32 value and the tensor core's reading
//     of it (the top 19 bits) is exact.  It is computed by two integer ops,
//     (bits + 0x1000) & ~0x1FFF: ptxas expands cvt.rna.tf32.f32 into those
//     two behind an FSETP that keeps NaN and inf out of the add, and the
//     bits are the same for every input but a NaN (chip_smoke.py compares
//     the two over all 2^32 patterns).  Attention's operands are finite;
//     a NaN operand still gives NaN, through lo.
//   * lo = x - hi, exact in fp32 (at most 13 significant bits), passed as
//     it is: the tensor core reads its top 19 bits, a truncation that costs
//     at most 2^-10 of lo, under 2^-21 of x, the order of the dropped lo*lo
//     term.  Rounding lo as well took 2 more ops an element and moved no
//     error the card checks print (PERF.md).
// ref.split_tf32_einsum is this arithmetic on the CPU.
//
// The products are mma.sync.m16n8k8 (tf32 x tf32 -> f32) on fragments a
// warp loads from shared memory by hand.  Tiles sit in shared memory as
// row-major fp32 with rows padded to D + 4 floats; every operand is split
// in registers as its fragment is loaded, so shared memory holds each tile
// once (a 64 x 256 fp32 tile is already 65 KB) and is read once a fragment.
// With the 4-float pad both fragment patterns below hit 32 distinct banks.
// sm_80 and up (mma.sync tf32, cp.async).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x rounded to TF32 (8-bit exponent, 10-bit mantissa) to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds any x but a NaN: a float
// whose low 13 mantissa bits are 0 (a carry into the exponent is the
// rounding up it should be, up to inf past the largest value)
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// cvt.rna.tf32.f32 itself, for the card's check of rna
__device__ __forceinline__ uint32_t cvt_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A (16 x 8) and B (8 x 8) fragments of mma.m16n8k8, split.  Lane (g, t) =
// (lane / 4, lane % 4) holds A's rows g and g + 8 at columns t and t + 4
// (registers 0..3: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)), B's
// column g at rows t and t + 4, and the accumulator's rows g and g + 8 at
// columns 2t and 2t + 1 ((g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// A from a row-major tile (rows M, contiguous K): x points at (m0, k0)
__device__ __forceinline__ void load_a(FragA& a, const float* x, int ld,
                                       int g, int t) {
  split(x[g * ld + t], a.hi[0], a.lo[0]);
  split(x[(g + 8) * ld + t], a.hi[1], a.lo[1]);
  split(x[g * ld + t + 4], a.hi[2], a.lo[2]);
  split(x[(g + 8) * ld + t + 4], a.hi[3], a.lo[3]);
}

// B from a row-major tile of B^T (rows N, contiguous K: K against Q K^T):
// x points at (n0, k0)
__device__ __forceinline__ void load_bt(FragB& b, const float* x, int ld,
                                        int g, int t) {
  split(x[g * ld + t], b.hi[0], b.lo[0]);
  split(x[g * ld + t + 4], b.hi[1], b.lo[1]);
}

// A from an accumulator's 8 columns c (the scores of 8 keys, P or dS), for
// a product over those columns.  The accumulator holds columns 2t and
// 2t + 1 where A wants t and t + 4, so the K order is permuted instead of
// the registers: A's column t is the accumulator's 2t, t + 4 its 2t + 1,
// and load_bn reads B's rows in the same order.  No shuffles.
__device__ __forceinline__ void acc_as_a(FragA& a, const float (&c)[4]) {
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
}

// B from a row-major tile (rows K, contiguous N: V against P V), its rows
// in acc_as_a's order: x points at (k0, n0)
__device__ __forceinline__ void load_bn(FragB& b, const float* x, int ld,
                                        int g, int t) {
  split(x[2 * t * ld + g], b.hi[0], b.lo[0]);
  split(x[(2 * t + 1) * ld + g], b.hi[1], b.lo[1]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tensor cores truncate the sums they accumulate (they do not round
// to nearest), so an accumulator that takes thousands of mma steps drifts:
// a dK summed over 10 heads x 2048 queries in one register set strayed to
// 1.6e-4 of the fp32 limit's 2e-4.  Products over a long dim (P V, dS K,
// P^T dO, dS^T Q) therefore sum each tile's steps in a fresh accumulator
// and add it to the running one in fp32 (mma_acc); products over the head
// dim (S, dP: at most 96 steps) accumulate in place (mma_step).  Each step
// issues its three products across independent accumulators in turn, so
// that no mma waits on the one before it.

// s (16 x 8 NB) += a (16 x 8) b, b (8 x 8 NB) the transpose of rows
// [0, 8 NB) of a row-major tile x at its column 0 (K against S = Q K^T)
template <int NB>
__device__ __forceinline__ void mma_step(float (&s)[NB][4], const FragA& a,
                                         const float* x, int ld, int g,
                                         int t) {
  FragB b[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) load_bt(b[n], x + n * 8 * ld, ld, g, t);
#pragma unroll
  for (int n = 0; n < NB; ++n) mma(s[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < NB; ++n) mma(s[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < NB; ++n) mma(s[n], a.hi, b[n].hi);
}

// the A fragments of a product over an accumulator's 8 KK columns
template <int KK>
__device__ __forceinline__ void acc_as_a(FragA (&a)[KK],
                                         const float (&c)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) acc_as_a(a[kk], c[kk]);
}

// acc (16 x 8 N8) += a (16 x 8 KK) b, b rows [0, 8 KK) of a row-major tile
// x (V against P V), in acc_as_a's K order: four output tiles at a time,
// their KK steps summed in a fresh accumulator that is then added to acc
template <int KK, int N8>
__device__ __forceinline__ void mma_acc(float (&acc)[N8][4],
                                        const FragA (&a)[KK], const float* x,
                                        int ld, int g, int t) {
  static_assert(N8 % 4 == 0, "output tiles in fours");
#pragma unroll
  for (int n0 = 0; n0 < N8; n0 += 4) {
    float tmp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      FragB b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_bn(b[j], x + kk * 8 * ld + (n0 + j) * 8, ld, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(tmp[j], a[kk].lo, b[j].hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(tmp[j], a[kk].hi, b[j].lo);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(tmp[j], a[kk].hi, b[j].hi);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[n0 + j][r] += tmp[j][r];
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits until at most N committed copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a (seq, D) fp32 slab (row stride ss elements;
// base and stride 16-byte aligned: the wrapper copies what is not) into a
// row-major tile of leading dim D + 4, by the block's THREADS threads, 16
// bytes a copy; rows at or past n arrive as zeros
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t ss, int r0, int n) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (D + 4) + 4 * c,
               ok ? src + (int64_t)(r0 + r) * ss + 4 * c : src, ok);
  }
}

}  // namespace tf32
