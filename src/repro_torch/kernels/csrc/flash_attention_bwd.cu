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
//   dS    = P o (dO V^T - delta)
//   dQ    = dS K * scale,   dK = dS^T Q * scale
// with the forward's masks: causal (q_pos >= k_pos), optionally within
// `window` (q_pos - k_pos < window), or none.
//
// Three kernels on the caller's stream, no atomics, one visiting order, so
// the result is bit-identical from run to run (the ROADMAP's determinism
// rule):
//   1. flash_bwd_delta: delta per query row, one warp a row;
//   2. flash_bwd_dkdv: a block owns 64 keys of one (batch, KV head); it
//      loops over the H / KV query heads of its group and over the query
//      tiles the mask admits, recomputes S^T and dP^T = V dO^T, and keeps
//      dK and dV in registers until it writes each once;
//   3. flash_bwd_dq: a block owns 64 query rows of one (batch, head); it
//      loops over the KV tiles the mask admits and keeps dQ in registers.
// Tiles outside the causal band or the window are never visited.
//
// What bounds it on the H100: five products of 2 B H S^2 D flop, halved by
// causality, about 172 GFLOP at olmo-1b's (4, 16, 16, 2048, 128): 0.174 ms
// at the 989 TFLOP/s bf16 tensor-core peak, over the 0.080 ms its ~268 MB
// of bytes take.  This first version is SIMT: every product runs on the
// fp32 FMA pipes (67 TFLOP/s peak) from shared memory, each thread a
// 4 x 4 score tile and a 4 x D/16 accumulator in registers, so a
// shared-memory read feeds 2-2.7 FMAs, and it recomputes S and dP in both
// passes (seven products for five).  Inputs are fp32 or bf16, staged into
// shared memory as fp32; all arithmetic is fp32; the gradients are written
// in the input's dtype.  The tensor-core version (wgmma, TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  int64_t b, h, s;  // elements; the head dim is contiguous
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

constexpr int kB = 64;           // rows of a query tile and of a key tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = 4;         // tile rows per thread (16 * 4 = kB)
constexpr int kCols = kB / 16;   // tile columns per thread

template <int D>
struct Cfg {
  static constexpr int kLd = D + 1;      // padded fp32 row of a staged tile
  static constexpr int kPld = kB + 4;    // padded row of a P or dS tile
  static constexpr int kOcols = D / 16;  // accumulator columns per thread
  // dK/dV: K, V, Q, dO, P^T, dS^T, lse, delta
  static constexpr size_t kSmemKV =
      sizeof(float) * (4 * kB * kLd + 2 * kB * kPld + 2 * kB);
  // dQ: Q, dO, K, V, dS, lse, delta
  static constexpr size_t kSmemQ =
      sizeof(float) * (4 * kB * kLd + kB * kPld + 2 * kB);
};

__device__ __forceinline__ bool admitted(int qi, int kj, int Sq, int Sk,
                                         int causal, int window) {
  return qi < Sq && kj < Sk && (!causal || qi >= kj) &&
         (window <= 0 || qi - kj < window);
}

// rows [r0, r0 + kB) of a (seq, D) slab into a padded fp32 tile; rows past
// `n` are zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t ss,
                                      int r0, int n) {
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * Cfg<D>::kLd + d] = r0 + r < n ? ld(src + (r0 + r) * ss + d) : 0.f;
  }
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

// dK and dV of 64 keys of one (batch, KV head)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int group,
               int Sq, int Sk, int causal, int window, float scale,
               Strides qst, Strides kst, Strides vst, Strides dost,
               Strides dkst, Strides dvst) {
  using C = Cfg<D>;
  constexpr int L = C::kLd, PL = C::kPld, OC = C::kOcols;
  extern __shared__ float smem[];
  float* Ks = smem;           // [kB][L]
  float* Vs = Ks + kB * L;    // [kB][L]
  float* Qs = Vs + kB * L;    // [kB][L]
  float* dOs = Qs + kB * L;   // [kB][L]
  float* Pt = dOs + kB * L;   // [kB keys][PL]
  float* dSt = Pt + kB * PL;  // [kB keys][PL]
  float* lse_s = dSt + kB * PL;
  float* dl_s = lse_s + kB;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int KV = H / group;
  const int b = blockIdx.x / KV, hk = blockIdx.x % KV;
  const int k0 = blockIdx.y * kB;  // key tile 0 sees the most queries: first

  stage<T, D>(Ks, k + b * kst.b + hk * kst.h, kst.s, k0, Sk);
  stage<T, D>(Vs, v + b * vst.b + hk * vst.h, vst.s, k0, Sk);

  float dka[kRows][OC], dva[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // the query tiles that see a key of this tile
  const int nq = (Sq + kB - 1) / kB;
  const int i_first = causal ? k0 / kB : 0;
  int i_end = nq;
  if (window > 0) i_end = min(nq, (min(k0 + kB, Sk) - 1 + window - 1) / kB + 1);

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const T* qb = q + b * qst.b + h * qst.h;
    const T* db = dout + b * dost.b + h * dost.h;
    const float* lb = lse + ((int64_t)b * H + h) * Sq;
    const float* deb = delta + ((int64_t)b * H + h) * Sq;
    for (int it = i_first; it < i_end; ++it) {
      const int q0 = it * kB;
      __syncthreads();  // the previous tile's reads are done
      stage<T, D>(Qs, qb, qst.s, q0, Sq);
      stage<T, D>(dOs, db, dost.s, q0, Sq);
      if (tid < kB) {
        const bool ok = q0 + tid < Sq;
        lse_s[tid] = ok ? lb[q0 + tid] : 0.f;
        dl_s[tid] = ok ? deb[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys ty*4+i, queries tx+16j
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kr[kRows], vr[kRows], qc[kCols], oc[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kr[i] = Ks[(ty * kRows + i) * L + d];
          vr[i] = Vs[(ty * kRows + i) * L + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qc[j] = Qs[(tx + 16 * j) * L + d];
          oc[j] = dOs[(tx + 16 * j) * L + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], oc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kr = ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int qr = tx + 16 * j;
          const float p =
              admitted(q0 + qr, k0 + kr, Sq, Sk, causal, window)
                  ? expf(fmaf(s[i][j], scale, -lse_s[qr]))
                  : 0.f;
          Pt[kr * PL + qr] = p;
          dSt[kr * PL + qr] = p * (dp[i][j] - dl_s[qr]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
      for (int qq = 0; qq < kB; ++qq) {
        float pv[kRows], sv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = Pt[(ty * kRows + i) * PL + qq];
          sv[i] = dSt[(ty * kRows + i) * PL + qq];
        }
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const float ov = dOs[qq * L + tx + 16 * c];
          const float qv = Qs[qq * L + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dva[i][c] = fmaf(pv[i], ov, dva[i][c]);
            dka[i][c] = fmaf(sv[i], qv, dka[i][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * dkst.b + hk * dkst.h;
  T* dvb = dv + b * dvst.b + hk * dvst.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty * kRows + i;
    if (kj >= Sk) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      st(dkb + kj * dkst.s + tx + 16 * c, dka[i][c] * scale);
      st(dvb + kj * dvst.s + tx + 16 * c, dva[i][c]);
    }
  }
}

// dQ of 64 query rows of one (batch, head)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int H, int group, int Sq, int Sk, int causal,
             int window, float scale, Strides qst, Strides kst, Strides vst,
             Strides dost, Strides dqst) {
  using C = Cfg<D>;
  constexpr int L = C::kLd, PL = C::kPld, OC = C::kOcols;
  extern __shared__ float smem[];
  float* Qs = smem;           // [kB][L]
  float* dOs = Qs + kB * L;   // [kB][L]
  float* Ks = dOs + kB * L;   // [kB][L]
  float* Vs = Ks + kB * L;    // [kB][L]
  float* dS = Vs + kB * L;    // [kB queries][PL]
  float* lse_s = dS + kB * PL;
  float* dl_s = lse_s + kB;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  // the last query tiles see the most keys under causal: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;

  stage<T, D>(Qs, q + b * qst.b + h * qst.h, qst.s, q0, Sq);
  stage<T, D>(dOs, dout + b * dost.b + h * dost.h, dost.s, q0, Sq);
  if (tid < kB) {
    const bool ok = q0 + tid < Sq;
    const int64_t row = ((int64_t)b * H + h) * Sq + q0 + tid;
    lse_s[tid] = ok ? lse[row] : 0.f;
    dl_s[tid] = ok ? delta[row] : 0.f;
  }
  const T* kb = k + b * kst.b + hk * kst.h;
  const T* vb = v + b * vst.b + hk * vst.h;

  float dqa[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dqa[i][c] = 0.f;

  int n_tiles = (Sk + kB - 1) / kB;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kB, Sq) - 1) / kB + 1);
  // the first key any row of this block may see is q0 - window + 1
  const int t_first = window > 0 ? max(q0 - window + 1, 0) / kB : 0;

  for (int t = t_first; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's reads are done
    stage<T, D>(Ks, kb, kst.s, k0, Sk);
    stage<T, D>(Vs, vb, vst.s, k0, Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries ty*4+i, keys tx+16j
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qr[kRows], orr[kRows], kc[kCols], vc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qr[i] = Qs[(ty * kRows + i) * L + d];
        orr[i] = dOs[(ty * kRows + i) * L + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kc[j] = Ks[(tx + 16 * j) * L + d];
        vc[j] = Vs[(tx + 16 * j) * L + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(orr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float p = admitted(q0 + r, k0 + c, Sq, Sk, causal, window)
                            ? expf(fmaf(s[i][j], scale, -lse_s[r]))
                            : 0.f;
        dS[r * PL + c] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K
    for (int kk = 0; kk < kB; ++kk) {
      float sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sv[i] = dS[(ty * kRows + i) * PL + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float kv = Ks[kk * L + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) dqa[i][c] = fmaf(sv[i], kv, dqa[i][c]);
      }
    }
  }

  T* dqb = dq + b * dqst.b + h * dqst.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c)
      st(dqb + qi * dqst.s + tx + 16 * c, dqa[i][c] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
           int causal, int window, float scale, const Strides* st,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const Strides &qst = st[0], &kst = st[1], &vst = st[2], &ost = st[3],
                &dost = st[4], &dqst = st[5], &dkst = st[6], &dvst = st[7];
  const int rows = B * H * Sq;
  flash_bwd_delta<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, rows, H, Sq, D, ost, dost);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::kSmemQ);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<T, D><<<dim3(B * H, (Sq + kB - 1) / kB), kThreads, C::kSmemQ,
                       stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, H, H / KV, Sq, Sk, causal, window, scale, qst, kst, vst, dost,
      dqst);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::kSmemKV);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<T, D><<<dim3(B * KV, (Sk + kB - 1) / kB), kThreads,
                         C::kSmemKV, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, H, H / KV, Sq, Sk, causal, window, scale, qst, kst,
      vst, dost, dkst, dvst);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int D, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
           int causal, int window, float scale, const Strides* st,
           cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                           KV, Sq, Sk, causal, window, scale, st, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                            KV, Sq, Sk, causal, window, scale, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, KV, Sk, D), each
// addressed by its (batch, head, seq) element strides, given in that order
// (q, k, v, o, dout, dq, dk, dv) as 24 int64 in `strides`, with a
// contiguous head dim; all of one dtype (is_bf16 ? bf16 : fp32).  lse:
// (B, H, Sq) fp32 contiguous, the forward's natural-log row log-sum-exp of
// the scaled scores; delta: (B, H, Sq) fp32 scratch.  D must be 64 or 128.
// Launches three kernels on `stream`; returns a CUDA error code (0 on
// success).
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
  if (is_bf16)
    return by_dim<__nv_bfloat16>(D, q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 B, H, KV, Sq, Sk, causal, window, scale, st,
                                 s);
  return by_dim<float>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV,
                       Sq, Sk, causal, window, scale, st, s);
}
