// WKV6 linear recurrence (RWKV-6 "Finch" time mixing) on Hopper, as a
// chunk-parallel scan.
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
// What bounds it on the H100: bytes.  At the serve path's shape (B = 1,
// H = 40, N = 64, T ~ 370) the inputs are ~4 N elements a token and head and
// the work ~3 N^2 fp32 FMA a token and head (~0.36 GFLOP, ~5 us at the fp32
// SIMT rate, next to a ~3.8 us bytes bound).  A walk over the tokens is a
// dependent chain of T steps on only B * H blocks; this design cuts the
// chain into chunks of L = 16 tokens, as the Pallas kernel does, but treats
// the chunks in parallel and keeps only an N x N elementwise fold
// sequential.  With cum_t the in-chunk inclusive sum of log_w and
// P_t = exp(cum_t):
//   pass 1, one block per (b, h, chunk c), 4N threads, everything local to
//     the chunk: the decayed queries q_t = r_t * P_{t-1} (stored
//     transposed), the intra-chunk matrix A (A[t, j] = q_t . (k_j / P_j)
//     below the diagonal, the bonus r_t . (u * k_t) on it, 0 above; 4 x 4
//     register tiles, each summed over a quarter of the channels), the
//     chunk's decay d_c = exp(cum_L) and its state contribution
//     U_c = (k_j * exp(cum_L - cum_j))^T v (an L-deep outer-product sum, a
//     4 x 4 or 8 x 4 register tile a thread); all into a scratch the wrapper
//     allocates (U_c, q, A, d_c: wkv6_scratch_floats below, 21 MB at the
//     main path);
//   pass 2, one thread per (b, h, n, 4 columns m): S_0 = S0 (or 0), then in
//     chunk order S_{c+1} = d_c[n] S_c + U_c, each S_c stored over U_c as
//     the state entering chunk c, S_C written as the final state; loads run
//     a group of 16 chunks ahead of the stores.  The fold multiplies by a rounded decay
//     C = T / L times where the sequential form multiplies by one T times,
//     so with decays near 1 over thousands of tokens it drifts far less
//     (the card tests hold it against an fp64 evaluation);
//   pass 3, one block per (b, h, c), N threads, each a 4-token x 4-column
//     register tile of the output: o = q S_c + A v, with S_c, q and A
//     staged in shared memory by cp.async.
// The scratch's N x N states are most of the bytes the passes move (~75 MB
// at the main path against ~13 MB of inputs and outputs), so the passes
// are bound by that traffic more than by their arithmetic.
// All three passes are launched by the one C entry point below, so a call
// is one ctypes call; passes 2 and 3 are programmatic dependent launches,
// which hide the launch gap between the passes.  Tiles of r, k, v and
// log_w are read, and o written, with 16-byte (fp32) or 8-byte (bf16)
// accesses (the wrapper copies a view that is off that grid); the ragged
// last chunk is masked (k = 0, log_w = 0: the state passes through
// unchanged), so any T works and the wrapper pads nothing.  r, k, v and
// log_w are read through their (batch, head, token) strides, so the
// model's (B, T, H, N) projections are read in place and the output is
// written in the same layout.
//
// Domain: the factored form multiplies exp(cum) by exp(-cum), which stays
// inside fp32's range and keeps fp32 accuracy only while |cum| <= L * 2.5,
// i.e. for log_w in the model's clamp [-2.5, -1e-4]
// (models/rwkv6.py: _decay), as the Pallas kernel's note says for its
// 16-token chunks; exp(40) ~ 2.4e17 is the widest factor a chunk can see.
//
// Determinism: no atomics, and every sum runs in one fixed order with
// fmaf, so two calls give the same bits.
//
// The backward (wkv6_bwd below; no Pallas counterpart: JAX differentiates
// its chunked jnp form, src/repro/models/rwkv6.py) takes the forward's
// scratch, whose U part holds the state S_c entering each chunk after
// pass 2, so states inside a chunk are rebuilt from S_c by the factored
// decays and never by dividing a state by w.  With G^c the gradient of the
// state leaving chunk c and B[i, j] = do_i . v_j, it runs two passes:
//   bwd pass 1, the fold: a block of 256 threads owns 16 rows of one
//     (b, h)'s N x N gradient, a thread one row and 4 columns; in reverse
//     chunk order it stores G^c (G^{C-1} = dS, or 0) and folds
//     G^{c-1} = d_c G^c + V_c, dS0 = G^{-1}, with V_c = q^T do (an L-deep
//     sum, from the forward's q^T) formed as it goes: each chunk's q^T
//     rows, d_c and dO tile come into a ring of 8 chunks by cp.async, 7
//     chunks ahead of the fold.  V_c never touches memory;
//   bwd pass 2, one block per (b, h, c), a programmatic dependent of the
//     fold that loads S_c, r, k, v, dO, log_w and forms A and B before it
//     waits for G^c; three groups of N threads, each thread a 4-token x
//     4-channel register tile of one gradient:
//       dr_i = P_{i-1} (S_c do_i + sum_{j<i} B[i, j] k_j / P_j) + u k_i B_ii
//       dk_i = u r_i B_ii + exp(cum_L - cum_i) G^c v_i
//              + exp(-cum_i) sum_{j>i} B[j, i] q_j
//       dv_i = sum_{j>=i} A[j, i] do_j + kd_i G^c
//     (A the forward's intra-chunk matrix, recomputed).  S_c and G^c come
//     in by cp.async as they lie, row-major into rows padded to 68 floats:
//     S_c do_i and G^c v_i are row dots, each thread's four channels 16
//     apart so that a warp's 16 rows fall in distinct bank groups, and
//     kd_i G^c reads rows of G^c, so no tile is transposed.  Then, one
//     thread a channel, the decay's gradient
//       dlog_w_s = sum_{t>s} r_t dr'_t - sum_{t>=s} k_t dk'_t
//                  + rowsum(dS * S_T)
//     (dr', dk' without the bonus terms: the gradient of every in-chunk
//     log-decay sum, gathered; the form w_t rowsum(G_t * S_{t-1}) would
//     need every token's N x N state) as the chunk's own reverse sums plus
//     its carry, the pairs that cross the chunk's end:
//       rowsum(G^c * S_{c+1}) = d_c rowsum(G^c * S_c)
//                               + sum_i kd_i (G^c v_i),
//     all from the chunk's own tiles; and du's share of the chunk, which
//     the wrapper sums over chunks and the batch.  192 threads and 73 KB of
//     shared memory a block: three blocks an SM.  ptxas gives the fold 64
//     registers and the chunk pass 96, no spill.
// The five passes before it (V_c, the fold and the chunk pass through
// memory, then the carry and the decay) moved ~1.7 GB of N x N scratch at
// rwkv6-3b's training shape, (4, 40, 2048, 64), and the chunk pass copied
// S_c and G^c transposed, with 32-way bank conflicts: 2.83 ms a call
// (PERF.md, NVIDIA H100 80GB HBM3 at 700 W).  This one writes G^c once and
// reads S_c and G^c once, 1.0 GB of N x N scratch and ~1.6 GB in all
// (PERF.md gives each pass's time).
// ref.wkv6_backward_chunked is this arithmetic on the CPU.  It is exact in
// fp32 on the forward's domain (the clamp above); no atomics, one order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 16;     // tokens per chunk
constexpr int kFold = 16;  // chunks a group of pass 2's loads covers

// four consecutive elements, one 16-byte (fp32) or 8-byte (bf16) load
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

struct Strides {
  int64_t b, h, t;  // elements; the channel dim is contiguous
};

// dst[i * N + n] = src[(t0 + i) * st + n] in fp32 for i < len, 0 past it
template <typename T, int N>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t st, int t0, int len) {
  for (int e = threadIdx.x; e < kL * N / 4; e += blockDim.x) {
    const int i = e / (N / 4), n = (e % (N / 4)) * 4;
    const float4 x = i < len ? load4(src + (t0 + i) * st + n)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + i * N + n, x);
  }
}

__device__ __forceinline__ void fma4(float a, float4 b, float (&acc)[4]) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// The scratch of one call, in floats from its (16-byte aligned) base: U_c
// (then the entering states), q^T, A^T, d_c, each (B, H, C, ...).  Every
// part starts 16-byte aligned.
struct Scratch {
  float* U;
  float* qT;
  float* AT;
  float* dec;
};

Scratch split_scratch(float* base, int64_t chunks, int N) {
  Scratch s;
  s.U = base;
  s.qT = s.U + chunks * N * N;
  s.AT = s.qT + chunks * kL * N;
  s.dec = s.AT + chunks * kL * kL;
  return s;
}

// floats one chunk takes in the scratch: the parts above
int64_t chunk_scratch_floats(int N) {
  return (int64_t)N * N + kL * N + kL * kL + N;
}

// ---------------------------------------------------------------------------
// pass 1: everything local to one chunk.  4N threads.
// ---------------------------------------------------------------------------
constexpr int kQS = kL + 4;   // row stride of the transposed tiles: 4-way
                              // bank conflicts at most where a warp writes
                              // a column, 16-byte aligned rows
constexpr int kAP = 4;        // parts the intra-chunk matrix's sum over n
                              // is cut into

template <int N>
__host__ __device__ constexpr int prep_smem_bytes() {
  // r, k, v, log_w tiles, r * u * k, q^T and (k / P)^T, the totals
  return (5 * kL * N + 2 * N * kQS + N) * 4;
}

template <typename T, int N>
__global__ void __launch_bounds__(4 * N)
wkv6_chunk_prep(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ log_w,
                const float* __restrict__ u, Scratch sc, int H, int T_len,
                int C, Strides rst, Strides kst, Strides vst, Strides wst) {
  constexpr int TN = N / 16;
  constexpr int TL = kL / 4;    // 4 x 4 tiles of A along each side
  static_assert(kAP * kL * kL <= kL * N, "A's partial sums fit in r's tile");
  static_assert(kAP * TL * TL <= 4 * N, "one thread per tile and part");
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // r, then A's partial sums
  float* ks = rs + kL * N;                      // k, then k exp(cum_L - cum)
  float* vs = ks + kL * N;
  float* ws = vs + kL * N;                      // log_w, then cum
  float* ps = ws + kL * N;                      // r * u * k
  float* qTs = ps + kL * N;                     // qTs[n * kQS + t] = q_t[n]
  float* kTs = qTs + N * kQS;                   // kTs[n * kQS + j] = k_j / P_j
  float* tot = kTs + N * kQS;                   // cum_L
  const int bh = blockIdx.x / C, c = blockIdx.x % C;
  const int b = bh / H, h = bh % H;
  const int t0 = c * kL, len = min(kL, T_len - t0);
  const int64_t chunk = (int64_t)bh * C + c;
  load_tile<T, N>(rs, r + b * rst.b + h * rst.h, rst.t, t0, len);
  load_tile<T, N>(ks, k + b * kst.b + h * kst.h, kst.t, t0, len);
  load_tile<T, N>(vs, v + b * vst.b + h * vst.h, vst.t, t0, len);
  load_tile<float, N>(ws, log_w + b * wst.b + h * wst.h, wst.t, t0, len);
  __syncthreads();
  if (threadIdx.x < N) {   // one thread a channel: the in-chunk cumsum
    const int n = threadIdx.x;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      acc += ws[i * N + n];
      ws[i * N + n] = acc;
    }
    tot[n] = acc;
    sc.dec[chunk * N + n] = expf(acc);
  }
  __syncthreads();
  // elementwise over (t, n), n fastest: decayed queries, scaled keys, bonus
  for (int e = threadIdx.x; e < kL * N; e += 4 * N) {
    const int i = e / N, n = e % N;
    const float cum = ws[e], prev = i ? ws[e - N] : 0.f;
    const float rv = rs[e], kv = ks[e];
    qTs[n * kQS + i] = rv * expf(prev);
    kTs[n * kQS + i] = kv * expf(-cum);
    ps[e] = rv * u[h * N + n] * kv;
    ks[e] = kv * expf(tot[n] - cum);
  }
  __syncthreads();
  // A's 4 x 4 tiles on and below the diagonal, each summed over a quarter
  // of the channels into rs (parts, then columns j, then rows t); a tile on
  // the diagonal sums the bonus r_t . (u * k_t) in place of its diagonal
  if (threadIdx.x < kAP * TL * TL) {
    const int part = threadIdx.x / (TL * TL);
    const int tt = threadIdx.x / TL % TL, jj = threadIdx.x % TL;
    float a[4][4], bonus[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 4; ++x) a[x][0] = a[x][1] = a[x][2] = a[x][3] = 0.f;
    if (jj <= tt) {
#pragma unroll 4
      for (int n = part * (N / kAP); n < (part + 1) * (N / kAP); ++n) {
        const float4 q = *reinterpret_cast<const float4*>(qTs + n * kQS + 4 * tt);
        const float4 kk = *reinterpret_cast<const float4*>(kTs + n * kQS + 4 * jj);
        fma4(q.x, kk, a[0]);
        fma4(q.y, kk, a[1]);
        fma4(q.z, kk, a[2]);
        fma4(q.w, kk, a[3]);
        if (jj == tt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) bonus[x] += ps[(4 * tt + x) * N + n];
        }
      }
    }
    float* pa = rs + part * kL * kL;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int t = 4 * tt + x, j = 4 * jj + y;
        pa[j * kL + t] = j < t ? a[x][y] : (j == t ? bonus[x] : 0.f);
      }
    }
  }
  __syncthreads();
  // A^T[j, t] = A[t, j], the parts added in order
  float* ATg = sc.AT + chunk * kL * kL;
  for (int e = threadIdx.x; e < kL * kL; e += 4 * N) {
    float a = rs[e];
#pragma unroll
    for (int part = 1; part < kAP; ++part) a += rs[part * kL * kL + e];
    ATg[e] = a;
  }
  float4* qTg = reinterpret_cast<float4*>(sc.qT + chunk * kL * N);
  for (int e = threadIdx.x; e < kL * N / 4; e += 4 * N) {
    const int n = e / (kL / 4), t4 = e % (kL / 4);
    qTg[e] = *reinterpret_cast<const float4*>(qTs + n * kQS + 4 * t4);
  }
  // U_c: thread (gn, gm) owns rows n0 .. n0 + TN - 1, columns m .. m + 3
  const int n0 = (threadIdx.x / (N / 4)) * TN;
  const int m = (threadIdx.x % (N / 4)) * 4;
  float acc[TN][4];
#pragma unroll
  for (int i = 0; i < TN; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const float4 vv = *reinterpret_cast<const float4*>(vs + j * N + m);
#pragma unroll
    for (int i4 = 0; i4 < TN; i4 += 4) {
      const float4 kd =
          *reinterpret_cast<const float4*>(ks + j * N + n0 + i4);
      fma4(kd.x, vv, acc[i4]);
      fma4(kd.y, vv, acc[i4 + 1]);
      fma4(kd.z, vv, acc[i4 + 2]);
      fma4(kd.w, vv, acc[i4 + 3]);
    }
  }
  float* Ug = sc.U + chunk * N * N;
#pragma unroll
  for (int i = 0; i < TN; ++i)
    store4(Ug + (n0 + i) * N + m,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// Passes 2 and 3 are launched as programmatic dependents of the pass before
// them (below): their blocks may start while that pass drains, and wait
// here until it has finished and its writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// pass 2: the fold over chunks, one thread per (b, h, n, m .. m + 3).  The
// fold streams its states through memory, so the loads of each group of
// kFold chunks are issued, by hand, before the stores of the group before
// it: a group whose loads wait behind those stores waits out a memory
// round trip.
// ---------------------------------------------------------------------------
constexpr int kFoldThreads = 64;   // the fold has only B H N^2 / 4 threads
                                   // (40960 at the main path): small blocks
                                   // spread them over every SM

template <int N>
__global__ void __launch_bounds__(kFoldThreads)
wkv6_state_fold(float* __restrict__ U, const float* __restrict__ dec,
                const float* __restrict__ s0, float* __restrict__ s_out,
                int BH, int C) {
  constexpr int Q = N * N / 4;   // float4s in one state
  grid_dependency_wait();
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)BH * Q) return;
  const int64_t bh = e / Q;
  const int w = (int)(e % Q), n = w / (N / 4);
  float4 S = s0 ? reinterpret_cast<const float4*>(s0)[e]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* Ub = reinterpret_cast<float4*>(U) + bh * C * Q + w;
  const float* db = dec + bh * C * N + n;
  float4 uu[kFold], un[kFold];
  float dd[kFold], dn[kFold];
#pragma unroll
  for (int i = 0; i < kFold; ++i) {
    if (i < C) {
      uu[i] = Ub[(int64_t)i * Q];
      dd[i] = db[(int64_t)i * N];
    }
  }
  for (int c0 = 0; c0 < C; c0 += kFold) {
#pragma unroll
    for (int i = 0; i < kFold; ++i) {   // the next group
      const int c = c0 + kFold + i;
      if (c < C) {
        un[i] = Ub[(int64_t)c * Q];
        dn[i] = db[(int64_t)c * N];
      }
    }
#pragma unroll
    for (int i = 0; i < kFold; ++i) {
      if (c0 + i < C) {   // the state entering chunk c0 + i
        Ub[(int64_t)(c0 + i) * Q] = S;
        S.x = fmaf(dd[i], S.x, uu[i].x);
        S.y = fmaf(dd[i], S.y, uu[i].y);
        S.z = fmaf(dd[i], S.z, uu[i].z);
        S.w = fmaf(dd[i], S.w, uu[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < kFold; ++i) {
      uu[i] = un[i];
      dd[i] = dn[i];
    }
  }
  reinterpret_cast<float4*>(s_out)[e] = S;
}

// ---------------------------------------------------------------------------
// pass 3: outputs, o = q S_c + A v.  L N / 16 threads (N at L = 16);
// thread (g, m) owns tokens 4g .. 4g + 3 and columns m .. m + 3 of the
// chunk's output.
// ---------------------------------------------------------------------------
template <int N>
__host__ __device__ constexpr int out_threads() { return kL * N / 16; }

template <int N>
__host__ __device__ constexpr int out_smem_bytes() {
  // S_c, q^T, A^T, the v tile
  return (N * N + 2 * kL * N + kL * kL) * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

template <typename T, int N>
__global__ void __launch_bounds__(out_threads<N>())
wkv6_chunk_out(const T* __restrict__ v, Scratch sc, T* __restrict__ o,
               int H, int T_len, int C, Strides vst, Strides ost) {
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);  // the entering state
  float* qTs = Ss + N * N;
  float* ATs = qTs + kL * N;
  float* vs = ATs + kL * kL;
  const int bh = blockIdx.x / C, c = blockIdx.x % C;
  const int b = bh / H, h = bh % H;
  const int t0 = c * kL, len = min(kL, T_len - t0);
  const int64_t chunk = (int64_t)bh * C + c;
  load_tile<T, N>(vs, v + b * vst.b + h * vst.h, vst.t, t0, len);
  grid_dependency_wait();   // the fold's states (and pass 1's q, A)
  const float* Sg = sc.U + chunk * N * N;
  for (int e = threadIdx.x; e < N * N / 4; e += out_threads<N>())
    cp_async16(Ss + 4 * e, Sg + 4 * e);
  const float* qTg = sc.qT + chunk * kL * N;
  for (int e = threadIdx.x; e < kL * N / 4; e += out_threads<N>())
    cp_async16(qTs + 4 * e, qTg + 4 * e);
  const float* ATg = sc.AT + chunk * kL * kL;
  for (int e = threadIdx.x; e < kL * kL / 4; e += out_threads<N>())
    cp_async16(ATs + 4 * e, ATg + 4 * e);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int g = threadIdx.x / (N / 4), m = (threadIdx.x % (N / 4)) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    const float4 q = *reinterpret_cast<const float4*>(qTs + n * kL + 4 * g);
    const float4 s = *reinterpret_cast<const float4*>(Ss + n * N + m);
    fma4(q.x, s, acc[0]);
    fma4(q.y, s, acc[1]);
    fma4(q.z, s, acc[2]);
    fma4(q.w, s, acc[3]);
  }
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(ATs + j * kL + 4 * g);
    const float4 vv = *reinterpret_cast<const float4*>(vs + j * N + m);
    fma4(a.x, vv, acc[0]);
    fma4(a.y, vv, acc[1]);
    fma4(a.z, vv, acc[2]);
    fma4(a.w, vv, acc[3]);
  }
  T* ob = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * g + i;
    if (t >= len) break;
    store4(ob + (t0 + t) * ost.t + m,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// dynamic shared memory past the 48 KB default needs the kernel's opt-in
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// a launch that may begin before the stream's previous kernel has finished
// (programmatic dependent launch); the kernel waits for it itself
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned grid,
                             int block, int smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* o, float* s_out,
           float* scratch, int B, int H, int T_len, Strides rst,
           Strides kst, Strides vst, Strides wst, Strides ost,
           cudaStream_t stream) {
  const int C = (T_len + kL - 1) / kL;
  const int BH = B * H;
  const Scratch sc = split_scratch(scratch, (int64_t)BH * C, N);
  if (C > 0) {
    constexpr int smem = prep_smem_bytes<N>();
    cudaError_t err = allow_smem(wkv6_chunk_prep<T, N>, smem);
    if (err != cudaSuccess) return (int)err;
    wkv6_chunk_prep<T, N><<<BH * C, 4 * N, smem, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, lw, u, sc, H, T_len, C, rst,
        kst, vst, wst);
  }
  const int64_t fold_threads = (int64_t)BH * N * N / 4;
  cudaError_t err = launch_dependent(
      wkv6_state_fold<N>,
      (unsigned)((fold_threads + kFoldThreads - 1) / kFoldThreads),
      kFoldThreads, 0,
      stream, sc.U, (const float*)sc.dec, s0, s_out, BH, C);
  if (err != cudaSuccess) return (int)err;
  if (C > 0) {
    constexpr int smem = out_smem_bytes<N>();
    err = allow_smem(wkv6_chunk_out<T, N>, smem);
    if (err != cudaSuccess) return (int)err;
    err = launch_dependent(wkv6_chunk_out<T, N>, (unsigned)(BH * C),
                           out_threads<N>(), smem, stream, (const T*)v, sc,
                           (T*)o, H, T_len, C, vst, ost);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const float* lw, const float* u, const float* s0, void* o,
               float* s_out, float* scratch, int B, int H, int T_len,
               Strides rst, Strides kst, Strides vst, Strides wst,
               Strides ost, cudaStream_t stream) {
  switch (N) {
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s0, o, s_out, scratch, B, H,
                           T_len, rst, kst, vst, wst, ost, stream);
    case 128:
      return launch<T, 128>(r, k, v, lw, u, s0, o, s_out, scratch, B, H,
                            T_len, rst, kst, vst, wst, ost, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

// four elements of T from global to shared memory by cp.async (8 bytes for
// bf16, 16 for fp32); `valid` false fills zeros and reads nothing
template <typename T>
__device__ __forceinline__ void cp_async4(T* smem, const T* gmem, bool valid) {
  constexpr int kBytes = 4 * sizeof(T);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(gmem), "n"(kBytes), "r"(valid ? kBytes : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// bwd pass 1: the reverse fold of the state's gradient with V_c = q^T do
// formed as it goes, so that V_c never touches memory.  A block owns kFR
// rows of one (b, h)'s N x N gradient, a thread one row and 4 columns; in
// reverse chunk order it stores G^c (the gradient of the state leaving
// chunk c) and folds G^{c-1} = d_c G^c + V_c.  Each chunk's q^T rows
// (from the forward's scratch), d_c and dO tile come into a ring of
// kFStages stages by cp.async, kFStages - 1 chunks ahead of the fold.
constexpr int kFR = 16;       // rows of G a block owns
constexpr int kFStages = 8;   // the ring's depth in chunks

template <int N>
__host__ __device__ constexpr int fold_threads() { return kFR * N / 4; }

template <typename T, int N>
__host__ __device__ constexpr int fold_stage_floats() {
  // q^T rows [kFR][kL], d_c [kFR], the dO tile [kL][N] in T
  return kFR * kL + kFR + kL * N * (int)sizeof(T) / 4;
}

template <typename T, int N>
__global__ void __launch_bounds__(fold_threads<N>())
wkv6_bwd_fold(const T* __restrict__ dout, Scratch sc,
              const float* __restrict__ dS, float* __restrict__ G,
              float* __restrict__ dS0, int H, int T_len, int C,
              Strides dst) {
  constexpr int NT = fold_threads<N>(), SF = fold_stage_floats<T, N>();
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  // the chunk pass may start now: what it loads before its wait does not
  // depend on this pass
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int bh = blockIdx.x / (N / kFR), n0 = (blockIdx.x % (N / kFR)) * kFR;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int r = tid / (N / 4), m = (tid % (N / 4)) * 4;
  const T* db = dout + b * dst.b + h * dst.h;

  auto issue = [&](int c) {   // chunk c's copies into stage c % kFStages
    float* st = ring + (c % kFStages) * SF;
    const int64_t chunk = (int64_t)bh * C + c;
    const float* qg = sc.qT + chunk * kL * N + n0 * kL;
    for (int e = tid; e < kFR * kL / 4; e += NT)
      cp_async4(st + 4 * e, qg + 4 * e, true);
    if (tid < kFR / 4)
      cp_async4(st + kFR * kL + 4 * tid, sc.dec + chunk * N + n0 + 4 * tid,
                true);
    T* ds = reinterpret_cast<T*>(st + kFR * kL + kFR);
    const int t0 = c * kL, len = min(kL, T_len - t0);
    for (int e = tid; e < kL * N / 4; e += NT) {
      const int i = e / (N / 4), col = (e % (N / 4)) * 4;
      cp_async4(ds + i * N + col, i < len ? db + (t0 + i) * dst.t + col : db,
                i < len);
    }
  };

  const int64_t gi = ((int64_t)bh * N + n0 + r) * N + m;  // (b, h, n, m)
  float4 g = dS ? *reinterpret_cast<const float4*>(dS + gi)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < kFStages - 1; ++i) {
    if (C - 1 - i >= 0) issue(C - 1 - i);
    cp_async_commit();
  }
  for (int c = C - 1; c >= 0; --c) {
    if (c - (kFStages - 1) >= 0) issue(c - (kFStages - 1));
    cp_async_commit();
    cp_async_wait<kFStages - 1>();   // chunk c's copies have landed
    __syncthreads();
    const float* st = ring + (c % kFStages) * SF;
    *reinterpret_cast<float4*>(G + ((int64_t)bh * C + c) * N * N +
                               (n0 + r) * N + m) = g;
    // V_c[n][m .. m + 3] = sum_t q_t[n] do_t[m .. m + 3], t in order
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = st + r * kL;
    const T* ds = reinterpret_cast<const T*>(st + kFR * kL + kFR);
#pragma unroll
    for (int t4 = 0; t4 < kL; t4 += 4) {
      const float4 q = lds4(qr + t4);
      fma4(q.x, lds4(ds + (t4 + 0) * N + m), acc);
      fma4(q.y, lds4(ds + (t4 + 1) * N + m), acc);
      fma4(q.z, lds4(ds + (t4 + 2) * N + m), acc);
      fma4(q.w, lds4(ds + (t4 + 3) * N + m), acc);
    }
    const float d = st[kFR * kL + r];
    g.x = fmaf(d, g.x, acc[0]);
    g.y = fmaf(d, g.y, acc[1]);
    g.z = fmaf(d, g.z, acc[2]);
    g.w = fmaf(d, g.w, acc[3]);
    __syncthreads();   // the stage is free for the copies issued next
  }
  if (dS0) *reinterpret_cast<float4*>(dS0 + gi) = g;
}

// bwd pass 2: each chunk's gradients, with the decay's gradient whole and
// du's share of the chunk.  3 x (L N / 16) threads: group 0 computes dr,
// group 1 dk, group 2 dv; thread (gi, gx) of a group owns tokens
// 4 gi .. 4 gi + 3 and, for dr and dk, channels gx + 16 c (c < 4; the rows
// of S_c and G^c it reads are then 16 consecutive ones a warp, one bank
// group each), for dv columns 4 gx .. 4 gx + 3.
constexpr int kP = 68;   // row pitch of every [*][N] tile (N = 64) in floats:
                         // consecutive rows start 16 bytes apart mod 128

template <int N>
__host__ __device__ constexpr int grads_threads() { return 3 * kL * N / 16; }

template <int N>
__host__ __device__ constexpr int grads_smem_bytes() {
  // S_c, G^c; r, k, v, do, cum, q, k/P, kd (then r dr', k dk', kd G v);
  // A, the two masked B's, B's diagonal, u
  return (2 * N * kP + 8 * kL * kP + 3 * kL * kL + kL + N) * 4;
}

// an N x N fp32 matrix into [N][kP] rows by cp.async
template <int N>
__device__ __forceinline__ void copy_square(float* dst, const float* src) {
  for (int e = threadIdx.x; e < N * N / 4; e += grads_threads<N>()) {
    const int n = e / (N / 4), m = (e % (N / 4)) * 4;
    cp_async4(dst + n * kP + m, src + n * N + m, true);
  }
}

// the dot of two N-float rows: four partial sums, each in channel order,
// then (p0 + p1) + (p2 + p3)
template <int N>
__device__ __forceinline__ float dot_rows(const float* x, const float* y) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; n += 4) {
    const float4 a = lds4(x + n), b = lds4(y + n);
    a0 = fmaf(a.x, b.x, a0);
    a1 = fmaf(a.y, b.y, a1);
    a2 = fmaf(a.z, b.z, a2);
    a3 = fmaf(a.w, b.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

template <typename T, int N>
__global__ void __launch_bounds__(grads_threads<N>(), 3)
wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ log_w,
               const float* __restrict__ u, const T* __restrict__ dout,
               Scratch sc, const float* __restrict__ Gg,
               float* __restrict__ du_part, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dlw, int H, int T_len, int C,
               Strides rst, Strides kst, Strides vst, Strides wst,
               Strides dst, Strides drst, Strides dkst, Strides dvst,
               Strides dwst) {
  static_assert(N == 64, "the tiles' pitch and thread map are N = 64's");
  constexpr int NT = grads_threads<N>(), TL = kL * kP;
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);   // S_c[n][m]
  float* Gs = Ss + N * kP;                       // G^c[n][m]
  float* rs = Gs + N * kP;                       // [kL][kP] tiles
  float* ks = rs + TL;
  float* vs = ks + TL;
  float* dos = vs + TL;
  float* cs = dos + TL;                          // cum
  float* qs = cs + TL;                           // r_t P_{t-1}; then r dr'
  float* kps = qs + TL;                          // k_t / P_t; then k dk'
  float* kds = kps + TL;                         // k_t exp(cum_L - cum_t);
                                                 // then kd_t (G^c v_t)
  float* As = kds + TL;                          // As[j * L + i] = A[j][i]
  float* Bl = As + kL * kL;   // Bl[j * L + i] = j < i ? B[i][j] : 0
  float* Bu = Bl + kL * kL;   // Bu[j * L + i] = j > i ? B[j][i] : 0
  float* Bd = Bu + kL * kL;                      // B[i][i]
  float* us = Bd + kL;                           // u of the head
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / C, c = blockIdx.x % C;
  const int b = bh / H, h = bh % H;
  const int t0 = c * kL, len = min(kL, T_len - t0);
  const int64_t chunk = (int64_t)bh * C + c;

  // what does not depend on the fold: S_c, the tiles, A and B.  The
  // tiles' loads are all issued before their stores, one memory round trip
  copy_square<N>(Ss, sc.U + chunk * N * N);
  cp_async_commit();
  {
    const T* rb = r + b * rst.b + h * rst.h;
    const T* kb = k + b * kst.b + h * kst.h;
    const T* vb = v + b * vst.b + h * vst.h;
    const T* ob = dout + b * dst.b + h * dst.h;
    const float* wb = log_w + b * wst.b + h * wst.h;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int e0 = 0; e0 < kL * N / 4; e0 += NT) {
      const int e = e0 + tid;
      const int i = e / (N / 4), n = (e % (N / 4)) * 4;
      const bool ok = e < kL * N / 4 && i < len;
      const float4 xr = ok ? load4(rb + (t0 + i) * rst.t + n) : z;
      const float4 xk = ok ? load4(kb + (t0 + i) * kst.t + n) : z;
      const float4 xv = ok ? load4(vb + (t0 + i) * vst.t + n) : z;
      const float4 xo = ok ? load4(ob + (t0 + i) * dst.t + n) : z;
      const float4 xw = ok ? load4(wb + (t0 + i) * wst.t + n) : z;
      if (e < kL * N / 4) {
        store4(rs + i * kP + n, xr);
        store4(ks + i * kP + n, xk);
        store4(vs + i * kP + n, xv);
        store4(dos + i * kP + n, xo);
        store4(cs + i * kP + n, xw);
      }
    }
  }
  if (tid < N) us[tid] = u[h * N + tid];
  __syncthreads();
  if (tid < N) {   // the in-chunk cumsum of log_w, as the forward's
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      acc += cs[i * kP + tid];
      cs[i * kP + tid] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < kL * N; e += NT) {
    const int i = e / N, n = e % N, x = i * kP + n;
    const float cum = cs[x], prev = i ? cs[x - kP] : 0.f;
    const float tot = cs[(kL - 1) * kP + n];
    qs[x] = rs[x] * expf(prev);
    kps[x] = ks[x] * expf(-cum);
    kds[x] = ks[x] * expf(tot - cum);
  }
  __syncthreads();
  // A (strictly lower q_j . k_i/P_i, the bonus r_j . (u k_j) on the
  // diagonal, 0 above) and B[i][j] = do_i . v_j, each a dot in channel order
  for (int e = tid; e < 2 * kL * kL; e += NT) {
    const int i = e / kL % kL, j = e % kL;
    if (e < kL * kL) {   // A[i][j], stored as As[i * L + j]
      float a = 0.f;
      if (j < i) {
        a = dot_rows<N>(qs + i * kP, kps + j * kP);
      } else if (j == i) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          const float4 x = lds4(rs + i * kP + n), y = lds4(ks + i * kP + n),
                       w = lds4(us + n);
          a0 = fmaf(x.x * w.x, y.x, a0);
          a1 = fmaf(x.y * w.y, y.y, a1);
          a2 = fmaf(x.z * w.z, y.z, a2);
          a3 = fmaf(x.w * w.w, y.w, a3);
        }
        a = (a0 + a1) + (a2 + a3);
      }
      As[i * kL + j] = a;
    } else {             // B[i][j]
      const float bij = dot_rows<N>(dos + i * kP, vs + j * kP);
      Bl[j * kL + i] = j < i ? bij : 0.f;
      Bu[i * kL + j] = i > j ? bij : 0.f;
      if (i == j) Bd[i] = bij;
    }
  }
  grid_dependency_wait();   // the fold's G^c
  copy_square<N>(Gs, Gg + chunk * N * N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int grp = tid / (kL * N / 16), lt = tid % (kL * N / 16);
  const int i0 = (lt / 16) * 4, gx = lt % 16;
  float acc[4][4], acc2[4][4], keep[4][4], keep2[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[a][y] = acc2[a][y] = 0.f;
  // acc[a][y] += sum over m of X[i0 + a][m] M[gx + 16 y][m], m in order
  auto rowdot = [&](const float* X, const float* M) {
#pragma unroll 2
    for (int m = 0; m < N; m += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = lds4(X + (i0 + a) * kP + m);
#pragma unroll
      for (int w = 0; w < 4; ++w) y[w] = lds4(M + (gx + 16 * w) * kP + m);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          acc[a][w] = fmaf(x[a].x, y[w].x, acc[a][w]);
          acc[a][w] = fmaf(x[a].y, y[w].y, acc[a][w]);
          acc[a][w] = fmaf(x[a].z, y[w].z, acc[a][w]);
          acc[a][w] = fmaf(x[a].w, y[w].w, acc[a][w]);
        }
    }
  };
  // acc2[a][y] += sum over j of W[j][i0 + a] Y[j][gx + 16 y], j in order
  auto masked = [&](const float* W, const float* Y) {
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const float4 w = lds4(W + j * kL + i0);
      const float wa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const float yv = Y[j * kP + gx + 16 * y];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc2[a][y] = fmaf(wa[a], yv, acc2[a][y]);
      }
    }
  };
  if (grp == 0) {
    // dr_i = P_{i-1} (S_c do_i + sum_{j<i} B[i][j] k_j / P_j) + u k_i B_ii
    rowdot(dos, Ss);
    masked(Bl, kps);
  } else if (grp == 1) {
    // dk_i = exp(cum_L - cum_i) G^c v_i + exp(-cum_i) sum_{j>i} B[j][i] q_j
    //        + u r_i B_ii
    rowdot(vs, Gs);
    masked(Bu, qs);
  } else {
    // dv_i = kd_i G^c + sum_{j>=i} A[j][i] do_j; columns 4 gx ..
#pragma unroll 2
    for (int n = 0; n < N; n += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = lds4(kds + (i0 + a) * kP + n);
#pragma unroll
      for (int w = 0; w < 4; ++w) y[w] = lds4(Gs + (n + w) * kP + 4 * gx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float xa[4] = {x[a].x, x[a].y, x[a].z, x[a].w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          acc[a][0] = fmaf(xa[w], y[w].x, acc[a][0]);
          acc[a][1] = fmaf(xa[w], y[w].y, acc[a][1]);
          acc[a][2] = fmaf(xa[w], y[w].z, acc[a][2]);
          acc[a][3] = fmaf(xa[w], y[w].w, acc[a][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const float4 w = lds4(As + j * kL + i0);
      const float wa[4] = {w.x, w.y, w.z, w.w};
      const float4 dd = lds4(dos + j * kP + 4 * gx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc2[a][0] = fmaf(wa[a], dd.x, acc2[a][0]);
        acc2[a][1] = fmaf(wa[a], dd.y, acc2[a][1]);
        acc2[a][2] = fmaf(wa[a], dd.z, acc2[a][2]);
        acc2[a][3] = fmaf(wa[a], dd.w, acc2[a][3]);
      }
    }
  }
  // outputs, and what the epilogue sums: r dr' (group 0), k dk' and
  // kd (G^c v) (group 1), each kept until the tiles they replace are free
  const Strides ost = grp == 0 ? drst : grp == 1 ? dkst : dvst;
  T* ob = (grp == 0 ? dr : grp == 1 ? dk : dv) + b * ost.b + h * ost.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + a;
    if (grp == 2) {
      if (i < len)
        store4(ob + (t0 + i) * ost.t + 4 * gx,
               make_float4(acc[a][0] + acc2[a][0], acc[a][1] + acc2[a][1],
                           acc[a][2] + acc2[a][2], acc[a][3] + acc2[a][3]));
      continue;
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int n = gx + 16 * y, x = i * kP + n;
      float out;
      if (grp == 0) {
        const float prev = i ? cs[x - kP] : 0.f;
        const float nb = expf(prev) * (acc[a][y] + acc2[a][y]);
        keep[a][y] = rs[x] * nb;
        out = fmaf(us[n] * ks[x], Bd[i], nb);
      } else {
        const float tot = cs[(kL - 1) * kP + n], cum = cs[x];
        const float nb = fmaf(expf(tot - cum), acc[a][y],
                              expf(-cum) * acc2[a][y]);
        keep[a][y] = ks[x] * nb;
        keep2[a][y] = kds[x] * acc[a][y];
        out = fmaf(us[n] * rs[x], Bd[i], nb);
      }
      if (i < len) {
        T* p = ob + (t0 + i) * ost.t + n;
        if constexpr (sizeof(T) == 4) *p = out;
        else *p = __float2bfloat16_rn(out);
      }
    }
  }
  __syncthreads();   // q, k/P and kd are read no more
  if (grp < 2) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int x = (i0 + a) * kP + gx + 16 * y;
        if (grp == 0) {
          qs[x] = keep[a][y];
        } else {
          kps[x] = keep[a][y];
          kds[x] = keep2[a][y];
        }
      }
  }
  __syncthreads();
  // per channel: the decay's gradient, dlog_w_i = sum_{t>i} r dr' -
  // sum_{t>=i} k dk' over the chunk's tokens + the chunk's carry
  // rowsum(G^c * S_{c+1}) = d_c rowsum(G^c * S_c) + sum_i kd_i (G^c v_i);
  // and du's share of the chunk, sum_i r_i k_i B_ii
  if (tid < N) {
    const int n = tid;
    float cg = 0.f;
#pragma unroll
    for (int i = 0; i < kL; ++i) cg += kds[i * kP + n];
    const float carry = fmaf(expf(cs[(kL - 1) * kP + n]),
                             dot_rows<N>(Gs + n * kP, Ss + n * kP), cg);
    float sa = 0.f, sb = 0.f, du = 0.f;
    float* wb = dlw + b * dwst.b + h * dwst.h + n;
    for (int i = kL - 1; i >= 0; --i) {
      const int x = i * kP + n;
      sb += kps[x];
      if (i < len) wb[(t0 + i) * dwst.t] = (sa - sb) + carry;
      sa += qs[x];
      du = fmaf(rs[x] * ks[x], Bd[i], du);
    }
    du_part[chunk * N + n] = du;
  }
}

template <typename T, int N>
int launch_bwd(const void* r, const void* k, const void* v, const float* lw,
               const float* u, const void* dout, const float* dS,
               float* scratch, float* bscratch, void* dr, void* dk, void* dv,
               float* dlw, float* du_part, float* dS0, int B, int H,
               int T_len, Strides rst, Strides kst, Strides vst, Strides wst,
               Strides dst, Strides drst, Strides dkst, Strides dvst,
               Strides dwst, cudaStream_t stream) {
  const int C = (T_len + kL - 1) / kL;
  const int BH = B * H;
  const Scratch sc = split_scratch(scratch, (int64_t)BH * C, N);
  float* G = bscratch;   // (BH, C, N, N): the gradient leaving each chunk
  constexpr int fold_smem = kFStages * fold_stage_floats<T, N>() * 4;
  cudaError_t err = allow_smem(wkv6_bwd_fold<T, N>, fold_smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_fold<T, N><<<BH * (N / kFR), fold_threads<N>(), fold_smem,
                        stream>>>((const T*)dout, sc, dS, G, dS0, H, T_len,
                                  C, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = grads_smem_bytes<N>();
  err = allow_smem(wkv6_bwd_chunk<T, N>, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_dependent(wkv6_bwd_chunk<T, N>, (unsigned)(BH * C),
                         grads_threads<N>(), smem, stream, (const T*)r,
                         (const T*)k, (const T*)v, lw, u, (const T*)dout, sc,
                         (const float*)G, du_part, (T*)dr, (T*)dk, (T*)dv,
                         dlw, H, T_len, C, rst, kst, vst, wst, dst, drst,
                         dkst, dvst, dwst);
  return (int)err;
}

}  // namespace

// tokens a chunk
extern "C" int wkv6_chunk_tokens() { return kL; }

// fp32 elements of the scratch that wkv6_fwd needs for these sizes
extern "C" int64_t wkv6_scratch_floats(int B, int H, int T_len, int N) {
  return (int64_t)B * H * ((T_len + kL - 1) / kL) * chunk_scratch_floats(N);
}

// r, k, v, o: (B, H, T, N) in one dtype (is_bf16 ? bf16 : fp32), log_w:
// (B, H, T, N) fp32, each addressed by its (batch, head, token) element
// strides with a contiguous channel dim; every base 4-element aligned (16
// bytes fp32, 8 bf16) and every stride a multiple of 4; u: (H, N) fp32
// contiguous; s0 (may be null: zero state) and s_out: (B, H, N, N) fp32
// contiguous, 16-byte aligned; scratch: wkv6_scratch_floats(B, H, T, N)
// fp32, 16-byte aligned (unused when T = 0).  N must be 64 or 128.
// Launches the three passes on `stream`; returns the first launch error
// (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* log_w, const float* u, const float* s0,
                        void* o, float* s_out, float* scratch, int is_bf16,
                        int B, int H, int T_len, int N, int64_t r_sb,
                        int64_t r_sh, int64_t r_st, int64_t k_sb,
                        int64_t k_sh, int64_t k_st, int64_t v_sb,
                        int64_t v_sh, int64_t v_st, int64_t w_sb,
                        int64_t w_sh, int64_t w_st, int64_t o_sb,
                        int64_t o_sh, int64_t o_st, void* stream) {
  if (B <= 0 || H <= 0 || T_len < 0) return (int)cudaErrorInvalidValue;
  const Strides rst{r_sb, r_sh, r_st}, kst{k_sb, k_sh, k_st},
      vst{v_sb, v_sh, v_st}, wst{w_sb, w_sh, w_st}, ost{o_sb, o_sh, o_st};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, log_w, u, s0, o, s_out,
                                     scratch, B, H, T_len, rst, kst, vst,
                                     wst, ost, s);
  return dispatch_n<float>(N, r, k, v, log_w, u, s0, o, s_out, scratch, B,
                           H, T_len, rst, kst, vst, wst, ost, s);
}

// fp32 elements of the scratch that wkv6_bwd needs beside the forward's:
// the gradient of the state leaving each chunk
extern "C" int64_t wkv6_bwd_scratch_floats(int B, int H, int T_len, int N) {
  return (int64_t)B * H * ((T_len + kL - 1) / kL) * N * N;
}

// Backward of wkv6_fwd.  r, k, v, log_w, u, S0's shapes and layouts as
// there; dout: (B, H, T, N) in r's dtype, by its strides (4-aligned, as
// r); scratch: the forward's scratch, as that call left it; dS (may be
// null: zero): (B, H, N, N) fp32 contiguous; bscratch:
// wkv6_bwd_scratch_floats fp32; dr, dk, dv: (B, H, T, N) in r's dtype and
// dlw (B, H, T, N) fp32, each by its strides (4-aligned); du_part: (B, H,
// C, N) fp32, each chunk's share of du (C = ceil(T / 16)); dS0 (may be
// null: not wanted): (B, H, N, N) fp32.  T > 0; N must be 64.
// Launches the two passes on `stream`; returns the first launch error.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const float* log_w, const float* u, const void* dout,
                        const float* dS, float* scratch, float* bscratch,
                        void* dr, void* dk, void* dv, float* dlw,
                        float* du_part, float* dS0, int is_bf16, int B, int H,
                        int T_len, int N, const int64_t* st, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || N != 64)
    return (int)cudaErrorInvalidValue;
  Strides ss[9];
  for (int i = 0; i < 9; ++i) ss[i] = Strides{st[3 * i], st[3 * i + 1],
                                              st[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_bwd<__nv_bfloat16, 64>(
        r, k, v, log_w, u, dout, dS, scratch, bscratch, dr, dk, dv, dlw,
        du_part, dS0, B, H, T_len, ss[0], ss[1], ss[2], ss[3], ss[4], ss[5],
        ss[6], ss[7], ss[8], s);
  return launch_bwd<float, 64>(
      r, k, v, log_w, u, dout, dS, scratch, bscratch, dr, dk, dv, dlw,
      du_part, dS0, B, H, T_len, ss[0], ss[1], ss[2], ss[3], ss[4], ss[5],
      ss[6], ss[7], ss[8], s);
}
