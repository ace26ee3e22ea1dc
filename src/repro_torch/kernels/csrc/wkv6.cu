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
// state leaving chunk c and B[i, j] = do_i . v_j, it mirrors the forward:
//   bwd pass 1, one block per (b, h, c): V_c = q^T do, from the forward's
//     q^T (an L-deep outer-product sum, as U_c);
//   bwd pass 2, one thread per (b, h, n, 4 columns): in reverse chunk
//     order G^{C-1} = dS (or 0), G^{c-1} = d_c[n] G^c + V_c, each G^c
//     stored over V_c, dS0 = G^{-1};
//   bwd pass 3, one block per (b, h, c), three groups of N threads, each
//     thread a 4-token x 4-channel register tile of one gradient:
//       dr_i = P_{i-1} (S_c do_i + sum_{j<i} B[i, j] k_j / P_j) + u k_i B_ii
//       dk_i = u r_i B_ii + exp(cum_L - cum_i) G^c v_i
//              + exp(-cum_i) sum_{j>i} B[j, i] q_j
//       dv_i = sum_{j>=i} A[j, i] do_j + kd_i G^c
//     (A the forward's intra-chunk matrix, recomputed), then per channel
//     the chunk's reverse sums of r dr' and k dk' (dr', dk' without the
//     bonus terms) and its share of du;
//   bwd passes 4 and 5: the decay's gradient
//     dlog_w_s = sum_{t>s} r_t dr'_t - sum_{t>=s} k_t dk'_t
//                + rowsum(dS * S_T)
//     (the gradient of every in-chunk log-decay sum, gathered: the form
//     w_t rowsum(G_t * S_{t-1}) would need every token's N x N state):
//     one thread per (b, h, n) walks the chunks' totals in reverse into
//     each chunk's carry and sums du's per-(b, h) partial over the chunks
//     in order (the wrapper sums the batch); then one block per (b, h, c)
//     adds its carry to the chunk's in-chunk part.
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

// bwd pass 1: V_c = q^T do.  4N threads; thread (gn, gm) owns rows
// n0 .. n0 + TN - 1 and columns m .. m + 3, as the forward's U_c
template <typename T, int N>
__global__ void __launch_bounds__(4 * N)
wkv6_bwd_chunk_v(const T* __restrict__ dout, Scratch sc,
                 float* __restrict__ V, int H, int T_len, int C,
                 Strides dst) {
  constexpr int TN = N / 16;
  extern __shared__ float4 smem4[];
  float* dos = reinterpret_cast<float*>(smem4);  // [L][N]
  float* qs = dos + kL * N;                      // [L][N]
  const int bh = blockIdx.x / C, c = blockIdx.x % C;
  const int b = bh / H, h = bh % H;
  const int t0 = c * kL, len = min(kL, T_len - t0);
  const int64_t chunk = (int64_t)bh * C + c;
  load_tile<T, N>(dos, dout + b * dst.b + h * dst.h, dst.t, t0, len);
  const float* qTg = sc.qT + chunk * kL * N;
  for (int e = threadIdx.x; e < kL * N; e += blockDim.x) {
    const int n = e / kL, t = e % kL;
    qs[t * N + n] = qTg[e];
  }
  __syncthreads();
  const int n0 = (threadIdx.x / (N / 4)) * TN;
  const int m = (threadIdx.x % (N / 4)) * 4;
  float acc[TN][4];
#pragma unroll
  for (int i = 0; i < TN; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const float4 dd = *reinterpret_cast<const float4*>(dos + j * N + m);
#pragma unroll
    for (int i4 = 0; i4 < TN; i4 += 4) {
      const float4 q = *reinterpret_cast<const float4*>(qs + j * N + n0 + i4);
      fma4(q.x, dd, acc[i4]);
      fma4(q.y, dd, acc[i4 + 1]);
      fma4(q.z, dd, acc[i4 + 2]);
      fma4(q.w, dd, acc[i4 + 3]);
    }
  }
  float* Vg = V + chunk * N * N;
#pragma unroll
  for (int i = 0; i < TN; ++i)
    store4(Vg + (n0 + i) * N + m,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// bwd pass 2: the reverse fold of the state's gradient, one thread per
// (b, h, n, m .. m + 3)
template <int N>
__global__ void __launch_bounds__(kFoldThreads)
wkv6_bwd_fold(float* __restrict__ V, const float* __restrict__ dec,
              const float* __restrict__ dS, float* __restrict__ dS0, int BH,
              int C) {
  constexpr int Q = N * N / 4;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)BH * Q) return;
  const int64_t bh = e / Q;
  const int w = (int)(e % Q), n = w / (N / 4);
  float4 G = dS ? reinterpret_cast<const float4*>(dS)[e]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* Vb = reinterpret_cast<float4*>(V) + bh * C * Q + w;
  const float* db = dec + bh * C * N + n;
  for (int c = C - 1; c >= 0; --c) {
    const float4 vv = Vb[(int64_t)c * Q];
    const float d = db[(int64_t)c * N];
    Vb[(int64_t)c * Q] = G;   // the gradient of the state leaving chunk c
    G.x = fmaf(d, G.x, vv.x);
    G.y = fmaf(d, G.y, vv.y);
    G.z = fmaf(d, G.z, vv.z);
    G.w = fmaf(d, G.w, vv.w);
  }
  if (dS0) reinterpret_cast<float4*>(dS0)[e] = G;
}

// bwd pass 3: each chunk's gradients.  3 x (L N / 16) threads: group 0
// writes dr, group 1 dk, group 2 dv; thread (g, x) of a group owns tokens
// 4g .. 4g + 3 and channels 4x .. 4x + 3.
template <int N>
__host__ __device__ constexpr int bwd_group_threads() { return kL * N / 16; }

template <int N>
__host__ __device__ constexpr int bwd_smem_bytes() {
  // S_c^T, G, G^T; r, k, v, do, cum, q, k/P, the reverse sums' terms
  // (2 tiles); do^T, v^T, kd^T; A, the two masked B's, B's diagonal
  return (3 * N * N + 9 * kL * N + 3 * N * kQS + 3 * kL * kL + kL) * 4;
}

template <typename T, int N>
__global__ void __launch_bounds__(3 * bwd_group_threads<N>())
wkv6_bwd_chunk_grads(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ log_w,
                     const float* __restrict__ u, const T* __restrict__ dout,
                     Scratch sc, const float* __restrict__ Gg,
                     float* __restrict__ part, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dlw, int H, int T_len, int C,
                     Strides rst, Strides kst, Strides vst, Strides wst,
                     Strides dst, Strides drst, Strides dkst, Strides dvst,
                     Strides dwst) {
  constexpr int NT = 3 * bwd_group_threads<N>();
  extern __shared__ float4 smem4[];
  float* STs = reinterpret_cast<float*>(smem4);  // STs[m * N + n] = S_c[n][m]
  float* Gs = STs + N * N;                       // G^c[n][m]
  float* GTs = Gs + N * N;                       // G^c[m][n]
  float* rs = GTs + N * N;                       // [L][N] tiles
  float* ks = rs + kL * N;
  float* vs = ks + kL * N;
  float* dos = vs + kL * N;
  float* cs = dos + kL * N;                      // cum
  float* qs = cs + kL * N;                       // r_t P_{t-1}
  float* kps = qs + kL * N;                      // k_t / P_t
  float* as = kps + kL * N;                      // r dr' (no bonus)
  float* bs = as + kL * N;                       // k dk' (no bonus)
  float* doT = bs + kL * N;                      // [N][kQS] transposed
  float* vT = doT + N * kQS;
  float* kdT = vT + N * kQS;                     // k_t exp(cum_L - cum_t)
  float* As = kdT + N * kQS;                     // As[j * L + i] = A[j][i]
  float* Bl = As + kL * kL;                      // Bl[j * L + i] = j < i ? B[i][j]
  float* Bu = Bl + kL * kL;                      // Bu[j * L + i] = j > i ? B[j][i]
  float* Bd = Bu + kL * kL;                      // B[i][i]
  const int bh = blockIdx.x / C, c = blockIdx.x % C;
  const int b = bh / H, h = bh % H;
  const int t0 = c * kL, len = min(kL, T_len - t0);
  const int64_t chunk = (int64_t)bh * C + c;
  load_tile<T, N>(rs, r + b * rst.b + h * rst.h, rst.t, t0, len);
  load_tile<T, N>(ks, k + b * kst.b + h * kst.h, kst.t, t0, len);
  load_tile<T, N>(vs, v + b * vst.b + h * vst.h, vst.t, t0, len);
  load_tile<T, N>(dos, dout + b * dst.b + h * dst.h, dst.t, t0, len);
  load_tile<float, N>(cs, log_w + b * wst.b + h * wst.h, wst.t, t0, len);
  const float* Sg = sc.U + chunk * N * N;
  const float* Gc = Gg + chunk * N * N;
  for (int e = threadIdx.x; e < N * N; e += NT) {
    const int n = e / N, m = e % N;
    STs[m * N + n] = Sg[e];
    const float g = Gc[e];
    Gs[e] = g;
    GTs[m * N + n] = g;
  }
  __syncthreads();
  if (threadIdx.x < N) {   // the in-chunk cumsum of log_w
    const int n = threadIdx.x;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      acc += cs[i * N + n];
      cs[i * N + n] = acc;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kL * N; e += NT) {
    const int i = e / N, n = e % N;
    const float cum = cs[e], prev = i ? cs[e - N] : 0.f;
    const float tot = cs[(kL - 1) * N + n];
    qs[e] = rs[e] * expf(prev);
    kps[e] = ks[e] * expf(-cum);
    kdT[n * kQS + i] = ks[e] * expf(tot - cum);
    doT[n * kQS + i] = dos[e];
    vT[n * kQS + i] = vs[e];
  }
  __syncthreads();
  // A (strictly lower q . k/P, the bonus r . (u k) on the diagonal, 0
  // above) and B = do v^T; each dot starts at a channel rotated by its
  // entry (fewer bank conflicts), one fixed order an entry
  for (int e = threadIdx.x; e < 2 * kL * kL; e += NT) {
    const int which = e / (kL * kL), i = e / kL % kL, j = e % kL;
    float acc = 0.f;
    if (which == 0) {   // A[i][j]
      if (j < i) {
        for (int nn = 0; nn < N; ++nn) {
          const int n = (nn + e) & (N - 1);
          acc = fmaf(qs[i * N + n], kps[j * N + n], acc);
        }
      } else if (j == i) {
        for (int nn = 0; nn < N; ++nn) {
          const int n = (nn + e) & (N - 1);
          acc = fmaf(rs[i * N + n] * u[h * N + n], ks[i * N + n], acc);
        }
      }
      As[i * kL + j] = acc;
    } else {            // B[i][j] = do_i . v_j
      for (int nn = 0; nn < N; ++nn) {
        const int n = (nn + e) & (N - 1);
        acc = fmaf(dos[i * N + n], vs[j * N + n], acc);
      }
      Bl[j * kL + i] = j < i ? acc : 0.f;
      Bu[i * kL + j] = i > j ? acc : 0.f;
      if (i == j) Bd[i] = acc;
    }
  }
  __syncthreads();

  const int grp = threadIdx.x / bwd_group_threads<N>();
  const int lt = threadIdx.x % bwd_group_threads<N>();
  const int i0 = (lt / (N / 4)) * 4, x0 = (lt % (N / 4)) * 4;
  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[a][y] = acc2[a][y] = 0.f;
  if (grp == 0) {
    // S_c do_i (channels x0..), then sum_{j<i} B[i][j] k_j / P_j
#pragma unroll 8
    for (int m = 0; m < N; ++m) {
      const float4 dd = *reinterpret_cast<const float4*>(doT + m * kQS + i0);
      const float4 ss = *reinterpret_cast<const float4*>(STs + m * N + x0);
      fma4(dd.x, ss, acc[0]);
      fma4(dd.y, ss, acc[1]);
      fma4(dd.z, ss, acc[2]);
      fma4(dd.w, ss, acc[3]);
    }
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const float4 bb = *reinterpret_cast<const float4*>(Bl + j * kL + i0);
      const float4 kp = *reinterpret_cast<const float4*>(kps + j * N + x0);
      fma4(bb.x, kp, acc2[0]);
      fma4(bb.y, kp, acc2[1]);
      fma4(bb.z, kp, acc2[2]);
      fma4(bb.w, kp, acc2[3]);
    }
  } else if (grp == 1) {
    // G^c v_i, then sum_{j>i} B[j][i] q_j
#pragma unroll 8
    for (int m = 0; m < N; ++m) {
      const float4 vv = *reinterpret_cast<const float4*>(vT + m * kQS + i0);
      const float4 gg = *reinterpret_cast<const float4*>(GTs + m * N + x0);
      fma4(vv.x, gg, acc[0]);
      fma4(vv.y, gg, acc[1]);
      fma4(vv.z, gg, acc[2]);
      fma4(vv.w, gg, acc[3]);
    }
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const float4 bb = *reinterpret_cast<const float4*>(Bu + j * kL + i0);
      const float4 q = *reinterpret_cast<const float4*>(qs + j * N + x0);
      fma4(bb.x, q, acc2[0]);
      fma4(bb.y, q, acc2[1]);
      fma4(bb.z, q, acc2[2]);
      fma4(bb.w, q, acc2[3]);
    }
  } else {
    // kd_i G^c (columns x0..), then sum_{j>=i} A[j][i] do_j
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      const float4 kd = *reinterpret_cast<const float4*>(kdT + n * kQS + i0);
      const float4 gg = *reinterpret_cast<const float4*>(Gs + n * N + x0);
      fma4(kd.x, gg, acc[0]);
      fma4(kd.y, gg, acc[1]);
      fma4(kd.z, gg, acc[2]);
      fma4(kd.w, gg, acc[3]);
    }
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const float4 aa = *reinterpret_cast<const float4*>(As + j * kL + i0);
      const float4 dd = *reinterpret_cast<const float4*>(dos + j * N + x0);
      fma4(aa.x, dd, acc2[0]);
      fma4(aa.y, dd, acc2[1]);
      fma4(aa.z, dd, acc2[2]);
      fma4(aa.w, dd, acc2[3]);
    }
  }
  const Strides ost = grp == 0 ? drst : grp == 1 ? dkst : dvst;
  T* ob = (grp == 0 ? dr : grp == 1 ? dk : dv) + b * ost.b + h * ost.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + a;
    float out[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int n = x0 + y, e = i * N + n;
      if (grp == 0) {
        const float prev = i ? cs[e - N] : 0.f;
        const float nb = expf(prev) * (acc[a][y] + acc2[a][y]);
        as[e] = rs[e] * nb;
        out[y] = fmaf(u[h * N + n] * ks[e], Bd[i], nb);
      } else if (grp == 1) {
        const float tot = cs[(kL - 1) * N + n], cum = cs[e];
        const float nb = fmaf(expf(tot - cum), acc[a][y],
                              expf(-cum) * acc2[a][y]);
        bs[e] = ks[e] * nb;
        out[y] = fmaf(u[h * N + n] * rs[e], Bd[i], nb);
      } else {
        out[y] = acc[a][y] + acc2[a][y];
      }
    }
    if (i < len)
      store4(ob + (t0 + i) * ost.t + x0,
             make_float4(out[0], out[1], out[2], out[3]));
  }
  __syncthreads();
  // per channel: the in-chunk part of the decay's gradient, the chunk's
  // totals for pass 4 and its share of du
  if (threadIdx.x < N) {
    const int n = threadIdx.x;
    float sa = 0.f, sb = 0.f, du = 0.f;
    float* wb = dlw + b * dwst.b + h * dwst.h + n;
    for (int i = kL - 1; i >= 0; --i) {
      const int e = i * N + n;
      sb += bs[e];
      if (i < len) wb[(t0 + i) * dwst.t] = sa - sb;
      sa += as[e];
      du = fmaf(rs[e] * ks[e], Bd[i], du);
    }
    float* pc = part + chunk * 2 * N;
    pc[n] = sa - sb;
    pc[N + n] = du;
  }
}

// bwd pass 4, one thread per (b, h, n): the carry of each chunk, the
// chunks' totals summed in reverse order from rowsum(dS * S_T), written
// over the totals; and du's partial of (b, h), the chunks summed in order
template <int N>
__global__ void wkv6_bwd_carry(float* __restrict__ part,
                               const float* __restrict__ dS,
                               const float* __restrict__ S_T,
                               float* __restrict__ du_part, int BH, int C) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= BH * N) return;
  const int bh = e / N, n = e % N;
  float carry = 0.f;
  if (dS) {
    const float* g = dS + ((int64_t)bh * N + n) * N;
    const float* st = S_T + ((int64_t)bh * N + n) * N;
    for (int m = 0; m < N; ++m) carry = fmaf(g[m], st[m], carry);
  }
  float* pb = part + (int64_t)bh * C * 2 * N + n;
  float du = 0.f;
  for (int c = 0; c < C; ++c) du += pb[(int64_t)c * 2 * N + N];
  for (int c = C - 1; c >= 0; --c) {
    const float tot = pb[(int64_t)c * 2 * N];
    pb[(int64_t)c * 2 * N] = carry;
    carry += tot;
  }
  du_part[e] = du;
}

// bwd pass 5, one block of N threads per (b, h, c): each token's decay
// gradient gets its chunk's carry
template <int N>
__global__ void __launch_bounds__(N)
wkv6_bwd_decay(const float* __restrict__ part, float* __restrict__ dlw,
               int H, int T_len, int C, Strides dwst) {
  const int bh = blockIdx.x / C, c = blockIdx.x % C, n = threadIdx.x;
  const int b = bh / H, h = bh % H;
  const int t0 = c * kL, len = min(kL, T_len - t0);
  const float carry = part[((int64_t)bh * C + c) * 2 * N + n];
  float* wb = dlw + b * dwst.b + h * dwst.h + n;
  for (int i = 0; i < len; ++i) wb[(t0 + i) * dwst.t] += carry;
}

template <typename T, int N>
int launch_bwd(const void* r, const void* k, const void* v, const float* lw,
               const float* u, const void* dout, const float* dS,
               const float* S_T, float* scratch, float* bscratch, void* dr,
               void* dk, void* dv, float* dlw, float* du_part, float* dS0,
               int B, int H, int T_len, Strides rst, Strides kst,
               Strides vst, Strides wst, Strides dst, Strides drst,
               Strides dkst, Strides dvst, Strides dwst,
               cudaStream_t stream) {
  const int C = (T_len + kL - 1) / kL;
  const int BH = B * H;
  const Scratch sc = split_scratch(scratch, (int64_t)BH * C, N);
  float* V = bscratch;                                 // (BH, C, N, N)
  float* part = bscratch + (int64_t)BH * C * N * N;    // (BH, C, 2, N)
  cudaError_t err;
  if (C > 0) {
    constexpr int smem = 2 * kL * N * 4;
    wkv6_bwd_chunk_v<T, N><<<BH * C, 4 * N, smem, stream>>>(
        (const T*)dout, sc, V, H, T_len, C, dst);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t fold_threads = (int64_t)BH * N * N / 4;
  wkv6_bwd_fold<N><<<(unsigned)((fold_threads + kFoldThreads - 1) /
                                kFoldThreads),
                     kFoldThreads, 0, stream>>>(V, sc.dec, dS, dS0, BH, C);
  err = cudaGetLastError();
  if (err != cudaSuccess || C == 0) return (int)err;
  constexpr int smem = bwd_smem_bytes<N>();
  err = allow_smem(wkv6_bwd_chunk_grads<T, N>, smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_chunk_grads<T, N><<<BH * C, 3 * bwd_group_threads<N>(), smem,
                               stream>>>(
      (const T*)r, (const T*)k, (const T*)v, lw, u, (const T*)dout, sc, V,
      part, (T*)dr, (T*)dk, (T*)dv, dlw, H, T_len, C, rst, kst, vst, wst,
      dst, drst, dkst, dvst, dwst);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_carry<N><<<(BH * N + 127) / 128, 128, 0, stream>>>(
      part, dS, S_T, du_part, BH, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_decay<N><<<BH * C, N, 0, stream>>>(part, dlw, H, T_len, C, dwst);
  return (int)cudaGetLastError();
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

// fp32 elements of the scratch that wkv6_bwd needs beside the forward's
extern "C" int64_t wkv6_bwd_scratch_floats(int B, int H, int T_len, int N) {
  return (int64_t)B * H * ((T_len + kL - 1) / kL) * ((int64_t)N * N + 2 * N);
}

// Backward of wkv6_fwd.  r, k, v, log_w, u, S0's shapes and layouts as
// there; dout: (B, H, T, N) in r's dtype, by its strides (4-aligned, as
// r); scratch: the forward's scratch, as that call left it; dS (may be
// null: zero) and S_T (the forward's s_out; read only with dS): (B, H, N,
// N) fp32 contiguous; bscratch: wkv6_bwd_scratch_floats fp32; dr, dk, dv:
// (B, H, T, N) in r's dtype and dlw (B, H, T, N) fp32, each by its
// strides (4-aligned); du_part: (B, H, N) fp32, the per-(b, h) partial of
// du; dS0 (may be null: not wanted): (B, H, N, N) fp32.  N must be 64.
// Launches the five passes on `stream`; returns the first launch error.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const float* log_w, const float* u, const void* dout,
                        const float* dS, const float* S_T, float* scratch,
                        float* bscratch, void* dr, void* dk, void* dv,
                        float* dlw, float* du_part, float* dS0, int is_bf16,
                        int B, int H, int T_len, int N, const int64_t* st,
                        void* stream) {
  if (B <= 0 || H <= 0 || T_len < 0 || N != 64)
    return (int)cudaErrorInvalidValue;
  Strides ss[9];
  for (int i = 0; i < 9; ++i) ss[i] = Strides{st[3 * i], st[3 * i + 1],
                                              st[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_bwd<__nv_bfloat16, 64>(
        r, k, v, log_w, u, dout, dS, S_T, scratch, bscratch, dr, dk, dv, dlw,
        du_part, dS0, B, H, T_len, ss[0], ss[1], ss[2], ss[3], ss[4], ss[5],
        ss[6], ss[7], ss[8], s);
  return launch_bwd<float, 64>(
      r, k, v, log_w, u, dout, dS, S_T, scratch, bscratch, dr, dk, dv, dlw,
      du_part, dS0, B, H, T_len, ss[0], ss[1], ss[2], ss[3], ss[4], ss[5],
      ss[6], ss[7], ss[8], s);
}
