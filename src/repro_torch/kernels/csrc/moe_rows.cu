// The MoE layer's row movement between tokens and expert slots, on Hopper.
//
// Replaces no Pallas kernel: JAX's moe_forward (src/repro/models/layers.py)
// dispatches and combines by one-hot einsums that XLA fuses.  The port
// gathers each kept (token, choice) pair into its (expert, slot) row
// instead (ops.py), and these kernels do that movement and its gradient
// without writing the k-expanded (token, choice, d) rows anywhere:
//   * moe_gather_rows: out[r] = src[idx[r]], a zero row where idx[r] ==
//     n_src (the sentinel), optionally each element times w[idx[r]] in
//     fp32 and rounded once.  Dispatch forward (x into the slots, a pure
//     copy) and the slots' part of the combine's backward (d_ye[s] =
//     g[t] * w[t], t = token_at[s]);
//   * moe_sum_rows: out[t] = sum over j = 0..k-1 of src[slot[t, j]] in
//     fp32, in that order, skipping the sentinel, optionally each row times
//     w[t] first (products and sums in fp32, not fused), rounded once.
//     Combine forward (weighted) and dispatch backward (unweighted);
//   * moe_combine_bwd: one launch whose first blocks write the slots' rows
//     d_ye (as moe_gather_rows, weighted) and whose last blocks form each
//     token's d_w[t] = sum over its kept j and over d of g[t] * ye[slot[t,
//     j]] in fp32 (a fixed order: per lane, then a butterfly over the warp).
//
// What bounds them on the H100: bytes.  Each row is moved once (granite-
// moe-1b at 8 x 2048 tokens: 163,840 slot rows and 131,072 pairs of 2 KB a
// layer), with a handful of flops an element.  The design:
//   * one warp a row, 8 rows a block; a lane moves 16 bytes at a time (8
//     bf16 or 4 fp32), neighbouring lanes on neighbouring addresses, and a
//     gather keeps 4 such loads in flight before its stores, a sum 8 (one
//     per row summed);
//   * fp32 accumulators in registers, one rounding to the row's dtype;
//   * every output row has one writer (a slot belongs to at most one pair,
//     a token's k slots differ), every sum one order: no atomics, and a
//     result is the same bits from run to run;
//   * a row that is not 16-byte aligned (d * sizeof(T) % 16, or a base off
//     the grid) runs the same code an element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // rows a block, one warp a row
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;               // 16-byte loads in flight a lane
constexpr int kBatch = 8;                // rows of a sum loaded at once

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
  return __float2bfloat16_rn(x);
}

// 16 bytes of T, unpacked to and packed from fp32
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  __device__ static void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Pack<__nv_bfloat16> {
  // element 2i in the low half of word i (little endian)
  __device__ static void unpack(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// V elements of T a lane moves at once: 16 bytes, or one element
template <typename T, int V>
struct Access {
  static_assert(V * sizeof(T) == 16, "a vector access is 16 bytes");
  using Raw = uint4;
  __device__ static Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void store(T* p, Raw r) {
    *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void unpack(Raw r, float* f) { Pack<T>::unpack(r, f); }
  __device__ static Raw pack(const float* f) { return Pack<T>::pack(f); }
};
template <typename T>
struct Access<T, 1> {
  using Raw = T;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static void store(T* p, Raw r) { *p = r; }
  __device__ static Raw zero() { return from_f<T>(0.f); }
  __device__ static void unpack(Raw r, float* f) { f[0] = to_f(r); }
  __device__ static Raw pack(const float* f) { return from_f<T>(f[0]); }
};

template <typename T, int V>
__device__ __forceinline__ typename Access<T, V>::Raw scaled(
    typename Access<T, V>::Raw r, float w) {
  float f[V];
  Access<T, V>::unpack(r, f);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = __fmul_rn(f[i], w);
  return Access<T, V>::pack(f);
}

// row r of out: src[idx[r]] (times w[idx[r]] with Weighted), or zeros
template <typename T, int V, bool Weighted>
__device__ __forceinline__ void gather_row(const T* __restrict__ src,
                                           const int64_t* __restrict__ idx,
                                           const float* __restrict__ w,
                                           T* __restrict__ out, int64_t r,
                                           int64_t n_src, int d, int lane) {
  using A = Access<T, V>;
  constexpr int step = 32 * V;
  const int64_t t = idx[r];
  T* o = out + r * d;
  if (t >= n_src) {
    for (int c = lane * V; c < d; c += step) A::store(o + c, A::zero());
    return;
  }
  const T* s = src + t * d;
  const float wt = Weighted ? w[t] : 1.f;
  int c = lane * V;
  for (; c + (kUnroll - 1) * step < d; c += kUnroll * step) {
    typename A::Raw v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = A::load(s + c + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      A::store(o + c + u * step, Weighted ? scaled<T, V>(v[u], wt) : v[u]);
  }
  for (; c < d; c += step) {
    const typename A::Raw v = A::load(s + c);
    A::store(o + c, Weighted ? scaled<T, V>(v, wt) : v);
  }
}

// acc += fp32 rows sl[0..n) of src at column c, in order (times wt first
// with Weighted); sentinel rows are skipped
template <typename T, int V, bool Weighted>
__device__ __forceinline__ void add_rows(const T* __restrict__ src,
                                         const int64_t* sl, int n,
                                         int64_t n_src, int d, int c,
                                         float wt, float* acc) {
  using A = Access<T, V>;
  typename A::Raw v[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    if (j < n && sl[j] < n_src) v[j] = A::load(src + sl[j] * d + c);
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (j < n && sl[j] < n_src) {
      float f[V];
      A::unpack(v[j], f);
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[i] = __fadd_rn(acc[i], Weighted ? __fmul_rn(f[i], wt) : f[i]);
    }
  }
}

// the slots of token t, kBatch at a time, in registers
template <typename T, int V, bool Weighted>
__device__ __forceinline__ void sum_row(const T* __restrict__ src,
                                        const int64_t* __restrict__ slot,
                                        const float* __restrict__ w,
                                        T* __restrict__ out, int64_t t, int k,
                                        int64_t n_src, int d, int lane) {
  using A = Access<T, V>;
  const int64_t* row = slot + t * k;
  const float wt = Weighted ? w[t] : 1.f;
  int64_t sl[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) sl[j] = j < k ? row[j] : n_src;
  for (int c = lane * V; c < d; c += 32 * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    add_rows<T, V, Weighted>(src, sl, k < kBatch ? k : kBatch, n_src, d, c,
                             wt, acc);
    for (int j0 = kBatch; j0 < k; j0 += kBatch) {
      int64_t more[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        more[j] = j0 + j < k ? row[j0 + j] : n_src;
      add_rows<T, V, Weighted>(src, more, k - j0 < kBatch ? k - j0 : kBatch,
                               n_src, d, c, wt, acc);
    }
    A::store(out + t * d + c, A::pack(acc));
  }
}

// d_w[t] = sum over j, c of g[t, c] * ye[slot[t, j], c] in fp32
template <typename T, int V>
__device__ __forceinline__ void weight_grad(const T* __restrict__ g,
                                            const T* __restrict__ ye,
                                            const int64_t* __restrict__ slot,
                                            float* __restrict__ d_w,
                                            int64_t t, int k, int64_t n_slot,
                                            int d, int lane) {
  using A = Access<T, V>;
  const int64_t* row = slot + t * k;
  float part[V];
#pragma unroll
  for (int i = 0; i < V; ++i) part[i] = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    float gf[V];
    A::unpack(A::load(g + t * d + c), gf);
    for (int j0 = 0; j0 < k; j0 += kBatch) {
      const int n = k - j0 < kBatch ? k - j0 : kBatch;
      int64_t sl[kBatch];
      typename A::Raw v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        sl[j] = j < n ? row[j0 + j] : n_slot;
        if (sl[j] < n_slot) v[j] = A::load(ye + sl[j] * d + c);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (sl[j] < n_slot) {
          float f[V];
          A::unpack(v[j], f);
#pragma unroll
          for (int i = 0; i < V; ++i) part[i] = fmaf(gf[i], f[i], part[i]);
        }
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) sum += part[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) d_w[t] = sum;
}

template <typename T, int V, bool Weighted>
__global__ void __launch_bounds__(kThreads)
    moe_gather_rows(const T* __restrict__ src, const int64_t* __restrict__ idx,
                    const float* __restrict__ w, T* __restrict__ out,
                    int64_t n_out, int64_t n_src, int d) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r < n_out)
    gather_row<T, V, Weighted>(src, idx, w, out, r, n_src, d,
                               threadIdx.x % 32);
}

template <typename T, int V, bool Weighted>
__global__ void __launch_bounds__(kThreads)
    moe_sum_rows(const T* __restrict__ src, const int64_t* __restrict__ slot,
                 const float* __restrict__ w, T* __restrict__ out,
                 int64_t n_tok, int k, int64_t n_src, int d) {
  const int64_t t = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (t < n_tok)
    sum_row<T, V, Weighted>(src, slot, w, out, t, k, n_src, d,
                            threadIdx.x % 32);
}

// blocks [0, slot_blocks) write d_ye's rows; the rest form d_w
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_combine_bwd(const T* __restrict__ g, const T* __restrict__ ye,
                    const float* __restrict__ w,
                    const int64_t* __restrict__ slot,
                    const int64_t* __restrict__ token_at,
                    T* __restrict__ d_ye, float* __restrict__ d_w,
                    int64_t n_tok, int k, int64_t n_slot, int d,
                    int64_t slot_blocks) {
  const int lane = threadIdx.x % 32;
  if (blockIdx.x < slot_blocks) {
    const int64_t s = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
    if (s < n_slot)
      gather_row<T, V, true>(g, token_at, w, d_ye, s, n_tok, d, lane);
  } else {
    const int64_t t =
        (int64_t)(blockIdx.x - slot_blocks) * kWarps + threadIdx.x / 32;
    if (t < n_tok) weight_grad<T, V>(g, ye, slot, d_w, t, k, n_slot, d, lane);
  }
}

bool aligned(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte accesses where every row starts on the 16-byte grid
template <typename T>
bool vector_rows(int d, const void* a, const void* b, const void* c = nullptr) {
  return (d * sizeof(T)) % 16 == 0 && aligned(a) && aligned(b) && aligned(c);
}

int64_t blocks_for(int64_t rows) { return (rows + kWarps - 1) / kWarps; }

template <typename T>
int gather(const void* src, const int64_t* idx, const float* w, void* out,
           int64_t n_out, int64_t n_src, int d, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks_for(n_out));
  const bool vec = vector_rows<T>(d, src, out);
  if (w != nullptr && vec)
    moe_gather_rows<T, V, true><<<grid, kThreads, 0, s>>>(x, idx, w, o, n_out,
                                                          n_src, d);
  else if (w != nullptr)
    moe_gather_rows<T, 1, true><<<grid, kThreads, 0, s>>>(x, idx, w, o, n_out,
                                                          n_src, d);
  else if (vec)
    moe_gather_rows<T, V, false><<<grid, kThreads, 0, s>>>(x, idx, w, o,
                                                           n_out, n_src, d);
  else
    moe_gather_rows<T, 1, false><<<grid, kThreads, 0, s>>>(x, idx, w, o,
                                                           n_out, n_src, d);
  return (int)cudaGetLastError();
}

template <typename T>
int sum(const void* src, const int64_t* slot, const float* w, void* out,
        int64_t n_tok, int k, int64_t n_src, int d, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks_for(n_tok));
  const bool vec = vector_rows<T>(d, src, out);
  if (w != nullptr && vec)
    moe_sum_rows<T, V, true><<<grid, kThreads, 0, s>>>(x, slot, w, o, n_tok,
                                                       k, n_src, d);
  else if (w != nullptr)
    moe_sum_rows<T, 1, true><<<grid, kThreads, 0, s>>>(x, slot, w, o, n_tok,
                                                       k, n_src, d);
  else if (vec)
    moe_sum_rows<T, V, false><<<grid, kThreads, 0, s>>>(x, slot, w, o, n_tok,
                                                        k, n_src, d);
  else
    moe_sum_rows<T, 1, false><<<grid, kThreads, 0, s>>>(x, slot, w, o, n_tok,
                                                        k, n_src, d);
  return (int)cudaGetLastError();
}

template <typename T>
int combine_bwd(const void* g, const void* ye, const float* w,
                const int64_t* slot, const int64_t* token_at, void* d_ye,
                float* d_w, int64_t n_tok, int k, int64_t n_slot, int d,
                cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int64_t slot_blocks = blocks_for(n_slot);
  const dim3 grid((unsigned)(slot_blocks + blocks_for(n_tok)));
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(ye);
  T* dy = static_cast<T*>(d_ye);
  if (vector_rows<T>(d, g, ye, d_ye))
    moe_combine_bwd<T, V><<<grid, kThreads, 0, s>>>(
        gt, yt, w, slot, token_at, dy, d_w, n_tok, k, n_slot, d, slot_blocks);
  else
    moe_combine_bwd<T, 1><<<grid, kThreads, 0, s>>>(
        gt, yt, w, slot, token_at, dy, d_w, n_tok, k, n_slot, d, slot_blocks);
  return (int)cudaGetLastError();
}

bool bad_sizes(int64_t rows, int64_t n_src, int d, int k) {
  return rows < 0 || n_src < 0 || d <= 0 || k <= 0 ||
         blocks_for(rows) > 0x3fffffff;
}

}  // namespace

// Rows are contiguous, d elements each, in one dtype (is_bf16 ? bf16 :
// fp32); indices int64; w fp32 or NULL (no weighting).  Each returns the
// launch's CUDA error (0: queued on stream).

// out (n_out, d) = src[idx] (n_src rows; idx == n_src: a zero row), each
// row times w[idx[r]] when w is given
extern "C" int moe_gather_rows_launch(const void* src, const int64_t* idx,
                                      const float* w, void* out, int64_t n_out,
                                      int64_t n_src, int d, int is_bf16,
                                      void* stream) {
  if (bad_sizes(n_out, n_src, d, 1)) return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? gather<__nv_bfloat16>(src, idx, w, out, n_out, n_src, d, s)
                 : gather<float>(src, idx, w, out, n_out, n_src, d, s);
}

// out (n_tok, d): out[t] = sum over j of src[slot[t, j]] (times w[t]),
// slot (n_tok, k), slot == n_src skipped
extern "C" int moe_sum_rows_launch(const void* src, const int64_t* slot,
                                   const float* w, void* out, int64_t n_tok,
                                   int k, int64_t n_src, int d, int is_bf16,
                                   void* stream) {
  if (bad_sizes(n_tok, n_src, d, k)) return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? sum<__nv_bfloat16>(src, slot, w, out, n_tok, k, n_src, d, s)
                 : sum<float>(src, slot, w, out, n_tok, k, n_src, d, s);
}

// the combine's gradients at g (n_tok, d): d_ye (n_slot, d) and d_w (n_tok)
// fp32, from ye (n_slot, d), w (n_tok), slot (n_tok, k), token_at (n_slot)
extern "C" int moe_combine_bwd_launch(const void* g, const void* ye,
                                      const float* w, const int64_t* slot,
                                      const int64_t* token_at, void* d_ye,
                                      float* d_w, int64_t n_tok, int k,
                                      int64_t n_slot, int d, int is_bf16,
                                      void* stream) {
  if (bad_sizes(n_slot + n_tok, n_slot, d, k) || w == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_slot + n_tok == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? combine_bwd<__nv_bfloat16>(g, ye, w, slot, token_at, d_ye,
                                              d_w, n_tok, k, n_slot, d, s)
                 : combine_bwd<float>(g, ye, w, slot, token_at, d_ye, d_w,
                                      n_tok, k, n_slot, d, s);
}
