// One-token grouped-query decode attention over a ragged KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention (_decode_kernel) of
// src/repro/kernels/decode_attention.py: for each sequence b and q head h,
// out[b, h] = softmax(q[b, h] . k[b, h / group, j] * scale) v[b, h / group, j]
// over the cache rows j < lengths[b] (a length above the cache's S reads
// every row) and, with a window, j >= lengths[b] - window.  float32 online
// softmax, output in q's type; a sequence with no visible row gets zeros, as
// from the Pallas kernel.  The serving path's decode epoch calls it once per
// layer (models/attention.py, apply_attn_decode).
//
// What bounds it on this card: memory.  Each visible cache row is read once
// (2 * D elements of K and V per kv head) and serves the `group` q heads of
// its kv head with 4 * D flops each: 2 * group flops per byte in bf16 (8 for
// granite-3-8b's group of 4), far below the card's 295, so the bound is the
// cache bytes up to each length over 3.35 TB/s (40 microseconds for 16
// sequences x 8 kv heads x 2048 rows x 128 in bf16).
//
// Design.  One CTA of 256 threads per (kv head, sequence), so all `group` q
// rows of a kv head share one streamed pass over its K/V rows and each cache
// byte is read once.  The CTA walks the visible rows [lo, hi) in chunks of
// kChunk = 8 warps x (32 / (D / 8)) rows x 4.  Scores: D / 8 lanes share a
// row, each loading 16 bytes of K (8 bf16) with the four rows of a thread
// issued together, dotting with the group's q slices held in registers, and
// summing by xor shuffles; the chunk's scores go to shared memory.  Softmax:
// warp g updates q row g's running max and sum and turns the chunk's scores
// into probabilities.  Values: thread t accumulates two output dimensions
// (2 * (t % (D / 2))) for every q row of the group over the rows
// t / (D / 2) + k * (512 / D) of the chunk; the partial sums over those row
// subsets are added through shared memory at the end.  Chunks start at lo,
// so only the last chunk has masked rows.  Split-K across CTAs (more CTAs
// than the 128 of the serving shape), a K/V prefetch ring and tensor cores
// are later work.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows per thread per chunk in the score pass
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int Hkv, int S, long long k_sb,
              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
              long long v_ss, float scale, int window) {
  constexpr int kLanesPerRow = D / 8;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kChunk = kWarps * kRowsPerWarp * kUnroll;
  constexpr int kPairs = D / 2;
  constexpr int kSubsets = kThreads / kPairs;
  static_assert(G <= kWarps, "one warp per q row of a group");
  static_assert(kChunk % kSubsets == 0, "value pass covers the chunk");

  __shared__ float Ss[G][kChunk];
  __shared__ float alpha_s[G];
  __shared__ float l_s[G];
  __shared__ float red[kSubsets][G][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int length = lengths[b];
  const int hi = min(length, S);
  const int lo = window > 0 ? max(0, length - window) : 0;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  // score pass: this lane's row within the warp and its 8-element slice
  const int sub = lane / kLanesPerRow;
  const int part = lane % kLanesPerRow;
  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + ((long long)b * Hkv * G + h * G + g) * D + part * 8, qr[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[g][e] *= scale;
  }
  // value pass: this thread's dimension pair and row subset
  const int dp = tid % kPairs;
  const int ks = tid / kPairs;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  float m_row = kNegInf, l_row = 0.f;  // warp g: q row g's running stats

  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    float kr[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c0 + (u * kWarps + warp) * kRowsPerWarp + sub;
      if (j < hi) {
        load8(kb + j * k_ss + part * 8, kr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = (u * kWarps + warp) * kRowsPerWarp + sub;
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s[g] = fmaf(qr[g][e], kr[u][e], s[g]);
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          s[g] += __shfl_xor_sync(kFull, s[g], off);
      }
      if (part == 0) {
        const bool ok = c0 + kk < hi;
#pragma unroll
        for (int g = 0; g < G; ++g) Ss[g][kk] = ok ? s[g] : kNegInf;
      }
    }
    __syncthreads();

    if (warp < G) {
      float mx = kNegInf;
      for (int i = lane; i < kChunk; i += 32) mx = fmaxf(mx, Ss[warp][i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_row, mx);
      float sum = 0.f;
      for (int i = lane; i < kChunk; i += 32) {
        const float p = expf(Ss[warp][i] - m_new);
        Ss[warp][i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float alpha = expf(m_row - m_new);
      l_row = alpha * l_row + sum;
      m_row = m_new;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g][0] *= alpha_s[g];
      acc[g][1] *= alpha_s[g];
    }
    constexpr int kPerThread = kChunk / kSubsets;
#pragma unroll
    for (int i0 = 0; i0 < kPerThread; i0 += 4) {
      float2 vv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int kk = ks + (i0 + t) * kSubsets;
        const int j = c0 + kk;
        vv[t] = j < hi ? load2(vb + j * v_ss + 2 * dp) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int kk = ks + (i0 + t) * kSubsets;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = Ss[g][kk];
          acc[g][0] = fmaf(p, vv[t].x, acc[g][0]);
          acc[g][1] = fmaf(p, vv[t].y, acc[g][1]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the scores
  }

  if (warp < G && lane == 0) l_s[warp] = l_row;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    red[ks][g][2 * dp] = acc[g][0];
    red[ks][g][2 * dp + 1] = acc[g][1];
  }
  __syncthreads();
  T* ob = o + ((long long)b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSubsets; ++s) sum += red[s][g][d];
    store1(ob + i, sum / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int B, int Hkv, int S, const long long* st, float scale,
           int window, cudaStream_t s) {
  const dim3 grid(Hkv, B);
  decode_kernel<T, D, G><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), Hkv, S, st[0],
      st[1], st[2], st[3], st[4], st[5], scale, window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const int* lengths, void* o, int B, int Hkv, int S,
               const long long* st, float scale, int window, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, lengths, o, B, Hkv, S, st, scale,
                                   window, s);
    case 2: return launch<T, D, 2>(q, k, v, lengths, o, B, Hkv, S, st, scale,
                                   window, s);
    case 4: return launch<T, D, 4>(q, k, v, lengths, o, B, Hkv, S, st, scale,
                                   window, s);
    case 5: return launch<T, D, 5>(q, k, v, lengths, o, B, Hkv, S, st, scale,
                                   window, s);
    case 8: return launch<T, D, 8>(q, k, v, lengths, o, B, Hkv, S, st, scale,
                                   window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_d(int D, int G, const void* q, const void* k, const void* v,
               const int* lengths, void* o, int B, int Hkv, int S,
               const long long* st, float scale, int window, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, lengths, o, B, Hkv, S, st,
                                      scale, window, s);
    case 32: return dispatch_g<T, 32>(G, q, k, v, lengths, o, B, Hkv, S, st,
                                      scale, window, s);
    case 64: return dispatch_g<T, 64>(G, q, k, v, lengths, o, B, Hkv, S, st,
                                      scale, window, s);
    case 128: return dispatch_g<T, 128>(G, q, k, v, lengths, o, B, Hkv, S, st,
                                        scale, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q and o contiguous (B, Hkv * G, D);
// strides (in elements) of the caches: k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
// the stride of D is 1.  lengths: i32[B].  D in {16, 32, 64, 128}, G (the group)
// in {1, 2, 4, 5, 8}; Hkv, B <= 65535.
int trees_decode_attention(int dtype, const void* q, const void* k,
                           const void* v, const int* lengths, void* o, int B,
                           int Hkv, int G, int S, int D,
                           const long long* strides, float scale, int window,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(D, G, q, k, v, lengths, o, B, Hkv, S, strides,
                             scale, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, G, q, k, v, lengths, o, B, Hkv, S,
                                     strides, scale, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
