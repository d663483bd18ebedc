// Blockwise (flash) grouped-query attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mha_flash (_flash_kernel) of
// src/repro/kernels/flash_attention.py: out = softmax(q k^T * scale + mask) v
// for q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), q head h reading kv head
// h / (Hq / Hkv); causal with q rows at absolute positions q_offset + i, an
// optional sliding window (qpos - kpos < window), keys at or past Skv masked.
// Masked scores take the -1e30 sentinel of the Pallas kernel, the softmax is
// online in float32, and the output is written in the inputs' type.  The
// serving path's prefill calls it once per layer (models/attention.py).
//
// What bounds it on this card: operations.  At the prefill shape (B = 16,
// Hq = 32, Hkv = 8, S = 1024, D = 128, causal) it does 4 * D flops per
// (query, visible key) pair, 137 GFLOP, against 0.34 GB of q, k, v and
// output: 410 flops per byte, above the card's 295 bf16 flops per byte, so
// the tensor cores' 989 TFLOP/s set the bound (0.14 ms).  This kernel does
// its products in float32 on the CUDA cores (67 TFLOP/s peak), so it cannot
// come near that bound; tensor cores (mma / wgmma), TMA loads and a
// pipelined K/V ring are later work.
//
// Design.  One CTA of 128 threads per (q tile of 64 rows, q head, batch);
// blockIdx.x runs over the q tiles from the last one down, so the causal
// tiles with the most keys start first.  The q tile is loaded once into
// shared memory as float32, pre-scaled.  The CTA walks the K/V tiles of 64
// keys that can hold a visible key: tiles wholly in the causal future of the
// q tile, or wholly behind every query's window, are skipped, as in the
// Pallas kernel.  Each K tile is staged in shared memory as float32; every
// q head of a group stages the same K/V head (it stays in L2).  Thread
// (rg, cg) = (tid / 8, tid % 8) owns score rows rg*4 .. rg*4+3 and key
// columns cg + 8j (j < 8): a row's 8 owners are lanes of one warp, so the
// row max and row sum are three xor shuffles.  Probabilities go to shared
// memory, the V tile replaces the K tile, and the same thread accumulates
// output rows rg*4 .. rg*4+3 at columns cg*4 + 32c .. +3 (those below D) in
// registers, rescaled by exp(m_old - m_new) per tile.  Shared memory
// holds q (64 x D), one K or V tile (64 x (D + 4)) and the scores
// (64 x 66), 82 KB at D = 128, so two CTAs fit on an SM.
//
// Inputs are addressed by strides (the element stride of D must be 1), so
// the transposed views the attention block makes from its projections are
// read in place; the output too is written through strides.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kPStride = kBK + 2;
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "stage_tile stages q and K/V tiles of one height");

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows x D elements of src (row stride `stride`, valid rows < n_valid) into
// shared memory dst (row stride dst_stride floats), times mul; zero past
// n_valid.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* src, long long stride,
                                           int n_valid, float* dst,
                                           int dst_stride, float mul) {
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < kBQ * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    float v[8];
    if (r < n_valid) {
      load8(src + r * stride + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float* out = dst + r * dst_stride + c;
    *reinterpret_cast<float4*>(out) =
        make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
    *reinterpret_cast<float4*>(out + 4) =
        make_float4(v[4] * mul, v[5] * mul, v[6] * mul, v[7] * mul);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Sq, int Skv, long long q_sb, long long q_sh, long long q_ss,
             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
             long long v_sh, long long v_ss, long long o_sb, long long o_sh,
             long long o_ss, float scale, int causal, int q_offset,
             int window) {
  constexpr int kQStride = D;
  constexpr int kKStride = D + 4;  // conflict-free float4 reads of 8 rows
  constexpr int kOC = (D + 31) / 32;  // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kBQ * kQStride;
  float* Ps = KVs + kBK * kKStride;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;

  const T* qb = q + b * q_sb + h * q_sh + q0 * q_ss;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int q_rows = min(kBQ, Sq - q0);

  stage_tile<T, D>(qb, q_ss, q_rows, Qs, kQStride, scale);

  // keys that can be visible to some row of this tile: [k_lo, k_hi)
  int k_hi = Skv;
  if (causal) k_hi = min(k_hi, q0 + q_rows - 1 + q_offset + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 + q_offset - window + 1);

  float m[4], l[4], acc[4][kOC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const int k_rows = min(kBK, Skv - k0);
    __syncthreads();  // the previous tile's V reads are done
    stage_tile<T, D>(kb + k0 * k_ss, k_ss, k_rows, KVs, kKStride, 1.f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            Qs + (rg * 4 + i) * kQStride + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            KVs + (cg + 8 * j) * kKStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(rg * 4 + i) * kPStride + cg + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();  // scores written, K reads done
    stage_tile<T, D>(vb + k0 * v_ss, v_ss, k_rows, KVs, kKStride, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(rg * 4 + i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        if (cg * 4 + 32 * c >= D) continue;  // D = 16: half the groups idle
        const float4 vv = *reinterpret_cast<const float4*>(
            KVs + j * kKStride + cg * 4 + 32 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(p[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      if (cg * 4 + 32 * c >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(ob + r * o_ss + cg * 4 + 32 * c + e, acc[i][c][e] * inv);
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  return (kBQ * D + kBK * (D + 4) + kBQ * kPStride) * (int)sizeof(float);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, const long long* st,
           float scale, int causal, int q_offset, int window,
           cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal, q_offset, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Hq, int Hkv, int Sq, int Skv, const long long* st,
               float scale, int causal, int q_offset, int window,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale,
                                  causal, q_offset, window, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale,
                                  causal, q_offset, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale,
                                  causal, q_offset, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st,
                                    scale, causal, q_offset, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  strides (in elements): q_sb, q_sh, q_ss,
// k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss; the stride of D is 1
// for all four.  D in {16, 32, 64, 128}; Hq a multiple of Hkv; B, Hq <= 65535.
int trees_flash_attention(int dtype, const void* q, const void* k,
                          const void* v, void* o, int B, int Hq, int Hkv,
                          int Sq, int Skv, int D, const long long* strides,
                          float scale, int causal, int q_offset, int window,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, strides,
                             scale, causal, q_offset, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                     strides, scale, causal, q_offset,
                                     window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
