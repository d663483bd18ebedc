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
// the tensor cores' 989 TFLOP/s set the bound (0.14 ms).
//
// Three designs, chosen by the inputs' type and head dim:
//
// bfloat16, D = 64 and 128 (the serving path's prefill: granite's 128,
// hymba's 64): Hopper's wgmma fed by TMA, in a persistent kernel (namespace
// wg below, whose comment says how it is laid out).
//
// bfloat16, D = 16 and 32 (the reduced test configs): mma.sync tensor
// cores (namespace tc).  One CTA of 4 warps per (q tile of 128 rows, q
// head, batch), each warp owning two 16-row mma tiles, so every K and V
// fragment it reads from shared memory feeds two products; blockIdx.x runs
// over the q tiles from the last one down, so the causal tiles with the
// most keys start first.  The q tile is copied once into shared memory and
// held in registers as mma A fragments.  K and V tiles of 64 keys go
// through a 2-stage ring in shared memory, filled by cp.async (16-byte
// copies, rows padded by 16 bytes so ldmatrix is free of bank conflicts);
// tile t + 1's K and V are in flight while tile t's products run, and V's
// copy is waited for only after S = Q K^T.  Both products are
// mma.sync.m16n8k16 with float32 accumulators; P is rounded to bf16 in
// registers and used directly as the A operand of O += P V, V read with
// ldmatrix.trans.
//
// In both bf16 designs the online softmax runs on S in registers, in log2
// units (the scale folded into the exponent with log2 e), the row max and
// sum over the 4 lanes of a row; only tiles that cross the causal
// diagonal, the window's edge or Skv are masked, and tiles wholly in the
// future or wholly behind the window are skipped, as in the Pallas kernel;
// the epilogue writes O / l in bf16 through the output strides.
//
// float32 (the card-vs-CPU checks, which hold it within 1e-5: TF32 tensor
// cores would break that): the CUDA-core kernel of the first port,
// unchanged.  One CTA of 128 threads per (q tile of 64 rows, q head,
// batch), longest q tiles first.  The q tile is staged in shared memory,
// pre-scaled; each K tile of 64 keys is staged, every q head of a group
// staging the same K/V head (it stays in L2).  Thread (rg, cg) = (tid / 8,
// tid % 8) owns score rows rg*4 .. rg*4+3 and key columns cg + 8j (j < 8):
// the row max and row sum are three xor shuffles.  Probabilities go to
// shared memory, the V tile replaces the K tile, and the same thread
// accumulates output rows rg*4 .. rg*4+3 at columns cg*4 + 32c .. +3 in
// registers, rescaled by exp(m_old - m_new) per tile.  Its products are
// float32 fmaf on the CUDA cores (67 TFLOP/s peak).
//
// Inputs are addressed by strides (the element stride of D must be 1, the
// others multiples of 8 elements, the data 16-byte aligned), so the
// transposed views the attention block makes from its projections are read
// in place; the output too is written through strides.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap (the driver's encoder is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

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

// ----------------------------------------------- shared by the bf16 designs
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// two floats as a bf16x2 register, lo in the low half (an mma A fragment)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ------------------------------- bfloat16, D = 16 and 32: mma.sync + cp.async
namespace tc {

constexpr int kBM = 128;  // q rows per CTA
constexpr int kStages = 2;  // K/V ring depth

// Each warp owns kMT tiles of 16 q rows, so each K and V fragment it reads
// from shared memory feeds kMT products; K/V tiles of kBN keys.
template <int D>
struct Layout {
  static constexpr int kMT = 2;
  static constexpr int kBN = 64;
  static constexpr int kWarps = kBM / (16 * kMT);
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStride = D + 8;  // bf16 per smem row: +16 bytes
  static constexpr int kQ = kBM * kStride;
  static constexpr int kKV = kBN * kStride;
  static constexpr int kBytes = (kQ + 2 * kStages * kKV) * 2;
};

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for a 16x16 bf16 A (row), a 16x8 bf16 B (col), float32 c
__device__ __forceinline__ void mma(float* c, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ROWS x D bf16 of src (row stride `stride`) into smem rows of kStride;
// rows at or past n_valid are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src,
                                          long long stride, int n_valid,
                                          __nv_bfloat16* dst) {
  constexpr int kThreads = Layout<D>::kThreads;
  constexpr int kChunks = D / 8;
  constexpr int kIters = (ROWS * kChunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (ROWS * kChunks % kThreads != 0 && i >= ROWS * kChunks) break;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * Layout<D>::kStride + c,
               src + (ok ? r : 0) * stride + c, ok);
  }
}

// the A fragment of q rows r0 .. r0 + 15, columns kk * 16 .. + 15
template <int D>
__device__ __forceinline__ void load_q(unsigned* a,
                                       const __nv_bfloat16* Qs, int r0,
                                       int kk, int lane) {
  ldsm_x4(a, Qs + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                      Layout<D>::kStride +
                  kk * 16 + ((lane >> 4) << 3));
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 2)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                int Skv, long long q_sb, long long q_sh, long long q_ss,
                long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss,
                long long o_sb, long long o_sh, long long o_ss,
                float scale_log2, int causal, int q_offset, int window) {
  using L = Layout<D>;
  constexpr int kMT = L::kMT;
  constexpr int kBN = L::kBN;
  constexpr int kS = L::kStride;
  constexpr int kDK = D / 16;   // k16 steps of Q K^T
  constexpr int kNT = kBN / 8;  // n8 tiles of S
  constexpr int kDT = D / 8;    // n8 tiles of O
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* Ks = Qs + L::kQ;
  __nv_bfloat16* Vs = Ks + kStages * L::kKV;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kBM, Sq - q0);

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh + q0 * q_ss;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  // keys that can be visible to some row of this tile: [k_lo, k_hi)
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = q0 + q_rows - 1 + q_offset;
  int k_hi = Skv;
  if (causal) k_hi = min(k_hi, qpos_hi + 1);
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBN - 1) / kBN : 0;

  // groups in flight: Q, then K(t) and V(t) per tile (empty past the end)
  load_tile<D, kBM>(qb, q_ss, q_rows, Qs);
  cp_commit();
  if (n_tiles > 0) load_tile<D, kBN>(kb + k_lo * k_ss, k_ss, k_hi - k_lo, Ks);
  cp_commit();
  if (n_tiles > 0) load_tile<D, kBN>(vb + k_lo * v_ss, v_ss, k_hi - k_lo, Vs);
  cp_commit();
  cp_wait<2>();
  __syncthreads();

  const int wrow = warp * 16 * kMT;  // the warp's first q row in the tile
  unsigned qa[kMT][kDK][4];          // Q as mma A fragments
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk)
      load_q<D>(qa[mt][kk], Qs, wrow + 16 * mt, kk, lane);

  // lane's rows: wrow + 16 mt + (lane >> 2) + 8 i, for mt < kMT, i < 2
  float m[kMT][2], l[kMT][2];  // l: this lane's share of the row sums
  float acc[kMT][kDT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kNegInf;
      l[mt][i] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int k0 = k_lo + t * kBN;
    cp_wait<1>();  // K(t) has landed; V(t) may still be in flight
    __syncthreads();
    // refill the other stage (tile t - 1, consumed by every warp by now)
    if (t + 1 < n_tiles) {
      const int k1 = k0 + kBN;
      load_tile<D, kBN>(kb + k1 * k_ss, k_ss, k_hi - k1,
                        Ks + (stage ^ 1) * L::kKV);
      cp_commit();
      load_tile<D, kBN>(vb + k1 * v_ss, v_ss, k_hi - k1,
                        Vs + (stage ^ 1) * L::kKV);
      cp_commit();
    } else {
      cp_commit();
      cp_commit();
    }

    // S = Q K^T: each K fragment feeds the warp's kMT row tiles
    const __nv_bfloat16* Kt = Ks + stage * L::kKV;
    float s[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned kf[4];
        ldsm_x4(kf, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS +
                        kk * 16 + (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(s[mt][2 * np], qa[mt][kk], kf[0], kf[1]);
          mma(s[mt][2 * np + 1], qa[mt][kk], kf[2], kf[3]);
        }
      }
    }

    // scale into log2 units; mask only tiles that cross an edge
    const bool edge = k0 + kBN > Skv ||
                      (causal && k0 + kBN - 1 > qpos_lo) ||
                      (window > 0 && qpos_hi - k0 >= window);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] *= scale_log2;
          if (edge) {
            const int qpos = q0 + wrow + 16 * mt + (lane >> 2) +
                             ((e >> 1) << 3) + q_offset;
            const int kpos = k0 + nt * 8 + ((lane & 3) << 1) + (e & 1);
            bool ok = kpos < Skv;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && (qpos - kpos < window);
            if (!ok) s[mt][nt][e] = kNegInf;
          }
        }

    // online softmax on the lane's rows
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[mt][i];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * i], s[mt][nt][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f(m[mt][i] - mx);
        m[mt][i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          s[mt][nt][2 * i] = exp2f(s[mt][nt][2 * i] - mx);
          s[mt][nt][2 * i + 1] = exp2f(s[mt][nt][2 * i + 1] - mx);
          sum += s[mt][nt][2 * i] + s[mt][nt][2 * i + 1];
        }
        l[mt][i] = alpha * l[mt][i] + sum;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          acc[mt][dt][2 * i] *= alpha;
          acc[mt][dt][2 * i + 1] *= alpha;
        }
      }

    cp_wait<2>();  // V(t) has landed; tile t + 1 may still be in flight
    __syncthreads();
    // O += P V: P as bf16 A fragments straight from the S accumulators,
    // each V fragment feeding the warp's kMT row tiles
    const __nv_bfloat16* Vt = Vs + stage * L::kKV;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      unsigned pa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vf[4];
        ldsm_x4_t(vf, Vt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               kS +
                           dp * 16 + ((lane >> 4) << 3));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(acc[mt][2 * dp], pa[mt], vf[0], vf[1]);
          mma(acc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
  }

  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = 1.f / fmaxf(li, 1e-30f);
      const int r = q0 + wrow + 16 * mt + (lane >> 2) + 8 * i;
      if (r >= Sq) continue;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(ob + r * o_ss + dt * 8 +
                                           ((lane & 3) << 1)) =
            __floats2bfloat162_rn(acc[mt][dt][2 * i] * inv,
                                  acc[mt][dt][2 * i + 1] * inv);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, const long long* st,
           float scale, int causal, int q_offset, int window,
           cudaStream_t s) {
  constexpr int bytes = Layout<D>::kBytes;
  constexpr int threads = Layout<D>::kThreads;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + kBM - 1) / kBM, Hq, B);
  flash_tc_kernel<D><<<grid, threads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Hq, Hkv, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale * kLog2e, causal, q_offset,
      window);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ------------------------------------ bfloat16, D = 64 and 128: wgmma + TMA
// A persistent CTA of three roles per SM, walking the (q tile of 128 rows,
// q head, batch) items longest first: a producer warp whose one thread
// loads each item's q tile and keeps a 2-stage ring of K and V tiles (128
// keys) filled with TMA (a 4-D tensor map over the (D, S, H, B) view of
// each input, 128-byte swizzle, completion on mbarriers), running ahead
// into the next item while the consumers finish one; and two consumer
// warpgroups of 64 q rows each.  A consumer issues S = Q K^T as wgmma
// m64n128k16 with Q and K from shared memory, runs the online softmax on S
// in registers, and issues O += P V as wgmma with P as bf16 register
// fragments and V from shared memory (transposed B); then it frees the
// stage.  The two warpgroups run unsynchronised, so one's softmax overlaps
// the other's products.
namespace wg {

constexpr int kBM = 128;          // q rows per CTA
constexpr int kBN = 128;          // keys per K/V tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;     // warpgroups of 64 q rows
constexpr int kThreads = kConsumers * 128 + 32;  // + the producer warp

template <int D>
struct Layout {  // byte offsets from a 1024-aligned base
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBM * D * 2;
  static constexpr int kV = kK + kStages * kBN * D * 2;
  static constexpr int kBar = kV + kStages * kBN * D * 2;
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a box of the tensor map at coordinates (c0, c1, c2, c3) into smem
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the shared-memory matrix descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// 2^x, approximate (2 ulp), flushing subnormals; 2^-huge = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A B, A and B from shared memory (K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A from registers, B from shared memory (MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float* d, const unsigned* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A from registers, B from shared memory (MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const unsigned* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const unsigned* a,
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n64(o, a, db);
}

// item i of n_qt * Hq * B, longest q tiles first
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item item_at(int i, int n_qt, int Hq, int B) {
  const int hb = i % (Hq * B);
  return {(n_qt - 1 - i / (Hq * B)) * kBM, hb % Hq, hb / Hq};
}

// the K/V tiles visible to some row of q rows q0 .. q0 + 127: the first
// key and the tile count
__device__ __forceinline__ int2 key_range(int q0, int Sq, int Skv,
                                          int causal, int q_offset,
                                          int window) {
  const int q_rows = min(kBM, Sq - q0);
  int k_hi = Skv;
  if (causal) k_hi = min(k_hi, q0 + q_rows + q_offset);
  const int k_lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  return make_int2(k_lo, k_hi > k_lo ? (k_hi - k_lo + kBN - 1) / kBN : 0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int B, int Hq, int Hkv,
                int Sq, int Skv, long long o_sb, long long o_sh,
                long long o_ss, float scale_log2, int causal, int q_offset,
                int window) {
  using L = Layout<D>;
  constexpr int kHalves = D / 64;     // 128-byte swizzle atoms across D
  constexpr int kNT = kBN / 8;        // n8 column groups of S
  constexpr int kDT = D / 8;          // n8 column groups of O
  constexpr int kTileBytes = kBN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base + L::kQ;
  uint8_t* Ks = base + L::kK;
  uint8_t* Vs = base + L::kV;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* bar_q_free = bar_q + 1;
  uint64_t* bar_k = bar_q_free + 1;
  uint64_t* bar_v = bar_k + kStages;
  uint64_t* bar_free = bar_v + kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_qt = (Sq + kBM - 1) / kBM;
  const int n_items = n_qt * Hq * B;
  const int group = Hq / Hkv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_free, kConsumers * 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + s, 1);
      mbar_init(bar_v + s, 1);
      mbar_init(bar_free + s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer
    if (lane == 0) {
      int g = 0;  // K/V tiles loaded so far, over all items
      for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
        const Item w = item_at(i, n_qt, Hq, B);
        const int2 kr = key_range(w.q0, Sq, Skv, causal, q_offset, window);
        if (it > 0) mbar_wait(bar_q_free, (it - 1) & 1);
        mbar_expect_tx(bar_q, kBM * D * 2);
        for (int hf = 0; hf < kHalves; ++hf)
          tma_load(Qs + hf * kBM * 128, &tm_q, bar_q, 64 * hf, w.q0, w.h,
                   w.b);
        for (int t = 0; t < kr.y; ++t, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(bar_free + s, (g / kStages - 1) & 1);
          const int k0 = kr.x + t * kBN;
          mbar_expect_tx(bar_k + s, kTileBytes);
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load(Ks + s * kTileBytes + hf * kBN * 128, &tm_k, bar_k + s,
                     64 * hf, k0, w.h / group, w.b);
          mbar_expect_tx(bar_v + s, kTileBytes);
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load(Vs + s * kTileBytes + hf * kBN * 128, &tm_v, bar_v + s,
                     64 * hf, k0, w.h / group, w.b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: q rows wq .. wq + 63 of each item; this lane's
  // rows wq + 16 * (warp % 4) + (lane >> 2) + 8 i, i < 2
  const int wq = (warp / 4) * 64;
  const int row0 = wq + 16 * (warp % 4) + (lane >> 2);
  int g = 0;  // K/V tiles consumed so far, over all items
  for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
    const Item w = item_at(i, n_qt, Hq, B);
    const int2 kr = key_range(w.q0, Sq, Skv, causal, q_offset, window);
    const int qpos_lo = w.q0 + q_offset;
    const int qpos_hi = w.q0 + min(kBM, Sq - w.q0) - 1 + q_offset;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this lane's share of the row sums
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    mbar_wait(bar_q, it & 1);
    if (kr.y == 0) mbar_arrive(bar_q_free);

    for (int t = 0; t < kr.y; ++t, ++g) {
      const int s = g % kStages;
      const int parity = (g / kStages) & 1;
      const int k0 = kr.x + t * kBN;
      const uint8_t* Kt = Ks + s * kTileBytes;
      const uint8_t* Vt = Vs + s * kTileBytes;
      mbar_wait(bar_k + s, parity);
      float sc[kBN / 2];
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) sc[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(
            sc,
            desc(Qs + (kk / 4) * kBM * 128 + wq * 128 + (kk % 4) * 32, 16,
                 1024),
            desc(Kt + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait();
      if (t == kr.y - 1) mbar_arrive(bar_q_free);  // the next q tile may load

      // scale into log2 units; mask only tiles that cross an edge
      const bool edge = k0 + kBN > Skv ||
                        (causal && k0 + kBN - 1 > qpos_lo) ||
                        (window > 0 && qpos_hi - k0 >= window);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[nt * 4 + e];
          x *= scale_log2;
          if (edge) {
            const int qpos = w.q0 + row0 + ((e >> 1) << 3) + q_offset;
            const int kpos = k0 + nt * 8 + ((lane & 3) << 1) + (e & 1);
            bool ok = kpos < Skv;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && (qpos - kpos < window);
            if (!ok) x = kNegInf;
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mx = fmaxf(mx, fmaxf(sc[nt * 4 + 2 * r], sc[nt * 4 + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = ex2(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          float* x = sc + nt * 4 + 2 * r;
          x[0] = ex2(x[0] - mx);
          x[1] = ex2(x[1] - mx);
          sum += x[0] + x[1];
        }
        l[r] = alpha * l[r] + sum;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          acc[dt * 4 + 2 * r] *= alpha;
          acc[dt * 4 + 2 * r + 1] *= alpha;
        }
      }
      unsigned pa[kBN / 16][4];
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        pa[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
        pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
        pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
        pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
      }

      mbar_wait(bar_v + s, parity);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j)
        wgmma_pv<D>(acc, pa[j], desc(Vt + j * 2048, kBN * 128, 1024));
      wgmma_commit();
      wgmma_wait();
      mbar_arrive(bar_free + s);
    }

    __nv_bfloat16* ob = o + w.b * o_sb + w.h * o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      const int row = w.q0 + row0 + 8 * r;
      if (row >= Sq) continue;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * o_ss + dt * 8 +
                                           ((lane & 3) << 1)) =
            __floats2bfloat162_rn(acc[dt * 4 + 2 * r] * inv,
                                  acc[dt * 4 + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (D, S, H, B) view of a bf16 (B, H, S, D) tensor with D contiguous,
// in boxes of 64 x rows, 128-byte swizzled; 0 on success
int make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
             long long sb, long long sh, long long ss, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, const long long* st,
           float scale, int causal, int q_offset, int window,
           cudaStream_t s) {
  constexpr int bytes = Layout<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // an empty K/V (Skv = 0) is never loaded, but a tensor map needs rows
  const int kv_rows = Skv > 0 ? Skv : 1;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, D, Sq, Hq, B, st[0], st[1], st[2], kBM);
  if (!e) e = make_map(&tk, k, D, kv_rows, Hkv, B, st[3], st[4], st[5], kBN);
  if (!e) e = make_map(&tv, v, D, kv_rows, Hkv, B, st[6], st[7], st[8], kBN);
  if (e) return e;
  static int n_sm = 0;
  if (!n_sm) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess || n_sm <= 0)
      return (int)cudaErrorInvalidDevice;
  }
  const long long n_items = (long long)((Sq + kBM - 1) / kBM) * Hq * B;
  const int grid = (int)(n_items < n_sm ? n_items : n_sm);
  flash_wg_kernel<D><<<grid, kThreads, bytes, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, Hq, Hkv, Sq, Skv,
      st[9], st[10], st[11], scale * kLog2e, causal, q_offset, window);
  return (int)cudaGetLastError();
}

}  // namespace wg

// the float32 CUDA-core kernel
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Skv, const long long* st,
               float scale, int causal, int q_offset, int window,
               cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<float, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal, q_offset, window);
  return (int)cudaGetLastError();
}

// dtype 0 (float32): the CUDA-core kernel; 1 (bfloat16): tensor cores
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int Hq, int Hkv, int Sq, int Skv, const long long* st,
           float scale, int causal, int q_offset, int window,
           cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale, causal,
                         q_offset, window, s);
  if (dtype == 1) {
    if constexpr (D >= 64)
      return wg::launch<D>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale, causal,
                           q_offset, window, s);
    else
      return tc::launch<D>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale, causal,
                           q_offset, window, s);
  }
  return (int)cudaErrorInvalidValue;
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
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv,
                               strides, scale, causal, q_offset, window, s);
    case 32: return launch<32>(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv,
                               strides, scale, causal, q_offset, window, s);
    case 64: return launch<64>(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv,
                               strides, scale, causal, q_offset, window, s);
    case 128: return launch<128>(dtype, q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                 strides, scale, causal, q_offset, window,
                                 s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
