// Backward of blockwise (flash) grouped-query attention for Hopper (sm_90a).
//
// Port-only: the Pallas TPU kernel mha_flash (_flash_kernel) of
// src/repro/kernels/flash_attention.py has no backward kernel, since the
// reference differentiates its plain attention (ref.mha_ref) with XLA.  The
// port's forward (flash_attention.cu) writes its output through a pointer
// autograd cannot see into, so its gradient is these kernels
// (flash_attention.py: flash_attention_bwd, the FlashAttention autograd
// Function), held to the plain version ref.mha_backward_ref.
//
// For q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), the forward's output o
// and its row log-sum-exp lse (float32 (B, Hq, Sq)), and dO:
//   delta = rowsum(dO * O)
//   P = exp(scale q k^T - lse) over the visible keys, 0 elsewhere
//   dV = P^T dO,  dS = P * (dO V^T - delta),
//   dQ = scale dS K,  dK = scale dS^T Q,
// kv head j serving q heads j g .. j g + g - 1 (g = Hq / Hkv), its dK and dV
// summed over them.  Visibility is the forward's: causal with q rows at
// absolute positions q_offset + i, an optional window (qpos - kpos <
// window), keys at or past Skv never.  Outputs are in the inputs' type.
//
// Three launches, deterministic: no float atomics, every sum in a fixed
// order.
//   1. delta: one warp per q row, float32.
//   2. dK/dV: one CTA per (key tile, kv head, batch).  It holds its keys'
//      K and V in shared memory and loops over the group's q heads and,
//      for each, the q tiles whose rows can see a key of the tile,
//      recomputing P from lse; dK and dV accumulate in float32 registers,
//      the group summed inside the CTA.
//   3. dQ: one CTA per (q tile, q head, batch), looping over the key tiles
//      its rows can see.
//
// What bounds it on this card: operations.  The function needs five
// products of 2 D flops per visible (query, key) pair (S, dP, dV, dK, dQ);
// at the training shape (B 4, 32/8 heads, S 2048, D 128, causal) that is
// 344 GFLOP against 0.34 GB of q, k, v, o, dO, lse and gradients, so the
// tensor cores' 989 TFLOP/s set the bound (0.35 ms).  This first design
// recomputes S and dP in both kernels (seven products a pair) and feeds
// mma.sync from shared memory without overlapping the tile loads; wgmma
// and TMA are later work.
//
// bfloat16, any D in {16, 32, 64, 128}: mma.sync.m16n8k16 tensor cores
// with float32 accumulators, four warps of 16 rows (keys in dK/dV, q rows
// in dQ), tiles of 64 rows and inner tiles of 64 (32 at D = 128, to keep
// the accumulators in registers) copied by cp.async into shared memory
// rows padded by 16 bytes (ldmatrix free of bank conflicts).  P^T and dS^T
// (dS in dQ) are rounded to bf16 in registers as the A operands of the
// second products, as the forward rounds P.
//
// float32, any D: the CUDA cores (67 TFLOP/s), 256 threads, tiles of 32
// keys by 32 q rows staged in shared memory with rows of D + 1 floats
// (conflict-free column reads); P and dS go through shared memory.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing (delta is the caller's scratch), does not synchronise, and
// returns the first cudaGetLastError() that is not success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// whether the query at absolute position qpos sees key kpos
__device__ __forceinline__ bool visible(int qpos, int kpos, int Skv,
                                        int causal, int window) {
  bool ok = kpos < Skv;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && (qpos - kpos < window);
  return ok;
}

// the q rows [lo, hi) that can see a key of keys k0 .. k0 + n - 1; lo
// rounded down to a multiple of tile
__device__ __forceinline__ int2 q_range(int k0, int n, int Sq, int causal,
                                        int q_offset, int window, int tile) {
  const int lo = causal ? max(0, k0 - q_offset) : 0;
  const int hi = window > 0 ? min(Sq, k0 + n - 1 + window - q_offset) : Sq;
  return make_int2(lo / tile * tile, hi);
}

// the keys [lo, hi) that q rows q0 .. q0 + n - 1 can see
__device__ __forceinline__ int2 k_range(int q0, int n, int Skv, int causal,
                                        int q_offset, int window) {
  const int hi = causal ? min(Skv, q0 + n + q_offset) : Skv;
  const int lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  return make_int2(lo, hi);
}

// ------------------------------------------------ delta = rowsum(dO * O)
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int Hq, int Sq, int D,
             long long o_sb, long long o_sh, long long o_ss, long long d_sb,
             long long d_sh, long long d_ss) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (row >= Sq) return;  // the whole warp
  const T* orow = o + b * o_sb + h * o_sh + row * o_ss;
  const T* drow = dout + b * d_sb + h * d_sh + row * d_ss;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)b * Hq + h) * Sq + row] = acc;
}

// ------------------------------------------------- float32: CUDA cores
namespace f32 {

constexpr int kT = 32;  // rows of a key tile and of a q tile
constexpr int kThreads = 256;
constexpr int kPS = kT + 1;  // floats per row of P and dS

template <int D>
struct Smem {
  static constexpr int kRow = D + 1;  // floats per row of K, V, Q, dO
  static constexpr int kTile = kT * kRow;
  static constexpr int kBytes = (4 * kTile + 2 * kT * kPS + 2 * kT) * 4;
};

// kT x D of src (row stride `stride`, rows < n_valid) into dst; 0 past it
template <int D>
__device__ __forceinline__ void stage(const float* src, long long stride,
                                      int n_valid, float* dst) {
  for (int i = threadIdx.x; i < kT * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    dst[r * Smem<D>::kRow + c] = r < n_valid ? src[r * stride + c] : 0.f;
  }
}

// P and dS of a kT x kT tile (rows: q rows q0 + i, columns: keys k0 + j)
// into Ps and dSs ([i][j]); thread (i, jg) = (tid / 8, tid % 8) computes
// columns jg + 8 c
template <int D>
__device__ __forceinline__ void p_ds(const float* Qs, const float* dOs,
                                     const float* Ks, const float* Vs,
                                     const float* lse_s,
                                     const float* delta_s, int q0, int k0,
                                     int Sq, int Skv, float scale,
                                     int causal, int q_offset, int window,
                                     float* Ps, float* dSs) {
  constexpr int R = Smem<D>::kRow;
  const int i = threadIdx.x >> 3;
  const int jg = threadIdx.x & 7;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float qv = Qs[i * R + d];
    const float dv = dOs[i * R + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = fmaf(qv, Ks[(jg + 8 * c) * R + d], s[c]);
      dp[c] = fmaf(dv, Vs[(jg + 8 * c) * R + d], dp[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jg + 8 * c;
    const bool ok = q0 + i < Sq &&
                    visible(q0 + i + q_offset, k0 + j, Skv, causal, window);
    const float p = ok ? expf(s[c] * scale - lse_s[i]) : 0.f;
    Ps[i * kPS + j] = p;
    dSs[i * kPS + j] = p * (dp[c] - delta_s[i]);
  }
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv;
  int Hq, Hkv, Sq, Skv;
  long long st[24];
  float scale;
  int causal, q_offset, window;
};

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  constexpr int R = Smem<D>::kRow;
  constexpr int kC = D / 8;  // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + Smem<D>::kTile;
  float* Qs = Vs + Smem<D>::kTile;
  float* dOs = Qs + Smem<D>::kTile;
  float* Ps = dOs + Smem<D>::kTile;
  float* dSs = Ps + kT * kPS;
  float* lse_s = dSs + kT * kPS;
  float* delta_s = lse_s + kT;

  const int k0 = blockIdx.x * kT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int k_rows = min(kT, a.Skv - k0);
  const long long* st = a.st;
  stage<D>(a.k + b * st[3] + kvh * st[4] + k0 * st[5], st[5], k_rows, Ks);
  stage<D>(a.v + b * st[6] + kvh * st[7] + k0 * st[8], st[8], k_rows, Vs);
  const int2 qr = q_range(k0, k_rows, a.Sq, a.causal, a.q_offset, a.window,
                          kT);
  // this thread's outputs: key j, columns dg + 8 c
  const int j = threadIdx.x & 31;
  const int dg = threadIdx.x >> 5;
  float dk_acc[kC], dv_acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
    for (int q0 = qr.x; q0 < qr.y; q0 += kT) {
      const int q_rows = min(kT, a.Sq - q0);
      __syncthreads();  // the last tile's reads are done
      stage<D>(a.q + b * st[0] + h * st[1] + q0 * st[2], st[2], q_rows, Qs);
      stage<D>(a.dout + b * st[12] + h * st[13] + q0 * st[14], st[14],
               q_rows, dOs);
      if (threadIdx.x < kT) {
        const bool ok = threadIdx.x < q_rows;
        lse_s[threadIdx.x] = ok ? a.lse[lrow + q0 + threadIdx.x] : 0.f;
        delta_s[threadIdx.x] = ok ? a.delta[lrow + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      p_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, a.Sq, a.Skv, a.scale,
              a.causal, a.q_offset, a.window, Ps, dSs);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        const float p = Ps[i * kPS + j];
        const float ds = dSs[i * kPS + j];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dv_acc[c] = fmaf(p, dOs[i * R + dg + 8 * c], dv_acc[c]);
          dk_acc[c] = fmaf(ds, Qs[i * R + dg + 8 * c], dk_acc[c]);
        }
      }
    }
  }
  if (j < k_rows) {
    float* dkr = a.dk + b * st[18] + kvh * st[19] + (k0 + j) * st[20];
    float* dvr = a.dv + b * st[21] + kvh * st[22] + (k0 + j) * st[23];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dkr[dg + 8 * c] = dk_acc[c] * a.scale;
      dvr[dg + 8 * c] = dv_acc[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  constexpr int R = Smem<D>::kRow;
  constexpr int kC = D / 8;
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + Smem<D>::kTile;
  float* Qs = Vs + Smem<D>::kTile;
  float* dOs = Qs + Smem<D>::kTile;
  float* Ps = dOs + Smem<D>::kTile;
  float* dSs = Ps + kT * kPS;
  float* lse_s = dSs + kT * kPS;
  float* delta_s = lse_s + kT;

  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q_rows = min(kT, a.Sq - q0);
  const long long* st = a.st;
  const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
  stage<D>(a.q + b * st[0] + h * st[1] + q0 * st[2], st[2], q_rows, Qs);
  stage<D>(a.dout + b * st[12] + h * st[13] + q0 * st[14], st[14], q_rows,
           dOs);
  if (threadIdx.x < kT) {
    const bool ok = threadIdx.x < q_rows;
    lse_s[threadIdx.x] = ok ? a.lse[lrow + q0 + threadIdx.x] : 0.f;
    delta_s[threadIdx.x] = ok ? a.delta[lrow + q0 + threadIdx.x] : 0.f;
  }
  const int2 kr = k_range(q0, q_rows, a.Skv, a.causal, a.q_offset, a.window);
  // this thread's outputs: q row i, columns dg + 8 c
  const int i = threadIdx.x & 31;
  const int dg = threadIdx.x >> 5;
  float dq_acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) dq_acc[c] = 0.f;

  for (int k0 = kr.x; k0 < kr.y; k0 += kT) {
    const int k_rows = min(kT, a.Skv - k0);
    __syncthreads();  // the last tile's reads are done (and Q staged)
    stage<D>(a.k + b * st[3] + kvh * st[4] + k0 * st[5], st[5], k_rows, Ks);
    stage<D>(a.v + b * st[6] + kvh * st[7] + k0 * st[8], st[8], k_rows, Vs);
    __syncthreads();
    p_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, a.Sq, a.Skv, a.scale,
            a.causal, a.q_offset, a.window, Ps, dSs);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kT; ++jj) {
      const float ds = dSs[i * kPS + jj];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        dq_acc[c] = fmaf(ds, Ks[jj * R + dg + 8 * c], dq_acc[c]);
    }
  }
  if (i < q_rows) {
    float* dqr = a.dq + b * st[15] + h * st[16] + (q0 + i) * st[17];
#pragma unroll
    for (int c = 0; c < kC; ++c) dqr[dg + 8 * c] = dq_acc[c] * a.scale;
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t s) {
  constexpr int bytes = Smem<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (a.Skv > 0) {
    dkdv_kernel<D><<<dim3((a.Skv + kT - 1) / kT, a.Hkv, B), kThreads, bytes,
                     s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  dq_kernel<D><<<dim3((a.Sq + kT - 1) / kT, a.Hq, B), kThreads, bytes, s>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -------------------------------------- bfloat16: mma.sync tensor cores
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kBM = 64;        // rows of the CTA's own tile

template <int D>
struct Cfg {
  static constexpr int kStride = D + 8;  // bf16 per smem row: +16 bytes
  // rows of the inner loop's tiles (q rows in dK/dV, keys in dQ): 32 at
  // D = 128 keeps S and dP beside the two D-wide accumulators in registers
  static constexpr int kIn = D == 128 ? 32 : 64;
  static constexpr int kOwn = kBM * kStride;  // elements of an own tile
  static constexpr int kInner = kIn * kStride;
  static constexpr int kBytes = (2 * kOwn + 2 * kInner) * 2 + 2 * kIn * 4;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// two floats as a bf16x2 register, lo in the low half (an mma A fragment)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

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

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
__device__ __forceinline__ void load_rows(const bf16* src, long long stride,
                                          int n_valid, bf16* dst) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * Cfg<D>::kStride + c,
               src + (ok ? r : 0) * stride + c, ok);
  }
}

// The three operand loads.  With an accumulator's rows r = (lane >> 2) +
// 8 (e >> 1) and columns (lane & 3) * 2 + (e & 1) of each n8 tile:
//
// the A fragment of rows r0 .. r0 + 15, columns kk * 16 .. + 15 of X
template <int D>
__device__ __forceinline__ void load_a(unsigned* f, const bf16* X, int r0,
                                       int kk, int lane) {
  ldsm_x4(f, X + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                     Cfg<D>::kStride +
                 kk * 16 + ((lane >> 4) << 3));
}

// B fragments of Y^T (the product X Y^T): Y's rows n0 .. n0 + 15 as two n8
// tiles (f[0..1], f[2..3]), its columns kk * 16 .. + 15 as k
template <int D>
__device__ __forceinline__ void load_bt(unsigned* f, const bf16* Y, int n0,
                                        int kk, int lane) {
  ldsm_x4(f, Y + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Cfg<D>::kStride +
                 kk * 16 + (((lane >> 3) & 1) << 3));
}

// B fragments of Y (the product X Y): Y's rows kk * 16 .. + 15 as k, its
// columns n0 .. n0 + 15 as two n8 tiles (f[0..1], f[2..3])
template <int D>
__device__ __forceinline__ void load_b(unsigned* f, const bf16* Y, int kk,
                                       int n0, int lane) {
  ldsm_x4_t(f, Y + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                       Cfg<D>::kStride +
                   n0 + ((lane >> 4) << 3));
}

// accumulator n8 tiles 2 kk and 2 kk + 1 as a bf16 A fragment (k = their
// 16 columns)
__device__ __forceinline__ void to_a(unsigned* f, const float* t0,
                                     const float* t1) {
  f[0] = pack_bf16(t0[0], t0[1]);
  f[1] = pack_bf16(t0[2], t0[3]);
  f[2] = pack_bf16(t1[0], t1[1]);
  f[3] = pack_bf16(t1[2], t1[3]);
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int Hq, Hkv, Sq, Skv;
  long long st[24];
  float scale, scale_log2;
  int causal, q_offset, window;
};

// the accumulators (rows 16 w + (lane >> 2) + 8 i, i < 2) of a D-wide
// output into rows row0 + that of dst, times mul, where row < n_rows
template <int D>
__device__ __forceinline__ void store_rows(const float (*acc)[4], bf16* dst,
                                           long long stride, int r_warp,
                                           int n_rows, float mul,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_warp + (lane >> 2) + 8 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + r * stride + dt * 8 +
                                         ((lane & 3) << 1)) =
          __floats2bfloat162_rn(acc[dt][2 * i] * mul,
                                acc[dt][2 * i + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int kQ = C::kIn;    // q rows per inner tile
  constexpr int kNT = kQ / 8;   // n8 tiles of S^T (q columns)
  constexpr int kDK = D / 16;   // k16 steps over D
  constexpr int kDT = D / 8;    // n8 tiles of dK and dV
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* Vs = Ks + C::kOwn;
  bf16* Qs = Vs + C::kOwn;
  bf16* dOs = Qs + C::kInner;
  float* lse_s = reinterpret_cast<float*>(dOs + C::kInner);
  float* delta_s = lse_s + kQ;

  const int k0 = blockIdx.x * kBM;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = a.Hq / a.Hkv;
  const int k_rows = min(kBM, a.Skv - k0);
  const long long* st = a.st;
  load_rows<D, kBM>(a.k + b * st[3] + kvh * st[4] + k0 * st[5], st[5],
                    k_rows, Ks);
  load_rows<D, kBM>(a.v + b * st[6] + kvh * st[7] + k0 * st[8], st[8],
                    k_rows, Vs);
  cp_commit();
  const int2 qr = q_range(k0, k_rows, a.Sq, a.causal, a.q_offset, a.window,
                          kQ);
  const int wk = warp * 16;  // the warp's first key of the tile
  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
    for (int q0 = qr.x; q0 < qr.y; q0 += kQ) {
      const int q_rows = min(kQ, a.Sq - q0);
      __syncthreads();  // every warp is done with the last tile
      load_rows<D, kQ>(a.q + b * st[0] + h * st[1] + q0 * st[2], st[2],
                       q_rows, Qs);
      load_rows<D, kQ>(a.dout + b * st[12] + h * st[13] + q0 * st[14],
                       st[14], q_rows, dOs);
      cp_commit();
      if (threadIdx.x < kQ) {
        const bool ok = threadIdx.x < q_rows;
        lse_s[threadIdx.x] =
            ok ? a.lse[lrow + q0 + threadIdx.x] * kLog2e : 0.f;
        delta_s[threadIdx.x] = ok ? a.delta[lrow + q0 + threadIdx.x] : 0.f;
      }
      cp_wait_all();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
      float st_[kNT][4], dpt[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st_[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        unsigned ka[4], va[4];
        load_a<D>(ka, Ks, wk, kk, lane);
        load_a<D>(va, Vs, wk, kk, lane);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          unsigned qf[4], df[4];
          load_bt<D>(qf, Qs, np * 16, kk, lane);
          load_bt<D>(df, dOs, np * 16, kk, lane);
          mma(st_[2 * np], ka, qf[0], qf[1]);
          mma(st_[2 * np + 1], ka, qf[2], qf[3]);
          mma(dpt[2 * np], va, df[0], df[1]);
          mma(dpt[2 * np + 1], va, df[2], df[3]);
        }
      }
      // P^T and dS^T in place (rows: keys, columns: q rows)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + wk + (lane >> 2) + ((e >> 1) << 3);
          const int qi = nt * 8 + ((lane & 3) << 1) + (e & 1);
          const bool ok = q0 + qi < a.Sq &&
                          visible(q0 + qi + a.q_offset, kpos, a.Skv,
                                  a.causal, a.window);
          const float p =
              ok ? exp2f(st_[nt][e] * a.scale_log2 - lse_s[qi]) : 0.f;
          st_[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - delta_s[qi]);
        }
      // dV += P^T dO and dK += dS^T Q, the q rows as k
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        unsigned pa[4], sa[4];
        to_a(pa, st_[2 * kk], st_[2 * kk + 1]);
        to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          unsigned df[4], qf[4];
          load_b<D>(df, dOs, kk, dp * 16, lane);
          load_b<D>(qf, Qs, kk, dp * 16, lane);
          mma(dv_acc[2 * dp], pa, df[0], df[1]);
          mma(dv_acc[2 * dp + 1], pa, df[2], df[3]);
          mma(dk_acc[2 * dp], sa, qf[0], qf[1]);
          mma(dk_acc[2 * dp + 1], sa, qf[2], qf[3]);
        }
      }
    }
  }
  cp_wait_all();  // K and V, where no q tile was loaded
  store_rows<D>(dk_acc, a.dk + b * st[18] + kvh * st[19] + k0 * st[20],
                st[20], wk, k_rows, a.scale, lane);
  store_rows<D>(dv_acc, a.dv + b * st[21] + kvh * st[22] + k0 * st[23],
                st[23], wk, k_rows, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int kK = C::kIn;    // keys per inner tile
  constexpr int kNT = kK / 8;   // n8 tiles of S (key columns)
  constexpr int kDK = D / 16;
  constexpr int kDT = D / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* dOs = Qs + C::kOwn;
  bf16* Ks = dOs + C::kOwn;
  bf16* Vs = Ks + C::kInner;

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kBM, a.Sq - q0);
  const long long* st = a.st;
  load_rows<D, kBM>(a.q + b * st[0] + h * st[1] + q0 * st[2], st[2], q_rows,
                    Qs);
  load_rows<D, kBM>(a.dout + b * st[12] + h * st[13] + q0 * st[14], st[14],
                    q_rows, dOs);
  cp_commit();
  const int wq = warp * 16;  // the warp's first q row of the tile
  const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
  float lse_r[2], delta_r[2];  // the lane's rows wq + (lane >> 2) + 8 i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wq + (lane >> 2) + 8 * i;
    const bool ok = r < q_rows;
    lse_r[i] = ok ? a.lse[lrow + q0 + r] * kLog2e : 0.f;
    delta_r[i] = ok ? a.delta[lrow + q0 + r] : 0.f;
  }
  const int2 kr = k_range(q0, q_rows, a.Skv, a.causal, a.q_offset, a.window);
  float dq_acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dt][e] = 0.f;

  for (int k0 = kr.x; k0 < kr.y; k0 += kK) {
    const int k_rows = min(kK, a.Skv - k0);
    __syncthreads();  // every warp is done with the last tile
    load_rows<D, kK>(a.k + b * st[3] + kvh * st[4] + k0 * st[5], st[5],
                     k_rows, Ks);
    load_rows<D, kK>(a.v + b * st[6] + kvh * st[7] + k0 * st[8], st[8],
                     k_rows, Vs);
    cp_commit();
    cp_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 q rows
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      unsigned qa[4], da[4];
      load_a<D>(qa, Qs, wq, kk, lane);
      load_a<D>(da, dOs, wq, kk, lane);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned kf[4], vf[4];
        load_bt<D>(kf, Ks, np * 16, kk, lane);
        load_bt<D>(vf, Vs, np * 16, kk, lane);
        mma(s[2 * np], qa, kf[0], kf[1]);
        mma(s[2 * np + 1], qa, kf[2], kf[3]);
        mma(dp[2 * np], da, vf[0], vf[1]);
        mma(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }
    // dS in place of dP (rows: q rows, columns: keys)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = wq + (lane >> 2) + 8 * i;
        const int kpos = k0 + nt * 8 + ((lane & 3) << 1) + (e & 1);
        const bool ok = r < q_rows && visible(q0 + r + a.q_offset, kpos,
                                              a.Skv, a.causal, a.window);
        const float p = ok ? exp2f(s[nt][e] * a.scale_log2 - lse_r[i]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - delta_r[i]);
      }
    // dQ += dS K, the keys as k
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      unsigned sa[4];
      to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        unsigned kf[4];
        load_b<D>(kf, Ks, kk, dn * 16, lane);
        mma(dq_acc[2 * dn], sa, kf[0], kf[1]);
        mma(dq_acc[2 * dn + 1], sa, kf[2], kf[3]);
      }
    }
  }
  cp_wait_all();  // Q and dO, where no key tile was loaded
  store_rows<D>(dq_acc, a.dq + b * st[15] + h * st[16] + q0 * st[17],
                st[17], wq, q_rows, a.scale, lane);
}

template <int D>
int launch(const Args& a, int B, cudaStream_t s) {
  constexpr int bytes = Cfg<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (a.Skv > 0) {
    dkdv_kernel<D><<<dim3((a.Skv + kBM - 1) / kBM, a.Hkv, B), kThreads,
                     bytes, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  dq_kernel<D><<<dim3((a.Sq + kBM - 1) / kBM, a.Hq, B), kThreads, bytes,
                 s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B,
                 int Hq, int Sq, int D, const long long* st,
                 cudaStream_t s) {
  delta_kernel<T><<<dim3((Sq + 7) / 8, Hq, B), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, Hq, Sq,
      D, st[9], st[10], st[11], st[12], st[13], st[14]);
  return (int)cudaGetLastError();
}

template <typename A, typename T>
A make_args(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dq, void* dk,
            void* dv, int Hq, int Hkv, int Sq, int Skv,
            const long long* st, float scale, int causal, int q_offset,
            int window) {
  A a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.dout = static_cast<const T*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  for (int i = 0; i < 24; ++i) a.st[i] = st[i];
  a.scale = scale;
  a.causal = causal;
  a.q_offset = q_offset;
  a.window = window;
  return a;
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* delta,
           void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
           int Skv, const long long* st, float scale, int causal,
           int q_offset, int window, cudaStream_t s) {
  if (dtype == 0) {
    int e = launch_delta<float>(o, dout, delta, B, Hq, Sq, D, st, s);
    if (e) return e;
    const f32::Args a = make_args<f32::Args, float>(
        q, k, v, dout, lse, delta, dq, dk, dv, Hq, Hkv, Sq, Skv, st, scale,
        causal, q_offset, window);
    return f32::launch<D>(a, B, s);
  }
  if (dtype == 1) {
    int e = launch_delta<__nv_bfloat16>(o, dout, delta, B, Hq, Sq, D, st, s);
    if (e) return e;
    tc::Args a = make_args<tc::Args, __nv_bfloat16>(
        q, k, v, dout, lse, delta, dq, dk, dv, Hq, Hkv, Sq, Skv, st, scale,
        causal, q_offset, window);
    a.scale_log2 = scale * kLog2e;
    return tc::launch<D>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  strides (in elements), three each
// (batch, head, row) for q, k, v, o, dO, dQ, dK, dV in that order; the
// stride of D is 1 for all eight, the others multiples of 8 (16-byte rows).
// lse: the forward's contiguous float32 (B, Hq, Sq); delta: scratch of the
// same shape.  D in {16, 32, 64, 128}; Hq a multiple of Hkv; B, Hq <= 65535.
int trees_flash_attention_bwd(int dtype, const void* q, const void* k,
                              const void* v, const void* o,
                              const void* dout, const float* lse,
                              float* delta, void* dq, void* dk, void* dv,
                              int B, int Hq, int Hkv, int Sq, int Skv, int D,
                              const long long* strides, float scale,
                              int causal, int q_offset, int window,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0) return 0;
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, o, dout, lse, delta, dq, dk,
                               dv, B, Hq, Hkv, Sq, Skv, strides, scale,
                               causal, q_offset, window, s);
    case 32: return launch<32>(dtype, q, k, v, o, dout, lse, delta, dq, dk,
                               dv, B, Hq, Hkv, Sq, Skv, strides, scale,
                               causal, q_offset, window, s);
    case 64: return launch<64>(dtype, q, k, v, o, dout, lse, delta, dq, dk,
                               dv, B, Hq, Hkv, Sq, Skv, strides, scale,
                               causal, q_offset, window, s);
    case 128: return launch<128>(dtype, q, k, v, o, dout, lse, delta, dq, dk,
                                 dv, B, Hq, Hkv, Sq, Skv, strides, scale,
                                 causal, q_offset, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
