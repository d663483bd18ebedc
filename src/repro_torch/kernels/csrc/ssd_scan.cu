// Mamba-2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_scan (_ssd_kernel) of
// src/repro/kernels/ssd_scan.py.  For each sequence b and head h it runs the
// recurrence h_t = exp(A dt_t) h_{t-1} + dt_t (x_t outer B_t), y_t = h_t C_t
// over the S steps, in chunks of kT steps (the state-space-duality form):
//   y     = ((C B^T) o M)(dt o X) + exp(cum) o (C . h),
//           M[t, s] = exp(cum_t - cum_s) for s <= t, else 0;
//   h'    = exp(cum_T) h + X^T diag(dt exp(cum_T - cum)) B,
// where cum is the inclusive cumulative sum of A dt within the chunk.  Every
// exponent is <= 0 (M is never factored into exp(cum_t) exp(-cum_s): dt
// reaches 20 at mamba2, and exp(-cum_s) would overflow within a chunk).  B
// and C are shared by all heads (one group).  The serving path's prefill
// calls it once per SSM layer (models/ssm.py, apply_ssm), with x, B and C as
// strided slices of the conv output.
//
// What bounds it on this card: memory.  At the mamba2-1.3b prefill bucket
// (16 sequences x 1024 steps, 64 heads of P = 64, N = 128, bf16) the function
// reads x (134.2 MB), B and C (8.4 MB), dt (2.1 MB) and writes y (134.2 MB)
// and h (33.6 MB, float32): about 312 MB, 0.093 ms at 3.35 TB/s.  The chunked
// form does 81,920 flops per (step, head) at the reference's chunk of 128,
// 85.9 GFLOP, 0.087 ms at the 989 TFLOP/s of the bf16 tensor cores.
//
// Two designs, chosen by dtype and shape alone (ssd_scan.pick_design):
//
// Tensor cores (bfloat16, P in {16, 32, 64}, N in {16, 32, 64, 128}).  The
// first design (still the CUDA-core one below) multiplied in float32 on the
// CUDA cores, 1.8 M multiply-adds per (chunk, head) from float32 staging
// (130 KB of shared memory, one CTA of 8 warps an SM, every chunk loaded
// synchronously), with C B^T recomputed for every head: 3.7 ms at the
// bucket, 2.5 % of its bound.  Now two launches:
//   1. ssd_gram_kernel: G = C B^T (kT x kT, float32) once per (sequence,
//      chunk), written to caller scratch (4 MB at the bucket, read back
//      from L2).  G does not depend on the head, so computing it per head
//      would be 29 % of the products for nothing.
//   2. ssd_tc_kernel: one CTA per (sequence, pair of heads).  The chunk
//      loop stays inside the CTA, in order, and each warp keeps its 16 rows
//      of the float32 state (all N columns) in registers, in the mma
//      accumulator layout, for the whole scan, as the TPU kept it in VMEM.
//      Chunks are staged in bfloat16 (x of both heads, B, C) with G in a
//      2-stage cp.async ring: chunk c + 1 loads while chunk c computes.  The
//      first warp of each head scans A dt; then the head's warps write W in
//      bf16 over the 16-row blocks below the diagonal and meet on a named
//      barrier; then the three products, transposed so that the state
//      never leaves registers:
//        Y^T  = h C^T o exp(cum) + X^T W^T
//        h    = exp(cum_T) h + X'^T B
//      At P = 64 with N a multiple of 64 (mamba2) a warpgroup takes a head:
//      wgmma m64n64k16 for h C^T (h as register A fragments from its
//      accumulators, C a K-major B) and for X^T W^T (X^T from ldmatrix, W a
//      K-major B whose upper blocks are zeroed once), m64nNk16 for the
//      update (X' from registers, B an MN-major B), from 128-byte-swizzled
//      tiles that cp.async and the W loop write in wgmma's layout: 8 + 4 + 4
//      wgmma a chunk at N = 128.  Elsewhere (hymba's N = 16, P = 16 or 32)
//      each warp runs its 16 rows as mma.sync.m16n8k16 tiles (the masked
//      product skipping blocks above the diagonal), two CTAs sharing an SM
//      at N = 16.  y goes out through the x rows the warp alone has read,
//      16 bytes a row half.
//   Rounding points (ref.ssd_chunked_tc repeats them): W = G o M o dt is
//   rounded to bf16 as an operand; X' = x o dt exp(cum_T - cum) is rounded
//   to bf16; the state is rounded to bf16 as the A operand of h C^T.  G, the
//   accumulators and the carried state stay float32.  Staging is 16-byte
//   cp.async where x, B and C are 16-byte aligned with strides of 8
//   elements (the model's conv slices are), else plain loads.
//   What still bounds it is not settled (no profiler runs on the card's
//   machine): switching off any one phase of a chunk (the scan of dt, W,
//   the products, the loads, y's stores) shortens the kernel by about that
//   phase's share, yet neither fewer tensor-core cycles (wgmma in place of
//   mma.sync at mamba2) nor more overlap (a third ring stage; issuing h C^T
//   and the update before W; one head a CTA, two CTAs an SM) moved it
//   much.  A warp-specialized design (a TMA producer on mbarriers, W on
//   warps of its own, as flash_attention's) is the next thing to try.

// CUDA cores (float32, and bfloat16 where P or N is 8).  TF32 would break
// the float32 checks (1e-4 against the plain version on the card, the
// float32 card-vs-CPU logits), so float32 keeps this design: one CTA of 256
// threads per (head, sequence) walks its chunks in order and keeps the
// float32 state in registers (a strided P x N tile per thread), with a copy
// in shared memory for the carry product.  Per chunk it stages dt, x, B and
// C as float32 (rows past S are zero, so dt = 0 makes them no-ops), scans
// A dt in one warp, and runs three block products from shared memory, each
// thread owning a strided TM x TN tile of the output (consecutive threads on
// consecutive columns; row strides of B, C, h and W are odd, so the column
// reads are free of bank conflicts):
//   W = (C B^T) o M o dt_s                          kT x kT, depth N
//   y = exp(cum_t) (C h^T) + W X                    kT x P,  depth N + kT
//   h = exp(cum_T) h + (X o dt exp(cum_T - cum))^T B  P x N, depth kT
// kT = 64 keeps shared memory at 130 KB for P = 64, N = 128 (x, B, C, h, W),
// inside a block's 227 KB.  The reference's chunk is 128; the result does
// not depend on the chunk beyond rounding.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // steps per chunk
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kT == 64, "the A dt scan gives each lane two steps");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// How kThreads threads cover an M x NC output: each of the first kUsed
// threads owns TM rows (ti + m * RT) and TN columns (tj + n * CT), with
// tj = tid % CT and ti = tid / CT.
template <int M, int NC>
struct Tile {
  static constexpr int kPer = M * NC >= kThreads ? M * NC / kThreads : 1;
  static constexpr int TN = kPer >= 4 ? (NC < 4 ? NC : 4)
                                      : (kPer < NC ? kPer : NC);
  static constexpr int TM = kPer / TN;
  static constexpr int CT = NC / TN;
  static constexpr int RT = M / TM;
  static constexpr int kUsed = RT * CT;
  static_assert(TM * TN == kPer && RT * TM == M && CT * TN == NC,
                "the tile covers the output");
  static_assert(kUsed <= kThreads, "one tile per thread");
};

// acc[m][n] += sum_{k < K} A(row m, k) * B(k, col n), with
// A(i, k) = a[i * AI + k * AK] and B(k, j) = b[k * BK + j * BJ] in shared
// memory, row m = ti + m * Tl::RT, col n = tj + n * Tl::CT.
template <class Tl, int K, int AI, int AK, int BK, int BJ>
__device__ __forceinline__ void mac(float (&acc)[Tl::TM][Tl::TN],
                                    const float* a, const float* b, int ti,
                                    int tj) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[Tl::TM], bv[Tl::TN];
#pragma unroll
    for (int m = 0; m < Tl::TM; ++m) av[m] = a[(ti + m * Tl::RT) * AI + k * AK];
#pragma unroll
    for (int n = 0; n < Tl::TN; ++n) bv[n] = b[k * BK + (tj + n * Tl::CT) * BJ];
#pragma unroll
    for (int m = 0; m < Tl::TM; ++m)
#pragma unroll
      for (int n = 0; n < Tl::TN; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
  }
}

template <int P, int N>
constexpr int smem_floats() {
  return kT * P + 2 * kT * (N + 1) + P * (N + 1) + kT * (kT + 1) + 2 * kT;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ hout, int H, int S,
           long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
           long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
           long long c_sb, long long c_ss) {
  constexpr int LDN = N + 1;   // rows of B, C and h
  constexpr int LDW = kT + 1;  // rows of W
  using TW = Tile<kT, kT>;
  using TY = Tile<kT, P>;
  using TH = Tile<P, N>;

  extern __shared__ float smem[];
  float* xs = smem;              // kT x P
  float* Bs = xs + kT * P;       // kT x LDN
  float* Cs = Bs + kT * LDN;     // kT x LDN
  float* hs = Cs + kT * LDN;     // P x LDN
  float* Ws = hs + P * LDN;      // kT x LDW
  float* dts = Ws + kT * LDW;    // kT
  float* cums = dts + kT;        // kT

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[h];
  x += b * x_sb + h * x_sh;
  dt += b * dt_sb + h * dt_sh;
  Bm += b * b_sb;
  Cm += b * c_sb;
  y += ((long long)b * S * H + h) * P;  // y[b, t, h, p] at t * H * P + p
  const long long hoff = ((long long)b * H + h) * P * N;

  // the state tile, in registers for the whole scan
  const bool hown = tid < TH::kUsed;
  const int hti = tid / TH::CT;
  const int htj = tid % TH::CT;
  float hr[TH::TM][TH::TN];
#pragma unroll
  for (int m = 0; m < TH::TM; ++m)
#pragma unroll
    for (int n = 0; n < TH::TN; ++n) {
      const int p = hti + m * TH::RT, c = htj + n * TH::CT;
      hr[m][n] = (hown && h0 != nullptr) ? h0[hoff + p * N + c] : 0.f;
      if (hown) hs[p * LDN + c] = hr[m][n];
    }

  for (int t0 = 0; t0 < S; t0 += kT) {
    __syncthreads();  // the last chunk's readers are done, hs is written
    for (int i = tid; i < kT; i += kThreads)
      dts[i] = t0 + i < S ? to_f(dt[(t0 + i) * dt_ss]) : 0.f;
    for (int i = tid; i < kT * P; i += kThreads) {
      const int t = t0 + i / P;
      xs[i] = t < S ? to_f(x[t * x_ss + i % P]) : 0.f;
    }
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N, c = i % N, t = t0 + r;
      Bs[r * LDN + c] = t < S ? to_f(Bm[t * b_ss + c]) : 0.f;
      Cs[r * LDN + c] = t < S ? to_f(Cm[t * c_ss + c]) : 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // inclusive scan of A dt over the chunk
      const float v0 = a * dts[2 * tid];
      const float v1 = v0 + a * dts[2 * tid + 1];
      float s = v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, s, off);
        if (tid >= off) s += o;
      }
      cums[2 * tid] = s - v1 + v0;
      cums[2 * tid + 1] = s;
    }
    __syncthreads();

    // W[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t
    if (tid < TW::kUsed) {
      const int ti = tid / TW::CT, tj = tid % TW::CT;
      float acc[TW::TM][TW::TN] = {};
      mac<TW, N, LDN, 1, 1, LDN>(acc, Cs, Bs, ti, tj);
#pragma unroll
      for (int m = 0; m < TW::TM; ++m)
#pragma unroll
        for (int n = 0; n < TW::TN; ++n) {
          const int t = ti + m * TW::RT, s = tj + n * TW::CT;
          Ws[t * LDW + s] =
              s <= t ? acc[m][n] * expf(fminf(cums[t] - cums[s], 0.f)) * dts[s]
                     : 0.f;
        }
    }
    __syncthreads();

    // y[t, p] = exp(cum_t) (C_t . h_p) + sum_s W[t, s] x[s, p]
    if (tid < TY::kUsed) {
      const int ti = tid / TY::CT, tj = tid % TY::CT;
      float acc[TY::TM][TY::TN] = {};
      mac<TY, N, LDN, 1, 1, LDN>(acc, Cs, hs, ti, tj);
#pragma unroll
      for (int m = 0; m < TY::TM; ++m) {
        const float e = expf(cums[ti + m * TY::RT]);
#pragma unroll
        for (int n = 0; n < TY::TN; ++n) acc[m][n] *= e;
      }
      mac<TY, kT, LDW, 1, P, 1>(acc, Ws, xs, ti, tj);
#pragma unroll
      for (int m = 0; m < TY::TM; ++m) {
        const int t = t0 + ti + m * TY::RT;
        if (t < S) {
#pragma unroll
          for (int n = 0; n < TY::TN; ++n)
            store1(y + (long long)t * H * P + tj + n * TY::CT, acc[m][n]);
        }
      }
    }
    __syncthreads();

    // x[s, p] *= dt_s exp(cum_T - cum_s), then the state update
    const float cl = cums[kT - 1];
    for (int i = tid; i < kT * P; i += kThreads) {
      const int s = i / P;
      xs[i] *= dts[s] * expf(cl - cums[s]);
    }
    __syncthreads();
    if (hown) {
      const float decay = expf(cl);
#pragma unroll
      for (int m = 0; m < TH::TM; ++m)
#pragma unroll
        for (int n = 0; n < TH::TN; ++n) hr[m][n] *= decay;
      mac<TH, kT, 1, P, LDN, 1>(hr, xs, Bs, hti, htj);
#pragma unroll
      for (int m = 0; m < TH::TM; ++m)
#pragma unroll
        for (int n = 0; n < TH::TN; ++n)
          hs[(hti + m * TH::RT) * LDN + htj + n * TH::CT] = hr[m][n];
    }
  }

  if (hown) {
#pragma unroll
    for (int m = 0; m < TH::TM; ++m)
#pragma unroll
      for (int n = 0; n < TH::TN; ++n)
        hout[hoff + (hti + m * TH::RT) * N + htj + n * TH::CT] = hr[m][n];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout, int Bt,
           int S, int H, const long long* st, cudaStream_t s) {
  constexpr int bytes = smem_floats<P, N>() * (int)sizeof(float);
  auto kernel = ssd_kernel<T, P, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, Bt);
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), h0,
      static_cast<T*>(y), hout, H, S, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const void* dt, const float* A,
               const void* Bm, const void* Cm, const float* h0, void* y,
               float* hout, int Bt, int S, int H, const long long* st,
               cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, P, 8>(x, dt, A, Bm, Cm, h0, y, hout, Bt, S, H,
                                   st, s);
    case 16: return launch<T, P, 16>(x, dt, A, Bm, Cm, h0, y, hout, Bt, S, H,
                                     st, s);
    case 32: return launch<T, P, 32>(x, dt, A, Bm, Cm, h0, y, hout, Bt, S, H,
                                     st, s);
    case 64: return launch<T, P, 64>(x, dt, A, Bm, Cm, h0, y, hout, Bt, S, H,
                                     st, s);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, h0, y, hout, Bt, S,
                                       H, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_p(int P, int N, const void* x, const void* dt, const float* A,
               const void* Bm, const void* Cm, const float* h0, void* y,
               float* hout, int Bt, int S, int H, const long long* st,
               cudaStream_t s) {
  switch (P) {
    case 8: return dispatch_n<T, 8>(N, x, dt, A, Bm, Cm, h0, y, hout, Bt, S,
                                    H, st, s);
    case 16: return dispatch_n<T, 16>(N, x, dt, A, Bm, Cm, h0, y, hout, Bt, S,
                                      H, st, s);
    case 32: return dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, h0, y, hout, Bt, S,
                                      H, st, s);
    case 64: return dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, h0, y, hout, Bt, S,
                                      H, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ bfloat16: tensor cores
namespace tc {

constexpr int kT = 64;             // steps per chunk
constexpr int kHG = 2;             // heads per CTA
constexpr int kGramThreads = 128;  // 4 warps, 16 rows of G each
using bf16 = __nv_bfloat16;

struct Strides {  // in elements
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// 8 bf16 of a row into shared memory: a 16-byte cp.async (vec), else eight
// 2-byte loads and one 16-byte store; zeros where !valid.
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, bool valid,
                                      bool vec) {
  if (vec) {
    cp_async16(dst, src, valid);
    return;
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (valid) {
    const unsigned short* e = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = e[2 * k] | ((unsigned)e[2 * k + 1] << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// kT rows of W elements (row stride rs in global memory, LD in shared
// memory) by NT threads; rows at or past `valid` read zero
template <int W, int LD, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long rs, int valid, bool vec) {
  constexpr int kCh = W / 8;
  for (int i = threadIdx.x; i < kT * kCh; i += NT) {
    const int r = i / kCh, ch = i % kCh;
    const bool ok = r < valid;
    load8(dst + r * LD + ch * 8, src + (ok ? r : 0) * rs + ch * 8, ok, vec);
  }
}

// kT rows of W elements (W a multiple of 64) into 128-byte-swizzled atoms
// of 64 columns: column block a at a * kT * 128 bytes, row r at r * 128,
// its 16-byte chunk c at (c ^ (r % 8)) * 16, as wgmma reads them
template <int W, int NT>
__device__ __forceinline__ void load_rows_sw(unsigned char* dst,
                                             const bf16* src, long long rs,
                                             int valid, bool vec) {
  constexpr int kCh = W / 8;
  for (int i = threadIdx.x; i < kT * kCh; i += NT) {
    const int r = i / kCh, ch = i % kCh;
    const bool ok = r < valid;
    load8(reinterpret_cast<bf16*>(dst + (ch / 8) * kT * 128 + r * 128 +
                                  (((ch % 8) ^ (r % 8)) << 4)),
          src + (ok ? r : 0) * rs + ch * 8, ok, vec);
  }
}

// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to wgmma's async-proxy reads, before the barrier that publishes them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the shared-memory matrix descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t wg_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
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

// d (+)= A B, m64n64k16, A from registers, B from shared memory K-major
// (its N rows hold K contiguous); `acc` 0 overwrites d
__device__ __forceinline__ void wgmma_n64_k(float* d, const unsigned* a,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d += A B, m64n64k16, A from registers, B from shared memory MN-major
// (its K rows hold N contiguous)
__device__ __forceinline__ void wgmma_n64_mn(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d += A B, m64n128k16, A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_n128_mn(float* d, const unsigned* a,
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, "
      "1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// G[b, c] = C_c B_c^T, float32 kT x kT, for chunk c = blockIdx.x of
// sequence b = blockIdx.y; warp w computes rows [16 w, 16 w + 16).
template <int N>
__global__ void __launch_bounds__(kGramThreads)
ssd_gram_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                float* __restrict__ gram, int S, int nc, Strides st,
                int vec) {
  constexpr int LB = N + 8;  // +16 bytes a row: ldmatrix without conflicts
  __shared__ __align__(16) unsigned short bc_raw[2 * kT * LB];
  bf16* Bs = reinterpret_cast<bf16*>(bc_raw);
  bf16* Cs = Bs + kT * LB;
  const int c = blockIdx.x, b = blockIdx.y;
  const int t0 = c * kT;
  const int valid = min(kT, S - t0);
  load_rows<N, LB, kGramThreads>(
      Bs, Bm + b * st.b_sb + (long long)t0 * st.b_ss, st.b_ss, valid, vec);
  load_rows<N, LB, kGramThreads>(
      Cs, Cm + b * st.c_sb + (long long)t0 * st.c_ss, st.c_ss, valid, vec);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, cq = lane & 3;
  float acc[kT / 8][4] = {};
#pragma unroll
  for (int kb = 0; kb < N / 16; ++kb) {
    unsigned a[4];
    ldsm_x4(a, Cs + (16 * warp + r8 + 8 * (mi & 1)) * LB + 16 * kb +
                   8 * (mi >> 1));
#pragma unroll
    for (int jp = 0; jp < kT / 16; ++jp) {
      unsigned bf[4];
      ldsm_x4(bf, Bs + (8 * (2 * jp + (mi >> 1)) + r8) * LB + 16 * kb +
                      8 * (mi & 1));
      mma(acc[2 * jp], a, bf[0], bf[1]);
      mma(acc[2 * jp + 1], a, bf[2], bf[3]);
    }
  }
  float* gp = gram + ((long long)b * nc + c) * kT * kT;
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
    const int row = 16 * warp + g, col = 8 * j + 2 * cq;
    *reinterpret_cast<float2*>(gp + row * kT + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(gp + (row + 8) * kT + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

template <int kCount>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kCount) : "memory");
}

template <int P, int N>
struct Geo {
  // P = 64 with N a multiple of 64 (mamba2): one warpgroup a head, its
  // products as wgmma from 128-byte-swizzled B, C and W tiles.  Else
  // mma.sync, a warp for 16 rows of P.  Either way each warp holds its 16
  // rows of the state, all N columns, in registers.
  static constexpr bool kWG = P == 64 && N % 64 == 0;
  static constexpr int kWarpsHead = P / 16;
  static constexpr int kThreads = kHG * kWarpsHead * 32;
  static constexpr int LX = P + 8;   // bf16 row strides in shared memory:
  static constexpr int LB = N + 8;   // +16 bytes keeps ldmatrix free of
  static constexpr int LW = kT + 8;  // bank conflicts
  // a stage: B, C (swizzled for wgmma, else padded rows), x of both heads
  // (padded rows: ldmatrix reads them), G (float32)
  static constexpr int kXBytes = kHG * kT * LX * 2;
  static constexpr int kBBytes = kWG ? kT * N * 2 : kT * LB * 2;
  static constexpr int kGBytes = kT * kT * 4;
  static constexpr int kXOff = 2 * kBBytes;
  static constexpr int kGOff = kXOff + kXBytes;
  static constexpr int kStage = kGOff + kGBytes;
  static constexpr int kWHead = kWG ? kT * kT * 2 : kT * LW * 2;
  static constexpr int kWBytes = kHG * kWHead;  // W of both heads
  // per head and chunk parity: dt, cum, exp(cum), dt exp(cum_T - cum) and
  // exp(cum_T)
  static constexpr int kVecFloats = 4 * kT + 4;
  // + 1024: the swizzled tiles need a 1024-byte-aligned base
  static constexpr int kBytes = 2 * kStage + kWBytes +
                                2 * kHG * kVecFloats * 4 + (kWG ? 1024 : 0);
  static_assert(kStage % 16 == 0 && kWBytes % 16 == 0, "16-byte regions");
  static_assert(!kWG || (kStage % 1024 == 0 && kBBytes % 1024 == 0),
                "swizzled tiles 1024-byte aligned");
};

// One CTA per (pair of heads, sequence).  Warp w: head blockIdx.x * kHG +
// w / kWarpsHead, rows [p0, p0 + 16) of P with p0 = 16 (w % kWarpsHead).
// y is (Bt, S, H, P) contiguous; h0 and hout (Bt, H, P, N) float32.  Per
// chunk c, one CTA barrier: chunk c's stage and per-step values are in
// (and chunk c - 1 is done everywhere); then the warps of each head meet
// once their W is written (named barrier 1 + head), so one head's
// products start while the other's W is still being written.  The first
// warp of each head loads chunk c + 1's dt while the chunk computes and
// scans it into the other parity's per-step values at the end.
template <int P, int N>
__global__ void __launch_bounds__(Geo<P, N>::kThreads)
ssd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ gram,
              const float* __restrict__ h0, bf16* __restrict__ y,
              float* __restrict__ hout, int H, int S, int nc, Strides st,
              int vec) {
  using G = Geo<P, N>;
  constexpr bool kWG = G::kWG;
  constexpr int NT = G::kThreads, LX = G::LX, LB = G::LB, LW = G::LW;
  constexpr int NJ = N / 8;  // n8 tiles of the state
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* smem =
      kWG ? tc_smem + ((1024 - (smem_addr(tc_smem) & 1023)) & 1023)
          : tc_smem;
  unsigned char* Ws = smem + 2 * G::kStage;
  float* vecs = reinterpret_cast<float*>(Ws + G::kWBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hh = warp / G::kWarpsHead;
  const int p0 = 16 * (warp % G::kWarpsHead);
  const int b = blockIdx.y;
  const int h0i = blockIdx.x * kHG;
  const int h = h0i + hh;
  const bool live = h < H;
  const bool scans = live && p0 == 0;  // the head's dt
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, cq = lane & 3;
  unsigned char* Wh = Ws + hh * G::kWHead;  // this head's W
  // this head's per-step values for chunk parity `par`
  auto dtv_of = [&](int par) {
    return vecs + (par * kHG + hh) * G::kVecFloats;
  };
  auto stage_of = [&](int c) { return smem + (c & 1) * G::kStage; };
  auto bs_of = [&](int c) { return reinterpret_cast<bf16*>(stage_of(c)); };
  auto cs_of = [&](int c) {
    return reinterpret_cast<bf16*>(stage_of(c) + G::kBBytes);
  };
  auto xs_of = [&](int c) {
    return reinterpret_cast<bf16*>(stage_of(c) + G::kXOff);
  };
  auto gs_of = [&](int c) {
    return reinterpret_cast<float*>(stage_of(c) + G::kGOff);
  };
  // chunk c's x (both heads), B, C and G into stage c & 1, one cp.async group
  auto load_chunk = [&](int c) {
    const int t0 = c * kT;
    const int valid = min(kT, S - t0);
#pragma unroll
    for (int q = 0; q < kHG; ++q) {
      if (h0i + q < H) {
        load_rows<P, LX, NT>(xs_of(c) + q * kT * LX,
                             x + b * st.x_sb + (long long)t0 * st.x_ss +
                                 (h0i + q) * st.x_sh,
                             st.x_ss, valid, vec);
      }
    }
    const bf16* bsrc = Bm + b * st.b_sb + (long long)t0 * st.b_ss;
    const bf16* csrc = Cm + b * st.c_sb + (long long)t0 * st.c_ss;
    if constexpr (kWG) {
      load_rows_sw<N, NT>(stage_of(c), bsrc, st.b_ss, valid, vec);
      load_rows_sw<N, NT>(stage_of(c) + G::kBBytes, csrc, st.c_ss, valid,
                          vec);
    } else {
      load_rows<N, LB, NT>(bs_of(c), bsrc, st.b_ss, valid, vec);
      load_rows<N, LB, NT>(cs_of(c), csrc, st.c_ss, valid, vec);
    }
    const float* gsrc = gram + ((long long)b * nc + c) * kT * kT;
    float* gdst = gs_of(c);
    for (int i = tid; i < kT * kT / 4; i += NT) {
      cp_async16(gdst + 4 * i, gsrc + 4 * i, true);
    }
    cp_commit();
  };
  // (scanning warps) dt of steps 2 lane and 2 lane + 1 of chunk c, 0 past S
  float d0 = 0.f, d1 = 0.f;
  auto load_dt = [&](int c) {
    const int t = c * kT + 2 * lane;
    const bf16* p = dt + b * st.dt_sb + (long long)t * st.dt_ss + h * st.dt_sh;
    d0 = t < S ? __bfloat162float(p[0]) : 0.f;
    d1 = t + 1 < S ? __bfloat162float(p[st.dt_ss]) : 0.f;
  };
  // (scanning warps) chunk c's per-step values from d0, d1: cum, the
  // inclusive scan of A dt, two steps a lane
  auto scan_dt = [&](int c) {
    float* dv = dtv_of(c & 1);
    float* cum = dv + kT;
    float* ec = dv + 2 * kT;
    float* xsc = dv + 3 * kT;
    const float a = A[h];
    const float v0 = a * d0;
    const float v1 = v0 + a * d1;
    float s = v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += o;
    }
    const float c0 = s - v1 + v0, c1 = s;
    const float cl = __shfl_sync(kFull, s, 31);
    dv[2 * lane] = d0;
    dv[2 * lane + 1] = d1;
    cum[2 * lane] = c0;
    cum[2 * lane + 1] = c1;
    ec[2 * lane] = __expf(c0);
    ec[2 * lane + 1] = __expf(c1);
    xsc[2 * lane] = d0 * __expf(cl - c0);
    xsc[2 * lane + 1] = d1 * __expf(cl - c1);
    if (lane == 0) dv[4 * kT] = __expf(cl);
  };

  // the state: rows p0 + g (+ 8), columns 8 j + 2 cq (+ 1) of tile j (the
  // mma accumulator layout, which is also wgmma's for the warpgroup)
  float hs[NJ][4];
  const long long hoff = ((long long)b * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v = make_float2(0.f, 0.f);
      if (live && h0 != nullptr) {
        v = *reinterpret_cast<const float2*>(
            h0 + hoff + (p0 + g + 8 * half) * N + 8 * j + 2 * cq);
      }
      hs[j][2 * half] = v.x;
      hs[j][2 * half + 1] = v.y;
    }

  if constexpr (kWG) {  // wgmma reads W whole: its upper blocks stay 0
    for (int i = tid; i < G::kWBytes / 16; i += NT) {
      reinterpret_cast<uint4*>(Ws)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (nc > 0) {
    load_chunk(0);
    if (scans) {
      load_dt(0);
      scan_dt(0);
    }
  }
  for (int c = 0; c < nc; ++c) {
    cp_wait_all();
    if constexpr (kWG) fence_async_smem();
    __syncthreads();  // chunk c is in; chunk c - 1 is done everywhere
    if (c + 1 < nc) {
      load_chunk(c + 1);
      if (scans) load_dt(c + 1);
    }
    const float* dv = dtv_of(c & 1);
    const float* cum = dv + kT;
    // W[t, s] = G[t, s] exp(min(cum_t - cum_s, 0)) dt_s for s <= t, in bf16,
    // over the 16-row blocks the masked product reads: rows [16 R, 16 R +
    // 16) up to column 16 R + 16 (zero above the diagonal), one column pair
    // an item, 128 (R + 1) items a block, every lane busy
    if (live) {
      const float* gs = gs_of(c);
      const int ti = tid - hh * G::kWarpsHead * 32;
      constexpr int kHT = G::kWarpsHead * 32;
      static_assert(128 % kHT == 0, "the head's threads tile every block");
#pragma unroll
      for (int R = 0; R < kT / 16; ++R) {
#pragma unroll
        for (int i = 0; i < 128 * (R + 1) / kHT; ++i) {
          const int item = ti + i * kHT;
          {
            const int t = 16 * R + item / (8 * (R + 1));
            const int s = 2 * (item % (8 * (R + 1)));
            const float2 gv =
                *reinterpret_cast<const float2*>(gs + t * kT + s);
            const float2 cs2 = *reinterpret_cast<const float2*>(cum + s);
            const float2 ds2 = *reinterpret_cast<const float2*>(dv + s);
            const float ct = cum[t];
            const float w0 =
                s <= t ? gv.x * __expf(fminf(ct - cs2.x, 0.f)) * ds2.x : 0.f;
            const float w1 =
                s + 1 <= t ? gv.y * __expf(fminf(ct - cs2.y, 0.f)) * ds2.y
                           : 0.f;
            // swizzled (wgmma) or padded (ldmatrix) row t, column s
            const int off = kWG ? t * 128 + ((((s >> 3) ^ (t & 7)) << 4) |
                                             ((s & 7) << 1))
                                : (t * LW + s) * 2;
            *reinterpret_cast<unsigned*>(Wh + off) = pack_bf16(w0, w1);
          }
        }
      }
      if constexpr (kWG) fence_async_smem();
      named_sync<G::kWarpsHead * 32>(1 + hh);  // W is in
    }
    if (live) {
      const float* ec = dv + 2 * kT;
      const float* xsc = dv + 3 * kT;
      bf16* xh = xs_of(c) + hh * kT * LX;
      // X^T: A fragments of this warp's 16 rows of P, for the 4 k16 steps
      unsigned xa[kT / 16][4];
#pragma unroll
      for (int kb = 0; kb < kT / 16; ++kb) {
        ldsm_x4_t(xa[kb], xh + (16 * kb + r8 + 8 * (mi >> 1)) * LX + p0 +
                              8 * (mi & 1));
      }
      // X' = x dt exp(cum_T - cum) in bf16, the A fragments of the update
      unsigned xp[kT / 16][4];
#pragma unroll
      for (int kb = 0; kb < kT / 16; ++kb) {
        const int t = 16 * kb + 2 * cq;
        const float s0 = xsc[t], s1 = xsc[t + 1];
        const float s2 = xsc[t + 8], s3 = xsc[t + 9];
        float2 f = unpack_bf16(xa[kb][0]);
        xp[kb][0] = pack_bf16(f.x * s0, f.y * s1);
        f = unpack_bf16(xa[kb][1]);
        xp[kb][1] = pack_bf16(f.x * s0, f.y * s1);
        f = unpack_bf16(xa[kb][2]);
        xp[kb][2] = pack_bf16(f.x * s2, f.y * s3);
        f = unpack_bf16(xa[kb][3]);
        xp[kb][3] = pack_bf16(f.x * s2, f.y * s3);
      }
      // the state in bf16: A fragments of h C^T (its accumulator layout)
      unsigned ah[N / 16][4];
#pragma unroll
      for (int kb = 0; kb < N / 16; ++kb) {
        ah[kb][0] = pack_bf16(hs[2 * kb][0], hs[2 * kb][1]);
        ah[kb][1] = pack_bf16(hs[2 * kb][2], hs[2 * kb][3]);
        ah[kb][2] = pack_bf16(hs[2 * kb + 1][0], hs[2 * kb + 1][1]);
        ah[kb][3] = pack_bf16(hs[2 * kb + 1][2], hs[2 * kb + 1][3]);
      }
      const float dcy = dv[4 * kT];
      float acc[kT / 8][4];
      if constexpr (kWG) {
        // the warpgroup's 64 rows of P at once: Y^T = h C^T (C a K-major
        // B), scaled by exp(cum); Y^T += X^T W^T (W a K-major B); h =
        // exp(cum_T) h + X'^T B (B an MN-major B, atoms of 64 columns of
        // N, kT * 128 bytes apart)
        const unsigned char* cb =
            reinterpret_cast<const unsigned char*>(cs_of(c));
        const unsigned char* bb =
            reinterpret_cast<const unsigned char*>(bs_of(c));
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < N / 16; ++kb) {
          wgmma_n64_k(&acc[0][0], ah[kb],
                      wg_desc(cb + (kb / 4) * kT * 128 + (kb % 4) * 32, 16,
                              1024),
                      kb > 0);
        }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {
          const float e0 = ec[8 * j + 2 * cq], e1 = ec[8 * j + 2 * cq + 1];
          acc[j][0] *= e0;
          acc[j][1] *= e1;
          acc[j][2] *= e0;
          acc[j][3] *= e1;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hs[j][e] *= dcy;
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < kT / 16; ++kb) {
          wgmma_n64_k(&acc[0][0], xa[kb], wg_desc(Wh + kb * 32, 16, 1024),
                      1);
        }
#pragma unroll
        for (int kb = 0; kb < kT / 16; ++kb) {
          const uint64_t db = wg_desc(bb + kb * 16 * 128, kT * 128, 1024);
          if constexpr (N == 128) {
            wgmma_n128_mn(&hs[0][0], xp[kb], db);
          } else {
            wgmma_n64_mn(&hs[0][0], xp[kb], db);
          }
        }
        wgmma_commit();
        wgmma_wait();
      } else {
        // a warp's 16 rows of P in m16n8k16 tiles
        const bf16* bs = bs_of(c);
        const bf16* cs = cs_of(c);
        const bf16* W = reinterpret_cast<const bf16*>(Wh);
        // Y^T = (h C^T) o exp(cum)
#pragma unroll
        for (int j = 0; j < kT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kb = 0; kb < N / 16; ++kb) {
#pragma unroll
          for (int jp = 0; jp < kT / 16; ++jp) {
            unsigned bf[4];
            ldsm_x4(bf, cs + (8 * (2 * jp + (mi >> 1)) + r8) * LB + 16 * kb +
                            8 * (mi & 1));
            mma(acc[2 * jp], ah[kb], bf[0], bf[1]);
            mma(acc[2 * jp + 1], ah[kb], bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {
          const float e0 = ec[8 * j + 2 * cq], e1 = ec[8 * j + 2 * cq + 1];
          acc[j][0] *= e0;
          acc[j][1] *= e1;
          acc[j][2] *= e0;
          acc[j][3] *= e1;
        }
        // Y^T += X^T W^T over s <= t: the steps of pair jp meet k16 step
        // kb (s in [16 kb, 16 kb + 16)) only when kb <= jp
#pragma unroll
        for (int kb = 0; kb < kT / 16; ++kb) {
#pragma unroll
          for (int jp = kb; jp < kT / 16; ++jp) {
            unsigned bf[4];
            ldsm_x4(bf, W + (8 * (2 * jp + (mi >> 1)) + r8) * LW + 16 * kb +
                           8 * (mi & 1));
            mma(acc[2 * jp], xa[kb], bf[0], bf[1]);
            mma(acc[2 * jp + 1], xa[kb], bf[2], bf[3]);
          }
        }
        // h = exp(cum_T) h + X'^T B
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hs[j][e] *= dcy;
#pragma unroll
        for (int kb = 0; kb < kT / 16; ++kb) {
#pragma unroll
          for (int jp = 0; jp < NJ / 2; ++jp) {
            unsigned bf[4];
            ldsm_x4_t(bf, bs + (16 * kb + r8 + 8 * (mi & 1)) * LB +
                              8 * (2 * jp + (mi >> 1)));
            mma(hs[2 * jp], xp[kb], bf[0], bf[1]);
            mma(hs[2 * jp + 1], xp[kb], bf[2], bf[3]);
          }
        }
      }
      // y (t, p) into the x rows this warp alone has read (its 16 columns),
      // then out, 16 bytes a row half, rows below S
#pragma unroll
      for (int j = 0; j < kT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xh[(8 * j + 2 * cq + (e & 1)) * LX + p0 + g + 8 * (e >> 1)] =
              __float2bfloat16(acc[j][e]);
        }
      __syncwarp();
      const int t0 = c * kT;
      const int valid = min(kT, S - t0);
#pragma unroll
      for (int k = 0; k < 2 * kT / 32; ++k) {
        const int t = (lane >> 1) + 16 * k, half = lane & 1;
        if (t < valid) {
          *reinterpret_cast<uint4*>(
              y + (((long long)b * S + t0 + t) * H + h) * P + p0 + 8 * half) =
              *reinterpret_cast<const uint4*>(xh + t * LX + p0 + 8 * half);
        }
      }
    }
    if (scans && c + 1 < nc) scan_dt(c + 1);
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<float2*>(hout + hoff + (p0 + g + 8 * half) * N +
                                   8 * j + 2 * cq) =
            make_float2(hs[j][2 * half], hs[j][2 * half + 1]);
      }
  }
}

template <int P, int N>
int launch(const void* x, const void* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout,
           float* gram, int Bt, int S, int H, const Strides& st, int vec,
           cudaStream_t s) {
  using G = Geo<P, N>;
  const int nc = (S + kT - 1) / kT;
  if (nc > 0) {
    ssd_gram_kernel<N><<<dim3(nc, Bt), kGramThreads, 0, s>>>(
        static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), gram, S,
        nc, st, vec);
  }
  auto kernel = ssd_tc_kernel<P, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((H + kHG - 1) / kHG, Bt), G::kThreads, G::kBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt), A,
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), gram, h0,
      static_cast<bf16*>(y), hout, H, S, nc, st, vec);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_n(int N, const void* x, const void* dt, const float* A,
               const void* Bm, const void* Cm, const float* h0, void* y,
               float* hout, float* gram, int Bt, int S, int H,
               const Strides& st, int vec, cudaStream_t s) {
  switch (N) {
    case 16: return launch<P, 16>(x, dt, A, Bm, Cm, h0, y, hout, gram, Bt, S,
                                  H, st, vec, s);
    case 32: return launch<P, 32>(x, dt, A, Bm, Cm, h0, y, hout, gram, Bt, S,
                                  H, st, vec, s);
    case 64: return launch<P, 64>(x, dt, A, Bm, Cm, h0, y, hout, gram, Bt, S,
                                  H, st, vec, s);
    case 128: return launch<P, 128>(x, dt, A, Bm, Cm, h0, y, hout, gram, Bt,
                                    S, H, st, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_p(int P, int N, const void* x, const void* dt, const float* A,
               const void* Bm, const void* Cm, const float* h0, void* y,
               float* hout, float* gram, int Bt, int S, int H,
               const Strides& st, int vec, cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<16>(N, x, dt, A, Bm, Cm, h0, y, hout, gram,
                                   Bt, S, H, st, vec, s);
    case 32: return dispatch_n<32>(N, x, dt, A, Bm, Cm, h0, y, hout, gram,
                                   Bt, S, H, st, vec, s);
    case 64: return dispatch_n<64>(N, x, dt, A, Bm, Cm, h0, y, hout, gram,
                                   Bt, S, H, st, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Steps a chunk of the tensor-core design takes (its G scratch holds
// Bt * ceil(S / chunk) * chunk * chunk float32).
int trees_ssd_chunk() { return tc::kT; }

// design: 0 CUDA cores, 1 tensor cores (bfloat16 only, P in {16, 32, 64},
// N in {16, 32, 64, 128}; gram: the G scratch above, 16-byte aligned).
// dtype: 0 float32, 1 bfloat16 (x, dt, B, C and y).  x (Bt, S, H, P), dt
// (Bt, S, H), B and C (Bt, S, N), addressed by the strides (in elements)
// x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss; the last
// axes of x, B and C are contiguous.  A: f32[H].  h0: f32 (Bt, H, P, N)
// contiguous, or null for a zero state.  y (Bt, S, H, P) and hout
// (Bt, H, P, N) float32, contiguous.  P in {8, 16, 32, 64}, N in
// {8, 16, 32, 64, 128}; Bt <= 65535.
int trees_ssd_scan(int dtype, int design, const void* x, const void* dt,
                   const float* A, const void* Bm, const void* Cm,
                   const float* h0, void* y, float* hout, float* gram, int Bt,
                   int S, int H, int P, int N, const long long* strides,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bt <= 0 || H <= 0) return 0;
  if (design == 1) {
    if (dtype != 1 || (S > 0 && gram == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    const tc::Strides st{strides[0], strides[1], strides[2], strides[3],
                         strides[4], strides[5], strides[6], strides[7],
                         strides[8], strides[9]};
    auto al16 = [](const void* p) {
      return reinterpret_cast<unsigned long long>(p) % 16 == 0;
    };
    const int vec = al16(x) && al16(Bm) && al16(Cm) && st.x_sb % 8 == 0 &&
                    st.x_ss % 8 == 0 && st.x_sh % 8 == 0 &&
                    st.b_sb % 8 == 0 && st.b_ss % 8 == 0 &&
                    st.c_sb % 8 == 0 && st.c_ss % 8 == 0;
    return tc::dispatch_p(P, N, x, dt, A, Bm, Cm, h0, y, hout, gram, Bt, S,
                          H, st, vec, s);
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_p<float>(P, N, x, dt, A, Bm, Cm, h0, y, hout, Bt, S, H,
                             strides, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, h0, y, hout, Bt,
                                     S, H, strides, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
