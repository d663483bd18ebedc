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
// exponent is <= 0.  B and C are shared by all heads (one group).  The
// serving path's prefill calls it once per SSM layer (models/ssm.py,
// apply_ssm), with x, B and C as strided slices of the conv output.
//
// What bounds it on this card: memory.  At the mamba2-1.3b prefill bucket
// (16 sequences x 1024 steps, 64 heads of P = 64, N = 128, bf16) the function
// reads x (134.2 MB), B and C (8.4 MB), dt (2.1 MB) and writes y (134.2 MB)
// and h (33.6 MB, float32): about 312 MB, 0.093 ms at 3.35 TB/s.  The chunked
// form does 81,920 flops per (step, head) at the reference's chunk of 128,
// 85.9 GFLOP, 0.087 ms at the 989 TFLOP/s of the bf16 tensor cores.  This
// kernel multiplies in float32 on the CUDA cores (67 TFLOP/s peak): at
// kT = 64 it does 1.8 M multiply-adds per (chunk, head) at P = 64, N = 128,
// 60 GFLOP for the bucket, each fed from shared memory, so it is bound by
// the CUDA cores and their operand loads, far from either bound.
//
// Design.  The TPU runs the chunks of a head in order on one core and keeps
// the (P, N) state in VMEM scratch between grid steps.  Blocks on this card
// run in no order, so the chunk axis is a loop inside the block: one CTA of
// 256 threads per (head, sequence) walks its chunks in order and keeps the
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
// inside a block's 227 KB; at kT = 128 it would not fit.  The reference's
// chunk is 128; the result does not depend on the chunk beyond rounding.
// Tensor-core tiles, sharing C B^T across the heads of a sequence and TMA
// staging are later work.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x, dt, B, C and y).  x (Bt, S, H, P), dt
// (Bt, S, H), B and C (Bt, S, N), addressed by the strides (in elements)
// x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss; the last
// axes of x, B and C are contiguous.  A: f32[H].  h0: f32 (Bt, H, P, N)
// contiguous, or null for a zero state.  y (Bt, S, H, P) and hout
// (Bt, H, P, N) float32, contiguous.  P in {8, 16, 32, 64}, N in
// {8, 16, 32, 64, 128}; Bt <= 65535.
int trees_ssd_scan(int dtype, const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* h0, void* y,
                   float* hout, int Bt, int S, int H, int P, int N,
                   const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bt <= 0 || H <= 0) return 0;
  if (dtype == 0)
    return dispatch_p<float>(P, N, x, dt, A, Bm, Cm, h0, y, hout, Bt, S, H,
                             strides, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, h0, y, hout, Bt,
                                     S, H, strides, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
