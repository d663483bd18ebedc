// One-token grouped-query decode attention over a ragged KV cache, for
// Hopper (sm_90a): split-K over the cache rows with a prefetch ring.
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
// cache bytes up to each length over 3.35 TB/s (12 microseconds for 16
// sequences x 8 kv heads x about 600 visible rows x 128 in bf16).  The
// design puts enough bytes in flight to approach that rate: more CTAs than
// one per (kv head, sequence), each with several tiles of loads queued.
//
// Design.  Two launches.
//
// 1. The split kernel, grid (n_split, Hkv, B), 128 threads.  The cache rows
//    are cut into splits of `split` rows, fixed on the host from S alone
//    (the lengths are never read back); CTA (s, h, b) takes the visible
//    rows of split s, [max(lo, s * split), min(hi, (s + 1) * split)), and a
//    split with none writes m = -1e30, l = 0 and exits.  The rows stream
//    through a cp.async ring in shared memory, K and V of a tile issued
//    together as 16-byte copies (rows past the split zero-filled).
//    All `group` q rows of the kv head share each cache row, so each cache
//    byte is read once.  The softmax is online, in float32 and log2 units
//    (scale folded into exp2f with log2 e).  At the end the CTA's partial
//    states are merged through shared memory into the split's partial
//    (m, l, acc[group][D]), written as float32 to scratch the wrapper
//    allocates.  The products, by type:
//    - bfloat16 (decode_split_tc_kernel): tensor cores.  The group's q rows
//      are the first rows of a 16-row mma A tile (the rest zero), each of
//      the 4 warps takes 16 keys of a 64-key tile, S = Q K^T and O += P V
//      are mma.sync.m16n8k16 with float32 accumulators (K and V read with
//      ldmatrix from rows padded by 16 bytes), P rounded to bf16 as the A
//      operand, and each warp keeps its own online softmax over its keys.
//      The ring has 2 stages of 64 rows (70 KB at D = 128), so three CTAs
//      share an SM.
//    - float32 (decode_split_kernel): CUDA cores, exact to 1e-5.  A ring
//      of 3 stages of 16 KB; D / 8 lanes share a row ("slot"), each
//      holding 8 of its D elements: the score for every q row of the group
//      is a dot of 8 products and an xor shuffle sum over the slot's
//      lanes, and each slot keeps its own online softmax and accumulator
//      over its rows.
// 2. decode_combine_kernel, grid (Hkv, B, group * D / 128): merges the
//    splits' partials, out = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M)
//    over the splits with l_s > 0 (M their largest m), one thread per
//    output element, the splits' weights computed once into shared memory;
//    writes it in q's type, zeros where no row is visible.
//
// Instantiated for group 1..8, D in {16, 32, 64, 128}, float32 and bf16.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kStageBytes = 16384;  // K and V of one tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// The float32 tile geometry for head dim D: each lane holds 8 elements of
// a row as 16-byte chunks of kVec elements, a row ("slot") is shared by
// D / 8 lanes, and a tile holds kU rows per slot.
template <int D>
struct Geo {
  static constexpr int kVec = 4;                       // elements a chunk
  static constexpr int kChunks = 8 / kVec;             // chunks a lane
  static constexpr int kLanesPerRow = D / 8;
  static constexpr int kSlots = kThreads / kLanesPerRow;
  static constexpr int kRows = kStageBytes / (2 * D * 4);
  static constexpr int kU = kRows / kSlots;            // rows a slot a tile
  static constexpr int kRowChunks = D / kVec;          // chunks a row
  static_assert(kRows % kSlots == 0, "slots tile the stage");
  // the element index of chunk c of the lane at `part` within its row: a
  // lane's chunks sit D / kChunks apart, so the lanes of a row read
  // neighbouring 16-byte chunks together
  static __device__ __forceinline__ int elem(int part, int c) {
    return c * (D / kChunks) + part * kVec;
  }
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

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

// this lane's 8 elements of a row
template <int D>
__device__ __forceinline__ void load_row8(const float* row, int part,
                                          float* x) {
  using G = Geo<D>;
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
    load_vec(row + G::elem(part, c), x + c * G::kVec);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [r, r + kRows) of K and V (rows at or past r_end zero-filled) into
// one stage: K rows then V rows, D elements each
template <int D>
__device__ __forceinline__ void load_stage(const float* kb, long long k_ss,
                                           const float* vb, long long v_ss,
                                           int r, int r_end, float* dst) {
  using G = Geo<D>;
  constexpr int kPer = G::kRows * G::kRowChunks;  // chunks of K (or V)
  static_assert((2 * kPer) % kThreads == 0, "threads tile the stage");
#pragma unroll
  for (int j = 0; j < 2 * kPer / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const bool is_v = i >= kPer;
    const int ii = is_v ? i - kPer : i;
    const int row = ii / G::kRowChunks;
    const int col = (ii % G::kRowChunks) * G::kVec;
    const bool ok = r + row < r_end;
    const long long src_row = ok ? r + row : r;
    const float* src = is_v ? vb + src_row * v_ss : kb + src_row * k_ss;
    cp_async16(dst + i * G::kVec, src + col, ok);
  }
}

template <int D, int GR>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ lengths,
                    float* __restrict__ part, int Hkv, int S, int split,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    float scale_log2, int window) {
  using G = Geo<D>;
  constexpr int kLPR = G::kLanesPerRow;
  constexpr int kStageElems = kStageBytes / 4;
  static_assert(G::kSlots * GR * D * 4 + 2 * G::kSlots * GR * 4 <=
                    kStages * kStageBytes,
                "the merge fits in the ring's shared memory");
  __shared__ uint4 ring_u4[kStages * kStageBytes / 16];
  float* ring = reinterpret_cast<float*>(ring_u4);

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int length = lengths[b];
  const int hi = min(length, S);
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int r0 = max(lo, sp * split);
  const int r1 = min(hi, sp * split + split);
  // partial of (b, h, sp): m[GR], l[GR], acc[GR][D]
  float* pm = part + (((long long)b * Hkv + h) * gridDim.x + sp) *
                         (GR * (D + 2));
  float* pl = pm + GR;
  float* pacc = pl + GR;
  if (r0 >= r1) {
    if (tid < GR) {
      pm[tid] = kNegInf;
      pl[tid] = 0.f;
    }
    return;
  }

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int n_tiles = (r1 - r0 + G::kRows - 1) / G::kRows;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      load_stage<D>(kb, k_ss, vb, v_ss, r0 + st * G::kRows, r1,
                       ring + st * kStageElems);
    cp_commit();
  }

  const int slot = tid / kLPR;
  const int part_i = tid % kLPR;
  float qr[GR][8];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    load_row8<D>(q + (((long long)b * Hkv + h) * GR + g) * D, part_i,
                    qr[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[g][e] *= scale_log2;
  }
  float m[GR], l[GR], acc[GR][8];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();         // ... and every thread's; tile t - 1 is done
    const int tn = t + kStages - 1;
    if (tn < n_tiles)
      load_stage<D>(kb, k_ss, vb, v_ss, r0 + tn * G::kRows, r1,
                       ring + (tn % kStages) * kStageElems);
    cp_commit();

    const float* Kt = ring + (t % kStages) * kStageElems;
    const float* Vt = Kt + G::kRows * D;
    const int rb = r0 + t * G::kRows;
    float s[G::kU][GR];
    bool ok[G::kU];
#pragma unroll
    for (int u = 0; u < G::kU; ++u) {
      const int kk = slot + G::kSlots * u;
      ok[u] = rb + kk < r1;
      float kr[8];
      load_row8<D>(Kt + kk * D, part_i, kr);
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qr[g][e], kr[e], x);
#pragma unroll
        for (int off = kLPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(kFull, x, off);
        s[u][g] = ok[u] ? x : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < G::kU; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < G::kU; ++u) {
        s[u][g] = ok[u] ? exp2f(s[u][g] - mx) : 0.f;
        sum += s[u][g];
      }
      l[g] = alpha * l[g] + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < G::kU; ++u) {
      float vr[8];
      load_row8<D>(Vt + (slot + G::kSlots * u) * D, part_i, vr);
#pragma unroll
      for (int g = 0; g < GR; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[u][g], vr[e], acc[g][e]);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: merge the slots through it

  float* red_m = reinterpret_cast<float*>(ring_u4);     // [kSlots][GR]
  float* red_l = red_m + G::kSlots * GR;                // [kSlots][GR]
  float* red_acc = red_l + G::kSlots * GR;              // [kSlots][GR][D]
  if (part_i == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      red_m[slot * GR + g] = m[g];
      red_l[slot * GR + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
      for (int e = 0; e < G::kVec; ++e)
        red_acc[(slot * GR + g) * D + G::elem(part_i, c) + e] =
            acc[g][c * G::kVec + e];
  __syncthreads();
  // the split's max and sum per q row; red_m becomes each slot's weight
  if (tid < GR) {
    float mx = kNegInf;
    for (int sl = 0; sl < G::kSlots; ++sl) mx = fmaxf(mx, red_m[sl * GR + tid]);
    float sum = 0.f;
    for (int sl = 0; sl < G::kSlots; ++sl) {
      const float w = exp2f(red_m[sl * GR + tid] - mx);
      red_m[sl * GR + tid] = w;
      sum += w * red_l[sl * GR + tid];
    }
    pm[tid] = mx;
    pl[tid] = sum;
  }
  __syncthreads();
  for (int i = tid; i < GR * D; i += kThreads) {
    const int g = i / D;
    float x = 0.f;
    for (int sl = 0; sl < G::kSlots; ++sl)
      x = fmaf(red_m[sl * GR + g], red_acc[(sl * GR) * D + i], x);
    pacc[i] = x;
  }
}

// ------------------------------------------------- bfloat16: tensor cores
// The same split, ring and partials, with the products on the tensor
// cores: the group's q rows are the rows of a 16-row mma tile (rows past
// the group zero), each warp takes 16 of a tile's 64 keys, S = Q K^T and
// O += P V are mma.sync.m16n8k16 (bf16 in, float32 accumulators), and each
// warp keeps its own online softmax over its keys.
namespace tc {

constexpr int kKeys = 16;               // keys per warp per tile
constexpr int kTile = kThreads / 32 * kKeys;
constexpr int kStages = 2;              // ring depth: 3 CTAs an SM

template <int D>
struct Layout {
  static constexpr int kStride = D + 8;  // bf16 per smem row: +16 bytes
  static constexpr int kStage = 2 * kTile * kStride;  // K rows, V rows
  static constexpr int kBytes = (kStages * kStage + 16 * kStride) * 2;
};

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

// rows [r, r + kTile) of K and V (rows at or past r_end zero-filled) into
// one stage of padded rows
template <int D>
__device__ __forceinline__ void load_stage(const __nv_bfloat16* kb,
                                           long long k_ss,
                                           const __nv_bfloat16* vb,
                                           long long v_ss, int r, int r_end,
                                           __nv_bfloat16* dst) {
  constexpr int kRowChunks = D / 8;
  constexpr int kPer = kTile * kRowChunks;
  static_assert((2 * kPer) % kThreads == 0, "threads tile the stage");
#pragma unroll
  for (int j = 0; j < 2 * kPer / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const bool is_v = i >= kPer;
    const int ii = is_v ? i - kPer : i;
    const int row = ii / kRowChunks;
    const int col = (ii % kRowChunks) * 8;
    const bool ok = r + row < r_end;
    const long long src_row = ok ? r + row : r;
    const __nv_bfloat16* src =
        is_v ? vb + src_row * v_ss : kb + src_row * k_ss;
    cp_async16(dst + ((is_v ? kTile : 0) + row) * Layout<D>::kStride + col,
               src + col, ok);
  }
}

template <int D, int GR>
__global__ void __launch_bounds__(kThreads)
decode_split_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ lengths,
                       float* __restrict__ part, int Hkv, int S, int split,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       float scale_log2, int window) {
  using L = Layout<D>;
  constexpr int kS = L::kStride;
  constexpr int kDK = D / 16;  // k16 steps of Q K^T
  constexpr int kDT = D / 8;   // n8 tiles of O
  constexpr int kWarps = kThreads / 32;
  static_assert(GR <= 8, "the group fits the mma tile's first 8 rows");
  static_assert(kWarps * GR * (D + 2) * 4 <= kStages * L::kStage * 2,
                "the merge fits in the ring");
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* Qs = ring + kStages * L::kStage;

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int length = lengths[b];
  const int hi = min(length, S);
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int r0 = max(lo, sp * split);
  const int r1 = min(hi, sp * split + split);
  float* pm = part + (((long long)b * Hkv + h) * gridDim.x + sp) *
                         (GR * (D + 2));
  float* pl = pm + GR;
  float* pacc = pl + GR;
  if (r0 >= r1) {
    if (tid < GR) {
      pm[tid] = kNegInf;
      pl[tid] = 0.f;
    }
    return;
  }

  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* qb = q + ((long long)b * Hkv + h) * GR * D;
  const int n_tiles = (r1 - r0 + kTile - 1) / kTile;
  // the q tile (rows past the group zero) rides in tile 0's group
  for (int i = tid; i < 16 * (D / 8); i += kThreads) {
    const int row = i / (D / 8);
    const int col = (i % (D / 8)) * 8;
    cp_async16(Qs + row * kS + col, qb + (row < GR ? row : 0) * D + col,
               row < GR);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      load_stage<D>(kb, k_ss, vb, v_ss, r0 + st * kTile, r1,
                    ring + st * L::kStage);
    cp_commit();
  }
  cp_wait<kStages - 2>();
  __syncthreads();
  unsigned qa[kDK][4];
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk)
    ldsm_x4(qa[kk], Qs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kS +
                        kk * 16 + ((lane >> 4) << 3));

  // lane's row: lane >> 2, a q row of the group when < GR (the mma tile's
  // rows 8 .. 15 are padding: their scores are never used)
  float m = kNegInf;
  float l = 0.f;  // this lane's share of the row sum
  float acc[kDT][2];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) acc[dt][0] = acc[dt][1] = 0.f;

  const int wkey = warp * kKeys;  // the warp's first key in a tile
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();         // ... and every thread's; tile t - 1 is done
    const int tn = t + kStages - 1;
    if (tn < n_tiles)
      load_stage<D>(kb, k_ss, vb, v_ss, r0 + tn * kTile, r1,
                    ring + (tn % kStages) * L::kStage);
    cp_commit();

    const __nv_bfloat16* Kt = ring + (t % kStages) * L::kStage;
    const __nv_bfloat16* Vt = Kt + kTile * kS;
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      unsigned kf[4];
      ldsm_x4(kf, Kt + (wkey + (lane & 7) + ((lane >> 4) << 3)) * kS +
                      kk * 16 + (((lane >> 3) & 1) << 3));
      mma(s[0], qa[kk], kf[0], kf[1]);
      mma(s[1], qa[kk], kf[2], kf[3]);
    }
    const int kbase = r0 + t * kTile + wkey + ((lane & 3) << 1);
    bool ok[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) ok[nt][e] = kbase + nt * 8 + e < r1;
    float mx = m;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[nt][e];
        x = ok[nt][e] ? x * scale_log2 : kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float alpha = exp2f(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[nt][e];
        x = ok[nt][e] ? exp2f(x - mx) : 0.f;
        sum += x;
      }
    l = alpha * l + sum;
    unsigned pa[4];  // P as the A operand; padding rows 0
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = 0u;
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = 0u;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned vf[4];
      ldsm_x4_t(vf, Vt + (wkey + (lane & 7) + (((lane >> 3) & 1) << 3)) * kS +
                        dp * 16 + ((lane >> 4) << 3));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float c[4] = {acc[2 * dp + j][0] * alpha, acc[2 * dp + j][1] * alpha,
                      0.f, 0.f};
        mma(c, pa, vf[2 * j], vf[2 * j + 1]);
        acc[2 * dp + j][0] = c[0];
        acc[2 * dp + j][1] = c[1];
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: merge the warps through it

  float* red_m = reinterpret_cast<float*>(smem_tc);  // [kWarps][GR]
  float* red_l = red_m + kWarps * GR;                 // [kWarps][GR]
  float* red_acc = red_l + kWarps * GR;               // [kWarps][GR][D]
  const int g = lane >> 2;
  float lsum = l;
  lsum += __shfl_xor_sync(kFull, lsum, 1);
  lsum += __shfl_xor_sync(kFull, lsum, 2);
  if (g < GR) {
    if ((lane & 3) == 0) {
      red_m[warp * GR + g] = m;
      red_l[warp * GR + g] = lsum;
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      float* dst = red_acc + (warp * GR + g) * D + dt * 8 + ((lane & 3) << 1);
      dst[0] = acc[dt][0];
      dst[1] = acc[dt][1];
    }
  }
  __syncthreads();
  // the split's max and sum per q row; red_m becomes each warp's weight
  if (tid < GR) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * GR + tid]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(red_m[w * GR + tid] - mx);
      red_m[w * GR + tid] = wt;
      sum += wt * red_l[w * GR + tid];
    }
    pm[tid] = mx;
    pl[tid] = sum;
  }
  __syncthreads();
  for (int i = tid; i < GR * D; i += kThreads) {
    const int gi = i / D;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      x = fmaf(red_m[w * GR + gi], red_acc[(w * GR) * D + i], x);
    pacc[i] = x;
  }
}

template <int D, int GR>
int launch_split(const void* q, const void* k, const void* v,
                 const int* lengths, float* part, int B, int Hkv, int S,
                 int split, int n_split, const long long* st,
                 float scale_log2, int window, cudaStream_t s) {
  constexpr int bytes = Layout<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_tc_kernel<D, GR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(n_split, Hkv, B);
  decode_split_tc_kernel<D, GR><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part, Hkv, S, split,
      st[0], st[1], st[2], st[3], st[4], st[5], scale_log2, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

// grid (Hkv, B, ceil(GR * D / kThreads)): thread i of the (b, h) slice
// writes output element i of the group's GR x D
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                      int n_split, int GR, int D) {
  extern __shared__ float weight[];  // [n_split][GR], then 1 / sum [GR]
  const long long bh = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int stride = GR * (D + 2);  // one split's partial
  const float* p0 = part + bh * n_split * stride;
  float* inv = weight + n_split * GR;
  if (threadIdx.x < GR) {
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s)
      if (p0[s * stride + GR + g] > 0.f) mx = fmaxf(mx, p0[s * stride + g]);
    float sum = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float l = p0[s * stride + GR + g];
      const float w = l > 0.f ? exp2f(p0[s * stride + g] - mx) : 0.f;
      weight[s * GR + g] = w;
      sum = fmaf(w, l, sum);
    }
    inv[g] = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  const int i = blockIdx.z * kThreads + threadIdx.x;
  if (i >= GR * D) return;
  const int g = i / D;
  float x = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float w = weight[s * GR + g];
    if (w > 0.f) x = fmaf(w, p0[s * stride + 2 * GR + i], x);
  }
  store1(o + bh * GR * D + i, x * inv[g]);
}

template <typename T, int D, int GR>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, float* part, int B, int Hkv, int S, int split,
           int n_split, const long long* st, float scale, int window,
           cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {  // bfloat16: tensor cores
    const int e = tc::launch_split<D, GR>(q, k, v, lengths, part, B, Hkv, S,
                                          split, n_split, st,
                                          scale * kLog2e, window, s);
    if (e != 0) return e;
  } else {
    const dim3 grid(n_split, Hkv, B);
    decode_split_kernel<D, GR><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lengths, part, Hkv, S, split, st[0],
        st[1], st[2], st[3], st[4], st[5], scale * kLog2e, window);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Hkv, B, (GR * D + kThreads - 1) / kThreads);
  const int smem = (n_split + 1) * GR * (int)sizeof(float);
  decode_combine_kernel<T><<<grid, kThreads, smem, s>>>(
      part, static_cast<T*>(o), n_split, GR, D);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_g(int GR, const void* q, const void* k, const void* v,
               const int* lengths, void* o, float* part, int B, int Hkv,
               int S, int split, int n_split, const long long* st,
               float scale, int window, cudaStream_t s) {
#define TREES_DECODE_G(n)                                                  \
  case n:                                                                  \
    return launch<T, D, n>(q, k, v, lengths, o, part, B, Hkv, S, split,    \
                           n_split, st, scale, window, s);
  switch (GR) {
    TREES_DECODE_G(1) TREES_DECODE_G(2) TREES_DECODE_G(3) TREES_DECODE_G(4)
    TREES_DECODE_G(5) TREES_DECODE_G(6) TREES_DECODE_G(7) TREES_DECODE_G(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TREES_DECODE_G
}

template <typename T>
int dispatch_d(int D, int GR, const void* q, const void* k, const void* v,
               const int* lengths, void* o, float* part, int B, int Hkv,
               int S, int split, int n_split, const long long* st,
               float scale, int window, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(GR, q, k, v, lengths, o, part, B, Hkv,
                                      S, split, n_split, st, scale, window,
                                      s);
    case 32: return dispatch_g<T, 32>(GR, q, k, v, lengths, o, part, B, Hkv,
                                      S, split, n_split, st, scale, window,
                                      s);
    case 64: return dispatch_g<T, 64>(GR, q, k, v, lengths, o, part, B, Hkv,
                                      S, split, n_split, st, scale, window,
                                      s);
    case 128: return dispatch_g<T, 128>(GR, q, k, v, lengths, o, part, B,
                                        Hkv, S, split, n_split, st, scale,
                                        window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q and o contiguous (B, Hkv * G, D);
// strides (in elements) of the caches: k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
// the stride of D is 1.  lengths: i32[B].  D in {16, 32, 64, 128}, G (the
// group) in 1..8; Hkv, B <= 65535; n_split = ceil(S / split) <= 2^31 - 1.
// part: float32 scratch of B * Hkv * n_split * G * (D + 2) elements.
int trees_decode_attention(int dtype, const void* q, const void* k,
                           const void* v, const int* lengths, void* o,
                           float* part, int B, int Hkv, int G, int S, int D,
                           int split, int n_split, const long long* strides,
                           float scale, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(D, G, q, k, v, lengths, o, part, B, Hkv, S,
                             split, n_split, strides, scale, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, G, q, k, v, lengths, o, part, B, Hkv,
                                     S, split, n_split, strides, scale,
                                     window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
