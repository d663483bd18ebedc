// Fork-slot allocation and type compaction scans for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/fork_compact.py:
//   * trees_fork_scan  <- fork_scan (_fork_scan_kernel): exclusive prefix
//     sum + grand total of an i32 vector.  The epoch commit's fork-slot
//     allocation (the paper's atomicInc(nextFreeCore)) and the compaction
//     pass's per-type start offsets.
//   * trees_type_rank  <- type_rank (_type_rank_kernel): the stable rank of
//     each active lane among the active lanes of its type (-1 if inactive)
//     + per-type counts.  The compacted dispatch's permutation, and, with
//     one type, the gather dispatch's frontier pack.
//
// What bounds them on this card: memory.  fork_scan must read 4 bytes and
// write 4 bytes per lane (8 B/lane); type_rank reads an i32 type and a u8
// active flag and writes an i32 rank (9 B/lane).  At 2^21 lanes that is
// 16.8 MB and 18.9 MB: about 5 and 6 microseconds at 3.35 TB/s.  The
// arithmetic (one add, or n_types ballots, per lane) is far below the
// card's rate.
//
// Why reduce-then-scan: the Pallas kernels carry a running sum from one
// grid step to the next in SMEM, which is race-free only because TPU grid
// steps run in order on one core.  CUDA blocks run in no order, so the
// carry becomes three launches on one stream:
//   1. each block reduces its 1024-lane tile to one total (per type);
//   2. one block per row scans the tile totals into tile offsets and
//      writes the grand total (per type);
//   3. each block scans its tile again (warp shuffles / ballots, then the
//      warp totals) and adds its tile offset.
// The input is read twice (12 or 13 B/lane moved against the 8 or 9 of
// the bound); a single-pass decoupled look-back scan is later work.
//
// Ranks are stable by construction: lanes are visited in order of
// (chunk, warp, lane), which is increasing lane index, and the commit's
// bit-identity depends on it.  All sums are taken in uint32 and wrap like
// the JAX int32 cumsum.
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, allocates nothing (the caller passes outputs and scratch), does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                    // chunks of kThreads lanes per tile
constexpr int kTile = kThreads * kItems;     // 1024 lanes per block
constexpr int kMaxTypes = 8;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan of one value per thread across the block.  Every thread
// of the block must call it.  *total receives the block total.
__device__ __forceinline__ unsigned block_inclusive_scan(
    unsigned v, unsigned* warp_tot, unsigned* total) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned y = __shfl_up_sync(kFull, v, d);
    if (lane >= (unsigned)d) v += y;
  }
  if (lane == 31u) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < (unsigned)kWarps ? warp_tot[lane] : 0u;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      unsigned y = __shfl_up_sync(kFull, w, d);
      if (lane >= (unsigned)d) w += y;
    }
    if (lane < (unsigned)kWarps) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const unsigned before = warp ? warp_tot[warp - 1] : 0u;
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the caller's next call
  return v + before;
}

// Pass 1 of fork_scan: block b writes the sum of its tile to sums[b].
__global__ void fork_scan_reduce(const int* __restrict__ counts,
                                 unsigned* __restrict__ sums, int n) {
  __shared__ unsigned warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) s += (unsigned)counts[i];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(kFull, s, d);
  if ((threadIdx.x & 31u) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    sums[blockIdx.x] = t;
  }
}

// Pass 2 (both kernels): block r scans row r of rows[rows, nb] in place
// into exclusive tile offsets and writes the row total to totals[r].
__global__ void scan_rows(unsigned* __restrict__ rows, int nb,
                          int* __restrict__ totals) {
  __shared__ unsigned warp_tot[kWarps];
  unsigned* row = rows + (long long)blockIdx.x * nb;
  unsigned carry = 0;
  for (int b0 = 0; b0 < nb; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    const unsigned v = b < nb ? row[b] : 0u;
    unsigned tot;
    const unsigned incl = block_inclusive_scan(v, warp_tot, &tot);
    if (b < nb) row[b] = carry + incl - v;
    carry += tot;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = (int)carry;
}

// Pass 3 of fork_scan: scan each tile and add its tile offset.
__global__ void fork_scan_tiles(const int* __restrict__ counts,
                                const unsigned* __restrict__ tile_offs,
                                int* __restrict__ offs, int n) {
  __shared__ unsigned warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  unsigned carry = tile_offs[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    const unsigned v = i < n ? (unsigned)counts[i] : 0u;
    unsigned tot;
    const unsigned incl = block_inclusive_scan(v, warp_tot, &tot);
    if (i < n) offs[i] = (int)(carry + incl - v);
    carry += tot;
  }
}

// Pass 1 of type_rank: per-tile, per-type active counts into
// counts[type * nb + tile].  Lanes whose type lies outside [0, n_types)
// count nothing.
__global__ void type_rank_reduce(const int* __restrict__ types,
                                 const unsigned char* __restrict__ active,
                                 unsigned* __restrict__ counts, int n,
                                 int n_types, int nb) {
  __shared__ unsigned s_cnt[kMaxTypes];
  if (threadIdx.x < kMaxTypes) s_cnt[threadIdx.x] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  unsigned warp_cnt[kMaxTypes];
#pragma unroll
  for (int j = 0; j < kMaxTypes; ++j) warp_cnt[j] = 0u;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    int t = -1;
    if (i < n && active[i]) t = types[i];
#pragma unroll
    for (int j = 0; j < kMaxTypes; ++j) {
      if (j < n_types) warp_cnt[j] += __popc(__ballot_sync(kFull, t == j));
    }
  }
  if ((threadIdx.x & 31u) == 0) {
#pragma unroll
    for (int j = 0; j < kMaxTypes; ++j) {
      if (j < n_types) atomicAdd(&s_cnt[j], warp_cnt[j]);
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < n_types) {
    counts[(long long)threadIdx.x * nb + blockIdx.x] = s_cnt[threadIdx.x];
  }
}

// Pass 3 of type_rank: rank = tile offset of the lane's type + same-type
// active lanes in earlier chunks of the tile + in earlier warps of this
// chunk + in earlier lanes of this warp (popc of the ballot under the
// lane's less-than mask).  An active lane of an out-of-range type gets
// rank 0, as in the Pallas kernel.
__global__ void type_rank_tiles(const int* __restrict__ types,
                                const unsigned char* __restrict__ active,
                                const unsigned* __restrict__ tile_offs,
                                int* __restrict__ rank, int n, int n_types,
                                int nb) {
  __shared__ unsigned s_warp[kWarps][kMaxTypes];
  __shared__ unsigned s_carry[kMaxTypes];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  if (threadIdx.x < kMaxTypes) {
    s_carry[threadIdx.x] =
        (int)threadIdx.x < n_types
            ? tile_offs[(long long)threadIdx.x * nb + blockIdx.x]
            : 0u;
  }
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    bool act = false;
    int t = -1;
    if (i < n) {
      act = active[i] != 0;
      if (act) t = types[i];
    }
    unsigned within = 0;
#pragma unroll
    for (int j = 0; j < kMaxTypes; ++j) {
      if (j < n_types) {
        const unsigned b = __ballot_sync(kFull, t == j);
        if (t == j) within = __popc(b & lt_mask);
        if (lane == 0) s_warp[warp][j] = __popc(b);
      }
    }
    __syncthreads();
    if (i < n) {
      int r = -1;
      if (act) {
        if (t >= 0 && t < n_types) {
          unsigned off = s_carry[t] + within;
          for (unsigned w = 0; w < warp; ++w) off += s_warp[w][t];
          r = (int)off;
        } else {
          r = 0;
        }
      }
      rank[i] = r;
    }
    __syncthreads();
    if ((int)threadIdx.x < n_types) {
      unsigned s = 0;
      for (int w = 0; w < kWarps; ++w) s += s_warp[w][threadIdx.x];
      s_carry[threadIdx.x] += s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int trees_tile_lanes() { return kTile; }

int trees_max_types() { return kMaxTypes; }

// offs[i] = counts[0] + ... + counts[i-1]; *total = sum of counts.
// scratch: max(1, ceil(n / trees_tile_lanes())) uint32.
int trees_fork_scan(const int* counts, int* offs, int* total,
                    unsigned* scratch, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + kTile - 1) / kTile;
  if (nb > 0) fork_scan_reduce<<<nb, kThreads, 0, s>>>(counts, scratch, n);
  scan_rows<<<1, kThreads, 0, s>>>(scratch, nb, total);
  if (nb > 0) {
    fork_scan_tiles<<<nb, kThreads, 0, s>>>(counts, scratch, offs, n);
  }
  return (int)cudaGetLastError();
}

// rank[i] = stable rank of active lane i among active lanes of its type,
// -1 for an inactive lane; counts[t] = active lanes of type t.
// 1 <= n_types <= trees_max_types(); scratch: n_types * max(1, nb) uint32.
int trees_type_rank(const int* types, const unsigned char* active,
                    int* rank, int* counts, unsigned* scratch, int n,
                    int n_types, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_types < 1 || n_types > kMaxTypes) return (int)cudaErrorInvalidValue;
  const int nb = (n + kTile - 1) / kTile;
  if (nb > 0) {
    type_rank_reduce<<<nb, kThreads, 0, s>>>(types, active, scratch, n,
                                             n_types, nb);
  }
  scan_rows<<<n_types, kThreads, 0, s>>>(scratch, nb, counts);
  if (nb > 0) {
    type_rank_tiles<<<nb, kThreads, 0, s>>>(types, active, scratch, rank, n,
                                            n_types, nb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
