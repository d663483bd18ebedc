// Fork-slot allocation and type compaction scans for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/fork_compact.py:
//   * trees_fork_scan  <- fork_scan (_fork_scan_kernel): exclusive prefix
//     sum + grand total of an i32 vector.  The epoch commit's fork-slot
//     allocation (the paper's atomicInc(nextFreeCore)), the compaction
//     pass's per-type start offsets and the server's slot allocation.
//   * trees_segmented_fork_scan <- segmented_fork_scan (_seg_scan_kernel):
//     each lane's exclusive prefix sum among the lanes of its own segment
//     + per-segment totals.  The JobArena commit's per-region fork-slot
//     allocation (one nextFreeCore per tenant region).
//   * trees_type_rank  <- type_rank (_type_rank_kernel): the stable rank of
//     each active lane among the active lanes of its type (-1 if inactive)
//     + per-type counts.  The compacted dispatch's permutation, and, with
//     one type, the gather dispatch's frontier pack.
//
// What bounds them on this card: memory.  fork_scan must read 4 bytes and
// write 4 bytes per lane (8 B/lane); type_rank reads an i32 type and a u8
// active flag and writes an i32 rank (9 B/lane); segmented_fork_scan reads
// an i32 count and an i32 segment id and writes an i32 offset (12 B/lane).
// At 2^21 lanes the first two move 16.8 MB and 18.9 MB, about 5 and 6
// microseconds at 3.35 TB/s; segmented_fork_scan at 2^23 lanes moves
// 100.7 MB, about 30 microseconds.  The arithmetic (one add, n_types
// ballots, or a 32-step shuffle sum per lane) is far below the card's rate.
//
// The Pallas kernels carry a running sum from one grid step to the next in
// SMEM, which is race-free only because TPU grid steps run in order on one
// core.  CUDA blocks run in no order, so the carry needs a cross-block
// scheme.
//
// fork_scan: one pass, decoupled look-back.  The old design reduced every
// tile, scanned the tile sums in one block and scanned every tile again:
// three launches, the input read twice (12 B/lane against the bound's 8),
// and a single-block pass between the two wide ones; at 2^21 lanes it ran
// at 37 % of its bound, no faster than torch.cumsum.  Now each block of
// 128 threads takes a tile of 4096 lanes from an atomic tile counter (not
// from blockIdx: blocks are not scheduled in blockIdx order, and a tile
// must only wait for tiles whose blocks are already running), loads it
// once with 16-byte vector loads (eight a thread, each warp-wide load 512
// contiguous bytes), and reduces it in registers and shared memory.  Warp
// 0 publishes the tile's aggregate as a packed 64-bit (status, uint32
// value) word, then reads its predecessors' words 32 at a time, nearest
// first, until it meets an inclusive prefix (windows of 128 words were no
// faster at 2^21 lanes); it publishes its own inclusive prefix and the
// block writes the offsets from the values still in registers (one
// 16-byte store per vector).  Value and status share one word, so a
// relaxed 64-bit load sees both or neither and no fence is needed.  The
// last tile writes the total.  The status words and the counter live in
// caller scratch that trees_fork_scan clears with a cudaMemsetAsync on the
// same stream before the launch, so a CUDA graph that replays the call,
// scratch and all, never reads a stale word.  8 B/lane moved; two device
// operations (the memset, the scan).
//
// type_rank and segmented_fork_scan: reduce-then-scan, three launches on
// one stream:
//   1. each block reduces its 1024-lane tile to one total per type or
//      segment;
//   2. one block per row scans the tile totals into tile offsets and
//      writes the grand total (per type or segment);
//   3. each block scans its tile again (warp shuffles / ballots, then the
//      warp totals) and adds its tile offset.
// The input is read twice (13 or 20 B/lane moved against the 9 or 12 of
// the bound); the look-back is their next design.
//
// Groups: type_rank and segmented_fork_scan keep one shared-memory counter
// per type or segment, so a block handles a group of at most kTypeGroup
// types or kSegGroup segments; blockIdx.y (with a grid-stride loop past
// 65535 groups) walks the groups, so any n_types or n_segs >= 1 works.
// Each group reads the tile again.
//
// Segments need not be contiguous (the gather and compacted dispatches
// permute lanes), so within a warp __match_any_sync finds the lanes of the
// same segment and a 32-step shuffle sums the lower ones among them; the
// warp sums per segment go through shared memory and the tile offsets
// through the scanned scratch rows, as for type_rank.
//
// Ranks and offsets are stable by construction: lanes are visited in
// increasing lane order, and the commit's bit-identity depends on it.  All
// sums are taken in uint32 and wrap like the JAX int32 cumsum.
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
constexpr int kTypeGroup = 8;               // types per block (type_rank)
constexpr int kSegGroup = 32;               // segments per block (seg scan)
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSegGroup == 32, "one warp lane per segment of a group");

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

// ------------------------------------------- fork_scan: decoupled look-back
constexpr int kScanThreads = 128;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanVecs = 8;                        // int4 vectors a thread
constexpr int kScanWarpLanes = 32 * 4 * kScanVecs;  // 1024 lanes a warp
constexpr int kScanTile = kScanWarps * kScanWarpLanes;  // 4096 a block
constexpr unsigned long long kAggregate = 1ull << 32;  // status words:
constexpr unsigned long long kInclusive = 2ull << 32;  // (status << 32) | sum

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v) {
  const unsigned lane = threadIdx.x & 31u;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, d);
    if (lane >= (unsigned)d) v += y;
  }
  return v;
}

// The exclusive prefix of everything before tile `tile`: the nearest
// predecessors' words 32 at a time (lane k reads tile - 1 - k), waiting
// until all 32 have published, summed up to and including the nearest
// inclusive one.  Tile 0 is inclusive from the start, so the walk ends.
// Warp-wide: every lane of the warp calls it and receives the sum.
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* status, int tile) {
  const int lane = (int)(threadIdx.x & 31u);
  unsigned excl = 0;
  for (int last = tile - 1;; last -= 32) {
    const int idx = last - lane;
    unsigned long long w = idx >= 0 ? load_status(status + idx) : kInclusive;
    while (__any_sync(kFull, (w >> 32) == 0)) {
      if ((w >> 32) == 0) w = load_status(status + idx);
    }
    const unsigned incl = __ballot_sync(kFull, (w >> 32) == 2);
    if (incl) {
      const int first = __ffs(incl) - 1;
      return excl + __reduce_add_sync(kFull, lane <= first ? (unsigned)w : 0u);
    }
    excl += __reduce_add_sync(kFull, (unsigned)w);
  }
}

// scratch[0]: the tile counter (low 32 bits); scratch[1 + t]: tile t's
// status word.  Both zero at the launch.  vec: counts and offs are 16-byte
// aligned, so whole vectors move as int4.
__global__ void __launch_bounds__(kScanThreads)
fork_scan_lookback(const int* __restrict__ counts, int* __restrict__ offs,
                   int* __restrict__ total,
                   unsigned long long* __restrict__ scratch, int n,
                   int n_tiles, int vec) {
  __shared__ unsigned warp_tot[kScanWarps];
  __shared__ unsigned s_tile, s_excl;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  unsigned long long* status = scratch + 1;
  if (threadIdx.x == 0) {
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  }
  __syncthreads();
  const int tile = (int)s_tile;
  // this lane's vector j holds lanes [i_j, i_j + 4), i_j = base + 128 j + 4
  // lane: a warp's j-th load is 512 contiguous bytes
  const long long base =
      (long long)tile * kScanTile + warp * kScanWarpLanes + 4 * lane;
  unsigned v[kScanVecs][4];
#pragma unroll
  for (int j = 0; j < kScanVecs; ++j) {
    const long long i = base + 128 * j;
    if (vec && i + 4 <= n) {
      const int4 q = *reinterpret_cast<const int4*>(counts + i);
      v[j][0] = q.x; v[j][1] = q.y; v[j][2] = q.z; v[j][3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = i + e < n ? counts[i + e] : 0u;
    }
  }
  // the exclusive prefix of each vector within the warp: lanes in order
  // within a load, loads in order within the warp
  unsigned pre[kScanVecs];
  unsigned run = 0;
#pragma unroll
  for (int j = 0; j < kScanVecs; ++j) {
    const unsigned s = v[j][0] + v[j][1] + v[j][2] + v[j][3];
    const unsigned incl = warp_inclusive_scan(s);
    pre[j] = run + incl - s;
    run += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) warp_tot[warp] = run;
  __syncthreads();
  if (warp == 0) {
    const unsigned wt = lane < (unsigned)kScanWarps ? warp_tot[lane] : 0u;
    const unsigned incl = warp_inclusive_scan(wt);
    const unsigned agg = __shfl_sync(kFull, incl, kScanWarps - 1);
    if (lane < (unsigned)kScanWarps) warp_tot[lane] = incl - wt;
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, kInclusive | agg);
    } else {
      if (lane == 0) store_status(status + tile, kAggregate | agg);
      excl = look_back(status, tile);
      if (lane == 0) store_status(status + tile, kInclusive | (excl + agg));
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == n_tiles - 1) *total = (int)(excl + agg);
    }
  }
  __syncthreads();
  const unsigned off = s_excl + warp_tot[warp];
#pragma unroll
  for (int j = 0; j < kScanVecs; ++j) {
    const long long i = base + 128 * j;
    unsigned o[4];
    o[0] = off + pre[j];
    o[1] = o[0] + v[j][0];
    o[2] = o[1] + v[j][1];
    o[3] = o[2] + v[j][2];
    if (vec && i + 4 <= n) {
      *reinterpret_cast<int4*>(offs + i) =
          make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < n) offs[i + e] = (int)o[e];
      }
    }
  }
}

// Pass 2 of type_rank and segmented_fork_scan: block r scans row r of rows[rows, nb] in place
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

// Pass 1 of type_rank: per-tile, per-type active counts into
// counts[type * nb + tile], one group of kTypeGroup types per loop trip.
// Lanes whose type lies outside [0, n_types) count nothing.
__global__ void type_rank_reduce(const int* __restrict__ types,
                                 const unsigned char* __restrict__ active,
                                 unsigned* __restrict__ counts, int n,
                                 int n_types, int nb) {
  __shared__ unsigned s_cnt[kTypeGroup];
  const int n_groups = (n_types + kTypeGroup - 1) / kTypeGroup;
  const long long base = (long long)blockIdx.x * kTile;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int g0 = g * kTypeGroup;
    const int width = min(kTypeGroup, n_types - g0);
    if (threadIdx.x < kTypeGroup) s_cnt[threadIdx.x] = 0u;
    __syncthreads();
    unsigned warp_cnt[kTypeGroup];
#pragma unroll
    for (int j = 0; j < kTypeGroup; ++j) warp_cnt[j] = 0u;
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      int t = -1;
      if (i < n && active[i]) {
        const int tv = types[i];
        if (tv >= g0 && tv < g0 + width) t = tv - g0;
      }
#pragma unroll
      for (int j = 0; j < kTypeGroup; ++j) {
        if (j < width) warp_cnt[j] += __popc(__ballot_sync(kFull, t == j));
      }
    }
    if ((threadIdx.x & 31u) == 0) {
#pragma unroll
      for (int j = 0; j < kTypeGroup; ++j) {
        if (j < width) atomicAdd(&s_cnt[j], warp_cnt[j]);
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < width) {
      counts[(long long)(g0 + threadIdx.x) * nb + blockIdx.x] =
          s_cnt[threadIdx.x];
    }
    __syncthreads();  // s_cnt is zeroed again by the next group
  }
}

// Pass 3 of type_rank: rank = tile offset of the lane's type + same-type
// active lanes in earlier chunks of the tile + in earlier warps of this
// chunk + in earlier lanes of this warp (popc of the ballot under the
// lane's less-than mask).  Each lane is written once: by the group of its
// type, or, if it is inactive (-1) or active with a type outside
// [0, n_types) (0, as in the Pallas kernel), by group 0.
__global__ void type_rank_tiles(const int* __restrict__ types,
                                const unsigned char* __restrict__ active,
                                const unsigned* __restrict__ tile_offs,
                                int* __restrict__ rank, int n, int n_types,
                                int nb) {
  __shared__ unsigned s_warp[kWarps][kTypeGroup];
  __shared__ unsigned s_carry[kTypeGroup];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int n_groups = (n_types + kTypeGroup - 1) / kTypeGroup;
  const long long base = (long long)blockIdx.x * kTile;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int g0 = g * kTypeGroup;
    const int width = min(kTypeGroup, n_types - g0);
    if (threadIdx.x < kTypeGroup) {
      s_carry[threadIdx.x] =
          (int)threadIdx.x < width
              ? tile_offs[(long long)(g0 + threadIdx.x) * nb + blockIdx.x]
              : 0u;
    }
    __syncthreads();
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      bool act = false;
      int tv = -1;  // the lane's type
      int t = -1;   // its index in this group, -1 outside the group
      if (i < n) {
        act = active[i] != 0;
        if (act) {
          tv = types[i];
          if (tv >= g0 && tv < g0 + width) t = tv - g0;
        }
      }
      unsigned within = 0;
#pragma unroll
      for (int j = 0; j < kTypeGroup; ++j) {
        if (j < width) {
          const unsigned b = __ballot_sync(kFull, t == j);
          if (t == j) within = __popc(b & lt_mask);
          if (lane == 0) s_warp[warp][j] = __popc(b);
        }
      }
      __syncthreads();
      if (i < n) {
        if (t >= 0) {
          unsigned off = s_carry[t] + within;
          for (unsigned w = 0; w < warp; ++w) off += s_warp[w][t];
          rank[i] = (int)off;
        } else if (g == 0 && (!act || tv < 0 || tv >= n_types)) {
          rank[i] = act ? 0 : -1;
        }
      }
      __syncthreads();
      if ((int)threadIdx.x < width) {
        unsigned s = 0;
        for (int w = 0; w < kWarps; ++w) s += s_warp[w][threadIdx.x];
        s_carry[threadIdx.x] += s;
      }
      __syncthreads();
    }
  }
}

// Sum of v over the lanes of this warp below this lane that carry the same
// key; *peers receives the mask of the lanes with this lane's key.  Every
// lane of the warp must call it (the shuffles read every lane).
__device__ __forceinline__ unsigned peer_exclusive_sum(int key, unsigned v,
                                                       unsigned* peers) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned same = __match_any_sync(kFull, key);
  const unsigned below = same & ((1u << lane) - 1u);
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const unsigned x = __shfl_sync(kFull, v, k);
    if (below & (1u << k)) s += x;
  }
  *peers = same;
  return s;
}

// Lane i's key within the segment group [g0, g0 + width): its segment's
// index in the group, or -1 (outside the group, or past the end).  *sv
// receives the lane's segment id (0 past the end), *c its count (0 when
// the key is -1).
__device__ __forceinline__ int seg_key(const int* __restrict__ counts,
                                       const int* __restrict__ seg,
                                       long long i, int n, int g0, int width,
                                       int* sv, unsigned* c) {
  *c = 0u;
  *sv = 0;
  if (i >= n) return -1;
  *sv = seg[i];
  if (*sv < g0 || *sv >= g0 + width) return -1;
  *c = (unsigned)counts[i];
  return *sv - g0;
}

// Pass 1 of segmented_fork_scan: per-tile, per-segment sums into
// sums[segment * nb + tile], one group of kSegGroup segments per loop
// trip.  The highest lane of each same-segment set in a warp adds the
// set's sum to a shared counter.
__global__ void seg_scan_reduce(const int* __restrict__ counts,
                                const int* __restrict__ seg,
                                unsigned* __restrict__ sums, int n,
                                int n_segs, int nb) {
  __shared__ unsigned s_tot[kSegGroup];
  const int lane = (int)(threadIdx.x & 31u);
  const int n_groups = (n_segs + kSegGroup - 1) / kSegGroup;
  const long long base = (long long)blockIdx.x * kTile;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int g0 = g * kSegGroup;
    const int width = min(kSegGroup, n_segs - g0);
    if (threadIdx.x < kSegGroup) s_tot[threadIdx.x] = 0u;
    __syncthreads();
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      int sv;
      unsigned c, peers;
      const int key = seg_key(counts, seg, i, n, g0, width, &sv, &c);
      const unsigned excl = peer_exclusive_sum(key, c, &peers);
      if (key >= 0 && 31 - __clz(peers) == lane) {
        atomicAdd(&s_tot[key], excl + c);
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < width) {
      sums[(long long)(g0 + threadIdx.x) * nb + blockIdx.x] =
          s_tot[threadIdx.x];
    }
    __syncthreads();  // s_tot is zeroed again by the next group
  }
}

// Pass 3 of segmented_fork_scan: offset = tile offset of the lane's
// segment + same-segment counts in earlier chunks of the tile + in earlier
// warps of this chunk + in earlier lanes of this warp.  Each lane is
// written once: by the group of its segment, or, if its id lies outside
// [0, n_segs), with 0 by group 0.
__global__ void seg_scan_tiles(const int* __restrict__ counts,
                               const int* __restrict__ seg,
                               const unsigned* __restrict__ tile_offs,
                               int* __restrict__ offs, int n, int n_segs,
                               int nb) {
  __shared__ unsigned s_warp[kWarps][kSegGroup];
  __shared__ unsigned s_carry[kSegGroup];
  const int lane = (int)(threadIdx.x & 31u);
  const unsigned warp = threadIdx.x >> 5;
  const int n_groups = (n_segs + kSegGroup - 1) / kSegGroup;
  const long long base = (long long)blockIdx.x * kTile;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int g0 = g * kSegGroup;
    const int width = min(kSegGroup, n_segs - g0);
    if ((int)threadIdx.x < width) {
      s_carry[threadIdx.x] =
          tile_offs[(long long)(g0 + threadIdx.x) * nb + blockIdx.x];
    }
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      s_warp[warp][lane] = 0u;  // this chunk's per-warp segment sums
      __syncthreads();
      int sv;
      unsigned c, peers;
      const int key = seg_key(counts, seg, i, n, g0, width, &sv, &c);
      const unsigned excl = peer_exclusive_sum(key, c, &peers);
      if (key >= 0 && 31 - __clz(peers) == lane) {
        s_warp[warp][key] = excl + c;
      }
      __syncthreads();
      if (i < n) {
        if (key >= 0) {
          unsigned off = s_carry[key] + excl;
          for (unsigned w = 0; w < warp; ++w) off += s_warp[w][key];
          offs[i] = (int)off;
        } else if (g == 0 && (sv < 0 || sv >= n_segs)) {
          offs[i] = 0;
        }
      }
      __syncthreads();
      if ((int)threadIdx.x < width) {
        unsigned s = 0;
        for (int w = 0; w < kWarps; ++w) s += s_warp[w][threadIdx.x];
        s_carry[threadIdx.x] += s;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Lanes a block of type_rank and segmented_fork_scan takes (their scratch
// holds one uint32 per tile and type or segment).
int trees_tile_lanes() { return kTile; }

// uint64 words of scratch trees_fork_scan takes for n lanes: the tile
// counter and one status word per tile.
int trees_fork_scan_scratch_words(int n) {
  const long long tiles = ((long long)n + kScanTile - 1) / kScanTile;
  return 1 + (int)(tiles > 1 ? tiles : 1);
}

// offs[i] = counts[0] + ... + counts[i-1]; *total = sum of counts.
// scratch: trees_fork_scan_scratch_words(n) uint64, 8-byte aligned, any
// contents (cleared here, on the stream, before the scan).
int trees_fork_scan(const int* counts, int* offs, int* total,
                    unsigned long long* scratch, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = trees_fork_scan_scratch_words(n);
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(*scratch) * words, s);
  if (e != cudaSuccess) return (int)e;
  const int vec = reinterpret_cast<unsigned long long>(counts) % 16 == 0 &&
                  reinterpret_cast<unsigned long long>(offs) % 16 == 0;
  fork_scan_lookback<<<words - 1, kScanThreads, 0, s>>>(counts, offs, total,
                                                    scratch, n, words - 1,
                                                    vec);
  return (int)cudaGetLastError();
}

// offs[i] = sum of counts[k] over k < i with seg[k] == seg[i] (0 where
// seg[i] lies outside [0, n_segs)); totals[s] = sum of counts over segment
// s.  n_segs >= 1; scratch: n_segs * max(1, nb) uint32.
int trees_segmented_fork_scan(const int* counts, const int* seg, int* offs,
                              int* totals, unsigned* scratch, int n,
                              int n_segs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_segs < 1) return (int)cudaErrorInvalidValue;
  const int nb = (n + kTile - 1) / kTile;
  const int groups = (n_segs + kSegGroup - 1) / kSegGroup;
  const dim3 grid(nb, groups < kMaxGridY ? groups : kMaxGridY);
  if (nb > 0) {
    seg_scan_reduce<<<grid, kThreads, 0, s>>>(counts, seg, scratch, n,
                                              n_segs, nb);
  }
  scan_rows<<<n_segs, kThreads, 0, s>>>(scratch, nb, totals);
  if (nb > 0) {
    seg_scan_tiles<<<grid, kThreads, 0, s>>>(counts, seg, scratch, offs, n,
                                             n_segs, nb);
  }
  return (int)cudaGetLastError();
}

// rank[i] = stable rank of active lane i among active lanes of its type,
// -1 for an inactive lane; counts[t] = active lanes of type t.
// n_types >= 1; scratch: n_types * max(1, nb) uint32.
int trees_type_rank(const int* types, const unsigned char* active,
                    int* rank, int* counts, unsigned* scratch, int n,
                    int n_types, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_types < 1) return (int)cudaErrorInvalidValue;
  const int nb = (n + kTile - 1) / kTile;
  const int groups = (n_types + kTypeGroup - 1) / kTypeGroup;
  const dim3 grid(nb, groups < kMaxGridY ? groups : kMaxGridY);
  if (nb > 0) {
    type_rank_reduce<<<grid, kThreads, 0, s>>>(types, active, scratch, n,
                                               n_types, nb);
  }
  scan_rows<<<n_types, kThreads, 0, s>>>(scratch, nb, counts);
  if (nb > 0) {
    type_rank_tiles<<<grid, kThreads, 0, s>>>(types, active, scratch, rank,
                                              n, n_types, nb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
