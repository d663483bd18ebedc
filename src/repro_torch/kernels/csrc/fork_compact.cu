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
// ballots, or a select and an add per segment of the group and lane) is far
// below the card's rate.
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
// segmented_fork_scan: the same single pass, one status word per (tile,
// segment), so the input is read once.  A block of 128 threads takes a
// 2048-lane tile from its group's counter and loads counts and ids once, in
// 16-byte vectors laid out as fork_scan's.  Each thread sums every segment of the
// group over its 16 lanes in registers (W running sums, W the group's width
// rounded up to a power of two: the wave's tenants, 4, take W = 4); the
// warp reduces them with one redux each, the block over its four warps
// in shared memory.  Warp 0 publishes W packed (status, value) words and
// looks back over windows of 32 predecessors (fewer above W = 8): lane q
// reads segment q % W's words, min(W, 8) of them, and each segment stops
// at its own nearest inclusive word.  The offsets are then written from
// registers: a warp scan per vector and segment, the lanes within a vector
// in order.
// 12 B/lane moved; two device operations (the memset, the scan).
//
// type_rank: reduce-then-scan, three launches on one stream:
//   1. each block reduces its 1024-lane tile to one total per type;
//   2. one block per type scans the tile totals into tile offsets and
//      writes the type's count;
//   3. each block scans its tile again (ballots, then the warp totals) and
//      adds its tile offset.
// The input is read twice (13 B/lane moved against the bound's 9); the
// look-back is its next design.
//
// Groups: a pass keeps W <= kSegGroup = 32 segment sums a thread, and
// type_rank one shared-memory counter per type for kTypeGroup = 8 types;
// blockIdx.y (with a grid-stride loop past 65535 groups) walks the groups
// (segmented_fork_scan gives each its own tile counter and status words),
// so any n_types or n_segs >= 1 works.  Each group reads the tile again; up to 32 segments
// the scan is one pass.
//
// Segments need not be contiguous (the gather and compacted dispatches
// permute lanes): a lane's segment only picks which running sum it adds to.
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
constexpr int kMaxGridY = 65535;
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

// ------------------------------------------- fork_scan: decoupled look-back
constexpr int kScanThreads = 128;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanVecs = 8;                        // int4 vectors a thread
constexpr int kScanWarpLanes = 32 * 4 * kScanVecs;  // 1024 lanes a warp
constexpr int kScanTile = kScanWarps * kScanWarpLanes;  // 4096 a block
constexpr unsigned long long kAggregate = 1ull << 32;  // status words:
constexpr unsigned long long kInclusive = 2ull << 32;  // (status << 32) | sum
// segmented_fork_scan: 128 threads of 4 int4 vectors each, 2048 lanes a
// tile (8 vectors a thread, as fork_scan, ran slower at 2^23 lanes: 96
// registers a thread held five blocks an SM)
constexpr int kSegGroup = 32;  // segments a pass takes
constexpr int kSegThreads = 128;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegVecs = 4;
constexpr int kSegWarpLanes = 32 * 4 * kSegVecs;
constexpr int kSegTile = kSegWarps * kSegWarpLanes;

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

// Pass 2 of type_rank: block r scans row r of rows[rows, nb] in place
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

// ------------------------------ segmented_fork_scan: decoupled look-back
// A lane's key within the segment group [g0, g0 + width): its segment's
// index in the group, kOtherGroup (a valid id of another group) or
// kOutOfRange (an id outside [0, n_segs), or a lane past the end).
constexpr int kOtherGroup = -1;
constexpr int kOutOfRange = -2;

__device__ __forceinline__ int seg_group_key(int sv, int g0, int width,
                                             int n_segs) {
  if ((unsigned)sv - (unsigned)g0 < (unsigned)width) return sv - g0;
  return (unsigned)sv < (unsigned)n_segs ? kOtherGroup : kOutOfRange;
}

// The exclusive prefix, for each segment k < W of the group, of everything
// before tile `tile`.  A window covers kWin = 32 / W x min(W, 8)
// predecessors (32 up to W = 8): lane q, segment k = q % W, reads words i <
// min(W, 8) of segment k at predecessor distance d = i * 32 / W + q / W,
// waiting until all have published.  Each segment stops at its nearest
// inclusive word (the least d, by a shuffle min over its lanes); its words
// up to that one are summed by a shuffle butterfly.  Warp-wide; every lane
// of segment k receives segment k's sum.
template <int W>
__device__ __forceinline__ unsigned seg_look_back(
    const unsigned long long* status, int tile) {
  constexpr int kRows = 32 / W;  // lanes per segment
  constexpr int kWords = W < 8 ? W : 8;
  constexpr int kWin = kRows * kWords;
  const int lane = (int)(threadIdx.x & 31u);
  const int k = lane % W, j = lane / W;
  unsigned excl = 0;
  bool done = false;
  for (int last = tile - 1;; last -= kWin) {
    unsigned long long w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int idx = last - (i * kRows + j);
      w[i] = idx >= 0 ? load_status(status + (long long)idx * W + k)
                      : kInclusive;
    }
    for (;;) {
      bool pending = false;
#pragma unroll
      for (int i = 0; i < kWords; ++i) pending |= (w[i] >> 32) == 0;
      if (!__any_sync(kFull, pending)) break;
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        if ((w[i] >> 32) == 0) {
          w[i] = load_status(status + (long long)(last - (i * kRows + j)) * W + k);
        }
      }
    }
    int dmin = kWin;  // the nearest inclusive word of segment k
#pragma unroll
    for (int i = kWords - 1; i >= 0; --i) {
      if ((w[i] >> 32) == 2) dmin = i * kRows + j;
    }
#pragma unroll
    for (int o = W; o < 32; o <<= 1) {
      dmin = min(dmin, __shfl_xor_sync(kFull, dmin, o));
    }
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if (i * kRows + j <= dmin) v += (unsigned)w[i];
    }
#pragma unroll
    for (int o = W; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
    if (!done) excl += v;
    done = done || dmin < kWin;
    if (__all_sync(kFull, done)) return excl;
  }
}

// One segment group per loop trip: each block takes a tile of kSegTile
// lanes of group g from the group's tile counter, loads counts and ids once
// (16-byte vectors, laid out as fork_scan's), sums each segment over its
// lanes in registers, reduces the sums across the warp (redux) and the
// warps (shared memory), publishes one status word per segment, looks back,
// and writes each lane's offset from the registers: a warp scan per vector
// and segment gives the lanes before it in the warp, the lanes within the
// vector follow in order.  W is the group's width rounded up to a power of
// two.  scratch[g]: group g's tile counter; scratch[n_groups + (g * n_tiles
// + t) * W + k]: tile t's word of segment g0 + k.  All zero at the launch.
template <int W>
__global__ void __launch_bounds__(kSegThreads)
seg_scan_lookback(const int* __restrict__ counts, const int* __restrict__ seg,
                  int* __restrict__ offs, int* __restrict__ totals,
                  unsigned long long* __restrict__ scratch, int n, int n_segs,
                  int n_tiles, int n_groups, int vec) {
  __shared__ unsigned warp_tot[kSegWarps][W];
  __shared__ unsigned s_excl[W];
  __shared__ unsigned s_tile;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int g0 = g * kSegGroup;
    const int width = min(kSegGroup, n_segs - g0);
    unsigned long long* status =
        scratch + n_groups + (long long)g * n_tiles * W;
    if (threadIdx.x == 0) {
      s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch + g), 1u);
    }
    __syncthreads();
    const int tile = (int)s_tile;
    const long long base =
        (long long)tile * kSegTile + warp * kSegWarpLanes + 4 * lane;
    unsigned c[kSegVecs][4];
    int key[kSegVecs][4];
#pragma unroll
    for (int j = 0; j < kSegVecs; ++j) {
      const long long i = base + 128 * j;
      int sv[4];
      if (vec && i + 4 <= n) {
        const int4 q = *reinterpret_cast<const int4*>(counts + i);
        const int4 r = *reinterpret_cast<const int4*>(seg + i);
        c[j][0] = q.x; c[j][1] = q.y; c[j][2] = q.z; c[j][3] = q.w;
        sv[0] = r.x; sv[1] = r.y; sv[2] = r.z; sv[3] = r.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[j][e] = i + e < n ? counts[i + e] : 0u;
          sv[e] = i + e < n ? seg[i + e] : -1;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        key[j][e] = seg_group_key(sv[e], g0, width, n_segs);
        if (key[j][e] < 0) c[j][e] = 0u;
      }
    }
    // each segment's sum over this thread's lanes, then over the warp
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
      unsigned t = 0;
#pragma unroll
      for (int j = 0; j < kSegVecs; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) t += key[j][e] == kk ? c[j][e] : 0u;
      }
      t = __reduce_add_sync(kFull, t);
      if (lane == 0) warp_tot[warp][kk] = t;
    }
    __syncthreads();
    if (warp == 0) {
      unsigned agg = 0;
      if (lane < (unsigned)W) {  // warp_tot becomes exclusive over warps
#pragma unroll
        for (int w = 0; w < kSegWarps; ++w) {
          const unsigned t = warp_tot[w][lane];
          warp_tot[w][lane] = agg;
          agg += t;
        }
      }
      unsigned excl = 0;
      if (tile == 0) {
        if (lane < (unsigned)W) store_status(status + lane, kInclusive | agg);
      } else {
        unsigned long long* own = status + (long long)tile * W;
        if (lane < (unsigned)W) store_status(own + lane, kAggregate | agg);
        excl = seg_look_back<W>(status, tile);
        if (lane < (unsigned)W) {
          store_status(own + lane, kInclusive | (excl + agg));
        }
      }
      if (lane < (unsigned)W) {
        s_excl[lane] = excl;
        if (tile == n_tiles - 1 && (int)lane < width) {
          totals[g0 + lane] = (int)(excl + agg);
        }
      }
    }
    __syncthreads();
    unsigned run[W];
#pragma unroll
    for (int kk = 0; kk < W; ++kk) run[kk] = s_excl[kk] + warp_tot[warp][kk];
#pragma unroll
    for (int j = 0; j < kSegVecs; ++j) {
      const long long i = base + 128 * j;
      unsigned pre[W];
#pragma unroll
      for (int kk = 0; kk < W; ++kk) {
        unsigned t = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) t += key[j][e] == kk ? c[j][e] : 0u;
        const unsigned incl = warp_inclusive_scan(t);
        pre[kk] = run[kk] + incl - t;
        run[kk] += __shfl_sync(kFull, incl, 31);
      }
      unsigned o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = 0u;
#pragma unroll
        for (int kk = 0; kk < W; ++kk) {
          if (key[j][e] == kk) {
            o[e] = pre[kk];
            pre[kk] += c[j][e];
          }
        }
      }
      if (n_groups == 1 && vec && i + 4 <= n) {  // every lane is this group's
        *reinterpret_cast<int4*>(offs + i) =
            make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = key[j][e];
          if (i + e < n && (kk >= 0 || (g == 0 && kk == kOutOfRange))) {
            offs[i + e] = (int)o[e];
          }
        }
      }
    }
    __syncthreads();  // s_tile, warp_tot and s_excl serve the next group
  }
}

// Tiles of segmented_fork_scan, and the width it runs a group of n_segs
// at: min(n_segs, kSegGroup) rounded up to a power of two.
int seg_scan_tiles(int n) {
  const long long tiles = ((long long)n + kSegTile - 1) / kSegTile;
  return (int)(tiles > 1 ? tiles : 1);
}
int seg_scan_width(int n_segs) {
  int w = 1;
  while (w < n_segs && w < kSegGroup) w <<= 1;
  return w;
}

}  // namespace

extern "C" {

// Lanes a block of type_rank takes (its scratch holds one uint32 per tile
// and type).
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

// uint64 words of scratch trees_segmented_fork_scan takes for n lanes and
// n_segs segments: one tile counter per group of kSegGroup segments and one
// status word per (group, tile, segment of the group's width).
long long trees_segmented_fork_scan_scratch_words(int n, int n_segs) {
  if (n_segs < 1) return 0;
  const long long groups = (n_segs + kSegGroup - 1) / kSegGroup;
  return groups + groups * seg_scan_tiles(n) * (long long)seg_scan_width(n_segs);
}

// offs[i] = sum of counts[k] over k < i with seg[k] == seg[i] (0 where
// seg[i] lies outside [0, n_segs)); totals[s] = sum of counts over segment
// s.  n_segs >= 1; scratch: at least
// trees_segmented_fork_scan_scratch_words(n, n_segs) uint64, 8-byte
// aligned, any contents (cleared here, on the stream, before the scan).
int trees_segmented_fork_scan(const int* counts, const int* seg, int* offs,
                              int* totals, unsigned long long* scratch,
                              long long scratch_words, int n, int n_segs,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_segs < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const long long words = trees_segmented_fork_scan_scratch_words(n, n_segs);
  if (scratch_words < words) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(*scratch) * words, s);
  if (e != cudaSuccess) return (int)e;
  const int tiles = seg_scan_tiles(n);
  const int groups = (n_segs + kSegGroup - 1) / kSegGroup;
  const dim3 grid(tiles, groups < kMaxGridY ? groups : kMaxGridY);
  const int vec = reinterpret_cast<unsigned long long>(counts) % 16 == 0 &&
                  reinterpret_cast<unsigned long long>(seg) % 16 == 0 &&
                  reinterpret_cast<unsigned long long>(offs) % 16 == 0;
#define TREES_SEG(W)                                                        \
  seg_scan_lookback<W><<<grid, kSegThreads, 0, s>>>(                        \
      counts, seg, offs, totals, scratch, n, n_segs, tiles, groups, vec);   \
  break;
  switch (seg_scan_width(n_segs)) {
    case 1: TREES_SEG(1)
    case 2: TREES_SEG(2)
    case 4: TREES_SEG(4)
    case 8: TREES_SEG(8)
    case 16: TREES_SEG(16)
    default: TREES_SEG(32)
  }
#undef TREES_SEG
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
