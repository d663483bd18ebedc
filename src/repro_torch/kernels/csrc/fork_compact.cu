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
//     + per-type counts.  Two specialisations of it write the packs its
//     callers build from the rank: trees_lane_pack (one type, active
//     alone: the gather dispatch's frontier pack) and trees_type_pack
//     (the compacted dispatch's permutation, perm[type_start + rank] =
//     lane).
//
// What bounds them on this card: memory.  fork_scan must read 4 bytes and
// write 4 bytes per lane (8 B/lane); type_rank reads an i32 type and a u8
// active flag and writes an i32 rank (9 B/lane; lane_pack reads the flag
// and writes the i32 permutation, 5 B/lane); segmented_fork_scan reads
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
// type_rank: the same single pass, one status word per (tile, type).  Its
// old design reduced 1024-lane tiles, scanned the tile totals in one block
// per type and scanned the tiles again: three launches, 13 B/lane moved
// against the bound's 9, 18.6 % of the bound at 2^21 lanes.  Now a block
// of 128 threads takes a 2048-lane tile from its group's counter; each
// thread holds 16 contiguous lanes, one 16-byte vector of active flags and
// four of types.  One pass over its lanes gives each lane its same-type
// lanes before it in the thread and the thread its count of each type:
// running counts four to a word in 8-bit fields.  Widened to 16-bit
// fields, two types to a word (a tile's counts fit), a warp scan of W / 2
// words gives every thread its same-type lanes in earlier threads.  Warp 0
// publishes W words and looks back as segmented_fork_scan does; each
// thread keeps its W bases in its own column of shared memory, and a
// lane's rank is its type's base plus its running count.  The ranks go
// through shared memory (16-byte chunks, swizzled), so each warp stores
// 512 contiguous bytes.  9 B/lane moved; two device operations.
//
// Its callers used to turn the rank into a pack with six to eleven torch
// ops on the card (a zeros vector of types, fork_offsets of the counts, a
// gather, an add, a full, a where, an arange, an index-put); the pack is
// now written by the kernel.  A tile's packed lanes are its lanes in type
// order; they are staged in shared memory, and each type's run is written
// to its contiguous destination.  With one type group the tiles also
// write perm's -1 tail, [packed lanes, n), each its own unpacked lanes,
// counted from the end, so the permutation is written once and no memset
// clears it first.
//   * lane_pack is the one-type pass that reads active alone and writes
//     perm[rank] = lane for each active lane: 5 B/lane, its bound.
//   * type_pack needs type_start, the scan of counts that only the last
//     tile knows, so it is two launches: the pass publishes the per-type
//     tile prefixes and the counts and writes no lane; a second pass over
//     the same tiles (from blockIdx: it waits on nothing) recounts its
//     lanes, reads its tile's prefix back from the predecessor's inclusive
//     words, scans counts in its warp 0 for type_start, and writes
//     perm[type_start + rank] = lane.  5 + 5 bytes read and 4 written a
//     lane against the bound's 9.
// Their status words are stored complemented, so the scratch and the
// counts (and, past one type group, the permutation) share one buffer and
// one cudaMemsetAsync to all ones (status "unpublished", tile counters at
// ~0, perm -1): type_rank and lane_pack are two device operations,
// type_pack three.
//
// Tile shapes tried at 2^21 and 2^23 lanes: 4096-lane tiles (256 threads)
// and look-back windows of 64 and 128 predecessors changed the times by a
// tenth or less, and so did a resident grid that walks the tiles; staging
// the stores, the running counts (in place of comparing a lane with each
// earlier one) and writing the -1 tail from the tiles each gained.
//
// Groups: a pass keeps W <= kSegGroup = 32 segment or type sums a thread;
// blockIdx.y (with a grid-stride loop past 65535 groups) walks the groups,
// each with its own tile counter and status words, so any n_types or
// n_segs >= 1 works.  Each group reads the tile again; up to 32 segments
// or types (every app, and the 7 types of the mixed4 fleet) the scan is one
// pass.
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

constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

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

// A status word as published: complemented where kOnes (type_rank's
// scratch is cleared to all ones, with the outputs it shares a memset with).
template <bool kOnes>
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  const unsigned long long w = load_status(p);
  return kOnes ? ~w : w;
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
// of segment k receives segment k's sum.  kOnes: the words are stored
// complemented (a scratch cleared to all ones reads as unpublished), as
// type_rank keeps them.
template <int W, bool kOnes = false>
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
      w[i] = idx >= 0 ? load_word<kOnes>(status + (long long)idx * W + k)
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
          w[i] = load_word<kOnes>(
              status + (long long)(last - (i * kRows + j)) * W + k);
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

// Tiles of `tile` lanes over n lanes (at least one, so the totals are
// written for n = 0), and the width a pass runs a group of k segments or
// types at: min(k, kSegGroup) rounded up to a power of two.
int group_tiles(int n, int tile) {
  const long long tiles = ((long long)n + tile - 1) / tile;
  return (int)(tiles > 1 ? tiles : 1);
}
int group_width(int k) {
  int w = 1;
  while (w < k && w < kSegGroup) w <<= 1;
  return w;
}

// uint64 words of look-back scratch for n lanes in tiles of `tile` and k
// segments or types: a tile counter per group of kSegGroup and a status
// word per (group, tile, member of the group's width).
long long lookback_words(int n, int tile, int k) {
  if (k < 1) return 0;
  const long long groups = (k + kSegGroup - 1) / kSegGroup;
  return groups + groups * group_tiles(n, tile) * (long long)group_width(k);
}


// ------------------------------------------ type_rank: decoupled look-back
// A block of kRankThreads threads takes a tile of kRankTile lanes; thread
// t holds lanes [tile * kRankTile + 16 t, + 16): one 16-byte vector of
// active flags and four of types.
constexpr int kRankThreads = 128;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankLanes = 16;
constexpr int kRankTile = kRankThreads * kRankLanes;  // 2048 lanes
constexpr int kTypeGroup = kSegGroup;  // types a pass takes
// What a launch writes for each lane: its rank (type_rank), nothing (the
// first pass of type_pack: counts and status words only), perm[rank] =
// lane for one type (lane_pack), perm[type_start + rank] = lane (the second
// pass of type_pack, which reads the first's status words back).
enum RankMode { kModeRank, kModeCount, kModeLanePack, kModeScatter };
// A lane's key within the type group [g0, g0 + width): its type's index in
// the group, or one of these.
constexpr int kKeyOther = -1;       // active, a valid type of another group
constexpr int kKeyOutOfRange = -2;  // active, a type outside [0, n_types)
constexpr int kKeyInactive = -3;    // inactive, or a lane past the end

// The keys of a thread's 16 lanes from i0 on.  kTypes: read the types (else
// every active lane is type 0: lane_pack reads active alone).
template <bool kTypes>
__device__ __forceinline__ void load_keys(const int* __restrict__ types,
                                          const unsigned char* __restrict__ active,
                                          long long i0, int n, int vec, int g0,
                                          int width, int n_types,
                                          int (&key)[kRankLanes]) {
  unsigned a[4];
  int tv[kRankLanes];
  if (vec && i0 + kRankLanes <= n) {
    const uint4 q = *reinterpret_cast<const uint4*>(active + i0);
    a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
    if constexpr (kTypes) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 r = *reinterpret_cast<const int4*>(types + i0 + 4 * j);
        tv[4 * j] = r.x; tv[4 * j + 1] = r.y;
        tv[4 * j + 2] = r.z; tv[4 * j + 3] = r.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long i = i0 + 4 * j + e;
        if (i < n && active[i]) a[j] |= 1u << (8 * e);
      }
    }
    if constexpr (kTypes) {
#pragma unroll
      for (int e = 0; e < kRankLanes; ++e) {
        tv[e] = i0 + e < n ? types[i0 + e] : 0;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kRankLanes; ++e) {
    const bool act = ((a[e / 4] >> (8 * (e % 4))) & 0xffu) != 0u;
    int k = 0;
    if constexpr (kTypes) k = seg_group_key(tv[e], g0, width, n_types);
    key[e] = act ? k : kKeyInactive;
  }
}

// The swizzled slot of 16-byte chunk c of a tile staged in shared memory:
// rows of eight chunks (128 bytes), a chunk's column XOR its row, so that
// eight threads writing chunks 4t + j, or reading eight consecutive
// chunks, meet eight different bank groups.
__device__ __forceinline__ int stage_chunk(int c) {
  return (c & ~7) | ((c ^ (c >> 3)) & 7);
}

// One type group per loop trip.  Each thread counts its lanes per type of
// the group in registers (running counts, 8-bit fields), the warp scans
// them two types to a word (16-bit fields), the block adds its warps'
// totals in shared memory.  Warp 0 publishes W status words
// (complemented: the scratch is cleared to all ones) and looks back
// (seg_look_back), or, in the scatter pass, reads the tile's prefix back
// from its predecessor's inclusive words and adds each type's start (an
// exclusive scan of counts).  Each thread then keeps its W bases in its
// own column of shared memory, and a lane's rank is its type's base plus
// its running count.  W is the group's width rounded up to a power of two.
// scratch[g]: group g's tile counter (all ones at the launch: the first
// atomicAdd returns ~0); scratch[n_groups + (g * n_tiles + t) * W + k]:
// tile t's word of type g0 + k.
template <int W, int kMode>
__global__ void __launch_bounds__(kRankThreads)
type_rank_lookback(const int* __restrict__ types,
                   const unsigned char* __restrict__ active,
                   int* __restrict__ out, int* __restrict__ counts,
                   unsigned long long* __restrict__ scratch, int n,
                   int n_types, int n_tiles, int n_groups, int vec) {
  constexpr int NQ = (W + 3) / 4;  // a thread's running counts: 8-bit fields
  constexpr int NW = (W + 1) / 2;  // its counts in the scans: 16-bit fields
  constexpr bool kPack = kMode == kModeLanePack || kMode == kModeScatter;
  constexpr int kBase = W > 1 && kMode != kModeCount ? W : 1;
  constexpr int kStage = kMode == kModeCount ? 4 : kRankTile;
  __shared__ unsigned s_wtot[kRankWarps][NW];
  __shared__ unsigned s_base[kBase][kRankThreads];
  __shared__ unsigned s_excl[W];   // the type's first rank (pack: dest) in the tile
  __shared__ unsigned s_tbase[W + 1];  // pack: the type's first tile position
  __shared__ __align__(16) int s_stage[kStage];  // ranks, or packed lanes
  __shared__ unsigned s_tile, s_before;  // pack: packed lanes in earlier tiles
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int g0 = g * kTypeGroup;
    const int width = min(kTypeGroup, n_types - g0);
    unsigned long long* status =
        scratch + n_groups + (long long)g * n_tiles * W;
    int tile = blockIdx.x;
    if constexpr (kMode != kModeScatter) {
      if (threadIdx.x == 0) {
        s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch + g), 1u) + 1u;
      }
      __syncthreads();
      tile = (int)s_tile;
    }
    const long long i0 =
        (long long)tile * kRankTile + (long long)threadIdx.x * kRankLanes;
    int key[kRankLanes];
    load_keys<kMode != kModeLanePack>(types, active, i0, n, vec, g0, width,
                                      n_types, key);
    // each lane's same-type lanes before it in this thread, and the
    // thread's count of each type: one running count per type, four to a
    // word in 8-bit fields (a thread holds 16 lanes); a lane outside the
    // group (key < 0) hits no word
    unsigned quad[NQ];
#pragma unroll
    for (int w = 0; w < NQ; ++w) quad[w] = 0u;
    unsigned r[kRankLanes];
#pragma unroll
    for (int e = 0; e < kRankLanes; ++e) {
      const int k = key[e];
      const unsigned sh = (unsigned)(k & 3) << 3;
      unsigned cur = 0;
#pragma unroll
      for (int w = 0; w < NQ; ++w) {
        const bool hit = (k >> 2) == w;
        cur = hit ? quad[w] : cur;
        quad[w] += hit ? 1u << sh : 0u;
      }
      r[e] = (cur >> sh) & 0xffu;
    }
    unsigned cnt[NW];  // the same counts, two to a word in 16-bit fields
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      cnt[w] = __byte_perm(quad[w >> 1], 0u, (w & 1) ? 0x4342u : 0x4140u);
    }
    unsigned wex[NW];  // same-type lanes in earlier threads of the warp
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned incl = warp_inclusive_scan(cnt[w]);
      wex[w] = incl - cnt[w];
      if (lane == 31u) s_wtot[warp][w] = incl;
    }
    __syncthreads();
    if (warp == 0) {
      unsigned run = 0;  // s_wtot becomes exclusive over warps
      if (lane < (unsigned)NW) {
#pragma unroll
        for (int wp = 0; wp < kRankWarps; ++wp) {
          const unsigned t = s_wtot[wp][lane];
          s_wtot[wp][lane] = run;
          run += t;
        }
      }
      const unsigned agg =
          (__shfl_sync(kFull, run, (lane >> 1) % NW) >> ((lane & 1u) << 4)) &
          0xffffu;
      unsigned prior = 0;  // the type's lanes in earlier tiles
      unsigned excl = 0;
      if constexpr (kMode == kModeScatter) {
        if (tile > 0 && lane < (unsigned)W) {
          excl = (unsigned)~load_status(status + (long long)(tile - 1) * W +
                                        lane);
        }
        prior = excl;
        unsigned run_c = 0;  // counts before type g0 + lane
        for (int c0 = 0; c0 < g0 + width; c0 += 32) {
          const int j = c0 + (int)lane;
          const unsigned v = j < g0 + width ? (unsigned)counts[j] : 0u;
          const unsigned incl = warp_inclusive_scan(v);
          if (c0 == g0) excl += run_c + incl - v;
          run_c += __shfl_sync(kFull, incl, 31);
        }
      } else if (tile == 0) {
        if (lane < (unsigned)W) store_status(status + lane, ~(kInclusive | agg));
      } else {
        unsigned long long* own = status + (long long)tile * W;
        if (lane < (unsigned)W) store_status(own + lane, ~(kAggregate | agg));
        excl = seg_look_back<W, true>(status, tile);
        if (lane < (unsigned)W) {
          store_status(own + lane, ~(kInclusive | (excl + agg)));
        }
      }
      if constexpr (kMode != kModeScatter) prior = excl;
      if (lane < (unsigned)W) {
        s_excl[lane] = excl;
        if (kMode != kModeScatter && tile == n_tiles - 1 &&
            (int)lane < width) {
          counts[g0 + lane] = (int)(excl + agg);
        }
      }
      if constexpr (kPack) {  // the tile's lanes in type order
        const unsigned a = lane < (unsigned)W ? agg : 0u;
        const unsigned incl = warp_inclusive_scan(a);
        if (lane < (unsigned)W) s_tbase[lane] = incl - a;
        if (lane == 31u) s_tbase[W] = incl;
        const unsigned before =
            __reduce_add_sync(kFull, lane < (unsigned)W ? prior : 0u);
        if (lane == 0u) s_before = before;
      }
    }
    __syncthreads();
    if constexpr (kMode != kModeCount) {
      // this thread's first rank of each type: the tile's prefix (a pack:
      // the type's first position in the tile), the earlier warps', the
      // earlier threads' of this warp
      unsigned base0 = 0;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const unsigned wb = s_wtot[warp][k >> 1] + wex[k >> 1];
        const unsigned b = (kPack ? s_tbase[k] : s_excl[k]) +
                           ((wb >> ((k & 1) << 4)) & 0xffffu);
        if constexpr (W == 1) {
          base0 = b;
        } else {
          s_base[k][threadIdx.x] = b;
        }
      }
      int o[kRankLanes];
#pragma unroll
      for (int e = 0; e < kRankLanes; ++e) {
        const int k = key[e];
        unsigned b = base0;
        if constexpr (W > 1) {
          if (k >= 0) b = s_base[k][threadIdx.x];
        }
        o[e] = k >= 0 ? (int)(b + r[e]) : (k == kKeyOutOfRange ? 0 : -1);
      }
      if constexpr (kMode == kModeRank) {
        if (n_groups == 1 && vec &&
            (long long)(tile + 1) * kRankTile <= n) {
          // through shared memory, so that each warp store is 512
          // contiguous bytes; 16-byte chunks swizzled, no bank conflicts
          int4* st = reinterpret_cast<int4*>(s_stage);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[stage_chunk(4 * threadIdx.x + j)] =
                make_int4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
          }
          __syncthreads();
          int4* dst = reinterpret_cast<int4*>(out + (long long)tile * kRankTile);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = j * kRankThreads + threadIdx.x;
            dst[c] = st[stage_chunk(c)];
          }
        } else {
#pragma unroll
          for (int e = 0; e < kRankLanes; ++e) {
            const int k = key[e];
            if (i0 + e < n && (k >= 0 || (g == 0 && k != kKeyOther))) {
              out[i0 + e] = o[e];
            }
          }
        }
      } else {
        // a pack: o is the lane's position in the tile's type-ordered
        // list; stage the list, then write each type's run of it to its
        // contiguous destination from s_excl on
#pragma unroll
        for (int e = 0; e < kRankLanes; ++e) {
          if (key[e] >= 0) s_stage[o[e]] = (int)(i0 + e);
        }
        __syncthreads();
        for (int k = 0; k < W; ++k) {
          const int t0 = (int)s_tbase[k], len = (int)s_tbase[k + 1] - t0;
          int* dst = out + s_excl[k];
          for (int j = threadIdx.x; j < len; j += kRankThreads) {
            dst[j] = s_stage[t0 + j];
          }
        }
        if (n_groups == 1) {
          // perm's -1 tail, [packed lanes, n), split among the tiles from
          // the end: this tile's unpacked lanes go below the earlier
          // tiles' (so no memset writes the permutation first)
          const long long lanes_before = (long long)tile * kRankTile;
          const int un = (int)min((long long)kRankTile, n - lanes_before) -
                         (int)s_tbase[W];
          int* dst = out + (n - (lanes_before - s_before) - un);
          for (int j = threadIdx.x; j < un; j += kRankThreads) dst[j] = -1;
        }
      }
    }
    __syncthreads();  // the shared words serve the next group
  }
}


}  // namespace

extern "C" {

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
  return lookback_words(n, kSegTile, n_segs);
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
  const int tiles = group_tiles(n, kSegTile);
  const int groups = (n_segs + kSegGroup - 1) / kSegGroup;
  const dim3 grid(tiles, groups < kMaxGridY ? groups : kMaxGridY);
  const int vec = reinterpret_cast<unsigned long long>(counts) % 16 == 0 &&
                  reinterpret_cast<unsigned long long>(seg) % 16 == 0 &&
                  reinterpret_cast<unsigned long long>(offs) % 16 == 0;
#define TREES_SEG(W)                                                        \
  seg_scan_lookback<W><<<grid, kSegThreads, 0, s>>>(                        \
      counts, seg, offs, totals, scratch, n, n_segs, tiles, groups, vec);   \
  break;
  switch (group_width(n_segs)) {
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

// uint64 words of scratch type_rank, lane_pack and type_pack take for n
// lanes and n_types types: one tile counter per group of kTypeGroup types
// and one status word per (group, tile, type of the group's width).
long long trees_type_rank_scratch_words(int n, int n_types) {
  return lookback_words(n, kRankTile, n_types);
}

// uint64 words of the work buffer of the three type entries: the scratch,
// then the counts (n_types int32, rounded up to whole words), then, for
// lane_pack (n_types = 1) and type_pack, the permutation (n int32).  One
// memset sets the scratch and the counts to ones (unpublished status
// words, tile counters at ~0), and the permutation to -1 past one type
// group (within one, the tiles write all of it).
long long trees_type_rank_work_words(int n, int n_types, int with_perm) {
  if (n_types < 1 || n < 0) return 0;
  return trees_type_rank_scratch_words(n, n_types) + (n_types + 1) / 2 +
         (with_perm ? ((long long)n + 1) / 2 : 0);
}

}  // extern "C"

namespace {

// Clear the work buffer and run pass kMode (then, for type_pack, the
// scatter pass) over the type groups at the group width.
int launch_type_rank(int mode, const int* types, const unsigned char* active,
                     int* rank, unsigned long long* work, long long work_words,
                     int n, int n_types, cudaStream_t s) {
  const int with_perm = mode != kModeRank;
  const long long need = trees_type_rank_work_words(n, n_types, with_perm);
  if (n_types < 1 || n < 0 || work_words < need) {
    return (int)cudaErrorInvalidValue;
  }
  const long long words = trees_type_rank_scratch_words(n, n_types);
  const int tiles = group_tiles(n, kRankTile);
  const int groups = (n_types + kTypeGroup - 1) / kTypeGroup;
  // one group: the tiles write all of perm, its -1 tail too
  const long long clear = groups == 1 ? words + (n_types + 1) / 2 : need;
  cudaError_t e = cudaMemsetAsync(work, 0xFF, sizeof(*work) * clear, s);
  if (e != cudaSuccess) return (int)e;
  int* counts = reinterpret_cast<int*>(work + words);
  int* perm = reinterpret_cast<int*>(work + words + (n_types + 1) / 2);
  const dim3 grid(tiles, groups < kMaxGridY ? groups : kMaxGridY);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int vec = aligned(active) && (mode == kModeLanePack || aligned(types)) &&
                  (mode != kModeRank || aligned(rank));
  if (mode == kModeLanePack) {
    type_rank_lookback<1, kModeLanePack><<<grid, kRankThreads, 0, s>>>(
        nullptr, active, perm, counts, work, n, 1, tiles, groups, vec);
    return (int)cudaGetLastError();
  }
#define TREES_RANK(W)                                                        \
  if (mode == kModeRank) {                                                   \
    type_rank_lookback<W, kModeRank><<<grid, kRankThreads, 0, s>>>(          \
        types, active, rank, counts, work, n, n_types, tiles, groups, vec);  \
  } else {                                                                   \
    type_rank_lookback<W, kModeCount><<<grid, kRankThreads, 0, s>>>(         \
        types, active, perm, counts, work, n, n_types, tiles, groups, vec);  \
    type_rank_lookback<W, kModeScatter><<<grid, kRankThreads, 0, s>>>(       \
        types, active, perm, counts, work, n, n_types, tiles, groups, vec);  \
  }                                                                          \
  break;
  switch (group_width(n_types)) {
    case 1: TREES_RANK(1)
    case 2: TREES_RANK(2)
    case 4: TREES_RANK(4)
    case 8: TREES_RANK(8)
    case 16: TREES_RANK(16)
    default: TREES_RANK(32)
  }
#undef TREES_RANK
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rank[i] = stable rank of active lane i among the active lanes of its
// type, -1 for an inactive lane, 0 for an active lane whose type lies
// outside [0, n_types); counts (in work, after the scratch) = active lanes
// of each type.  work: trees_type_rank_work_words(n, n_types, 0) uint64,
// any contents (cleared here, on the stream, before the scan).
int trees_type_rank(const int* types, const unsigned char* active, int* rank,
                    unsigned long long* work, long long work_words, int n,
                    int n_types, void* stream) {
  return launch_type_rank(kModeRank, types, active, rank, work, work_words, n,
                          n_types, static_cast<cudaStream_t>(stream));
}

// The frontier pack: perm[d] = the d-th active lane, -1 for d >= count;
// count = the active lanes.  work: trees_type_rank_work_words(n, 1, 1)
// uint64 holding the scratch, count and perm.
int trees_lane_pack(const unsigned char* active, unsigned long long* work,
                    long long work_words, int n, void* stream) {
  return launch_type_rank(kModeLanePack, nullptr, active, nullptr, work,
                          work_words, n, 1, static_cast<cudaStream_t>(stream));
}

// The compaction pack: perm[type_start[t] + rank] = lane for each active
// lane of type t in [0, n_types), -1 past the active lanes; type_start is
// the exclusive scan of counts.  work: trees_type_rank_work_words(n,
// n_types, 1) uint64 holding the scratch, counts and perm.  A memset and
// two launches: the first publishes each tile's per-type prefix and the
// counts, the second reads them back and scatters.
int trees_type_pack(const int* types, const unsigned char* active,
                    unsigned long long* work, long long work_words, int n,
                    int n_types, void* stream) {
  return launch_type_rank(kModeCount, types, active, nullptr, work, work_words,
                          n, n_types, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
