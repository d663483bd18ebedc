// Resident epoch megakernel for Hopper (sm_90a): one launch runs a whole
// K-epoch chunk of the TREES resident loop.
//
// Replaces the Pallas TPU kernel src/repro/kernels/epoch_megakernel.py
// (epoch_chunk / _epoch_chunk_pallas): `while cond(carry, limit):
// carry = body(carry)` with the ResidentCarry updated in place and the
// chunk bound `limit` read on the device, so K = 1, K = 4 and the fully
// resident run re-enter the same compiled kernel.
//
// The adaptation.  The Pallas kernel is generic over a traced JAX body; a
// CUDA kernel cannot run a Python task body.  So this kernel holds the
// program-independent phases of one epoch of EpochLoop.resident_body (solo
// carry, one region):
//   pop -> frontier (masked range, or the gather pack count) -> fork counts
//   and their in-order exclusive scan -> child scatter, join, child
//   pointers, TMS update -> emits and heap writes -> trailing-invalid
//   reclamation -> LIFO push (join continuation below the forked range) ->
//   counters -> map payloads,
// and each app's task bodies are __device__ functions (FibApp, BfsApp,
// MsortApp, TreePostApp, TreePreApp, SsspApp, NQueensApp, TspApp,
// NaiveMsortApp, AnnealingApp, FftApp and MatmulApp below: fib, bfs,
// mergesort in its map and naive variants, treewalk in post- and pre-order,
// sssp, nqueens, tsp, annealing, fft and matmul), written from
// src/repro_torch/apps/*.py with the same effects.  A constant a task body
// captured from its make_program and no heap shape gives (nqueens' and tsp's
// n, annealing's n_bits, n_steps and n_chains, matmul's n and block) comes
// in the launch's `consts`.  A task body runs against a "sink":
// CountSink counts its forks, ApplySink commits its effects, StageSink
// records a map element's writes.
//
// Grid: one persistent cooperative grid (cudaLaunchCooperativeKernel, so
// every CTA is resident) of G CTAs of 1024 threads, G = SMs x the CTAs an
// SM holds (the occupancy API; computed once per device), where the Pallas
// kernel had one program instance because TPU grid steps run in order
// (DESIGN.md §12).  Each epoch begins at a barrier of the whole grid after
// CTA 0's thread 0 has popped the next range; every CTA then reads the
// popped count and takes the same route.  A range of n lanes runs on the
// first ge = min(G, ceil(n / 1024)) CTAs, each owning a contiguous block of
// it, and the others wait at the next epoch's barrier: a narrow epoch (n <=
// 1024; fib has many) runs on CTA 0 alone with __syncthreads, at the cost
// of one grid barrier.  A wide
// epoch crosses the group's barriers:
//   A: pass A writes per-lane counts, scanned within the CTA, and one
//      total per CTA -> barrier -> each CTA scans the ge CTA totals in one
//      warp for its base, so the lane-order fork scan needs no pass of its
//      own;
//   B: pass B writes the TV and each CTA scans its lanes' map domains ->
//      barrier;
//   C: pass C applies the staged emits and heap writes while reclamation
//      (which reads only `epoch`) searches down for the last valid slot in
//      windows of 1024 slots, one per CTA, with a grid-wide atomicMax ->
//      barrier (one more per further round; one round is enough for a
//      forking epoch, whose last child is the last valid slot, and a
//      forkless one whose window misses, as bfs's last epoch of a few
//      lanes does above the emptied TV, hands the rest of the search to
//      the whole grid at the next epoch's start);
//   then CTA 0 pushes and counts, and sums the CTAs' map elements.
// Map payloads (mergesort, fft, matmul) run at the next epoch's start, after its grid
// barrier, so that every CTA takes part whatever the lanes of the epoch
// that scheduled them (the last merges are one lane and 2^18 elements):
// each CTA finds its elements' lanes by the same CTA-total scheme, stage
// -> grid barrier -> apply -> grid barrier.  So a wide epoch crosses four
// barriers (one the grid's), and a map launch that fires two more.
// The barriers count up on words of a caller scratch that the launch
// clears with cudaMemsetAsync on the stream (so K-chunk re-entry and a
// captured graph start clean); the per-epoch control words and the
// reclamation words are kept by epoch parity, so CTA 0 never overwrites
// one that a slower CTA has still to read.
//
// Bits.  The kernel must produce the bits of the plain loop
// (kernels/ref.py::epoch_chunk_ref over the torch resident body):
//   * Every read of an epoch sees the TV and heap as they were before the
//     epoch.  Pass A evaluates each active lane's body and counts its forks
//     (no writes); the counts are scanned in lane order (allocation order
//     is part of the bits).  Pass B evaluates the body again and writes
//     the TV: children go to fresh slots >= nextFreeCore, which hold no
//     valid task, and a lane's own row is read into registers before it is
//     written.  Emitted values and heap writes are staged per lane and
//     applied in pass C, after a barrier, so that a join lane reading its
//     children's values, or bfs reading the `dist` it min-writes, sees the
//     snapshot.
//   * Across CTAs: each CTA owns a contiguous block of the range, so its
//     base (the forks of the CTAs before it) plus its own scan is the
//     lane-order scan.  Passes A and B of every CTA end before any pass C
//     begins (a barrier), and pass A before any pass B: the TV rows pass B
//     writes are each lane's own and fresh slots, which no lane reads in
//     the epoch, and values and heap change only in pass C.
//   * Forks past the capacity are dropped (the plain loop's sink row);
//     the overflow fails the region and zeroes its stack pointer.  A push
//     onto a full stack clips to the top row and flags failed_stack.
//   * Reclamation: next_free = min(next_free + forks, last_valid + 1).  No
//     valid slot lies at or above next_free + forks (the allocator hands
//     out slots above every valid one; the CPU tests assert it after every
//     epoch), so the search for last_valid starts there and walks down.
//   * Map payloads run after the push (at the next epoch's start, before
//     its pass A) and see the heap after the commit.
//     A launch whose scheduled lanes all have empty domains runs and counts
//     nothing; otherwise its live elements (lane, element < domain) are
//     laid out by an in-order prefix over the lanes' domains, each element
//     is evaluated into a stage (reads see the pre-payload heap) and the
//     stage is applied after a barrier.  map_lanes adds the lane rung x
//     domain rung of the JAX body.
//   * Counters are int64 (the JAX carry's exact hi/lo pairs, decoded).
//   * Float arithmetic in a task or map body is written with explicit
//     rounding intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn, __dmul_rn, ...):
//     nvcc contracts a * b + c into one FMA by default, and the plain loop
//     rounds each torch operation on its own.  fft's twiddles are cosf /
//     sinf, the functions torch's CUDA cos / sin call.
//
// What bounds it on this card: latency, not bytes or operations.  The
// bytes a chunk must move are about 24-48 bytes per task and per fork
// (RunStats-derived bound in PERF.md: tens of microseconds for the
// full-size runs).  A wide epoch's lanes spread over every SM, so what
// bounds a chunk is serial: the grid barriers (one an epoch, about four
// more a wide one, each a round trip of every CTA to one L2 word), CTA 0's
// one-thread pop and push, and the narrow epochs on one CTA.
// chip_smoke.py times an empty cooperative kernel of N barriers
// (trees_grid_sync_bench) to price that floor.
//
// Atomics: heap add/min/max keep their atomics (heap_apply) across CTAs as
// they did across threads: int add/min/max and float min/max (sssp's
// dist, a compare-and-swap loop) are order-independent.  Float add is not,
// and takes no atomicAdd: a map payload's float add (matmul's C, n / block
// terms a cell in one payload) goes through the ordered add of
// ordered_add.cuh, inside the chunk: count -> grid barrier -> the counts'
// scan over the CTAs' blocks of cells (two barriers) -> place -> barrier ->
// each cell's run sorted by stage position and summed from the old value
// in that order, which is run_map_payload's lane-major order and the CPU
// index_add_'s.  Only a table that declares kOrderedMapAdd pays those four
// barriers a payload (STATS' ordered_barriers).  A float add from a task
// body (pass C), or from the map of a table without kOrderedMapAdd, is a
// fault (kFaultFloatAdd) that ends the chunk; no table writes one.
//
// C interface (bound with ctypes): trees_epoch_chunk launches on the given
// stream, allocates nothing (the caller passes the carry, the scratch and
// the chunk bound as device pointers), does not synchronise, and returns
// the cooperative launch's error or cudaGetLastError(): a refused launch
// is an error, with no single-CTA fallback.  A fault found on the device
// (a map stage too small, a float add outside the ordered path) is written
// to the carry's `fault` word and ends the chunk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered_add.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSpan = 8;
constexpr int kMaxMaps = 4;
constexpr int kMaxMapW = 40;
constexpr int kMaxHeap = 8;
constexpr int kMaxConsts = 4;

enum Op { kSet = 0, kAdd = 1, kMin = 2, kMax = 3 };
enum Dtype { kI32 = 0, kF32 = 1 };

// lane_flags bits: active, emitted, one bit per map launch; the task type
// + 1 above bit 8 (0: a type outside the program — active, no effects)
constexpr int kActive = 1;
constexpr int kEmitted = 2;
constexpr int kMapBit = 4;  // kMapBit << g for map launch g (< 4)
constexpr int kTypeShift = 8;

constexpr int kFaultStage = 1;
constexpr int kFaultFloatAdd = 2;

// ---- the argument layout shared with epoch_megakernel.py -----------------
enum Ptr {
  P_TASK, P_ARGI, P_ARGF, P_EPOCH, P_VALUE, P_CHILD_BASE, P_CHILD_COUNT,
  P_NEXT_FREE, P_JSTACK, P_RSTACK, P_SP, P_FAILED, P_FAILED_STACK,
  P_N_EPOCHS, P_JOB_EPOCHS, P_JOB_TASKS, P_JOB_FORKS, P_JOB_PEAK,
  P_MAP_LAUNCHES, P_MAP_ELEMENTS, P_MAP_LANES, P_HOLE_LANES, P_FAULT,
  P_LIMIT, P_LANE_CNT, P_LANE_EXCL, P_LANE_FLAGS, P_EMIT_STAGE, P_WR_IDX,
  P_WR_VAL, P_WR_META, P_MAP_ARGI, P_MAP_ARGF, P_MAP_PRE, P_ST_IDX,
  P_ST_VAL, P_ST_META, P_COOP, P_STATS, P_OA_CNT, P_OA_OFF, P_OA_LONG,
  P_OA_RUN, P_OA_TOT, P_HEAP0, P_COUNT = P_HEAP0 + kMaxHeap
};
enum Int {
  I_CAPACITY, I_DEPTH, I_GATHER, I_N_SPAN, I_SPAN0,
  I_STAGE_CAP = I_SPAN0 + kMaxSpan, I_N_HEAP, I_HEAP_LEN0,
  I_HEAP_DTYPE0 = I_HEAP_LEN0 + kMaxHeap, I_N_MAPS = I_HEAP_DTYPE0 + kMaxHeap,
  I_MAP0,  // per map: max_domain, n_widths, widths[kMaxMapW]
  I_N_ARG_I = I_MAP0 + kMaxMaps * (2 + kMaxMapW), I_N_ARG_F, I_VALUE_WIDTH,
  I_GRID, I_COOP_WORDS, I_CONST0, I_COUNT = I_CONST0 + kMaxConsts
};

struct Params {
  int* task; int* argi; float* argf; int* epoch; uint32_t* value;
  int* child_base; int* child_count; int* next_free;
  int* jstack; int* rstack; int* sp;
  uint8_t* failed; uint8_t* failed_stack;
  int* n_epochs; int* job_epochs; long long* job_tasks; long long* job_forks;
  int* job_peak;
  int* map_launches; long long* map_elements; long long* map_lanes;
  long long* hole_lanes; int* fault;
  const int* limit;
  // scratch, lane-relative (lane l is slot start + l of the popped range)
  int* lane_cnt; int* lane_excl; int* lane_flags; uint32_t* emit_stage;
  int* wr_idx; uint32_t* wr_val; int* wr_meta;
  int* map_argi; float* map_argf; long long* map_pre;
  int* st_idx; uint32_t* st_val; int* st_meta;
  unsigned long long* coop;  // the grid's barriers and totals
  long long* stats;          // optional: epochs and barriers, or null
  // the ordered float add's scratch (tables with kOrderedMapAdd): per cell
  // of the added variable a count and a cursor, then the long-run count
  // and its copy (oa_cnt, zero between uses); the counts' scan (oa_off);
  // the long cells (oa_long); two stage-sized position buffers (oa_run);
  // one total per CTA (oa_tot)
  int* oa_cnt; int* oa_off; int* oa_long; int* oa_run; int* oa_tot;
  uint32_t* heap[kMaxHeap];
  int grid;                  // CTAs of the cooperative launch
  int capacity, depth, gather, n_span;
  int span_w[kMaxSpan];
  long long stage_cap;
  int n_heap;
  int heap_len[kMaxHeap];  // real rows; row heap_len is the sink
  int heap_dtype[kMaxHeap];
  int n_maps;
  int max_domain[kMaxMaps];
  int n_map_w[kMaxMaps];
  int map_w[kMaxMaps][kMaxMapW];
  int consts[kMaxConsts];  // the app's constants (DeviceTable.consts)
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// floor division and modulo, as torch's // and % on int tensors
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  return a - floordiv(a, b) * b;
}

// torch's int32 shifts: by a negative amount or one of 32 or more, << gives
// 0 and >> the sign; within range << wraps (1 << 31 is INT_MIN)
__device__ __forceinline__ int shl(int a, int b) {
  return (unsigned)b < 32u ? (int)((uint32_t)a << b) : 0;
}
__device__ __forceinline__ int sar(int a, int b) {
  return a >> ((unsigned)b < 32u ? b : 31);
}
// int32 + and * that wrap, as torch's do
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// smallest rung >= key (searchsorted left), clipped to the top rung
__device__ __forceinline__ int rung(const int* w, int n, long long key) {
  for (int i = 0; i < n; ++i) {
    if ((long long)w[i] >= key) return w[i];
  }
  return w[n - 1];
}

// Exclusive scan of one value per thread across the block, in thread
// order.  Every thread must call it.  *total receives the block total.
template <class T>
__device__ __forceinline__ T block_excl_scan(T v, T* s_warp, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = s_warp[lane];  // kWarps == 32
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const T before = warp ? s_warp[warp - 1] : T(0);
  *total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is reused by the next call
  return before + x - v;
}

// ---- heap access (reads clip to the real rows, as heap_read does) --------
__device__ __forceinline__ int heap_i32(const Params& p, int var, int idx) {
  return (int)p.heap[var][clampi(idx, 0, p.heap_len[var] - 1)];
}
__device__ __forceinline__ float heap_f32(const Params& p, int var, int idx) {
  return __uint_as_float(p.heap[var][clampi(idx, 0, p.heap_len[var] - 1)]);
}

// Apply one write; false for a float add, which has no order-free atomic
// (the caller faults: only the ordered add may take it).
__device__ __forceinline__ bool heap_apply(const Params& p, int meta, int idx, uint32_t bits) {
  const int var = meta >> 2;
  const int op = meta & 3;
  uint32_t* a = p.heap[var] + idx;
  if (op == kSet) {
    *a = bits;
  } else if (p.heap_dtype[var] == kI32) {
    const int v = (int)bits;
    if (op == kAdd) atomicAdd((int*)a, v);
    else if (op == kMin) atomicMin((int*)a, v);
    else atomicMax((int*)a, v);
  } else {
    const float v = __uint_as_float(bits);
    if (op == kAdd) {
      return false;
    } else {
      uint32_t old = *a, assumed;
      do {
        assumed = old;
        const float cur = __uint_as_float(assumed);
        const bool take = op == kMin ? v < cur : v > cur;
        if (!take) break;
        old = atomicCAS(a, assumed, bits);
      } while (old != assumed);
    }
  }
  return true;
}

// ---- one lane's view of its TV row, read before the epoch's writes --------
template <class App>
struct TaskIn {
  int slot;
  int argi[App::kArgI];
  float argf[App::kArgF > 0 ? App::kArgF : 1];
  int child_base, child_count;

  __device__ void load(const Params& p, int cidx) {
    slot = cidx;
#pragma unroll
    for (int k = 0; k < App::kArgI; ++k) argi[k] = p.argi[cidx * App::kArgI + k];
#pragma unroll
    for (int k = 0; k < App::kArgF; ++k) argf[k] = p.argf[cidx * App::kArgF + k];
    child_base = p.child_base[cidx];
    child_count = p.child_count[cidx];
  }

  // ctx.child_values(n)[k, w]: the k-th child's value (0 past child_count)
  __device__ uint32_t child_value(const Params& p, int k, int w) const {
    if (k >= child_count) return 0u;
    const int c = clampi(child_base + k, 0, p.capacity - 1);
    return p.value[c * App::kValW + w];
  }
};

// Pass A: count the forks that fire.
struct CountSink {
  int n = 0;
  __device__ void fork(int, const int*, const float*, bool where) { n += where; }
  __device__ void join(int, const int*, const float*, bool) {}
  __device__ void emit(const uint32_t*, bool) {}
  __device__ void write(int, int, int, uint32_t, int, bool) {}
  __device__ void map(int, const int*, const float*, bool) {}
};

// Pass B: commit one lane's effects.  Children and the lane's own TV row
// are written here; emits, heap writes and map arguments are staged.
template <class App>
struct ApplySink {
  const Params& p;
  int cidx, l, cen;
  unsigned base, within = 0;
  bool joined = false, emitted = false;
  int map_bits = 0;
  uint32_t val[App::kValW];
  int w_idx[App::kWrites > 0 ? App::kWrites : 1];
  uint32_t w_val[App::kWrites > 0 ? App::kWrites : 1];
  int w_meta[App::kWrites > 0 ? App::kWrites : 1];

  __device__ ApplySink(const Params& p_, int cidx_, int l_, int cen_,
                       unsigned base_)
      : p(p_), cidx(cidx_), l(l_), cen(cen_), base(base_) {
#pragma unroll
    for (int k = 0; k < App::kWrites; ++k) w_meta[k] = -1;
  }

  __device__ void fork(int task, const int* ai, const float* af, bool where) {
    if (!where) return;
    const int raw = (int)(base + within);
    ++within;
    if (raw < 0 || raw >= p.capacity) return;  // past the TV: dropped
    p.task[raw] = task;
#pragma unroll
    for (int k = 0; k < App::kArgI; ++k) p.argi[raw * App::kArgI + k] = ai[k];
#pragma unroll
    for (int k = 0; k < App::kArgF; ++k) p.argf[raw * App::kArgF + k] = af[k];
    p.epoch[raw] = cen + 1;
    p.child_base[raw] = 0;
    p.child_count[raw] = 0;
  }

  __device__ void join(int task, const int* ai, const float* af, bool where) {
    if (!where) return;
    joined = true;
    p.task[cidx] = task;
#pragma unroll
    for (int k = 0; k < App::kArgI; ++k) p.argi[cidx * App::kArgI + k] = ai[k];
#pragma unroll
    for (int k = 0; k < App::kArgF; ++k) p.argf[cidx * App::kArgF + k] = af[k];
  }

  __device__ void emit(const uint32_t* v, bool where) {
    if (!where) return;
    emitted = true;
#pragma unroll
    for (int w = 0; w < App::kValW; ++w) val[w] = v[w];
  }

  __device__ void write(int k, int var, int idx, uint32_t bits, int op,
                        bool where) {
    if (!where) return;
    w_idx[k] = clampi(idx, 0, p.heap_len[var] - 1);
    w_val[k] = bits;
    w_meta[k] = (var << 2) | op;
  }

  __device__ void map(int g, const int* ai, const float* af, bool where) {
    if (!where) return;
    map_bits |= kMapBit << g;
    const long long row = (long long)g * p.capacity + l;
#pragma unroll
    for (int k = 0; k < App::kArgI; ++k) p.map_argi[row * App::kArgI + k] = ai[k];
#pragma unroll
    for (int k = 0; k < App::kArgF; ++k) p.map_argf[row * App::kArgF + k] = af[k];
  }

  // the lane's child pointers, TMS update and staged effects; returns the
  // lane's new flags
  __device__ int finish(int flags, int lane_count) {
    p.child_base[cidx] = (int)base;
    p.child_count[cidx] = lane_count;
    if (!joined) p.epoch[cidx] = 0;
    if (emitted) {
      flags |= kEmitted;
#pragma unroll
      for (int w = 0; w < App::kValW; ++w) {
        p.emit_stage[(long long)l * App::kValW + w] = val[w];
      }
    }
#pragma unroll
    for (int k = 0; k < App::kWrites; ++k) {
      const long long at = (long long)k * p.capacity + l;
      p.wr_meta[at] = w_meta[k];
      p.wr_idx[at] = w_idx[k];
      p.wr_val[at] = w_val[k];
    }
    return flags | map_bits;
  }
};

// Map payload: stage one element's writes at position f of the stage.
template <class App>
struct StageSink {
  const Params& p;
  long long f;
  __device__ void write(int k, int var, int idx, uint32_t bits, int op,
                        bool where) {
    const long long at = (long long)k * p.stage_cap + f;
    p.st_meta[at] = where ? ((var << 2) | op) : -1;
    p.st_idx[at] = clampi(idx, 0, p.heap_len[var] - 1);
    p.st_val[at] = bits;
  }
};

// ---- the device task tables ------------------------------------------------
// An App holds kTypes task bodies over kArgI int and kArgF float arguments,
// a value of kValW words, kWrites heap write sites per task, kHeap heap
// variables and kMapLaunches map launches of kMapWrites write sites each;
// consts_ok checks the launch's constants on the host.  kOrderedMapAdd
// says the maps' float adds (into heap variable kOrderedVar only) go
// through the ordered add.  AppDefaults gives the apps without maps or
// constants their (empty) map hooks.
struct AppDefaults {
  static constexpr int kMapLaunches = 0, kMapWrites = 0;
  static constexpr bool kOrderedMapAdd = false;
  static constexpr int kOrderedVar = 0;
  static bool consts_ok(const long long*) { return true; }
  __device__ static int map_id(int) { return 0; }
  __device__ static int map_domain(int, const int*, const Params&) { return 0; }
  template <class S>
  __device__ static void map_payload(int, const int*, const float*, int,
                                     const Params&, S&) {}
};

// fib (src/repro_torch/apps/fib.py): fib forks fib(n-1), fib(n-2) and joins
// fibsum unless n < 2, where it emits n; fibsum emits the sum of its two
// children's values.
struct FibApp : AppDefaults {
  static constexpr int kTypes = 2, kArgI = 1, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 0, kHeap = 0;

  template <class S>
  __device__ static void task(int type, const TaskIn<FibApp>& in,
                              const Params& p, S& s) {
    if (type == 0) {
      const int n = in.argi[0];
      const bool leaf = n < 2;
      const uint32_t v = (uint32_t)n;
      s.emit(&v, leaf);
      const int a0[1] = {n - 1};
      s.fork(0, a0, nullptr, !leaf);
      const int a1[1] = {n - 2};
      s.fork(0, a1, nullptr, !leaf);
      const int z[1] = {0};
      s.join(1, z, nullptr, !leaf);
    } else {
      const uint32_t v = in.child_value(p, 0, 0) + in.child_value(p, 1, 0);
      s.emit(&v, true);
    }
  }
};

// bfs (src/repro_torch/apps/bfs.py): visit(v, d, chunk) claims v with a
// min-write of d on dist and forks up to CHUNK = 8 unvisited neighbours,
// plus the next chunk of its edge list.
struct BfsApp : AppDefaults {
  static constexpr int kTypes = 1, kArgI = 3, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 1, kHeap = 3;
  static constexpr int kChunk = 8;
  enum { kAdjOff = 0, kAdj = 1, kDist = 2 };

  template <class S>
  __device__ static void task(int, const TaskIn<BfsApp>& in, const Params& p,
                              S& s) {
    const int v = in.argi[0], d = in.argi[1], chunk = in.argi[2];
    const int off = heap_i32(p, kAdjOff, v);
    const int deg = heap_i32(p, kAdjOff, v + 1) - off;
    const bool first = chunk == 0;
    const bool improve = d < heap_i32(p, kDist, v);
    const bool live = !first || improve;
    s.write(0, kDist, v, (uint32_t)d, kMin, first && improve);
    const int base = chunk * kChunk;
    for (int i = 0; i < kChunk; ++i) {
      const int e = base + i;
      const int u = heap_i32(p, kAdj, off + e);
      const bool stale = heap_i32(p, kDist, u) <= d + 1;
      const int a[3] = {u, d + 1, 0};
      s.fork(0, a, nullptr, live && (e < deg) && !stale);
    }
    const int a[3] = {v, d, chunk + 1};
    s.fork(0, a, nullptr, live && (base + kChunk < deg));
  }
};

// mergesort (src/repro_torch/apps/mergesort.py), both variants: msort
// splits until span 1 (a leaf copies its input element into its level's
// buffer) and joins merge; the merge places each element of its span at
// its own offset plus its rank in the sibling half (a binary search of
// log2(n) steps; left elements win ties).  Level `depth` reads buffer
// (depth + 1) % 2 and writes buffer depth % 2 of `src` (2n floats).
struct MsortBase : AppDefaults {
  static constexpr int kArgI = 4, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 1, kHeap = 2;
  enum { kInp = 0, kSrc = 1 };

  __device__ static int buf(const Params& p, int depth) {
    return floormod(depth, 2) * p.heap_len[kInp];
  }

  // msort(lo, span, depth)
  template <class S>
  __device__ static void split(int lo, int span, int depth, const Params& p,
                               S& s) {
    const bool leaf = span == 1;
    s.write(0, kSrc, buf(p, depth) + lo,
            __float_as_uint(heap_f32(p, kInp, lo)), kSet, leaf);
    const int half = floordiv(span, 2);
    const int a0[4] = {lo, half, depth + 1, 0};
    s.fork(0, a0, nullptr, !leaf);
    const int a1[4] = {lo + half, half, depth + 1, 0};
    s.fork(0, a1, nullptr, !leaf);
    const int j[4] = {lo, span, depth, 0};
    s.join(1, j, nullptr, !leaf);
  }

  // the placement of element i of a merge: the map payload `place` and
  // naive's `place1` task alike (_place_common)
  template <class S>
  __device__ static void place(int lo, int span, int depth, int i,
                               const Params& p, S& s) {
    const int n = p.heap_len[kInp];
    const int log_n = 31 - __clz(n);
    const int half = floordiv(span, 2);
    const int rbuf = buf(p, depth + 1);
    const int wbuf = buf(p, depth);
    const bool from_left = i < half;
    const int own_off = from_left ? i : i - half;
    const int other_lo = rbuf + (from_left ? lo + half : lo);
    const float v = heap_f32(p, kSrc, rbuf + lo + i);
    int a = 0, b = half;  // search in [a, b)
    for (int it = 0; it < log_n; ++it) {
      const int mid = floordiv(a + b, 2);
      const int at = mid < 0 ? 0 : mid;
      const float x = heap_f32(p, kSrc, other_lo + (at < half - 1 ? at : half - 1));
      const bool go_right = (from_left ? x < v : x <= v) && (a < b);
      if (go_right) a = mid + 1; else b = mid;
    }
    s.write(0, kSrc, wbuf + lo + own_off + a, __float_as_uint(v), kSet, true);
  }
};

// the map variant: merge schedules one `place` map over its span
struct MsortApp : MsortBase {
  static constexpr int kTypes = 2;
  static constexpr int kMapLaunches = 1, kMapWrites = 1;

  template <class S>
  __device__ static void task(int type, const TaskIn<MsortApp>& in,
                              const Params& p, S& s) {
    const int lo = in.argi[0], span = in.argi[1], depth = in.argi[2];
    if (type == 0) {
      split(lo, span, depth, p, s);
    } else {
      const int m[4] = {lo, span, depth, 0};
      s.map(0, m, nullptr, true);
    }
  }
  __device__ static int map_id(int) { return 0; }
  __device__ static int map_domain(int, const int* ai, const Params&) {
    return ai[1];
  }

  template <class S>
  __device__ static void map_payload(int, const int* ai, const float*, int i,
                                     const Params& p, S& s) {
    place(ai[0], ai[1], ai[2], i, p, s);
  }
};

// the naive variant: merge forks place1(lo, span, depth, i) at n static
// sites, i = 0..n-1, where i < span, in site order (allocation order); the
// sites past the span never fire, so the loop stops at min(n, span) and is
// not unrolled (n = 1024 at the chip size)
struct NaiveMsortApp : MsortBase {
  static constexpr int kTypes = 3;

  template <class S>
  __device__ static void task(int type, const TaskIn<NaiveMsortApp>& in,
                              const Params& p, S& s) {
    const int lo = in.argi[0], span = in.argi[1], depth = in.argi[2];
    if (type == 0) {
      split(lo, span, depth, p, s);
    } else if (type == 1) {
      const int sites = min(p.heap_len[kInp], span);
#pragma unroll 1
      for (int i = 0; i < sites; ++i) {
        const int a[4] = {lo, span, depth, i};
        s.fork(2, a, nullptr, true);
      }
    } else {
      place(lo, span, depth, in.argi[3], p, s);
    }
  }
};

// treewalk (src/repro_torch/apps/treewalk.py) over heap left, right (child
// indices, -1 = NULL), visit_epoch and visit_clock: a visit adds 1 to the
// clock and stamps its node with the clock as it stood before the epoch.
// A read at node -1 clips to row 0, as every heap read does.
struct TreeBase : AppDefaults {
  static constexpr int kArgI = 1, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 2, kHeap = 4;
  enum { kLeft = 0, kRight = 1, kVisit = 2, kClock = 3 };

  template <class S>
  __device__ static void visit(int node, const Params& p, S& s, bool where) {
    s.write(0, kClock, 0, 1u, kAdd, where);
    s.write(1, kVisit, node, (uint32_t)heap_i32(p, kClock, 0), kSet, where);
  }
  template <class S>
  __device__ static void fork_children(int node, const Params& p, S& s,
                                       bool where) {
    const int l[1] = {heap_i32(p, kLeft, node)};
    s.fork(0, l, nullptr, where);
    const int r[1] = {heap_i32(p, kRight, node)};
    s.fork(0, r, nullptr, where);
  }
};

// post-order: walk(node) forks walk on both children and joins
// visit_after(node), which visits; a NULL node does nothing
struct TreePostApp : TreeBase {
  static constexpr int kTypes = 2;

  template <class S>
  __device__ static void task(int type, const TaskIn<TreePostApp>& in,
                              const Params& p, S& s) {
    const int node = in.argi[0];
    if (type == 0) {
      fork_children(node, p, s, node >= 0);
      s.join(1, in.argi, nullptr, node >= 0);
    } else {
      visit(node, p, s, true);
    }
  }
};

// pre-order: walk(node) visits, then forks walk on both children
struct TreePreApp : TreeBase {
  static constexpr int kTypes = 1;

  template <class S>
  __device__ static void task(int, const TaskIn<TreePreApp>& in,
                              const Params& p, S& s) {
    const int node = in.argi[0];
    visit(node, p, s, node >= 0);
    fork_children(node, p, s, node >= 0);
  }
};

// sssp (src/repro_torch/apps/sssp.py): relax(v, chunk; d) claims v with a
// float min-write of d on dist and forks relax(u, 0; d + w) for up to
// CHUNK = 8 neighbours u the new distance improves, plus the next chunk of
// its edge list.  d is the TV's float argument; d + w is one float32 add.
struct SsspApp : AppDefaults {
  static constexpr int kTypes = 1, kArgI = 2, kArgF = 1, kValW = 1;
  static constexpr int kWrites = 1, kHeap = 4;
  static constexpr int kChunk = 8;
  enum { kAdjOff = 0, kAdj = 1, kWgt = 2, kDist = 3 };

  template <class S>
  __device__ static void task(int, const TaskIn<SsspApp>& in, const Params& p,
                              S& s) {
    const int v = in.argi[0], chunk = in.argi[1];
    const float d = in.argf[0];
    const int off = heap_i32(p, kAdjOff, v);
    const int deg = heap_i32(p, kAdjOff, v + 1) - off;
    const bool first = chunk == 0;
    const bool improve = d < heap_f32(p, kDist, v);
    const bool live = !first || improve;
    s.write(0, kDist, v, __float_as_uint(d), kMin, first && improve);
    const int base = chunk * kChunk;
    for (int i = 0; i < kChunk; ++i) {
      const int e = base + i;
      const int u = heap_i32(p, kAdj, off + e);
      const float nd = __fadd_rn(d, heap_f32(p, kWgt, off + e));
      const bool stale = heap_f32(p, kDist, u) <= nd;
      const int a[2] = {u, 0};
      s.fork(0, a, &nd, live && (e < deg) && !stale);
    }
    const int a[2] = {v, chunk + 1};
    s.fork(0, a, &d, live && (base + kChunk < deg));
  }
};

// nqueens (src/repro_torch/apps/nqueens.py): place(row, cols, d1, d2)
// counts a full board (row == n) with an int add into count[0], else forks
// one child per column c that no queen attacks, at n static sites.  n is
// consts[0] (make_program's closure), at most 16, so every shift amount of
// a row in [0, n] is below 32.
struct NQueensApp : AppDefaults {
  static constexpr int kTypes = 1, kArgI = 4, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 1, kHeap = 1;
  static constexpr int kMaxN = 16;
  enum { kCount = 0 };

  static bool consts_ok(const long long* ints) {
    return ints[I_CONST0] >= 1 && ints[I_CONST0] <= kMaxN;
  }

  template <class S>
  __device__ static void task(int, const TaskIn<NQueensApp>& in,
                              const Params& p, S& s) {
    const int n = p.consts[0];
    const int row = in.argi[0], cols = in.argi[1], d1 = in.argi[2],
              d2 = in.argi[3];
    const bool done = row == n;
    s.write(0, kCount, 0, 1u, kAdd, done);
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const int s1 = wadd(row, c), s2 = wadd(wadd(row, -c), n - 1);
      const bool attacked =
          ((sar(cols, c) | sar(d1, s1) | sar(d2, s2)) & 1) == 1;
      const int a[4] = {wadd(row, 1), cols | shl(1, c), d1 | shl(1, s1),
                        d2 | shl(1, s2)};
      s.fork(0, a, nullptr, !done && !attacked);
    }
  }
};

// tsp (src/repro_torch/apps/tsp.py): extend(cur, visited, cost) closes a
// full tour with an int min-write of its cost on best[0], else forks one
// child per unvisited city c whose cost stays below best[0] as it stood
// before the epoch (passes A and B read the same bound), at n - 1 static
// sites.  n is consts[0] = sqrt(len(dist)), at most 31, so (1 << n) - 1
// fits in int32.
struct TspApp : AppDefaults {
  static constexpr int kTypes = 1, kArgI = 3, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 1, kHeap = 2;
  static constexpr int kMaxN = 31;
  enum { kDist = 0, kBest = 1 };

  static bool consts_ok(const long long* ints) {
    const long long n = ints[I_CONST0];
    return n >= 1 && n <= kMaxN && ints[I_HEAP_LEN0 + kDist] == n * n;
  }

  template <class S>
  __device__ static void task(int, const TaskIn<TspApp>& in, const Params& p,
                              S& s) {
    const int n = p.consts[0];
    const int cur = in.argi[0], visited = in.argi[1], cost = in.argi[2];
    const bool all_visited = visited == (int)((1u << n) - 1u);
    const int back = heap_i32(p, kDist, wmul(cur, n));
    s.write(0, kBest, 0, (uint32_t)wadd(cost, back), kMin, all_visited);
    const int bound = heap_i32(p, kBest, 0);
#pragma unroll 1
    for (int c = 1; c < n; ++c) {
      const bool seen = (sar(visited, c) & 1) == 1;
      const int nc = wadd(cost, heap_i32(p, kDist, wadd(wmul(cur, n), c)));
      const int a[3] = {c, visited | shl(1, c), nc};
      s.fork(0, a, nullptr, !all_visited && !seen && nc < bound);
    }
  }
};

// int32 - that wraps, as torch's does
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

// annealing (src/repro_torch/apps/annealing.py): seed forks
// step(((cid * 26543 + 7) % 65536, 0, cid)) at n_chains static sites, in
// site order; step(state, t, cid) hashes its proposal h, flips bit
// h % n_bits of state, accepts by the integer Metropolis rule (dE < 0, or a
// draw of (h >> 7) % 16 below the temperature), min-writes the kept energy
// on best[0] and forks its successor while t + 1 < n_steps.  The energy
// sums Q[i * n_bits + j] b_i b_j over i <= j in int32, which wraps and is
// exact in any order: so the sum runs over the set bits' pairs only, and
// the candidate's energy is the state's plus or minus the flipped bit's
// row (its diagonal and its pairs with the other set bits).  n_bits,
// n_steps and n_chains are consts[0..2] (the closures'), 1 <= n_bits <= 16.
struct AnnealingApp : AppDefaults {
  static constexpr int kTypes = 2, kArgI = 3, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 1, kHeap = 2;
  static constexpr int kMaxBits = 16;
  enum { kQ = 0, kBest = 1 };

  static bool consts_ok(const long long* ints) {
    const long long nb = ints[I_CONST0], ns = ints[I_CONST0 + 1],
                    nc = ints[I_CONST0 + 2];
    return nb >= 1 && nb <= kMaxBits && ns >= 1 && nc >= 0 &&
           ints[I_HEAP_LEN0 + kQ] == nb * nb;
  }

  // sum of Q[i * nb + j] over the set bits i <= j of `bits`
  __device__ static int energy(unsigned bits, int nb, const Params& p) {
    int e = 0;
#pragma unroll 1
    for (unsigned a = bits; a; a &= a - 1) {
      const int i = __ffs(a) - 1;
#pragma unroll 1
      for (unsigned c = a; c; c &= c - 1) {
        e = wadd(e, heap_i32(p, kQ, i * nb + __ffs(c) - 1));
      }
    }
    return e;
  }

  // Q's terms with bit f: the diagonal and f's pairs with `bits` (f clear)
  __device__ static int row(unsigned bits, int f, int nb, const Params& p) {
    int r = heap_i32(p, kQ, f * nb + f);
#pragma unroll 1
    for (unsigned c = bits; c; c &= c - 1) {
      const int j = __ffs(c) - 1;
      r = wadd(r, heap_i32(p, kQ, j < f ? j * nb + f : f * nb + j));
    }
    return r;
  }

  template <class S>
  __device__ static void task(int type, const TaskIn<AnnealingApp>& in,
                              const Params& p, S& s) {
    const int nb = p.consts[0], ns = p.consts[1], nc = p.consts[2];
    if (type == 0) {
#pragma unroll 1
      for (int cid = 0; cid < nc; ++cid) {
        const int a[3] = {(int)(((long long)cid * 26543 + 7) % 65536), 0,
                          cid};
        s.fork(1, a, nullptr, true);
      }
      return;
    }
    const int state = in.argi[0], t = in.argi[1], cid = in.argi[2];
    const int h = wadd(wadd(wadd(wmul(state, 31421), wmul(t, 6927)),
                            wmul(cid, 97)), 13) & 0x7FFF;
    const int flip = floormod(h, nb);
    const int cand = state ^ shl(1, flip);
    const unsigned bits = (unsigned)state & ((1u << nb) - 1u);
    const unsigned fbit = 1u << flip;
    const int e_cur = energy(bits, nb, p);
    const int d_row = row(bits & ~fbit, flip, nb, p);
    const int e_new = (bits & fbit) ? wsub(e_cur, d_row) : wadd(e_cur, d_row);
    const int temp = max(wadd(floordiv(wmul(wsub(ns, t), 4), ns), 1), 1);
    const int draw = floormod(sar(h, 7), 16);
    const bool accept = wsub(e_new, e_cur) < 0 || draw < temp;
    s.write(0, kBest, 0, (uint32_t)(accept ? e_new : e_cur), kMin, true);
    const int a[3] = {accept ? cand : state, wadd(t, 1), cid};
    s.fork(1, a, nullptr, wadd(t, 1) < ns);
  }
};

// fft (src/repro_torch/apps/fft.py), radix-2 decimation in time over heap
// xr, xi (n floats) and the double-buffered levels re, im (2n floats):
// fft(base, stride, lo, span, depth) copies input element `base` into its
// level's buffer at a leaf (span 1), else forks the even and odd halves and
// joins combine(lo, span, depth), which schedules the map `butterfly` over
// span / 2 elements.  Element k reads the pair (lo + k, lo + span/2 + k) of
// level depth + 1 and writes both results to level depth.  Every float
// operation rounds as torch's eager operations do: the angle is a float32
// product by float32(-2 pi), then a division; tr and ti are two rounded
// products, then a rounded sum.
struct FftApp : AppDefaults {
  static constexpr int kTypes = 2, kArgI = 5, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 2, kHeap = 4;
  static constexpr int kMapLaunches = 1, kMapWrites = 4;
  enum { kXr = 0, kXi = 1, kRe = 2, kIm = 3 };

  __device__ static int buf(const Params& p, int depth) {
    return floormod(depth, 2) * p.heap_len[kXr];
  }

  template <class S>
  __device__ static void task(int type, const TaskIn<FftApp>& in,
                              const Params& p, S& s) {
    if (type == 1) {  // combine
      const int m[5] = {in.argi[0], in.argi[1], in.argi[2], 0, 0};
      s.map(0, m, nullptr, true);
      return;
    }
    const int base = in.argi[0], stride = in.argi[1], lo = in.argi[2],
              span = in.argi[3], depth = in.argi[4];
    const bool leaf = span == 1;
    const int at = wadd(buf(p, depth), lo);
    s.write(0, kRe, at, __float_as_uint(heap_f32(p, kXr, base)), kSet, leaf);
    s.write(1, kIm, at, __float_as_uint(heap_f32(p, kXi, base)), kSet, leaf);
    const int half = floordiv(span, 2);
    const int a0[5] = {base, wmul(2, stride), lo, half, wadd(depth, 1)};
    s.fork(0, a0, nullptr, !leaf);
    const int a1[5] = {wadd(base, stride), wmul(2, stride), wadd(lo, half),
                       half, wadd(depth, 1)};
    s.fork(0, a1, nullptr, !leaf);
    const int j[5] = {lo, span, depth, 0, 0};
    s.join(1, j, nullptr, !leaf);
  }

  __device__ static int map_id(int) { return 0; }
  __device__ static int map_domain(int, const int* ai, const Params&) {
    return floordiv(ai[1], 2);
  }

  template <class S>
  __device__ static void map_payload(int, const int* ai, const float*, int k,
                                     const Params& p, S& s) {
    const int lo = ai[0], span = ai[1], depth = ai[2];
    const int half = floordiv(span, 2);
    const int r0 = buf(p, depth + 1) + lo + k, w0 = buf(p, depth) + lo + k;
    const float er = heap_f32(p, kRe, r0), ei = heap_f32(p, kIm, r0);
    const float orr = heap_f32(p, kRe, r0 + half);
    const float oi = heap_f32(p, kIm, r0 + half);
    const float ang = __fdiv_rn(__fmul_rn(-6.2831855f, (float)k), (float)span);
    const float wr = cosf(ang), wi = sinf(ang);
    const float tr = __fsub_rn(__fmul_rn(wr, orr), __fmul_rn(wi, oi));
    const float ti = __fadd_rn(__fmul_rn(wr, oi), __fmul_rn(wi, orr));
    s.write(0, kRe, w0, __float_as_uint(__fadd_rn(er, tr)), kSet, true);
    s.write(1, kIm, w0, __float_as_uint(__fadd_rn(ei, ti)), kSet, true);
    s.write(2, kRe, w0 + half, __float_as_uint(__fsub_rn(er, tr)), kSet, true);
    s.write(3, kIm, w0 + half, __float_as_uint(__fsub_rn(ei, ti)), kSet, true);
  }
};

// matmul (src/repro_torch/apps/matmul.py): mm(i0, j0, k0, size) forks its
// eight octants at 8 static sites in (di, dj, dk) order until size ==
// block, where it schedules the map block_mm over block^2 elements.
// Element (r, c) computes its block product's cell as apps/matmul.py::_fma
// chains it (a float64 product, exact, then a float64 add rounded to
// float32; the first term's c is the float32 product a1 * b1) and adds it
// to C[(i0 + r) n + j0 + c] with a float add, which the ordered add applies
// in stage order: each C cell takes n / block terms in one payload.  n and
// block are consts[0..1] (the closures').
struct MatmulApp : AppDefaults {
  static constexpr int kTypes = 1, kArgI = 4, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 0, kHeap = 3;
  static constexpr int kMapLaunches = 1, kMapWrites = 1;
  enum { kA = 0, kB = 1, kC = 2 };
  static constexpr bool kOrderedMapAdd = true;
  static constexpr int kOrderedVar = kC;

  static bool consts_ok(const long long* ints) {
    const long long n = ints[I_CONST0], block = ints[I_CONST0 + 1];
    return block >= 2 && n >= block && n % block == 0 &&
           ints[I_HEAP_LEN0 + kA] == n * n &&
           ints[I_HEAP_LEN0 + kB] == n * n && ints[I_HEAP_LEN0 + kC] == n * n;
  }

  __device__ static float fma_like(float a, float b, float c) {
    return __double2float_rn(
        __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
  }

  template <class S>
  __device__ static void task(int, const TaskIn<MatmulApp>& in,
                              const Params& p, S& s) {
    const int block = p.consts[1];
    const int i0 = in.argi[0], j0 = in.argi[1], k0 = in.argi[2],
              size = in.argi[3];
    const bool leaf = size == block;
    const int m[4] = {i0, j0, k0, 0};
    s.map(0, m, nullptr, leaf);
    const int h = floordiv(size, 2);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int di = q >> 2, dj = (q >> 1) & 1, dk = q & 1;
      const int a[4] = {wadd(i0, wmul(di, h)), wadd(j0, wmul(dj, h)),
                        wadd(k0, wmul(dk, h)), h};
      s.fork(0, a, nullptr, !leaf);
    }
  }

  __device__ static int map_id(int) { return 0; }
  __device__ static int map_domain(int, const int*, const Params& p) {
    return p.consts[1] * p.consts[1];
  }

  template <class S>
  __device__ static void map_payload(int, const int* ai, const float*, int e,
                                     const Params& p, S& s) {
    const int n = p.consts[0], block = p.consts[1];
    const int i0 = ai[0], j0 = ai[1], k0 = ai[2];
    const int r = floordiv(e, block), c = floormod(e, block);
    const int arow = (i0 + r) * n + k0, bcol = k0 * n + j0 + c;
    float acc = fma_like(heap_f32(p, kA, arow), heap_f32(p, kB, bcol),
                         __fmul_rn(heap_f32(p, kA, arow + 1),
                                   heap_f32(p, kB, bcol + n)));
#pragma unroll 1
    for (int kk = 2; kk < block; ++kk) {
      acc = fma_like(heap_f32(p, kA, arow + kk),
                     heap_f32(p, kB, bcol + kk * n), acc);
    }
    s.write(0, kC, (i0 + r) * n + j0 + c, __float_as_uint(acc), kAdd, true);
  }
};

// ---- the grid and its barriers ---------------------------------------------
// The cooperative scratch (caller memory, cleared on the stream before each
// launch), in uint64 words:
//   [0]                 two uint32 barrier counters: the grid's, the group's
//   [1, 21)             Ctl ctl[2]: the popped range and the pending map
//                       launches, by epoch parity
//   [21, 23)            int last[2][2]: reclamation's last valid slot, by
//                       epoch parity and round parity
//   [23, 23 + 10 G)     CtaRec cta[G]: each CTA's totals of one epoch
struct Ctl {
  int go, live, cen, start, count, nf;
  unsigned gen1;  // the group counter's value when the epoch starts
  // the previous epoch's map launches, run at this epoch's start: a bit
  // per launch that fired, that epoch's lanes and group, the elements
  int fired, map_nl, map_ge;
  // 1 + the slot where the previous epoch's reclamation search goes on
  // over the whole grid (0: it ended)
  int search;
  // nonzero once a float add met no ordered path in this epoch (its map
  // payloads or its pass C): the chunk ends with kFaultFloatAdd
  int fault;
  unsigned long long map_el[kMaxMaps];
};
struct CtaRec {
  unsigned tot;  // fork count of the CTA's lanes
  int act;       // active lanes
  int join;      // some lane joined
  int pad;
  unsigned long long el[kMaxMaps];  // live map elements, per map launch
  int rows[kMaxMaps];               // lanes that scheduled the launch
  int dmax[kMaxMaps];               // their largest domain
};
static_assert(sizeof(Ctl) == 80 && sizeof(CtaRec) == 80, "scratch layout");
constexpr int kCoopHeader = 1 + 2 * (int)sizeof(Ctl) / 8 + 2;
constexpr int kCtaWords = (int)sizeof(CtaRec) / 8;
constexpr int kMaxGrid = 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* a) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(a)
               : "memory");
  return v;
}

// Barrier over `n` co-resident CTAs on the counter *bar, which only grows:
// `target` (thread 0's copy) is the count at which all n have arrived.
// Release before the arrival, acquire after the wait, as
// cooperative_groups' grid sync does, so every write made before the
// barrier by any of the n CTAs is seen after it.  The comparison is
// wrap-safe: the counter never runs more than n ahead of a waiter.  A wait
// of about 2^35 cycles (seconds) means a CTA will never arrive: the kernel
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void bar_sync(unsigned* bar, unsigned& target,
                                         unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += n;
    __threadfence();
    atomicAdd(bar, 1u);
    const long long t0 = clock64();
    while ((int)(ld_acquire(bar) - target) < 0) {
      if (clock64() - t0 > (1ll << 35)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The largest v of the block, to every thread.  Every thread must call it.
__device__ __forceinline__ int block_max(int v, int* s_warp) {
  v = __reduce_max_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  v = __reduce_max_sync(kFull, s_warp[threadIdx.x & 31]);  // kWarps == 32
  __syncthreads();  // s_warp is reused by the next call
  return v;
}

// The carry's scalars, held by CTA 0 in shared memory for the whole chunk
// (only its thread 0 pops, pushes and counts) and written back at the end:
// a read-modify-write of each in device memory, every epoch, would put a
// dozen dependent round trips to L2 on the chunk's serial path.
struct Scalars {
  long long job_tasks, job_forks, map_elements, map_lanes, hole_lanes;
  int sp, next_free, n_epochs, job_epochs, job_peak, map_launches, fault;
  int limit;
  bool failed, failed_stack;

  __device__ void load(const Params& p) {
    job_tasks = p.job_tasks[0]; job_forks = p.job_forks[0];
    map_elements = p.map_elements[0]; map_lanes = p.map_lanes[0];
    hole_lanes = p.hole_lanes[0];
    sp = p.sp[0]; next_free = p.next_free[0]; n_epochs = p.n_epochs[0];
    job_epochs = p.job_epochs[0]; job_peak = p.job_peak[0];
    map_launches = p.map_launches[0]; fault = p.fault[0];
    limit = p.limit[0];
    failed = p.failed[0]; failed_stack = p.failed_stack[0];
  }
  __device__ void store(const Params& p) const {
    p.job_tasks[0] = job_tasks; p.job_forks[0] = job_forks;
    p.map_elements[0] = map_elements; p.map_lanes[0] = map_lanes;
    p.hole_lanes[0] = hole_lanes;
    p.sp[0] = sp; p.next_free[0] = next_free; p.n_epochs[0] = n_epochs;
    p.job_epochs[0] = job_epochs; p.job_peak[0] = job_peak;
    p.map_launches[0] = map_launches; p.fault[0] = fault;
    p.failed[0] = failed; p.failed_stack[0] = failed_stack;
  }
};

// Pop the next epoch's range (solo: one region) into ctl[e & 1] and reset
// its reclamation words.  One thread (CTA 0's thread 0).
__device__ __forceinline__ void pop(const Params& p, const Scalars& car,
                                    Ctl* ctl, int* last, int e,
                                    unsigned gen1) {
  Ctl& c = ctl[e & 1];
  const int sp = car.sp;
  const bool live = sp > 0;
  const int top = clampi(sp - 1, 0, p.depth - 1);
  c.go = live && (car.n_epochs < car.limit);
  c.live = live;
  c.cen = live ? p.jstack[top] : 0;
  c.start = live ? p.rstack[2 * top] : 0;
  c.count = live ? p.rstack[2 * top + 1] : 0;
  c.nf = car.next_free;
  c.gen1 = gen1;
  c.fault = 0;
  last[2 * (e & 1)] = -1;
  last[2 * (e & 1) + 1] = -1;
}

// ordered_add.cuh's view of one map write site's stage: the term at
// stage position f and the cells of heap variable kOrderedVar
struct StageTerms {
  const uint32_t* val;
  float* arr;
  __device__ int width() const { return 1; }
  __device__ float term(int f, int) const { return __uint_as_float(val[f]); }
  __device__ float* dst(int cell, int) const { return arr + cell; }
};

// One map write site's float adds into heap variable App::kOrderedVar,
// applied in stage order by every CTA of the grid (ordered_add.cuh's
// phases, four grid barriers); the site's other writes are applied
// directly.  Returns the barriers crossed; the caller's next barrier ends
// the sum phase.
template <class App>
__device__ int ordered_site(const Params& p, int k, long long el,
                            unsigned* bar, unsigned& gen0, int* fault,
                            int* s_sort, unsigned* s_warp32,
                            unsigned* s_obase) {
  const int tid = threadIdx.x, b = blockIdx.x;
  const unsigned G = gridDim.x;
  const long long gstride = (long long)G * kThreads;
  const int cells = p.heap_len[App::kOrderedVar];
  const int ometa = (App::kOrderedVar << 2) | kAdd;
  int* const n_long = p.oa_cnt + 2LL * cells;  // then its copy
  oadd::Scratch os;
  os.cnt = p.oa_cnt;
  os.cur = p.oa_cnt + cells;
  os.off = p.oa_off;
  os.run = p.oa_run;
  os.run2 = p.oa_run + p.stage_cap;
  os.n_long = n_long;
  os.long_cells = p.oa_long;
  const long long at0 = (long long)k * p.stage_cap;
  // count the site's ordered terms; apply its other writes
  for (long long f = (long long)b * kThreads + tid; f < el; f += gstride) {
    const int meta = p.st_meta[at0 + f];
    if (meta == ometa) {
      oadd::count(os, p.st_idx[at0 + f]);
    } else if (meta >= 0 &&
               !heap_apply(p, meta, p.st_idx[at0 + f], p.st_val[at0 + f])) {
      atomicOr(fault, 1);
    }
  }
  bar_sync(bar, gen0, G);
  // the counts' exclusive scan: CTA b's contiguous block of cells, its
  // total, then its base from the earlier CTAs' totals
  const int per = (int)((cells + (long long)G - 1) / G);
  const int c_lo = min(cells, b * per), c_hi = min(cells, c_lo + per);
  unsigned sum = 0;
  for (int c = c_lo + tid; c < c_hi; c += kThreads) sum += (unsigned)p.oa_cnt[c];
  sum = __reduce_add_sync(kFull, sum);
  if ((tid & 31) == 0) atomicAdd(s_obase, sum);  // s_obase is zero here
  __syncthreads();
  if (tid == 0) {
    p.oa_tot[b] = (int)*s_obase;
    if (b == 0) {  // the long cells are all listed: keep their count
      n_long[1] = __ldcg(n_long);
      *n_long = 0;
    }
  }
  bar_sync(bar, gen0, G);
  if (tid < 32) {
    unsigned before = 0;
    for (int q0 = 0; q0 < b; q0 += 32) {
      const int q = q0 + tid;
      before += __reduce_add_sync(kFull, q < b ? (unsigned)__ldcg(&p.oa_tot[q]) : 0u);
    }
    if (tid == 0) *s_obase = before;
  }
  __syncthreads();
  unsigned run = *s_obase;
  for (int c0 = c_lo; c0 < c_hi; c0 += kThreads) {
    const int c = c0 + tid;
    const unsigned v = c < c_hi ? (unsigned)p.oa_cnt[c] : 0u;
    unsigned tot;
    const unsigned ex = block_excl_scan<unsigned>(v, s_warp32, &tot);
    if (c < c_hi) p.oa_off[c] = (int)(run + ex);
    run += tot;
  }
  bar_sync(bar, gen0, G);
  if (tid == 0) *s_obase = 0;  // for the next site (read before the barrier)
  // place each term's stage position in its cell's run
  for (long long f = (long long)b * kThreads + tid; f < el; f += gstride) {
    if (p.st_meta[at0 + f] == ometa) oadd::place(os, p.st_idx[at0 + f], (int)f);
  }
  bar_sync(bar, gen0, G);
  // sum: a short run a thread, a long run a CTA
  const StageTerms terms{p.st_val + at0,
                         reinterpret_cast<float*>(p.heap[App::kOrderedVar])};
  for (long long c = (long long)b * kThreads + tid; c < cells; c += gstride) {
    const int n = p.oa_cnt[c];
    if (n > 0 && n <= oadd::kShortRun) oadd::sum_short(os, (int)c, n, terms);
  }
  const int nl = __ldcg(n_long + 1);
  for (int i = b; i < nl; i += (int)G) {
    const int c = __ldcg(&p.oa_long[i]);
    oadd::sum_long(os, c, __ldcg(&p.oa_cnt[c]), terms, s_sort);
  }
  return 4;
}

// ---- the chunk ---------------------------------------------------------------
// Every CTA runs the epoch loop; CTA 0's thread 0 pops and pushes.  Each
// epoch starts at a barrier of the whole grid, after which every CTA reads
// the popped range and computes the same group: the first ge = min(G,
// ceil(lanes / kThreads)) CTAs, each owning a contiguous block of the
// range's lanes.  The others go straight to the next epoch's barrier.  The
// group's phase boundaries are barriers of the group (a __syncthreads when
// ge == 1: a narrow epoch runs on CTA 0 alone, as one CTA ran every epoch
// before).
template <class App>
__global__ void __launch_bounds__(kThreads, 1) epoch_chunk_kernel(const Params p) {
  __shared__ unsigned s_warp32[kWarps];
  __shared__ unsigned long long s_warp64[kWarps];
  __shared__ int s_wmax[kWarps];
  __shared__ unsigned long long s_elbase[kMaxGrid];  // each CTA's first element
  __shared__ unsigned s_base, s_total;
  __shared__ int s_nact, s_join, s_last[2];  // s_last: by round parity
  __shared__ unsigned long long s_mel[kMaxMaps];  // CTA 0: map launch totals
  __shared__ int s_mrows[kMaxMaps], s_mdmax[kMaxMaps];
  __shared__ Scalars car;  // CTA 0's
  __shared__ unsigned s_obase;  // the ordered add's scan base
  __shared__ int s_sort[App::kOrderedMapAdd ? oadd::kSortTile : 1];

  const int C = p.capacity;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const unsigned G = gridDim.x;
  unsigned* const bar = reinterpret_cast<unsigned*>(p.coop);
  Ctl* const ctl = reinterpret_cast<Ctl*>(p.coop + 1);
  int* const last = reinterpret_cast<int*>(p.coop + 1 + 2 * sizeof(Ctl) / 8);
  CtaRec* const cta = reinterpret_cast<CtaRec*>(p.coop + kCoopHeader);
  unsigned gen0 = 0, gen1 = 0;  // barrier targets (thread 0's are used)
  long long n_narrow = 0, n_wide = 0, n_grid = 0, n_group = 0, n_search = 0;
  long long n_ordered = 0;
  if (tid == 0) s_obase = 0;

  if (b == 0 && tid == 0) {
    // the sink rows stay zero (the plain loop zeroes them after each
    // epoch); written once, before the first barrier
    p.task[C] = 0;
    p.epoch[C] = 0;
    p.child_base[C] = 0;
    p.child_count[C] = 0;
    for (int k = 0; k < App::kArgI; ++k) p.argi[C * App::kArgI + k] = 0;
    for (int k = 0; k < App::kArgF; ++k) p.argf[C * App::kArgF + k] = 0.f;
    for (int w = 0; w < App::kValW; ++w) p.value[C * App::kValW + w] = 0u;
    for (int v = 0; v < p.n_heap; ++v) p.heap[v][p.heap_len[v]] = 0u;
    car.load(p);
    pop(p, car, ctl, last, 0, 0u);
  }

  for (int e = 0;; ++e) {
    bar_sync(bar, gen0, G);  // ctl[e & 1] is written
    ++n_grid;
    const Ctl* const cc = ctl + (e & 1);

    // ---- the previous epoch's reclamation search, where its first window
    // found no valid slot and it forked nothing: the rest of the TV below,
    // over the whole grid, then next_free (the ranges' pass B needs it)
    int nf_cap = 0x7fffffff;
    const int search = __ldcg(&cc->search);
    if (search > 0) {
      const long long top = search - 1;
      int* const words = last + 2 * ((e - 1) & 1);
      int lv;
      for (int q = 0;; ++q) {
        int* const word = words + ((q + 1) & 1);  // round 0 used words[0]
        const long long s = top - ((long long)q * G + b) * kThreads - tid;
        const bool valid = s >= 0 && p.epoch[s] > 0;
        const int m = __reduce_max_sync(kFull, valid ? (int)s : -1);
        if ((tid & 31) == 0 && m >= 0) atomicMax(word, m);
        bar_sync(bar, gen0, G);
        ++n_grid;
        ++n_search;
        lv = __ldcg(word);
        if (lv >= 0 || top - (long long)(q + 1) * G * kThreads < 0) break;
      }
      nf_cap = lv + 1;
      if (b == 0 && tid == 0) {
        car.next_free = min(car.next_free, nf_cap);
        car.job_peak = max(car.job_peak, car.next_free);
      }
    }

    // ---- the previous epoch's map payloads (after its commit and push),
    // one launch per (type, site), their elements spread over the grid
    // whatever that epoch's lanes: stage every element against the
    // pre-payload heap -> grid barrier -> apply -> grid barrier
    const int fired = App::kMapLaunches > 0 ? __ldcg(&cc->fired) : 0;
    if (fired) {
      const int mnl = __ldcg(&cc->map_nl), mge = __ldcg(&cc->map_ge);
      const int mper = (mnl + mge - 1) / mge;
      for (int g = 0; g < App::kMapLaunches; ++g) {
        if (!(fired & (1 << g))) continue;
        const int mid = App::map_id(g);
        const unsigned long long el = __ldcg(&cc->map_el[g]);
        const int gm = (int)min((unsigned long long)G,
                                (el + kThreads - 1) / kThreads);
        const long long stride = (long long)gm * kThreads;
        if (b < gm) {
          if (tid < 32) {  // the first element of each CTA's lanes
            unsigned long long run = 0;
            for (int q0 = 0; q0 < mge; q0 += 32) {
              const int q = q0 + tid;
              const unsigned long long x =
                  q < mge ? __ldcg(&cta[q].el[g]) : 0ull;
              unsigned long long incl = x;
#pragma unroll
              for (int d = 1; d < 32; d <<= 1) {
                const unsigned long long y = __shfl_up_sync(kFull, incl, d);
                if (tid >= d) incl += y;
              }
              if (q < mge) s_elbase[q] = run + incl - x;
              run += __shfl_sync(kFull, incl, 31);
            }
          }
          __syncthreads();
          // element f: the CTA whose elements hold it, then that CTA's
          // last lane with map_pre <= f
          const long long* pre = p.map_pre + (long long)g * C;
          for (long long f = (long long)b * kThreads + tid;
               f < (long long)el; f += stride) {
            int c0 = 0, c1 = mge - 1;
            while (c0 < c1) {
              const int m = (c0 + c1 + 1) >> 1;
              if (s_elbase[m] <= (unsigned long long)f) c0 = m; else c1 = m - 1;
            }
            const long long fl = f - (long long)s_elbase[c0];
            int a = min(mnl, c0 * mper), z = min(mnl, a + mper) - 1;
            while (a < z) {
              const int m = (a + z + 1) >> 1;
              if (pre[m] <= fl) a = m; else z = m - 1;
            }
            const long long row = (long long)g * C + a;
            StageSink<App> ss{p, f};
            App::map_payload(
                mid, p.map_argi + row * App::kArgI,
                p.map_argf + row * (App::kArgF > 0 ? App::kArgF : 1),
                (int)(fl - pre[a]), p, ss);
          }
        }
        bar_sync(bar, gen0, G);  // every element is staged
        ++n_grid;
        int* const mfault = const_cast<int*>(&cc->fault);
        if constexpr (App::kOrderedMapAdd) {
          // site by site, each site's writes after the last's
          for (int k = 0; k < App::kMapWrites; ++k) {
            const int nb = ordered_site<App>(p, k, (long long)el, bar, gen0,
                                             mfault, s_sort, s_warp32,
                                             &s_obase);
            n_grid += nb;
            n_ordered += nb;
            if (k + 1 < App::kMapWrites) {
              bar_sync(bar, gen0, G);
              ++n_grid;
              ++n_ordered;
            }
          }
        } else if (b < gm) {
          for (long long f = (long long)b * kThreads + tid;
               f < (long long)el; f += stride) {
            for (int k = 0; k < App::kMapWrites; ++k) {
              const long long at = (long long)k * p.stage_cap + f;
              const int meta = p.st_meta[at];
              if (meta >= 0 &&
                  !heap_apply(p, meta, p.st_idx[at], p.st_val[at])) {
                atomicOr(mfault, 1);
              }
            }
          }
        }
        bar_sync(bar, gen0, G);  // the heap is written
        ++n_grid;
      }
      if (__ldcg(&cc->fault)) {  // every CTA reads it after the barrier
        if (b == 0 && tid == 0) car.fault = kFaultFloatAdd;
        break;
      }
    }
    if (!__ldcg(&cc->go)) break;
    const int live = __ldcg(&cc->live), cen = __ldcg(&cc->cen);
    const int start = __ldcg(&cc->start), count = __ldcg(&cc->count);
    const int nf = min(__ldcg(&cc->nf), nf_cap);
    // lanes of the popped range (the step's window never exceeds the TV)
    const int nl = clampi(count, 0, C);
    const int ge = (int)min((unsigned)max(1, (nl + kThreads - 1) / kThreads), G);
    if (b >= ge) continue;
    gen1 = __ldcg(&cc->gen1);
    auto group_sync = [&]() {
      if (ge == 1) {
        __syncthreads();
      } else {
        bar_sync(bar + 1, gen1, (unsigned)ge);
        ++n_group;
      }
    };
    if (ge == 1) ++n_narrow; else ++n_wide;
    const int per = (nl + ge - 1) / ge;
    const int lo = min(nl, b * per), hi = min(nl, lo + per);

    // ---- pass A: frontier, fork counts, their scan in lane order within
    // this CTA's block
    unsigned run = 0;
    int act_n = 0;
    for (int b0 = lo; b0 < hi; b0 += kThreads) {
      const int l = b0 + tid;
      unsigned cnt = 0;
      int act = 0;
      if (l < hi) {
        const int slot = start + l;
        const bool in_tv = p.gather ? (slot >= 0 && slot < C) : true;
        const int cidx = clampi(slot, 0, C - 1);
        int flags = 0;
        if (in_tv && cen > 0 && p.epoch[cidx] == cen) {
          act = 1;
          const int t = p.task[cidx];
          const bool known = t >= 0 && t < App::kTypes;
          flags = kActive | ((known ? t + 1 : 0) << kTypeShift);
          if (known) {
            TaskIn<App> in;
            in.load(p, cidx);
            CountSink cs;
            App::task(t, in, p, cs);
            cnt = (unsigned)cs.n;
          }
        }
        p.lane_flags[l] = flags;
        p.lane_cnt[l] = (int)cnt;
      }
      unsigned tot;
      const unsigned ex = block_excl_scan<unsigned>(cnt, s_warp32, &tot);
      if (l < hi) p.lane_excl[l] = (int)(run + ex);
      run += tot;
      act_n += __syncthreads_count(act);
    }
    if (tid == 0) {
      cta[b].tot = run;
      cta[b].act = act_n;
      s_last[0] = s_last[1] = -1;
    }
    group_sync();

    // ---- this CTA's base (the group's earlier CTAs' forks), the fork
    // total and the active lanes, from the CTA totals (a narrow epoch has
    // them already)
    if (ge == 1) {
      if (tid == 0) {
        s_base = 0;
        s_total = run;
        s_nact = act_n;
      }
    } else if (tid < 32) {
      unsigned before = 0, total = 0;
      int nact = 0;
      for (int q0 = 0; q0 < ge; q0 += 32) {
        const int q = q0 + tid;
        const unsigned t = q < ge ? __ldcg(&cta[q].tot) : 0u;
        before += __reduce_add_sync(kFull, q < b ? t : 0u);
        total += __reduce_add_sync(kFull, t);
        nact += __reduce_add_sync(kFull, q < ge ? __ldcg(&cta[q].act) : 0);
      }
      if (tid == 0) {
        s_base = before;
        s_total = total;
        s_nact = nact;
      }
    }
    __syncthreads();
    const unsigned base = (unsigned)nf + s_base, total = s_total;

    // ---- pass B: children, joins, child pointers, TMS; stage the rest
    int my_join = 0;
    for (int l = lo + tid; l < hi; l += kThreads) {
      const int flags = p.lane_flags[l];
      const int t = (flags >> kTypeShift) - 1;
      if (!(flags & kActive) || t < 0) continue;
      const int cidx = clampi(start + l, 0, C - 1);
      TaskIn<App> in;
      in.load(p, cidx);
      ApplySink<App> as(p, cidx, l, cen, base + (unsigned)p.lane_excl[l]);
      App::task(t, in, p, as);
      p.lane_flags[l] = as.finish(flags, p.lane_cnt[l]);
      my_join |= as.joined;
    }
    const int any_join = __syncthreads_or(my_join);
    if (tid == 0) {
      cta[b].join = any_join;
      s_join = any_join;
    }
    // the map domains of this CTA's lanes, scanned in lane order, one map
    // launch at a time (map_pre is CTA-relative)
    for (int g = 0; g < App::kMapLaunches; ++g) {
      const int mid = App::map_id(g);
      const int maxd = p.max_domain[mid];
      unsigned long long el = 0;
      int n_rows = 0, my_dmax = 0;
      for (int b0 = lo; b0 < hi; b0 += kThreads) {
        const int l = b0 + tid;
        int on = 0;
        unsigned long long dom = 0;
        if (l < hi && (p.lane_flags[l] & (kMapBit << g))) {
          on = 1;
          const long long row = (long long)g * C + l;
          const int d = App::map_domain(mid, p.map_argi + row * App::kArgI, p);
          dom = (unsigned long long)clampi(d, 0, maxd);
          my_dmax = max(my_dmax, (int)dom);
        }
        unsigned long long tot;
        const unsigned long long ex =
            block_excl_scan<unsigned long long>(dom, s_warp64, &tot);
        if (l < hi) p.map_pre[(long long)g * C + l] = (long long)(el + ex);
        el += tot;
        n_rows += __syncthreads_count(on);
      }
      const int dmax = block_max(my_dmax, s_wmax);
      if (tid == 0) {
        cta[b].el[g] = el;
        cta[b].rows[g] = n_rows;
        cta[b].dmax[g] = dmax;
        if (ge == 1) {
          s_mel[g] = el;
          s_mrows[g] = n_rows;
          s_mdmax[g] = dmax;
        }
      }
    }
    group_sync();  // the TV is written; pass B's reads are done

    // ---- pass C: staged emits and heap writes of this CTA's lanes
    for (int l = lo + tid; l < hi; l += kThreads) {
      const int flags = p.lane_flags[l];
      if (!(flags & kActive) || (flags >> kTypeShift) == 0) continue;
      const int cidx = clampi(start + l, 0, C - 1);
      if (flags & kEmitted) {
        for (int w = 0; w < App::kValW; ++w) {
          p.value[cidx * App::kValW + w] =
              p.emit_stage[(long long)l * App::kValW + w];
        }
      }
      for (int k = 0; k < App::kWrites; ++k) {
        const long long at = (long long)k * C + l;
        const int meta = p.wr_meta[at];
        if (meta >= 0 && !heap_apply(p, meta, p.wr_idx[at], p.wr_val[at])) {
          atomicOr(const_cast<int*>(&cc->fault), 1);
        }
      }
    }

    // ---- reclamation (beside pass C: it reads only `epoch`, which pass B
    // wrote): the last valid slot, searched down from nf + forks - 1 in
    // windows of kThreads slots, one per CTA and round
    const int nft = (int)((unsigned)nf + total);  // int32, as the JAX TV
    const int hi_slot = (nft >= 1 && nft <= C) ? nft - 1 : C - 1;
    int lv;
    bool deep = false;  // the search goes on at the next epoch's start
    for (int r = 0;; ++r) {
      int* const word =
          ge == 1 ? s_last + (r & 1) : last + 2 * (e & 1) + (r & 1);
      const long long s =
          (long long)hi_slot - ((long long)r * ge + b) * kThreads - tid;
      const bool valid = s >= 0 && p.epoch[s] > 0;
      const int m = __reduce_max_sync(kFull, valid ? (int)s : -1);
      if ((tid & 31) == 0 && m >= 0) atomicMax(word, m);
      group_sync();
      lv = ge == 1 ? *word : __ldcg(word);
      if (lv >= 0 || (long long)hi_slot - (long long)(r + 1) * ge * kThreads < 0) {
        break;
      }
      // a forking epoch's last child is the last valid slot; a forkless
      // one (bfs's last, with few lanes) may search the whole TV: the grid
      // does that at the next epoch's start
      if (total == 0) {
        deep = true;
        break;
      }
    }
    // with a deep search pending, next_free stays nft = nf until it ends
    // (and job_peak, which new_nf <= nf cannot raise, waits for it)
    const int new_nf = deep ? nft : min(nft, lv + 1);

    // ---- push, counters and the map launches' totals (CTA 0); the
    // payloads run at the next epoch's start, where every CTA takes part
    if (b == 0) {
      if (ge > 1 && tid < 32) {
        int j = 0;
        for (int q = tid; q < ge; q += 32) j |= __ldcg(&cta[q].join);
        j = __reduce_or_sync(kFull, j);
        if (tid == 0) s_join = j;
        for (int g = 0; g < App::kMapLaunches; ++g) {
          unsigned long long el = 0;
          int rows = 0, dmax = 0;
          for (int q0 = 0; q0 < ge; q0 += 32) {
            const int q = q0 + tid;
            unsigned long long x = q < ge ? __ldcg(&cta[q].el[g]) : 0ull;
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
            el += x;
            rows += __reduce_add_sync(kFull, q < ge ? __ldcg(&cta[q].rows[g]) : 0);
            dmax = max(dmax, __reduce_max_sync(
                                 kFull, q < ge ? __ldcg(&cta[q].dmax[g]) : 0));
          }
          if (tid == 0) {
            s_mel[g] = el;
            s_mrows[g] = rows;
            s_mdmax[g] = dmax;
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        car.next_free = new_nf;
        int sp = car.sp - (live ? 1 : 0);
        bool failed = car.failed || (live && nft > C);
        const bool ok = live && !failed;
        const int forks = (int)total;
        bool of = false;
        if (ok && s_join) {  // the join continuation, below
          of |= sp >= p.depth;
          const int ssp = clampi(sp, 0, p.depth - 1);
          p.jstack[ssp] = cen;
          p.rstack[2 * ssp] = start;
          p.rstack[2 * ssp + 1] = count;
          ++sp;
        }
        if (ok && forks > 0) {  // this epoch's forked range, on top
          of |= sp >= p.depth;
          const int ssp = clampi(sp, 0, p.depth - 1);
          p.jstack[ssp] = cen + 1;
          p.rstack[2 * ssp] = new_nf - forks;
          p.rstack[2 * ssp + 1] = forks;
          ++sp;
        }
        failed = failed || of;
        car.failed_stack = car.failed_stack || of;
        car.failed = failed;
        car.sp = failed ? 0 : sp;
        if (!deep) car.job_peak = max(car.job_peak, new_nf);
        const long long key = p.gather ? s_nact : (live ? count : 0);
        car.hole_lanes += C - rung(p.span_w, p.n_span, key);
        car.n_epochs += 1;
        car.job_epochs += live ? 1 : 0;
        car.job_tasks += s_nact;
        car.job_forks += forks;
        // a launch fires when some scheduled lane has a domain; a stage
        // too small for its elements is a fault and ends the chunk before
        // this or any later launch runs
        Ctl& nx = ctl[(e + 1) & 1];
        int fire = 0;
        bool fault = false;
        for (int g = 0; g < App::kMapLaunches && !fault; ++g) {
          const int mid = App::map_id(g);
          car.map_elements += (long long)s_mel[g];
          if (s_mdmax[g] > 0) {
            car.map_launches += 1;
            car.map_lanes += (long long)rung(p.span_w, p.n_span, s_mrows[g]) *
                             rung(p.map_w[mid], p.n_map_w[mid], s_mdmax[g]);
            if ((long long)s_mel[g] > p.stage_cap) {
              car.fault = kFaultStage;
              fault = true;
            } else {
              fire |= 1 << g;
              nx.map_el[g] = s_mel[g];
            }
          }
        }
        if (!fault && __ldcg(&cc->fault)) {  // pass C met a float add
          car.fault = kFaultFloatAdd;
          fault = true;
          fire = 0;
        }
        nx.fired = fire;
        nx.map_nl = nl;
        nx.map_ge = ge;
        nx.search = deep ? hi_slot - ge * kThreads + 1 : 0;
        if (fault) {
          nx.go = 0;
          nx.fault = 0;
        } else {
          pop(p, car, ctl, last, e + 1, gen1);
        }
      }
    }
  }
  if (b == 0 && tid == 0) car.store(p);
  if (b == 0 && tid == 0 && p.stats) {
    p.stats[0] += n_narrow;
    p.stats[1] += n_wide;
    p.stats[2] += n_grid;
    p.stats[3] += n_group;
    p.stats[4] += n_search;
    p.stats[5] += n_ordered;
  }
}

// An empty cooperative kernel that crosses n grid barriers: the barrier's
// own cost, the serial floor of the chunk's design.
__global__ void __launch_bounds__(kThreads, 1) grid_sync_bench(unsigned* bar,
                                                               int n) {
  unsigned target = 0;
  for (int i = 0; i < n; ++i) bar_sync(bar, target, gridDim.x);
}

// CTAs of the cooperative grid of epoch_chunk_kernel<App> on the current
// device: SMs x the CTAs an SM holds, computed once per device; a negative
// CUDA error where the device cannot launch cooperatively.
template <class App>
int grid_size() {
  static int cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0, coop = 0, per = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, epoch_chunk_kernel<App>, kThreads, 0);
  }
  if (e != cudaSuccess) return -(int)e;
  if (!coop || per < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  const int g = min(sms * per, kMaxGrid);
  if (dev < kMaxDevices) cache[dev] = g;
  return g;
}

template <class App>
int launch(const Params& p, long long coop_words, cudaStream_t s) {
  if (p.grid < 1 || p.grid > kMaxGrid ||
      coop_words < kCoopHeader + (long long)kCtaWords * p.grid) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaMemsetAsync(p.coop, 0, 8 * (size_t)coop_words, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {const_cast<Params*>(&p)};
  e = cudaLaunchCooperativeKernel((const void*)epoch_chunk_kernel<App>,
                                  dim3(p.grid), dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class App>
bool shape_ok(const long long* ints) {
  return ints[I_N_ARG_I] == App::kArgI && ints[I_N_ARG_F] == App::kArgF &&
         ints[I_VALUE_WIDTH] == App::kValW && ints[I_N_HEAP] == App::kHeap &&
         App::consts_ok(ints);
}

// f(App{}) for device table `app`, in the order of TABLES in
// epoch_megakernel.py; `unknown` for any other
template <class F>
int with_app(int app, int unknown, F f) {
  switch (app) {
    case 0: return f(FibApp{});
    case 1: return f(BfsApp{});
    case 2: return f(MsortApp{});
    case 3: return f(TreePostApp{});
    case 4: return f(TreePreApp{});
    case 5: return f(SsspApp{});
    case 6: return f(NQueensApp{});
    case 7: return f(TspApp{});
    case 8: return f(NaiveMsortApp{});
    case 9: return f(AnnealingApp{});
    case 10: return f(FftApp{});
    case 11: return f(MatmulApp{});
    default: return unknown;
  }
}

}  // namespace

extern "C" {

int trees_epoch_ptr_count() { return P_COUNT; }
int trees_epoch_int_count() { return I_COUNT; }

// CTAs of the cooperative grid of device table `app` on the current device
// (SMs x the CTAs an SM holds, cached per device); a negative CUDA error
// where the device cannot launch it.
int trees_epoch_grid(int app) {
  return with_app(app, -(int)cudaErrorInvalidValue, [](auto a) {
    return grid_size<decltype(a)>();
  });
}

// uint64 words of cooperative scratch a grid of `grid` CTAs takes.
long long trees_epoch_coop_words(int grid) {
  return kCoopHeader + (long long)kCtaWords * grid;
}

// n grid barriers of `grid` CTAs in one cooperative launch (the barrier's
// cost); scratch: one uint64 word, any contents (cleared here).
int trees_grid_sync_bench(int grid, int n, unsigned long long* scratch,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || grid > kMaxGrid || n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(scratch, 0, 8, s);
  if (e != cudaSuccess) return (int)e;
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  void* args[] = {&bar, &n};
  e = cudaLaunchCooperativeKernel((const void*)grid_sync_bench, dim3(grid),
                                  dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out[0..7] = kTypes, kArgI, kArgF, kValW, kWrites, kMapLaunches,
// kMapWrites and the ordered add's heap variable (kOrderedVar, or -1 without
// kOrderedMapAdd) of device table `app` (TABLES' order in
// epoch_megakernel.py); returns 0, or cudaErrorInvalidValue for an unknown
// app.
int trees_epoch_app_info(int app, int* out) {
  return with_app(app, (int)cudaErrorInvalidValue, [out](auto a) {
    using A = decltype(a);
    const int v[8] = {A::kTypes, A::kArgI, A::kArgF, A::kValW, A::kWrites,
                      A::kMapLaunches, A::kMapWrites,
                      A::kOrderedMapAdd ? A::kOrderedVar : -1};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
  });
}

// One chunk of device table `app` over the carry in `ptrs` (layout: enum
// Ptr) with the sizes in `ints` (enum Int).
int trees_epoch_chunk(int app, const unsigned long long* ptrs, int n_ptrs,
                      const long long* ints, int n_ints, void* stream) {
  if (n_ptrs != P_COUNT || n_ints != I_COUNT) return (int)cudaErrorInvalidValue;
  Params p;
  p.task = (int*)ptrs[P_TASK];
  p.argi = (int*)ptrs[P_ARGI];
  p.argf = (float*)ptrs[P_ARGF];
  p.epoch = (int*)ptrs[P_EPOCH];
  p.value = (uint32_t*)ptrs[P_VALUE];
  p.child_base = (int*)ptrs[P_CHILD_BASE];
  p.child_count = (int*)ptrs[P_CHILD_COUNT];
  p.next_free = (int*)ptrs[P_NEXT_FREE];
  p.jstack = (int*)ptrs[P_JSTACK];
  p.rstack = (int*)ptrs[P_RSTACK];
  p.sp = (int*)ptrs[P_SP];
  p.failed = (uint8_t*)ptrs[P_FAILED];
  p.failed_stack = (uint8_t*)ptrs[P_FAILED_STACK];
  p.n_epochs = (int*)ptrs[P_N_EPOCHS];
  p.job_epochs = (int*)ptrs[P_JOB_EPOCHS];
  p.job_tasks = (long long*)ptrs[P_JOB_TASKS];
  p.job_forks = (long long*)ptrs[P_JOB_FORKS];
  p.job_peak = (int*)ptrs[P_JOB_PEAK];
  p.map_launches = (int*)ptrs[P_MAP_LAUNCHES];
  p.map_elements = (long long*)ptrs[P_MAP_ELEMENTS];
  p.map_lanes = (long long*)ptrs[P_MAP_LANES];
  p.hole_lanes = (long long*)ptrs[P_HOLE_LANES];
  p.fault = (int*)ptrs[P_FAULT];
  p.limit = (const int*)ptrs[P_LIMIT];
  p.lane_cnt = (int*)ptrs[P_LANE_CNT];
  p.lane_excl = (int*)ptrs[P_LANE_EXCL];
  p.lane_flags = (int*)ptrs[P_LANE_FLAGS];
  p.emit_stage = (uint32_t*)ptrs[P_EMIT_STAGE];
  p.wr_idx = (int*)ptrs[P_WR_IDX];
  p.wr_val = (uint32_t*)ptrs[P_WR_VAL];
  p.wr_meta = (int*)ptrs[P_WR_META];
  p.map_argi = (int*)ptrs[P_MAP_ARGI];
  p.map_argf = (float*)ptrs[P_MAP_ARGF];
  p.map_pre = (long long*)ptrs[P_MAP_PRE];
  p.st_idx = (int*)ptrs[P_ST_IDX];
  p.st_val = (uint32_t*)ptrs[P_ST_VAL];
  p.st_meta = (int*)ptrs[P_ST_META];
  p.coop = (unsigned long long*)ptrs[P_COOP];
  p.stats = (long long*)ptrs[P_STATS];
  p.oa_cnt = (int*)ptrs[P_OA_CNT];
  p.oa_off = (int*)ptrs[P_OA_OFF];
  p.oa_long = (int*)ptrs[P_OA_LONG];
  p.oa_run = (int*)ptrs[P_OA_RUN];
  p.oa_tot = (int*)ptrs[P_OA_TOT];
  p.grid = (int)ints[I_GRID];
  for (int v = 0; v < kMaxHeap; ++v) p.heap[v] = (uint32_t*)ptrs[P_HEAP0 + v];
  p.capacity = (int)ints[I_CAPACITY];
  p.depth = (int)ints[I_DEPTH];
  p.gather = (int)ints[I_GATHER];
  p.n_span = (int)ints[I_N_SPAN];
  if (p.capacity < 1 || p.depth < 1 || p.n_span < 1 || p.n_span > kMaxSpan) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < kMaxSpan; ++i) p.span_w[i] = (int)ints[I_SPAN0 + i];
  p.stage_cap = ints[I_STAGE_CAP];
  p.n_heap = (int)ints[I_N_HEAP];
  if (p.n_heap < 0 || p.n_heap > kMaxHeap) return (int)cudaErrorInvalidValue;
  for (int v = 0; v < kMaxHeap; ++v) {
    p.heap_len[v] = (int)ints[I_HEAP_LEN0 + v];
    p.heap_dtype[v] = (int)ints[I_HEAP_DTYPE0 + v];
  }
  p.n_maps = (int)ints[I_N_MAPS];
  if (p.n_maps < 0 || p.n_maps > kMaxMaps) return (int)cudaErrorInvalidValue;
  for (int m = 0; m < kMaxMaps; ++m) {
    const long long* mi = ints + I_MAP0 + m * (2 + kMaxMapW);
    p.max_domain[m] = (int)mi[0];
    p.n_map_w[m] = (int)mi[1];
    if (m < p.n_maps && (p.n_map_w[m] < 1 || p.n_map_w[m] > kMaxMapW)) {
      return (int)cudaErrorInvalidValue;
    }
    for (int i = 0; i < kMaxMapW; ++i) p.map_w[m][i] = (int)mi[2 + i];
  }
  for (int i = 0; i < kMaxConsts; ++i) p.consts[i] = (int)ints[I_CONST0 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_app(app, (int)cudaErrorInvalidValue, [&](auto a) {
    using A = decltype(a);
    if (!shape_ok<A>(ints)) return (int)cudaErrorInvalidValue;
    return launch<A>(p, ints[I_COOP_WORDS], s);
  });
}

}  // extern "C"
