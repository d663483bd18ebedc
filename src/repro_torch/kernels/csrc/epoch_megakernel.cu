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
// MsortApp below), written from src/repro_torch/apps/*.py with the same
// effects.  A task body runs against a "sink": CountSink counts its forks,
// ApplySink commits its effects, StageSink records a map element's writes.
//
// Grid: one CTA of 1024 threads, looping over lanes in strides — the
// Pallas kernel's single program instance (DESIGN.md §12).  Lanes
// interact every epoch through the fork scan and the push, and one block
// makes every phase boundary a __syncthreads().  A cooperative multi-CTA
// grid is later work.
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
//   * Forks past the capacity are dropped (the plain loop's sink row);
//     the overflow fails the region and zeroes its stack pointer.  A push
//     onto a full stack clips to the top row and flags failed_stack.
//   * Reclamation: next_free = min(next_free + forks, last_valid + 1).  No
//     valid slot lies at or above next_free + forks (the allocator hands
//     out slots above every valid one; the CPU tests assert it after every
//     epoch), so the search for last_valid starts there and walks down.
//   * Map payloads run after the push and see the heap after the commit.
//     A launch whose scheduled lanes all have empty domains runs and counts
//     nothing; otherwise its live elements (lane, element < domain) are
//     laid out by an in-order prefix over the lanes' domains, each element
//     is evaluated into a stage (reads see the pre-payload heap) and the
//     stage is applied after a barrier.  map_lanes adds the lane rung x
//     domain rung of the JAX body.
//   * Counters are int64 (the JAX carry's exact hi/lo pairs, decoded).
//
// What bounds it on this card: latency, not bytes or operations.  The
// bytes a chunk must move are about 24-48 bytes per task and per fork
// (RunStats-derived bound in PERF.md: tens of microseconds for the
// full-size runs), but one SM walks every lane of every epoch with a few
// block barriers per 1024 lanes, and each epoch's phases are serial.  The
// design buys one launch per chunk (no host in the loop) at that price.
//
// C interface (bound with ctypes): trees_epoch_chunk launches on the given
// stream, allocates nothing (the caller passes the carry, the scratch and
// the chunk bound as device pointers), does not synchronise, and returns
// cudaGetLastError().  A fault found on the device (a map stage too small)
// is written to the carry's `fault` word and ends the chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSpan = 8;
constexpr int kMaxMaps = 4;
constexpr int kMaxMapW = 40;
constexpr int kMaxHeap = 8;

enum Op { kSet = 0, kAdd = 1, kMin = 2, kMax = 3 };
enum Dtype { kI32 = 0, kF32 = 1 };

// lane_flags bits: active, emitted, one bit per map launch; the task type
// + 1 above bit 8 (0: a type outside the program — active, no effects)
constexpr int kActive = 1;
constexpr int kEmitted = 2;
constexpr int kMapBit = 4;  // kMapBit << g for map launch g (< 4)
constexpr int kTypeShift = 8;

constexpr int kFaultStage = 1;

// ---- the argument layout shared with epoch_megakernel.py -----------------
enum Ptr {
  P_TASK, P_ARGI, P_ARGF, P_EPOCH, P_VALUE, P_CHILD_BASE, P_CHILD_COUNT,
  P_NEXT_FREE, P_JSTACK, P_RSTACK, P_SP, P_FAILED, P_FAILED_STACK,
  P_N_EPOCHS, P_JOB_EPOCHS, P_JOB_TASKS, P_JOB_FORKS, P_JOB_PEAK,
  P_MAP_LAUNCHES, P_MAP_ELEMENTS, P_MAP_LANES, P_HOLE_LANES, P_FAULT,
  P_LIMIT, P_LANE_CNT, P_LANE_EXCL, P_LANE_FLAGS, P_EMIT_STAGE, P_WR_IDX,
  P_WR_VAL, P_WR_META, P_MAP_ARGI, P_MAP_ARGF, P_MAP_PRE, P_ST_IDX,
  P_ST_VAL, P_ST_META, P_HEAP0, P_COUNT = P_HEAP0 + kMaxHeap
};
enum Int {
  I_CAPACITY, I_DEPTH, I_GATHER, I_N_SPAN, I_SPAN0,
  I_STAGE_CAP = I_SPAN0 + kMaxSpan, I_N_HEAP, I_HEAP_LEN0,
  I_HEAP_DTYPE0 = I_HEAP_LEN0 + kMaxHeap, I_N_MAPS = I_HEAP_DTYPE0 + kMaxHeap,
  I_MAP0,  // per map: max_domain, n_widths, widths[kMaxMapW]
  I_N_ARG_I = I_MAP0 + kMaxMaps * (2 + kMaxMapW), I_N_ARG_F, I_VALUE_WIDTH,
  I_COUNT
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
  uint32_t* heap[kMaxHeap];
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

__device__ __forceinline__ void heap_apply(const Params& p, int meta, int idx, uint32_t bits) {
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
      atomicAdd((float*)a, v);
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
// fib (src/repro_torch/apps/fib.py): fib forks fib(n-1), fib(n-2) and joins
// fibsum unless n < 2, where it emits n; fibsum emits the sum of its two
// children's values.
struct FibApp {
  static constexpr int kTypes = 2, kArgI = 1, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 0, kMapLaunches = 0, kMapWrites = 0;

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
  __device__ static int map_id(int) { return 0; }
  __device__ static int map_domain(int, const int*) { return 0; }
  template <class S>
  __device__ static void map_payload(int, const int*, const float*, int,
                                     const Params&, S&) {}
};

// bfs (src/repro_torch/apps/bfs.py): visit(v, d, chunk) claims v with a
// min-write of d on dist and forks up to CHUNK = 8 unvisited neighbours,
// plus the next chunk of its edge list.
struct BfsApp {
  static constexpr int kTypes = 1, kArgI = 3, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 1, kMapLaunches = 0, kMapWrites = 0;
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
  __device__ static int map_id(int) { return 0; }
  __device__ static int map_domain(int, const int*) { return 0; }
  template <class S>
  __device__ static void map_payload(int, const int*, const float*, int,
                                     const Params&, S&) {}
};

// mergesort, map variant (src/repro_torch/apps/mergesort.py): msort splits
// until span 1 (a leaf copies its input element into its level's buffer),
// joins merge, and merge schedules one `place` map over its span; place
// writes each element at its own offset plus its rank in the sibling half
// (a binary search of log2(n) steps; left elements win ties).
struct MsortApp {
  static constexpr int kTypes = 2, kArgI = 4, kArgF = 0, kValW = 1;
  static constexpr int kWrites = 1, kMapLaunches = 1, kMapWrites = 1;
  enum { kInp = 0, kSrc = 1 };

  __device__ static int buf(const Params& p, int depth) {
    return floormod(depth, 2) * p.heap_len[kInp];
  }

  template <class S>
  __device__ static void task(int type, const TaskIn<MsortApp>& in,
                              const Params& p, S& s) {
    const int lo = in.argi[0], span = in.argi[1], depth = in.argi[2];
    if (type == 0) {
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
    } else {
      const int m[4] = {lo, span, depth, 0};
      s.map(0, m, nullptr, true);
    }
  }
  __device__ static int map_id(int) { return 0; }
  __device__ static int map_domain(int, const int* ai) { return ai[1]; }

  template <class S>
  __device__ static void map_payload(int, const int* ai, const float*, int i,
                                     const Params& p, S& s) {
    const int lo = ai[0], span = ai[1], depth = ai[2];
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

// ---- the chunk ---------------------------------------------------------------
template <class App>
__global__ void __launch_bounds__(kThreads, 1) epoch_chunk_kernel(const Params p) {
  __shared__ unsigned s_warp32[kWarps];
  __shared__ unsigned long long s_warp64[kWarps];
  __shared__ int s_go, s_live, s_cen, s_start, s_count, s_nf, s_last;
  __shared__ int s_dmax, s_fault;

  const int C = p.capacity;
  const int tid = threadIdx.x;

  // the sink rows stay zero (the plain loop zeroes them after each epoch)
  if (tid == 0) {
    p.task[C] = 0;
    p.epoch[C] = 0;
    p.child_base[C] = 0;
    p.child_count[C] = 0;
    for (int k = 0; k < App::kArgI; ++k) p.argi[C * App::kArgI + k] = 0;
    for (int k = 0; k < App::kArgF; ++k) p.argf[C * App::kArgF + k] = 0.f;
    for (int w = 0; w < App::kValW; ++w) p.value[C * App::kValW + w] = 0u;
    for (int v = 0; v < p.n_heap; ++v) p.heap[v][p.heap_len[v]] = 0u;
  }

  for (;;) {
    if (tid == 0) {
      s_go = (p.sp[0] > 0) && (p.n_epochs[0] < p.limit[0]);
      // pop (solo: one region)
      const int sp = p.sp[0];
      const bool live = sp > 0;
      const int top = clampi(sp - 1, 0, p.depth - 1);
      s_live = live;
      s_cen = live ? p.jstack[top] : 0;
      s_start = live ? p.rstack[2 * top] : 0;
      s_count = live ? p.rstack[2 * top + 1] : 0;
      s_nf = p.next_free[0];
      s_last = -1;
      s_fault = 0;
    }
    __syncthreads();
    if (!s_go) break;
    const int cen = s_cen, start = s_start, nf = s_nf;
    // lanes of the popped range (the step's window never exceeds the TV)
    const int nl = clampi(s_count, 0, C);

    // ---- pass A: frontier, fork counts, their exclusive scan in lane order
    unsigned total = 0;
    int n_active = 0;
    for (int b0 = 0; b0 < nl; b0 += kThreads) {
      const int l = b0 + tid;
      unsigned cnt = 0;
      int act = 0;
      if (l < nl) {
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
      if (l < nl) p.lane_excl[l] = (int)(total + ex);
      total += tot;
      n_active += __syncthreads_count(act);
    }

    // ---- pass B: children, joins, child pointers, TMS; stage the rest
    int my_join = 0;
    for (int l = tid; l < nl; l += kThreads) {
      const int flags = p.lane_flags[l];
      const int t = (flags >> kTypeShift) - 1;
      if (!(flags & kActive) || t < 0) continue;
      const int cidx = clampi(start + l, 0, C - 1);
      TaskIn<App> in;
      in.load(p, cidx);
      ApplySink<App> as(p, cidx, l, cen,
                        (unsigned)nf + (unsigned)p.lane_excl[l]);
      App::task(t, in, p, as);
      p.lane_flags[l] = as.finish(flags, p.lane_cnt[l]);
      my_join |= as.joined;
    }
    const int any_join = __syncthreads_or(my_join);

    // ---- pass C: staged emits and heap writes
    for (int l = tid; l < nl; l += kThreads) {
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
        if (meta >= 0) heap_apply(p, meta, p.wr_idx[at], p.wr_val[at]);
      }
    }
    __syncthreads();

    // ---- reclamation: last valid slot, searched down from nf + forks - 1
    const int nft = (int)((unsigned)nf + total);  // int32, as the JAX TV
    const int hi = (nft >= 1 && nft <= C) ? nft - 1 : C - 1;
    for (int top = hi; top >= 0; top -= kThreads) {
      const int s = top - tid;
      const bool valid = s >= 0 && p.epoch[s] > 0;
      if (valid) atomicMax(&s_last, s);
      if (__syncthreads_or(valid)) break;
    }
    __syncthreads();
    const int new_nf = min(nft, s_last + 1);

    // ---- push and counters (one thread)
    if (tid == 0) {
      p.next_free[0] = new_nf;
      const bool live = s_live;
      int sp = p.sp[0] - (live ? 1 : 0);
      bool failed = p.failed[0] || (live && nft > C);
      const bool ok = live && !failed;
      const int forks = (int)total;
      bool of = false;
      if (ok && any_join) {  // the join continuation, below
        of |= sp >= p.depth;
        const int ssp = clampi(sp, 0, p.depth - 1);
        p.jstack[ssp] = cen;
        p.rstack[2 * ssp] = start;
        p.rstack[2 * ssp + 1] = s_count;
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
      p.failed_stack[0] = p.failed_stack[0] || of;
      p.failed[0] = failed;
      p.sp[0] = failed ? 0 : sp;
      p.job_peak[0] = max(p.job_peak[0], new_nf);
      const long long key = p.gather ? n_active : (live ? s_count : 0);
      p.hole_lanes[0] += C - rung(p.span_w, p.n_span, key);
      p.n_epochs[0] += 1;
      p.job_epochs[0] += live ? 1 : 0;
      p.job_tasks[0] += n_active;
      p.job_forks[0] += forks;
    }

    // ---- map payloads, after the commit, one launch per (type, site)
    for (int g = 0; g < App::kMapLaunches; ++g) {
      // s_dmax was last read before the barrier that ended launch g - 1
      if (tid == 0) s_dmax = 0;
      const int mid = App::map_id(g);
      const int maxd = p.max_domain[mid];
      unsigned long long el = 0;
      int n_rows = 0;
      int my_dmax = 0;
      for (int b0 = 0; b0 < nl; b0 += kThreads) {
        const int l = b0 + tid;
        int on = 0;
        unsigned long long dom = 0;
        if (l < nl && (p.lane_flags[l] & (kMapBit << g))) {
          on = 1;
          const long long row = (long long)g * C + l;
          const int d = App::map_domain(mid, p.map_argi + row * App::kArgI);
          dom = (unsigned long long)clampi(d, 0, maxd);
          my_dmax = max(my_dmax, (int)dom);
        }
        unsigned long long tot;
        const unsigned long long ex =
            block_excl_scan<unsigned long long>(dom, s_warp64, &tot);
        if (l < nl) p.map_pre[l] = (long long)(el + ex);
        el += tot;
        n_rows += __syncthreads_count(on);
      }
      if (my_dmax > 0) atomicMax(&s_dmax, my_dmax);
      __syncthreads();
      const int dmax = s_dmax;
      const bool fired = dmax > 0;
      if (tid == 0) {
        p.map_elements[0] += (long long)el;
        if (fired) {
          p.map_launches[0] += 1;
          p.map_lanes[0] += (long long)rung(p.span_w, p.n_span, n_rows) *
                            rung(p.map_w[mid], p.n_map_w[mid], dmax);
          if ((long long)el > p.stage_cap) {
            p.fault[0] = kFaultStage;
            s_fault = 1;
          }
        }
      }
      __syncthreads();
      if (s_fault) return;
      if (!fired) continue;
      // each live element (lane, e < domain) into the stage
      for (long long f = tid; f < (long long)el; f += kThreads) {
        int a = 0, b = nl - 1;  // last lane with map_pre <= f
        while (a < b) {
          const int m = (a + b + 1) >> 1;
          if (p.map_pre[m] <= f) a = m; else b = m - 1;
        }
        const long long row = (long long)g * C + a;
        StageSink<App> ss{p, f};
        App::map_payload(mid, p.map_argi + row * App::kArgI,
                         p.map_argf + row * (App::kArgF > 0 ? App::kArgF : 1),
                         (int)(f - p.map_pre[a]), p, ss);
      }
      __syncthreads();
      for (long long f = tid; f < (long long)el; f += kThreads) {
        for (int k = 0; k < App::kMapWrites; ++k) {
          const long long at = (long long)k * p.stage_cap + f;
          const int meta = p.st_meta[at];
          if (meta >= 0) heap_apply(p, meta, p.st_idx[at], p.st_val[at]);
        }
      }
      __syncthreads();
    }
    __syncthreads();
  }
}

template <class App>
int launch(const Params& p, cudaStream_t s) {
  epoch_chunk_kernel<App><<<1, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <class App>
bool shape_ok(const long long* ints) {
  return ints[I_N_ARG_I] == App::kArgI && ints[I_N_ARG_F] == App::kArgF &&
         ints[I_VALUE_WIDTH] == App::kValW;
}

}  // namespace

extern "C" {

int trees_epoch_ptr_count() { return P_COUNT; }
int trees_epoch_int_count() { return I_COUNT; }

// out[0..6] = kTypes, kArgI, kArgF, kValW, kWrites, kMapLaunches,
// kMapWrites of device table `app` (0 fib, 1 bfs, 2 mergesort); returns
// 0, or cudaErrorInvalidValue for an unknown app.
int trees_epoch_app_info(int app, int* out) {
#define TREES_INFO(A)                                                    \
  out[0] = A::kTypes; out[1] = A::kArgI; out[2] = A::kArgF;              \
  out[3] = A::kValW; out[4] = A::kWrites; out[5] = A::kMapLaunches;      \
  out[6] = A::kMapWrites; return 0;
  switch (app) {
    case 0: { TREES_INFO(FibApp) }
    case 1: { TREES_INFO(BfsApp) }
    case 2: { TREES_INFO(MsortApp) }
    default: return (int)cudaErrorInvalidValue;
  }
#undef TREES_INFO
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (app) {
    case 0:
      if (!shape_ok<FibApp>(ints)) return (int)cudaErrorInvalidValue;
      return launch<FibApp>(p, s);
    case 1:
      if (!shape_ok<BfsApp>(ints)) return (int)cudaErrorInvalidValue;
      return launch<BfsApp>(p, s);
    case 2:
      if (!shape_ok<MsortApp>(ints)) return (int)cudaErrorInvalidValue;
      return launch<MsortApp>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
