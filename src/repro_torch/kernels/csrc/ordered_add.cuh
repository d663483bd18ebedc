// The ordered float scatter-add, as device routines: `arr[idx] += val` with
// each cell's terms added one at a time, in source order, from its old
// value.  That is the CPU's index_add_ (a serial loop), whose rounding the
// JAX reference's CPU scatter shares; CUDA's index_add_ adds atomically, in
// an order that changes from run to run.
//
// It replaces no TPU kernel: on the TPU the scatter was XLA's.  Two kernels
// of this package include it: epoch_megakernel.cu (a map payload's float
// `add`, inside the cooperative chunk, phases separated by grid barriers)
// and ordered_add.cu (the host path's scatter, phases separated by kernel
// launches).  Both run the same phases over terms t (a source position:
// the stage position of a map element, or the row of `idx`):
//   count  each term adds one to its cell's count (integer atomics, so the
//          order does not matter); the term that makes a run longer than
//          kShortRun lists the cell as long;
//   scan   an exclusive scan of the counts over the cells gives each cell's
//          run in one buffer (the caller's: fork_scan, or the chunk's own
//          scan across its CTAs);
//   place  each term writes its position into its cell's run, at a slot
//          from an atomic cursor (in no order);
//   sum    each run is sorted by position (positions are unique, so any
//          sort gives the source order) and summed serially from the old
//          value with __fadd_rn.  A short run (<= kShortRun) is one
//          thread's insertion sort in a local array; a long one is a CTA's
//          bitonic sort of kSortTile positions at a time in shared memory,
//          then merge passes through a second buffer, so that one hot cell
//          costs O(n log n) spread over a CTA, not O(n^2) on one thread.
//          The serial sum itself cannot be split: float addition does not
//          associate.
//
// What bounds it: bytes at matmul's payload (a count, a cursor and an
// offset per cell, a position per term written and read back, each term's
// value read once), about 0.02 ms at 8.4 M terms on the card's 3.35 TB/s;
// in practice the atomics on hot cells and the serial sum of the longest
// run.
#pragma once

#include <stdint.h>

namespace oadd {

constexpr int kShortRun = 32;    // longest run one thread sorts and sums
constexpr int kSortTile = 4096;  // positions a CTA sorts in shared memory
constexpr int kNoPos = 0x7fffffff;

// The caller's scratch.  cnt, cur and n_long are zero before a use, and the
// sum phase leaves them zero for the next.
struct Scratch {
  int* cnt;         // [cells] terms per cell
  int* cur;         // [cells] placement cursors
  int* off;         // [cells] exclusive scan of cnt
  int* run;         // [terms] positions, grouped by cell
  int* run2;        // [terms] the merge passes' second buffer
  int* n_long;      // [1] cells with more than kShortRun terms
  int* long_cells;  // [cells] those cells, in no order
};

__device__ __forceinline__ void count(const Scratch& s, int cell) {
  if (atomicAdd(s.cnt + cell, 1) == kShortRun) {
    s.long_cells[atomicAdd(s.n_long, 1)] = cell;
  }
}

__device__ __forceinline__ void place(const Scratch& s, int cell, int pos) {
  s.run[s.off[cell] + atomicAdd(s.cur + cell, 1)] = pos;
}

// One thread: the run of `cell` (n terms, 1 <= n <= kShortRun) in source
// order, summed into each of its T::width() columns; clears the cell.
// T gives term(pos, column), the value of the term at `pos`, and
// dst(cell, column), the address of the cell's column.
template <class T>
__device__ void sum_short(const Scratch& s, int cell, int n, const T& t) {
  int k[kShortRun];
  const int* r = s.run + s.off[cell];
  for (int i = 0; i < n; ++i) {
    const int x = r[i];
    int j = i;
    while (j > 0 && k[j - 1] > x) {
      k[j] = k[j - 1];
      --j;
    }
    k[j] = x;
  }
  for (int c = 0; c < t.width(); ++c) {
    float* d = t.dst(cell, c);
    float acc = *d;
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, t.term(k[i], c));
    *d = acc;
  }
  s.cnt[cell] = 0;
  s.cur[cell] = 0;
}

// Bitonic sort of sh[0, p2) ascending, p2 a power of two; every thread of
// the CTA calls it.
__device__ __forceinline__ void bitonic(int* sh, int p2) {
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int ij = i ^ j;
        if (ij > i) {
          const int a = sh[i], b = sh[ij];
          if ((a > b) == ((i & k) == 0)) {
            sh[i] = b;
            sh[ij] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// elements of x[0, n) below v (x ascending)
__device__ __forceinline__ int lower_bound(const int* x, int n, int v) {
  int a = 0;
  while (n > 0) {
    const int h = n >> 1;
    if (x[a + h] < v) {
      a += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return a;
}

// The whole CTA: the run of `cell` (n > kShortRun terms) sorted and summed
// as sum_short does; `sh` is kSortTile ints of shared memory.  Every
// thread of the CTA calls it with the same cell.
template <class T>
__device__ void sum_long(const Scratch& s, int cell, int n, const T& t,
                         int* sh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int* src = s.run + s.off[cell];
  int* dst = s.run2 + s.off[cell];
  // sorted tiles of kSortTile positions
  for (int t0 = 0; t0 < n; t0 += kSortTile) {
    const int m = min(kSortTile, n - t0);
    int p2 = 1;
    while (p2 < m) p2 <<= 1;
    for (int i = tid; i < p2; i += nt) sh[i] = i < m ? src[t0 + i] : kNoPos;
    __syncthreads();
    bitonic(sh, p2);
    for (int i = tid; i < m; i += nt) src[t0 + i] = sh[i];
    __syncthreads();
  }
  // merge pairs of sorted blocks of width w into dst, w = kSortTile, 2
  // kSortTile, ...: each position's place is its own index plus the
  // positions below it in the other block
  for (int w = kSortTile; w < n; w <<= 1) {
    for (int i = tid; i < n; i += nt) {
      const int a0 = ((i / w) & ~1) * w;
      const int mid = min(a0 + w, n), end = min(a0 + 2 * w, n);
      const int x = src[i];
      dst[i < mid ? i + lower_bound(src + mid, end - mid, x)
                  : a0 + (i - mid) + lower_bound(src + a0, mid - a0, x)] = x;
    }
    __syncthreads();
    int* tmp = src;
    src = dst;
    dst = tmp;
  }
  // the serial sum, a shared tile of gathered terms at a time
  float* shf = reinterpret_cast<float*>(sh);
  for (int c = 0; c < t.width(); ++c) {
    float* d = t.dst(cell, c);
    float acc = tid == 0 ? *d : 0.f;
    for (int t0 = 0; t0 < n; t0 += kSortTile) {
      const int m = min(kSortTile, n - t0);
      for (int i = tid; i < m; i += nt) shf[i] = t.term(src[t0 + i], c);
      __syncthreads();
      if (tid == 0) {
        for (int i = 0; i < m; ++i) acc = __fadd_rn(acc, shf[i]);
      }
      __syncthreads();
    }
    if (tid == 0) *d = acc;
  }
  if (tid == 0) {
    s.cnt[cell] = 0;
    s.cur[cell] = 0;
  }
}

}  // namespace oadd
