// The ordered float scatter-add on its own, for Hopper (sm_90a): the host
// path's `arr[idx] += val` for a float heap (core/tvm.py::_scatter_heap),
// each cell's terms added in source order from its old value, as the CPU's
// index_add_ adds them.  The algorithm is ordered_add.cuh's, which
// epoch_megakernel.cu runs inside its chunk; here its phases are launches
// on one stream:
//   count (one thread a term) -> fork_scan of the counts (fork_compact.cu,
//   called by the wrapper) -> place (one thread a term) -> sum of the short
//   runs (one thread a cell) -> sum of the long runs (one CTA a run).
// `arr` is R rows of W floats (row R - 1 is the sink: its terms are
// skipped, as are rows outside [0, R - 1)); every column of a row is a cell
// of its own, and all W share the row's term order.  The caller's scratch
// (torch.empty) is cleared by a cudaMemsetAsync on the stream
// (trees_ordered_add_count) and every size comes from the tensors' shapes,
// so nothing is read back to the host and a CUDA graph may replay it all.
//
// It replaces no TPU kernel (the JAX package left the scatter to XLA);
// ROADMAP §2 item 3 asked for it: the plain version (kernels/ref.py::
// ordered_add_ref, a stable sort, then one gather/add/store per term rank)
// made two host syncs and as many passes as the longest run.  What bounds
// it: see ordered_add.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered_add.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLongThreads = 1024;

// ordered_add.cuh's term/dst accessor over R rows of W floats
struct Cells {
  float* arr;
  const float* val;
  int w;
  __device__ int width() const { return w; }
  __device__ float term(int pos, int c) const {
    return val[(long long)pos * w + c];
  }
  __device__ float* dst(int cell, int c) const {
    return arr + (long long)cell * w + c;
  }
};

__device__ __forceinline__ int row_of(const void* idx, int idx64, int t) {
  const long long r = idx64 ? static_cast<const long long*>(idx)[t]
                            : (long long)static_cast<const int*>(idx)[t];
  return (int)r == r ? (int)r : -1;
}

__global__ void count_kernel(oadd::Scratch s, const void* idx, int idx64,
                             int terms, int sink) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < terms;
       t += gridDim.x * blockDim.x) {
    const int r = row_of(idx, idx64, t);
    if (r >= 0 && r < sink) oadd::count(s, r);
  }
}

__global__ void place_kernel(oadd::Scratch s, const void* idx, int idx64,
                             int terms, int sink) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < terms;
       t += gridDim.x * blockDim.x) {
    const int r = row_of(idx, idx64, t);
    if (r >= 0 && r < sink) oadd::place(s, r, t);
  }
}

__global__ void short_kernel(oadd::Scratch s, Cells c, int sink) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < sink;
       r += gridDim.x * blockDim.x) {
    const int n = s.cnt[r];
    if (n > 0 && n <= oadd::kShortRun) oadd::sum_short(s, r, n, c);
  }
}

__global__ void __launch_bounds__(kLongThreads) long_kernel(oadd::Scratch s,
                                                            Cells c) {
  __shared__ int sh[oadd::kSortTile];
  const int n_long = *s.n_long;
  for (int i = blockIdx.x; i < n_long; i += gridDim.x) {
    const int r = s.long_cells[i];
    oadd::sum_long(s, r, s.cnt[r], c, sh);
  }
}

int blocks_for(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return (int)(b < 1 ? 1 : (b > (1 << 20) ? (1 << 20) : b));
}

oadd::Scratch scratch_at(int* w, int rows, int terms) {
  // layout: cnt[rows], cur[rows], n_long, long_cells[rows], run[terms],
  // run2[terms]; off comes from the caller (fork_scan's output)
  oadd::Scratch s;
  s.cnt = w;
  s.cur = w + rows;
  s.n_long = w + 2LL * rows;
  s.long_cells = w + 2LL * rows + 1;
  s.run = w + 3LL * rows + 1;
  s.run2 = s.run + terms;
  s.off = nullptr;
  return s;
}

}  // namespace

extern "C" {

// int32 words of scratch for `rows` rows and `terms` terms.
long long trees_ordered_add_scratch_words(int rows, int terms) {
  return 3LL * rows + 1 + 2LL * terms;
}

// Clear the scratch's counters and count each kept term into its row
// (`idx64`: idx is int64, else int32).
int trees_ordered_add_count(const void* idx, int idx64, int terms, int rows,
                            int* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || terms < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaMemsetAsync(scratch, 0, sizeof(int) * (2LL * rows + 1), st);
  if (e != cudaSuccess) return (int)e;
  oadd::Scratch s = scratch_at(scratch, rows, terms);
  count_kernel<<<blocks_for(terms, kThreads), kThreads, 0, st>>>(
      s, idx, idx64, terms, rows - 1);
  return (int)cudaGetLastError();
}

// With off = the exclusive scan of the counts (scratch[0, rows)): place
// each term, then sum the short runs and the long runs into arr.
int trees_ordered_add_apply(float* arr, const float* val, int width,
                            const void* idx, int idx64, int terms, int rows,
                            int* scratch, int* off, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || terms < 0 || width < 1) return (int)cudaErrorInvalidValue;
  oadd::Scratch s = scratch_at(scratch, rows, terms);
  s.off = off;
  const Cells c{arr, val, width};
  place_kernel<<<blocks_for(terms, kThreads), kThreads, 0, st>>>(
      s, idx, idx64, terms, rows - 1);
  short_kernel<<<blocks_for(rows, kThreads), kThreads, 0, st>>>(s, c,
                                                                rows - 1);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  // at most one CTA a possible long run, two an SM
  const long long most = terms / (oadd::kShortRun + 1);
  const int g = (int)(most < 1 ? 1 : (most < 2LL * sms ? most : 2LL * sms));
  long_kernel<<<g, kLongThreads, 0, st>>>(s, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
