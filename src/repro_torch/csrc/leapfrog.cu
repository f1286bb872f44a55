// Bounded search (the leapfrog seek): per query, the insertion point of a
// value inside a window of a shared sorted column.
//
// Replaces: src/repro/kernels/leapfrog/leapfrog.py, function _bound_pallas
// (kernel body _bound_kernel) — the Pallas dense masked count
//     lo + |{p in [lo, hi) and [0, N) : col[p] < v}|   (<= for upper)
// over a sequential grid of column blocks.
//
// What bounds it on an H100: memory and launch latency.  A query reads
// its value, lo and hi and writes one result: 16 bytes, so the chain
// EXPAND's calls (M = 65536 queries) move about 1 MB, 0.31 us at
// 3.35 TB/s.  The column (at most 415 KB at wiki-Vote scale) stays in the
// 50 MB L2 across the log2(N) dependent reads of each search.
//
// Design.  The TPU's design — a (queries x column block) compare-and-count
// accumulated over a sequential grid — does O(N) work per query and relies
// on grid steps running in order; Hopper blocks run concurrently, and at
// N ~ 1e5 the dense count wastes five orders of magnitude of work.  Here
// one thread does a plain binary search over [max(lo, 0), min(hi, N)).
// That equals the dense count whenever the window is sorted, which every
// window the chain EXPAND relies on is: a trie level's column is sorted
// within each parent run and a window never crosses a run.  lo >= hi (or
// lo >= N) returns lo.  Later work: stage the column in shared memory, and
// fuse the lower/upper pair of one atom into one launch.
#include "common.cuh"

namespace ctj {

template <bool kStrict>
__global__ void bound_kernel(const int* __restrict__ col, int n,
                             const int* __restrict__ values,
                             const int* __restrict__ lo,
                             const int* __restrict__ hi, int m,
                             int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int l = lo[i];
  const int start = l > 0 ? l : 0;
  const int h = hi[i];
  const int v = values[i];
  int a = start;
  int b = h < n ? h : n;
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    const int x = __ldg(col + mid);
    if (kStrict ? (x < v) : (x <= v)) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  out[i] = l + (a - start);  // lo itself when the window is empty
}

}  // namespace ctj

// out[i] = the bounded lower (strict != 0) or upper bound of query i.
// Returns the first CUDA error.
extern "C" int ctj_bound(const void* col, const void* values, const void* lo,
                         const void* hi, int n, int m, int strict, void* out,
                         void* stream_ptr) {
  using namespace ctj;
  if (n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int* c = static_cast<const int*>(col);
  const int* v = static_cast<const int*>(values);
  const int* l = static_cast<const int*>(lo);
  const int* h = static_cast<const int*>(hi);
  int* o = static_cast<int*>(out);
  if (strict) {
    bound_kernel<true><<<blocks_for(m), kThreads, 0, stream>>>(c, n, v, l, h,
                                                                m, o);
  } else {
    bound_kernel<false><<<blocks_for(m), kThreads, 0, stream>>>(c, n, v, l,
                                                                 h, m, o);
  }
  return static_cast<int>(cudaGetLastError());
}
