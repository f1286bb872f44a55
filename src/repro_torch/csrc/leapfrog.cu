// Bounded search (the leapfrog seek): the insertion point of a value inside
// a window of a shared sorted column.  Two entry points share the search:
//
//   ctj_bound        one bound (lower or upper) of M independent queries;
//                    it serves registry.lower_bound / upper_bound with
//                    impl="leapfrog" on a CUDA column;
//   ctj_bound_atoms  the chain EXPAND's membership test: every membership
//                    atom's lower and upper bound for every candidate slot,
//                    narrowing the slot's windows in place, in one launch.
//
// Replaces: src/repro/kernels/leapfrog/leapfrog.py, function _bound_pallas
// (kernel body _bound_kernel) — the Pallas dense masked count
//     lo + |{p in [lo, hi) and [0, N) : col[p] < v}|   (<= for upper)
// over a sequential grid of column blocks, which the reference's chain
// EXPAND (repro/kernels/expand/xla.py) calls twice for each atom.
//
// What bounds it on an H100: not bytes.  A slot reads its ok flag, its
// value and one lo/hi pair an atom; a rejected slot writes its ok flag,
// a kept one its narrowed windows: under 1 MB at C = 65536, 0.3 us at
// 3.35 TB/s.  The columns (at most 370 KB at wiki-Vote scale) stay in the
// 50 MB L2.  What a call costs is the launch and the wrapper's host work
// around it (a ctj_bound call was 3.4 us busy in 33 us), and on the device
// the chain of dependent L2 loads of each search: log2(window) of them,
// with a warp waiting for its longest.
//
// Design.  The TPU's compare-and-count does O(N) work per query and relies
// on grid steps running in order; here one thread does a binary search
// over [max(lo, 0), min(hi, N)), which equals the dense count whenever the
// window is sorted.  Every window the chain EXPAND searches on a live slot
// is (a trie level's column is sorted within each parent run and a window
// never crosses a run).  lo >= hi (or lo >= N) returns lo.  Against the
// launch cost and the load chain, ctj_bound_atoms
//   * makes one launch for all atoms of an EXPAND (up to kMaxAtoms; more go
//     in groups, in atom order), with the columns passed by value as kernel
//     parameters, so no host->device copy and no per-atom strided copies;
//   * reads the windows in place in the (C, m) lo/hi matrices and writes
//     them back only for a slot that every atom of the launch keeps, and
//     ok only for a slot that an atom rejects;
//   * searches nothing for a dead slot (past `needed`, or a candidate past
//     its parent's runs) and stops at the first atom that rejects a slot,
//     the leapfrog rule;
//   * finds the upper bound by galloping from the lower bound s (probes s,
//     s+1, s+3, s+7, ...) and a binary search in the last gap: a trie run
//     holds distinct values, so it costs one or two loads where a second
//     full search cost log2(window).
// Later work: stage a hub's window in shared memory.
#include "common.cuh"

namespace ctj {

constexpr int kMaxAtoms = 8;  // atoms one ctj_bound_atoms launch takes

// One membership atom: its column (n > 0 values) and its lo/hi column ai.
struct AtomCol {
  const int* col;
  int n;
  int ai;
};

// The atoms of one launch, passed by value as a kernel parameter.
struct AtomCols {
  AtomCol atom[kMaxAtoms];
  int count;
};

__device__ __forceinline__ bool before(int x, int v, bool strict) {
  return strict ? x < v : x <= v;
}

// The bounded lower (strict) or upper bound of one query by binary search:
// lo + |{p in [lo, hi) and [0, n) : col[p] < v}| (<= unless strict) when
// the window is sorted.
__device__ __forceinline__ int bound_search(const int* __restrict__ col, int n,
                                            int v, int lo, int hi,
                                            bool strict) {
  const int start = lo > 0 ? lo : 0;
  int a = start;
  int b = hi < n ? hi : n;
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    if (before(__ldg(col + mid), v, strict)) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return lo + (a - start);  // lo itself when the window is empty
}

// The same upper bound (<=) found by galloping from the window's start,
// for windows whose first values are likely the last ones <= v: probes
// start, start+1, start+3, start+7, ... inside the window, then a binary
// search of the last gap.  Equal to bound_search(..., false) on a sorted
// window.
__device__ __forceinline__ int upper_gallop(const int* __restrict__ col,
                                            int n, int v, int lo, int hi) {
  const int start = lo > 0 ? lo : 0;
  const int end = hi < n ? hi : n;
  int a = start;  // every position in [start, a) holds a value <= v
  int b = end;
  for (long long step = 1; start + step - 1 < end; step <<= 1) {
    const int p = static_cast<int>(start + step - 1);
    if (__ldg(col + p) > v) {
      b = p;
      break;
    }
    a = p + 1;
  }
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    if (__ldg(col + mid) <= v) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return lo + (a - start);
}

template <bool kStrict>
__global__ void bound_kernel(const int* __restrict__ col, int n,
                             const int* __restrict__ values,
                             const int* __restrict__ lo,
                             const int* __restrict__ hi, int m,
                             int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  out[i] = bound_search(col, n, values[i], lo[i], hi[i], kStrict);
}

// Slot i (a thread) of a chain EXPAND: for each atom in order, narrow the
// window (lo2[i][ai], hi2[i][ai]) to the run of values equal to values[i].
// An empty run clears ok[i] and ends the slot's work; the narrowed windows
// are held in registers and written only for a slot that every atom keeps,
// the only slots whose windows the chain reads.
__global__ void bound_atoms_kernel(AtomCols atoms,
                                   const int* __restrict__ values,
                                   bool* __restrict__ ok,
                                   int* __restrict__ lo2,
                                   int* __restrict__ hi2, int C, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C || !ok[i]) return;
  const int v = values[i];
  int* lo_row = lo2 + static_cast<long long>(i) * m;
  int* hi_row = hi2 + static_cast<long long>(i) * m;
  int s[kMaxAtoms];
  int e[kMaxAtoms];
#pragma unroll
  for (int k = 0; k < kMaxAtoms; ++k) {
    if (k < atoms.count) {
      const AtomCol a = atoms.atom[k];
      const int hi = hi_row[a.ai];
      s[k] = bound_search(a.col, a.n, v, lo_row[a.ai], hi, true);
      e[k] = upper_gallop(a.col, a.n, v, s[k], hi);
      if (s[k] >= e[k]) {
        ok[i] = false;
        return;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxAtoms; ++k) {
    if (k < atoms.count) {
      lo_row[atoms.atom[k].ai] = s[k];
      hi_row[atoms.atom[k].ai] = e[k];
    }
  }
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

// The membership atoms of one chain EXPAND over C slots: `atoms` points to
// n_atoms (1..kMaxAtoms) host records {column, its length n > 0, its lo/hi
// column ai < m}, searched in that order; values, ok (in/out) and the (C, m)
// row-major windows lo2, hi2 (in/out) are on the device.  Returns the first
// CUDA error.
extern "C" int ctj_bound_atoms(const void* atoms, int n_atoms,
                               const void* values, void* ok, void* lo2,
                               void* hi2, int C, int m, void* stream_ptr) {
  using namespace ctj;
  if (n_atoms <= 0 || n_atoms > kMaxAtoms || C <= 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AtomCols cols{};
  const AtomCol* in = static_cast<const AtomCol*>(atoms);
  for (int k = 0; k < n_atoms; ++k) {
    if (in[k].col == nullptr || in[k].n <= 0 || in[k].ai < 0 ||
        in[k].ai >= m) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cols.atom[k] = in[k];
  }
  cols.count = n_atoms;
  bound_atoms_kernel<<<blocks_for(C), kThreads, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      cols, static_cast<const int*>(values), static_cast<bool*>(ok),
      static_cast<int*>(lo2), static_cast<int*>(hi2), C, m);
  return static_cast<int>(cudaGetLastError());
}
