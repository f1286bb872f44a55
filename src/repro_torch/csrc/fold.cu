// FOLD, replay-only arity: one bracket close in evaluation mode.
//
// Replaces: src/repro/kernels/fold/fused.py, function build (kernel body
// _make_kernel), its replay-only arity — the fused Pallas FOLD of the TPU
// engine.  For every active parent row i and every valid exit row e whose
// orig is rep_of_row[i], one output row: the parent's assignment with
// columns [d0, d1] taken from the exit row, factor = parent x exit.
//
// What bounds it on an H100: memory and launch latency.  At the main
// path's chunk (C = 65536, n = 4, m = 4) a call moves at most the parent
// chunk (60 bytes a row), active and rep_of_row (5), the exit chunk's
// assign, factor, valid and orig (29), a full output chunk (61) and the
// stats: 155 bytes a row, about 10.2 MB, 3.0 us at 3.35 TB/s.  A real
// fold needs only the parents that replay, the exits they replay and
// min(needed, C) output rows (chip_smoke.py counts those).
//
// Design.  The TPU kernel computed its plan into VMEM scratch in the first
// step of a sequential grid; here the steps are three launches:
//   1. plan  — one thread per parent row: its representative's exit range
//              by two bounded searches over the exit keys
//              ekey = valid ? clip(orig) : C (the exits are valid-prefix
//              compacted with nondecreasing orig — the executor's
//              sorted-exits invariant — so no histogram or sort is
//              needed), and pcnt = active ? range length : 0;
//   2. scan  — exclusive scan of pcnt: replay offsets and `needed`;
//   3. slots — one thread per output slot: invert the offsets by an
//              upper-bound search, gather the parent and the exit row,
//              write the row; slot 0 also writes stats.
// The offsets partition [0, needed), so the survivors are a prefix by
// construction and no compaction pass is needed.
#include "common.cuh"

namespace ctj {

// Sort key of exit row i: its representative, or C past the valid prefix.
struct ExitKey {
  const bool* valid;
  const int* orig;
  int C;
  __device__ __forceinline__ int operator()(int i) const {
    return valid[i] ? clampi(orig[i], 0, C - 1) : C;
  }
};

__global__ void fold_plan(const bool* __restrict__ active,
                          const int* __restrict__ rep_of_row,
                          const bool* __restrict__ e_valid,
                          const int* __restrict__ e_orig, int C,
                          int* __restrict__ plb, int* __restrict__ pcnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const ExitKey key{e_valid, e_orig, C};
  const int rep = clampi(rep_of_row[i], 0, C - 1);
  const int lb = bsearch<true>(key, C, rep, 0, C);
  const int ub = bsearch<false>(key, C, rep, 0, C);
  plb[i] = lb;
  pcnt[i] = active[i] ? ub - lb : 0;
}

__global__ void fold_slots(
    const int* __restrict__ p_assign, const long long* __restrict__ p_factor,
    const int* __restrict__ p_orig, const int* __restrict__ p_lo,
    const int* __restrict__ p_hi, const int* __restrict__ e_assign,
    const long long* __restrict__ e_factor, const int* __restrict__ plb,
    const int* __restrict__ roff, const int* __restrict__ needed_p, int C,
    int n, int m, int d0, int d1, int* __restrict__ o_assign,
    long long* __restrict__ o_factor, bool* __restrict__ o_valid,
    int* __restrict__ o_orig, int* __restrict__ o_lo,
    int* __restrict__ o_hi, long long* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C) return;
  const int needed = *needed_p;
  const int n_valid = needed < C ? needed : C;
  if (s == 0) {
    stats[0] = needed;
    stats[1] = 0;
    stats[2] = n_valid;
  }
  o_valid[s] = s < n_valid;
  if (s >= n_valid) return;
  const int src =
      clampi(bsearch<false>(ColLoad{roff}, C, s, 0, C) - 1, 0, C - 1);
  const int eidx = clampi(plb[src] + (s - roff[src]), 0, C - 1);
  const size_t so = static_cast<size_t>(s);
  const size_t ps = static_cast<size_t>(src);
  const size_t es = static_cast<size_t>(eidx);
  for (int c = 0; c < n; ++c) {
    o_assign[so * n + c] = (c >= d0 && c <= d1) ? e_assign[es * n + c]
                                                : p_assign[ps * n + c];
  }
  for (int c = 0; c < m; ++c) {
    o_lo[so * m + c] = p_lo[ps * m + c];
    o_hi[so * m + c] = p_hi[ps * m + c];
  }
  o_factor[s] = p_factor[src] * e_factor[eidx];
  o_orig[s] = p_orig[src];
}

}  // namespace ctj

// Scratch layout (int32, 3C + 1 values): plb, pcnt, roff (C each),
// needed (1).  Returns the first CUDA error.
extern "C" int ctj_fold_replay(
    const void* p_assign, const void* p_factor, const void* p_orig,
    const void* p_lo, const void* p_hi, const void* active,
    const void* rep_of_row, const void* e_assign, const void* e_factor,
    const void* e_valid, const void* e_orig, int C, int n, int m, int d0,
    int d1, void* o_assign, void* o_factor, void* o_valid, void* o_orig,
    void* o_lo, void* o_hi, void* o_stats, void* scratch,
    void* stream_ptr) {
  using namespace ctj;
  if (C <= 0 || d0 < 0 || d1 < d0 || d1 >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t c = static_cast<size_t>(C);
  int* plb = static_cast<int*>(scratch);
  int* pcnt = plb + c;
  int* roff = pcnt + c;
  int* needed = roff + c;
  const int grid = blocks_for(C);

  fold_plan<<<grid, kThreads, 0, stream>>>(
      static_cast<const bool*>(active), static_cast<const int*>(rep_of_row),
      static_cast<const bool*>(e_valid), static_cast<const int*>(e_orig), C,
      plb, pcnt);
  CTJ_CHECK(cudaGetLastError());
  CTJ_CHECK(launch_scan<int>(pcnt, roff, needed, C, false, stream));
  fold_slots<<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(p_assign),
      static_cast<const long long*>(p_factor),
      static_cast<const int*>(p_orig), static_cast<const int*>(p_lo),
      static_cast<const int*>(p_hi), static_cast<const int*>(e_assign),
      static_cast<const long long*>(e_factor), plb, roff, needed, C, n, m,
      d0, d1, static_cast<int*>(o_assign), static_cast<long long*>(o_factor),
      static_cast<bool*>(o_valid), static_cast<int*>(o_orig),
      static_cast<int*>(o_lo), static_cast<int*>(o_hi),
      static_cast<long long*>(o_stats));
  return static_cast<int>(cudaGetLastError());
}
