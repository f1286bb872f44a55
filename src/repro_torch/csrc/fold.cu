// FOLD, replay-only and splice-only arities: one bracket close in
// evaluation mode.
//
// ---- Replay-only (ctj_fold_replay) ----------------------------------------
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
//
// ---- Splice-only (ctj_fold_splice) ----------------------------------------
//
// Replaces: the same Pallas kernel's splice-only arity
// (src/repro/kernels/fold/fused.py, build with with_replay=False,
// with_splice=True; splice region of _make_kernel).  Each parent row i
// with a tier-2 payload hit contributes plen[i] output rows: the parent's
// assignment with columns [d0, d1] taken from slab rows poff[i] ..
// poff[i] + plen[i] - 1 (its cached factorized block), in parent-row
// order; factor, orig, lo and hi are the parent's.  Slots below
// min(n_spliced, C) are valid; stats = [0, n_spliced, min(n_spliced, C)].
//
// What bounds it on an H100: memory and launch latency, as for replay.
// A call must read the hit flags and block pointers of every parent, the
// parent row of every parent that hits, the n_spliced slab rows, and
// write min(n_spliced, C) output rows: at C = 65536, n = m = 4 and a full
// chunk of output that is at most ~10 MB, about 3 us at 3.35 TB/s; each
// output slot also runs one bounded search over the C offsets.
//
// Design.  The Pallas kernel computed scnt/soff into VMEM scratch in its
// first grid step; here those steps are their own launches:
//   1. plan  — one thread per parent row: scnt = hit ? plen : 0;
//   2. scan  — exclusive scan of scnt (block_scan): soff and n_spliced;
//   3. slots — one thread per output slot: the parent by an upper-bound
//              search of the slot in soff, minus 1; the slab row
//              poff[src] + slot - soff[src], clipped to [0, nslab - 2] as
//              the Pallas kernel clips it (the last slab row is the
//              store's scratch row, never read); slot 0 writes stats.
// The offsets partition [0, n_spliced), so the valid rows are a prefix
// and no compaction is needed.  Blocks are contiguous in the slab, so no
// per-representative sort is needed either.
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

__global__ void splice_plan(const bool* __restrict__ hit,
                            const int* __restrict__ plen, int C,
                            int* __restrict__ scnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  scnt[i] = hit[i] ? plen[i] : 0;
}

__global__ void splice_slots(
    const int* __restrict__ p_assign, const long long* __restrict__ p_factor,
    const int* __restrict__ p_orig, const int* __restrict__ p_lo,
    const int* __restrict__ p_hi, const int* __restrict__ poff,
    const int* __restrict__ slab, const int* __restrict__ soff,
    const int* __restrict__ n_spl_p, int C, int n, int m, int d0, int d1,
    int nslab, int* __restrict__ o_assign, long long* __restrict__ o_factor,
    bool* __restrict__ o_valid, int* __restrict__ o_orig,
    int* __restrict__ o_lo, int* __restrict__ o_hi,
    long long* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C) return;
  const int n_spl = *n_spl_p;
  const int n_valid = n_spl < C ? n_spl : C;
  if (s == 0) {
    stats[0] = 0;
    stats[1] = n_spl;
    stats[2] = n_valid;
  }
  o_valid[s] = s < n_valid;
  if (s >= n_valid) return;
  const int src =
      clampi(bsearch<false>(ColLoad{soff}, C, s, 0, C) - 1, 0, C - 1);
  const int w = d1 - d0 + 1;
  const int sidx = clampi(poff[src] + (s - soff[src]), 0, nslab - 2);
  const size_t so = static_cast<size_t>(s);
  const size_t ps = static_cast<size_t>(src);
  const size_t ss = static_cast<size_t>(sidx);
  for (int c = 0; c < n; ++c) {
    o_assign[so * n + c] = (c >= d0 && c <= d1) ? slab[ss * w + (c - d0)]
                                                : p_assign[ps * n + c];
  }
  for (int c = 0; c < m; ++c) {
    o_lo[so * m + c] = p_lo[ps * m + c];
    o_hi[so * m + c] = p_hi[ps * m + c];
  }
  o_factor[s] = p_factor[src];
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

// Splice-only FOLD.  slab is (nslab, d1 - d0 + 1) int32, its last row the
// store's scratch row.  Scratch layout (int32, 2C + 1 values): scnt, soff
// (C each), n_spliced (1).  Returns the first CUDA error.
extern "C" int ctj_fold_splice(
    const void* p_assign, const void* p_factor, const void* p_orig,
    const void* p_lo, const void* p_hi, const void* hit, const void* poff,
    const void* plen, const void* slab, int C, int n, int m, int d0, int d1,
    int nslab, void* o_assign, void* o_factor, void* o_valid, void* o_orig,
    void* o_lo, void* o_hi, void* o_stats, void* scratch,
    void* stream_ptr) {
  using namespace ctj;
  if (C <= 0 || d0 < 0 || d1 < d0 || d1 >= n || nslab < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t c = static_cast<size_t>(C);
  int* scnt = static_cast<int*>(scratch);
  int* soff = scnt + c;
  int* n_spl = soff + c;
  const int grid = blocks_for(C);

  splice_plan<<<grid, kThreads, 0, stream>>>(
      static_cast<const bool*>(hit), static_cast<const int*>(plen), C, scnt);
  CTJ_CHECK(cudaGetLastError());
  CTJ_CHECK(launch_scan<int>(scnt, soff, n_spl, C, false, stream));
  splice_slots<<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(p_assign),
      static_cast<const long long*>(p_factor),
      static_cast<const int*>(p_orig), static_cast<const int*>(p_lo),
      static_cast<const int*>(p_hi), static_cast<const int*>(poff),
      static_cast<const int*>(slab), soff, n_spl, C, n, m, d0, d1, nslab,
      static_cast<int*>(o_assign), static_cast<long long*>(o_factor),
      static_cast<bool*>(o_valid), static_cast<int*>(o_orig),
      static_cast<int*>(o_lo), static_cast<int*>(o_hi),
      static_cast<long long*>(o_stats));
  return static_cast<int>(cudaGetLastError());
}
