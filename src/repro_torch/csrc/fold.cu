// FOLD, in its three arities (replay-only, splice-only and merged): one
// bracket close in evaluation mode.  The file holds one copy of each
// gather (replay_row, splice_row) and three entry points.
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
// ---- Merged (ctj_fold_merged) ---------------------------------------------
//
// Replaces: the same Pallas kernel's two-region arity
// (src/repro/kernels/fold/fused.py, build with with_replay=True,
// with_splice=True: the `with_replay and with_splice` branch of
// _make_kernel), which only the static executor calls.  Output layout
// [replay | splice]: the replay rows of the miss parents first, truncated
// to n1 = min(needed, C), then the splice rows of the hit parents in slots
// n1 .. min(n1 + n_spliced, C) - 1.  stats = [needed, n_spliced,
// min(needed, C) + min(n_spliced, C)], the last figure uncapped so that
// the executor can flag an overflow.
//
// What bounds it on an H100: bytes.  It must read the parent plan (active,
// rep_of_row, hit, plen: 10 bytes a parent), the exits' valid flags and
// orig, the parent row of every parent that fills an output row, the exit
// or slab row each output row takes, and write min(n1 + n2, C) output rows
// (61 bytes each at n = m = 4) and the valid flags.  At the static path's
// capacities (C = 2^23 to 2^25) that is 0.5-2 GB at most, 0.15-0.6 ms at
// 3.35 TB/s; but the two exclusive scans run in one block each
// (block_scan, about 0.6 ns a value), 5-20 ms apiece, and they set the
// kernel's time.
//
// Design.  The Pallas kernel computed both plans into VMEM scratch in grid
// step 0 and read them in later steps; Hopper runs blocks concurrently, so
// the steps are four launches on one stream:
//   1. plan  — one thread per parent row writes both plans: the replay
//              plan (its representative's exit range by two bounded
//              searches over the sorted exit keys, pcnt) and the splice
//              plan (scnt = hit ? plen : 0);
//   2. scan  — exclusive scan of pcnt: roff and `needed`;
//   3. scan  — exclusive scan of scnt: soff and n_spliced;
//   4. slots — one thread per output slot reads n1 from the first scan's
//              total in device memory (no host round trip): slots below n1
//              take the replay gather at pair s, the rest the splice
//              gather at pair u = s - n1; slot 0 writes stats.
// Both regions are prefixes of their own offsets, so the valid rows are a
// prefix with no compaction.  The scans are the repo's single-block scan,
// kept simple here: a multi-block scan is the way to make this fast.
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

// The parent chunk's fields that an output row copies.
struct Parent {
  const int* assign;
  const long long* factor;
  const int* orig;
  const int* lo;
  const int* hi;
};

// The output chunk.
struct Out {
  int* assign;
  long long* factor;
  bool* valid;
  int* orig;
  int* lo;
  int* hi;
};

// What the replay gather reads: the exit rows and the replay plan.
struct Replay {
  const int* e_assign;
  const long long* e_factor;
  const int* plb;   // first exit of each parent's representative
  const int* roff;  // exclusive scan of the pair counts
};

// What the splice gather reads: the block pointers, the slab and the
// splice offsets.
struct Splice {
  const int* poff;
  const int* slab;
  const int* soff;  // exclusive scan of the spliced row counts
  int nslab;
};

struct Shape {
  int C, n, m, d0, d1;
};

// Replay plan of parent row i: its representative's exit range [lb, ub)
// (the exits are sorted by representative) and the pairs it replays.
__device__ __forceinline__ void replay_plan_row(
    int i, const bool* __restrict__ active,
    const int* __restrict__ rep_of_row, const ExitKey& key, int C,
    int* __restrict__ plb, int* __restrict__ pcnt) {
  const int rep = clampi(rep_of_row[i], 0, C - 1);
  const int lb = bsearch<true>(key, C, rep, 0, C);
  const int ub = bsearch<false>(key, C, rep, 0, C);
  plb[i] = lb;
  pcnt[i] = active[i] ? ub - lb : 0;
}

// Output slot s takes replay pair r: the parent by an upper-bound search
// of r in roff, minus 1, and that parent's (r - roff[src])-th exit.
__device__ __forceinline__ void replay_row(int s, int r, const Shape& sh,
                                           const Parent& p, const Replay& rp,
                                           const Out& o) {
  const int C = sh.C, n = sh.n, m = sh.m;
  const int src =
      clampi(bsearch<false>(ColLoad{rp.roff}, C, r, 0, C) - 1, 0, C - 1);
  const int eidx = clampi(rp.plb[src] + (r - rp.roff[src]), 0, C - 1);
  const size_t so = static_cast<size_t>(s);
  const size_t ps = static_cast<size_t>(src);
  const size_t es = static_cast<size_t>(eidx);
  for (int c = 0; c < n; ++c) {
    o.assign[so * n + c] = (c >= sh.d0 && c <= sh.d1)
                               ? rp.e_assign[es * n + c]
                               : p.assign[ps * n + c];
  }
  for (int c = 0; c < m; ++c) {
    o.lo[so * m + c] = p.lo[ps * m + c];
    o.hi[so * m + c] = p.hi[ps * m + c];
  }
  o.factor[s] = p.factor[src] * rp.e_factor[eidx];
  o.orig[s] = p.orig[src];
}

// Output slot s takes splice row u: the parent by an upper-bound search
// of u in soff, minus 1, and slab row poff[src] + u - soff[src], clipped
// to [0, nslab - 2] as the Pallas kernel clips it (the last slab row is
// the store's scratch row, never read).
__device__ __forceinline__ void splice_row(int s, int u, const Shape& sh,
                                           const Parent& p, const Splice& sp,
                                           const Out& o) {
  const int C = sh.C, n = sh.n, m = sh.m;
  const int src =
      clampi(bsearch<false>(ColLoad{sp.soff}, C, u, 0, C) - 1, 0, C - 1);
  const int w = sh.d1 - sh.d0 + 1;
  const int sidx = clampi(sp.poff[src] + (u - sp.soff[src]), 0,
                          sp.nslab - 2);
  const size_t so = static_cast<size_t>(s);
  const size_t ps = static_cast<size_t>(src);
  const size_t ss = static_cast<size_t>(sidx);
  for (int c = 0; c < n; ++c) {
    o.assign[so * n + c] = (c >= sh.d0 && c <= sh.d1)
                               ? sp.slab[ss * w + (c - sh.d0)]
                               : p.assign[ps * n + c];
  }
  for (int c = 0; c < m; ++c) {
    o.lo[so * m + c] = p.lo[ps * m + c];
    o.hi[so * m + c] = p.hi[ps * m + c];
  }
  o.factor[s] = p.factor[src];
  o.orig[s] = p.orig[src];
}

__global__ void fold_plan(const bool* __restrict__ active,
                          const int* __restrict__ rep_of_row,
                          const bool* __restrict__ e_valid,
                          const int* __restrict__ e_orig, int C,
                          int* __restrict__ plb, int* __restrict__ pcnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  replay_plan_row(i, active, rep_of_row, ExitKey{e_valid, e_orig, C}, C,
                  plb, pcnt);
}

__global__ void fold_slots(Shape sh, Parent p, Replay rp,
                           const int* __restrict__ needed_p, Out o,
                           long long* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= sh.C) return;
  const int needed = *needed_p;
  const int n_valid = needed < sh.C ? needed : sh.C;
  if (s == 0) {
    stats[0] = needed;
    stats[1] = 0;
    stats[2] = n_valid;
  }
  o.valid[s] = s < n_valid;
  if (s >= n_valid) return;
  replay_row(s, s, sh, p, rp, o);
}

__global__ void splice_plan(const bool* __restrict__ hit,
                            const int* __restrict__ plen, int C,
                            int* __restrict__ scnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  scnt[i] = hit[i] ? plen[i] : 0;
}

__global__ void splice_slots(Shape sh, Parent p, Splice sp,
                             const int* __restrict__ n_spl_p, Out o,
                             long long* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= sh.C) return;
  const int n_spl = *n_spl_p;
  const int n_valid = n_spl < sh.C ? n_spl : sh.C;
  if (s == 0) {
    stats[0] = 0;
    stats[1] = n_spl;
    stats[2] = n_valid;
  }
  o.valid[s] = s < n_valid;
  if (s >= n_valid) return;
  splice_row(s, s, sh, p, sp, o);
}

__global__ void merged_plan(const bool* __restrict__ active,
                            const int* __restrict__ rep_of_row,
                            const bool* __restrict__ e_valid,
                            const int* __restrict__ e_orig,
                            const bool* __restrict__ hit,
                            const int* __restrict__ plen, int C,
                            int* __restrict__ plb, int* __restrict__ pcnt,
                            int* __restrict__ scnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  replay_plan_row(i, active, rep_of_row, ExitKey{e_valid, e_orig, C}, C,
                  plb, pcnt);
  scnt[i] = hit[i] ? plen[i] : 0;
}

__global__ void merged_slots(Shape sh, Parent p, Replay rp, Splice sp,
                             const int* __restrict__ needed_p,
                             const int* __restrict__ n_spl_p, Out o,
                             long long* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int C = sh.C;
  if (s >= C) return;
  const int needed = *needed_p;
  const int n_spl = *n_spl_p;
  const int n1 = needed < C ? needed : C;
  const int n2 = n_spl < C ? n_spl : C;
  const int n_valid = n1 + n2 < C ? n1 + n2 : C;  // n1 + n2 <= 2C < 2^31
  if (s == 0) {
    stats[0] = needed;
    stats[1] = n_spl;
    stats[2] = static_cast<long long>(n1) + n2;
  }
  o.valid[s] = s < n_valid;
  if (s >= n_valid) return;
  if (s < n1) {
    replay_row(s, s, sh, p, rp, o);
  } else {
    splice_row(s, s - n1, sh, p, sp, o);
  }
}

}  // namespace ctj

namespace {

ctj::Parent parent_of(const void* assign, const void* factor,
                      const void* orig, const void* lo, const void* hi) {
  return ctj::Parent{static_cast<const int*>(assign),
                     static_cast<const long long*>(factor),
                     static_cast<const int*>(orig),
                     static_cast<const int*>(lo),
                     static_cast<const int*>(hi)};
}

ctj::Out out_of(void* assign, void* factor, void* valid, void* orig,
                void* lo, void* hi) {
  return ctj::Out{static_cast<int*>(assign), static_cast<long long*>(factor),
                  static_cast<bool*>(valid), static_cast<int*>(orig),
                  static_cast<int*>(lo), static_cast<int*>(hi)};
}

}  // namespace

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
      Shape{C, n, m, d0, d1},
      parent_of(p_assign, p_factor, p_orig, p_lo, p_hi),
      Replay{static_cast<const int*>(e_assign),
             static_cast<const long long*>(e_factor), plb, roff},
      needed, out_of(o_assign, o_factor, o_valid, o_orig, o_lo, o_hi),
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
      Shape{C, n, m, d0, d1},
      parent_of(p_assign, p_factor, p_orig, p_lo, p_hi),
      Splice{static_cast<const int*>(poff), static_cast<const int*>(slab),
             soff, nslab},
      n_spl, out_of(o_assign, o_factor, o_valid, o_orig, o_lo, o_hi),
      static_cast<long long*>(o_stats));
  return static_cast<int>(cudaGetLastError());
}

// Merged FOLD [replay | splice].  The exits must be valid-prefix compacted
// with nondecreasing orig, as for ctj_fold_replay; slab as for
// ctj_fold_splice.  Scratch layout (int32, 5C + 2 values): plb, pcnt,
// roff, scnt, soff (C each), needed, n_spliced (1 each).  Returns the
// first CUDA error.
extern "C" int ctj_fold_merged(
    const void* p_assign, const void* p_factor, const void* p_orig,
    const void* p_lo, const void* p_hi, const void* active,
    const void* rep_of_row, const void* e_assign, const void* e_factor,
    const void* e_valid, const void* e_orig, const void* hit,
    const void* poff, const void* plen, const void* slab, int C, int n,
    int m, int d0, int d1, int nslab, void* o_assign, void* o_factor,
    void* o_valid, void* o_orig, void* o_lo, void* o_hi, void* o_stats,
    void* scratch, void* stream_ptr) {
  using namespace ctj;
  if (C <= 0 || d0 < 0 || d1 < d0 || d1 >= n || nslab < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t c = static_cast<size_t>(C);
  int* plb = static_cast<int*>(scratch);
  int* pcnt = plb + c;
  int* roff = pcnt + c;
  int* scnt = roff + c;
  int* soff = scnt + c;
  int* needed = soff + c;
  int* n_spl = needed + 1;
  const int grid = blocks_for(C);

  merged_plan<<<grid, kThreads, 0, stream>>>(
      static_cast<const bool*>(active), static_cast<const int*>(rep_of_row),
      static_cast<const bool*>(e_valid), static_cast<const int*>(e_orig),
      static_cast<const bool*>(hit), static_cast<const int*>(plen), C, plb,
      pcnt, scnt);
  CTJ_CHECK(cudaGetLastError());
  CTJ_CHECK(launch_scan<int>(pcnt, roff, needed, C, false, stream));
  CTJ_CHECK(launch_scan<int>(scnt, soff, n_spl, C, false, stream));
  merged_slots<<<grid, kThreads, 0, stream>>>(
      Shape{C, n, m, d0, d1},
      parent_of(p_assign, p_factor, p_orig, p_lo, p_hi),
      Replay{static_cast<const int*>(e_assign),
             static_cast<const long long*>(e_factor), plb, roff},
      Splice{static_cast<const int*>(poff), static_cast<const int*>(slab),
             soff, nslab},
      needed, n_spl, out_of(o_assign, o_factor, o_valid, o_orig, o_lo, o_hi),
      static_cast<long long*>(o_stats));
  return static_cast<int>(cudaGetLastError());
}
