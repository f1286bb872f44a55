// FOLD, in its three arities (replay-only, splice-only and merged): one
// bracket close in evaluation mode.  The file holds one copy of each plan
// row and each gather (replay_plan_row, replay_row, splice_row) and three
// entry points, each a plan launch that scans as it goes and a slots
// launch.
//
// Replaces: src/repro/kernels/fold/fused.py, function build (kernel body
// _make_kernel) — the fused Pallas FOLD of the TPU engine, one
// pallas_call in three arities:
//   * replay-only (ctj_fold_replay; with_replay=True, with_splice=False):
//     for every active parent row i and every valid exit row e whose orig
//     is rep_of_row[i], one output row: the parent's assignment with
//     columns [d0, d1] taken from the exit row, factor = parent x exit;
//     stats = [needed, 0, min(needed, C)];
//   * splice-only (ctj_fold_splice; with_replay=False, with_splice=True):
//     each parent row i with a tier-2 payload hit contributes plen[i]
//     output rows: the parent's assignment with columns [d0, d1] taken
//     from slab rows poff[i] .. poff[i] + plen[i] - 1 (its cached block),
//     in parent-row order; factor, orig, lo and hi are the parent's;
//     stats = [0, n_spliced, min(n_spliced, C)];
//   * merged (ctj_fold_merged; both, which only the static executor
//     calls): [replay | splice], the replay rows truncated to
//     n1 = min(needed, C), then the splice rows in slots
//     n1 .. min(n1 + n_spliced, C) - 1; stats = [needed, n_spliced,
//     min(needed, C) + min(n_spliced, C)], the last figure uncapped so
//     that the executor can flag an overflow.
// The replay and merged arities require the exit chunk valid-prefix
// compacted with nondecreasing orig (the executor's sorted-exits
// invariant), so a representative's exits are one range found by search:
// no histogram or sort is needed.
//
// What bounds it on an H100: memory and launch latency.  At the main
// path's chunk (C = 65536, n = 4, m = 4) a replay call moves at most the
// parent chunk (60 bytes a row), active and rep_of_row (5), the exit
// chunk's assign, factor, valid and orig (29), a full output chunk (61)
// and the stats: 155 bytes a row, about 10.2 MB, 3.0 us at 3.35 TB/s; a
// real fold needs only the parents that replay, the exits they replay and
// min(needed, C) output rows (chip_smoke.py counts those): about 1 us.  At
// the static pass's C = 2^25 the merged arity moves at most 0.5-2 GB,
// 0.15-0.6 ms.
//
// Before: each arity ran a plan launch, one single-block scan a region
// (one block of 1024 threads walking all C values at about 0.6 ns a
// value, 39 us at C = 2^16 and 20-27 ms at 2^25) and a slots
// launch in which every slot inverted the offsets by a fixed-trip search
// over all C of them.  The scans were most of every call: 39 of 58.6 us of
// device time for replay at 2^16, two of them about 50 of 50.75 ms for
// merged at 2^25.
//
// Design.  Two launches after one memset (of the look-back's status words
// and ticket):
//   1. plan  — tiles of kTile = 1024 parent rows claimed by ticket, one
//              row a thread.  A row's count: the exit range [lb, ub) of
//              its representative (lb by a fixed-trip bounded search of
//              the exit keys ekey = valid ? clip(orig) : C, ub by
//              galloping from lb: a range is a few exits long), pcnt =
//              active ? ub - lb : 0; and/or scnt = hit ? plen : 0.  The
//              counts' exclusive prefix (block_exclusive_sum plus
//              tile_prefix, decoupled look-back; the merged arity runs
//              both scans side by side, tile_prefix_pair) gives the
//              offsets roff / soff.  Each row names itself as the source
//              of every slot tile whose first slot its range covers
//              (mark_tiles: a row covering many tiles writes each of
//              them, so skew is fine), and the last tile writes stats.
//   2. slots — one thread an output slot, in blocks of kThreads (the
//              slots scan nothing, so their block size is free of the
//              plan's tile).  A slot reads the totals from stats (no host
//              round trip), writes valid, and a slot below the valid count
//              finds its parent by an upper-bound search of the offsets
//              inside its tile's window of rows (slot_row: about a
//              thousand rows, in L1, not all C) and gathers its row.  In
//              the merged arity slots below n1 take replay pair s, the
//              rest splice row u = s - n1, whose window comes from the
//              splice tiles (tile_src over the u space): n1 need not be
//              tile-aligned.
// The offsets partition [0, needed) and [0, n_spliced), so the valid rows
// are a prefix by construction and no compaction pass is needed.  Sums
// are 32-bit and wrap as the plain version's int32 cumsum does.
#include "common.cuh"

namespace ctj {

// Sort key of exit row i: its representative, or C past the valid prefix.
struct ExitKey {
  const bool* valid;
  const int* orig;
  int C;
  __device__ __forceinline__ int operator()(int i) const {
    return valid[i] ? clampi(__ldg(orig + i), 0, C - 1) : C;
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

// What the replay plan reads: the parents' flags and representatives and
// the exits' sort keys.
struct ReplayIn {
  const bool* active;
  const int* rep_of_row;
  ExitKey key;
};

// What the replay gather reads: the exit rows and the replay plan.
struct Replay {
  const int* e_assign;
  const long long* e_factor;
  const int* plb;       // first exit of each parent's representative
  const int* roff;      // exclusive scan of the pair counts
  const int* tile_src;  // the parent covering each slot tile's first slot
};

// What the splice gather reads: the block pointers, the slab and the
// splice offsets.
struct Splice {
  const int* poff;
  const int* slab;
  const int* soff;      // exclusive scan of the spliced row counts
  const int* tile_src;  // the parent covering each splice tile's first row
  int nslab;
};

struct Shape {
  int C, n, m, d0, d1;
};

// Replay plan of parent row i: the pairs it replays, and in *lb the first
// exit of its representative (the exits are sorted by representative, so
// its exits are the range [lb, ub)).  An inactive row replays nothing and
// searches nothing.
__device__ __forceinline__ int replay_plan_row(int i, const ReplayIn& in,
                                               int C, int* lb) {
  *lb = 0;
  if (!in.active[i]) return 0;
  const int rep = clampi(in.rep_of_row[i], 0, C - 1);
  *lb = bsearch<true>(in.key, C, rep, 0, C);
  return search_from<false>(in.key, C, rep, *lb) - *lb;
}

// Output slot s takes replay pair r of parent src (found by slot_row):
// the parent's row with its (r - roff[src])-th exit.
__device__ __forceinline__ void replay_row(int s, int r, int src,
                                           const Shape& sh, const Parent& p,
                                           const Replay& rp, const Out& o) {
  const int C = sh.C, n = sh.n, m = sh.m;
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

// Output slot s takes splice row u of parent src (found by slot_row):
// slab row poff[src] + u - soff[src], clipped to [0, nslab - 2] as the
// Pallas kernel clips it (the last slab row is the store's scratch row,
// never read).
__device__ __forceinline__ void splice_row(int s, int u, int src,
                                           const Shape& sh, const Parent& p,
                                           const Splice& sp, const Out& o) {
  const int n = sh.n, m = sh.m;
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

__global__ void __launch_bounds__(kTile)
fold_plan(ReplayIn in, int C, int* __restrict__ plb, int* __restrict__ roff,
          int* __restrict__ tile_src, long long* __restrict__ stats,
          unsigned long long* status, int* ticket) {
  const int tile = claim_tile(ticket);
  const int i = tile * kTile + threadIdx.x;
  int lb = 0, cnt = 0;
  if (i < C) cnt = replay_plan_row(i, in, C, &lb);
  unsigned total;
  const unsigned in_tile = block_exclusive_sum<kTile>(cnt, total);
  const unsigned before = tile_prefix(status, tile, total);
  if (i < C) {
    const int off = static_cast<int>(before + in_tile);
    plb[i] = lb;
    roff[i] = off;
    mark_tiles(tile_src, i, off, cnt, C);
  }
  if (tile == tiles_for(C) - 1 && threadIdx.x == 0) {
    const int needed = static_cast<int>(before + total);
    stats[0] = needed;
    stats[1] = 0;
    stats[2] = needed < C ? needed : C;
  }
}

__global__ void fold_slots(Shape sh, Parent p, Replay rp, Out o,
                           const long long* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= sh.C) return;
  const int n_valid = static_cast<int>(stats[2]);
  o.valid[s] = s < n_valid;
  if (s >= n_valid) return;
  replay_row(s, s, slot_row(rp.roff, rp.tile_src, s, n_valid, sh.C), sh, p,
             rp, o);
}

__global__ void __launch_bounds__(kTile)
splice_plan(const bool* __restrict__ hit, const int* __restrict__ plen,
            int C, int* __restrict__ soff, int* __restrict__ tile_src,
            long long* __restrict__ stats, unsigned long long* status,
            int* ticket) {
  const int tile = claim_tile(ticket);
  const int i = tile * kTile + threadIdx.x;
  const int cnt = i < C && hit[i] ? plen[i] : 0;
  unsigned total;
  const unsigned in_tile = block_exclusive_sum<kTile>(cnt, total);
  const unsigned before = tile_prefix(status, tile, total);
  if (i < C) {
    const int off = static_cast<int>(before + in_tile);
    soff[i] = off;
    mark_tiles(tile_src, i, off, cnt, C);
  }
  if (tile == tiles_for(C) - 1 && threadIdx.x == 0) {
    const int n_spl = static_cast<int>(before + total);
    stats[0] = 0;
    stats[1] = n_spl;
    stats[2] = n_spl < C ? n_spl : C;
  }
}

__global__ void splice_slots(Shape sh, Parent p, Splice sp, Out o,
                             const long long* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= sh.C) return;
  const int n_valid = static_cast<int>(stats[2]);
  o.valid[s] = s < n_valid;
  if (s >= n_valid) return;
  splice_row(s, s, slot_row(sp.soff, sp.tile_src, s, n_valid, sh.C), sh, p,
             sp, o);
}

__global__ void __launch_bounds__(kTile)
merged_plan(ReplayIn in, const bool* __restrict__ hit,
            const int* __restrict__ plen, int C, int* __restrict__ plb,
            int* __restrict__ roff, int* __restrict__ soff,
            int* __restrict__ r_tile_src, int* __restrict__ s_tile_src,
            long long* __restrict__ stats, unsigned long long* r_status,
            unsigned long long* s_status, int* ticket) {
  const int tile = claim_tile(ticket);
  const int i = tile * kTile + threadIdx.x;
  int lb = 0, pcnt = 0, scnt = 0;
  if (i < C) {
    pcnt = replay_plan_row(i, in, C, &lb);
    scnt = hit[i] ? plen[i] : 0;
  }
  unsigned r_total, s_total, s_before;
  const unsigned r_in = block_exclusive_sum<kTile>(pcnt, r_total);
  __syncthreads();  // every thread has read the first sum's shared words
  const unsigned s_in = block_exclusive_sum<kTile>(scnt, s_total);
  const unsigned r_before =
      tile_prefix_pair(r_status, s_status, tile, r_total, s_total, s_before);
  if (i < C) {
    const int r_off = static_cast<int>(r_before + r_in);
    const int s_off = static_cast<int>(s_before + s_in);
    plb[i] = lb;
    roff[i] = r_off;
    soff[i] = s_off;
    mark_tiles(r_tile_src, i, r_off, pcnt, C);
    mark_tiles(s_tile_src, i, s_off, scnt, C);
  }
  if (tile == tiles_for(C) - 1 && threadIdx.x == 0) {
    const int needed = static_cast<int>(r_before + r_total);
    const int n_spl = static_cast<int>(s_before + s_total);
    const int n1 = needed < C ? needed : C;
    const int n2 = n_spl < C ? n_spl : C;
    stats[0] = needed;
    stats[1] = n_spl;
    stats[2] = static_cast<long long>(n1) + n2;
  }
}

__global__ void merged_slots(Shape sh, Parent p, Replay rp, Splice sp, Out o,
                             const long long* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int C = sh.C;
  if (s >= C) return;
  const int needed = static_cast<int>(stats[0]);
  const int n1 = needed < C ? needed : C;
  const long long both = stats[2];
  const int n_valid = both < C ? static_cast<int>(both) : C;
  o.valid[s] = s < n_valid;
  if (s >= n_valid) return;
  if (s < n1) {
    replay_row(s, s, slot_row(rp.roff, rp.tile_src, s, n1, C), sh, p, rp, o);
  } else {
    const int u = s - n1;
    splice_row(s, u, slot_row(sp.soff, sp.tile_src, u, n_valid - n1, C), sh,
               p, sp, o);
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

ctj::ReplayIn replay_in(const void* active, const void* rep_of_row,
                        const void* e_valid, const void* e_orig, int C) {
  return ctj::ReplayIn{
      static_cast<const bool*>(active), static_cast<const int*>(rep_of_row),
      ctj::ExitKey{static_cast<const bool*>(e_valid),
                   static_cast<const int*>(e_orig), C}};
}

}  // namespace

// Scratch (int32 values, scratch_len of them; 8-byte aligned), as
// kernels/fold/cuda.py::scratch_layout(C, "replay") lays it out, with
// tiles = ceil(C / 1024): the look-back's status words (2 * tiles
// values) and ticket (1), both cleared here, then tile_src (tiles), plb
// and roff (C each).  Returns the first CUDA error.
extern "C" int ctj_fold_replay(
    const void* p_assign, const void* p_factor, const void* p_orig,
    const void* p_lo, const void* p_hi, const void* active,
    const void* rep_of_row, const void* e_assign, const void* e_factor,
    const void* e_valid, const void* e_orig, int C, int n, int m, int d0,
    int d1, void* o_assign, void* o_factor, void* o_valid, void* o_orig,
    void* o_lo, void* o_hi, void* o_stats, void* scratch,
    long long scratch_len, void* stream_ptr) {
  using namespace ctj;
  const long long tiles = tiles_for(C);
  const long long zeroed = 2 * tiles + 1;
  if (C <= 0 || d0 < 0 || d1 < d0 || d1 >= n ||
      scratch_len < zeroed + tiles + 2LL * C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* sc = static_cast<int*>(scratch);
  int* tile_src = sc + zeroed;
  int* plb = tile_src + tiles;
  int* roff = plb + C;
  long long* stats = static_cast<long long*>(o_stats);

  CTJ_CHECK(cudaMemsetAsync(sc, 0, sizeof(int) * zeroed, stream));
  fold_plan<<<static_cast<int>(tiles), kTile, 0, stream>>>(
      replay_in(active, rep_of_row, e_valid, e_orig, C), C, plb, roff,
      tile_src, stats, reinterpret_cast<unsigned long long*>(sc),
      sc + 2 * tiles);
  CTJ_CHECK(cudaGetLastError());
  fold_slots<<<blocks_for(C), kThreads, 0, stream>>>(
      Shape{C, n, m, d0, d1},
      parent_of(p_assign, p_factor, p_orig, p_lo, p_hi),
      Replay{static_cast<const int*>(e_assign),
             static_cast<const long long*>(e_factor), plb, roff, tile_src},
      out_of(o_assign, o_factor, o_valid, o_orig, o_lo, o_hi), stats);
  return static_cast<int>(cudaGetLastError());
}

// Splice-only FOLD.  slab is (nslab, d1 - d0 + 1) int32, its last row the
// store's scratch row.  Scratch as scratch_layout(C, "splice"): the
// status words (2 * tiles) and ticket (1), cleared here, then tile_src
// (tiles) and soff (C).  Returns the first CUDA error.
extern "C" int ctj_fold_splice(
    const void* p_assign, const void* p_factor, const void* p_orig,
    const void* p_lo, const void* p_hi, const void* hit, const void* poff,
    const void* plen, const void* slab, int C, int n, int m, int d0, int d1,
    int nslab, void* o_assign, void* o_factor, void* o_valid, void* o_orig,
    void* o_lo, void* o_hi, void* o_stats, void* scratch,
    long long scratch_len, void* stream_ptr) {
  using namespace ctj;
  const long long tiles = tiles_for(C);
  const long long zeroed = 2 * tiles + 1;
  if (C <= 0 || d0 < 0 || d1 < d0 || d1 >= n || nslab < 2 ||
      scratch_len < zeroed + tiles + C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* sc = static_cast<int*>(scratch);
  int* tile_src = sc + zeroed;
  int* soff = tile_src + tiles;
  long long* stats = static_cast<long long*>(o_stats);

  CTJ_CHECK(cudaMemsetAsync(sc, 0, sizeof(int) * zeroed, stream));
  splice_plan<<<static_cast<int>(tiles), kTile, 0, stream>>>(
      static_cast<const bool*>(hit), static_cast<const int*>(plen), C, soff,
      tile_src, stats, reinterpret_cast<unsigned long long*>(sc),
      sc + 2 * tiles);
  CTJ_CHECK(cudaGetLastError());
  splice_slots<<<blocks_for(C), kThreads, 0, stream>>>(
      Shape{C, n, m, d0, d1},
      parent_of(p_assign, p_factor, p_orig, p_lo, p_hi),
      Splice{static_cast<const int*>(poff), static_cast<const int*>(slab),
             soff, tile_src, nslab},
      out_of(o_assign, o_factor, o_valid, o_orig, o_lo, o_hi), stats);
  return static_cast<int>(cudaGetLastError());
}

// Merged FOLD [replay | splice].  The exits must be valid-prefix compacted
// with nondecreasing orig, as for ctj_fold_replay; slab as for
// ctj_fold_splice.  Scratch as scratch_layout(C, "merged"): the replay
// and the splice scan's status words (2 * tiles each) and the ticket (1),
// cleared here, then the replay and the splice tile_src (tiles each),
// plb, roff and soff (C each).  Returns the first CUDA error.
extern "C" int ctj_fold_merged(
    const void* p_assign, const void* p_factor, const void* p_orig,
    const void* p_lo, const void* p_hi, const void* active,
    const void* rep_of_row, const void* e_assign, const void* e_factor,
    const void* e_valid, const void* e_orig, const void* hit,
    const void* poff, const void* plen, const void* slab, int C, int n,
    int m, int d0, int d1, int nslab, void* o_assign, void* o_factor,
    void* o_valid, void* o_orig, void* o_lo, void* o_hi, void* o_stats,
    void* scratch, long long scratch_len, void* stream_ptr) {
  using namespace ctj;
  const long long tiles = tiles_for(C);
  const long long zeroed = 4 * tiles + 1;
  if (C <= 0 || d0 < 0 || d1 < d0 || d1 >= n || nslab < 2 ||
      scratch_len < zeroed + 2 * tiles + 3LL * C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* sc = static_cast<int*>(scratch);
  unsigned long long* r_status = reinterpret_cast<unsigned long long*>(sc);
  unsigned long long* s_status = r_status + tiles;
  int* r_tile_src = sc + zeroed;
  int* s_tile_src = r_tile_src + tiles;
  int* plb = s_tile_src + tiles;
  int* roff = plb + C;
  int* soff = roff + C;
  long long* stats = static_cast<long long*>(o_stats);

  CTJ_CHECK(cudaMemsetAsync(sc, 0, sizeof(int) * zeroed, stream));
  merged_plan<<<static_cast<int>(tiles), kTile, 0, stream>>>(
      replay_in(active, rep_of_row, e_valid, e_orig, C),
      static_cast<const bool*>(hit), static_cast<const int*>(plen), C, plb,
      roff, soff, r_tile_src, s_tile_src, stats, r_status, s_status,
      sc + 4 * tiles);
  CTJ_CHECK(cudaGetLastError());
  merged_slots<<<blocks_for(C), kThreads, 0, stream>>>(
      Shape{C, n, m, d0, d1},
      parent_of(p_assign, p_factor, p_orig, p_lo, p_hi),
      Replay{static_cast<const int*>(e_assign),
             static_cast<const long long*>(e_factor), plb, roff, r_tile_src},
      Splice{static_cast<const int*>(poff), static_cast<const int*>(slab),
             soff, s_tile_src, nslab},
      out_of(o_assign, o_factor, o_valid, o_orig, o_lo, o_hi), stats);
  return static_cast<int>(cudaGetLastError());
}
