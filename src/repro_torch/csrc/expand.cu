// EXPAND: one frontier expansion of order variable x_d.
//
// Replaces: src/repro/kernels/expand/fused.py, function build (kernel body
// _make_kernel) — the fused Pallas EXPAND of the TPU engine.
//
// What bounds it on an H100: memory and launch latency, not arithmetic.
// At the main path's chunk (C = 65536 rows, n = 4 assignment columns,
// m = 4 atoms) a call moves at most a full chunk in (61 bytes a row:
// assign 16, factor 8, valid 1, orig 4, lo and hi 32 — 4.0 MB), the trie
// columns it searches (4 bytes a value, about 0.4 MB each on the
// 92k-edge graph) and a full chunk out: about 9 MB, 2.7 us at
// 3.35 TB/s.  A real chunk needs far less, since only valid rows are
// planned and only survivors are written (chip_smoke.py counts the rows
// its data needs): a fraction of a microsecond, below the few
// microseconds that each launch costs.  So the launches and the passes
// over device memory are what to cut.  The binary searches are chains of
// dependent loads; they hide behind other warps, not behind arithmetic.
//
// Before: five launches, plan, a scan of the counts, slots, a scan of the
// survivor flags and compact.  Both scans ran in a single block of 1024
// threads walking all C values (about 39 us at C = 2^16, 5-20 ms at 2^25),
// and every slot staged its whole row in device scratch for compact to
// copy to its rank.
//
// Design.  Two launches, each a single pass that scans as it goes
// (decoupled look-back, common.cuh), after one memset of the look-back
// status words and tickets and one of o_valid.  Both work on tiles of
// kTile = 1024 rows or slots, one a thread: fewer tiles than 256-row ones
// (the look-back's line is 4x shorter), and one row a thread still fills
// every SM at C = 2^16.  Searches take as many trips as their window
// needs (bsearch_in, search_from), not as the whole column.
//   1. plan  — the guard run range [r0, r1) of each valid row by bounded
//              search of lo/hi over the run starts, cnt = r1 - r0, and
//              its exclusive prefix, the slot offset off; each row also
//              names itself as the source of every slot tile whose first
//              slot its candidates fill (tile_src), and the last tile
//              writes `needed` (the output scalar);
//   2. slots — a slot's source row is found by an upper-bound search of
//              off inside the window of rows that tile_src gives its tile
//              (about a thousand rows, in L1, not all C); the candidate,
//              its run and two bounded searches per other atom decide
//              whether it survives; the survivor flags' exclusive prefix
//              gives each survivor its rank, and the survivor writes its
//              row there straight from its parent row (its searches done
//              again: survivors are a few percent of the slots) and sets
//              valid[rank].  Ranks grow with the slot, so the order is
//              stable; they are dense, so valid is true exactly below the
//              survivor count.
// Tiles are claimed by an atomic ticket.  Scratch is the wrapper's
// (kernels/expand/cuda.py::scratch_layout, int32 values): the status words
// of the two scans (two values a tile), the two tickets, tile_src, then
// r0, cnt and off (C each).  Nothing is allocated here.
#include "common.cuh"

namespace ctj {

constexpr int kMaxOthers = 16;  // more: ctj_expand returns invalid value

// The other participating atoms' trie columns, passed by value.
struct OtherAtoms {
  const int* col[kMaxOthers];
  int len[kMaxOthers];
  int ai[kMaxOthers];
  int n;
};

__global__ void __launch_bounds__(kTile)
expand_plan(const int* __restrict__ lo, const int* __restrict__ hi,
            const bool* __restrict__ valid, const int* __restrict__ g_rs,
            int nruns, int C, int m, int g_ai, int* __restrict__ r0_out,
            int* __restrict__ cnt_out, int* __restrict__ off_out,
            int* __restrict__ tile_src, int* __restrict__ needed,
            unsigned long long* status, int* ticket) {
  const int tile = claim_tile(ticket);
  const int i = tile * kTile + threadIdx.x;
  int r0 = 0, cnt = 0;
  if (i < C && valid[i]) {
    const ColLoad rs{g_rs};
    const size_t row = static_cast<size_t>(i) * m + g_ai;
    const int v0 = lo[row], v1 = hi[row];
    r0 = bsearch<true>(rs, nruns, v0, 0, nruns);
    cnt = (v1 >= v0 ? search_from<true>(rs, nruns, v1, r0)
                    : bsearch<true>(rs, nruns, v1, 0, nruns)) - r0;
  }
  unsigned total;
  const unsigned in_tile = block_exclusive_sum<kTile>(cnt, total);
  const unsigned before = tile_prefix(status, tile, total);
  if (i < C) {
    const int off = static_cast<int>(before + in_tile);
    r0_out[i] = r0;
    cnt_out[i] = cnt;
    off_out[i] = off;
    mark_tiles(tile_src, i, off, cnt, C);
  }
  if (tile == tiles_for(C) - 1 && threadIdx.x == 0)
    *needed = static_cast<int>(before + total);
}

__global__ void __launch_bounds__(kTile)
expand_slots(const int* __restrict__ assign,
             const long long* __restrict__ factor,
             const int* __restrict__ orig, const int* __restrict__ lo,
             const int* __restrict__ hi, const int* __restrict__ g_col,
             const int* __restrict__ g_rs, OtherAtoms others,
             const int* __restrict__ r0, const int* __restrict__ cnt,
             const int* __restrict__ off, const int* __restrict__ tile_src,
             const int* __restrict__ needed_p, int C, int n, int m, int d,
             int g_ai, int nruns, int n_rows_g, unsigned long long* status,
             int* ticket, int* __restrict__ o_assign,
             long long* __restrict__ o_factor, bool* __restrict__ o_valid,
             int* __restrict__ o_orig, int* __restrict__ o_lo,
             int* __restrict__ o_hi) {
  const int tile = claim_tile(ticket);
  const int needed = *needed_p;
  const int limit = needed < C ? needed : C;  // slots that hold a candidate
  const int s0 = tile * kTile;
  // the rows that feed this tile's slots: from the one that fills its
  // first slot to the one that fills the next tile's
  int w_lo = 0, w_hi = C;
  if (s0 < limit) {
    w_lo = clampi(tile_src[tile], 0, C - 1);
    if (s0 + kTile < limit)
      w_hi = clampi(tile_src[tile + 1], 0, C - 1) + 1;
  }

  // slot s: does its candidate survive; if dst >= 0, write its row there
  auto slot = [&](int s, long long dst) -> bool {
    const int src =
        clampi(bsearch_in<false>(ColLoad{off}, C, s, w_lo, w_hi) - 1, 0, C - 1);
    const int delta = s - off[src];
    if (!(delta < cnt[src] && nruns > 0)) return false;
    const int k = clampi(r0[src] + delta, 0, nruns - 1);
    const int pos = g_rs[k];
    const int value = g_col[clampi(pos, 0, n_rows_g > 0 ? n_rows_g - 1 : 0)];
    const int* plo = lo + static_cast<size_t>(src) * m;
    const int* phi = hi + static_cast<size_t>(src) * m;
    int* olo = dst >= 0 ? o_lo + dst * m : nullptr;
    int* ohi = dst >= 0 ? o_hi + dst * m : nullptr;
    if (dst >= 0) {
      const int* pa = assign + static_cast<size_t>(src) * n;
      int* oa = o_assign + dst * n;
      for (int c = 0; c < n; ++c) oa[c] = c == d ? value : pa[c];
      for (int c = 0; c < m; ++c) {
        olo[c] = plo[c];
        ohi[c] = phi[c];
      }
      olo[g_ai] = pos;
      ohi[g_ai] = k + 1 < nruns ? g_rs[k + 1] : n_rows_g;
      o_factor[dst] = factor[src];
      o_orig[dst] = orig[src];
      o_valid[dst] = true;
    }
    for (int t = 0; t < others.n; ++t) {
      const int ai = others.ai[t];
      const ColLoad col{others.col[t]};
      const int a = bsearch_in<true>(col, others.len[t], value, plo[ai],
                                     phi[ai]);
      const int b = bsearch_in<false>(col, others.len[t], value, a, phi[ai]);
      if (!(a < b)) return false;
      if (dst >= 0) {
        olo[ai] = a;
        ohi[ai] = b;
      }
    }
    return true;
  };

  const int sl = s0 + threadIdx.x;
  const bool kept = sl < limit && slot(sl, -1);
  unsigned total;
  const unsigned in_tile = block_exclusive_sum<kTile>(kept ? 1u : 0u, total);
  const unsigned before = tile_prefix(status, tile, total);
  if (kept) slot(sl, static_cast<long long>(before) + in_tile);
}

}  // namespace ctj

// other_cols / other_lens / other_ais are HOST arrays of n_others entries
// (device column addresses, their lengths, their atom indices).  Scratch
// (int32 values, scratch_len of them; 8-byte aligned), as
// kernels/expand/cuda.py::scratch_layout lays it out, with tiles =
// ceil(C / 1024): the status words of the plan's scan and of the slots'
// scan (2 * tiles values each), the two tickets (2), tile_src (tiles),
// then r0, cnt and off (C each).  Returns the first CUDA error.
extern "C" int ctj_expand(
    const void* assign, const void* factor, const void* valid,
    const void* orig, const void* lo, const void* hi, const void* g_col,
    const void* g_rs, const void* other_cols, const void* other_lens,
    const void* other_ais, int n_others, int C, int n, int m, int d,
    int g_ai, int nruns, int n_rows_g, void* o_assign, void* o_factor,
    void* o_valid, void* o_orig, void* o_lo, void* o_hi, void* o_needed,
    void* scratch, long long scratch_len, void* stream_ptr) {
  using namespace ctj;
  if (n_others < 0 || n_others > kMaxOthers || C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = tiles_for(C);
  const long long zeroed = 4 * tiles + 2;  // both scans' words, tickets
  if (scratch_len < zeroed + tiles + 3LL * C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  OtherAtoms others{};
  others.n = n_others;
  for (int t = 0; t < n_others; ++t) {
    others.col[t] = static_cast<const int* const*>(other_cols)[t];
    others.len[t] = static_cast<const int*>(other_lens)[t];
    others.ai[t] = static_cast<const int*>(other_ais)[t];
  }
  int* sc = static_cast<int*>(scratch);
  unsigned long long* plan_status = reinterpret_cast<unsigned long long*>(sc);
  unsigned long long* slot_status = plan_status + tiles;
  int* tickets = sc + 4 * tiles;
  int* tile_src = sc + zeroed;
  int* r0 = tile_src + tiles;
  int* cnt = r0 + C;
  int* off = cnt + C;

  CTJ_CHECK(cudaMemsetAsync(sc, 0, sizeof(int) * zeroed, stream));
  CTJ_CHECK(cudaMemsetAsync(o_valid, 0, sizeof(bool) * C, stream));
  const int grid = static_cast<int>(tiles);
  expand_plan<<<grid, kTile, 0, stream>>>(
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const bool*>(valid), static_cast<const int*>(g_rs), nruns,
      C, m, g_ai, r0, cnt, off, tile_src, static_cast<int*>(o_needed),
      plan_status, tickets);
  CTJ_CHECK(cudaGetLastError());
  expand_slots<<<grid, kTile, 0, stream>>>(
      static_cast<const int*>(assign), static_cast<const long long*>(factor),
      static_cast<const int*>(orig), static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<const int*>(g_col),
      static_cast<const int*>(g_rs), others, r0, cnt, off, tile_src,
      static_cast<const int*>(o_needed), C, n, m, d, g_ai, nruns, n_rows_g,
      slot_status, tickets + 1, static_cast<int*>(o_assign),
      static_cast<long long*>(o_factor), static_cast<bool*>(o_valid),
      static_cast<int*>(o_orig), static_cast<int*>(o_lo),
      static_cast<int*>(o_hi));
  return static_cast<int>(cudaGetLastError());
}
