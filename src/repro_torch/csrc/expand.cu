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
// its data needs).  The binary searches are a few dozen dependent loads
// a slot; they hide behind other warps, not behind arithmetic.
//
// Design.  The TPU kernel ran its plan, expand, scan and compact steps in
// one sequential grid; on Hopper they are five launches on one stream:
//   1. plan     — one thread per row: the guard run range [r0, r1) by
//                 bounded search of lo/hi over the run starts, and cnt;
//   2. scan     — exclusive scan of cnt: slot offsets and `needed`
//                 (written straight into the output scalar);
//   3. slots    — one thread per output slot: invert the offsets by an
//                 upper-bound search, gather the candidate and its run,
//                 two bounded searches per other atom, and stage the row
//                 and its survivor flag in device scratch;
//   4. scan     — inclusive scan of the survivor flags;
//   5. compact  — one thread per staged slot scatters a survivor to its
//                 rank (stable, since ranks grow with the slot) and writes
//                 valid = slot < survivors for every output row.
// Scratch is the wrapper's; nothing is allocated here.  A slot that cannot
// survive writes only its flag, so staging traffic follows the survivors.
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

__global__ void expand_plan(const int* __restrict__ lo,
                            const int* __restrict__ hi,
                            const bool* __restrict__ valid,
                            const int* __restrict__ g_rs, int nruns, int C,
                            int m, int g_ai, int* __restrict__ r0_out,
                            int* __restrict__ cnt_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const ColLoad rs{g_rs};
  const size_t row = static_cast<size_t>(i) * m + g_ai;
  const int r0 = bsearch<true>(rs, nruns, lo[row], 0, nruns);
  const int r1 = bsearch<true>(rs, nruns, hi[row], 0, nruns);
  r0_out[i] = r0;
  cnt_out[i] = valid[i] ? r1 - r0 : 0;
}

__global__ void expand_slots(
    const int* __restrict__ assign, const long long* __restrict__ factor,
    const int* __restrict__ orig, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ g_col,
    const int* __restrict__ g_rs, OtherAtoms others,
    const int* __restrict__ r0, const int* __restrict__ cnt,
    const int* __restrict__ off, const int* __restrict__ needed_p, int C,
    int n, int m, int d, int g_ai, int nruns, int n_rows_g,
    int* __restrict__ st_assign, long long* __restrict__ st_factor,
    int* __restrict__ st_orig, int* __restrict__ st_lo,
    int* __restrict__ st_hi, int* __restrict__ st_ok) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C) return;
  const int needed = *needed_p;
  const int src =
      clampi(bsearch<false>(ColLoad{off}, C, s, 0, C) - 1, 0, C - 1);
  const int delta = s - off[src];
  if (!(s < needed && delta < cnt[src] && nruns > 0)) {
    st_ok[s] = 0;
    return;
  }
  const int k = clampi(r0[src] + delta, 0, nruns - 1);
  const int pos = g_rs[k];
  const int value = g_col[clampi(pos, 0, n_rows_g > 0 ? n_rows_g - 1 : 0)];
  const int run_end = k + 1 < nruns ? g_rs[k + 1] : n_rows_g;
  const int* plo = lo + static_cast<size_t>(src) * m;
  const int* phi = hi + static_cast<size_t>(src) * m;
  int* olo = st_lo + static_cast<size_t>(s) * m;
  int* ohi = st_hi + static_cast<size_t>(s) * m;
  for (int c = 0; c < m; ++c) {
    olo[c] = plo[c];
    ohi[c] = phi[c];
  }
  olo[g_ai] = pos;
  ohi[g_ai] = run_end;
  for (int t = 0; t < others.n; ++t) {
    const int ai = others.ai[t];
    const ColLoad col{others.col[t]};
    const int a = bsearch<true>(col, others.len[t], value, plo[ai], phi[ai]);
    const int b = bsearch<false>(col, others.len[t], value, a, phi[ai]);
    if (!(a < b)) {
      st_ok[s] = 0;
      return;
    }
    olo[ai] = a;
    ohi[ai] = b;
  }
  const int* pa = assign + static_cast<size_t>(src) * n;
  int* oa = st_assign + static_cast<size_t>(s) * n;
  for (int c = 0; c < n; ++c) oa[c] = pa[c];
  oa[d] = value;
  st_factor[s] = factor[src];
  st_orig[s] = orig[src];
  st_ok[s] = 1;
}

__global__ void expand_compact(
    const int* __restrict__ st_assign, const long long* __restrict__ st_factor,
    const int* __restrict__ st_orig, const int* __restrict__ st_lo,
    const int* __restrict__ st_hi, const int* __restrict__ st_ok,
    const int* __restrict__ csum, const int* __restrict__ total, int C,
    int n, int m, int* __restrict__ o_assign,
    long long* __restrict__ o_factor, bool* __restrict__ o_valid,
    int* __restrict__ o_orig, int* __restrict__ o_lo,
    int* __restrict__ o_hi) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= C) return;
  o_valid[j] = j < *total;
  if (!st_ok[j]) return;
  const size_t dst = static_cast<size_t>(csum[j] - 1);
  const size_t sj = static_cast<size_t>(j);
  for (int c = 0; c < n; ++c) o_assign[dst * n + c] = st_assign[sj * n + c];
  for (int c = 0; c < m; ++c) {
    o_lo[dst * m + c] = st_lo[sj * m + c];
    o_hi[dst * m + c] = st_hi[sj * m + c];
  }
  o_factor[dst] = st_factor[j];
  o_orig[dst] = st_orig[j];
}

}  // namespace ctj

// other_cols / other_lens / other_ais are HOST arrays of n_others entries
// (device column addresses, their lengths, their atom indices).  Scratch
// layout (int32, C * (6 + n + 2m) + 1 values): r0, cnt, off, ok, csum
// (C each), staged assign (C*n), orig (C), lo (C*m), hi (C*m), survivor
// total (1); st_factor is C int64 values.  Returns the first CUDA error.
extern "C" int ctj_expand(
    const void* assign, const void* factor, const void* valid,
    const void* orig, const void* lo, const void* hi, const void* g_col,
    const void* g_rs, const void* other_cols, const void* other_lens,
    const void* other_ais, int n_others, int C, int n, int m, int d,
    int g_ai, int nruns, int n_rows_g, void* o_assign, void* o_factor,
    void* o_valid, void* o_orig, void* o_lo, void* o_hi, void* o_needed,
    void* scratch, void* st_factor, void* stream_ptr) {
  using namespace ctj;
  if (n_others < 0 || n_others > kMaxOthers || C <= 0) {
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
  const size_t c = static_cast<size_t>(C);
  int* r0 = sc;
  int* cnt = r0 + c;
  int* off = cnt + c;
  int* ok = off + c;
  int* csum = ok + c;
  int* st_assign = csum + c;
  int* st_orig = st_assign + c * n;
  int* st_lo = st_orig + c;
  int* st_hi = st_lo + c * m;
  int* n_ok = st_hi + c * m;
  int* needed = static_cast<int*>(o_needed);
  long long* st_f = static_cast<long long*>(st_factor);
  const int grid = blocks_for(C);

  expand_plan<<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const bool*>(valid), static_cast<const int*>(g_rs), nruns,
      C, m, g_ai, r0, cnt);
  CTJ_CHECK(cudaGetLastError());
  CTJ_CHECK(launch_scan<int>(cnt, off, needed, C, false, stream));
  expand_slots<<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(assign), static_cast<const long long*>(factor),
      static_cast<const int*>(orig), static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<const int*>(g_col),
      static_cast<const int*>(g_rs), others, r0, cnt, off, needed, C, n, m,
      d, g_ai, nruns, n_rows_g, st_assign, st_f, st_orig, st_lo, st_hi, ok);
  CTJ_CHECK(cudaGetLastError());
  CTJ_CHECK(launch_scan<int>(ok, csum, n_ok, C, true, stream));
  expand_compact<<<grid, kThreads, 0, stream>>>(
      st_assign, st_f, st_orig, st_lo, st_hi, ok, csum, n_ok, C, n, m,
      static_cast<int*>(o_assign), static_cast<long long*>(o_factor),
      static_cast<bool*>(o_valid), static_cast<int*>(o_orig),
      static_cast<int*>(o_lo), static_cast<int*>(o_hi));
  return static_cast<int>(cudaGetLastError());
}
