// Shared device pieces of the cached trie join's kernels: the bounded
// binary searches and the pieces of a single-pass device-wide scan
// (decoupled look-back).
//
// The TPU kernels ran their plan and scan steps once, in the first step of
// a sequential grid, into VMEM scratch that later steps read.  Hopper
// blocks run concurrently, so a scan across the whole chunk is done by
// blocks that pass their sums on through device memory: claim_tile /
// block_exclusive_sum / tile_prefix (or tile_prefix_pair, two scans at
// once), embedded in any kernel that works tile by tile (EXPAND's plan
// and slots, FOLD's plans, EMIT).  Scratch lives in device memory that
// the wrapper allocates.
#pragma once

#include <cuda_runtime.h>

namespace ctj {

constexpr int kThreads = 256;  // threads per block of the row launches
constexpr int kTile = 1024;    // values a scan tile (a block), one a thread

__host__ __device__ inline int blocks_for(int n) {
  return (n + kThreads - 1) / kThreads;
}

__host__ __device__ inline int tiles_for(int n) {
  return (n + kTile - 1) / kTile;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Column reader for bsearch.
struct ColLoad {
  const int* p;
  __device__ __forceinline__ int operator()(int i) const { return __ldg(p + i); }
};

// Fixed-trip bounded binary search over positions [lo, hi) of a column of
// n values: the twin of repro_torch.kernels.registry._bsearch, with the
// same trip count (ceil(log2(n + 1)) + 1, the bit length of n plus one),
// the same clipped midpoint and the same update, so the two agree bit for
// bit on any input.  kStrict gives the first position whose value is not
// < value (lower bound); otherwise not <= value (upper bound).
template <bool kStrict, typename Load>
__device__ __forceinline__ int bsearch(const Load& load, int n, int value,
                                       int lo, int hi) {
  if (n == 0) return lo;
  const int trips = (32 - __clz(n)) + 1;
  for (int t = 0; t < trips; ++t) {
    const bool go = lo < hi;
    const int mid = (lo + hi) >> 1;
    const int x = load(clampi(mid, 0, n - 1));
    const bool pred = kStrict ? (x < value) : (x <= value);
    if (go && pred) {
      lo = mid + 1;
    } else if (go) {
      hi = mid;
    }
  }
  return lo;
}

// Binary search over positions [lo, hi) of a column of n values, with as
// many trips as the window needs (the fixed-trip bsearch above takes as
// many as the whole column needs).  On a sorted window inside [0, n) it
// returns what bsearch returns; elsewhere it stays inside the column.
template <bool kStrict, typename Load>
__device__ __forceinline__ int bsearch_in(const Load& load, int n, int value,
                                          int lo, int hi) {
  if (n == 0) return lo;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int x = load(clampi(mid, 0, n - 1));
    if (kStrict ? (x < value) : (x <= value)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The first position p >= from of the sorted column [0, n) whose value is
// not < value (kStrict; not <= value otherwise), given that no position
// before `from` is: galloping steps of 1, 2, 4, ... from `from`, then a
// binary search inside the last step.  A range a few values long takes a
// few loads where a search of the whole column takes its bit length.
template <bool kStrict, typename Load>
__device__ __forceinline__ int search_from(const Load& load, int n, int value,
                                           int from) {
  int lo = from, hi = from;
  for (int step = 1; hi < n; step <<= 1) {
    const int x = load(hi);
    if (!(kStrict ? (x < value) : (x <= value))) break;
    lo = hi + 1;
    hi = from + step;
  }
  return bsearch_in<kStrict>(load, n, value, lo, hi < n ? hi : n);
}

// ---------------------------------------------------------------------------
// Single-pass device-wide scan by decoupled look-back (Merrill and
// Garland, 2016).  A kernel that embeds it works on tiles, each block of
// kBlock threads one tile, each thread one value x:
//
//   const int tile = claim_tile(ticket);
//   ... the thread's value x ...
//   unsigned total;
//   const unsigned in_tile = block_exclusive_sum<kBlock>(x, total);
//   const unsigned before = tile_prefix(status, tile, total);
//   // before + in_tile: the sum of every value before the thread's x
//
// The status words (one a tile) and the ticket are scratch that must be
// zero when the kernel starts (the wrapper clears them with one
// cudaMemsetAsync).  Sums are 32-bit and wrap, as an int32 cumsum does.
//
// Cost: a tile that has done its work waits, holding its SM slot, until
// every tile between it and the nearest published prefix has published
// its sum, and the prefixes pass down the line of tiles 32 a round trip.
// Large tiles keep the line short: tiles of kTile = 1024 values make
// 32,768 at 2^25 values.
// ---------------------------------------------------------------------------

// a status word: flag in the high 32 bits (0: nothing yet), sum below
constexpr unsigned long long kTileAggregate = 1ull << 32;  // the tile's sum
constexpr unsigned long long kTilePrefix = 2ull << 32;     // sum up to it

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The tile this block scans.  Tickets go out in the order blocks start,
// so every earlier tile belongs to a block that is already running and
// will publish its sum: the look-back cannot wait on a block that the
// card has not scheduled.  Call once a kernel, from every thread.
__device__ __forceinline__ int claim_tile(int* ticket) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1);
  __syncthreads();
  return tile;
}

// Exclusive sum of x over the kBlock threads of the block (at most
// 1024), in thread order; *total* gets the block's sum.  Call it from
// every thread; a second call must come after a __syncthreads that
// follows the first (tile_prefix's will do).
template <int kBlock>
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned x,
                                                        unsigned& total) {
  constexpr int kWarps = kBlock / 32;
  __shared__ unsigned warp_incl[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kWarps ? warp_incl[lane] : 0u;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_incl[lane] = w;
  }
  __syncthreads();
  total = warp_incl[kWarps - 1];
  return (warp > 0 ? warp_incl[warp - 1] : 0u) + incl - x;
}

// The look-back of one whole warp: the sum of every tile before `tile`,
// given this tile's sum, in every lane.  Publishes the sum as the tile's
// aggregate (a release store).  Then it reads the status words of the 32
// tiles before it in one coalesced load (lane l the tile l + 1 before) and
// adds the sums from the nearest tile back to the nearest one that holds
// its inclusive prefix, waiting only while a tile nearer than that one
// holds no flag yet (rereading the empty words); if the window holds no
// prefix it adds all 32 and steps a window further back.  Last it fences
// (acquire) and publishes this tile's inclusive prefix.
__device__ __forceinline__ unsigned warp_lookback(unsigned long long* status,
                                                  int tile, unsigned total) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  if (tile > 0) {
    if (lane == 0) st_release(status + tile, kTileAggregate | total);
    int pred = tile - 1 - lane;  // this lane's tile, nearest first
    unsigned long long w = pred >= 0 ? ld_relaxed(status + pred) : kTilePrefix;
    for (;;) {
      const unsigned long long flag = w & ~0xffffffffull;
      const unsigned has_prefix =
          __ballot_sync(0xffffffffu, flag == kTilePrefix);
      const unsigned empty = __ballot_sync(0xffffffffu, flag == 0);
      const int pre = has_prefix ? __ffs(has_prefix) - 1 : 32;
      const int gap = empty ? __ffs(empty) - 1 : 32;
      if (gap < pre) {  // a nearer tile has not published yet
        if (flag == 0) w = ld_relaxed(status + pred);
        continue;
      }
      unsigned x = lane <= pre ? static_cast<unsigned>(w) : 0u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      excl += x;
      if (pre < 32) break;
      pred -= 32;
      w = pred >= 0 ? ld_relaxed(status + pred) : kTilePrefix;
    }
    __threadfence();
  }
  if (lane == 0) st_release(status + tile, kTilePrefix | (excl + total));
  return excl;
}

// The sum of every tile before `tile`, given this tile's sum: warp 0
// looks back (warp_lookback) and passes the result to the block.  Call
// once a kernel, from every thread.
__device__ __forceinline__ unsigned tile_prefix(unsigned long long* status,
                                                int tile, unsigned total) {
  __shared__ unsigned before;
  if (threadIdx.x < 32) {
    const unsigned excl = warp_lookback(status, tile, total);
    if (threadIdx.x == 0) before = excl;
  }
  __syncthreads();
  return before;
}

// Two scans over the same tiles at once: warp 0 looks back over status0
// with total0, warp 1 over status1 with total1, side by side.  Returns
// the first scan's prefix; before1 gets the second's.  Call once a
// kernel, from every thread of a block of at least 64.
__device__ __forceinline__ unsigned tile_prefix_pair(
    unsigned long long* status0, unsigned long long* status1, int tile,
    unsigned total0, unsigned total1, unsigned& before1) {
  __shared__ unsigned before[2];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const unsigned excl = warp_lookback(warp == 0 ? status0 : status1, tile,
                                        warp == 0 ? total0 : total1);
    if ((threadIdx.x & 31) == 0) before[warp] = excl;
  }
  __syncthreads();
  before1 = before[1];
  return before[0];
}

// The slot tiles t < tiles_for(C) whose first slot t * kTile lies in
// [off, off + cnt) name `row` as their source (tile_src[t] = row): a row
// covering many tiles writes each of them.  Together with the offsets
// this lets a slot find its row by a search inside its tile's window.
__device__ __forceinline__ void mark_tiles(int* __restrict__ tile_src,
                                           int row, int off, int cnt, int C) {
  if (cnt <= 0 || off < 0) return;
  const long long end = static_cast<long long>(off) + cnt;
  for (long long t = (off + kTile - 1LL) / kTile;
       t < tiles_for(C) && t * kTile < end; ++t)
    tile_src[t] = row;
}

// The row whose offset range covers slot s (the last row with off <= s),
// for s < limit, the slots that hold a row: an upper-bound search of s in
// off[0, C) inside the window of rows that tile_src gives s's tile, from
// the row that covers its first slot to the one that covers the next
// tile's.  Rows of count 0 share the next row's offset, so the search
// steps past them.
__device__ __forceinline__ int slot_row(const int* __restrict__ off,
                                        const int* __restrict__ tile_src,
                                        int s, int limit, int C) {
  const int t = s / kTile;
  const int w_lo = clampi(tile_src[t], 0, C - 1);
  const int w_hi = (t + 1) * kTile < limit
                       ? clampi(tile_src[t + 1], 0, C - 1) + 1
                       : C;
  return clampi(bsearch_in<false>(ColLoad{off}, C, s, w_lo, w_hi) - 1, 0,
                C - 1);
}

}  // namespace ctj

// Return the first CUDA error of a sequence of launches.
#define CTJ_CHECK(expr)                      \
  do {                                       \
    const cudaError_t ctj_err_ = (expr);     \
    if (ctj_err_ != cudaSuccess) return ctj_err_; \
  } while (0)
