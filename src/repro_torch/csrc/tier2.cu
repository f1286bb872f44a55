// Tier-2 table ops: the batched probe and the batched insert of the
// set-associative tables of core/cache.py, each (S, W): S sets, W ways.
//
//   ctj_tier2_probe   first matching way of each valid row: hit, its value
//                     (or, on a payload probe, its block's offset and
//                     length), and the LRU touch of that way's stamp;
//   ctj_tier2_insert  `rounds` rounds of one elected writer per set, the
//                     victim chosen by the policy (first free way, else the
//                     LRU way, or the cheapest under "costaware").
//
// Replaces no Pallas kernel: the JAX package's probe and insert
// (src/repro/core/cache.py, _probe, _probe_payload and _insert) are XLA op
// chains, as the port's plain twins (kernels/tier2/plain.py) are PyTorch
// op chains, and both work on every row of the chunk.  Added because the
// static pass probes and inserts a chunk of C = 2^26 rows of which few are
// live: 6,236,814 valid rows are probed and 1,410,739 representatives
// (2.1%) offered for insert in a 4-cycle pass at graph500 scale, yet the
// op chains gathered (C, W) planes of the table eight times an insert, for
// two thirds of the pass's device time.
//
// What bounds it on an H100: bytes of the live rows' sets plus one mask
// byte a row.  A live row reads its key (8 bytes) and its set's W ways of
// used, key and stamp or cost (8 x 21 bytes at W = 8); a dead row reads
// only its mask byte (64 MB a round at C = 2^26, about 20 us at 3.35
// TB/s).  The probe writes C-wide hit and value planes (576 MiB at 2^26).
//
// Design.  One thread a row, which leaves at once on a dead row and never
// builds a (C, W) intermediate: it loops over its set's ways in device
// memory (any W).  An insert round is two launches.  The elect kernel
// reads the table as the round found it, computes the row's victim (a
// payload-less resident is refreshed in its own way) and the costaware
// admission test, stores the victim, and offers its row index to its set
// by an atomicMax on a per-set tag of (round, row): the highest admitted
// row wins, as in the op chain, and the round in the tag's high word
// spares a reset of the tags between rounds.  The write kernel, one
// thread a set, writes the winner's planes into (set, victim), clears the
// winner's remaining flag and counts admits and evictions a warp at a
// time.  Victims are all read before any write of the round, so the
// tables, stamps and counts equal the op chain's plane for plane.  The
// probe's touch is an atomicMax of the tick into the hit way's stamp;
// misses and invalid rows touch nothing (the op chain's max with -1 is a
// no-op on stamps, which are ticks >= 0).
#include "common.cuh"

namespace ctj {

constexpr long long kMix = -7046029254386353131LL;  // 0x9E3779B97F4A7C15

// Set of a key, as core/cache.py's _hash_sets: a wraparound multiply, an
// arithmetic shift, a wraparound abs (INT64_MIN stays itself) and a floor
// modulo.
__device__ __forceinline__ long long hash_set(long long key, int n_sets) {
  long long h = static_cast<long long>(static_cast<unsigned long long>(key) *
                                       static_cast<unsigned long long>(kMix));
  h ^= h >> 29;
  const long long a = static_cast<long long>(
      h < 0 ? 0ULL - static_cast<unsigned long long>(h)
            : static_cast<unsigned long long>(h));
  const long long r = a % n_sets;
  return r < 0 ? r + n_sets : r;
}

// One row a thread: the first way of the row's set holding its key (with a
// block, on a payload probe) answers it.
__global__ void __launch_bounds__(kThreads)
tier2_probe(const long long* __restrict__ tkeys,
            const long long* __restrict__ tvals,
            const bool* __restrict__ tused, int* tstamp,
            const int* __restrict__ tpoff, const int* __restrict__ tplen,
            const long long* __restrict__ keys,
            const bool* __restrict__ active, int C, int n_sets, int W,
            int tick, bool* __restrict__ hit, long long* __restrict__ vals,
            int* __restrict__ poff, int* __restrict__ plen) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= C) return;
  long long at = -1;
  if (active[r]) {
    const long long key = keys[r];
    const long long base = hash_set(key, n_sets) * W;
    for (int w = 0; w < W; ++w) {
      const long long i = base + w;
      if (tused[i] && tkeys[i] == key && (tplen == nullptr || tplen[i] >= 0)) {
        at = i;
        break;
      }
    }
  }
  hit[r] = at >= 0;
  if (tplen == nullptr) {
    vals[r] = at >= 0 ? tvals[at] : 0;
  } else {
    poff[r] = at >= 0 ? tpoff[at] : 0;
    plen[r] = at >= 0 ? tplen[at] : 0;
  }
  if (at >= 0) atomicMax(tstamp + at, tick);
}

constexpr unsigned kEvict = 0x80000000u;  // choice bit: the write evicts

// One row a thread, on the rows still remaining: blocked rows leave the
// insert, admitted rows store their victim (bit 31: an eviction) and offer
// themselves to their set under this round's tag.
__global__ void __launch_bounds__(kThreads)
tier2_elect(const long long* __restrict__ tkeys,
            const bool* __restrict__ tused,
            const int* __restrict__ tstamp,
            const long long* __restrict__ tcost,
            const int* __restrict__ tplen,
            const long long* __restrict__ keys,
            const long long* __restrict__ costs,
            const int* __restrict__ plen, bool* __restrict__ remaining,
            int C, int n_sets, int W, bool costaware, unsigned tag,
            unsigned* __restrict__ choice,
            unsigned long long* __restrict__ winner) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= C || !remaining[r]) return;
  const long long key = keys[r];
  const long long s = hash_set(key, n_sets);
  const long long base = s * W;
  const bool cand_pay = plen != nullptr && plen[r] >= 0;
  int free_way = -1, res_way = -1, contested = -1;
  long long least = 0;
  bool blocking = false;
  for (int w = 0; w < W; ++w) {
    const long long i = base + w;
    if (!tused[i]) {
      if (free_way < 0) free_way = w;
      continue;
    }
    if (tkeys[i] == key) {
      if (res_way < 0) res_way = w;
      // a resident blocks unless it lacks a block the candidate brings
      if (tplen == nullptr || tplen[i] >= 0 || !cand_pay) blocking = true;
    }
    // the contested way, taken only when every way is used: the first of
    // the least cost (costaware) or stamp (LRU)
    const long long v = costaware ? tcost[i] : tstamp[i];
    if (contested < 0 || v < least) {
      least = v;
      contested = w;
    }
  }
  if (blocking) {
    remaining[r] = false;
    return;
  }
  const bool any_free = free_way >= 0;
  const bool has_res = tplen != nullptr && res_way >= 0;
  const int victim = has_res ? res_way : (any_free ? free_way : contested);
  // costaware admission: refused rows stay remaining for the next round
  if (costaware && !has_res && !any_free && costs[r] < least) return;
  choice[r] = static_cast<unsigned>(victim) |
              (!any_free && !has_res ? kEvict : 0u);
  atomicMax(winner + s, (static_cast<unsigned long long>(tag) << 32) |
                            static_cast<unsigned>(r));
}

// One set a thread: the set's winner of this round writes its row into
// (set, victim) and leaves the insert; admits and evictions are counted a
// warp at a time.
__global__ void __launch_bounds__(kThreads)
tier2_write(long long* __restrict__ tkeys, long long* __restrict__ tvals,
            bool* __restrict__ tused, int* __restrict__ tstamp,
            long long* __restrict__ tcost, int* __restrict__ tpoff,
            int* __restrict__ tplen, const long long* __restrict__ keys,
            const long long* __restrict__ vals,
            const long long* __restrict__ costs,
            const int* __restrict__ poff, const int* __restrict__ plen,
            const unsigned long long* __restrict__ winner,
            const unsigned* __restrict__ choice,
            bool* __restrict__ remaining, int n_sets, int W, int tick,
            unsigned tag, int* __restrict__ counts) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  bool won = false, evict = false;
  if (s < n_sets) {
    const unsigned long long t = winner[s];
    if (static_cast<unsigned>(t >> 32) == tag) {
      const int r = static_cast<int>(t & 0xffffffffu);
      const unsigned c = choice[r];
      const long long i = static_cast<long long>(s) * W + (c & ~kEvict);
      tkeys[i] = keys[r];
      tvals[i] = vals[r];
      tcost[i] = costs[r];
      tstamp[i] = tick;
      tused[i] = true;
      if (tplen != nullptr) {
        tpoff[i] = poff[r];
        tplen[i] = plen[r];
      }
      remaining[r] = false;
      won = true;
      evict = (c & kEvict) != 0;
    }
  }
  const int n_won = __popc(__ballot_sync(0xffffffffu, won));
  const int n_evict = __popc(__ballot_sync(0xffffffffu, evict));
  if ((threadIdx.x & 31) == 0) {
    if (n_won) atomicAdd(counts, n_won);
    if (n_evict) atomicAdd(counts + 1, n_evict);
  }
}

}  // namespace ctj

// The probe.  Tables (S, W) = (n_sets, W), contiguous; stamp is updated in
// place (the wrapper passes a copy).  With tplen (and tpoff, poff, plen)
// set it is the payload probe: a hit needs a block, and writes poff and
// plen; else it writes vals.  Returns the first CUDA error.
extern "C" int ctj_tier2_probe(const void* tkeys, const void* tvals,
                               const void* tused, void* tstamp,
                               const void* tpoff, const void* tplen,
                               const void* keys, const void* active, int C,
                               int n_sets, int W, int tick, void* o_hit,
                               void* o_vals, void* o_poff, void* o_plen,
                               void* stream_ptr) {
  using namespace ctj;
  if (C < 0 || n_sets <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  tier2_probe<<<blocks_for(C), kThreads, 0, stream>>>(
      static_cast<const long long*>(tkeys),
      static_cast<const long long*>(tvals), static_cast<const bool*>(tused),
      static_cast<int*>(tstamp), static_cast<const int*>(tpoff),
      static_cast<const int*>(tplen), static_cast<const long long*>(keys),
      static_cast<const bool*>(active), C, n_sets, W, tick,
      static_cast<bool*>(o_hit), static_cast<long long*>(o_vals),
      static_cast<int*>(o_poff), static_cast<int*>(o_plen));
  return static_cast<int>(cudaGetLastError());
}

// The insert, in place on the tables the wrapper copied.  tpoff, tplen,
// poff and plen are all set (the payload planes ride the election) or all
// null.  Scratch: remaining (C bools, holding the active mask on entry),
// choice (C unsigned), winner (n_sets 64-bit tags, cleared here) and counts
// (admits, evictions: 2 ints, cleared here).  policy: 0 direct, 1
// setassoc, 2 costaware.  Returns the first CUDA error.
extern "C" int ctj_tier2_insert(void* tkeys, void* tvals, void* tused,
                                void* tstamp, void* tcost, void* tpoff,
                                void* tplen, const void* keys,
                                const void* vals, const void* costs,
                                const void* poff, const void* plen, int C,
                                int n_sets, int W, int tick, int policy,
                                int rounds, void* remaining, void* choice,
                                void* winner, void* counts,
                                void* stream_ptr) {
  using namespace ctj;
  if (C < 0 || n_sets <= 0 || W <= 0 || policy < 0 || policy > 2 ||
      (tplen == nullptr) != (plen == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  CTJ_CHECK(cudaMemsetAsync(counts, 0, 2 * sizeof(int), stream));
  if (C == 0) return 0;
  CTJ_CHECK(cudaMemsetAsync(winner, 0,
                            static_cast<size_t>(n_sets) * sizeof(long long),
                            stream));
  auto* ck = static_cast<long long*>(tkeys);
  auto* cv = static_cast<long long*>(tvals);
  auto* cu = static_cast<bool*>(tused);
  auto* cs = static_cast<int*>(tstamp);
  auto* cc = static_cast<long long*>(tcost);
  auto* cpo = static_cast<int*>(tpoff);
  auto* cpl = static_cast<int*>(tplen);
  auto* rem = static_cast<bool*>(remaining);
  auto* ch = static_cast<unsigned*>(choice);
  auto* win = static_cast<unsigned long long*>(winner);
  for (int k = 0; k < (rounds > 1 ? rounds : 1); ++k) {
    const unsigned tag = static_cast<unsigned>(k + 1);
    tier2_elect<<<blocks_for(C), kThreads, 0, stream>>>(
        ck, cu, cs, cc, cpl, static_cast<const long long*>(keys),
        static_cast<const long long*>(costs), static_cast<const int*>(plen),
        rem, C, n_sets, W, policy == 2, tag, ch, win);
    CTJ_CHECK(cudaGetLastError());
    tier2_write<<<blocks_for(n_sets), kThreads, 0, stream>>>(
        ck, cv, cu, cs, cc, cpo, cpl, static_cast<const long long*>(keys),
        static_cast<const long long*>(vals),
        static_cast<const long long*>(costs), static_cast<const int*>(poff),
        static_cast<const int*>(plen), win, ch, rem, n_sets, W, tick, tag,
        static_cast<int*>(counts));
    CTJ_CHECK(cudaGetLastError());
  }
  return 0;
}
