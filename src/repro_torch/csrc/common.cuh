// Shared device pieces of the cached trie join's kernels: the bounded
// binary search and a single-block scan.
//
// The TPU kernels ran their plan and scan steps once, in the first step of
// a sequential grid, into VMEM scratch that later steps read.  Hopper
// blocks run concurrently, so here every such step is its own launch on
// the same stream, and the scratch lives in device memory that the
// wrapper allocates.
#pragma once

#include <cuda_runtime.h>

namespace ctj {

constexpr int kThreads = 256;       // threads per block of the row launches
constexpr int kScanThreads = 1024;  // the single block of the scan

__host__ __device__ inline int blocks_for(int n) {
  return (n + kThreads - 1) / kThreads;
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

// Scan of n values in one block of kScanThreads threads: out[i] is the
// sum of in[0..i] (inclusive) or of in[0..i) (exclusive), *total the sum
// of all n.  Tiles of kScanThreads values are read coalesced and scanned
// with warp shuffles; a running carry links the tiles.  Sums are int32 and
// wrap as the plain version's int32 cumsum does.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
block_scan(const T* __restrict__ in, int* __restrict__ out,
           int* __restrict__ total, int n, int inclusive) {
  __shared__ int warp_incl[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? static_cast<int>(in[i]) : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_incl[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_incl[lane] = w;
    }
    __syncthreads();
    const int incl = carry + x + (warp > 0 ? warp_incl[warp - 1] : 0);
    if (i < n) out[i] = inclusive ? incl : incl - v;
    __syncthreads();  // every thread has read carry before it moves on
    if (threadIdx.x == kScanThreads - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

template <typename T>
inline cudaError_t launch_scan(const T* in, int* out, int* total, int n,
                               bool inclusive, cudaStream_t stream) {
  block_scan<T><<<1, kScanThreads, 0, stream>>>(in, out, total, n,
                                                inclusive ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace ctj

// Return the first CUDA error of a sequence of launches.
#define CTJ_CHECK(expr)                      \
  do {                                       \
    const cudaError_t ctj_err_ = (expr);     \
    if (ctj_err_ != cudaSuccess) return ctj_err_; \
  } while (0)
