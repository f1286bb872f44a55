// EMIT: stable pack of a result chunk's valid rows to the front.
//
// Replaces: src/repro/kernels/emit/fused.py, function build — the fused
// Pallas EMIT of the TPU engine.
//
// What bounds it on an H100: memory and launch latency.  At the main
// path's chunk (C = 65536, n = 4) a call reads valid (1 byte a row) and
// the k valid rows of assign (16 bytes each), and writes k packed rows
// (16) and k: at most about 2.2 MB, 0.65 us at 3.35 TB/s, when every
// row is valid.
//
// Design.  The TPU kernel scanned valid once into VMEM in the first grid
// step and gathered each output slot's row by a search over the scan;
// here the scan is its own launch (inclusive, giving each valid row its
// rank and k, written straight into the output scalar) and a second
// launch scatters every valid row to its rank — stable, since ranks grow
// with the row, and free of the search.  Rows past k are not written.
#include "common.cuh"

namespace ctj {

__global__ void emit_pack(const int* __restrict__ assign,
                          const bool* __restrict__ valid,
                          const int* __restrict__ csum, int C, int n,
                          int* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C || !valid[i]) return;
  const size_t dst = static_cast<size_t>(csum[i] - 1);
  const size_t src = static_cast<size_t>(i);
  for (int c = 0; c < n; ++c) packed[dst * n + c] = assign[src * n + c];
}

}  // namespace ctj

// Scratch: csum, C int32 values.  Returns the first CUDA error.
extern "C" int ctj_emit(const void* assign, const void* valid, int C, int n,
                        void* o_packed, void* o_k, void* scratch,
                        void* stream_ptr) {
  using namespace ctj;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* csum = static_cast<int*>(scratch);
  CTJ_CHECK(launch_scan<bool>(static_cast<const bool*>(valid), csum,
                              static_cast<int*>(o_k), C, true, stream));
  emit_pack<<<blocks_for(C), kThreads, 0, stream>>>(
      static_cast<const int*>(assign), static_cast<const bool*>(valid), csum,
      C, n, static_cast<int*>(o_packed));
  return static_cast<int>(cudaGetLastError());
}
