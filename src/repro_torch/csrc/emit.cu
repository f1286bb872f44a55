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
// Before: two launches, a scan of valid in a single block of 1024
// threads (one block walking all C values at about 0.6 ns a value: about
// 39 us of the call's 40.5 us of device time at C = 2^16), then a scatter
// of every valid row to its rank.
//
// Design.  The TPU kernel scanned valid once into VMEM in the first grid
// step and gathered each output slot's row by a search over the scan.
// Here one launch after one memset does it all in a single pass: tiles of
// kTile = 1024 rows, claimed by ticket (claim_tile), one row a thread; a
// row's rank is the number of valid rows before it, the sum of its tile's
// earlier rows (block_exclusive_sum) and of the earlier tiles (tile_prefix,
// decoupled look-back), and a valid row writes its n columns to
// packed[rank].  Ranks grow with the row, so the pack is stable; the last
// tile writes k.  Rows past k are not written.  The memset clears the
// look-back's status words and ticket, the only scratch.
#include "common.cuh"

namespace ctj {

__global__ void __launch_bounds__(kTile)
emit_pack(const int* __restrict__ assign, const bool* __restrict__ valid,
          int C, int n, int* __restrict__ packed, int* __restrict__ k,
          unsigned long long* status, int* ticket) {
  const int tile = claim_tile(ticket);
  const int i = tile * kTile + threadIdx.x;
  const bool keep = i < C && valid[i];
  unsigned total;
  const unsigned in_tile = block_exclusive_sum<kTile>(keep ? 1u : 0u, total);
  const unsigned before = tile_prefix(status, tile, total);
  if (keep) {
    const size_t dst = static_cast<size_t>(before + in_tile) * n;
    const size_t src = static_cast<size_t>(i) * n;
    for (int c = 0; c < n; ++c) packed[dst + c] = assign[src + c];
  }
  if (tile == tiles_for(C) - 1 && threadIdx.x == 0)
    *k = static_cast<int>(before + total);
}

}  // namespace ctj

// Scratch (int32 values, scratch_len of them; 8-byte aligned), as
// kernels/emit/cuda.py::scratch_layout lays it out, with tiles =
// ceil(C / 1024): the look-back's status words (2 * tiles values), then
// the ticket (1), all cleared here.  Returns the first CUDA error.
extern "C" int ctj_emit(const void* assign, const void* valid, int C, int n,
                        void* o_packed, void* o_k, void* scratch,
                        long long scratch_len, void* stream_ptr) {
  using namespace ctj;
  const long long tiles = tiles_for(C);
  if (C <= 0 || scratch_len < 2 * tiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* sc = static_cast<int*>(scratch);
  CTJ_CHECK(cudaMemsetAsync(sc, 0, sizeof(int) * (2 * tiles + 1), stream));
  emit_pack<<<static_cast<int>(tiles), kTile, 0, stream>>>(
      static_cast<const int*>(assign), static_cast<const bool*>(valid), C, n,
      static_cast<int*>(o_packed), static_cast<int*>(o_k),
      reinterpret_cast<unsigned long long*>(sc), sc + 2 * tiles);
  return static_cast<int>(cudaGetLastError());
}
