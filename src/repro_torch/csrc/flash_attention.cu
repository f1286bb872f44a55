// Flash attention, forward: softmax(q k^T / sqrt(Dh)) v under the causal,
// sliding-window and sequence-end masks, with grouped-query heads.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, function
// flash_attention_pallas (kernel body _flash_kernel) — FlashAttention-2
// over a grid (batch x KV head, q blocks, kv blocks) whose kv axis runs in
// order, the running max m, sum l and accumulator kept in VMEM scratch
// from one kv step to the next.
//
// What bounds it on an H100: operations.  A causal prefill of qwen2.5-3b
// (B = 4, T = S = 2048, H = 16, Hkv = 2, Dh = 128) does 4·B·H·Dh FLOPs for
// each of the 2,098,176 unmasked (query, key) pairs of a head: 69 GFLOP,
// 0.07 ms at the 989 TFLOP/s bf16 tensor-core peak, against 75.5 MB of
// q, k, v and o in bf16 (33.6 MB each for q and o, 4.2 MB each for k and
// v: 0.023 ms at 3.35 TB/s).
//
// Design.  The Pallas grid is not carried over: Hopper blocks run
// concurrently and in no order, so no state may pass from one block to
// the next.  One CTA owns kRows query rows of one (batch, KV head): the
// rows are the (position, query head) pairs of that KV head's group,
// flattened position-major, so one K/V tile in shared memory serves all
// G = H / Hkv query heads that read it (GQA without copies: q, k, v and o
// are read and written in place, in their (B, T, H, Dh) and
// (B, S, Hkv, Dh) layouts, query head h reading KV head h / G).  The CTA
// loops over the kv tiles itself, with m, l and the accumulator in
// registers.  It visits only the tiles that some row of it can see:
// tiles wholly above the causal diagonal or wholly before the window are
// skipped.  That gives the reference's result: a tile that is all masked
// for a row adds p = exp(-1e30 - (-1e30)) = 1 while m is still -1e30,
// and the first valid key wipes that out with alpha = 0; in the model
// every row sees at least its own position.  (A row that sees no key at
// all, which the model never makes, gives 0 here and the mean of v there.)
//
// The numbers are the reference's: q, k and v are upcast to fp32 in
// shared memory; scores are fp32 sums of products, times 1/sqrt(Dh), and
// -1e30 where masked; m, l and the accumulator are fp32; the output is
// acc / max(l, 1e-30), rounded to q's type.  Both products run on the
// fp32 FMA units: 256 threads, each a 4 x 4 block of the 64 x 64 score
// tile and 4 rows x Dh/16 columns of the output, read from padded
// shared-memory rows (no bank conflicts).  That is simple and exact in
// fp32, and far from the tensor-core peak that bounds the work; wmma /
// wgmma tiles with TMA loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace ctj {
namespace fa {

constexpr int kRows = 64;       // query rows (position x query head) a CTA
constexpr int kKeys = 64;       // keys a kv tile
constexpr int kFaThreads = 256;  // 16 x 16 threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Shared memory (floats): Q rows and K rows padded to Dh + 1 so that a
// column read by 16 threads hits 16 banks; V rows unpadded (read along
// a row); P padded likewise.
template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kRows) * (DH + 1) + size_t(kKeys) * (DH + 1) +
                          size_t(kKeys) * DH + size_t(kRows) * (kKeys + 1));
}

template <typename Elem, int DH>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_fwd(const Elem* __restrict__ q, const Elem* __restrict__ k,
          const Elem* __restrict__ v, Elem* __restrict__ o, int T, int S,
          int H, int Hkv, int causal, int window, int q_offset, float scale) {
  constexpr int LQ = DH + 1;
  constexpr int LP = kKeys + 1;
  constexpr int DC = DH / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kRows][LQ]
  float* Ks = Qs + kRows * LQ;        // [kKeys][LQ]
  float* Vs = Ks + kKeys * LQ;        // [kKeys][DH]
  float* Ps = Vs + kKeys * DH;        // [kRows][LP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // score columns tx + 16j, output columns tx + 16c
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int n_rows = T * G;  // the wrapper keeps T * H below 2^31
  const int f0 = blockIdx.x * kRows;

  // the q rows of this CTA: row r is (position (f0 + r) / G, query head
  // hkv * G + (f0 + r) % G)
  for (int idx = tid; idx < kRows * DH; idx += kFaThreads) {
    const int r = idx / DH, d = idx % DH;
    const int f = f0 + r;
    float x = 0.f;
    if (f < n_rows) {
      const int t = f / G, h = hkv * G + f % G;
      x = to_float(q[((b * (long long)T + t) * H + h) * DH + d]);
    }
    Qs[r * LQ + d] = x;
  }

  int qpos[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q_offset + (f0 + ty * 4 + i) / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // the keys some row of this CTA can see
  const int f_last = (f0 + kRows < n_rows ? f0 + kRows : n_rows) - 1;
  const int qpos_min = q_offset + f0 / G;
  const int qpos_max = q_offset + f_last / G;
  int k_end = S;
  if (causal && qpos_max + 1 < k_end) k_end = qpos_max + 1;
  int k_begin = 0;
  if (window > 0 && qpos_min - window + 1 > 0) k_begin = qpos_min - window + 1;

  const long long kv_row = (long long)Hkv * DH;  // elements between keys
  const Elem* kb = k + ((long long)b * S * Hkv + hkv) * DH;
  const Elem* vb = v + ((long long)b * S * Hkv + hkv) * DH;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    for (int idx = tid; idx < kKeys * DH; idx += kFaThreads) {
      const int j = idx / DH, d = idx % DH;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < S) {
        kx = to_float(kb[key * kv_row + d]);
        vx = to_float(vb[key * kv_row + d]);
      }
      Ks[j * LQ + d] = kx;
      Vs[j * DH + d] = vx;
    }
    __syncthreads();

    // scores of rows ty*4+i, keys k0 + tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: the 16 threads of a row are 16 lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        bool ok = key < S;
        if (causal) ok = ok && key <= qpos[i];
        if (window > 0) ok = ok && key > qpos[i] - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vx = Vs[j * DH + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vx, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty * 4 + i;
    if (f >= n_rows) continue;
    const int t = f / G, h = hkv * G + f % G;
    Elem* out = o + ((b * (long long)T + t) * H + h) * DH;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) store(out + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename Elem, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int T, int S, int H, int Hkv, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  CTJ_CHECK(cudaFuncSetAttribute(flash_fwd<Elem, DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)));
  const int rows = T * (H / Hkv);
  const dim3 grid((rows + kRows - 1) / kRows, Hkv, B);
  flash_fwd<Elem, DH><<<grid, kFaThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<Elem*>(o), T, S, H, Hkv,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v,
                     void* o, int B, int T, int S, int H, int Hkv, int causal,
                     int window, int q_offset, float scale,
                     cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch<Elem, 16>(q, k, v, o, B, T, S, H, Hkv, causal, window,
                              q_offset, scale, st);
    case 32:
      return launch<Elem, 32>(q, k, v, o, B, T, S, H, Hkv, causal, window,
                              q_offset, scale, st);
    case 64:
      return launch<Elem, 64>(q, k, v, o, B, T, S, H, Hkv, causal, window,
                              q_offset, scale, st);
    case 128:
      return launch<Elem, 128>(q, k, v, o, B, T, S, H, Hkv, causal, window,
                               q_offset, scale, st);
    case 160:
      return launch<Elem, 160>(q, k, v, o, B, T, S, H, Hkv, causal, window,
                               q_offset, scale, st);
    case 256:
      return launch<Elem, 256>(q, k, v, o, B, T, S, H, Hkv, causal, window,
                               q_offset, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fa
}  // namespace ctj

// o = attention(q, k, v): q and o (B, T, H, Dh), k and v (B, S, Hkv, Dh),
// all contiguous, bf16 (bf16 != 0) or fp32; Dh in {16, 32, 64, 128, 160,
// 256}; window <= 0 means no window.  Returns the first CUDA error.
extern "C" int ctj_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int B, int T,
                                   int S, int H, int Hkv, int Dh, int bf16,
                                   int causal, int window, int q_offset,
                                   float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ctj::fa::dispatch<__nv_bfloat16>(Dh, q, k, v, o, B, T, S, H, Hkv,
                                            causal, window, q_offset, scale,
                                            st);
  return ctj::fa::dispatch<float>(Dh, q, k, v, o, B, T, S, H, Hkv, causal,
                                  window, q_offset, scale, st);
}
