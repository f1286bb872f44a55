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
// 0.0695 ms at the 989 TFLOP/s bf16 tensor-core peak, against 75.5 MB of
// q, k, v and o in bf16 (33.6 MB each for q and o, 4.2 MB each for k and
// v: 0.023 ms at 3.35 TB/s).  So the products have to run on the tensor
// cores, and the loads have to hide behind them.
//
// Rows and tiles (both paths).  The Pallas grid is not carried over:
// Hopper blocks run concurrently and in no order, so no state may pass
// from one block to the next.  One CTA owns a tile of query rows (64;
// 128 in the bf16 path at Dh <= 128) of one (batch, KV head): the rows
// are the (position, query head) pairs of that KV head's group,
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
// all, which the model never makes, gives 0 here and the mean of v
// there.)  Scores are -1e30 where masked; m, l and the accumulator are
// fp32; the output is acc / max(l, 1e-30), rounded to q's type.
//
// bf16 (flash_fwd_tc, the model's path).  4 warps run both products as
// mma.sync.m16n8k16 bf16 tensor-core instructions with fp32 accumulators.
// The ldmatrix reads of shared memory, not the tensor cores, set the pace
// of such a kernel, so at Dh <= 128 each warp owns two 16-row m-tiles
// (a CTA 128 rows) and every K or V fragment it reads serves both; at
// Dh >= 160 the larger accumulator leaves room for one (a CTA 64 rows).
//   * S = Q K^T: Q fragments are read from shared memory by ldmatrix at
//     each k-step (beside two m-tiles' accumulators they do not fit in
//     registers; measured on an H100, two m-tiles with Q re-read beat one
//     m-tile with Q held in registers, PERF.md), K fragments likewise.
//     Products of bf16 values are exact in fp32, so only the order of the
//     sums differs from the reference.
//   * the online softmax runs on the accumulator fragments in registers:
//     a row's max takes two __shfl_xor_sync within its quad of lanes, and
//     its sum stays a per-lane partial until the end.  Masks are applied
//     per element, and only on tiles that cross the diagonal, the window's
//     edge or S.  Scores are kept in base 2 (scaled by log2(e) / sqrt(Dh))
//     so that p = exp2(s - m).
//   * O += P V: the score fragments are repacked in registers as the A
//     operand with p rounded to bf16 (as FlashAttention-2 does; nothing
//     goes through shared memory); l is summed from the fp32 p.  V
//     fragments come from ldmatrix.trans of the [key][d] tile.  This
//     rounding of p is the one numerical change from the reference.
//   * K/V tiles are double-buffered in shared memory and filled by
//     cp.async, 16 bytes a thread, so that the next tile's copy overlaps
//     this tile's products.  Rows are padded by 16 bytes, which puts the 8
//     rows an ldmatrix reads in 8 distinct 4-bank groups (no conflicts).
//     At Dh = 128 that is 102 KB a CTA (Q, and two stages of K and V with
//     64 keys), so two CTAs share an SM; Dh = 256 takes 32-key tiles.
//   * the heaviest causal row tiles launch first (the linear block index
//     runs over the row tiles from the last), so the diagonal's imbalance
//     leaves no tail of long CTAs.
// Left to a later design: wgmma (warpgroup products from shared memory,
// the only way to the full tensor-core rate), TMA loads behind mbarriers
// and warp specialisation (a producer warp keeping loads in flight).
//
// fp32 (flash_fwd, the fp32-compute checks): q, k and v are upcast in
// shared memory and both products run on the fp32 FMA units, 256 threads
// each a 4 x 4 block of the 64 x 64 score tile and 4 rows x Dh/16 columns
// of the output, read from padded shared-memory rows.  Simple and exact in
// fp32; the tensor cores take no fp32 operands.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace ctj {
namespace fa {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;       // query rows a CTA (fp32 path)
constexpr int kKeys = 64;       // keys a kv tile (fp32 path)
constexpr int kFaThreads = 256;  // 16 x 16 threads (fp32 path)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync) and cp.async
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps

template <int DH>
struct Tc {
  // 16-row m-tiles a warp: two share each K and V fragment read from
  // shared memory, where the accumulators leave room for them
  static constexpr int kMTiles = DH <= 128 ? 2 : 1;
  static constexpr int kRows = 64 * kMTiles;        // query rows a CTA
  static constexpr int kKeys = DH > 160 ? 32 : 64;  // keys a kv tile
  static constexpr int kLd = DH + 8;                // padded row (elements)
  static constexpr int kChunks = DH / 8;            // 16-byte chunks a row
  static constexpr int kKSteps = DH / 16;    // k-steps of Q K^T
  static constexpr int kSTiles = kKeys / 8;  // 8-key n-tiles of S
  static constexpr int kOTiles = DH / 8;     // 8-column n-tiles of O
  static constexpr int kPSteps = kKeys / 16;  // k-steps of P V
  // Q, then two stages of K, then two stages of V
  static constexpr size_t kSmem =
      sizeof(bf16) * size_t(kRows + 4 * kKeys) * kLd;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where !full
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8, fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16 (round to nearest even), the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Fragments (PTX ISA, mma.m16n8k16): lane = 4 g + c holds, of a 16 x 8
// accumulator, rows g (elements 0, 1) and g + 8 (elements 2, 3) at columns
// 2c and 2c + 1; of the A operand, rows g and g + 8 at columns 2c, 2c + 1
// and 2c + 8, 2c + 9; of B, column g at rows 2c, 2c + 1 and 2c + 8, 2c + 9.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int T, int S,
             int H, int Hkv, int B, int n_tiles, int causal, int window,
             int q_offset, float scale_log2) {
  using C = Tc<DH>;
  constexpr int LD = C::kLd, KEYS = C::kKeys, CH = C::kChunks;
  constexpr int MT = C::kMTiles, ROWS = C::kRows;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);  // [ROWS][LD]
  bf16* Ks = Qs + ROWS * LD;                    // [2][KEYS][LD]
  bf16* Vs = Ks + 2 * KEYS * LD;                // [2][KEYS][LD]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  // the block index runs over (batch, KV head) fastest and over the row
  // tiles from the last (the longest under the causal mask) to the first
  const int bh = blockIdx.x % (B * Hkv);
  const int tile = n_tiles - 1 - blockIdx.x / (B * Hkv);
  const int hkv = bh % Hkv, b = bh / Hkv;
  const int G = H / Hkv;
  const int n_rows = T * G;  // the wrapper keeps T * H below 2^31
  const int f0 = tile * ROWS;

  // the q rows of this CTA: row r is (position (f0 + r) / G, query head
  // hkv * G + (f0 + r) % G); rows past T * G are zeros
  for (int i = tid; i < ROWS * CH; i += kTcThreads) {
    const int r = i / CH, ch = i % CH, f = f0 + r;
    const bool in = f < n_rows;
    const bf16* src = q;
    if (in) {
      const int t = f / G, h = hkv * G + f % G;
      src = q + ((b * (long long)T + t) * H + h) * DH + ch * 8;
    }
    cp_async16(smem_u32(Qs + r * LD + ch * 8), src, in);
  }

  // the keys some row of this CTA can see
  const int f_last = (f0 + ROWS < n_rows ? f0 + ROWS : n_rows) - 1;
  const int qpos_min = q_offset + f0 / G;
  const int qpos_max = q_offset + f_last / G;
  int k_end = S;
  if (causal && qpos_max + 1 < k_end) k_end = qpos_max + 1;
  int k_begin = 0;
  if (window > 0 && qpos_min - window + 1 > 0) k_begin = qpos_min - window + 1;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + KEYS - 1) / KEYS : 0;

  const long long kv_row = (long long)Hkv * DH;  // elements between keys
  const bf16* kb = k + ((long long)b * S * Hkv + hkv) * DH;
  const bf16* vb = v + ((long long)b * S * Hkv + hkv) * DH;
  // keys k0 .. k0 + KEYS - 1 into stage st; keys past S are zeros
  auto load_kv = [&](int k0, int st) {
    bf16* ks = Ks + st * KEYS * LD;
    bf16* vs = Vs + st * KEYS * LD;
    for (int i = tid; i < KEYS * CH; i += kTcThreads) {
      const int j = i / CH, ch = i % CH, key = k0 + j;
      const bool in = key < S;
      const long long off = in ? key * kv_row + ch * 8 : 0;
      cp_async16(smem_u32(ks + j * LD + ch * 8), kb + off, in);
      cp_async16(smem_u32(vs + j * LD + ch * 8), vb + off, in);
    }
  };
  if (n_kv > 0) load_kv(k_begin, 0);
  cp_async_commit();  // Q and the first tile

  // this lane's rows: 16 (MT warp + mt) + g + 8 hr, for m-tile mt and
  // half hr (accumulator elements 2 hr and 2 hr + 1)
  int qpos[MT][2];
  float m[MT][2], l[MT][2];
  float acc[MT][C::kOTiles][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      qpos[mt][hr] = q_offset + (f0 + 16 * (MT * warp + mt) + g + 8 * hr) / G;
      m[mt][hr] = kNegInf;
      l[mt][hr] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < C::kOTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
  }

  // ldmatrix row addresses of this lane (shared-memory bytes): A (Q) rows
  // 16 (MT warp + mt) + lane % 16 at column 8 (lane / 16); K rows
  // (lane / 16) 8 + lane % 8 at column 8 ((lane / 8) % 2); V (transposed)
  // rows lane % 8 + 8 ((lane / 8) % 2) at column 8 (lane / 16)
  const unsigned q_lane = smem_u32(
      Qs + (16 * MT * warp + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_lane =
      ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = k_begin + it * KEYS;
    if (it + 1 < n_kv) load_kv(k0 + KEYS, (it + 1) & 1);
    cp_async_commit();  // possibly empty: one group an iteration
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    const bf16* ks = Ks + (it & 1) * KEYS * LD;
    const bf16* vs = Vs + (it & 1) * KEYS * LD;

    // S = Q K^T on the tensor cores: each K fragment serves every m-tile
    float s[MT][C::kSTiles][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < C::kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::kKSteps; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(q_lane + (16 * mt * LD + 16 * kk) * 2, a[mt]);
#pragma unroll
      for (int jp = 0; jp < C::kSTiles / 2; ++jp) {
        unsigned bk[4];
        ldsm_x4(smem_u32(ks + jp * 16 * LD + kk * 16 + k_lane), bk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * jp], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * jp + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // scores in base 2; masks only where the tile crosses an edge
    const bool edge = k0 + KEYS > S || (causal && k0 + KEYS - 1 > qpos_min) ||
                      (window > 0 && k0 <= qpos_max - window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < C::kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * c + (e & 1);
            const int qp = qpos[mt][e >> 1];
            bool ok = key < S;
            if (causal) ok = ok && key <= qp;
            if (window > 0) ok = ok && key > qp - window;
            x = ok ? x : kNegInf;
          }
          s[mt][j][e] = x;
        }

    // online softmax on the fragments: a row's elements are spread over
    // the 4 lanes of a quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = m[mt][hr];
#pragma unroll
        for (int j = 0; j < C::kSTiles; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * hr], s[mt][j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f(m[mt][hr] - mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::kSTiles; ++j)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            s[mt][j][e] = exp2f(s[mt][j][e] - mx);
            sum += s[mt][j][e];
          }
        l[mt][hr] = l[mt][hr] * alpha + sum;  // this lane's part of the sum
        m[mt][hr] = mx;
#pragma unroll
        for (int t = 0; t < C::kOTiles; ++t) {
          acc[mt][t][2 * hr] *= alpha;
          acc[mt][t][2 * hr + 1] *= alpha;
        }
      }

    // O += P V: p rounded to bf16 as the A operand, straight from the
    // score fragments (n-tiles 2 kk and 2 kk + 1 are k-step kk's 16
    // keys); each V fragment serves every m-tile
#pragma unroll
    for (int kk = 0; kk < C::kPSteps; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int tp = 0; tp < C::kOTiles / 2; ++tp) {
        unsigned bv[4];
        ldsm_x4_t(smem_u32(vs + kk * 16 * LD + tp * 16 + v_lane), bv);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * tp], a[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * tp + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float den = l[mt][hr];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      den = fmaxf(den, 1e-30f);
      const int f = f0 + 16 * (MT * warp + mt) + g + 8 * hr;
      if (f >= n_rows) continue;
      const int t = f / G, h = hkv * G + f % G;
      bf16* out = o + ((b * (long long)T + t) * H + h) * DH + 2 * c;
#pragma unroll
      for (int tt = 0; tt < C::kOTiles; ++tt)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * tt) =
            __floats2bfloat162_rn(acc[mt][tt][2 * hr] / den,
                                  acc[mt][tt][2 * hr + 1] / den);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int T, int S, int H, int Hkv, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  CTJ_CHECK(cudaFuncSetAttribute(flash_fwd<float, DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)));
  const int rows = T * (H / Hkv);
  const dim3 grid((rows + kRows - 1) / kRows, Hkv, B);
  flash_fwd<float, DH><<<grid, kFaThreads, smem, stream>>>(
      q, k, v, o, T, S, H, Hkv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int B, int T, int S, int H, int Hkv, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Tc<DH>::kSmem;
  CTJ_CHECK(cudaFuncSetAttribute(flash_fwd_tc<DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)));
  const int n_tiles = (T * (H / Hkv) + Tc<DH>::kRows - 1) / Tc<DH>::kRows;
  const long long blocks = (long long)n_tiles * B * Hkv;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_tc<DH><<<static_cast<unsigned>(blocks), kTcThreads, smem,
                     stream>>>(q, k, v, o, T, S, H, Hkv, B, n_tiles, causal,
                               window, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v,
                     void* o, int B, int T, int S, int H, int Hkv, int causal,
                     int window, int q_offset, float scale,
                     cudaStream_t st) {
  const Elem* qe = static_cast<const Elem*>(q);
  const Elem* ke = static_cast<const Elem*>(k);
  const Elem* ve = static_cast<const Elem*>(v);
  Elem* oe = static_cast<Elem*>(o);
  switch (dh) {
    case 16:
      return launch<16>(qe, ke, ve, oe, B, T, S, H, Hkv, causal, window,
                        q_offset, scale, st);
    case 32:
      return launch<32>(qe, ke, ve, oe, B, T, S, H, Hkv, causal, window,
                        q_offset, scale, st);
    case 64:
      return launch<64>(qe, ke, ve, oe, B, T, S, H, Hkv, causal, window,
                        q_offset, scale, st);
    case 128:
      return launch<128>(qe, ke, ve, oe, B, T, S, H, Hkv, causal, window,
                         q_offset, scale, st);
    case 160:
      return launch<160>(qe, ke, ve, oe, B, T, S, H, Hkv, causal, window,
                         q_offset, scale, st);
    case 256:
      return launch<256>(qe, ke, ve, oe, B, T, S, H, Hkv, causal, window,
                         q_offset, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fa
}  // namespace ctj

// o = attention(q, k, v): q and o (B, T, H, Dh), k and v (B, S, Hkv, Dh),
// all contiguous, bf16 (bf16 != 0; each 16-byte aligned) or fp32; Dh in
// {16, 32, 64, 128, 160, 256}; window <= 0 means no window.  Returns the
// first CUDA error.
extern "C" int ctj_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int B, int T,
                                   int S, int H, int Hkv, int Dh, int bf16,
                                   int causal, int window, int q_offset,
                                   float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ctj::fa::dispatch<ctj::fa::bf16>(Dh, q, k, v, o, B, T, S, H, Hkv,
                                            causal, window, q_offset, scale,
                                            st);
  return ctj::fa::dispatch<float>(Dh, q, k, v, o, B, T, S, H, Hkv, causal,
                                  window, q_offset, scale, st);
}
