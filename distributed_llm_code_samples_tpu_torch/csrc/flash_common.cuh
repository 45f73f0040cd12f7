// Pieces of the flash-attention kernels for Hopper (sm_90a): the tiles
// of flash_attn_fwd.cu, and the mask (keep) and the largest head dim
// (kDH), which flash_attn_bwd.cu shares (its tiles are its own).
// Layouts: q, dy, y [BH, Tq, dh]; k, v [BH, Tk, dh]; lse, D [BH, Tq]; all
// f32, row-major, contiguous. BH is every (batch, head) pair: one launch
// covers them all.
//
// Arithmetic is f32 FMA on the CUDA cores (no tensor cores yet). With
// kBf16 (the Pallas kernels' `mxu_bf16`) every operand tile is rounded to
// bf16 once it is in shared memory, and so are the probability and
// score-gradient tiles where they are formed; products of two bf16 values
// are exact in f32 and sums stay f32.
//
// Tiles are 64 rows (queries or keys) by the head dim, padded to 64 and
// zero-filled past dh and past T. A [64 x 64] product tile is shared by
// 256 threads: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4..+3
// and columns tx*4..+3, 16 sums, fed per step of the sum by one 16-byte
// shared load of each operand. The 16 threads that share a row are one
// half-warp, so row statistics reduce with four shuffles. Every output
// element is summed by one thread in a fixed order, with no atomics: a
// launch is bit-for-bit deterministic from run to run.

#pragma once

#include <cmath>

#include "ffn_common.cuh"

namespace flash {

constexpr int kThreads = 256;
constexpr int kB = 64;             // rows of a query or key tile
constexpr int kDH = 64;            // largest head dim the kernels take
constexpr int kS = kB + 4;         // row stride of every [64][64] tile
constexpr int kTile = kB * kS;     // floats of one tile
constexpr float kNeg = -1e30f;     // the Pallas kernels' _NEG

static_assert(kDH == kB, "one product routine serves both sum lengths");

__device__ __forceinline__ int row0() { return (threadIdx.x >> 4) * 4; }
__device__ __forceinline__ int col0() { return (threadIdx.x & 15) * 4; }

// Rows row0.. (64 of them) of a [rows, dh] matrix p into a tile, as
// dst[c][r] (kTrans) or dst[r][c]. kRound false starts the cp.async
// copies (zero past rows and dh); kRound true, after the wait, rounds
// this thread's own elements to bf16 when kBf16.
template <bool kTrans, bool kRound, bool kBf16>
__device__ __forceinline__ void load_tile(float* dst, const float* p,
                                          int row0_, int rows, int dh) {
  if (kRound && !kBf16) return;
#pragma unroll 4
  for (int q = 0; q < kB * kDH / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int c = e % kDH, r = e / kDH;
    const int off = kTrans ? c * kS + r : r * kS + c;
    if (kRound) {
      dst[off] = ffn::bf16_round(dst[off]);
    } else {
      const bool ok = row0_ + r < rows && c < dh;
      ffn::cp_async4(dst + off,
                     ok ? p + static_cast<size_t>(row0_ + r) * dh + c : p,
                     ok);
    }
  }
}

// acc[i][j] += sum_k aT[k][row0() + i] * bT[k][col0() + j] over k < 64,
// in order.
__device__ __forceinline__ void outer(float acc[4][4], const float* aT,
                                      const float* bT) {
  const int r0 = row0(), c0 = col0();
#pragma unroll 8
  for (int k = 0; k < kB; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(aT + k * kS + r0);
    const float4 b = *reinterpret_cast<const float4*>(bT + k * kS + c0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float a[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// Store a thread's 4 x 4 values v[i][j] (row row0()+i, column col0()+j)
// transposed, as dst[col][row].
__device__ __forceinline__ void store_T(float* dst, const float v[4][4]) {
  const int r0 = row0(), c0 = col0();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (c0 + j) * kS + r0) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Write a thread's 4 x 4 block of a [rows, dh] output at rows row0_..,
// times `scale`; rows and dh masked.
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float v[4][4], int row0_,
                                           int rows, int dh, float scale) {
  const int r0 = row0(), c0 = col0();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0_ + r0 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < dh)
        out[static_cast<size_t>(r) * dh + c0 + j] = v[i][j] * scale;
  }
}

// Sum and max over the 16 threads of a half-warp (the threads that share
// a row).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Whether query row qr may see key kr.
__device__ __forceinline__ bool keep(int qr, int kr, int Tq, int Tk,
                                     bool causal) {
  return qr < Tq && kr < Tk && (!causal || qr >= kr);
}

// Key tiles a causal query tile at q0 needs: those starting at or before
// its last row (the Pallas kernels' _tile_needed).
__device__ __forceinline__ int key_tiles(int q0, int Tk, bool causal) {
  const int all = (Tk + kB - 1) / kB;
  return causal ? min(all, (q0 + kB - 1) / kB + 1) : all;
}

}  // namespace flash
