// Pieces the flash-attention kernels for Hopper (sm_90a) share
// (flash_attn_fwd.cu, flash_attn_bwd.cu): the largest head dim (kDH), the
// mask (keep), and the copies of row-major [rows][dh] operand tiles into
// shared memory (load_rows) with their bf16 rounding (round_rows).
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
// An operand tile is row-major [rows][kLd] in shared memory, copied as it
// lies in device memory by 16-byte cp.async (4-byte when dh is not a
// multiple of 4 or a pointer not 16-byte aligned), never transposed, and
// zero-filled past dh and past T.

#pragma once

#include <cmath>

#include "ffn_common.cuh"
#include "gemm_core.cuh"

namespace flash {

constexpr int kDH = 64;            // largest head dim the kernels take
constexpr int kLd = kDH + 4;       // row stride of a [rows][dh] tile
constexpr float kNeg = -1e30f;     // the Pallas kernels' _NEG

// Whether query row qr may see key kr.
__device__ __forceinline__ bool keep(int qr, int kr, int Tq, int Tk,
                                     bool causal) {
  return qr < Tq && kr < Tk && (!causal || qr >= kr);
}

// Chunk q of this thread's copies of a kRows x 64 tile (16 chunks of 4
// floats a row): row r, column c.
template <int kThreadsN>
__device__ __forceinline__ void chunk(int q, int& r, int& c) {
  const int e = static_cast<int>(threadIdx.x) + q * kThreadsN;
  r = e / 16;
  c = (e % 16) * 4;
}

// Rows [r0, r0 + kRows) of a [rows][dh] matrix into dst [kRows][ld], zero
// past `rows` and dh.
template <int kRows, int kThreadsN>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int r0,
                                          int rows, int dh, bool vec) {
  static_assert(kRows * 16 % kThreadsN == 0, "whole rounds of copies");
#pragma unroll
  for (int q = 0; q < kRows * 16 / kThreadsN; ++q) {
    int r, c;
    chunk<kThreadsN>(q, r, c);
    const bool row = r0 + r < rows;
    const size_t at = static_cast<size_t>(r0 + r) * dh + c;
    float* d = dst + r * ld + c;
    if (vec) {
      const bool ok = row && c < dh;
      gemm::cp_async16(d, ok ? src + at : src, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = row && c + i < dh;
        ffn::cp_async4(d + i, ok ? src + at + i : src, ok);
      }
    }
  }
}

// This thread's chunks of the same tile rounded to bf16, after its wait.
template <int kRows, int kThreadsN>
__device__ __forceinline__ void round_rows(float* dst, int ld) {
#pragma unroll
  for (int q = 0; q < kRows * 16 / kThreadsN; ++q) {
    int r, c;
    chunk<kThreadsN>(q, r, c);
    float4* p = reinterpret_cast<float4*>(dst + r * ld + c);
    float4 x = *p;
    x.x = gemm::bf16_round(x.x);
    x.y = gemm::bf16_round(x.y);
    x.z = gemm::bf16_round(x.z);
    x.w = gemm::bf16_round(x.w);
    *p = x;
  }
}

}  // namespace flash
