// Pieces the flash-attention kernels for Hopper (sm_90a) share
// (flash_attn_fwd.cu, flash_attn_bwd.cu): the largest head dim (kDH), the
// mask (keep), the copies of row-major [rows][dh] operand tiles into
// shared memory (load_rows) with their bf16 rounding (round_rows), and
// the stores of output rows (store4, store1).
// Layouts: q, dy, y [BH, Tq, dh]; k, v [BH, Tk, dh]; lse, D [BH, Tq]; all
// row-major, contiguous. BH is every (batch, head) pair: one launch
// covers them all. The storage type T of q, k, v, dy, y and the outputs
// is f32 or bf16 (the JAX kernels' outputs take their inputs' dtype);
// lse and D are f32 either way.
//
// bf16 storage in the backward (the forward's runs on the tensor cores,
// flash_attn_fwd.cu): a tile is read as bf16 (8 bytes for 4 elements,
// half the f32 bytes), widened to f32 in shared memory, and computed on
// exactly as the f32 kernels compute with kBf16 on: every operand is
// already a bf16 value, p and ds are rounded to bf16 where formed,
// products and sums are f32, and each output is rounded to bf16 once,
// when stored. Its copies
// are plain loads and stores, not cp.async (which cannot widen): the
// threads that copy a tile stall on it, and the barrier that publishes
// the tile is the same.
//
// Arithmetic here is f32 FMA on the CUDA cores. With
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

// The same copy from bf16 storage: each chunk of 4 elements read as one
// 8-byte load (4 two-byte loads when !vec), widened, stored as a float4.
template <int kRows, int kThreadsN>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int dh, bool vec) {
  static_assert(kRows * 16 % kThreadsN == 0, "whole rounds of copies");
#pragma unroll
  for (int q = 0; q < kRows * 16 / kThreadsN; ++q) {
    int r, c;
    chunk<kThreadsN>(q, r, c);
    const bool row = r0 + r < rows;
    const __nv_bfloat16* at = src + static_cast<size_t>(r0 + r) * dh + c;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec) {
      if (row && c < dh) {
        const uint2 u = *reinterpret_cast<const uint2*>(at);
        const float2 a =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        x = make_float4(a.x, a.y, b.x, b.y);
      }
    } else if (row) {
      float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < dh) e[i] = __bfloat162float(at[i]);
      x = make_float4(e[0], e[1], e[2], e[3]);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// One element of an operand as f32.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An f32 result into its storage type (bf16: round to nearest even).
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive outputs (16 bytes of f32 or 8 of bf16, aligned).
__device__ __forceinline__ void store4(float* out, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(out) = u;
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
