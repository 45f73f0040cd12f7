// Shared pieces of the FFN kernels for Hopper (sm_90a): ffn_fwd.cu and
// ffn_bwd_dx.cu (ffn_bwd_dw.cu runs on gemm_core.cuh). Layouts are the
// JAX package's:
// x, dy [T, d]; w1 [ffn, d]; w2 [d, ffn]; all f32, row-major, contiguous.
//
// Arithmetic is f32 FMA on the CUDA cores (no tensor cores yet). With
// kBf16 (the Pallas kernels' `mxu_bf16`) every operand is rounded to
// bf16 (round to nearest even) once it is in shared memory, and the
// hidden activation is rounded where it is formed; the product of two
// bf16 values is exact in f32, and sums stay f32, which is what
// `preferred_element_type=f32` computes.
//
// Every output element is summed by one thread in a fixed order, with no
// atomics, so a launch is bit-for-bit deterministic from run to run.
//
// Operand tiles move from device to shared memory with `cp.async` (4
// bytes a thread and element, zero-filled past the edges, no registers
// held), two buffers deep: the copy of step s + 1 is in flight while
// step s computes.
//
// The hidden tile. Both fused kernels compute a [kBT tokens x kBF ffn]
// tile of
//   h  = x  w1^T   (sum over d)
//   da = dy w2     (sum over d, the input gradient's kernel only)
// 256 threads; warp w owns ffn columns w*16..+15, lane l the 4 rows
// (l/4)*4..+3 and the 4 columns (l%4)*4..+3 of them: 4 x 4 sums a thread,
// fed by one 16-byte shared load of each operand per step of d.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ffn {

constexpr int kThreads = 256;
constexpr int kBT = 32;          // token rows a block owns
constexpr int kBF = 128;         // ffn columns of one hidden tile
constexpr int kBK = 32;          // depth of one step over d (hidden tile)
constexpr int kDT = 768;         // output columns a fused block owns
constexpr int kFC = 16;          // ffn rows of one step of the second product
constexpr int kXS = kBT + 4;     // row stride of [k][t] and [f][t] tiles
constexpr int kWS = kBF + 4;     // row stride of [k][f] and [t][f] tiles
constexpr int kBS = kDT + 4;     // row stride of the [f][c] weight tile
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on sm_90

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float op(float v) {
  return kBf16 ? bf16_round(v) : v;
}

// ReLU as the JAX package writes it: where(h <= 0, 0, h) (NaN passes).
__device__ __forceinline__ float relu(float h) { return h <= 0.f ? 0.f : h; }

// -- asynchronous tile copies ------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A tile map says, for element i of an N-element tile, where it goes in
// shared memory (off), where it comes from (src) and whether it lies
// inside the array (ok; outside it is zero and src is only a valid base).
// Thread threadIdx.x moves elements threadIdx.x + q * kThreads.
//
// kRound false: start the copies. kRound true (after the wait): round
// this thread's own elements to bf16 in place, when kBf16.
template <bool kBf16, bool kRound, int N, typename Map>
__device__ __forceinline__ void move(float* dst, const Map& m) {
  static_assert(N % kThreads == 0, "a tile is a whole number of rounds");
  if (kRound && !kBf16) return;
#pragma unroll 4
  for (int q = 0; q < N / kThreads; ++q) {
    int off;
    const float* src;
    bool ok;
    m(threadIdx.x + q * kThreads, off, src, ok);
    if (kRound)
      dst[off] = bf16_round(dst[off]);
    else
      cp_async4(dst + off, src, ok);
  }
}

// [kBK][kXS] <- p[t0 + r, k0 + k] (x or dy, transposed)
struct TokensT {
  const float* p;
  int t0, k0, T, d;
  __device__ void operator()(int i, int& off, const float*& src,
                             bool& ok) const {
    const int kk = i % kBK, r = i / kBK, t = t0 + r, k = k0 + kk;
    off = kk * kXS + r;
    ok = t < T && k < d;
    src = ok ? p + static_cast<size_t>(t) * d + k : p;
  }
};

// [kBK][kWS] <- w1[f0 + f, k0 + k] (transposed)
struct W1T {
  const float* p;
  int f0, k0, ffn, d;
  __device__ void operator()(int i, int& off, const float*& src,
                             bool& ok) const {
    const int kk = i % kBK, f = i / kBK, ff = f0 + f, k = k0 + kk;
    off = kk * kWS + f;
    ok = ff < ffn && k < d;
    src = ok ? p + static_cast<size_t>(ff) * d + k : p;
  }
};

// [kBK][kWS] <- w2[k0 + k, f0 + f] (rows of w2 run along ffn)
struct W2Rows {
  const float* p;
  int f0, k0, ffn, d;
  __device__ void operator()(int i, int& off, const float*& src,
                             bool& ok) const {
    const int f = i % kBF, kk = i / kBF, ff = f0 + f, k = k0 + kk;
    off = kk * kWS + f;
    ok = ff < ffn && k < d;
    src = ok ? p + static_cast<size_t>(k) * ffn + ff : p;
  }
};

// -- the hidden tile ---------------------------------------------------------

// acc[i][j] += sum_k aT[k][r0 + i] * bT[k][c0 + j], k in order.
__device__ __forceinline__ void outer_4x4(float acc[4][4], const float* aT,
                                          const float* bT, int r0, int c0) {
#pragma unroll 8
  for (int k = 0; k < kBK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(aT + k * kXS + r0);
    const float4 b = *reinterpret_cast<const float4*>(bT + k * kWS + c0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Shared floats of one buffer of the hidden tile's operands:
// x^T, dy^T [kBK][kXS]; w1^T, w2 [kBK][kWS].
constexpr int kHiddenStage = 2 * kBK * kXS + 2 * kBK * kWS;
constexpr int kHiddenFloats = 2 * kHiddenStage;    // two buffers

template <bool kBf16, bool kGrad, bool kRound>
__device__ __forceinline__ void hidden_operands(
    float* s, const float* x, const float* dy, const float* w1,
    const float* w2, int t0, int f0, int k0, int T, int d, int ffn) {
  move<kBf16, kRound, kBT * kBK>(s, TokensT{x, t0, k0, T, d});
  move<kBf16, kRound, kBF * kBK>(s + 2 * kBK * kXS, W1T{w1, f0, k0, ffn, d});
  if (kGrad) {
    move<kBf16, kRound, kBT * kBK>(s + kBK * kXS, TokensT{dy, t0, k0, T, d});
    move<kBf16, kRound, kBF * kBK>(s + 2 * kBK * kXS + kBK * kWS,
                                   W2Rows{w2, f0, k0, ffn, d});
  }
}

__device__ __forceinline__ int hidden_row() {
  return ((threadIdx.x & 31) >> 2) * 4;
}
__device__ __forceinline__ int hidden_col() {
  return (threadIdx.x >> 5) * 16 + (threadIdx.x & 3) * 4;
}

// The hidden tile at tokens t0.., ffn columns f0..: h always, da when
// kGrad. `buf` holds kHiddenFloats shared floats, free on entry (every
// reader passed a barrier since); free again on return. Each thread's
// sums are for rows hidden_row(), columns hidden_col().
template <bool kBf16, bool kGrad>
__device__ void hidden_tile(float h[4][4], float da[4][4],
                            const float* __restrict__ x,
                            const float* __restrict__ dy,
                            const float* __restrict__ w1,
                            const float* __restrict__ w2, int t0, int f0,
                            int T, int d, int ffn, float* buf) {
  const int r0 = hidden_row(), c0 = hidden_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) h[i][j] = da[i][j] = 0.f;
  const int steps = (d + kBK - 1) / kBK;
  hidden_operands<kBf16, kGrad, false>(buf, x, dy, w1, w2, t0, f0, 0, T, d,
                                       ffn);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    float* cur = buf + (s & 1) * kHiddenStage;
    if (s + 1 < steps) {                 // next step's copies in flight
      hidden_operands<kBf16, kGrad, false>(buf + ((s + 1) & 1) * kHiddenStage,
                                           x, dy, w1, w2, t0, f0,
                                           (s + 1) * kBK, T, d, ffn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    hidden_operands<kBf16, kGrad, true>(cur, x, dy, w1, w2, t0, f0, s * kBK,
                                        T, d, ffn);
    __syncthreads();
    outer_4x4(h, cur, cur + 2 * kBK * kXS, r0, c0);
    if (kGrad)
      outer_4x4(da, cur + kBK * kXS, cur + 2 * kBK * kXS + kBK * kWS, r0, c0);
    __syncthreads();                     // cur may be refilled next
  }
}

// -- the fused kernels' second product ---------------------------------------

// For one hidden tile held in shared memory as hs[f][t] (stride kXS):
// acc[t][c] += sum_f hs[f][t] * B[f][c] over the tile's ffn rows, where
// map(fc) is the tile map of B's rows fc..fc + kFC - 1 into bs[f][c]
// (stride kBS, two buffers of kFC * kBS). A thread owns the 4 rows
// (lane/4)*4..+3 and the 24 columns warp*96 + (lane%4)*24..+23 of the
// block's [kBT x kDT] output: 96 sums in registers, fed per ffn row by
// one 16-byte load of hs and six of bs. hs must have been written before
// the call; bs is free on entry and on return.
template <bool kBf16, typename MapOf>
__device__ void second_product(float acc[4][24], const float* hs, float* bs,
                               int f0, int ffn, MapOf map) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (lane >> 2) * 4, cb = warp * 96 + (lane & 3) * 24;
  const int n = (min(kBF, ffn - f0) + kFC - 1) / kFC;
  move<kBf16, false, kFC * kDT>(bs, map(0));
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    float* cur = bs + (c & 1) * kFC * kBS;
    if (c + 1 < n) {
      move<kBf16, false, kFC * kDT>(bs + ((c + 1) & 1) * kFC * kBS,
                                    map((c + 1) * kFC));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    move<kBf16, true, kFC * kDT>(cur, map(c * kFC));
    __syncthreads();                     // cur (and hs) visible to all
#pragma unroll 4
    for (int f = 0; f < kFC; ++f) {
      const float4 a =
          *reinterpret_cast<const float4*>(hs + (c * kFC + f) * kXS + r0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float* brow = cur + f * kBS + cb;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(brow + 4 * q);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * q + j] = fmaf(av[i], bv[j], acc[i][4 * q + j]);
      }
    }
    __syncthreads();                     // cur may be refilled next
  }
}

// Store a thread's 4 x 4 hidden values as hs[f][t] (stride kXS).
__device__ __forceinline__ void store_hidden_T(float* hs, const float v[4][4]) {
  const int r0 = hidden_row(), c0 = hidden_col();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(hs + (c0 + j) * kXS + r0) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Write a thread's [4 x 24] block of the [T, d] output at tokens t0..,
// columns d0..; edges masked.
__device__ __forceinline__ void store_output(float* __restrict__ out,
                                             const float acc[4][24], int t0,
                                             int d0, int T, int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (lane >> 2) * 4, cb = warp * 96 + (lane & 3) * 24;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + r0 + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int c = d0 + cb + j;
      if (c < d) out[static_cast<size_t>(t) * d + c] = acc[i][j];
    }
  }
}

// Shared floats of a fused kernel: the hidden tile's operands, hs, bs.
constexpr int kFusedFloats = kHiddenFloats + kBF * kXS + 2 * kFC * kBS;

inline cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ffn
