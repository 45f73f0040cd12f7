// Small f32 tile pieces for Hopper (sm_90a) that predate the GEMM core
// of gemm_core.cuh, kept for their two users: head_xent_fwd.cu (the
// hidden tile below, its logit tile) and the flash kernels, through
// flash_common.cuh (bf16 rounding, op, the 4-byte cp.async copies and
// set_smem). The FFN kernels run on gemm_core.cuh (ffn_gemm.cuh).
// Layouts are the JAX package's, row-major and contiguous.
//
// Arithmetic is f32 FMA on the CUDA cores (no tensor cores yet). With
// kBf16 (the Pallas kernels' `mxu_bf16`) every operand is rounded to
// bf16 (round to nearest even) once it is in shared memory; the product
// of two bf16 values is exact in f32, and sums stay f32, which is what
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
// The hidden tile: a [kBT rows x kBF columns] tile of h = x w^T (sum over
// d; x [T, d], w [F, d]). 256 threads; warp w owns columns w*16..+15,
// lane l the 4 rows (l/4)*4..+3 and the 4 columns (l%4)*4..+3 of them:
// 4 x 4 sums a thread, fed by one 16-byte shared load of each operand per
// step of d.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ffn {

constexpr int kThreads = 256;
constexpr int kBT = 32;          // token rows a block owns
constexpr int kBF = 128;         // columns of one hidden tile
constexpr int kBK = 32;          // depth of one step over d (hidden tile)
constexpr int kXS = kBT + 4;     // row stride of [k][t] tiles
constexpr int kWS = kBF + 4;     // row stride of [k][f] tiles
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on sm_90

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float op(float v) {
  return kBf16 ? bf16_round(v) : v;
}

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

// [kBK][kXS] <- p[t0 + r, k0 + k] (x, transposed)
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

// [kBK][kWS] <- w[f0 + f, k0 + k] (transposed)
struct WT {
  const float* p;
  int f0, k0, F, d;
  __device__ void operator()(int i, int& off, const float*& src,
                             bool& ok) const {
    const int kk = i % kBK, f = i / kBK, ff = f0 + f, k = k0 + kk;
    off = kk * kWS + f;
    ok = ff < F && k < d;
    src = ok ? p + static_cast<size_t>(ff) * d + k : p;
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
// x^T [kBK][kXS]; w^T [kBK][kWS].
constexpr int kHiddenStage = kBK * kXS + kBK * kWS;
constexpr int kHiddenFloats = 2 * kHiddenStage;    // two buffers

template <bool kBf16, bool kRound>
__device__ __forceinline__ void hidden_operands(float* s, const float* x,
                                                const float* w, int t0,
                                                int f0, int k0, int T, int d,
                                                int F) {
  move<kBf16, kRound, kBT * kBK>(s, TokensT{x, t0, k0, T, d});
  move<kBf16, kRound, kBF * kBK>(s + kBK * kXS, WT{w, f0, k0, F, d});
}

__device__ __forceinline__ int hidden_row() {
  return ((threadIdx.x & 31) >> 2) * 4;
}
__device__ __forceinline__ int hidden_col() {
  return (threadIdx.x >> 5) * 16 + (threadIdx.x & 3) * 4;
}

// The hidden tile at rows t0.., columns f0.. `buf` holds kHiddenFloats
// shared floats, free on entry (every reader passed a barrier since);
// free again on return. Each thread's sums are for rows hidden_row(),
// columns hidden_col().
template <bool kBf16>
__device__ void hidden_tile(float h[4][4], const float* __restrict__ x,
                            const float* __restrict__ w, int t0, int f0,
                            int T, int d, int F, float* buf) {
  const int r0 = hidden_row(), c0 = hidden_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) h[i][j] = 0.f;
  const int steps = (d + kBK - 1) / kBK;
  hidden_operands<kBf16, false>(buf, x, w, t0, f0, 0, T, d, F);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    float* cur = buf + (s & 1) * kHiddenStage;
    if (s + 1 < steps) {                 // next step's copies in flight
      hidden_operands<kBf16, false>(buf + ((s + 1) & 1) * kHiddenStage, x,
                                    w, t0, f0, (s + 1) * kBK, T, d, F);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    hidden_operands<kBf16, true>(cur, x, w, t0, f0, s * kBK, T, d, F);
    __syncthreads();
    outer_4x4(h, cur, cur + kBK * kXS, r0, c0);
    __syncthreads();                     // cur may be refilled next
  }
}

inline cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ffn
