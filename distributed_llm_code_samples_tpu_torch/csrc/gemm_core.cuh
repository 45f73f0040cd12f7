// The f32 GEMM core for Hopper (sm_90a) shared by head_xent_bwd.cu and
// the three FFN kernels (through ffn_gemm.cuh): a block's 128 x 128
// output tile of
//   acc[m][n] = sum over k in [k0, k1), in order, of a[k][m] * b[k][n],
// with both operands row-major [K][M] and [K][N] arrays whose rows are
// read as 16-byte vectors, and the padded copies that put operands into
// that layout (gemm_prep_kernel).
//
// The core: 256 threads; an 8 x 8 register tile a thread, in four 4 x 4
// quadrants 64 rows and columns apart (quad), so a warp's shared loads
// are broadcasts or one contiguous line; a kStages-deep ring of
// [kBK][128] operand tiles in shared memory fed by 16-byte cp.async, so
// the loads of later k-steps are in flight while a step's FMAs run. Two
// blocks an SM (16 warps): callers launch with __launch_bounds__(kThreads,
// 2). Arithmetic is f32 FMA on the CUDA cores, one explicit fmaf chain a
// sum in k order, so the bits depend only on the operands and the k range.
// Each caller writes its own epilogue over acc.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace gemm {

constexpr int kThreads = 256;
constexpr int kTile = 128;        // output rows and columns a block owns
// the pipeline: k-steps of a stage and stages in flight (of (8, 4),
// (16, 3), (16, 4) and (32, 2), (16, 3) was fastest for the head's
// backward at its main shape)
constexpr int kBK = 16, kStages = 3;
// the operand ring fits the 48 KB a block gets without opting in
constexpr size_t kSmem = static_cast<size_t>(kStages) * 2 * kBK * kTile *
                         sizeof(float);
static_assert(kSmem <= 48 * 1024, "operand ring over 48 KB");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A thread's rows (columns) of the tile: q < 4 at 4*base + q, else at
// 64 + 4*base + q - 4 (base: threadIdx.x / 16 for rows, % 16 for
// columns).
__device__ __forceinline__ int quad(int base, int q) {
  return (q < 4 ? 0 : 64 - 4) + base * 4 + q;
}

// The two operands of a product. A row of a (of b) may be read up to
// a_ext (b_ext) floats, a multiple of 4, from a 16-byte aligned start
// with lda (ldb) a multiple of 4; past it, and outside [k0, k1), operands
// read as zero.
struct Operands {
  const float* a;
  const float* b;
  long long lda, ldb;
  int a_ext, b_ext;
};

// acc = the block's tile at (m0, n0) over k in [k0, k1). smem holds
// kSmem bytes, 16-byte aligned. Every thread of the block calls it.
__device__ __forceinline__ void mainloop(const Operands& g, int m0, int n0,
                                         int k0, int k1, float* smem,
                                         float (&acc)[8][8]) {
  constexpr int kStage = 2 * kBK * kTile;
  constexpr int kLoads = kBK * (kTile / 4) / kThreads;
  static_assert(kLoads >= 1 && kBK * (kTile / 4) % kThreads == 0,
                "whole rounds of 16-byte copies");
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ktiles = (k1 - k0 + kBK - 1) / kBK;

  auto load = [&](int kt, int s) {
    float* as = smem + s * kStage;
    float* bs = as + kBK * kTile;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = tid + q * kThreads, r = i / (kTile / 4);
      const int c = (i % (kTile / 4)) * 4, k = k0 + kt * kBK + r;
      const bool oka = k < k1 && m0 + c < g.a_ext;
      const bool okb = k < k1 && n0 + c < g.b_ext;
      cp_async16(as + r * kTile + c,
                 oka ? g.a + static_cast<size_t>(k) * g.lda + m0 + c : g.a,
                 oka);
      cp_async16(bs + r * kTile + c,
                 okb ? g.b + static_cast<size_t>(k) * g.ldb + n0 + c : g.b,
                 okb);
    }
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step kt landed; step kt-1's stage is free
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load(nk, nk % kStages);
    cp_async_commit();
    const float* as = smem + (kt % kStages) * kStage;
    const float* bs = as + kBK * kTile;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kTile +
                                                         4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kTile +
                                                         64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kTile +
                                                         4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kTile +
                                                         64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
}

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// src [R][C] (row-major, C contiguous; f32, or bf16 storage widened
// exactly) -> f32 dst [R][ldc] (zero in columns [C, ldc)) and dst_t [C][ldt]
// (the transpose, zero in columns [R, ldt)), each value rounded to bf16
// when `round`. ldc 0 (ldt 0) writes no dst (dst_t). 32 x 32 tiles through
// shared memory; 32 x 8 threads. Tag only names the caller, so that a
// profile tells its copies apart.
template <typename Tag, typename Src>
__global__ void gemm_prep_kernel(const Src* __restrict__ src, int R, int C,
                                 float* __restrict__ dst, int ldc,
                                 float* __restrict__ dst_t, int ldt,
                                 int round) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    float v =
        r < R && c < C ? to_f32(src[static_cast<size_t>(r) * C + c]) : 0.f;
    if (round) v = bf16_round(v);
    tile[i][tx] = v;
    if (r < R && c < ldc) dst[static_cast<size_t>(r) * ldc + c] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c < C && r < ldt)
      dst_t[static_cast<size_t>(c) * ldt + r] = tile[tx][i];
  }
}

}  // namespace

// One gemm_prep_kernel launch over src [R][C]; its grid covers the
// padded extents of both copies (ldc columns, ldt rows).
template <typename Tag = void, typename Src>
inline void prep(const Src* src, int R, int C, float* dst, int ldc,
                 float* dst_t, int ldt, int round, cudaStream_t st) {
  const int cols = C > ldc ? C : ldc, rows = R > ldt ? R : ldt;
  gemm_prep_kernel<Tag, Src><<<dim3((cols + 31) / 32, (rows + 31) / 32),
                               dim3(32, 8), 0, st>>>(src, R, C, dst, ldc,
                                                     dst_t, ldt, round);
}

__host__ __device__ inline long long up4(long long x) {
  return (x + 3) / 4 * 4;
}

}  // namespace gemm
