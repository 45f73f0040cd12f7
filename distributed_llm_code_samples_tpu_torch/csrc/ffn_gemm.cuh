// The passes the three FFN kernels for Hopper (sm_90a) share, on the
// GEMM core of gemm_core.cuh: ffn_fwd.cu, ffn_bwd_dx.cu and ffn_bwd_dw.cu.
// Layouts are the JAX package's: x, dy [T, d]; w1 [ffn, d]; w2 [d, ffn];
// all f32, row-major, contiguous. Each kernel copies its operands padded
// (gemm::prep) so that every operand of every product is a row-major
// [K][M] or [K][N] array read as 16-byte vectors, then runs:
//   pass 1 (hidden_kernel): one 128 x 128 tile of the hidden activation a
//     block. It sums h over d and stores a = relu(h), or keeps h's mask as
//     64 bits a thread in shared memory, sums a second product da over d
//     in the same registers and stores dh = where(h <= 0, 0, da), or both
//     (the weight gradients). relu is where(h <= 0, 0, h): NaN passes.
//   pass 2 (slice_kernel): one or two products whose depth axis is cut
//     into S slices of L, each block one 128 x 128 output tile over one
//     slice, summed in order; with S > 1 the partials go to [S][M][N].
//   reduce (reduce_kernel, only when S > 1): each output element the sum
//     of its S partials in slice order.
// The passes are kernel templates whose first argument is a tag naming
// the FFN kernel that launches them (fwd, dx, dw; the copies take it as
// gemm::prep<Tag>), so that a profile tells the three kernels' passes
// apart. No atomics: every output element has one fixed order of
// summation (k in order within a slice, then slices in order), so a
// launch is bit-for-bit deterministic from run to run.
//
// With kBf16 (the Pallas kernels' `mxu_bf16`) the copies round the
// operands to bf16 and pass 1 rounds what it stores; products and sums
// stay f32 FMA on the CUDA cores.

#pragma once

#include <stdint.h>

#include "gemm_core.cuh"

namespace ffn_gemm {

// the FFN kernel that launches a pass
struct fwd;
struct dx;
struct dw;

using gemm::kThreads;
using gemm::kTile;
using gemm::quad;

template <bool kBf16>
__device__ __forceinline__ float op(float v) {
  return kBf16 ? gemm::bf16_round(v) : v;
}

// What pass 1 stores: a bit set.
enum : int { kStoreA = 1, kStoreDh = 2 };

// Pass 1. Block b owns rows [128 (b / tiles_n), +128) and columns
// [128 (b % tiles_n), +128) of the hidden tile; h is the product of
// h_op over k in [0, depth), da that of da_op. a and dh are [rows][ld]
// (ld a multiple of 4); rows past `rows` are not stored.
struct Hidden {
  gemm::Operands h_op, da_op;
  float* a;
  float* dh;
  int rows, ld, tiles_n, depth;
};

__host__ __device__ inline int tiles(long long n) {
  return static_cast<int>((n + kTile - 1) / kTile);
}

// acc out to rows m < rows of out [rows][ld] (columns < ld, 16-byte
// stores).
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[8][8], int m0,
                                           int n0, int rows, long long ld) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + quad(ty, i);
    if (m >= rows) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + quad(tx, 4 * q);
      if (n < ld)
        *reinterpret_cast<float4*>(out + m * ld + n) = make_float4(
            acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
            acc[i][4 * q + 3]);
    }
  }
}

// Shared bytes of pass 1: the operand ring, and with kStoreDh each
// thread's 64 mask bits behind it. The core's mainloop takes all 128
// registers a thread has at two blocks an SM; the mask held in two more
// through the second product spilled some 300 bytes a thread.
template <int kStore>
constexpr size_t hidden_smem() {
  return gemm::kSmem + (kStore & kStoreDh ? kThreads * sizeof(uint64_t) : 0);
}

template <typename Tag, int kStore, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    hidden_kernel(const Hidden p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* masks = reinterpret_cast<uint64_t*>(smem + gemm::kSmem /
                                                           sizeof(float));
  const int m0 = (static_cast<int>(blockIdx.x) / p.tiles_n) * kTile;
  const int n0 = (static_cast<int>(blockIdx.x) % p.tiles_n) * kTile;
  float acc[8][8];

  // h; a = relu(h) out, the mask kept as bits
  gemm::mainloop(p.h_op, m0, n0, 0, p.depth, smem, acc);
  uint64_t mask = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float h = acc[i][j];
      if (!(h <= 0.f)) mask |= 1ull << (8 * i + j);
      acc[i][j] = op<kBf16>(h <= 0.f ? 0.f : h);
    }
  if (kStore & kStoreA) store_tile(p.a, acc, m0, n0, p.rows, p.ld);
  if (!(kStore & kStoreDh)) return;
  masks[threadIdx.x] = mask;   // read back by this thread alone
  __syncthreads();             // the operand ring is refilled below

  // da; dh = where(h <= 0, 0, da) out
  gemm::mainloop(p.da_op, m0, n0, 0, p.depth, smem, acc);
  mask = masks[threadIdx.x];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = op<kBf16>((mask >> (8 * i + j)) & 1 ? acc[i][j] : 0.f);
  store_tile(p.dh, acc, m0, n0, p.rows, p.ld);
}

// One of pass 2's products: out [M][N] (+ slice * M * N) = the sum over
// the slice's depth of a[k][m] * b[k][n]. tiles 0: no product.
struct Product {
  gemm::Operands op;
  float* out;
  int M, N, tiles_n, tiles;
};

// Block blk of product p: tile blk % tiles over slice blk / tiles, whose
// depth is [s L, min(K, (s + 1) L)).
__device__ __forceinline__ void slice_tile(const Product& p, int blk, int K,
                                           int L, float* smem) {
  const int s = blk / p.tiles, t = blk % p.tiles;
  const int m0 = (t / p.tiles_n) * kTile, n0 = (t % p.tiles_n) * kTile;
  const int k0 = s * L, k1 = min(K, k0 + L);
  float acc[8][8];
  gemm::mainloop(p.op, m0, n0, k0, k1, smem, acc);
  float* out = p.out + static_cast<size_t>(s) * p.M * p.N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + quad(ty, i);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + quad(tx, j);
      if (n < p.N) out[static_cast<size_t>(m) * p.N + n] = acc[i][j];
    }
  }
}

// Pass 2. Blocks [0, S * p0.tiles) compute p0's tiles, slice by slice,
// the rest p1's.
template <typename Tag>
__global__ void __launch_bounds__(kThreads, 2)
    slice_kernel(const Product p0, const Product p1, int K, int S, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < S * p0.tiles)
    slice_tile(p0, blk, K, L, smem);
  else
    slice_tile(p1, blk - S * p0.tiles, K, L, smem);
}

// out[i] = part[0][i] + part[1][i] + ... in slice order, for `outputs`
// (1 or 2) outputs of `count` floats each (partials [S][count]).
template <typename Tag>
__global__ void reduce_kernel(const float* __restrict__ part1,
                              const float* __restrict__ part2,
                              float* __restrict__ out1,
                              float* __restrict__ out2, long long count,
                              int outputs, int S) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < outputs * count; i += stride) {
    const bool second = i >= count;
    const float* p = second ? part2 : part1;
    const long long e = second ? i - count : i;
    float acc = __ldg(p + e);
    for (int s = 1; s < S; ++s) acc = acc + __ldg(p + s * count + e);
    (second ? out2 : out1)[e] = acc;
  }
}

// -- host side -----------------------------------------------------------

inline Product product(const float* a, long long lda, int a_ext,
                       const float* b, long long ldb, int b_ext, int M,
                       int N) {
  Product p;
  p.op = gemm::Operands{a, b, lda, ldb, a_ext, b_ext};
  p.out = nullptr;
  p.M = M;
  p.N = N;
  p.tiles_n = tiles(N);
  p.tiles = tiles(M) * p.tiles_n;
  return p;
}

// Pass 1 over a [rows x ld] hidden tile.
template <typename Tag, int kStore, bool kBf16>
cudaError_t hidden(Hidden p, cudaStream_t st) {
  p.tiles_n = tiles(p.ld);
  constexpr size_t smem = hidden_smem<kStore>();
  auto kern = hidden_kernel<Tag, kStore, kBf16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<tiles(p.rows) * p.tiles_n, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// Pass 2 over depth K in S slices of L and, when S > 1, the reduce:
// out1 = p0 and out2 = p1 (p1.tiles 0: none; both of p0.M * p0.N
// floats), through the partials part1 and part2 ([S][M][N]).
template <typename Tag>
cudaError_t sliced(Product p0, Product p1, float* out1, float* out2,
                   float* part1, float* part2, int K, int S, int L,
                   cudaStream_t st) {
  const bool split = S > 1;
  p0.out = split ? part1 : out1;
  p1.out = split ? part2 : out2;
  slice_kernel<Tag><<<S * (p0.tiles + p1.tiles), kThreads, gemm::kSmem,
                      st>>>(p0, p1, K, S, L);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  reduce_kernel<Tag><<<1024, 256, 0, st>>>(
      part1, part2, out1, out2, static_cast<long long>(p0.M) * p0.N,
      p1.tiles > 0 ? 2 : 1, S);
  return cudaGetLastError();
}

// S slices of L cover a depth of K: S = ceil(K / L).
inline bool covers(int K, int S, int L) {
  return S >= 1 && L >= 1 && static_cast<long long>(S - 1) * L < K &&
         static_cast<long long>(S) * L >= K;
}

}  // namespace ffn_gemm
