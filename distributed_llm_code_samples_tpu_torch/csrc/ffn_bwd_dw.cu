// FFN weight gradients for Hopper (sm_90a):
//   dw1 = (1[h > 0] * (dy w2))^T x,   dw2 = dy^T relu(h),   h = x w1^T.
//
// Replaces the TPU kernel `ffn_bwd_dw_pallas` (body `_bwd_dw_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function, with h recomputed from the block input and the mask
// where(h <= 0, 0, da) (NaN passes). With mxu_bf16, x, dy, w1 and w2 are
// rounded to bf16 and so are a = relu(h) and dh (pallas_ffn.py:231-242);
// sums are f32 either way.
//
// What bounds it: operations. 8*T*d*ffn flops (h, da, dw1, dw2) against
// 2*T*d + 4*d*ffn floats moved; at the main shape (T 8192, d 768,
// ffn 3072) 155 GFLOP, 2.31 ms at the f32 FMA rate of 67 TFLOP/s.
//
// Design: four products on the GEMM core of gemm_core.cuh (a 128 x 128
// tile a block of 256 threads, 8 x 8 sums a thread, a 3-deep ring of
// 16-byte cp.async; two blocks an SM), in four launches:
//   prep: x and dy copied as [T][d4] and [d][T4], w1 as [d][ffn4] and w2
//     as [d][ffn4] (d4, T4, ffn4: rounded up to 4; zero padded; rounded
//     to bf16 with mxu_bf16), so that every operand of every product is
//     a row-major [K][M] or [K][N] array read as 16-byte vectors;
//   pass 1 (ffn_dw_hidden_kernel): a block owns a [128 tokens x 128 ffn]
//     tile; it sums h over d, writes a = relu(h) to a [T][ffn4] scratch
//     and keeps only h's 64 mask bits a thread, then sums da = dy w2 over
//     d in the same registers and writes dh = mask ? da : 0 to a second
//     [T][ffn4] scratch (2 x 4 x T x ffn bytes written and read once,
//     0.4 GB or about 0.12 ms at 3.35 TB/s at the main shape);
//   pass 2 (ffn_dw_gemm_kernel): dw1 = dh^T x and dw2 = dy^T a, with the
//     token axis as the depth. Their 2 x 144 tiles at the main shape
//     would fill 264 block slots (132 SMs x 2) 1.09 times, a second wave
//     of 24 blocks with the card idle around it; so the token axis splits
//     into S slices (ops/fused_ffn.py's dw_plan: the fewest that fill
//     four waves), each block sums one tile over one slice in order, and
//     the partials go to [S][ffn][d] and [S][d][ffn] scratch;
//   reduce (ffn_dw_reduce_kernel, only when S > 1): each output element is
//     the sum of its S partials in slice order.
// No atomics: every output element has one fixed order of summation (k
// in order within a slice, then slices in order), so two calls give the
// same bits. Ragged T, d and ffn are masked in the loads and stores.
//
// Plain C interface, bound with ctypes: the caller allocates dw1, dw2 and
// every scratch piece (ops/fused_ffn.py's dw_scratch has their sizes),
// passes the stream, and gets the first CUDA error back.

#include <stdint.h>

#include "gemm_core.cuh"

namespace {

using gemm::bf16_round;
using gemm::kThreads;
using gemm::kTile;
using gemm::quad;
using gemm::up4;

template <bool kBf16>
__device__ __forceinline__ float op(float v) {
  return kBf16 ? bf16_round(v) : v;
}

// acc out to rows m < T of out [T][f4] (columns < f4, 16-byte stores).
__device__ __forceinline__ void store_hidden(float* __restrict__ out,
                                             const float (&acc)[8][8],
                                             int m0, int n0, int T,
                                             long long f4) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + quad(ty, i);
    if (m >= T) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + quad(tx, 4 * q);
      if (n < f4)
        *reinterpret_cast<float4*>(out + m * f4 + n) = make_float4(
            acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
            acc[i][4 * q + 3]);
    }
  }
}

// Pass 1. Block b owns tokens [128 (b / tiles_f), +128) and ffn columns
// [128 (b % tiles_f), +128). xT, dyT [d][T4]; w1T, w2c [d][ffn4]; a, dh
// [T][ffn4].
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    ffn_dw_hidden_kernel(const float* __restrict__ xT,
                         const float* __restrict__ dyT,
                         const float* __restrict__ w1T,
                         const float* __restrict__ w2c, float* __restrict__ a,
                         float* __restrict__ dh, int T, int d, int ffn) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long T4 = up4(T), f4 = up4(ffn);
  const int tiles_f = static_cast<int>((f4 + kTile - 1) / kTile);
  const int m0 = (static_cast<int>(blockIdx.x) / tiles_f) * kTile;
  const int n0 = (static_cast<int>(blockIdx.x) % tiles_f) * kTile;
  const int ext_t = static_cast<int>(T4), ext_f = static_cast<int>(f4);
  float acc[8][8];

  // h = x w1^T; a = relu(h) out, the mask kept as bits
  gemm::mainloop(gemm::Operands{xT, w1T, T4, f4, ext_t, ext_f}, m0, n0, 0, d,
                 smem, acc);
  uint64_t mask = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float h = acc[i][j];
      if (!(h <= 0.f)) mask |= 1ull << (8 * i + j);
      acc[i][j] = op<kBf16>(h <= 0.f ? 0.f : h);
    }
  store_hidden(a, acc, m0, n0, T, f4);
  __syncthreads();   // the operand ring is refilled below

  // da = dy w2; dh = where(h <= 0, 0, da) out
  gemm::mainloop(gemm::Operands{dyT, w2c, T4, f4, ext_t, ext_f}, m0, n0, 0,
                 d, smem, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = op<kBf16>((mask >> (8 * i + j)) & 1 ? acc[i][j] : 0.f);
  store_hidden(dh, acc, m0, n0, T, f4);
}

// One of pass 2's products: out [M][N] (+ slice * M * N) = the sum over
// the slice's tokens of a[t][m] * b[t][n].
struct Product {
  gemm::Operands op;
  float* out;
  int M, N, tiles_n, tiles;
};

// Block blk of product p: tile blk % tiles over slice blk / tiles, whose
// tokens are [s L, min(T, (s + 1) L)).
__device__ __forceinline__ void dw_tile(const Product& p, int blk, int T,
                                        int L, float* smem) {
  const int s = blk / p.tiles, t = blk % p.tiles;
  const int m0 = (t / p.tiles_n) * kTile, n0 = (t % p.tiles_n) * kTile;
  const int k0 = s * L, k1 = min(T, k0 + L);
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
__global__ void __launch_bounds__(kThreads, 2)
    ffn_dw_gemm_kernel(const Product p0, const Product p1, int T, int S,
                       int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < S * p0.tiles)
    dw_tile(p0, blk, T, L, smem);
  else
    dw_tile(p1, blk - S * p0.tiles, T, L, smem);
}

// out[i] = part[0][i] + part[1][i] + ... in slice order, for the two
// outputs of `count` floats each (partials [S][count]).
__global__ void ffn_dw_reduce_kernel(const float* __restrict__ part1,
                                     const float* __restrict__ part2,
                                     float* __restrict__ dw1,
                                     float* __restrict__ dw2,
                                     long long count, int S) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < 2 * count; i += stride) {
    const bool second = i >= count;
    const float* p = second ? part2 : part1;
    const long long e = second ? i - count : i;
    float acc = __ldg(p + e);
    for (int s = 1; s < S; ++s) acc = acc + __ldg(p + s * count + e);
    (second ? dw2 : dw1)[e] = acc;
  }
}

Product product(const float* a, long long lda, int a_ext, const float* b,
                long long ldb, int b_ext, float* out, int M, int N) {
  Product p;
  p.op = gemm::Operands{a, b, lda, ldb, a_ext, b_ext};
  p.out = out;
  p.M = M;
  p.N = N;
  p.tiles_n = (N + kTile - 1) / kTile;
  p.tiles = ((M + kTile - 1) / kTile) * p.tiles_n;
  return p;
}

template <bool kBf16>
cudaError_t launch(const float* x, const float* dy, const float* w1,
                   const float* w2, float* dw1, float* dw2, float* xT,
                   float* dyT, float* xc, float* dyc, float* w1T, float* w2c,
                   float* a, float* dh, float* part1, float* part2, int T,
                   int d, int ffn, int S, int L, cudaStream_t st) {
  const int T4 = static_cast<int>(up4(T)), d4 = static_cast<int>(up4(d)),
            f4 = static_cast<int>(up4(ffn));
  gemm::prep(x, T, d, xc, d4, xT, T4, kBf16, st);
  gemm::prep(dy, T, d, dyc, d4, dyT, T4, kBf16, st);
  gemm::prep(w1, ffn, d, nullptr, 0, w1T, f4, kBf16, st);
  gemm::prep(w2, d, ffn, w2c, f4, nullptr, 0, kBf16, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int hidden = ((T4 + kTile - 1) / kTile) * ((f4 + kTile - 1) / kTile);
  ffn_dw_hidden_kernel<kBf16><<<hidden, kThreads, gemm::kSmem, st>>>(
      xT, dyT, w1T, w2c, a, dh, T, d, ffn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const bool split = S > 1;
  const Product p0 = product(dh, f4, f4, xc, d4, d4, split ? part1 : dw1,
                             ffn, d);      // dw1 [ffn, d] = dh^T x
  const Product p1 = product(dyc, d4, d4, a, f4, f4, split ? part2 : dw2, d,
                             ffn);         // dw2 [d, ffn] = dy^T a
  ffn_dw_gemm_kernel<<<S * (p0.tiles + p1.tiles), kThreads, gemm::kSmem,
                       st>>>(p0, p1, T, S, L);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  ffn_dw_reduce_kernel<<<1024, 256, 0, st>>>(
      part1, part2, dw1, dw2, static_cast<long long>(ffn) * d, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy [T, d], w1 [ffn, d], w2 [d, ffn] -> dw1 [ffn, d], dw2 [d, ffn];
// all f32. The scratch pieces, each 16-byte aligned (T4, d4, ffn4: T, d
// and ffn rounded up to 4): xT, dyT [d][T4]; xc, dyc [T][d4]; w1T, w2c
// [d][ffn4]; a, dh [T][ffn4]; part1 [S][ffn][d] and part2 [S][d][ffn]
// (unused when S is 1). S slices of L tokens (S = ceil(T / L)).
// mxu_bf16: 0 or 1. Returns a cudaError_t as int; 0 on success.
int ffn_bwd_dw_launch(const float* x, const float* dy, const float* w1,
                      const float* w2, float* dw1, float* dw2, float* xT,
                      float* dyT, float* xc, float* dyc, float* w1T,
                      float* w2c, float* a, float* dh, float* part1,
                      float* part2, int T, int d, int ffn, int S, int L,
                      int mxu_bf16, void* stream) {
  if (T < 1 || d < 1 || ffn < 1 || S < 1 || L < 1 ||
      static_cast<long long>(S - 1) * L >= T ||
      static_cast<long long>(S) * L < T)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch<true>(x, dy, w1, w2, dw1, dw2, xT, dyT, xc, dyc, w1T,
                              w2c, a, dh, part1, part2, T, d, ffn, S, L, st)
               : launch<false>(x, dy, w1, w2, dw1, dw2, xT, dyT, xc, dyc,
                               w1T, w2c, a, dh, part1, part2, T, d, ffn, S,
                               L, st));
}

}  // extern "C"
