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
// 16-byte cp.async; two blocks an SM), in the passes of ffn_gemm.cuh:
//   prep: x and dy copied as [T][d4] and [d][T4], w1 as [d][ffn4] and w2
//     as [d][ffn4] (d4, T4, ffn4: rounded up to 4; zero padded; rounded
//     to bf16 with mxu_bf16), so that every operand of every product is
//     a row-major [K][M] or [K][N] array read as 16-byte vectors;
//   pass 1: a block owns a [128 tokens x 128 ffn] tile; it sums h over d,
//     writes a = relu(h) to a [T][ffn4] scratch and keeps only h's 64
//     mask bits a thread, then sums da = dy w2 over d in the same
//     registers and writes dh = mask ? da : 0 to a second [T][ffn4]
//     scratch (2 x 4 x T x ffn bytes written and read once, 0.4 GB or
//     about 0.12 ms at 3.35 TB/s at the main shape);
//   pass 2: dw1 = dh^T x and dw2 = dy^T a, with the token axis as the
//     depth. Their 2 x 144 tiles at the main shape would fill 264 block
//     slots (132 SMs x 2) 1.09 times, a second wave of 24 blocks with the
//     card idle around it; so the token axis splits into S slices
//     (ops/fused_ffn.py's dw_plan: the fewest that fill four waves), each
//     block sums one tile over one slice in order, and the partials go to
//     [S][ffn][d] and [S][d][ffn] scratch;
//   reduce (only when S > 1): each output element is the sum of its S
//     partials in slice order.
// No atomics: every output element has one fixed order of summation (k
// in order within a slice, then slices in order), so two calls give the
// same bits. Ragged T, d and ffn are masked in the loads and stores.
//
// Plain C interface, bound with ctypes: the caller allocates dw1, dw2 and
// every scratch piece (ops/fused_ffn.py's dw_scratch has their sizes),
// passes the stream, and gets the first CUDA error back.

#include "ffn_gemm.cuh"

namespace {

using gemm::up4;
using ffn_gemm::dw;

template <bool kBf16>
cudaError_t launch(const float* x, const float* dy, const float* w1,
                   const float* w2, float* dw1, float* dw2, float* xT,
                   float* dyT, float* xc, float* dyc, float* w1T, float* w2c,
                   float* a, float* dh, float* part1, float* part2, int T,
                   int d, int ffn, int S, int L, cudaStream_t st) {
  const int T4 = static_cast<int>(up4(T)), d4 = static_cast<int>(up4(d)),
            f4 = static_cast<int>(up4(ffn));
  gemm::prep<dw>(x, T, d, xc, d4, xT, T4, kBf16, st);
  gemm::prep<dw>(dy, T, d, dyc, d4, dyT, T4, kBf16, st);
  gemm::prep<dw>(w1, ffn, d, nullptr, 0, w1T, f4, kBf16, st);
  gemm::prep<dw>(w2, d, ffn, w2c, f4, nullptr, 0, kBf16, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // h = x w1^T and da = dy w2, [T][ffn4]
  e = ffn_gemm::hidden<dw, ffn_gemm::kStoreA | ffn_gemm::kStoreDh, kBf16>(
      ffn_gemm::Hidden{gemm::Operands{xT, w1T, T4, f4, T4, f4},
                       gemm::Operands{dyT, w2c, T4, f4, T4, f4}, a, dh, T,
                       f4, 0, d},
      st);
  if (e != cudaSuccess) return e;
  return ffn_gemm::sliced<dw>(
      ffn_gemm::product(dh, f4, f4, xc, d4, d4, ffn, d),    // dw1 = dh^T x
      ffn_gemm::product(dyc, d4, d4, a, f4, f4, d, ffn),    // dw2 = dy^T a
      dw1, dw2, part1, part2, T, S, L, st);
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
  if (T < 1 || d < 1 || ffn < 1 || !ffn_gemm::covers(T, S, L))
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
