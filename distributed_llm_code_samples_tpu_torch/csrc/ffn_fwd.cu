// FFN forward for Hopper (sm_90a): y = relu(x w1^T) w2^T.
//
// Replaces the TPU kernel `ffn_fwd_pallas` (body `_fwd_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function, relu as where(h <= 0, 0, h) (NaN passes). With
// mxu_bf16, x, w1 and w2 are rounded to bf16 and so is a = relu(h)
// (pallas_ffn.py:117-122); sums are f32 either way.
//
// What bounds it: operations. 4*T*d*ffn flops against T*d + 2*d*ffn + T*d
// floats moved; at the main shape (T 8192, d 768, ffn 3072) 77 GFLOP over
// 69 MB, 1.15 ms at the f32 FMA rate of 67 TFLOP/s and some 1100 flops a
// byte, far above the ~20 an H100 needs in f32 before arithmetic is the
// limit (67 TFLOP/s over 3.35 TB/s).
//
// Design: two products on the GEMM core of gemm_core.cuh (a 128 x 128
// tile a block of 256 threads, 8 x 8 sums a thread, a 3-deep ring of
// 16-byte cp.async; two blocks an SM), in the passes of ffn_gemm.cuh.
// The Pallas kernel keeps a [256, d] f32 accumulator and its [256, 512]
// hidden tile in VMEM and never writes the hidden activation out. A
// Hopper block cannot hold a [128 x d] accumulator in registers at d 768,
// and fusing both products on 128 x 128 tiles would recompute h once per
// 128-column band of y. So the hidden activation goes to device memory
// once, as a^T: 2 x 4 x T x ffn bytes written and read, 0.2 GB or about
// 0.06 ms at 3.35 TB/s at the main shape, 5% of the bound.
//   prep: x copied as [d][T4], w1 as [d][ffn4], w2 as [ffn][d4] (T4, d4,
//     ffn4: rounded up to 4; zero padded; rounded to bf16 with mxu_bf16);
//   pass 1: a^T [ffn][T4] = relu(w1 x^T), a 128 ffn x 128 token tile a
//     block (1536 blocks, 5.8 waves of 264 slots at the main shape),
//     computed transposed so that its rows are pass 2's [K][M] operand;
//   pass 2: y = a w2^T with ffn as the depth, a 128 x 128 tile of
//     [T, d] a block. The ffn axis splits into S slices, each summed in
//     order into [S][T][d] partials, only where the output's tiles would
//     not fill one wave of block slots (ops/fused_ffn.py's out_plan): at
//     the main shape its 64 x 6 tiles run unsplit, 1.45 waves of 264
//     slots, which chip_smoke.py's ffn-*-slices sweep found fastest on an
//     H100 (the partials and their reduce cost more than the last wave);
//   reduce (only when S > 1): each y element the sum of its S partials
//     in slice order.
// No atomics, so two calls give the same bits. Ragged T, d and ffn are
// masked in the loads and stores.
//
// Plain C interface, bound with ctypes: the caller allocates y and every
// scratch piece (ops/fused_ffn.py's fwd_scratch has their sizes), passes
// the stream, and gets the first CUDA error back.

#include "ffn_gemm.cuh"

namespace {

using ffn_gemm::fwd;
using gemm::up4;

template <bool kBf16>
cudaError_t launch(const float* x, const float* w1, const float* w2, float* y,
                   float* xT, float* w1T, float* w2T, float* aT, float* part,
                   int T, int d, int ffn, int S, int L, cudaStream_t st) {
  const int T4 = static_cast<int>(up4(T)), d4 = static_cast<int>(up4(d)),
            f4 = static_cast<int>(up4(ffn));
  gemm::prep<fwd>(x, T, d, nullptr, 0, xT, T4, kBf16, st);
  gemm::prep<fwd>(w1, ffn, d, nullptr, 0, w1T, f4, kBf16, st);
  gemm::prep<fwd>(w2, d, ffn, nullptr, 0, w2T, d4, kBf16, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // a^T = relu(w1 x^T), [ffn][T4]
  e = ffn_gemm::hidden<fwd, ffn_gemm::kStoreA, kBf16>(
      ffn_gemm::Hidden{gemm::Operands{w1T, xT, f4, T4, f4, T4}, {}, aT,
                       nullptr, ffn, T4, 0, d},
      st);
  if (e != cudaSuccess) return e;
  return ffn_gemm::sliced<fwd>(
      ffn_gemm::product(aT, T4, T4, w2T, d4, d4, T, d),   // y = a w2^T
      ffn_gemm::Product{}, y, nullptr, part, nullptr, ffn, S, L, st);
}

}  // namespace

extern "C" {

// x [T, d], w1 [ffn, d], w2 [d, ffn] -> y [T, d], all f32. The scratch
// pieces, each 16-byte aligned (T4, d4, ffn4: T, d and ffn rounded up to
// 4): xT [d][T4]; w1T [d][ffn4]; w2T [ffn][d4]; aT [ffn][T4]; part
// [S][T][d] (unused when S is 1). S slices of L ffn columns (S =
// ceil(ffn / L)). mxu_bf16: 0 or 1. Returns a cudaError_t as int; 0 on
// success.
int ffn_fwd_launch(const float* x, const float* w1, const float* w2, float* y,
                   float* xT, float* w1T, float* w2T, float* aT, float* part,
                   int T, int d, int ffn, int S, int L, int mxu_bf16,
                   void* stream) {
  if (T < 1 || d < 1 || ffn < 1 || !ffn_gemm::covers(ffn, S, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch<true>(x, w1, w2, y, xT, w1T, w2T, aT, part, T, d,
                              ffn, S, L, st)
               : launch<false>(x, w1, w2, y, xT, w1T, w2T, aT, part, T, d,
                               ffn, S, L, st));
}

}  // extern "C"
