// FFN input gradient for Hopper (sm_90a):
//   dx = (1[h > 0] * (dy w2)) w1,  h = x w1^T recomputed.
//
// Replaces the TPU kernel `ffn_bwd_dx_pallas` (body `_bwd_dx_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function: the block input is the only residual, h is recomputed,
// and the mask is where(h <= 0, 0, da) (NaN passes). With mxu_bf16, x,
// dy, w1 and w2 are rounded to bf16 and so is dh (pallas_ffn.py:176-182);
// sums are f32 either way.
//
// What bounds it: operations. 6*T*d*ffn flops (h, da and dx, each
// 2*T*d*ffn) against 3*T*d + 2*d*ffn floats moved; at the main shape
// (T 8192, d 768, ffn 3072) 116 GFLOP over 94 MB, 1.73 ms at the f32 FMA
// rate of 67 TFLOP/s.
//
// Design: three products on the GEMM core of gemm_core.cuh (a 128 x 128
// tile a block of 256 threads, 8 x 8 sums a thread, a 3-deep ring of
// 16-byte cp.async; two blocks an SM), in the passes of ffn_gemm.cuh.
// The Pallas kernel keeps a [256, d] f32 accumulator and its hidden
// tiles in VMEM and never writes dh out. A Hopper block cannot hold a
// [128 x d] accumulator in registers at d 768, and fusing on 128 x 128
// tiles would recompute h and da once per 128-column band of dx. So dh
// goes to device memory once, as dh^T: 2 x 4 x T x ffn bytes written and
// read, 0.2 GB or about 0.06 ms at 3.35 TB/s at the main shape, 3.5% of
// the bound.
//   prep: x and dy copied as [d][T4], w1 as [d][ffn4] and [ffn][d4], w2
//     as [d][ffn4] (T4, d4, ffn4: rounded up to 4; zero padded; rounded
//     to bf16 with mxu_bf16; w1 [ffn][d4] in the same launch as w1^T);
//   pass 1: a 128 ffn x 128 token tile a block (1536 blocks, 5.8 waves of
//     264 slots at the main shape), computed transposed so that its rows
//     are pass 2's [K][M] operand: h^T = w1 x^T over d, kept as 64 mask
//     bits a thread, then da^T = w2^T dy^T over d in the same registers,
//     and dh^T [ffn][T4] = where(h <= 0, 0, da) out;
//   pass 2: dx = dh w1 with ffn as the depth, a 128 x 128 tile of
//     [T, d] a block. The ffn axis splits into S slices, each summed in
//     order into [S][T][d] partials, only where the output's tiles would
//     not fill one wave of block slots (ops/fused_ffn.py's out_plan): at
//     the main shape its 64 x 6 tiles run unsplit, 1.45 waves of 264
//     slots, which chip_smoke.py's ffn-*-slices sweep found fastest on an
//     H100 (the partials and their reduce cost more than the last wave);
//   reduce (only when S > 1): each dx element the sum of its S partials
//     in slice order.
// No atomics, so two calls give the same bits. Ragged T, d and ffn are
// masked in the loads and stores.
//
// Plain C interface, bound with ctypes: the caller allocates dx and every
// scratch piece (ops/fused_ffn.py's dx_scratch has their sizes), passes
// the stream, and gets the first CUDA error back.

#include "ffn_gemm.cuh"

namespace {

using gemm::up4;
using Tag = ffn_gemm::dx;

template <bool kBf16>
cudaError_t launch(const float* x, const float* dy, const float* w1,
                   const float* w2, float* dx, float* xT, float* dyT,
                   float* w1T, float* w2c, float* w1c, float* dhT,
                   float* part, int T, int d, int ffn, int S, int L,
                   cudaStream_t st) {
  const int T4 = static_cast<int>(up4(T)), d4 = static_cast<int>(up4(d)),
            f4 = static_cast<int>(up4(ffn));
  gemm::prep<Tag>(x, T, d, nullptr, 0, xT, T4, kBf16, st);
  gemm::prep<Tag>(dy, T, d, nullptr, 0, dyT, T4, kBf16, st);
  gemm::prep<Tag>(w1, ffn, d, w1c, d4, w1T, f4, kBf16, st);
  gemm::prep<Tag>(w2, d, ffn, w2c, f4, nullptr, 0, kBf16, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // h^T = w1 x^T, da^T = w2^T dy^T; dh^T [ffn][T4] out
  e = ffn_gemm::hidden<Tag, ffn_gemm::kStoreDh, kBf16>(
      ffn_gemm::Hidden{gemm::Operands{w1T, xT, f4, T4, f4, T4},
                       gemm::Operands{w2c, dyT, f4, T4, f4, T4}, nullptr, dhT,
                       ffn, T4, 0, d},
      st);
  if (e != cudaSuccess) return e;
  return ffn_gemm::sliced<Tag>(
      ffn_gemm::product(dhT, T4, T4, w1c, d4, d4, T, d),   // dx = dh w1
      ffn_gemm::Product{}, dx, nullptr, part, nullptr, ffn, S, L, st);
}

}  // namespace

extern "C" {

// x, dy [T, d], w1 [ffn, d], w2 [d, ffn] -> dx [T, d], all f32. The
// scratch pieces, each 16-byte aligned (T4, d4, ffn4: T, d and ffn
// rounded up to 4): xT, dyT [d][T4]; w1T, w2c [d][ffn4]; w1c [ffn][d4];
// dhT [ffn][T4]; part [S][T][d] (unused when S is 1). S slices of L ffn
// rows (S = ceil(ffn / L)). mxu_bf16: 0 or 1. Returns a cudaError_t as
// int; 0 on success.
int ffn_bwd_dx_launch(const float* x, const float* dy, const float* w1,
                      const float* w2, float* dx, float* xT, float* dyT,
                      float* w1T, float* w2c, float* w1c, float* dhT,
                      float* part, int T, int d, int ffn, int S, int L,
                      int mxu_bf16, void* stream) {
  if (T < 1 || d < 1 || ffn < 1 || !ffn_gemm::covers(ffn, S, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch<true>(x, dy, w1, w2, dx, xT, dyT, w1T, w2c, w1c, dhT,
                              part, T, d, ffn, S, L, st)
               : launch<false>(x, dy, w1, w2, dx, xT, dyT, w1T, w2c, w1c,
                               dhT, part, T, d, ffn, S, L, st));
}

}  // extern "C"
