// Fused FFN forward for Hopper (sm_90a): y = relu(x w1^T) w2^T.
//
// Replaces the TPU kernel `ffn_fwd_pallas` (body `_fwd_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function: the ffn axis is reduced in an f32 accumulator and the
// [tokens, ffn] hidden activation never goes to device memory. With
// mxu_bf16, x, w1 and w2 are rounded to bf16 and so is a = relu(h)
// (pallas_ffn.py:117-122); sums are f32 either way.
//
// What bounds it: operations. 4*T*d*ffn flops against T*d + 2*d*ffn + T*d
// floats moved; at T 8192, d 768, ffn 3072 that is 77 GFLOP over 69 MB,
// some 1100 flops a byte, far above the ~20 an H100 needs in f32 before
// arithmetic is the limit (67 TFLOP/s over 3.35 TB/s).
//
// Design. The Pallas kernel keeps a [256, d] f32 accumulator and a
// [256, 512] hidden tile in VMEM (1.25 MB at d 768); a Hopper block has
// 227 KB of shared memory. So a block owns a thin token tile of 32 rows
// across a band of 768 output columns (all of d at d <= 768), with the
// [32 x 768] accumulator spread over 256 threads' registers (96 a
// thread). It walks the ffn axis in tiles of 128, the loop that takes
// the place of the Pallas grid's sequential ffn axis:
//   1. h[32 x 128] = x w1^T over d, in steps of 32 (ffn_common.cuh);
//   2. a = relu(h) goes to shared memory, never to device memory;
//   3. acc += a w2^T, with the 128 w2 columns staged 16 at a time as
//      [16 x 768] rows, read along ffn (w2 is [d, ffn]).
// h is computed once per token tile when d <= 768. A wider d takes one
// block per 768-column band, and each band recomputes h: d/768 times the
// first product's work. At T 8192 there are 256 blocks of 8 warps, about
// two waves over 132 SMs with one block resident per SM. The weights are
// read once per token tile from L2 (256 x 19 MB at the main shape).
// Ragged T, d and ffn are masked in the loads (zeros) and the stores.
//
// Plain C interface, bound with ctypes: the caller allocates y, passes
// the stream, and gets cudaGetLastError() back.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

// bs[f][c] <- w2[d0 + c, f0 + f] for f < kFC, c < kDT: the rows of w2^T,
// read along ffn (w2 is [d, ffn]).
struct W2Cols {
  const float* p;
  int f0, d0, ffn, d;
  __device__ void operator()(int i, int& off, const float*& src,
                             bool& ok) const {
    const int f = i % kFC, c = i / kFC, ff = f0 + f, cc = d0 + c;
    off = f * kBS + c;
    ok = ff < ffn && cc < d;
    src = ok ? p + static_cast<size_t>(cc) * ffn + ff : p;
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ w2, float* __restrict__ y, int T,
                   int d, int ffn) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* hs = buf + kHiddenFloats;     // [kBF][kXS]: a, as [f][t]
  float* bs = hs + kBF * kXS;          // 2 x [kFC][kBS]: w2^T rows
  const int t0 = blockIdx.x * kBT, d0 = blockIdx.y * kDT;

  float acc[4][24];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 24; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < ffn; f0 += kBF) {
    float h[4][4], unused[4][4];
    hidden_tile<kBf16, false>(h, unused, x, nullptr, w1, nullptr, t0, f0, T,
                              d, ffn, buf);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = op<kBf16>(relu(h[i][j]));
    store_hidden_T(hs, h);
    second_product<kBf16>(acc, hs, bs, f0, ffn, [&](int fc) {
      return W2Cols{w2, f0 + fc, d0, ffn, d};
    });
  }
  store_output(y, acc, t0, d0, T, d);
}

template <bool kBf16>
cudaError_t launch(const float* x, const float* w1, const float* w2, float* y,
                   int T, int d, int ffn, cudaStream_t stream) {
  const size_t smem = kFusedFloats * sizeof(float);
  auto kern = ffn_fwd_kernel<kBf16>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + kBT - 1) / kBT, (d + kDT - 1) / kDT);
  kern<<<grid, kThreads, smem, stream>>>(x, w1, w2, y, T, d, ffn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [T, d], w1 [ffn, d], w2 [d, ffn] -> y [T, d], all f32. mxu_bf16: 0 or
// 1. Returns a cudaError_t as int; 0 on success.
int ffn_fwd_launch(const float* x, const float* w1, const float* w2, float* y,
                   int T, int d, int ffn, int mxu_bf16, void* stream) {
  if (T < 1 || d < 1 || ffn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch<true>(x, w1, w2, y, T, d, ffn, st)
               : launch<false>(x, w1, w2, y, T, d, ffn, st));
}

}  // extern "C"
