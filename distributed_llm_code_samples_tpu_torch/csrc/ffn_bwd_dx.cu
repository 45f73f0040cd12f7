// Fused FFN input gradient for Hopper (sm_90a):
//   dx = (1[h > 0] * (dy w2)) w1,  h = x w1^T recomputed.
//
// Replaces the TPU kernel `ffn_bwd_dx_pallas` (body `_bwd_dx_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function: the block input is the only residual, h is recomputed,
// the mask is where(h <= 0, 0, da), and the ffn axis is reduced in an
// f32 accumulator without the [tokens, ffn] tiles going to device
// memory. With mxu_bf16, x, dy, w1 and w2 are rounded to bf16 and so is
// dh (pallas_ffn.py:176-182); sums are f32 either way.
//
// What bounds it: operations. 6*T*d*ffn flops (h, da and dx, each
// 2*T*d*ffn) against 3*T*d + 2*d*ffn floats moved; at the main shape
// (T 8192, d 768, ffn 3072) 116 GFLOP over 94 MB.
//
// Design: ffn_fwd.cu's, with the second operand pair added to the first
// product. A block owns 32 token rows x a 768-column band of dx, the
// [32 x 768] f32 accumulator in 256 threads' registers, and walks ffn in
// tiles of 128 (the loop that replaces the Pallas grid's sequential ffn
// axis):
//   1. h = x w1^T and da = dy w2, [32 x 128] each, over d in steps of 32;
//   2. dh = where(h <= 0, 0, da) goes to shared memory;
//   3. acc += dh w1, with the tile's 128 rows of w1 staged 16 at a time
//      (rows of w1 are contiguous along d: coalesced).
// Past d = 768 each column band recomputes h and da: d/768 times the
// first products' work. Ragged T, d and ffn are masked in loads and
// stores.
//
// Plain C interface, bound with ctypes: the caller allocates dx, passes
// the stream, and gets cudaGetLastError() back.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

// bs[f][c] <- w1[f0 + f, d0 + c] for f < kFC, c < kDT (rows of w1 run
// along d).
struct W1Rows {
  const float* p;
  int f0, d0, ffn, d;
  __device__ void operator()(int i, int& off, const float*& src,
                             bool& ok) const {
    const int c = i % kDT, f = i / kDT, ff = f0 + f, cc = d0 + c;
    off = f * kBS + c;
    ok = ff < ffn && cc < d;
    src = ok ? p + static_cast<size_t>(ff) * d + cc : p;
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_dx_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy,
                      const float* __restrict__ w1,
                      const float* __restrict__ w2, float* __restrict__ dx,
                      int T, int d, int ffn) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* hs = buf + kHiddenFloats;     // [kBF][kXS]: dh, as [f][t]
  float* bs = hs + kBF * kXS;          // 2 x [kFC][kBS]: w1 rows
  const int t0 = blockIdx.x * kBT, d0 = blockIdx.y * kDT;

  float acc[4][24];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 24; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < ffn; f0 += kBF) {
    float h[4][4], da[4][4];
    hidden_tile<kBf16, true>(h, da, x, dy, w1, w2, t0, f0, T, d, ffn, buf);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[i][j] = op<kBf16>(h[i][j] <= 0.f ? 0.f : da[i][j]);
    store_hidden_T(hs, h);
    second_product<kBf16>(acc, hs, bs, f0, ffn, [&](int fc) {
      return W1Rows{w1, f0 + fc, d0, ffn, d};
    });
  }
  store_output(dx, acc, t0, d0, T, d);
}

template <bool kBf16>
cudaError_t launch(const float* x, const float* dy, const float* w1,
                   const float* w2, float* dx, int T, int d, int ffn,
                   cudaStream_t stream) {
  const size_t smem = kFusedFloats * sizeof(float);
  auto kern = ffn_bwd_dx_kernel<kBf16>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + kBT - 1) / kBT, (d + kDT - 1) / kDT);
  kern<<<grid, kThreads, smem, stream>>>(x, dy, w1, w2, dx, T, d, ffn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy [T, d], w1 [ffn, d], w2 [d, ffn] -> dx [T, d], all f32.
// mxu_bf16: 0 or 1. Returns a cudaError_t as int; 0 on success.
int ffn_bwd_dx_launch(const float* x, const float* dy, const float* w1,
                      const float* w2, float* dx, int T, int d, int ffn,
                      int mxu_bf16, void* stream) {
  if (T < 1 || d < 1 || ffn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch<true>(x, dy, w1, w2, dx, T, d, ffn, st)
               : launch<false>(x, dy, w1, w2, dx, T, d, ffn, st));
}

}  // extern "C"
