// The fused LM head's backward for Hopper (sm_90a): dh = dz w and dw =
// dz^T h with dz = (exp(h w^T - lse) - onehot(targets)) / N, the logit
// tiles recomputed and never stored.
//
// Replaces the TPU kernel `head_xent_bwd` (bodies `_bwd_dh_kernel` and
// `_bwd_dw_kernel`) in distributed_llm_code_samples_tpu/ops/pallas_xent.py.
// It computes the same function: dz carries the 1/N of the mean and is
// zero on columns past V (the Pallas kernels' padding; here nothing is
// padded), and the scalar upstream gradient scales both outputs outside
// the kernels. With mxu_bf16, h, w and dz are rounded to bf16 before the
// products.
//
// What bounds it: operations. The function needs three products (z, dh,
// dw), 6*N*d*V flops, against 2*N*d + 2*V*d floats moved; at N 8192,
// d 768, V 50304 that is 1.9 TFLOP over 0.36 GB. The two launches
// execute 8*N*d*V (2.5 TFLOP): each recomputes the logits (2*N*d*V) and
// takes one product with dz.
//
// Design. Two launches, each the shape of the FFN kernels' fused input
// gradient (ffn_bwd_dx.cu), with no atomics, so a launch is bit-for-bit
// deterministic:
//  - dh: a block owns 32 token rows x a 768-column band of dh, the
//    [32 x 768] f32 accumulator in 256 threads' registers, and walks one
//    of `splits` equal chunks of the vocabulary in tiles of 128: the
//    [32 x 128] logit tile over d (ffn_common.cuh's hidden tile, h for x
//    and w for w1), dz into shared memory, then acc += dz w with the
//    tile's 128 rows of w staged 16 at a time. Each chunk's sum goes to
//    its slice of a [splits, N, d] scratch, and a second kernel adds the
//    slices in order. One chain of 50304 sums per element would carry
//    several times the rounding error of the cuBLAS product; `splits`
//    chains of a few thousand do not, and they give the card `splits`
//    times as many blocks (256 at N 8192 are two uneven waves).
//  - dw: the same with the roles of tokens and vocabulary swapped. A
//    block owns 32 vocab rows x a 768-column band of dw and walks all the
//    tokens in tiles of 128: the transposed logit tile w h^T, dz^T into
//    shared memory, acc += dz^T h. Each [32 x 768] sum runs over every
//    token in order, so no partial sums leave the block.
// Past d = 768 each column band recomputes the logit tiles.
//
// Plain C interface, bound with ctypes: the caller allocates dh, dw and
// the dh scratch, passes the stream, and gets cudaGetLastError() back.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

// bs[f][c] <- p[f0 + f, d0 + c] for f < kFC, c < kDT: rows of a [rows, d]
// matrix (w for dh, h for dw), read along d.
struct Rows {
  const float* p;
  int f0, d0, rows, d;
  __device__ void operator()(int i, int& off, const float*& src,
                             bool& ok) const {
    const int c = i % kDT, f = i / kDT, ff = f0 + f, cc = d0 + c;
    off = f * kBS + c;
    ok = ff < rows && cc < d;
    src = ok ? p + static_cast<size_t>(ff) * d + cc : p;
  }
};

// dz of one logit: (exp(z - lse) - [col == target]) / N, 0 off the
// vocabulary or off the tokens.
__device__ __forceinline__ float dz_of(float z, float lse, int col,
                                       int target, bool valid, float inv_n) {
  const float onehot = col == target ? 1.f : 0.f;
  return valid ? (expf(z - lse) - onehot) * inv_n : 0.f;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    head_xent_dh_kernel(const float* __restrict__ h,
                        const float* __restrict__ w,
                        const int* __restrict__ targets,
                        const float* __restrict__ lse,
                        float* __restrict__ part, int N, int d, int V,
                        float inv_n) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* hs = buf + kHiddenFloats;     // [kBF][kXS]: dz, as [vocab][token]
  float* bs = hs + kBF * kXS;          // 2 x [kFC][kBS]: w rows
  const int t0 = blockIdx.x * kBT, d0 = blockIdx.y * kDT;
  // this block's chunk of the vocabulary, in whole tiles
  const int per = ((V + kBF - 1) / kBF + gridDim.z - 1) / gridDim.z;
  const int f_begin = blockIdx.z * per * kBF;
  const int f_end = min(V, f_begin + per * kBF);
  const int r0 = hidden_row(), c0 = hidden_col();

  float lrow[4];
  int tgt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + r0 + i;
    lrow[i] = t < N ? lse[t] : 0.f;
    tgt[i] = t < N ? targets[t] : -1;
  }
  float acc[4][24];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 24; ++j) acc[i][j] = 0.f;

  for (int f0 = f_begin; f0 < f_end; f0 += kBF) {
    float z[4][4], unused[4][4];
    hidden_tile<kBf16, false>(z, unused, h, nullptr, w, nullptr, t0, f0, N,
                              d, V, buf);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = f0 + c0 + j;
        z[i][j] = op<kBf16>(dz_of(z[i][j], lrow[i], col, tgt[i],
                                  col < V && t0 + r0 + i < N, inv_n));
      }
    store_hidden_T(hs, z);
    second_product<kBf16>(acc, hs, bs, f0, V, [&](int fc) {
      return Rows{w, f0 + fc, d0, V, d};
    });
  }
  store_output(part + static_cast<size_t>(blockIdx.z) * N * d, acc, t0, d0,
               N, d);
}

// out[i] = sum over s, in order, of part[s][i], for i < n.
__global__ void sum_slices(const float* __restrict__ part,
                           float* __restrict__ out, size_t n, int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = part[i];
    for (int s = 1; s < splits; ++s) acc += part[s * n + i];
    out[i] = acc;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    head_xent_dw_kernel(const float* __restrict__ h,
                        const float* __restrict__ w,
                        const int* __restrict__ targets,
                        const float* __restrict__ lse, float* __restrict__ dw,
                        int N, int d, int V, float inv_n) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* hs = buf + kHiddenFloats;     // [kBF][kXS]: dz^T, as [token][vocab]
  float* bs = hs + kBF * kXS;          // 2 x [kFC][kBS]: h rows
  const int v0 = blockIdx.x * kBT, d0 = blockIdx.y * kDT;
  const int r0 = hidden_row(), c0 = hidden_col();

  float acc[4][24];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 24; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kBF) {
    // zt[i][j]: vocab row v0 + r0 + i, token n0 + c0 + j
    float zt[4][4], unused[4][4];
    hidden_tile<kBf16, false>(zt, unused, w, nullptr, h, nullptr, v0, n0, V,
                              d, N, buf);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + c0 + j;
      const float ln = n < N ? lse[n] : 0.f;
      const int tn = n < N ? targets[n] : -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int vr = v0 + r0 + i;
        zt[i][j] = op<kBf16>(dz_of(zt[i][j], ln, vr, tn, vr < V && n < N,
                                   inv_n));
      }
    }
    store_hidden_T(hs, zt);
    second_product<kBf16>(acc, hs, bs, n0, N, [&](int fc) {
      return Rows{h, n0 + fc, d0, N, d};
    });
  }
  store_output(dw, acc, v0, d0, V, d);
}

template <bool kBf16>
cudaError_t launch_dh(const float* h, const float* w, const int* targets,
                      const float* lse, float* dh, float* part, int N, int d,
                      int V, int splits, cudaStream_t stream) {
  const size_t smem = kFusedFloats * sizeof(float);
  auto kern = head_xent_dh_kernel<kBf16>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBT - 1) / kBT, (d + kDT - 1) / kDT, splits);
  kern<<<grid, kThreads, smem, stream>>>(h, w, targets, lse, part, N, d, V,
                                         static_cast<float>(1.0 / N));
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return e2;
  const size_t n = static_cast<size_t>(N) * d;
  const size_t blocks = (n + 255) / 256;
  sum_slices<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
               stream>>>(part, dh, n, splits);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_dw(const float* h, const float* w, const int* targets,
                      const float* lse, float* dw, int N, int d, int V,
                      cudaStream_t stream) {
  const size_t smem = kFusedFloats * sizeof(float);
  auto kern = head_xent_dw_kernel<kBf16>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + kBT - 1) / kBT, (d + kDT - 1) / kDT);
  kern<<<grid, kThreads, smem, stream>>>(h, w, targets, lse, dw, N, d, V,
                                         static_cast<float>(1.0 / N));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h [N, d], w [V, d], lse [N] f32, targets [N] int32 -> dh [N, d] f32,
// without the upstream scalar; part is a [splits, N, d] f32 scratch,
// splits in [1, 64]. mxu_bf16: 0 or 1. Returns a cudaError_t as int; 0 on
// success.
int head_xent_dh_launch(const float* h, const float* w, const int* targets,
                        const float* lse, float* dh, float* part, int N,
                        int d, int V, int splits, int mxu_bf16,
                        void* stream) {
  if (N < 1 || d < 1 || V < 1 || splits < 1 || splits > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16
          ? launch_dh<true>(h, w, targets, lse, dh, part, N, d, V, splits, st)
          : launch_dh<false>(h, w, targets, lse, dh, part, N, d, V, splits,
                             st));
}

// The same inputs -> dw [V, d].
int head_xent_dw_launch(const float* h, const float* w, const int* targets,
                        const float* lse, float* dw, int N, int d, int V,
                        int mxu_bf16, void* stream) {
  if (N < 1 || d < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch_dw<true>(h, w, targets, lse, dw, N, d, V, st)
               : launch_dw<false>(h, w, targets, lse, dw, N, d, V, st));
}

}  // extern "C"
