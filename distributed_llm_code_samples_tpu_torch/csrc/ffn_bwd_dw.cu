// FFN weight gradients for Hopper (sm_90a):
//   dw1 = (1[h > 0] * (dy w2))^T x,   dw2 = dy^T relu(h),   h = x w1^T.
//
// Replaces the TPU kernel `ffn_bwd_dw_pallas` (body `_bwd_dw_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function, with h recomputed from the block input and the mask
// where(h <= 0, 0, da). With mxu_bf16, x, dy, w1 and w2 are rounded to
// bf16 and so are a = relu(h) and dh (pallas_ffn.py:231-242); sums are
// f32 either way.
//
// What bounds it: operations. 8*T*d*ffn flops (h, da, dw1, dw2) against
// 2*T*d + 4*d*ffn floats moved; at the main shape (T 8192, d 768,
// ffn 3072) 155 GFLOP over 88 MB.
//
// Design: two passes in one call, not one fused pass.
// The Pallas kernel reduces over tokens in two [256, d] f32 accumulators
// per ffn tile, carried across its sequential token axis. A Hopper block
// can hold about 2 x 16 x 768 such sums in registers, so a fused version
// would own 16 ffn rows and re-read all of x and dy for every 16 rows
// (2 x 192 x 25 MB from L2 at the main shape, several times the
// arithmetic's own time) or recompute h per column band of d. Instead:
//   pass 1 (`ffn_dw_hidden_kernel`): a = relu(h) and dh = where(h <= 0,
//     0, dy w2) for [32 tokens x 128 ffn] tiles (ffn_common.cuh's hidden
//     tile), written to two [T, ffn] f32 scratch arrays the caller
//     allocates: 2 x 4 x T x ffn bytes written and read once, 0.4 GB or
//     about 0.12 ms at 3.35 TB/s at the main shape, a few percent of the
//     f32 operation bound;
//   pass 2 (`ffn_dw_gemm_kernel`): both products C = A^T B with the
//     token axis as the depth, dw1 = dh^T x and dw2 = dy^T a, in one
//     launch over [64 x 64] output tiles, 4 x 4 sums a thread. Each
//     output tile walks all T tokens in order inside its block, the loop
//     that replaces the Pallas grid's sequential token axis. At the main
//     shape that is 2 x 576 blocks, so the token axis needs no split and
//     no second reduction; the sums have one fixed order and no atomics,
//     so the result is bit-for-bit the same from run to run.
// Ragged T, d and ffn are masked in loads and stores.
//
// Plain C interface, bound with ctypes: the caller allocates dw1, dw2 and
// the two scratch arrays, passes the stream, and gets cudaGetLastError()
// back.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

constexpr int kGM = 64;          // output rows of a pass-2 tile
constexpr int kGN = 64;          // output columns of a pass-2 tile
constexpr int kGK = 16;          // tokens of one pass-2 step
constexpr int kGS = kGM + 4;     // row stride of the pass-2 operand tiles

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    ffn_dw_hidden_kernel(const float* __restrict__ x,
                         const float* __restrict__ dy,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2,
                         float* __restrict__ a_out,
                         float* __restrict__ dh_out, int T, int d, int ffn) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* as = buf + kHiddenFloats;     // [kBT][kWS]: a, as [t][f]
  float* dhs = as + kBT * kWS;         // [kBT][kWS]: dh
  const int t0 = blockIdx.x * kBT, f0 = blockIdx.y * kBF;

  float h[4][4], da[4][4];
  hidden_tile<kBf16, true>(h, da, x, dy, w1, w2, t0, f0, T, d, ffn, buf);
  const int r0 = hidden_row(), c0 = hidden_col();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float av[4], dv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      av[j] = op<kBf16>(relu(h[i][j]));
      dv[j] = op<kBf16>(h[i][j] <= 0.f ? 0.f : da[i][j]);
    }
    *reinterpret_cast<float4*>(as + (r0 + i) * kWS + c0) =
        make_float4(av[0], av[1], av[2], av[3]);
    *reinterpret_cast<float4*>(dhs + (r0 + i) * kWS + c0) =
        make_float4(dv[0], dv[1], dv[2], dv[3]);
  }
  __syncthreads();
  // rows of the tile out to [T, ffn], along ffn
  for (int i = threadIdx.x; i < kBT * kBF; i += kThreads) {
    const int f = i % kBF, r = i / kBF;
    const int t = t0 + r, ff = f0 + f;
    if (t < T && ff < ffn) {
      const size_t o = static_cast<size_t>(t) * ffn + ff;
      a_out[o] = as[r * kWS + f];
      dh_out[o] = dhs[r * kWS + f];
    }
  }
}

// C[M, N] = sum_k A[k, m] B[k, n], with A [K, M] and B [K, N] row-major.
struct Product {
  const float* a;
  const float* b;
  float* c;
  int m, n;
};

// [kGK][kGS] <- p[k0 + k, c0 + c]: a band of kGK rows (tokens) and kGM
// columns of a [K, width] operand.
struct Band {
  const float* p;
  int k0, c0, K, width;
  __device__ void operator()(int i, int& off, const float*& src,
                             bool& ok) const {
    const int c = i % kGM, kk = i / kGM, k = k0 + kk, cc = c0 + c;
    off = kk * kGS + c;
    ok = k < K && cc < width;
    src = ok ? p + static_cast<size_t>(k) * width + cc : p;
  }
};

template <bool kBf16, bool kRound>
__device__ __forceinline__ void bands(float* as, float* bs, const Product& p,
                                      int k0, int m0, int n0, int K) {
  move<kBf16, kRound, kGK * kGM>(as, Band{p.a, k0, m0, K, p.m});
  move<kBf16, kRound, kGK * kGN>(bs, Band{p.b, k0, n0, K, p.n});
}

// Blocks 0..tiles0-1 compute p0's tiles, the rest p1's. Rounding an
// operand that pass 1 already rounded to bf16 leaves it as it is, so
// both operands of both products go through the same op<kBf16>.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    ffn_dw_gemm_kernel(Product p0, Product p1, int tiles0, int K) {
  __shared__ __align__(16) float as[2][kGK * kGS];
  __shared__ __align__(16) float bs[2][kGK * kGS];
  int tile = blockIdx.x;
  const Product p = tile < tiles0 ? p0 : p1;
  if (tile >= tiles0) tile -= tiles0;
  const int tiles_n = (p.n + kGN - 1) / kGN;
  const int m0 = (tile / tiles_n) * kGM, n0 = (tile % tiles_n) * kGN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int steps = (K + kGK - 1) / kGK;
  bands<kBf16, false>(as[0], bs[0], p, 0, m0, n0, K);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {                 // next band's copies in flight
      bands<kBf16, false>(as[cur ^ 1], bs[cur ^ 1], p, (s + 1) * kGK, m0, n0,
                          K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    bands<kBf16, true>(as[cur], bs[cur], p, s * kGK, m0, n0, K);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGK; ++k) {
      const float4 a =
          *reinterpret_cast<const float4*>(&as[cur][k * kGS + ty * 4]);
      const float4 b =
          *reinterpret_cast<const float4*>(&bs[cur][k * kGS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();                     // cur may be refilled next
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.n) p.c[static_cast<size_t>(m) * p.n + n] = acc[i][j];
    }
  }
}

int tiles(const Product& p) {
  return ((p.m + kGM - 1) / kGM) * ((p.n + kGN - 1) / kGN);
}

template <bool kBf16>
cudaError_t launch(const float* x, const float* dy, const float* w1,
                   const float* w2, float* dw1, float* dw2, float* a,
                   float* dh, int T, int d, int ffn, cudaStream_t stream) {
  const size_t smem = (kHiddenFloats + 2 * kBT * kWS) * sizeof(float);
  auto hidden = ffn_dw_hidden_kernel<kBf16>;
  cudaError_t e = set_smem(reinterpret_cast<const void*>(hidden), smem);
  if (e != cudaSuccess) return e;
  hidden<<<dim3((T + kBT - 1) / kBT, (ffn + kBF - 1) / kBF), kThreads, smem,
           stream>>>(x, dy, w1, w2, a, dh, T, d, ffn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Product p0{dh, x, dw1, ffn, d};      // dw1 [ffn, d] = dh^T x
  const Product p1{dy, a, dw2, d, ffn};      // dw2 [d, ffn] = dy^T a
  const int t0 = tiles(p0);
  ffn_dw_gemm_kernel<kBf16><<<t0 + tiles(p1), kThreads, 0, stream>>>(
      p0, p1, t0, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy [T, d], w1 [ffn, d], w2 [d, ffn] -> dw1 [ffn, d], dw2 [d, ffn];
// a_scratch, dh_scratch [T, ffn]; all f32. mxu_bf16: 0 or 1. Returns a
// cudaError_t as int; 0 on success.
int ffn_bwd_dw_launch(const float* x, const float* dy, const float* w1,
                      const float* w2, float* dw1, float* dw2,
                      float* a_scratch, float* dh_scratch, int T, int d,
                      int ffn, int mxu_bf16, void* stream) {
  if (T < 1 || d < 1 || ffn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch<true>(x, dy, w1, w2, dw1, dw2, a_scratch, dh_scratch,
                              T, d, ffn, st)
               : launch<false>(x, dy, w1, w2, dw1, dw2, a_scratch,
                               dh_scratch, T, d, ffn, st));
}

}  // extern "C"
