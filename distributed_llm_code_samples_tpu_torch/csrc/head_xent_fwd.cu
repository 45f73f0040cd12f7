// The fused LM head's forward statistics for Hopper (sm_90a): per token
// row, lse = logsumexp(h w^T) over the vocabulary and tz = the target's
// logit, with the [N, V] logits never stored.
//
// Replaces the TPU kernel `head_xent_stats` (body `_fwd_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_xent.py. It computes the
// same function: an online logsumexp over vocab tiles and the target
// column picked by a match that only real vocab columns can make (a
// target outside [0, V) gives tz = 0). The loss, mean(lse - tz), is
// taken outside. With mxu_bf16, h and w are rounded to bf16.
//
// What bounds it: operations. 2*N*d*V flops against N*d + V*d floats
// read; at N 8192, d 768, V 50304 that is 0.63 TFLOP over 180 MB.
//
// Design. The Pallas kernel zero-pads w to a multiple of its vocab tile
// (a 154 MB copy per call at V 50304); here the vocab edge is masked in
// the kernel. A block owns 32 token rows and walks the vocabulary in
// tiles of 128 (the loop that replaces the Pallas grid's sequential
// vocab axis), each [32 x 128] logit tile computed over d by
// ffn_common.cuh's hidden tile (with h for x). Each thread keeps its own running (max, sum of
// exp) for its 4 rows over the columns it computes, and the 32 threads
// of a row merge theirs once at the end, by shuffles within a warp and
// through shared memory across warps, in a fixed order: no atomics, and
// a launch is bit-for-bit deterministic.
//
// Plain C interface, bound with ctypes: the caller allocates lse and tz,
// passes the stream, and gets cudaGetLastError() back.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

constexpr float kNeg = -1e30f;
constexpr int kWarps = kThreads / 32;

// (m, s) += (m2, s2) for s = sum of exp(z - m).
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    head_xent_stats_kernel(const float* __restrict__ h,
                           const float* __restrict__ w,
                           const int* __restrict__ targets,
                           float* __restrict__ lse, float* __restrict__ tz,
                           int N, int d, int V) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int t0 = blockIdx.x * kBT;
  const int r0 = hidden_row(), c0 = hidden_col();

  float m[4], s[4], zt[4];
  int tgt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + r0 + i;
    m[i] = kNeg, s[i] = 0.f, zt[i] = 0.f;
    tgt[i] = t < N ? targets[t] : -1;
  }

  for (int f0 = 0; f0 < V; f0 += kBF) {
    float z[4][4];
    hidden_tile<kBf16>(z, h, w, t0, f0, N, d, V, buf);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (f0 + c0 + j < V) mx = fmaxf(mx, z[i][j]);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = f0 + c0 + j;
        if (col < V) {
          sum += expf(z[i][j] - m_new);
          if (col == tgt[i]) zt[i] += z[i][j];
        }
      }
      s[i] = s[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }

  // the 4 lanes of a warp that share rows (lane % 4 differs), then the 8
  // warps, in warp order
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], o);
      zt[i] += __shfl_xor_sync(0xffffffffu, zt[i], o);
      merge(m[i], s[i], m2, s2);
    }
  // buf is free: hidden_tile's last barrier passed
  float* red_m = buf;                     // [kWarps][kBT]
  float* red_s = red_m + kWarps * kBT;
  float* red_z = red_s + kWarps * kBT;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red_m[warp * kBT + r0 + i] = m[i];
      red_s[warp * kBT + r0 + i] = s[i];
      red_z[warp * kBT + r0 + i] = zt[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < kBT && t0 + threadIdx.x < N) {
    const int r = threadIdx.x;
    float mm = red_m[r], ss = red_s[r], zz = red_z[r];
    for (int q = 1; q < kWarps; ++q) {
      merge(mm, ss, red_m[q * kBT + r], red_s[q * kBT + r]);
      zz += red_z[q * kBT + r];
    }
    lse[t0 + r] = mm + logf(ss);
    tz[t0 + r] = zz;
  }
}

template <bool kBf16>
cudaError_t launch(const float* h, const float* w, const int* targets,
                   float* lse, float* tz, int N, int d, int V,
                   cudaStream_t stream) {
  const size_t smem = kHiddenFloats * sizeof(float);
  auto kern = head_xent_stats_kernel<kBf16>;
  const cudaError_t e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBT - 1) / kBT);
  kern<<<grid, kThreads, smem, stream>>>(h, w, targets, lse, tz, N, d, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h [N, d], w [V, d] f32, targets [N] int32 -> lse [N], tz [N] f32.
// mxu_bf16: 0 or 1. Returns a cudaError_t as int; 0 on success.
int head_xent_stats_launch(const float* h, const float* w, const int* targets,
                           float* lse, float* tz, int N, int d, int V,
                           int mxu_bf16, void* stream) {
  if (N < 1 || d < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch<true>(h, w, targets, lse, tz, N, d, V, st)
               : launch<false>(h, w, targets, lse, tz, N, d, V, st));
}

}  // extern "C"
