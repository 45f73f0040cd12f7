// Paged decode attention for Hopper (sm_90a): single-query attention of
// every (slot, KV head) straight from the paged KV pool.
//
// Replaces the TPU kernel `paged_decode_attn` in
// distributed_llm_code_samples_tpu/ops/pallas_paged_attention.py
// (`_walk_kernel`, `_walk_kernel_q8`, body `_tile`). It computes the same
// function: for slot i and query head hq = h*G + g,
//   s[t] = (q[i, hq] . k[table[i, t/blk], h, t%blk]) / sqrt(dh)   t < len[i]
//   s[t] = -1e30                                                   t >= len[i]
//   y[i, hq] = sum_t softmax(s)[t] * v[table[i, t/blk], h, t%blk]
// with bf16 widened by __bfloat162float and int8 widened to f32 and
// multiplied by its block's scale (k_scale[table[i, j], h]), the order of
// the TPU kernel's `_tile`. Compute and output are f32.
//
// What bounds it: the bytes it reads. A decode step does 2 flops per KV
// element it loads, far below the ~20 flop/byte an H100 needs (67 TFLOP/s
// f32 over 3.35 TB/s) before arithmetic is the limit, so the least time
// is (live KV bytes at the storage type + int8 scales + q + y) / 3.35 TB/s.
// What the design does about it: the pool is read at its storage type
// (a bf16 or int8 pool moves 2x or 4x fewer bytes than the f32 gathered
// view the gather path materializes), every K and V row is read once by
// one warp with neighbouring lanes on neighbouring elements (coalesced),
// and blocks at or past the slot's length are never read.
//
// Design: one thread block per (slot, KV head), with the G = H/H_kv query
// rows of that head. The block walks its slot's table itself, reading
// tables[i, j] from global memory; that loop takes the place of the
// Pallas scalar-prefetch index map and its sequential j grid axis, whose
// VMEM scratch carried across grid steps has no CUDA counterpart across
// blocks. The Pallas kernel holds the whole V row [tcap, dh] in VMEM,
// which at tcap = 1024, dh = 64 is 256 KB, more than the 227 KB a block
// may use. So V is never staged whole:
//   pass 1: each warp scores live positions into a shared [G, tcap] f32
//           row (4 KB a query row at tcap = 1024);
//   softmax over the row in decode_attn's order: the scale is applied
//           before the mask, max, exp(s - max), then divide by the sum;
//   pass 2: the live V rows are read again from global memory and each
//           warp accumulates p * V for its positions into shared memory;
//           the warps' partial sums are added at the end.
// This is an assemble-then-softmax design, not a flash-style rescaling
// accumulator. Sums are taken in another order than XLA's, so the result
// agrees with the plain version to rounding, not bit for bit.
//
// Plain C interface, bound with ctypes: the caller allocates `y`, passes
// the stream, and gets cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;             // decode_attn's mask value
constexpr size_t kMaxSmem = 232448;         // 227 KB a block may use on sm_90

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float widen<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduce one value per thread over the block; every thread gets the
// result. `red` holds kWarps floats of shared scratch.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();                        // red may still be read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Shared floats: q [G, dh], scores [G, tcap], partial p.V [kWarps, G, dh],
// reduction scratch [kWarps].
__host__ __device__ inline size_t smem_floats(int g, int dh, int tcap) {
  return static_cast<size_t>(g) * dh + static_cast<size_t>(g) * tcap +
         static_cast<size_t>(kWarps) * g * dh + kWarps;
}

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads) paged_decode_attn_kernel(
    const float* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ y, int hq, int hkv,
    int blk, int dh, int mb) {
  const int i = blockIdx.x;               // slot
  const int h = blockIdx.y;               // KV head
  const int g_n = hq / hkv;
  const int tcap = mb * blk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                      // [G, dh]
  float* s_s = q_s + g_n * dh;            // [G, tcap]
  float* acc_s = s_s + g_n * tcap;        // [kWarps, G, dh]
  float* red_s = acc_s + kWarps * g_n * dh;

  // positions 0..len-1 are live; callers guarantee 1 <= len <= tcap
  const int len = min(lengths[i], tcap);
  const int* table = tables + static_cast<size_t>(i) * mb;
  const size_t qy_off = (static_cast<size_t>(i) * hq + h * g_n) * dh;
  const size_t head_stride = static_cast<size_t>(blk) * dh;

  for (int e = threadIdx.x; e < g_n * dh; e += kThreads) q_s[e] = q[qy_off + e];
  for (int e = threadIdx.x; e < kWarps * g_n * dh; e += kThreads) acc_s[e] = 0.f;
  __syncthreads();

  const float root_dh = sqrtf(static_cast<float>(dh));

  // pass 1: raw scores of the live positions, one position per warp
  for (int t = warp; t < len; t += kWarps) {
    const int phys = table[t / blk];
    const T* krow = pool_k + (static_cast<size_t>(phys) * hkv + h) * head_stride +
                    static_cast<size_t>(t % blk) * dh;
    const float sc = kScaled ? k_scale[static_cast<size_t>(phys) * hkv + h] : 1.f;
    for (int g = 0; g < g_n; ++g) {
      float part = 0.f;
      for (int d = lane; d < dh; d += 32) {
        float kv = widen<T>(krow[d]);
        if (kScaled) kv *= sc;
        part += q_s[g * dh + d] * kv;
      }
      part = warp_sum(part);
      if (lane == 0) s_s[g * tcap + t] = part / root_dh;
    }
  }
  __syncthreads();

  // softmax over each assembled row; positions >= len hold kNeg, whose
  // exp(kNeg - max) is exactly 0, so only the live ones are visited
  for (int g = 0; g < g_n; ++g) {
    float* row = s_s + g * tcap;
    float m = kNeg;
    for (int t = threadIdx.x; t < len; t += kThreads) m = fmaxf(m, row[t]);
    m = block_reduce<true>(m, red_s);
    float sum = 0.f;
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red_s);
    for (int t = threadIdx.x; t < len; t += kThreads) row[t] = row[t] / sum;
  }
  __syncthreads();

  // pass 2: p . V over the live positions, re-read from global memory
  float* acc_w = acc_s + warp * g_n * dh;
  for (int t = warp; t < len; t += kWarps) {
    const int phys = table[t / blk];
    const T* vrow = pool_v + (static_cast<size_t>(phys) * hkv + h) * head_stride +
                    static_cast<size_t>(t % blk) * dh;
    const float sc = kScaled ? v_scale[static_cast<size_t>(phys) * hkv + h] : 1.f;
    for (int d = lane; d < dh; d += 32) {
      float vv = widen<T>(vrow[d]);
      if (kScaled) vv *= sc;
      for (int g = 0; g < g_n; ++g) acc_w[g * dh + d] += s_s[g * tcap + t] * vv;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < g_n * dh; e += kThreads) {
    float r = 0.f;
    for (int w = 0; w < kWarps; ++w) r += acc_s[w * g_n * dh + e];
    y[qy_off + e] = r;
  }
}

template <typename T, bool kScaled>
cudaError_t launch(const float* q, const void* pool_k, const void* pool_v,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* lengths, float* y, int b,
                   int hq, int hkv, int blk, int dh, int mb, size_t smem,
                   cudaStream_t stream) {
  auto kern = paged_decode_attn_kernel<T, kScaled>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(b, hkv), kThreads, smem, stream>>>(
      q, static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      k_scale, v_scale, tables, lengths, y, hq, hkv, blk, dh, mb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t paged_decode_attn_smem_bytes(int g, int dh, int tcap) {
  return smem_floats(g, dh, tcap) * sizeof(float);
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 (k_scale/v_scale [n_blocks, H_kv]).
// Returns a cudaError_t as int; 0 on success.
int paged_decode_attn_launch(const float* q, const void* pool_k,
                             const void* pool_v, const float* k_scale,
                             const float* v_scale, const int* tables,
                             const int* lengths, float* y, int b, int hq,
                             int hkv, int blk, int dh, int mb, int dtype,
                             void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || blk < 1 || dh < 1 || mb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = paged_decode_attn_smem_bytes(hq / hkv, dh, mb * blk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch<float, false>(q, pool_k, pool_v, nullptr, nullptr, tables,
                               lengths, y, b, hq, hkv, blk, dh, mb, smem, st);
      break;
    case 1:
      e = launch<__nv_bfloat16, false>(q, pool_k, pool_v, nullptr, nullptr,
                                       tables, lengths, y, b, hq, hkv, blk,
                                       dh, mb, smem, st);
      break;
    case 2:
      if (k_scale == nullptr || v_scale == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      e = launch<int8_t, true>(q, pool_k, pool_v, k_scale, v_scale, tables,
                               lengths, y, b, hq, hkv, blk, dh, mb, smem, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // extern "C"
