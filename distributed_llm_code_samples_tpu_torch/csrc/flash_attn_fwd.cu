// Flash attention forward for Hopper (sm_90a): y = softmax(q k^T * scale)
// v per head, with lse = the row log-sum-exp, scale = dh^-0.5.
//
// Replaces the TPU kernel `flash_attention_fwd` (body `_flash_fwd_kernel`)
// in distributed_llm_code_samples_tpu/ops/pallas_attention.py. It
// computes the same function by the same online softmax: a running row
// max m and denominator l, an f32 accumulator rescaled by exp(m_old -
// m_new) at each key tile, scores masked to -1e30 where causal, and p
// zeroed after the exp where masked (a fully masked row would otherwise
// give exp(-1e30 - -1e30) = 1). No [Tq, Tk] tile reaches device memory.
// With mxu_bf16, q, k, v and p are rounded to bf16 before the products.
//
// What bounds it: operations. 4*dh flops per (query, visible key) pair
// against 4 reads or writes of [T, dh] per head; at 192 heads of T 512,
// dh 64, causal, that is 6.5 GFLOP over 100 MB.
//
// Design. The Pallas grid is (query tile, key tile) with the key axis
// sequential, per head under a vmap. Here a block owns one (head, 64-row
// query tile) and walks the key tiles up to the diagonal (all of them
// when not causal) in a loop; the grid covers every head at once, with
// the query tiles in reverse so that the longest causal walks start
// first. Per key tile: the [64 x 64] score tile in registers (16 a
// thread), the row max and sum over the 16 threads of a row by shuffles,
// p to shared memory, then acc += p v. q stays in shared memory for the
// whole walk; k and v come in by cp.async, zero-filled past Tk and dh.
// Four [64 x 68] tiles, 68 KB: two blocks an SM.
//
// Plain C interface, bound with ctypes: the caller allocates y and lse,
// passes the stream, and gets cudaGetLastError() back.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ y,
                     float* __restrict__ lse, int Tq, int Tk, int dh,
                     bool causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [dh][q rows]
  float* kT = qT + kTile;                        // [dh][keys]
  float* vs = kT + kTile;                        // [keys][dh]
  float* pT = vs + kTile;                        // [keys][q rows]
  const int nq = (Tq + kB - 1) / kB;
  const int q0 = (nq - 1 - blockIdx.x) * kB;
  const size_t bh = blockIdx.y;
  q += bh * Tq * dh;
  y += bh * Tq * dh;
  k += bh * Tk * dh;
  v += bh * Tk * dh;
  const int r0 = row0(), c0 = col0();

  load_tile<true, false, kBf16>(qT, q, q0, Tq, dh);
  ffn::cp_async_commit();
  ffn::cp_async_wait<0>();
  load_tile<true, true, kBf16>(qT, q, q0, Tq, dh);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNeg, l[i] = 0.f;
  zero(acc);

  const int nk = key_tiles(q0, Tk, causal);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kB;
    __syncthreads();                     // the last tile's readers are done
    load_tile<true, false, kBf16>(kT, k, k0, Tk, dh);
    load_tile<false, false, kBf16>(vs, v, k0, Tk, dh);
    ffn::cp_async_commit();
    ffn::cp_async_wait<0>();
    load_tile<true, true, kBf16>(kT, k, k0, Tk, dh);
    load_tile<false, true, kBf16>(vs, v, k0, Tk, dh);
    __syncthreads();

    float s[4][4];
    zero(s);
    outer(s, qT, kT);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool ok = keep(q0 + r0 + i, k0 + c0 + jj, Tq, Tk, causal);
        s[i][jj] = ok ? s[i][jj] * scale : kNeg;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool ok = keep(q0 + r0 + i, k0 + c0 + jj, Tq, Tk, causal);
        const float p = ok ? expf(s[i][jj] - m_new) : 0.f;
        sum += p;
        s[i][jj] = ffn::op<kBf16>(p);
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] *= alpha;
    }
    store_T(pT, s);
    __syncthreads();
    outer(acc, pT, vs);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] *= inv;
    const int r = q0 + r0 + i;
    if (c0 == 0 && r < Tq) lse[bh * Tq + r] = m[i] + logf(l[i]);
  }
  store_rows(y, acc, q0, Tq, dh, 1.f);
}

template <bool kBf16>
cudaError_t launch(const float* q, const float* k, const float* v, float* y,
                   float* lse, int BH, int Tq, int Tk, int dh, bool causal,
                   cudaStream_t stream) {
  const size_t smem = 4 * kTile * sizeof(float);
  auto kern = flash_fwd_kernel<kBf16>;
  const cudaError_t e =
      ffn::set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + kB - 1) / kB, BH);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, y, lse, Tq, Tk, dh, causal,
                                         scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [BH, Tq, dh], k, v [BH, Tk, dh] -> y [BH, Tq, dh], lse [BH, Tq], all
// f32; dh <= 64. causal, mxu_bf16: 0 or 1. Returns a cudaError_t as int;
// 0 on success.
int flash_attn_fwd_launch(const float* q, const float* k, const float* v,
                          float* y, float* lse, int BH, int Tq, int Tk,
                          int dh, int causal, int mxu_bf16, void* stream) {
  if (BH < 1 || Tq < 1 || Tk < 1 || dh < 1 || dh > kDH || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? launch<true>(q, k, v, y, lse, BH, Tq, Tk, dh, causal != 0, st)
               : launch<false>(q, k, v, y, lse, BH, Tq, Tk, dh, causal != 0,
                               st));
}

}  // extern "C"
