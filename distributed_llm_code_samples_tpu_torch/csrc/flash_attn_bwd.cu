// Flash attention backward for Hopper (sm_90a): dq, dk, dv from (q, k, v,
// dy, lse, D) with the score tiles recomputed, never stored.
//
// Replaces the TPU kernel `flash_attention_bwd` (bodies
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_attention.py. It computes
// the same function: p = exp(s * scale - lse) zeroed where causally
// masked, ds = p * (dy v^T - D) with D = rowsum(dy * y) computed once by
// the caller, dq = ds k * scale, dk = ds^T q * scale, dv = p^T dy. With
// mxu_bf16, q, k, v, dy and the p and ds tiles are rounded to bf16
// before the products they feed.
//
// What bounds it: operations. The function needs five products (s, dp,
// dq, dk, dv), 10*dh flops per visible (query, key) pair, against about
// 10 reads or writes of [T, dh] per head; at 192 heads of T 512, dh 64,
// causal, 16.1 GFLOP over 0.2 GB. The two launches execute 14*dh
// (22.6 GFLOP): each recomputes the score tile and dp.
//
// Design. As in the Pallas kernels, two launches with no atomics, so a
// launch is bit-for-bit deterministic:
//  - dq: a block per (head, 64-row query tile) walks the key tiles up to
//    the diagonal, the [64 x dh] dq accumulator in registers. q and dy
//    stay in shared memory; per key tile, k (twice: transposed for the
//    scores, row-major for ds k) and v come in by cp.async. Six tiles,
//    104 KB: two blocks an SM.
//  - dkv: a block per (head, 64-row key tile) walks the query tiles from
//    the diagonal on, with the dk and dv accumulators in registers. It
//    computes the transposed tiles s^T and dp^T, so each thread holds
//    its own key rows of p and ds; they go to shared memory as [q][k]
//    for dv += p^T dy and dk += ds^T q. Eight tiles, 136 KB.
//
// Plain C interface, bound with ctypes: the caller allocates dq, dk, dv,
// passes the stream, and gets cudaGetLastError() back.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dy,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dq,
                    int Tq, int Tk, int dh, bool causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [dh][q rows]
  float* dyT = qT + kTile;                       // [dh][q rows]
  float* kT = dyT + kTile;                       // [dh][keys]
  float* vT = kT + kTile;                        // [dh][keys]
  float* ks = vT + kTile;                        // [keys][dh]
  float* dsT = ks + kTile;                       // [keys][q rows]
  const int nq = (Tq + kB - 1) / kB;
  const int q0 = (nq - 1 - blockIdx.x) * kB;
  const size_t bh = blockIdx.y;
  q += bh * Tq * dh;
  dy += bh * Tq * dh;
  dq += bh * Tq * dh;
  k += bh * Tk * dh;
  v += bh * Tk * dh;
  lse += bh * Tq;
  D += bh * Tq;
  const int r0 = row0(), c0 = col0();

  load_tile<true, false, kBf16>(qT, q, q0, Tq, dh);
  load_tile<true, false, kBf16>(dyT, dy, q0, Tq, dh);
  ffn::cp_async_commit();
  ffn::cp_async_wait<0>();
  load_tile<true, true, kBf16>(qT, q, q0, Tq, dh);
  load_tile<true, true, kBf16>(dyT, dy, q0, Tq, dh);

  float lrow[4], drow[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + r0 + i;
    lrow[i] = r < Tq ? lse[r] : 0.f;
    drow[i] = r < Tq ? D[r] : 0.f;
  }
  zero(acc);

  const int nk = key_tiles(q0, Tk, causal);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kB;
    __syncthreads();                     // the last tile's readers are done
    load_tile<true, false, kBf16>(kT, k, k0, Tk, dh);
    load_tile<true, false, kBf16>(vT, v, k0, Tk, dh);
    load_tile<false, false, kBf16>(ks, k, k0, Tk, dh);
    ffn::cp_async_commit();
    ffn::cp_async_wait<0>();
    load_tile<true, true, kBf16>(kT, k, k0, Tk, dh);
    load_tile<true, true, kBf16>(vT, v, k0, Tk, dh);
    load_tile<false, true, kBf16>(ks, k, k0, Tk, dh);
    __syncthreads();

    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    outer(s, qT, kT);
    outer(dp, dyT, vT);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool ok = keep(q0 + r0 + i, k0 + c0 + jj, Tq, Tk, causal);
        const float p = ok ? expf(s[i][jj] * scale - lrow[i]) : 0.f;
        s[i][jj] = ffn::op<kBf16>(p * (dp[i][jj] - drow[i]));
      }
    store_T(dsT, s);
    __syncthreads();
    outer(acc, dsT, ks);
  }
  store_rows(dq, acc, q0, Tq, dh, scale);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dy,
                     const float* __restrict__ lse,
                     const float* __restrict__ D, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int Tk, int dh,
                     bool causal, float scale) {
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);   // [dh][keys]
  float* vT = kT + kTile;                        // [dh][keys]
  float* qT = vT + kTile;                        // [dh][q rows]
  float* dyT = qT + kTile;                       // [dh][q rows]
  float* qs = dyT + kTile;                       // [q rows][dh]
  float* dys = qs + kTile;                       // [q rows][dh]
  float* ps = dys + kTile;                       // [q rows][keys]
  float* dss = ps + kTile;                       // [q rows][keys]
  const int k0 = blockIdx.x * kB;
  const size_t bh = blockIdx.y;
  q += bh * Tq * dh;
  dy += bh * Tq * dh;
  k += bh * Tk * dh;
  v += bh * Tk * dh;
  dk += bh * Tk * dh;
  dv += bh * Tk * dh;
  lse += bh * Tq;
  D += bh * Tq;
  const int r0 = row0(), c0 = col0();

  load_tile<true, false, kBf16>(kT, k, k0, Tk, dh);
  load_tile<true, false, kBf16>(vT, v, k0, Tk, dh);
  ffn::cp_async_commit();
  ffn::cp_async_wait<0>();
  load_tile<true, true, kBf16>(kT, k, k0, Tk, dh);
  load_tile<true, true, kBf16>(vT, v, k0, Tk, dh);

  float acck[4][4], accv[4][4];
  zero(acck);
  zero(accv);

  const int nq = (Tq + kB - 1) / kB;
  // query tiles that see this key tile: from the one holding row k0 on
  // when causal (q0 + 63 >= k0), all of them otherwise
  for (int t = causal ? k0 / kB : 0; t < nq; ++t) {
    const int q0 = t * kB;
    __syncthreads();                     // the last tile's readers are done
    load_tile<true, false, kBf16>(qT, q, q0, Tq, dh);
    load_tile<true, false, kBf16>(dyT, dy, q0, Tq, dh);
    load_tile<false, false, kBf16>(qs, q, q0, Tq, dh);
    load_tile<false, false, kBf16>(dys, dy, q0, Tq, dh);
    ffn::cp_async_commit();
    ffn::cp_async_wait<0>();
    load_tile<true, true, kBf16>(qT, q, q0, Tq, dh);
    load_tile<true, true, kBf16>(dyT, dy, q0, Tq, dh);
    load_tile<false, true, kBf16>(qs, q, q0, Tq, dh);
    load_tile<false, true, kBf16>(dys, dy, q0, Tq, dh);
    __syncthreads();

    // transposed tiles: row i is key k0 + r0 + i, column jj is query
    // q0 + c0 + jj
    float st[4][4], dpt[4][4], pt[4][4];
    zero(st);
    zero(dpt);
    outer(st, kT, qT);
    outer(dpt, vT, dyT);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int qr = q0 + c0 + jj;
      const float lq = qr < Tq ? lse[qr] : 0.f;
      const float dd = qr < Tq ? D[qr] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = keep(qr, k0 + r0 + i, Tq, Tk, causal);
        const float p = ok ? expf(st[i][jj] * scale - lq) : 0.f;
        pt[i][jj] = ffn::op<kBf16>(p);
        st[i][jj] = ffn::op<kBf16>(p * (dpt[i][jj] - dd));
      }
    }
    store_T(ps, pt);
    store_T(dss, st);
    __syncthreads();
    outer(accv, ps, dys);
    outer(acck, dss, qs);
  }
  store_rows(dk, acck, k0, Tk, dh, scale);
  store_rows(dv, accv, k0, Tk, dh, 1.f);
}

struct Args {
  const float *q, *k, *v, *dy, *lse, *D;
  int BH, Tq, Tk, dh;
  bool causal;
  float scale;
};

template <typename Kern>
cudaError_t prepare(Kern kern, int tiles, size_t& smem) {
  smem = tiles * kTile * sizeof(float);
  return ffn::set_smem(reinterpret_cast<const void*>(kern), smem);
}

template <bool kBf16>
cudaError_t launch_dq(const Args& a, float* dq, cudaStream_t stream) {
  size_t smem;
  auto kern = flash_dq_kernel<kBf16>;
  const cudaError_t e = prepare(kern, 6, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Tq + kB - 1) / kB, a.BH);
  kern<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.dy, a.lse, a.D, dq,
                                         a.Tq, a.Tk, a.dh, a.causal, a.scale);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv,
                       cudaStream_t stream) {
  size_t smem;
  auto kern = flash_dkv_kernel<kBf16>;
  const cudaError_t e = prepare(kern, 8, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Tk + kB - 1) / kB, a.BH);
  kern<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.dy, a.lse, a.D, dk,
                                         dv, a.Tq, a.Tk, a.dh, a.causal,
                                         a.scale);
  return cudaGetLastError();
}

bool bad(int BH, int Tq, int Tk, int dh) {
  return BH < 1 || Tq < 1 || Tk < 1 || dh < 1 || dh > kDH || BH > 65535;
}

Args args(const float* q, const float* k, const float* v, const float* dy,
          const float* lse, const float* D, int BH, int Tq, int Tk, int dh,
          int causal) {
  return Args{q, k, v, dy, lse, D, BH, Tq, Tk, dh, causal != 0,
              static_cast<float>(1.0 / sqrt(static_cast<double>(dh)))};
}

}  // namespace

extern "C" {

// q, dy [BH, Tq, dh], k, v [BH, Tk, dh], lse, D [BH, Tq] -> dq [BH, Tq,
// dh], all f32; dh <= 64. causal, mxu_bf16: 0 or 1. Returns a cudaError_t
// as int; 0 on success.
int flash_attn_dq_launch(const float* q, const float* k, const float* v,
                         const float* dy, const float* lse, const float* D,
                         float* dq, int BH, int Tq, int Tk, int dh,
                         int causal, int mxu_bf16, void* stream) {
  if (bad(BH, Tq, Tk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = args(q, k, v, dy, lse, D, BH, Tq, Tk, dh, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mxu_bf16 ? launch_dq<true>(a, dq, st)
                                   : launch_dq<false>(a, dq, st));
}

// The same inputs -> dk, dv [BH, Tk, dh].
int flash_attn_dkv_launch(const float* q, const float* k, const float* v,
                          const float* dy, const float* lse, const float* D,
                          float* dk, float* dv, int BH, int Tq, int Tk,
                          int dh, int causal, int mxu_bf16, void* stream) {
  if (bad(BH, Tq, Tk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = args(q, k, v, dy, lse, D, BH, Tq, Tk, dh, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mxu_bf16 ? launch_dkv<true>(a, dk, dv, st)
                                   : launch_dkv<false>(a, dk, dv, st));
}

}  // extern "C"
