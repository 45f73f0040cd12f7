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
// With mxu_bf16, q, k, v and p are rounded to bf16 before the products
// (l sums p before its rounding, as the plain version does). With bf16
// storage (the JAX kernel given bf16 q, k, v: its y is bf16, its lse
// f32) the tiles are read as bf16, the math is the mxu_bf16 math, and y
// is rounded to bf16 when stored (flash_common.cuh).
//
// What bounds it: operations. 4*dh flops per (query, visible key) pair
// against 4 reads or writes of [T, dh] per head; at 192 heads of T 512,
// dh 64, causal, 6.5 GFLOP over 100 MB: 0.096 ms at the f32 FMA rate of
// an H100 SXM, 0.030 ms of bytes.
//
// Design. A block owns one (head, query tile of kQB rows) and walks the
// key tiles of kKB keys up to the diagonal (all of them when not causal);
// the grid takes every head's last query tile first, so the longest
// causal walks start first. A block has 2 kQB threads: 16 threads share
// a row group of 8 query rows, each holding 8 rows x kKB/16 keys of the
// score tile (keys tx + 16 j) and 8 rows x 4 head-dim columns of the
// accumulator. Per key tile:
//  - s = q k^T over dh, both operands row-major in shared memory (16-byte
//    loads along dh; the 16 threads of a row group read one q row, so it
//    is a broadcast);
//  - the row max over the 16 threads by four shuffles; p = __expf(s -
//    m_new) and alpha = __expf(m_old - m_new), whose arguments are <= 0
//    on every pair the mask leaves (a few ulps off expf, far inside the
//    1e-4 the calls are held to); the mask is a select, run only on tiles
//    that cross the diagonal or the ragged edge (Tq, Tk); whole tiles
//    skip it. Each thread keeps its own part of l, rescaled by the same
//    alpha; the 16 parts are summed once, at the end;
//  - p to shared memory, [query][key], read back only by the 16 threads
//    of its row group (a warp sync, no block barrier); acc += p v over
//    the tile's keys in order.
// K and V come through a ring of kStages tiles of 16-byte cp.async
// copies: tile j+kStages-1's copies are in flight while tile j computes,
// one block barrier a tile. q stays in shared memory for the whole walk.
// With mxu_bf16 each thread rounds the elements it copied once they
// land, before the barrier that publishes them. Every output element is
// one FMA chain in a fixed order, with no atomics: a launch is bit-for-
// bit repeatable.
//
// The plan (query tile, key tile, ring stages) is an argument, so
// chip_smoke.py's flash-fwd-tiles sweep can time each; the wrapper
// (ops/flash_attention.py, FWD_PLAN) passes the fastest. Shared memory a
// block, fwd_floats: q [kQB][68], kStages x (k, v) [kKB][68], p
// [kQB][kKB + 4], 4 bytes each: (64, 64, 2) 102 KB, two blocks an SM
// (264 block slots on 132 SMs, 8 warps an SM); (128, 64, 2) and (64,
// 64, 3) 136 KB and (64, 128, 2) 186 KB, one block an SM.
//
// Plain C interface, bound with ctypes: the caller allocates y and lse,
// passes the stream, and gets cudaGetLastError() back.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::kDH;
using flash::keep;
using flash::kLd;
using flash::kNeg;

__host__ __device__ constexpr int fwd_floats(int query_tile, int key_tile,
                                             int stages) {
  return query_tile * kLd + stages * 2 * key_tile * kLd +
         query_tile * (key_tile + 4);
}

// Sum and max over the 16 threads of a row group (a half-warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Fwd {
  const void *q, *k, *v;   // T: float or __nv_bfloat16
  void* y;                 // T
  float* lse;
  int BH, Tq, Tk, dh, causal, vec;
  float scale;
};

template <int kQB, int kKB, int kStages, bool kBf16, typename T>
__global__ void __launch_bounds__(2 * kQB, 1) flash_fwd_kernel(const Fwd a) {
  constexpr int kThreads = 2 * kQB;
  // bf16 storage holds bf16 values already: only f32 tiles are rounded
  constexpr bool kRound = kBf16 && std::is_same<T, float>::value;
  constexpr int kRG = kQB / 8;     // row groups; row g + kRG i, i < 8
  constexpr int KJ = kKB / 16;     // keys a thread: tx + 16 j
  constexpr int kPs = kKB + 4;     // row stride of p, [query][key]
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kQB][kLd]
  float* ring = qs + kQB * kLd;                  // kStages x k, v [kKB][kLd]
  float* ps = ring + kStages * 2 * kKB * kLd;    // [kQB][kPs]
  const int nq = (a.Tq + kQB - 1) / kQB;
  const int b = static_cast<int>(blockIdx.x);
  const int bh = b % a.BH, q0 = (nq - 1 - b / a.BH) * kQB;
  const size_t qo = static_cast<size_t>(bh) * a.Tq;
  const size_t ko = static_cast<size_t>(bh) * a.Tk;
  const T* k = static_cast<const T*>(a.k) + ko * a.dh;
  const T* v = static_cast<const T*>(a.v) + ko * a.dh;
  const int tid = threadIdx.x, g = tid / 16, tx = tid % 16;
  const bool vec = a.vec != 0, causal = a.causal != 0;
  // key tiles this query tile needs: those up to its last row's key when
  // causal
  const int all = (a.Tk + kKB - 1) / kKB;
  const int nk =
      causal ? min(all, (min(q0 + kQB, a.Tq) - 1) / kKB + 1) : all;

  auto load_kv = [&](int j) {
    float* ks = ring + (j % kStages) * 2 * kKB * kLd;
    flash::load_rows<kKB, kThreads>(ks, kLd, k, j * kKB, a.Tk, a.dh, vec);
    flash::load_rows<kKB, kThreads>(ks + kKB * kLd, kLd, v, j * kKB, a.Tk,
                                    a.dh, vec);
  };
  flash::load_rows<kQB, kThreads>(qs, kLd,
                                  static_cast<const T*>(a.q) + qo * a.dh, q0,
                                  a.Tq, a.dh, vec);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_kv(s);
    gemm::cp_async_commit();
  }

  float m[8], l[8], acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    gemm::cp_async_wait<kStages - 2>();
    float* ks = ring + (j % kStages) * 2 * kKB * kLd;
    float* vs = ks + kKB * kLd;
    if (kRound) {
      if (j == 0) flash::round_rows<kQB, kThreads>(qs, kLd);
      flash::round_rows<kKB, kThreads>(ks, kLd);
      flash::round_rows<kKB, kThreads>(vs, kLd);
    }
    __syncthreads();   // tile j landed; tile j-1's readers are done
    if (j + kStages - 1 < nk) load_kv(j + kStages - 1);
    gemm::cp_async_commit();
    const int k0 = j * kKB;

    // s = q k^T over dh (zero past dh), each sum in dh order
    float s[8][KJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kDH; c += 4) {
      float4 kf[KJ];
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj)
        kf[jj] = *reinterpret_cast<const float4*>(ks + (tx + 16 * jj) * kLd +
                                                  c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(qs + (g + kRG * i) * kLd + c);
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          s[i][jj] = fmaf(qf.x, kf[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qf.y, kf[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qf.z, kf[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qf.w, kf[jj].w, s[i][jj]);
        }
      }
    }

    // whether every pair of the tile is seen (no diagonal, no edge)
    const bool full = (!causal || q0 >= k0 + kKB - 1) && q0 + kQB <= a.Tq &&
                      k0 + kKB <= a.Tk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = g + kRG * i, qr = q0 + r;
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        float x = s[i][jj] * a.scale;
        if (!full && !keep(qr, k0 + tx + 16 * jj, a.Tq, a.Tk, causal))
          x = kNeg;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      const float alpha = __expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const float e = __expf(s[i][jj] - mn);
        const float p =
            full || keep(qr, k0 + tx + 16 * jj, a.Tq, a.Tk, causal) ? e
                                                                    : 0.f;
        sum += p;
        ps[r * kPs + tx + 16 * jj] = ffn::op<kBf16>(p);
      }
      l[i] = alpha * l[i] + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();   // p of this row group visible to its 16 threads

    // acc += p v over the tile's keys, in order: columns 4 tx .. 4 tx + 3
#pragma unroll 4
    for (int kk = 0; kk < kKB; kk += 4) {
      float4 vf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vf[u] = *reinterpret_cast<const float4*>(vs + (kk + u) * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 pf =
            *reinterpret_cast<const float4*>(ps + (g + kRG * i) * kPs + kk);
        const float pv[4] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(pv[u], vf[u].x, acc[i][0]);
          acc[i][1] = fmaf(pv[u], vf[u].y, acc[i][1]);
          acc[i][2] = fmaf(pv[u], vf[u].z, acc[i][2]);
          acc[i][3] = fmaf(pv[u], vf[u].w, acc[i][3]);
        }
      }
    }
  }
  gemm::cp_async_wait<0>();

  T* y = static_cast<T*>(a.y) + qo * a.dh;
  const int c0 = 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lt = row_sum(l[i]);   // the 16 parts, in a fixed tree
    const int qr = q0 + g + kRG * i;
    if (qr >= a.Tq) continue;
    T* out = y + static_cast<size_t>(qr) * a.dh;
    if (vec && c0 < a.dh) {
      flash::store4(out + c0, acc[i][0] / lt, acc[i][1] / lt,
                    acc[i][2] / lt, acc[i][3] / lt);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < a.dh) out[c0 + c] = flash::narrow<T>(acc[i][c] / lt);
    }
    if (tx == 0) a.lse[qo + qr] = m[i] + logf(lt);
  }
}

template <int kQB, int kKB, int kStages, bool kBf16, typename T>
cudaError_t launch(const Fwd& a, cudaStream_t st) {
  auto kern = flash_fwd_kernel<kQB, kKB, kStages, kBf16, T>;
  const size_t smem = fwd_floats(kQB, kKB, kStages) * sizeof(float);
  const cudaError_t e =
      ffn::set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  kern<<<(a.Tq + kQB - 1) / kQB * a.BH, 2 * kQB, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool kBf16, typename T>
cudaError_t plan(const Fwd& a, int query_tile, int key_tile, int stages,
                 cudaStream_t st) {
  if (query_tile == 64 && key_tile == 64 && stages == 2)
    return launch<64, 64, 2, kBf16, T>(a, st);
  if (query_tile == 128 && key_tile == 64 && stages == 2)
    return launch<128, 64, 2, kBf16, T>(a, st);
  if (query_tile == 64 && key_tile == 128 && stages == 2)
    return launch<64, 128, 2, kBf16, T>(a, st);
  if (query_tile == 64 && key_tile == 64 && stages == 3)
    return launch<64, 64, 3, kBf16, T>(a, st);
  return cudaErrorInvalidValue;
}

// 16-byte aligned (a float4 of f32), or with bf16 storage 8-byte (4 bf16)
bool aligned(const void* p, int bf16) {
  return (reinterpret_cast<size_t>(p) & (bf16 ? 7 : 15)) == 0;
}

}  // namespace

extern "C" {

// q [BH, Tq, dh], k, v [BH, Tk, dh] -> y [BH, Tq, dh], lse [BH, Tq]; q,
// k, v and y f32, or bf16 when bf16 is 1 (mxu_bf16 then changes
// nothing), lse f32; dh <= 64. (query_tile, key_tile, stages): (64, 64,
// 2), (128, 64, 2), (64, 128, 2) or (64, 64, 3). causal, mxu_bf16: 0 or
// 1. Returns a cudaError_t as int; 0 on success.
int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                          void* y, float* lse, int BH, int Tq, int Tk,
                          int dh, int causal, int query_tile, int key_tile,
                          int stages, int mxu_bf16, int bf16, void* stream) {
  if (BH < 1 || Tq < 1 || Tk < 1 || dh < 1 || dh > kDH ||
      static_cast<long long>((Tq + 63) / 64) * BH > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Fwd a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.y = y;
  a.lse = lse;
  a.BH = BH;
  a.Tq = Tq;
  a.Tk = Tk;
  a.dh = dh;
  a.causal = causal != 0;
  a.vec = dh % 4 == 0 && aligned(q, bf16) && aligned(k, bf16) &&
          aligned(v, bf16) && aligned(y, bf16);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(
        plan<true, __nv_bfloat16>(a, query_tile, key_tile, stages, st));
  return static_cast<int>(
      mxu_bf16 ? plan<true, float>(a, query_tile, key_tile, stages, st)
               : plan<false, float>(a, query_tile, key_tile, stages, st));
}

}  // extern "C"
