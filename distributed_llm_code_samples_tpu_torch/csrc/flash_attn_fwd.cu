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
// With mxu_bf16 (f32 storage), q, k, v and p are rounded to bf16 before
// the products (l sums p before its rounding, as the plain version
// does). With bf16 storage (the JAX kernel given bf16 q, k, v: its y is
// bf16, its lse f32) the math is the mxu_bf16 math on the bf16 values,
// and y is rounded to bf16 once, when stored.
//
// What bounds it: operations in f32, bytes in bf16. 4*dh flops per
// (query, visible key) pair against 4 reads or writes of [T, dh] per
// head; at 192 heads of T 512, dh 64, causal, 6.5 GFLOP over 100 MB of
// f32: 0.096 ms at the f32 FMA rate of an H100 SXM, 0.030 ms of bytes;
// on bf16 storage 0.0066 ms at the tensor cores' rate against 0.015 ms
// of bytes (50 MB).
//
// f32 storage (modes 0 and 1) runs on the CUDA cores. A block owns one
// (head, query tile of kQB rows) and walks the key tiles of kKB keys up
// to the diagonal (all of them when not causal); the grid takes every
// head's last query tile first, so the longest causal walks start first.
// A block has 2 kQB threads: 16 threads share a row group of 8 query
// rows, each holding 8 rows x kKB/16 keys of the score tile (keys tx + 16
// j) and 8 rows x 4 head-dim columns of the accumulator. Per key tile:
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
// bf16 storage (mode 2) runs on the tensor cores (tc_core.cuh):
// flash_fwd_tc_kernel, a block per (head, 128 query rows), the grid's
// last query tiles first; 288 threads: two consumer warpgroups of 64
// query rows each and a producer warp. The producer loads the block's q
// once and keeps a ring of 4 (K, V) stages of 64 keys in flight, all by
// TMA from [BH][T][dh] viewed as 3-D (zero past each head's T and past
// dh, 128-byte swizzled). Per key tile, a warpgroup:
//  - S = q k^T on wgmma m64n64k16 (q and k K-major over dh, 4 k16
//    steps; dh < 64 zero-filled), f32 in registers;
//  - the online softmax in registers: each row's max over its quad of
//    threads by two shuffles, p = __expf(s * scale - m_new), alpha =
//    __expf(m_old - m_new) (arguments <= 0), the mask a select only on
//    tiles that cross the diagonal or Tk; each thread's part of l, as
//    above; O *= alpha;
//  - P rounded to bf16 straight into wgmma's A registers (the layout of
//    an m64nN accumulator is that of A's k16 slices), O += P V on wgmma
//    m64n64k16 with V [keys][dh] read MN-major through the transpose bit.
// A warpgroup skips the key tiles that lie wholly past its own rows'
// diagonal (it waits for them and releases them unread). y = O / l,
// rounded to bf16 once, and lse = m + log l are stored from registers.
// Shared memory 81 KB a block: two blocks would fit an SM, but the
// registers decide (at most 113 a thread for two; chip_smoke.py's
// flash-tc-ptxas reports the count), and at one block an SM a
// warpgroup's softmax leaves its tensor cores idle. Every sum has a fixed order (wgmma's
// k16 steps in order, the quad's shuffles, tiles in order), no atomics:
// a launch is bit-for-bit repeatable. bf16 operands that TMA cannot read
// in place (a base not 16-byte aligned, dh not a multiple of 8) are
// staged into zero-padded copies first.
//
// Plain C interface, bound with ctypes: the caller allocates y, lse and
// the staged copies, passes the stream, and gets cudaGetLastError() back.

#include "flash_common.cuh"
#include "tc_core.cuh"

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
  const float *q, *k, *v;
  float* y;
  float* lse;
  int BH, Tq, Tk, dh, causal, vec;
  float scale;
};

template <int kQB, int kKB, int kStages, bool kBf16>
__global__ void __launch_bounds__(2 * kQB, 1) flash_fwd_kernel(const Fwd a) {
  constexpr int kThreads = 2 * kQB;
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
  const float* k = a.k + ko * a.dh;
  const float* v = a.v + ko * a.dh;
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
                                  a.q + qo * a.dh, q0,
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
    if (kBf16) {
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

  float* y = a.y + qo * a.dh;
  const int c0 = 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lt = row_sum(l[i]);   // the 16 parts, in a fixed tree
    const int qr = q0 + g + kRG * i;
    if (qr >= a.Tq) continue;
    float* out = y + static_cast<size_t>(qr) * a.dh;
    if (vec && c0 < a.dh) {
      flash::store4(out + c0, acc[i][0] / lt, acc[i][1] / lt,
                    acc[i][2] / lt, acc[i][3] / lt);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < a.dh) out[c0 + c] = acc[i][c] / lt;
    }
    if (tx == 0) a.lse[qo + qr] = m[i] + logf(lt);
  }
}

template <int kQB, int kKB, int kStages, bool kBf16>
cudaError_t launch(const Fwd& a, cudaStream_t st) {
  auto kern = flash_fwd_kernel<kQB, kKB, kStages, kBf16>;
  const size_t smem = fwd_floats(kQB, kKB, kStages) * sizeof(float);
  const cudaError_t e =
      ffn::set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  kern<<<(a.Tq + kQB - 1) / kQB * a.BH, 2 * kQB, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t plan(const Fwd& a, int query_tile, int key_tile, int stages,
                 cudaStream_t st) {
  if (query_tile == 64 && key_tile == 64 && stages == 2)
    return launch<64, 64, 2, kBf16>(a, st);
  if (query_tile == 128 && key_tile == 64 && stages == 2)
    return launch<128, 64, 2, kBf16>(a, st);
  if (query_tile == 64 && key_tile == 128 && stages == 2)
    return launch<64, 128, 2, kBf16>(a, st);
  if (query_tile == 64 && key_tile == 64 && stages == 3)
    return launch<64, 64, 3, kBf16>(a, st);
  return cudaErrorInvalidValue;
}

// -- bf16 storage on the tensor cores ---------------------------------------

namespace fwd_tc {

using bf = __nv_bfloat16;

constexpr int kQB = 128;      // query rows a block: two warpgroups of 64
constexpr int kKB = 64;       // keys a tile
constexpr int kStages = 4;    // (K, V) tiles in flight
constexpr int kThreads = 288; // two consumer warpgroups and a producer warp
constexpr int kQBytes = kQB * 128;   // q's box: 128 rows of 64 dh, bf16
constexpr int kKVBytes = kKB * 128;  // a K or V box
constexpr int kStageBytes = 2 * kKVBytes;
// q, the ring, and room to align them to a 1024-byte swizzle atom
constexpr size_t kSmem =
    kQBytes + static_cast<size_t>(kStages) * kStageBytes + 1024;

// q [BH][Tq][dh], k, v [BH][Tk][dh] as TMA reads them (rows ld apart);
// y [BH][Tq][dh] bf16, lse [BH][Tq] f32; nq query tiles a head.
struct Params {
  CUtensorMap q, k, v;
  bf* y;
  float* lse;
  int BH, Tq, Tk, dh, causal, nq;
  float scale;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One key tile's scores s (s[4 j + 2 h + e]: row r0 + 8 h, key k0 + c0 +
// 8 j + e) into p, rounded to bf16 as wgmma's A fragments of the tile's
// four k16 steps (p[2 j + h] holds row h's keys c0 + 8 j (+ 1): k16 step
// j / 2), and the rows' running m, l and o (o[4 j + 2 h + e]: column c0
// + 8 j + e of row h) rescaled. Each pair of p is packed as soon as its
// exps are taken, so s's registers free as p's fill. kMask: the tile
// crosses the diagonal or Tk.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[32],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&p)[16], int r0,
                                             int k0, int c0,
                                             const Params& a) {
  const bool causal = a.causal != 0;
  float mn[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * h + e] * a.scale;
        if (kMask &&
            !keep(r0 + 8 * h, k0 + c0 + 8 * j + e, a.Tq, a.Tk, causal))
          x = kNeg;
        s[4 * j + 2 * h + e] = x;
        mx = fmaxf(mx, x);
      }
    mn[h] = fmaxf(m[h], quad_max(mx));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pe[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = __expf(s[4 * j + 2 * h + e] - mn[h]);
        pe[e] = !kMask || keep(r0 + 8 * h, k0 + c0 + 8 * j + e, a.Tq, a.Tk,
                               causal)
                    ? x
                    : 0.f;
        sum[h] += pe[e];
      }
      p[2 * j + h] = tc::pack_bf16(pe[0], pe[1]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float alpha = __expf(m[h] - mn[h]);
    l[h] = alpha * l[h] + sum[h];
    m[h] = mn[h];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j + 2 * h] *= alpha;
      o[4 * j + 2 * h + 1] *= alpha;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ Params a) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t qs = (tc::smem_u32(smem) + 1023) & ~1023u;
  const uint32_t ring = qs + kQBytes;
  const uint32_t full = tc::smem_u32(bars), empty = full + 8 * kStages;
  const uint32_t qbar = full + 16 * kStages;
  const int b = static_cast<int>(blockIdx.x);
  const int bh = b % a.BH, q0 = (a.nq - 1 - b / a.BH) * kQB;
  const bool causal = a.causal != 0;
  // key tiles the block needs: those up to its last row's key when causal
  const int all = (a.Tk + kKB - 1) / kKB;
  const int nk =
      causal ? min(all, (min(q0 + kQB, a.Tq) - 1) / kKB + 1) : all;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::bar_init(full + 8 * s, 1);
      tc::bar_init(empty + 8 * s, 2);
    }
    tc::bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x != 256) return;
    tc::bar_expect(qbar, kQBytes);
    tc::tma_load3(qs, &a.q, qbar, 0, q0, bh);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nk; ++j) {
      tc::bar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t bar = full + 8 * stage;
      tc::bar_expect(bar, kStageBytes);
      const uint32_t ks = ring + stage * kStageBytes;
      tc::tma_load3(ks, &a.k, bar, 0, j * kKB, bh);
      tc::tma_load3(ks + kKVBytes, &a.v, bar, 0, j * kKB, bh);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  const int t = threadIdx.x % 128;
  const int qw = q0 + 64 * wg;   // this warpgroup's first query row
  // this thread's rows r0 (+ 8) and columns c0 + 8 j (+ 1)
  const int r0 = qw + 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  // the block's key tiles this warpgroup reads; it releases the rest
  const int mine = qw >= a.Tq ? 0
                   : causal   ? min(nk, (min(qw + 64, a.Tq) - 1) / kKB + 1)
                              : nk;
  float o[32], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint32_t qa = qs + wg * (64 * 128);   // the warpgroup's 64 q rows
  tc::bar_wait(qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < nk; ++j) {
    tc::bar_wait(full + 8 * stage, phase);
    if (j < mine) {
      const uint32_t ks = ring + stage * kStageBytes, vs = ks + kKVBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      tc::fence_regs(s);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma64<tc::kKMajor, tc::kKMajor>(
            s, tc::step_desc<tc::kKMajor>(qa, kk),
            tc::step_desc<tc::kKMajor>(ks, kk));
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(s);
      const int k0 = j * kKB;
      // every pair of the warpgroup's rows and the tile's keys seen
      const bool whole = k0 + kKB <= a.Tk && (!causal || qw >= k0 + kKB - 1);
      uint32_t p[16];
      if (whole)
        softmax_tile<false>(s, o, m, l, p, r0, k0, c0, a);
      else
        softmax_tile<true>(s, o, m, l, p, r0, k0, c0, a);
      tc::fence_regs(o);
      tc::fence_regs(p);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pk[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                p[4 * kk + 3]};
        tc::wgmma64_rs<tc::kMNMajor>(o, pk,
                                     tc::step_desc<tc::kMNMajor>(vs, kk));
      }
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(o);
    }
    if (t == 0) tc::bar_arrive(empty + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  const bool vec = a.dh % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);   // the 4 parts, in a fixed tree
    const int qr = r0 + 8 * h;
    if (qr >= a.Tq) continue;
    const size_t row = static_cast<size_t>(bh) * a.Tq + qr;
    bf* out = a.y + row * a.dh;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tc::put2(out, c0 + 8 * j, a.dh, vec, o[4 * j + 2 * h] / lt,
               o[4 * j + 2 * h + 1] / lt);
    if (t % 4 == 0) a.lse[row] = m[h] + logf(lt);
  }
}

}  // namespace fwd_tc

// 16-byte aligned (a float4 of f32)
bool aligned(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

namespace flash {
struct fwd_tc;   // names the staging copies in a profile
}

extern "C" {

// q [BH, Tq, dh], k, v [BH, Tk, dh], y [BH, Tq, dh] f32 -> y, lse [BH,
// Tq] f32 (modes 0 and 1, the CUDA cores; bf16 storage is
// flash_attn_fwd_tc_launch's); dh <= 64. (query_tile, key_tile,
// stages): (64, 64, 2), (128, 64, 2), (64, 128, 2) or (64, 64, 3).
// causal, mxu_bf16: 0 or 1. Returns a cudaError_t as int; 0 on success.
int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                          void* y, float* lse, int BH, int Tq, int Tk,
                          int dh, int causal, int query_tile, int key_tile,
                          int stages, int mxu_bf16, void* stream) {
  if (BH < 1 || Tq < 1 || Tk < 1 || dh < 1 || dh > kDH ||
      static_cast<long long>((Tq + 63) / 64) * BH > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Fwd a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.y = static_cast<float*>(y);
  a.lse = lse;
  a.BH = BH;
  a.Tq = Tq;
  a.Tk = Tk;
  a.dh = dh;
  a.causal = causal != 0;
  a.vec = dh % 4 == 0 && aligned(q) && aligned(k) && aligned(v) &&
          aligned(y);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mxu_bf16 ? plan<true>(a, query_tile, key_tile, stages, st)
               : plan<false>(a, query_tile, key_tile, stages, st));
}

// The tensor-core forward on bf16 storage: q [BH, Tq, dh], k, v [BH, Tk,
// dh] bf16 -> y [BH, Tq, dh] bf16, lse [BH, Tq] f32; dh <= 64. qs, ks,
// vs: zero-padded bf16 copies [BH * T][dh8] (dh8: dh rounded up to 8)
// for an operand TMA cannot read in place (a base not 16-byte aligned or
// dh not a multiple of 8), else null. causal: 0 or 1. Returns a
// cudaError_t as int; 0 on success.
int flash_attn_fwd_tc_launch(const void* q, const void* k, const void* v,
                             void* y, float* lse, void* qs, void* ks,
                             void* vs, int BH, int Tq, int Tk, int dh,
                             int causal, void* stream) {
  using fwd_tc::bf;
  if (BH < 1 || Tq < 1 || Tk < 1 || dh < 1 || dh > kDH ||
      static_cast<long long>((Tq + fwd_tc::kQB - 1) / fwd_tc::kQB) * BH >
          0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::Operand qo, ko, vo;
  cudaError_t e;
  const long long rq = static_cast<long long>(BH) * Tq;
  const long long rk = static_cast<long long>(BH) * Tk;
  if ((e = tc::bind_device(q)) != cudaSuccess ||
      (e = tc::operand<flash::fwd_tc>(static_cast<const bf*>(q), rq, dh,
                                      static_cast<bf*>(qs), st, &qo)) !=
          cudaSuccess ||
      (e = tc::operand<flash::fwd_tc>(static_cast<const bf*>(k), rk, dh,
                                      static_cast<bf*>(ks), st, &ko)) !=
          cudaSuccess ||
      (e = tc::operand<flash::fwd_tc>(static_cast<const bf*>(v), rk, dh,
                                      static_cast<bf*>(vs), st, &vo)) !=
          cudaSuccess)
    return static_cast<int>(e);
  fwd_tc::Params a{};
  if ((e = tc::tensor_map3(&a.q, qo.p, BH, Tq, dh, qo.ld, fwd_tc::kQB)) !=
          cudaSuccess ||
      (e = tc::tensor_map3(&a.k, ko.p, BH, Tk, dh, ko.ld, fwd_tc::kKB)) !=
          cudaSuccess ||
      (e = tc::tensor_map3(&a.v, vo.p, BH, Tk, dh, vo.ld, fwd_tc::kKB)) !=
          cudaSuccess)
    return static_cast<int>(e);
  a.y = static_cast<bf*>(y);
  a.lse = lse;
  a.BH = BH;
  a.Tq = Tq;
  a.Tk = Tk;
  a.dh = dh;
  a.causal = causal != 0;
  a.nq = (Tq + fwd_tc::kQB - 1) / fwd_tc::kQB;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  if ((e = cudaFuncSetAttribute(fwd_tc::flash_fwd_tc_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(fwd_tc::kSmem))) !=
      cudaSuccess)
    return static_cast<int>(e);
  fwd_tc::flash_fwd_tc_kernel<<<a.nq * BH, fwd_tc::kThreads, fwd_tc::kSmem,
                                st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
