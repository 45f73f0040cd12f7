// Flash attention backward for Hopper (sm_90a): dq, dk, dv from (q, k, v,
// dy, y, lse) with the score tiles recomputed from lse, never stored whole.
//
// Replaces the TPU kernel `flash_attention_bwd` (bodies
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`, shared
// `_recompute_p_ds`) in distributed_llm_code_samples_tpu/ops/
// pallas_attention.py. It computes the same function: p = exp(s * scale -
// lse) zeroed where causally masked, ds = p * (dy v^T - D) with D =
// rowsum(dy * y) (which the JAX package computes outside its kernels),
// dq = ds k * scale, dk = ds^T q * scale, dv = p^T dy. With mxu_bf16, q,
// k, v, dy and the p and ds tiles are rounded to bf16 before the
// products they feed. With bf16 storage (the JAX kernels given bf16 q,
// k, v, dy and y: their dq, dk, dv are bf16) the math is the mxu_bf16
// math on the bf16 values: ds from the unrounded p, bf16(p) and bf16(ds)
// into the products, f32 sums, lse and D f32, and dq, dk and dv rounded
// to bf16 once, when stored.
//
// What bounds it: operations. The function needs five products (s, dp,
// dq, dk, dv), 10*dh flops per visible (query, key) pair, against about
// 10 reads or writes of [T, dh] per head; at 192 heads of T 512, dh 64,
// causal, 16.1 GFLOP over 0.2 GB of f32: 0.24 ms at the f32 FMA rate; on
// bf16 storage 0.016 ms at the tensor cores' rate against 0.030 ms of
// bytes (0.1 GB), so there bytes bound it.
//
// f32 storage (modes 0 and 1) runs on the CUDA cores, in two launches,
// no atomics, so a call is bit-for-bit repeatable:
//  1. dkv: first D, 16 threads a row; then a block of 512 threads (16
//     warps, one block an SM) per (head, key tile of kKB = 128 keys), the
//     heaviest causal walks first, walks the query tiles of 64 that see
//     its keys. Two warp groups of 256 run side by side: group 0 computes
//     s^T = k q^T, forms p and sums dv += p^T dy; group 1 computes dp^T =
//     v dy^T, forms ds from p and sums dk += ds^T q. Each thread holds an
//     8 x 4 tile of s^T (or dp^T), 8 keys by 4 queries, and one of dv (or
//     dk), 8 keys by 4 dh columns: an 8 x 8 tile of each would not fit
//     beside the other in the 128 registers a thread has at 16 warps.
//     ds^T also goes to a scratch [BH][Tk128][Tq64] in device memory, only
//     the tiles the causal mask leaves (126 MB written at the main shape).
//  2. dq: a block of 64 threads per (head, query tile of 64) sums dq = ds
//     k over the keys it sees from that scratch and k, 8 x 8 a thread, in
//     a 3-deep ring of 16-byte cp.async copies. So s and dp are computed
//     once (the Pallas kernels compute them in both: 14*dh flops a pair
//     executed against 10*dh here).
// Every operand tile is row-major [rows][dh] in shared memory, copied as
// it lies in device memory by 16-byte cp.async (4-byte when dh is not a
// multiple of 4 or a pointer not 16-byte aligned), never transposed:
// products over dh (s^T, dp^T) read both operands along dh, products over
// queries (dv, dk, dq) along the output's rows. The dkv launch's query
// tiles come through a two-stage ring: the next tile's q and dy copies
// are in flight while this one computes. With mxu_bf16 each thread rounds
// the elements it copied once they land, before the barrier that
// publishes them. Every output element is one FMA chain in a fixed
// order. p takes __expf: s * scale - lse <= 0 on every pair the mask
// leaves, where it errs by a few ulps (far inside the 1e-4 the calls are
// held to), and expf's longer sequence showed in the call's time; the
// mask is a select after it, skipped on tiles it leaves whole.
// The key tile (64 or 128) and the ring's stages (1 or 2) are arguments,
// so chip_smoke.py's flash-bwd-tiles sweep can time each; the wrapper
// (ops/flash_attention.py, BWD_PLAN) passes 128 and 2.
//
// bf16 storage (mode 2) runs on the tensor cores (tc_core.cuh), in two
// launches of 288 threads a block (two consumer warpgroups and a producer
// warp), every product on wgmma m64n64k16 fed by TMA from [BH][T][dh]
// viewed as 3-D (zero past each head's T and past dh, 128-byte swizzled),
// and no ds scratch: the dq launch computes s and dp again, as the Pallas
// kernels do (4*dh flops a pair more, 0.007 ms at the main shape, against
// the 0.075 ms of HBM time an f32 ds^T round trip took):
//  1. dkv (flash_dkv_tc_kernel): D first (the same rowsum kernel, on the
//     bf16 values); then a block per (head, 128 keys), the heaviest causal
//     walks first; warpgroup w owns 64 keys. The producer loads K and V
//     once and keeps a ring of 4 stages of (Q, dY) tiles of 64 query rows
//     in flight, from the tile holding the block's first key on when
//     causal; its 32 lanes also copy the stage's lse and D (f32) and each
//     arrives on the stage's barrier. Per query tile, a warpgroup computes
//     s^T = K Q^T and dp^T = V dY^T (both K-major over dh), then p^T and
//     ds^T in registers with lse and D indexed by the accumulator's
//     columns, packs bf16(p^T) and bf16(ds^T) straight into wgmma's A
//     registers (the layout of an m64nN accumulator is that of A's k16
//     slices), and sums dV += P^T dY and dK += dS^T Q with dY and Q read
//     MN-major through the transpose bit. It skips a tile that lies
//     wholly above its keys' diagonal.
//  2. dq (flash_dq_tc_kernel): a block per (head, 128 query rows) laid
//     out as the forward's (flash_attn_fwd.cu), the grid's last query
//     tiles first: Q and dY loaded once, a ring of 4 (K, V) stages of 64
//     keys; each warpgroup, with its rows' lse and D in registers,
//     computes S = Q K^T and dP = dY V^T (P's exps beside dP's product),
//     then dS in registers, and sums dQ += dS K (K read MN-major), over
//     the key tiles up to its rows' diagonal.
// p takes __expf, as in the f32 kernels; the mask is a select after it,
// run only on tiles that cross the diagonal, Tq or Tk. dq, dk and dv are stored from registers, rounded
// once, clipped at T and dh. Every sum has a fixed order (wgmma's k16
// steps in order, tiles in order), no atomics: a launch is bit-for-bit
// repeatable. bf16 operands that TMA cannot read in place (a base not
// 16-byte aligned, dh not a multiple of 8) are staged by the dkv launch
// into zero-padded copies, which the dq launch reads.
//
// Plain C interface, bound with ctypes: the caller allocates dq, dk, dv
// and the scratch (flash_attention.py's bwd_scratch in f32: D and ds^T;
// bwd_tc_scratch in bf16: D and the staged copies), passes the stream,
// and gets the first CUDA error back. The dkv launch comes first.

#include "flash_common.cuh"
#include "tc_core.cuh"

namespace flash {
struct bwd_tc;   // names the staging copies in a profile
}

namespace {

using flash::chunk;
using flash::kDH;
using flash::keep;
using flash::kLd;
using flash::load_rows;
using flash::round_rows;

constexpr int kQB = 64;           // query rows of a dkv tile and a dq block
constexpr int kGroup = 256;       // threads of a dkv warp group
constexpr int kDkvThreads = 2 * kGroup;
constexpr int kScratchKeys = 128; // the scratch's key rows: Tk rounded up
constexpr int kDqThreads = 64, kDqBK = 16, kDqStages = 3;

struct Bwd {
  const float *q, *k, *v, *dy;
  const float *lse, *D;
  float *dq, *dk, *dv;
  float* dsT;
  int BH, Tq, Tk, dh, Tqp, Tkp;   // Tqp, Tkp: the scratch's padded extents
  int causal, vec;
  float scale;
};

__host__ __device__ constexpr int dkv_floats(int key_tile, int stages) {
  return 2 * key_tile * kLd + stages * 2 * kQB * kLd +
         2 * kQB * (key_tile + 4);
}

template <int kKB, int kStages, bool kBf16>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_dkv_kernel(const Bwd a) {
  constexpr int KI = kKB / 16;     // keys a thread: 8 or 4
  constexpr int kPs = kKB + 4;     // row stride of p and ds, [query][key]
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [kKB][kLd]
  float* vs = ks + kKB * kLd;                    // [kKB][kLd]
  float* ring = vs + kKB * kLd;                  // kStages x q, dy [kQB][kLd]
  float* ps = ring + kStages * 2 * kQB * kLd;    // [kQB][kPs]
  float* dss = ps + kQB * kPs;                   // [kQB][kPs]
  const int b = static_cast<int>(blockIdx.x);
  const int bh = b % a.BH, k0 = (b / a.BH) * kKB;
  const size_t qo = static_cast<size_t>(bh) * a.Tq;
  const size_t ko = static_cast<size_t>(bh) * a.Tk;
  const float* q = a.q + qo * a.dh;
  const float* dy = a.dy + qo * a.dh;
  const float* kg = a.k + ko * a.dh;
  const float* vg = a.v + ko * a.dh;
  const float* lse = a.lse + qo;
  const float* D = a.D + qo;
  float* dsT = a.dsT + static_cast<size_t>(bh) * a.Tkp * a.Tqp;
  const int tid = threadIdx.x, grp = tid / kGroup, t = tid % kGroup;
  const int ty = t / 16, tx = t % 16;
  const bool vec = a.vec != 0;
  const int nq = (a.Tq + kQB - 1) / kQB;
  // query tiles that see this key tile: from the one holding row k0 on
  // when causal (q0 + 63 >= k0), all of them otherwise
  const int first = a.causal ? k0 / kQB : 0;
  const int dh4 = (a.dh + 3) & ~3;

  load_rows<kKB, kDkvThreads>(ks, kLd, kg, k0, a.Tk, a.dh, vec);
  load_rows<kKB, kDkvThreads>(vs, kLd, vg, k0, a.Tk, a.dh, vec);
  if (first < nq) {
    load_rows<kQB, kDkvThreads>(ring, kLd, q, first * kQB, a.Tq, a.dh, vec);
    load_rows<kQB, kDkvThreads>(ring + kQB * kLd, kLd, dy, first * kQB,
                                a.Tq, a.dh, vec);
  }
  gemm::cp_async_commit();

  // group 0: dv; group 1: dk. Row i is key k0 + quad(ty, i), column jj dh
  // 4 tx + jj.
  float acc[KI][4];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  for (int it = first; it < nq; ++it) {
    const int q0 = it * kQB;
    float* qs = ring + (kStages == 2 ? (it - first) % 2 : 0) * 2 * kQB * kLd;
    float* dys = qs + kQB * kLd;
    if (kStages == 1 && it > first) {
      __syncthreads();                 // the last tile's readers are done
      load_rows<kQB, kDkvThreads>(qs, kLd, q, q0, a.Tq, a.dh, vec);
      load_rows<kQB, kDkvThreads>(dys, kLd, dy, q0, a.Tq, a.dh, vec);
      gemm::cp_async_commit();
    }
    gemm::cp_async_wait<0>();
    if (kBf16) {
      if (it == first) {
        round_rows<kKB, kDkvThreads>(ks, kLd);
        round_rows<kKB, kDkvThreads>(vs, kLd);
      }
      round_rows<kQB, kDkvThreads>(qs, kLd);
      round_rows<kQB, kDkvThreads>(dys, kLd);
    }
    __syncthreads();   // tile it landed; the last tile's readers are done
    if (kStages == 2 && it + 1 < nq) {
      float* nqs = ring + ((it + 1 - first) % 2) * 2 * kQB * kLd;
      load_rows<kQB, kDkvThreads>(nqs, kLd, q, q0 + kQB, a.Tq, a.dh, vec);
      load_rows<kQB, kDkvThreads>(nqs + kQB * kLd, kLd, dy, q0 + kQB, a.Tq,
                                  a.dh, vec);
      gemm::cp_async_commit();
    }

    // s^T = k q^T (group 0) or dp^T = v dy^T (group 1) over dh, in order:
    // row i is key k0 + ty + 16 i, column j query q0 + tx + 16 j
    float tile[KI][4];
    {
      const float* ra = grp == 0 ? ks : vs;
      const float* rb = grp == 0 ? qs : dys;
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tile[i][j] = 0.f;
#pragma unroll 1
      for (int c = 0; c < dh4; c += 4) {
        float4 bq[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bq[j] = *reinterpret_cast<const float4*>(rb + (tx + 16 * j) * kLd +
                                                   c);
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const float4 ak =
              *reinterpret_cast<const float4*>(ra + (ty + 16 * i) * kLd + c);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tile[i][j] = fmaf(ak.x, bq[j].x, tile[i][j]);
            tile[i][j] = fmaf(ak.y, bq[j].y, tile[i][j]);
            tile[i][j] = fmaf(ak.z, bq[j].z, tile[i][j]);
            tile[i][j] = fmaf(ak.w, bq[j].w, tile[i][j]);
          }
        }
      }
    }

    // group 0: p to shared, [query][key]; with bf16 operands dv takes it
    // rounded (ps) and ds unrounded (dss, overwritten by ds below)
    if (grp == 0) {
      // whether every pair of the tile is seen (no diagonal, no edge)
      const bool full = (!a.causal || q0 >= k0 + kKB - 1) &&
                        q0 + kQB <= a.Tq && k0 + kKB <= a.Tk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = q0 + tx + 16 * j;
        const float l = qr < a.Tq ? lse[qr] : 0.f;
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const int at = (tx + 16 * j) * kPs + ty + 16 * i;
          // a masked pair's exponent may overflow: the select drops it
          const float e = __expf(tile[i][j] * a.scale - l);
          const float p =
              full || keep(qr, k0 + ty + 16 * i, a.Tq, a.Tk, a.causal)
                  ? e
                  : 0.f;
          ps[at] = ffn::op<kBf16>(p);
          if (kBf16) dss[at] = p;
        }
      }
    }
    __syncthreads();   // p visible

    if (grp == 1) {
      // ds = p (dp - D): to shared, [query][key], and to the scratch as
      // ds^T [key][query]
      const float* praw = kBf16 ? dss : ps;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = q0 + tx + 16 * j;
        const float dd = qr < a.Tq ? D[qr] : 0.f;
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const int at = (tx + 16 * j) * kPs + ty + 16 * i;
          const float ds = ffn::op<kBf16>(praw[at] * (tile[i][j] - dd));
          dss[at] = ds;
          dsT[static_cast<size_t>(k0 + ty + 16 * i) * a.Tqp + qr] = ds;
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kGroup) : "memory");
    }

    // dv += p^T dy (group 0), dk += ds^T q (group 1), over the tile's
    // queries in order
    {
      const float* pa = grp == 0 ? ps : dss;
      const float* rb = grp == 0 ? dys : qs;
#pragma unroll 16
      for (int r = 0; r < kQB; ++r) {
        const float4 bv = *reinterpret_cast<const float4*>(rb + r * kLd +
                                                           4 * tx);
        float av[KI];
#pragma unroll
        for (int h = 0; h < KI / 4; ++h) {
          const float4 x = *reinterpret_cast<const float4*>(
              pa + r * kPs + 64 * h + 4 * ty);
          av[4 * h] = x.x;
          av[4 * h + 1] = x.y;
          av[4 * h + 2] = x.z;
          av[4 * h + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
        }
      }
    }
  }

  float* out = (grp == 0 ? a.dv : a.dk) + ko * a.dh;
  const float scale = grp == 0 ? 1.f : a.scale;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kr = k0 + gemm::quad(ty, i);
    if (kr >= a.Tk) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (4 * tx + jj < a.dh)
        out[static_cast<size_t>(kr) * a.dh + 4 * tx + jj] =
            acc[i][jj] * scale;
  }
}

// D[r] = sum over c < dh of dy[r][c] * y[r][c], 16 threads a row (each
// in column order, then a fixed shuffle tree), in f32.
template <typename T>
__global__ void flash_rowsum_kernel(const T* __restrict__ dy,
                                    const T* __restrict__ y,
                                    float* __restrict__ D, long long rows,
                                    int dh) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 16;
  const int lane = threadIdx.x % 16;
  float s = 0.f;
  if (r < rows)
    for (int c = lane; c < dh; c += 16)
      s = fmaf(flash::widen(dy[r * dh + c]), flash::widen(y[r * dh + c]), s);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0 && r < rows) D[r] = s;
}

// dq of the query rows q0.. of one head: the sum over the keys they see
// of ds^T (the scratch) times k, 8 x 8 a thread (rows quad8(ty, i),
// columns quad8(tx, j)), a kDqStages-deep ring of kDqBK-key steps.
__device__ __forceinline__ int quad8(int base, int q) {
  return (q < 4 ? 0 : 32 - 4) + base * 4 + q;
}

template <bool kBf16>
__global__ void __launch_bounds__(kDqThreads)
    flash_dq_kernel(const Bwd a) {
  constexpr int kStage = kDqBK * (kQB + kDH);
  __shared__ __align__(16) float ring[kDqStages * kStage];
  const int nq = (a.Tq + kQB - 1) / kQB;
  const int b = static_cast<int>(blockIdx.x);
  const int bh = b % a.BH, q0 = (nq - 1 - b / a.BH) * kQB;
  const float* k = a.k + static_cast<size_t>(bh) * a.Tk * a.dh;
  const float* ds = a.dsT + static_cast<size_t>(bh) * a.Tkp * a.Tqp + q0;
  const int kend = a.causal ? min(a.Tk, q0 + kQB) : a.Tk;
  const int steps = (kend + kDqBK - 1) / kDqBK;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const bool vec = a.vec != 0;

  // ds^T rows past kend may not have been written: read as zero
  auto load = [&](int s, int buf) {
    float* as = ring + buf * kStage;
#pragma unroll
    for (int q = 0; q < kDqBK * 16 / kDqThreads; ++q) {
      int r, c;
      chunk<kDqThreads>(q, r, c);
      const int key = s * kDqBK + r;
      const bool ok = key < kend;
      gemm::cp_async16(as + r * kQB + c,
                       ok ? ds + static_cast<size_t>(key) * a.Tqp + c : ds,
                       ok);
    }
    load_rows<kDqBK, kDqThreads>(as + kDqBK * kQB, kDH, k, s * kDqBK, kend,
                                 a.dh, vec);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kDqStages - 1; ++s) {
    if (s < steps) load(s, s);
    gemm::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    gemm::cp_async_wait<kDqStages - 2>();
    const float* as = ring + (s % kDqStages) * kStage;
    float* bs = ring + (s % kDqStages) * kStage + kDqBK * kQB;
    if (kBf16) round_rows<kDqBK, kDqThreads>(bs, kDH);
    __syncthreads();   // step s landed; step s-1's stage is free
    const int ns = s + kDqStages - 1;
    if (ns < steps) load(ns, ns % kDqStages);
    gemm::cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kDqBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kQB +
                                                         4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kQB + 32 +
                                                         4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kDH +
                                                         4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kDH + 32 +
                                                         4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  gemm::cp_async_wait<0>();

  float* dq = a.dq + static_cast<size_t>(bh) * a.Tq * a.dh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + quad8(ty, i);
    if (qr >= a.Tq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = quad8(tx, j);
      if (c < a.dh)
        dq[static_cast<size_t>(qr) * a.dh + c] = acc[i][j] * a.scale;
    }
  }
}

template <int kKB, int kStages, bool kBf16>
cudaError_t launch_dkv(const Bwd& a, cudaStream_t st) {
  auto kern = flash_dkv_kernel<kKB, kStages, kBf16>;
  const size_t smem = dkv_floats(kKB, kStages) * sizeof(float);
  const cudaError_t e =
      ffn::set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  kern<<<((a.Tk + kKB - 1) / kKB) * a.BH, kDkvThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dkv(const Bwd& a, int key_tile, int stages, cudaStream_t st) {
  if (key_tile == 128)
    return stages == 2 ? launch_dkv<128, 2, kBf16>(a, st)
                       : launch_dkv<128, 1, kBf16>(a, st);
  return stages == 2 ? launch_dkv<64, 2, kBf16>(a, st)
                     : launch_dkv<64, 1, kBf16>(a, st);
}

// 16-byte aligned (a float4 of f32)
bool aligned(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

bool bad(int BH, int Tq, int Tk, int dh, const float* dsT) {
  return BH < 1 || Tq < 1 || Tk < 1 || dh < 1 || dh > kDH || !aligned(dsT) ||
         static_cast<long long>((Tk + kQB - 1) / kQB) * BH > 0x7fffffff;
}

Bwd args(const float* q, const float* k, const float* v, const float* dy,
         const float* lse, const float* D, float* dsT, int BH, int Tq, int Tk,
         int dh, int causal) {
  Bwd a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dy = dy;
  a.lse = lse;
  a.D = D;
  a.dsT = dsT;
  a.BH = BH;
  a.Tq = Tq;
  a.Tk = Tk;
  a.dh = dh;
  a.Tqp = (Tq + kQB - 1) / kQB * kQB;
  a.Tkp = (Tk + kScratchKeys - 1) / kScratchKeys * kScratchKeys;
  a.causal = causal != 0;
  a.vec = dh % 4 == 0 && aligned(k) && (q == nullptr || aligned(q)) &&
          (v == nullptr || aligned(v)) && (dy == nullptr || aligned(dy));
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  return a;
}

// -- bf16 storage on the tensor cores ---------------------------------------

namespace bwd_tc {

using bf = __nv_bfloat16;

constexpr int kKB = 128;       // dkv: keys a block, two warpgroups of 64
constexpr int kQT = 64;        // dkv: query rows a tile of its ring
constexpr int kQB = 128;       // dq: query rows a block, two warpgroups
constexpr int kKT = 64;        // dq: keys a tile of its ring
constexpr int kStages = 4;     // tiles in flight in either ring
constexpr int kThreads = 288;  // two consumer warpgroups, a producer warp
constexpr int kBox64 = 64 * 128;     // 64 rows of 64 dh, bf16
constexpr int kBox128 = 128 * 128;   // 128 rows
constexpr int kStageBytes = 2 * kBox64;   // (Q, dY) or (K, V) tiles
// the operands kept for the whole walk (K, V or Q, dY), the ring, and
// room to align them to a 1024-byte swizzle atom
constexpr size_t kSmem =
    2 * kBox128 + static_cast<size_t>(kStages) * kStageBytes + 1024;

// q, dy [BH][Tq][dh], k, v [BH][Tk][dh] as TMA reads them; lse, D [BH][Tq]
// f32; dq, dk, dv [BH][T][dh] bf16.
struct Params {
  CUtensorMap q, k, v, dy;
  const float *lse, *D;
  bf *dq, *dk, *dv;
  int BH, Tq, Tk, dh, causal;
  float scale;
};

// One dkv tile of a warpgroup: s = s^T (keys kr (+ 8) by queries q0 + c0
// + 8 j (+ 1): s[4 j + 2 h + e] at key kr + 8 h, query q0 + c0 + 8 j + e)
// and dp = dp^T alike; lse and D of the tile's 64 queries. p = exp(s *
// scale - lse) (0 where masked) and ds = p (dp - D), from the unrounded
// p, rounded to bf16 into wgmma's A fragments of the tile's four k16
// steps over queries (p[2 j + h]: k16 step j / 2; the layout of an m64nN
// accumulator is that of A's k16 slices). kMask: the tile crosses the
// diagonal, Tq or Tk.
template <bool kMask>
__device__ __forceinline__ void dkv_tile(const float (&s)[32],
                                         const float (&dp)[32],
                                         uint32_t (&p)[16], uint32_t (&ds)[16],
                                         const float* lse, const float* D,
                                         int kr, int q0, int c0,
                                         const Params& a) {
  const bool causal = a.causal != 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + c0 + 8 * j);
    const float2 d = *reinterpret_cast<const float2*>(D + c0 + 8 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pe[2], de[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        // a masked pair's exponent may overflow: the select drops it
        const float x = __expf(s[i] * a.scale - (e ? l.y : l.x));
        pe[e] = !kMask || flash::keep(q0 + c0 + 8 * j + e, kr + 8 * h, a.Tq,
                                      a.Tk, causal)
                    ? x
                    : 0.f;
        de[e] = pe[e] * (dp[i] - (e ? d.y : d.x));
      }
      p[2 * j + h] = tc::pack_bf16(pe[0], pe[1]);
      ds[2 * j + h] = tc::pack_bf16(de[0], de[1]);
    }
  }
}

// One dq tile of a warpgroup, rows qr (+ 8) (lse l[h]) and keys k0 + c0 +
// 8 j (+ 1): p = exp(s * scale - lse) into s, in place, 0 where masked.
// kMask: the tile crosses the diagonal or Tk.
template <bool kMask>
__device__ __forceinline__ void dq_p(float (&s)[32], const float (&l)[2],
                                     int qr, int k0, int c0, const Params& a) {
  const bool causal = a.causal != 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const float x = __expf(s[i] * a.scale - l[h]);
        s[i] = !kMask || flash::keep(qr + 8 * h, k0 + c0 + 8 * j + e, a.Tq,
                                     a.Tk, causal)
                   ? x
                   : 0.f;
      }
}

// ds = p (dp - D) (D d[h] of row qr + 8 h) rounded to bf16 into the A
// fragments of the dq tile's four k16 steps over keys.
__device__ __forceinline__ void dq_ds(const float (&p)[32],
                                      const float (&dp)[32],
                                      uint32_t (&ds)[16], const float (&d)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ds[2 * j + h] = tc::pack_bf16(p[4 * j + 2 * h] * (dp[4 * j + 2 * h] - d[h]),
                                    p[4 * j + 2 * h + 1] *
                                        (dp[4 * j + 2 * h + 1] - d[h]));
}

// acc (+)= A B over 64 deep: four m64n64k16 with both operands in shared
// memory, K-major.
__device__ __forceinline__ void product(float (&acc)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::wgmma64<tc::kKMajor, tc::kKMajor>(acc, tc::step_desc<tc::kKMajor>(a, kk),
                                          tc::step_desc<tc::kKMajor>(b, kk));
}

// acc += A B over 64 deep: A the bf16 fragments in registers, B [64 deep][64
// dh] in shared memory read MN-major.
__device__ __forceinline__ void product_rs(float (&acc)[32],
                                           const uint32_t (&a)[16],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    tc::wgmma64_rs<tc::kMNMajor>(acc, ak, tc::step_desc<tc::kMNMajor>(b, kk));
  }
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

// A warpgroup's 64 x 64 accumulator times `scale` out to rows r (+ 8) of
// out [.][dh], those below `rows`, rounded to bf16 once.
__device__ __forceinline__ void store(bf* out, int r, int rows, int c0,
                                      float scale, const float (&acc)[32],
                                      const Params& a) {
  const bool vec = a.dh % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= rows) continue;
    bf* row = out + static_cast<size_t>(r + 8 * h) * a.dh;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tc::put2(row, c0 + 8 * j, a.dh, vec, acc[4 * j + 2 * h] * scale,
               acc[4 * j + 2 * h + 1] * scale);
  }
}

// dk and dv of one (head, 128 keys): warpgroup w owns keys k0 + 64 w ..
// + 63 and walks the query tiles that see them, from the one holding
// query k0 on when causal.
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_tc_kernel(const __grid_constant__ Params a) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  __shared__ __align__(16) float stats[kStages][2][kQT];   // lse, D
  const uint32_t ks = (tc::smem_u32(smem) + 1023) & ~1023u;
  const uint32_t vs = ks + kBox128, ring = vs + kBox128;
  const uint32_t full = tc::smem_u32(bars), empty = full + 8 * kStages;
  const uint32_t kvbar = full + 16 * kStages;
  const int b = static_cast<int>(blockIdx.x);
  const int bh = b % a.BH, k0 = (b / a.BH) * kKB;
  const bool causal = a.causal != 0;
  const int nq = (a.Tq + kQT - 1) / kQT;
  const int first = causal ? min(nq, k0 / kQT) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::bar_init(full + 8 * s, 32);   // the producer warp's lanes
      tc::bar_init(empty + 8 * s, 2);
    }
    tc::bar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer warp: K and V once; then each stage's Q and dY by TMA
    // (lane 0) and its rows' lse and D by plain loads (every lane, each
    // arriving once its stores are made)
    const int lane = threadIdx.x - 256;
    if (lane == 0) {
      tc::bar_expect(kvbar, 2 * kBox128);
      tc::tma_load3(ks, &a.k, kvbar, 0, k0, bh);
      tc::tma_load3(vs, &a.v, kvbar, 0, k0, bh);
    }
    const size_t row0 = static_cast<size_t>(bh) * a.Tq;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = first; it < nq; ++it) {
      const int q0 = it * kQT;
      tc::bar_wait(empty + 8 * stage, phase ^ 1);
#pragma unroll
      for (int i = lane; i < kQT; i += 32) {
        const bool in = q0 + i < a.Tq;
        stats[stage][0][i] = in ? a.lse[row0 + q0 + i] : 0.f;
        stats[stage][1][i] = in ? a.D[row0 + q0 + i] : 0.f;
      }
      const uint32_t bar = full + 8 * stage;
      if (lane == 0) {
        const uint32_t qs = ring + stage * kStageBytes;
        tc::bar_expect(bar, kStageBytes);
        tc::tma_load3(qs, &a.q, bar, 0, q0, bh);
        tc::tma_load3(qs + kBox64, &a.dy, bar, 0, q0, bh);
      } else {
        tc::bar_arrive(bar);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  const int t = threadIdx.x % 128;
  const int kw = k0 + 64 * wg;   // this warpgroup's first key
  // this thread's keys kr (+ 8) and queries c0 + 8 j (+ 1) of a tile
  const int kr = kw + 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const uint32_t ka = ks + wg * kBox64, va = vs + wg * kBox64;
  float dv[32], dk[32];
  zero(dv);
  zero(dk);
  tc::bar_wait(kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = first; it < nq; ++it) {
    const int q0 = it * kQT;
    tc::bar_wait(full + 8 * stage, phase);
    // the warpgroup skips a tile wholly above its keys' diagonal (the
    // first one of the second warpgroup) or keys wholly past Tk
    if (kw < a.Tk && (!causal || q0 + kQT - 1 >= kw)) {
      const uint32_t qs = ring + stage * kStageBytes, dys = qs + kBox64;
      float s[32], dp[32];
      zero(s);
      zero(dp);
      tc::fence_regs(s);
      tc::fence_regs(dp);
      tc::wg_fence();
      product(s, ka, qs);     // s^T = K Q^T
      product(dp, va, dys);   // dp^T = V dY^T
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(s);
      tc::fence_regs(dp);
      // every pair of the warpgroup's keys and the tile's queries seen
      const bool whole = (!causal || q0 >= kw + 63) && q0 + kQT <= a.Tq &&
                         kw + 64 <= a.Tk;
      // one commit group each way: splitting them, as the dq kernel does,
      // keeps more values live than the 168 registers a thread of nine
      // warps has
      uint32_t p[16], ds[16];
      if (whole)
        dkv_tile<false>(s, dp, p, ds, stats[stage][0], stats[stage][1], kr, q0,
                        c0, a);
      else
        dkv_tile<true>(s, dp, p, ds, stats[stage][0], stats[stage][1], kr, q0,
                       c0, a);
      tc::fence_regs(dv);
      tc::fence_regs(dk);
      tc::fence_regs(p);
      tc::fence_regs(ds);
      tc::wg_fence();
      product_rs(dv, p, dys);   // dV += P^T dY
      product_rs(dk, ds, qs);   // dK += dS^T Q
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(dv);
      tc::fence_regs(dk);
    }
    if (t == 0) tc::bar_arrive(empty + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  const size_t base = static_cast<size_t>(bh) * a.Tk * a.dh;
  store(a.dv + base, kr, a.Tk, c0, 1.f, dv, a);
  store(a.dk + base, kr, a.Tk, c0, a.scale, dk, a);
}

// dq of one (head, 128 query rows), the grid's last query tiles first:
// warpgroup w owns rows q0 + 64 w .. + 63 and walks the key tiles up to
// its rows' diagonal (all of them when not causal).
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_tc_kernel(const __grid_constant__ Params a) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t qs = (tc::smem_u32(smem) + 1023) & ~1023u;
  const uint32_t dys = qs + kBox128, ring = dys + kBox128;
  const uint32_t full = tc::smem_u32(bars), empty = full + 8 * kStages;
  const uint32_t qbar = full + 16 * kStages;
  const int nq = (a.Tq + kQB - 1) / kQB;
  const int b = static_cast<int>(blockIdx.x);
  const int bh = b % a.BH, q0 = (nq - 1 - b / a.BH) * kQB;
  const bool causal = a.causal != 0;
  // key tiles the block needs: those up to its last row's key when causal
  const int all = (a.Tk + kKT - 1) / kKT;
  const int nk =
      causal ? min(all, (min(q0 + kQB, a.Tq) - 1) / kKT + 1) : all;
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
    tc::bar_expect(qbar, 2 * kBox128);
    tc::tma_load3(qs, &a.q, qbar, 0, q0, bh);
    tc::tma_load3(dys, &a.dy, qbar, 0, q0, bh);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nk; ++j) {
      tc::bar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t bar = full + 8 * stage;
      const uint32_t kt = ring + stage * kStageBytes;
      tc::bar_expect(bar, kStageBytes);
      tc::tma_load3(kt, &a.k, bar, 0, j * kKT, bh);
      tc::tma_load3(kt + kBox64, &a.v, bar, 0, j * kKT, bh);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  const int t = threadIdx.x % 128;
  const int qw = q0 + 64 * wg;   // this warpgroup's first query row
  // this thread's rows qr (+ 8) and keys c0 + 8 j (+ 1) of a tile
  const int qr = qw + 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  // the block's key tiles this warpgroup reads; it releases the rest
  const int mine = qw >= a.Tq ? 0
                   : causal   ? min(nk, (min(qw + 64, a.Tq) - 1) / kKT + 1)
                              : nk;
  const size_t row0 = static_cast<size_t>(bh) * a.Tq;
  float l[2], d[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qr + 8 * h < a.Tq;
    l[h] = in ? a.lse[row0 + qr + 8 * h] : 0.f;
    d[h] = in ? a.D[row0 + qr + 8 * h] : 0.f;
  }
  const uint32_t qa = qs + wg * kBox64, dya = dys + wg * kBox64;
  float dq[32];
  zero(dq);
  tc::bar_wait(qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < nk; ++j) {
    tc::bar_wait(full + 8 * stage, phase);
    if (j < mine) {
      const uint32_t kt = ring + stage * kStageBytes, vt = kt + kBox64;
      // P's exps run beside dP's product
      float s[32], dp[32];
      zero(s);
      zero(dp);
      tc::fence_regs(s);
      tc::fence_regs(dp);
      tc::wg_fence();
      product(s, qa, kt);     // S = Q K^T
      tc::wg_commit();
      product(dp, dya, vt);   // dP = dY V^T
      tc::wg_commit();
      tc::wg_wait<1>();
      tc::fence_regs(s);
      const int k0 = j * kKT;
      // every pair of the warpgroup's rows and the tile's keys seen (rows
      // past Tq are computed and never stored)
      const bool whole = k0 + kKT <= a.Tk && (!causal || qw >= k0 + kKT - 1);
      if (whole)
        dq_p<false>(s, l, qr, k0, c0, a);
      else
        dq_p<true>(s, l, qr, k0, c0, a);
      tc::wg_wait<0>();
      tc::fence_regs(dp);
      uint32_t ds[16];
      dq_ds(s, dp, ds, d);
      tc::fence_regs(dq);
      tc::fence_regs(ds);
      tc::wg_fence();
      product_rs(dq, ds, kt);   // dQ += dS K
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(dq);
    }
    if (t == 0) tc::bar_arrive(empty + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store(a.dq + row0 * a.dh, qr, a.Tq, c0, a.scale, dq, a);
}

bool bad(int BH, int Tq, int Tk, int dh) {
  const long long tiles = (static_cast<long long>(Tq > Tk ? Tq : Tk) + 63) / 64;
  return BH < 1 || Tq < 1 || Tk < 1 || dh < 1 || dh > kDH ||
         tiles * BH > 0x7fffffff;
}

// An operand as TMA reads it: in place, or its zero-padded copy [rows][dh8]
// where `staged` is given, made here when `prep` (the dkv launch makes
// the copies, the dq launch reads them).
cudaError_t operand(const void* src, void* staged, long long rows, int dh,
                    bool prep, cudaStream_t st, tc::Operand* out) {
  if (staged != nullptr && !prep) {
    *out = tc::Operand{static_cast<const bf*>(staged), tc::up8(dh)};
    return cudaSuccess;
  }
  return tc::operand<flash::bwd_tc>(static_cast<const bf*>(src),
                                    static_cast<int>(rows), dh,
                                    static_cast<bf*>(staged), st, out);
}

// The four operands' tensor maps, q and dy in boxes of q_rows rows, k and
// v of k_rows, and the rest of the parameters.
cudaError_t params(Params* a, const void* const src[4], void* const staged[4],
                   int BH, int Tq, int Tk, int dh, int causal, int q_rows,
                   int k_rows, bool prep, cudaStream_t st) {
  cudaError_t e;
  tc::Operand op[4];
  const long long rows[4] = {static_cast<long long>(BH) * Tq,
                             static_cast<long long>(BH) * Tk,
                             static_cast<long long>(BH) * Tk,
                             static_cast<long long>(BH) * Tq};
  for (int i = 0; i < 4; ++i)
    if ((e = operand(src[i], staged[i], rows[i], dh, prep, st, &op[i])) !=
        cudaSuccess)
      return e;
  CUtensorMap* maps[4] = {&a->q, &a->k, &a->v, &a->dy};
  for (int i = 0; i < 4; ++i) {
    const bool qside = i == 0 || i == 3;
    if ((e = tc::tensor_map3(maps[i], op[i].p, BH, qside ? Tq : Tk, dh,
                             op[i].ld, qside ? q_rows : k_rows)) !=
        cudaSuccess)
      return e;
  }
  a->BH = BH;
  a->Tq = Tq;
  a->Tk = Tk;
  a->dh = dh;
  a->causal = causal != 0;
  a->scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  return cudaSuccess;
}

template <typename Kern>
cudaError_t launch(Kern kern, int blocks, const Params& a, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (e != cudaSuccess) return e;
  kern<<<blocks, kThreads, kSmem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace bwd_tc

}  // namespace

extern "C" {

// f32 storage (modes 0 and 1, the CUDA cores; bf16 storage is
// flash_attn_dkv_tc_launch's): q, dy, y [BH, Tq, dh], k, v [BH, Tk, dh],
// lse [BH, Tq] -> dk, dv [BH, Tk, dh], D = rowsum(dy * y) [BH, Tq] and
// the scratch dsT [BH][Tk rounded up to 128][Tq rounded up to 64]
// (16-byte aligned; only the tiles the mask leaves are written); dh <=
// 64. key_tile 64 or 128, stages 1 or 2; causal, mxu_bf16: 0 or 1.
// Returns a cudaError_t as int; 0 on success.
int flash_attn_dkv_launch(const void* q, const void* k, const void* v,
                          const void* dy, const float* lse, const void* y,
                          void* dk, void* dv, float* D, float* dsT, int BH,
                          int Tq, int Tk, int dh, int causal, int key_tile,
                          int stages, int mxu_bf16, void* stream) {
  if (bad(BH, Tq, Tk, dh, dsT) || (key_tile != 64 && key_tile != 128) ||
      (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Bwd a = args(static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(dy),
               lse, D, dsT, BH, Tq, Tk, dh, causal);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(BH) * Tq;
  const unsigned grid = static_cast<unsigned>((rows + 15) / 16);
  flash_rowsum_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y), D, rows,
      dh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(mxu_bf16 ? dkv<true>(a, key_tile, stages, st)
                                   : dkv<false>(a, key_tile, stages, st));
}

// k [BH, Tk, dh] and the dkv launch's dsT -> dq [BH, Tq, dh], f32.
int flash_attn_dq_launch(const void* k, const float* dsT, void* dq, int BH,
                         int Tq, int Tk, int dh, int causal, int mxu_bf16,
                         void* stream) {
  if (bad(BH, Tq, Tk, dh, dsT)) return static_cast<int>(cudaErrorInvalidValue);
  Bwd a = args(nullptr, static_cast<const float*>(k), nullptr, nullptr,
               nullptr, nullptr, const_cast<float*>(dsT), BH, Tq, Tk, dh,
               causal);
  a.dq = static_cast<float*>(dq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (Tq + kQB - 1) / kQB * BH;
  if (mxu_bf16)
    flash_dq_kernel<true><<<blocks, kDqThreads, 0, st>>>(a);
  else
    flash_dq_kernel<false><<<blocks, kDqThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The tensor cores' dkv launch on bf16 storage: q, dy, y [BH, Tq, dh], k, v
// [BH, Tk, dh] bf16, lse [BH, Tq] f32 -> D = rowsum(dy * y) [BH, Tq] f32
// and dk, dv [BH, Tk, dh] bf16; dh <= 64. qs, ks, vs, dys: zero-padded
// bf16 copies [BH * T][dh8] (dh8: dh rounded up to 8) for an operand TMA
// cannot read in place (a base not 16-byte aligned or dh not a multiple
// of 8), made here, else null. causal: 0 or 1. Returns a cudaError_t as
// int; 0 on success.
int flash_attn_dkv_tc_launch(const void* q, const void* k, const void* v,
                             const void* dy, const float* lse, const void* y,
                             void* dk, void* dv, float* D, void* qs, void* ks,
                             void* vs, void* dys, int BH, int Tq, int Tk,
                             int dh, int causal, void* stream) {
  using bwd_tc::bf;
  if (bwd_tc::bad(BH, Tq, Tk, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = tc::bind_device(q)) != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(BH) * Tq;
  flash_rowsum_kernel<<<static_cast<unsigned>((rows + 15) / 16), 256, 0,
                        st>>>(static_cast<const bf*>(dy),
                              static_cast<const bf*>(y), D, rows, dh);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const void* src[4] = {q, k, v, dy};
  void* const staged[4] = {qs, ks, vs, dys};
  bwd_tc::Params a{};
  if ((e = bwd_tc::params(&a, src, staged, BH, Tq, Tk, dh, causal,
                          bwd_tc::kQT, bwd_tc::kKB, true, st)) != cudaSuccess)
    return static_cast<int>(e);
  a.lse = lse;
  a.D = D;
  a.dk = static_cast<bf*>(dk);
  a.dv = static_cast<bf*>(dv);
  return static_cast<int>(
      bwd_tc::launch(bwd_tc::flash_dkv_tc_kernel,
                     (Tk + bwd_tc::kKB - 1) / bwd_tc::kKB * BH, a, st));
}

// The tensor cores' dq launch, after the dkv launch on the same operands:
// its D and staged copies (the same qs, ks, vs, dys, or null) -> dq [BH,
// Tq, dh] bf16.
int flash_attn_dq_tc_launch(const void* q, const void* k, const void* v,
                            const void* dy, const float* lse, const float* D,
                            void* dq, void* qs, void* ks, void* vs, void* dys,
                            int BH, int Tq, int Tk, int dh, int causal,
                            void* stream) {
  using bwd_tc::bf;
  if (bwd_tc::bad(BH, Tq, Tk, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = tc::bind_device(q)) != cudaSuccess) return static_cast<int>(e);
  const void* src[4] = {q, k, v, dy};
  void* const staged[4] = {qs, ks, vs, dys};
  bwd_tc::Params a{};
  if ((e = bwd_tc::params(&a, src, staged, BH, Tq, Tk, dh, causal,
                          bwd_tc::kQB, bwd_tc::kKT, false, st)) !=
      cudaSuccess)
    return static_cast<int>(e);
  a.lse = lse;
  a.D = D;
  a.dq = static_cast<bf*>(dq);
  return static_cast<int>(
      bwd_tc::launch(bwd_tc::flash_dq_tc_kernel,
                     (Tq + bwd_tc::kQB - 1) / bwd_tc::kQB * BH, a, st));
}

}  // extern "C"
