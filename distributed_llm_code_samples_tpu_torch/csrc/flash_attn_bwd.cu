// Flash attention backward for Hopper (sm_90a): dq, dk, dv from (q, k, v,
// dy, y, lse) with the score tiles computed once, never stored whole.
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
// k, v, dy and y: their dq, dk, dv are bf16) the tiles and D's operands
// are read as bf16, the math is the mxu_bf16 math, lse, D and the ds^T
// scratch stay f32, and dq, dk and dv are rounded to bf16 when stored
// (flash_common.cuh).
//
// What bounds it: operations. The function needs five products (s, dp,
// dq, dk, dv), 10*dh flops per visible (query, key) pair, against about
// 10 reads or writes of [T, dh] per head; at 192 heads of T 512, dh 64,
// causal, 16.1 GFLOP over 0.2 GB, 0.24 ms at the f32 FMA rate.
//
// Design. Two launches, no atomics, so a call is bit-for-bit repeatable:
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
//
// The key tile (64 or 128) and the ring's stages (1 or 2) are arguments,
// so chip_smoke.py's flash-bwd-tiles sweep can time each; the wrapper
// (ops/flash_attention.py, BWD_PLAN) passes 128 and 2.
//
// Plain C interface, bound with ctypes: the caller allocates dq, dk, dv
// and the scratch for D and ds^T (flash_attention.py's bwd_scratch),
// passes the stream, and gets the first CUDA error back. The dkv launch
// comes first.

#include <type_traits>

#include "flash_common.cuh"

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
  const void *q, *k, *v, *dy;   // T: float or __nv_bfloat16
  const float *lse, *D;
  void *dq, *dk, *dv;           // T
  float* dsT;
  int BH, Tq, Tk, dh, Tqp, Tkp;   // Tqp, Tkp: the scratch's padded extents
  int causal, vec;
  float scale;
};

__host__ __device__ constexpr int dkv_floats(int key_tile, int stages) {
  return 2 * key_tile * kLd + stages * 2 * kQB * kLd +
         2 * kQB * (key_tile + 4);
}

template <int kKB, int kStages, bool kBf16, typename T>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_dkv_kernel(const Bwd a) {
  // bf16 storage holds bf16 values already: only f32 tiles are rounded
  constexpr bool kRound = kBf16 && std::is_same<T, float>::value;
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
  const T* q = static_cast<const T*>(a.q) + qo * a.dh;
  const T* dy = static_cast<const T*>(a.dy) + qo * a.dh;
  const T* kg = static_cast<const T*>(a.k) + ko * a.dh;
  const T* vg = static_cast<const T*>(a.v) + ko * a.dh;
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
    if (kRound) {
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

  T* out = static_cast<T*>(grp == 0 ? a.dv : a.dk) + ko * a.dh;
  const float scale = grp == 0 ? 1.f : a.scale;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kr = k0 + gemm::quad(ty, i);
    if (kr >= a.Tk) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (4 * tx + jj < a.dh)
        out[static_cast<size_t>(kr) * a.dh + 4 * tx + jj] =
            flash::narrow<T>(acc[i][jj] * scale);
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

template <bool kBf16, typename T>
__global__ void __launch_bounds__(kDqThreads)
    flash_dq_kernel(const Bwd a) {
  constexpr bool kRound = kBf16 && std::is_same<T, float>::value;
  constexpr int kStage = kDqBK * (kQB + kDH);
  __shared__ __align__(16) float ring[kDqStages * kStage];
  const int nq = (a.Tq + kQB - 1) / kQB;
  const int b = static_cast<int>(blockIdx.x);
  const int bh = b % a.BH, q0 = (nq - 1 - b / a.BH) * kQB;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(bh) * a.Tk * a.dh;
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
    if (kRound) round_rows<kDqBK, kDqThreads>(bs, kDH);
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

  T* dq = static_cast<T*>(a.dq) + static_cast<size_t>(bh) * a.Tq * a.dh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + quad8(ty, i);
    if (qr >= a.Tq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = quad8(tx, j);
      if (c < a.dh)
        dq[static_cast<size_t>(qr) * a.dh + c] =
            flash::narrow<T>(acc[i][j] * a.scale);
    }
  }
}

template <int kKB, int kStages, bool kBf16, typename T>
cudaError_t launch_dkv(const Bwd& a, cudaStream_t st) {
  auto kern = flash_dkv_kernel<kKB, kStages, kBf16, T>;
  const size_t smem = dkv_floats(kKB, kStages) * sizeof(float);
  const cudaError_t e =
      ffn::set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  kern<<<((a.Tk + kKB - 1) / kKB) * a.BH, kDkvThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool kBf16, typename T>
cudaError_t dkv(const Bwd& a, int key_tile, int stages, cudaStream_t st) {
  if (key_tile == 128)
    return stages == 2 ? launch_dkv<128, 2, kBf16, T>(a, st)
                       : launch_dkv<128, 1, kBf16, T>(a, st);
  return stages == 2 ? launch_dkv<64, 2, kBf16, T>(a, st)
                     : launch_dkv<64, 1, kBf16, T>(a, st);
}

// 16-byte aligned (a float4 of f32), or with bf16 storage 8-byte (4 bf16)
bool aligned(const void* p, int bf16 = 0) {
  return (reinterpret_cast<size_t>(p) & (bf16 ? 7 : 15)) == 0;
}

bool bad(int BH, int Tq, int Tk, int dh, const float* dsT) {
  return BH < 1 || Tq < 1 || Tk < 1 || dh < 1 || dh > kDH || !aligned(dsT) ||
         static_cast<long long>((Tk + kQB - 1) / kQB) * BH > 0x7fffffff;
}

Bwd args(const void* q, const void* k, const void* v, const void* dy,
         const float* lse, const float* D, float* dsT, int BH, int Tq, int Tk,
         int dh, int causal, int bf16) {
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
  a.vec = dh % 4 == 0 && aligned(k, bf16) &&
          (q == nullptr || aligned(q, bf16)) &&
          (v == nullptr || aligned(v, bf16)) &&
          (dy == nullptr || aligned(dy, bf16));
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  return a;
}

}  // namespace

extern "C" {

// q, dy, y [BH, Tq, dh], k, v [BH, Tk, dh], lse [BH, Tq] -> dk, dv [BH,
// Tk, dh], D = rowsum(dy * y) [BH, Tq] and the scratch dsT [BH][Tk rounded
// up to 128][Tq rounded up to 64] (16-byte aligned; only the tiles the
// mask leaves are written); q, k, v, dy, y, dk and dv f32, or bf16 when
// bf16 is 1 (mxu_bf16 then changes nothing), lse, D and dsT f32; dh <= 64.
// key_tile 64 or 128, stages 1 or 2; causal, mxu_bf16: 0 or 1. Returns a
// cudaError_t as int; 0 on success.
int flash_attn_dkv_launch(const void* q, const void* k, const void* v,
                          const void* dy, const float* lse, const void* y,
                          void* dk, void* dv, float* D, float* dsT, int BH,
                          int Tq, int Tk, int dh, int causal, int key_tile,
                          int stages, int mxu_bf16, int bf16, void* stream) {
  if (bad(BH, Tq, Tk, dh, dsT) || (key_tile != 64 && key_tile != 128) ||
      (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Bwd a = args(q, k, v, dy, lse, D, dsT, BH, Tq, Tk, dh, causal, bf16);
  a.dk = dk;
  a.dv = dv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(BH) * Tq;
  const unsigned grid = static_cast<unsigned>((rows + 15) / 16);
  if (bf16)
    flash_rowsum_kernel<<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(y), D, rows, dh);
  else
    flash_rowsum_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(y), D, rows,
        dh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bf16)
    return static_cast<int>(dkv<true, __nv_bfloat16>(a, key_tile, stages, st));
  return static_cast<int>(mxu_bf16
                              ? dkv<true, float>(a, key_tile, stages, st)
                              : dkv<false, float>(a, key_tile, stages, st));
}

// k [BH, Tk, dh] and the dkv launch's dsT -> dq [BH, Tq, dh] (k and dq f32,
// or bf16 when bf16 is 1).
int flash_attn_dq_launch(const void* k, const float* dsT, void* dq, int BH,
                         int Tq, int Tk, int dh, int causal, int mxu_bf16,
                         int bf16, void* stream) {
  if (bad(BH, Tq, Tk, dh, dsT)) return static_cast<int>(cudaErrorInvalidValue);
  Bwd a = args(nullptr, k, nullptr, nullptr, nullptr, nullptr,
               const_cast<float*>(dsT), BH, Tq, Tk, dh, causal, bf16);
  a.dq = dq;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (Tq + kQB - 1) / kQB * BH;
  if (bf16)
    flash_dq_kernel<true, __nv_bfloat16><<<blocks, kDqThreads, 0, st>>>(a);
  else if (mxu_bf16)
    flash_dq_kernel<true, float><<<blocks, kDqThreads, 0, st>>>(a);
  else
    flash_dq_kernel<false, float><<<blocks, kDqThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
