// The tensor-core passes of the FFN kernels for Hopper (sm_90a): modes 1
// and 2 of ffn_fwd.cu, ffn_bwd_dx.cu and ffn_bwd_dw.cu (bf16 operands,
// f32 sums), and the products of head_xent_bwd.cu's modes 1 and 2. Mode
// 0 (f32) keeps the CUDA-core passes of ffn_gemm.cuh.
//
// Every product is bf16 x bf16 -> f32 on wgmma.mma_async m64n256k16, its
// operands brought into shared memory by TMA straight from row-major bf16
// arrays (the caller's, or a copy: bf16_prep_kernel rounds f32 operands in
// mode 1, and stages bf16 that TMA cannot read: a base not 16-byte aligned
// or rows not a multiple of 8 elements). The ring, descriptors, PTX and
// tensor maps are tc_core.cuh's: a block owns a 128 x 256 output tile at
// a time; 384 threads, two consumer warpgroups of 64 rows each, then one
// producer warp (setmaxnreg hands the producer warpgroup's registers to
// the consumers) that keeps a ring of [128 x 64] A and [64 x 256] B tiles
// in flight. The blocks are persistent, one an SM, each walking its tiles
// through one ring.
//   pass 1 (wgmma_hidden_kernel, a 3-stage ring): a [128 tokens x 256 ffn]
//     tile of h = x w1^T over d (both K-major); its mask !(h <= 0) kept as
//     128 bits a thread (an h near zero summed again: exact_h,
//     serial_h), a = relu(h) stored as bf16 when asked (kStoreA); then,
//     in the backward kernels (kDh), da = dy w2 over d into the same
//     registers (w2 MN-major) and dh = mask ? da : 0 stored as bf16, both
//     [T][ffn8] through a swizzled shared buffer and a TMA store that the
//     next tile's products overlap. NaN passes the mask.
//   pass 2 (wgmma_slice_kernel, a 4-stage ring): one or two products,
//     each with its own depth, operand layouts and output type, the
//     first optionally added to what its output holds; the tiles that
//     fill whole rounds of the card run over the whole depth, the rest
//     (only where they would leave the last round part idle) over S
//     slices of L (a multiple of 64) each, their f32 partials summed in
//     slice order by split_reduce_kernel. No atomics, and wgmma sums a
//     k16 step in a fixed order: two calls give the same bits.
// TMA zero-fills loads past an array's edge and clips its stores there;
// pass 2's stores are masked. The tensor maps come from
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint at run
// time, so nothing links -lcuda.

#pragma once

#include "ffn_gemm.cuh"
#include "tc_core.cuh"

namespace ffn_tc {

using namespace tc;

// -- the kernels -------------------------------------------------------------

// Both kernels are persistent: block b of G takes tiles b, b + G, ...
// (G the card's SMs, or fewer tiles), its producer and consumers walking
// the same tiles through one ring, so the producer fills the next tile's
// stages while the consumers store the last one's outputs.

// Pass 1. x, dy [T][d] (boxes 64 x 128), w1 [ffn][d] (64 x 256), w2
// [d][ffn] (64 x 64); a_out (unused without kStoreA) and dh_out: bf16
// [T][ffn] with rows ffn8 apart (boxes 64 x 64); dy, w2 and dh_out unused
// without kDh (the forward). xg, w1g: the bf16 arrays of the x and w1
// maps, rows ldx and ldw1 apart (exact_h, serial_h).
struct HiddenParams {
  CUtensorMap x, w1, dy, w2, a_out, dh_out;
  const bf16* xg;
  const bf16* w1g;
  long long ldx, ldw1;
  int T, d, ffn, tiles_n, tiles;
};

// The tensor cores sum a k16 step's products aligned to the largest
// magnitude and truncated, so h carries an error of some 2^-21 of the
// magnitudes a thread's tile holds (measured at the main shape), more
// than an f32 FMA chain's, whose partial sums hold most bf16 products
// exactly: enough to flip the sign, and so the mask of where(h <= 0, 0,
// da), of an h within that of zero. An h under kNearZero of the largest
// |h| among the thread's 128 is summed again in float64 (exact_h: exact
// products, the warp's lanes in parallel), and one whose float64 sum is
// under kSerial of it, where an f32 chain's own rounding could give
// another sign, once more as the CUDA-core passes of mode 0 sum it
// (serial_h): the mask and a = relu(h) take the sign mode 0 gives.
constexpr float kNearZero = 0x1p-16f, kSerial = 0x1p-20f;

// h at one (row, col) in float64 from the bf16 rows x and w (16-byte
// aligned, TMA's operands) of depth d: the warp's lanes sum 8-element
// chunks, then the partial sums meet across the warp. Every lane of the
// warp calls it with the same rows.
__device__ __forceinline__ double exact_h(const bf16* x, const bf16* w,
                                          int d) {
  const int lane = threadIdx.x % 32;
  double s = 0.0;
#pragma unroll 4
  for (int k = 8 * lane; k < d; k += 256) {
    if (k + 8 <= d) {
      const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
      const uint4 wv = *reinterpret_cast<const uint4*>(w + k);
      const bf16* xe = reinterpret_cast<const bf16*>(&xv);
      const bf16* we = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s = fma(static_cast<double>(__bfloat162float(xe[e])),
                static_cast<double>(__bfloat162float(we[e])), s);
    } else {
      for (int e = k; e < d; ++e)
        s = fma(static_cast<double>(__bfloat162float(x[e])),
                static_cast<double>(__bfloat162float(w[e])), s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The same h as gemm_core's chain sums it: f32 FMA over k in order from
// zero, by one thread.
__device__ __forceinline__ float serial_h(const bf16* x, const bf16* w,
                                          int d) {
  float s = 0.f;
  int k = 0;
#pragma unroll 2
  for (; k + 8 <= d; k += 8) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
    const uint4 wv = *reinterpret_cast<const uint4*>(w + k);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const bf16* we = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      s = fmaf(__bfloat162float(xe[e]), __bfloat162float(we[e]), s);
  }
  for (; k < d; ++k)
    s = fmaf(__bfloat162float(x[k]), __bfloat162float(w[k]), s);
  return s;
}
template <typename Tag, bool kStoreA, bool kDh>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_hidden_kernel(const __grid_constant__ HiddenParams p) {
  static_assert(kStoreA || kDh, "pass 1 stores a, dh or both");
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const Ring r = ring_setup(smem, bars, kHiddenStages);
  const int nk = (p.d + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  if (wg == 2) {
    regs_dec<40>();
    if (threadIdx.x != 256) return;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kBM, n0 = (tile % p.tiles_n) * kBN;
      for (int i = 0; i < (kDh ? 2 : 1) * nk; ++i) {
        uint32_t bar;
        const uint32_t a = produce(r, stage, phase, bar);
        if (i < nk) {
          load<kKMajor, kBM>(a, &p.x, bar, m0, i * kBK);
          load<kKMajor, kBN>(a + kABytes, &p.w1, bar, n0, i * kBK);
        } else {
          load<kKMajor, kBM>(a, &p.dy, bar, m0, (i - nk) * kBK);
          load<kMNMajor, kBN>(a + kABytes, &p.w2, bar, n0, (i - nk) * kBK);
        }
      }
    }
  } else {
    regs_inc<232>();
    const int t = threadIdx.x % 128;
    const int off = kHiddenStages * kStageBytes + wg * kOutBytes;
    uint8_t* const out = r.base + off;
    const uint32_t out_u32 = r.tiles + off;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kBM, n0 = (tile % p.tiles_n) * kBN;
      const int mw = m0 + 64 * wg;
      // this thread's rows and columns: r0 (+ 8), c0 + 8 j (+ 1)
      const int r0 = mw + 16 * (t / 32) + (t % 32) / 4, c0 = n0 + 2 * (t % 4);
      float acc[128];
      zero(acc);
      // h; its mask kept as bits, a = relu(h) out
      consume<kKMajor, kKMajor>(acc, nk, r, stage, phase, wg);
      uint32_t mask[4] = {0u, 0u, 0u, 0u}, near[4] = {0u, 0u, 0u, 0u};
      float top = 0.f;
#pragma unroll
      for (int i = 0; i < 128; ++i) top = fmaxf(top, fabsf(acc[i]));
#pragma unroll
      for (int i = 0; i < 128; ++i) {
        const float h = acc[i];
        const bool inside = r0 + 8 * ((i >> 1) & 1) < p.T &&
                            c0 + 8 * (i >> 2) + (i & 1) < p.ffn;
        if (!(h <= 0.f)) mask[i / 32] |= 1u << (i % 32);
        if (inside && fabsf(h) < kNearZero * top)
          near[i / 32] |= 1u << (i % 32);
        acc[i] = h <= 0.f ? 0.f : h;
      }
      if (kStoreA) {
        staged_free(wg);
        stage_acc(out, acc);
      }
      // the h near zero: mask and a from exact_h (serial_h nearer still),
      // the warp taking its lanes' elements one at a time
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t bits = near[w];
        for (uint32_t todo = __ballot_sync(0xffffffffu, bits != 0u);
             todo != 0u; todo = __ballot_sync(0xffffffffu, bits != 0u)) {
          const int src = __ffs(todo) - 1;
          const int b = __shfl_sync(0xffffffffu, __ffs(bits) - 1, src);
          const int i = 32 * w + b;
          const int row = mw + 16 * (t / 32) + src / 4 + 8 * ((i >> 1) & 1);
          const int col = n0 + 2 * (src % 4) + 8 * (i >> 2) + (i & 1);
          const bf16* xr = p.xg + row * p.ldx;
          const bf16* wr = p.w1g + col * p.ldw1;
          const double h64 = exact_h(xr, wr, p.d);
          if (t % 32 == src) {
            bits &= bits - 1;
            const float h = fabs(h64) < kSerial * top
                                ? serial_h(xr, wr, p.d)
                                : static_cast<float>(h64);
            if (h <= 0.f)
              mask[w] &= ~(1u << b);
            else
              mask[w] |= 1u << b;
            if (kStoreA)
              *reinterpret_cast<bf16*>(staged(out, row - mw, col - n0)) =
                  __float2bfloat16_rn(h <= 0.f ? 0.f : h);
          }
        }
      }
      if (kStoreA) store_staged(&p.a_out, out_u32, wg, mw, n0);
      if (!kDh) continue;
      // da; dh = where(h <= 0, 0, da) out
      zero(acc);
      consume<kKMajor, kMNMajor>(acc, nk, r, stage, phase, wg);
#pragma unroll
      for (int i = 0; i < 128; ++i)
        acc[i] = (mask[i / 32] >> (i % 32)) & 1u ? acc[i] : 0.f;
      staged_free(wg);
      stage_acc(out, acc);
      store_staged(&p.dh_out, out_u32, wg, mw, n0);
    }
    if (t == 0) bulk_wait();
  }
}

// Pass 2: up to two products out[q] [M][N] = sum over depth K[q] of A B
// (product 0: A [M][K] as kTA, B [K][N] as kTB, out of type Out; product
// 1: kTA1, kTB1, Out1; A boxes of 64 x 128 or 64 x 64, B of 64 x 256 or
// 64 x 64); with add[q], out[q] += the sum (f32 out only). Tiles are
// numbered product 0's, then product 1's. Tiles [0, U) are summed over
// the whole depth and stored; the other nsplit tiles (S > 1 only) over S
// slices of L each, one work item a (slice, tile), their f32 partials to
// part [S][nsplit][128][256] for split_reduce_kernel. U is a multiple of
// the card's SMs, so the unsplit tiles fill whole rounds and the split
// ones share the last: the round that 144 tiles on 132 SMs would leave
// 91% idle.
struct SliceParams {
  CUtensorMap a[2], b[2];
  void* out[2];
  float* part;
  int M[2], N[2], K[2], tiles_n[2], tiles[2], add[2];
  int S, L, U, nsplit;
};

// A tile's product and corner.
struct Tile {
  int q, m0, n0;
};

__host__ __device__ inline Tile tile_of(const int (&tiles)[2],
                                        const int (&tiles_n)[2], int tile) {
  Tile t;
  t.q = tile < tiles[0] ? 0 : 1;
  if (t.q) tile -= tiles[0];
  t.m0 = (tile / tiles_n[t.q]) * kBM;
  t.n0 = (tile % tiles_n[t.q]) * kBN;
  return t;
}

// Work item `item` of pass 2: its tile, slice (-1: the whole depth) and
// depth in ring stages (none for a slice past its product's depth).
struct Item {
  Tile t;
  int split, s, k0, nk;
};

__device__ __forceinline__ Item item_of(const SliceParams& p, int item) {
  Item it;
  int tile = item;
  it.split = -1;
  it.s = 0;
  it.k0 = 0;
  if (item >= p.U) {
    const int j = item - p.U;
    it.split = j % p.nsplit;
    it.s = j / p.nsplit;
    tile = p.U + it.split;
    it.k0 = it.s * p.L;
  }
  it.t = tile_of(p.tiles, p.tiles_n, tile);
  const int K = p.K[it.t.q];
  const int k1 = it.split < 0 ? K : min(K, it.k0 + p.L);
  it.nk = k1 > it.k0 ? (k1 - it.k0 + kBK - 1) / kBK : 0;
  return it;
}

template <typename Tag, typename Out, int kTA, int kTB, typename Out1 = Out,
          int kTA1 = kTA, int kTB1 = kTB>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_slice_kernel(const __grid_constant__ SliceParams p) {
  // one operand layout for both products: one load and product path
  constexpr bool kOne = kTA == kTA1 && kTB == kTB1;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const Ring r = ring_setup(smem, bars, kStages);
  const int items = p.U + p.S * p.nsplit;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  if (wg == 2) {
    regs_dec<40>();
    if (threadIdx.x != 256) return;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item it = item_of(p, item);
      const CUtensorMap* am = it.t.q ? &p.a[1] : &p.a[0];
      const CUtensorMap* bm = it.t.q ? &p.b[1] : &p.b[0];
      for (int i = 0; i < it.nk; ++i) {
        uint32_t bar;
        const uint32_t a = produce(r, stage, phase, bar);
        const int k = it.k0 + i * kBK;
        if (kOne || it.t.q == 0) {
          load<kTA, kBM>(a, am, bar, it.t.m0, k);
          load<kTB, kBN>(a + kABytes, bm, bar, it.t.n0, k);
        } else {
          load<kTA1, kBM>(a, am, bar, it.t.m0, k);
          load<kTB1, kBN>(a + kABytes, bm, bar, it.t.n0, k);
        }
      }
    }
  } else {
    regs_inc<232>();
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item it = item_of(p, item);
      float acc[128];
      zero(acc);
      if (kOne || it.t.q == 0)
        consume<kTA, kTB>(acc, it.nk, r, stage, phase, wg);
      else
        consume<kTA1, kTB1>(acc, it.nk, r, stage, phase, wg);
      const int q = it.t.q, M = p.M[q], N = p.N[q], mw = it.t.m0 + 64 * wg;
      if (it.split >= 0)
        store_acc(p.part + (static_cast<size_t>(it.s) * p.nsplit + it.split) *
                               (kBM * kBN),
                  kBN, kBM, kBN, true, false, 64 * wg, 0, acc);
      else if (q == 0)
        store_acc(static_cast<Out*>(p.out[0]), N, M, N, N % 2 == 0,
                  p.add[0] != 0, mw, it.t.n0, acc);
      else
        store_acc(static_cast<Out1*>(p.out[1]), N, M, N, N % 2 == 0,
                  p.add[1] != 0, mw, it.t.n0, acc);
    }
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// An output element: v (plus what o holds, with add) rounded once.
template <typename Out>
__device__ __forceinline__ void put_sum(Out* o, float v, bool add) {
  put(o, add ? value(o) + v : v);
}

// The split tiles' outputs: each element the sum of its S partials in
// slice order (added to the output with add), rounded once to the
// product's output type; elements past M or N not stored.
struct ReduceParams {
  const float* part;
  void* out[2];
  int M[2], N[2], tiles_n[2], tiles[2], add[2];
  int S, U, nsplit;
};

template <typename Tag, typename Out, typename Out1 = Out>
__global__ void split_reduce_kernel(const ReduceParams p) {
  constexpr int kTile = kBM * kBN;
  const long long n = static_cast<long long>(p.nsplit) * kTile;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    const int j = static_cast<int>(i / kTile), e = static_cast<int>(i % kTile);
    const Tile t = tile_of(p.tiles, p.tiles_n, p.U + j);
    const int m = t.m0 + e / kBN, c = t.n0 + e % kBN;
    if (m >= p.M[t.q] || c >= p.N[t.q]) continue;
    float acc = __ldg(p.part + i);
    for (int s = 1; s < p.S; ++s)
      acc = acc + __ldg(p.part + static_cast<long long>(s) * n + i);
    const size_t at = static_cast<size_t>(m) * p.N[t.q] + c;
    if (t.q == 0)
      put_sum(static_cast<Out*>(p.out[0]) + at, acc, p.add[0] != 0);
    else
      put_sum(static_cast<Out1*>(p.out[1]) + at, acc, p.add[1] != 0);
  }
}

// Pass 1 on [T, d] x (and dy) and the weights: a (kStoreA) and dh (kDh)
// [T][ld]; dy and w2 are read only with kDh.
template <typename Tag, bool kStoreA, bool kDh>
cudaError_t hidden(const Operand& x, const Operand& w1, const Operand& dy,
                   const Operand& w2, bf16* a, bf16* dh, int T, int d,
                   int ffn, int sms, cudaStream_t st) {
  HiddenParams p{};
  cudaError_t e;
  const long long ld = up8(ffn);
  if ((e = tensor_map(&p.x, x.p, T, d, x.ld, kBM)) != cudaSuccess ||
      (e = tensor_map(&p.w1, w1.p, ffn, d, w1.ld, kBN)) != cudaSuccess ||
      (kStoreA &&
       (e = tensor_map(&p.a_out, a, T, ffn, ld, 64)) != cudaSuccess) ||
      (kDh &&
       ((e = tensor_map(&p.dy, dy.p, T, d, dy.ld, kBM)) != cudaSuccess ||
        (e = tensor_map(&p.w2, w2.p, d, ffn, w2.ld, 64)) != cudaSuccess ||
        (e = tensor_map(&p.dh_out, dh, T, ffn, ld, 64)) != cudaSuccess)))
    return e;
  p.xg = x.p;
  p.w1g = w1.p;
  p.ldx = x.ld;
  p.ldw1 = w1.ld;
  p.T = T;
  p.d = d;
  p.ffn = ffn;
  p.tiles_n = tiles(ffn, kBN);
  p.tiles = tiles(T, kBM) * p.tiles_n;
  return launch(wgmma_hidden_kernel<Tag, kStoreA, kDh>,
                p.tiles < sms ? p.tiles : sms, kHiddenSmem, p, st);
}

// One product of pass 2 over depth K: its A and B maps filled by the
// caller.
inline void product(SliceParams& p, int q, void* out, int M, int N, int K) {
  p.out[q] = out;
  p.M[q] = M;
  p.N[q] = N;
  p.K[q] = K;
  p.tiles_n[q] = tiles(N, kBN);
  p.tiles[q] = tiles(M, kBM) * p.tiles_n[q];
}

// Pass 2 on up to sms blocks: tiles [0, U) whole, the rest in S slices
// of L (S 1: every tile whole), then the split tiles' reduce from part.
template <typename Tag, typename Out, int kTA, int kTB, typename Out1 = Out,
          int kTA1 = kTA, int kTB1 = kTB>
cudaError_t sliced(SliceParams& p, float* part, int S, int L, int U, int sms,
                   cudaStream_t st) {
  const int all = p.tiles[0] + p.tiles[1];
  p.S = S;
  p.L = L;
  p.U = S > 1 ? U : all;
  p.nsplit = all - p.U;
  p.part = part;
  const int items = p.U + S * p.nsplit;
  cudaError_t e =
      launch(wgmma_slice_kernel<Tag, Out, kTA, kTB, Out1, kTA1, kTB1>,
             items < sms ? items : sms, kSliceSmem, p, st);
  if (e != cudaSuccess || p.nsplit == 0) return e;
  ReduceParams r{};
  r.part = part;
  for (int q = 0; q < 2; ++q) {
    r.out[q] = p.out[q];
    r.M[q] = p.M[q];
    r.N[q] = p.N[q];
    r.tiles_n[q] = p.tiles_n[q];
    r.tiles[q] = p.tiles[q];
    r.add[q] = p.add[q];
  }
  r.S = S;
  r.U = p.U;
  r.nsplit = p.nsplit;
  split_reduce_kernel<Tag, Out, Out1><<<1024, 256, 0, st>>>(r);
  return cudaGetLastError();
}

// A plan of pass 2 over depth K and `all` tiles: S slices of L (a
// multiple of kBK) cover K, and U of the tiles are whole (S 1: all).
inline bool plan_ok(int K, int all, int S, int L, int U) {
  return ffn_gemm::covers(K, S, L) &&
         (S == 1 || (L % kBK == 0 && U >= 0 && U <= all));
}

}  // namespace ffn_tc
