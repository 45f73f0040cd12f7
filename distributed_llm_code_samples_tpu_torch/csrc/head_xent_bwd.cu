// The fused LM head's backward for Hopper (sm_90a): dh = dz w and dw =
// dz^T h with dz = (exp(h w^T - lse) - onehot(targets)) / N, each logit
// tile computed once.
//
// Replaces the TPU kernel `head_xent_bwd` (bodies `_bwd_dh_kernel` and
// `_bwd_dw_kernel`) in distributed_llm_code_samples_tpu/ops/pallas_xent.py.
// It computes the same function: dz carries the 1/N of the mean and is
// zero on columns past V (the Pallas kernels' padding; here nothing of
// the caller's is padded), and the scalar upstream gradient scales both
// outputs outside the kernels. With mxu_bf16 (mode 1), h, w and dz are
// rounded to bf16 before the products. On bf16 storage (mode 2: h, w, dh
// and dw bf16, the LM's --dtype bfloat16) it computes what the Pallas
// kernels compute on bf16 refs: z and dz in f32 from the exact bf16
// values, dz rounded to bf16 before both products (the kernels'
// dz.astype(w.dtype)), the products summed in f32 and each output
// rounded to bf16 once. dh, which chunks add to, is summed in f32 (in
// the scratch on bf16 storage) and rounded after the last chunk; dw
// rounds at its one store.
//
// What bounds it on this card: operations. The function needs three
// products (z, dh, dw), 6*N*d*V flops, against 2*N*d + 2*V*d elements
// that must move; at N 8192, d 768, V 50304 that is 1.90 TFLOP: 28.3 ms
// at the f32 FMA rate of 67 TFLOP/s (mode 0), 1.92 ms at the bf16
// tensor-core rate of 989 TFLOP/s (modes 1 and 2). Two passes that each
// recompute the logits (the Pallas kernels' dh and dw) execute 8*N*d*V,
// a third more, so the logits are computed once here; and the products
// reach the card's rate only with tiles deep enough to hide the loads.
//
// The vocabulary is walked in chunks, so the [N, V] logits are never
// stored whole: for each chunk c of Vc columns, a pass forms dz_c in a
// bounded scratch, then dh += dz_c w_c (over the chunk's Vc columns;
// chunk 0 stores, later chunks add to what dh's f32 sum holds, in chunk
// order) and dw_c = dz_c^T h (over N). Every output element is summed by
// one thread in a fixed order and dh's chunks are added in chunk order,
// with no atomics, so two launches on the same inputs give the same bits.
//
// Mode 0 (f32) runs on the f32 GEMM core of gemm_core.cuh (shared with
// the FFN kernels): a 128 x 128 output tile a block of 256 threads, an
// 8 x 8 register tile a thread, and a 3-deep ring of 16-byte cp.async
// operand tiles in shared memory; two blocks an SM; f32 FMA on the CUDA
// cores. Chunks of at most kMaxChunk columns (all but the last of equal
// size, a multiple of the tile). A first launch copies h and w, padded,
// into both orientations (h^T, w^T, h, w), so that every operand of every
// product is a row-major [K][M] or [K][N] array whose rows are read as
// 16-byte vectors. For each chunk, two launches:
//  1. z_c = h w_c^T, [N, Vc] over d; its epilogue forms dz_c and stores
//     it twice, as dz [N][Vc] and as dz^T [Vc][N], f32;
//  2. one launch of the two products over their own tiles, the deeper of
//     the two (dh: Vc deep; dw: N deep) first in block order.
// dz is written twice and read twice, 4*N*V*4 bytes over the vocabulary
// (6.6 GB at the main shape, about 2 ms at 3.35 TB/s).
//
// Modes 1 and 2 run on the tensor cores (wgmma m64n256k16 fed by TMA,
// the pieces of tc_core.cuh and ffn_wgmma.cuh: a 128 x 256 tile a block,
// two consumer warpgroups and a producer warp, persistent blocks). TMA
// reads h and w where they lie on bf16 storage, or from bf16 copies (mode
// 1's rounding, or bf16 that TMA cannot read in place: a base not 16-byte
// aligned or rows not a multiple of 8 elements). For each chunk of
// `width` columns (a multiple of 256, fused_xent.py's head_tc_plan; the
// last shorter):
//  1. head_dz_kernel: z_c = h w_c^T (both K-major, a 3-stage ring) over
//     d; its epilogue forms dz_c in f32 (zero past N and past the chunk),
//     rounds it to bf16 and stores it once, [N][width8], through a
//     swizzled shared buffer and a TMA store;
//  2. wgmma_slice_kernel, two products over their own tiles (a 4-stage
//     ring): dh (+)= dz_c w_c (dz K-major, w_c MN-major; Vc deep) into
//     dh's f32 sum, and dw_c = dz_c^T h (dz read MN-major through
//     wgmma's transpose bit, h MN-major; N deep), rounded at its store.
// dz crosses device memory as bf16, written once and read twice: 3 x 2 x
// N x V bytes, 2.5 GB at the main shape (0.74 ms at 3.35 TB/s, partly
// from L2). Scratch at the main shape (width 8448 of 6 chunks): dz
// 138.4 MB, dh's f32 sum 25.2 MB on bf16 storage; mode 1 adds the bf16
// copies of h and w (12.6 and 77.3 MB). On one TP rank's 12576 rows
// (width 6400 of 2 chunks): dz 104.9 MB.
//
// Plain C interface, bound with ctypes: the caller allocates dh, dw and
// the scratch (mode 0: head_xent_bwd_scratch_floats floats; modes 1 and
// 2: the pieces of fused_xent.py's head_tc_scratch), passes the stream,
// and gets the first CUDA error back.

#include "ffn_wgmma.cuh"

namespace xent {
struct bwd_tc;   // names the tensor-core passes in a profile
}

namespace {

using gemm::kThreads;
using gemm::kTile;
using gemm::quad;
using gemm::up4;

constexpr int kMaxChunk = 8192;   // mode 0: vocabulary columns a chunk

// -- mode 0: the three products on the GEMM core ----------------------------

enum Epilogue { kDz = 0, kDh = 1, kDw = 2 };

// out[m][n] = sum over k < K, in order, of a[k][m] * b[k][n], for
// m < M, n < N (gemm_core.cuh's Operands: rows of a and b read up to
// a_ext and b_ext floats).
struct Gemm {
  gemm::Operands op;
  int M, N, K;
  int tiles_n, tiles;
  int epi;
  // kDh, kDw: out [M][ldo]; kDh adds to it when `accumulate`
  float* out;
  long long ldo;
  int accumulate;
  // kDz: z -> dz, stored as out [M][ldo] for columns < out_n and as
  // out_t [N][ldo_t] for columns < out_m (the padded extents the next
  // products read)
  float* out_t;
  long long ldo_t;
  int out_m, out_n;
  const float* lse;
  const int* targets;
  int v0;
  float inv_n;
};

__device__ __forceinline__ void gemm_tile(const Gemm& g, int t,
                                          float* smem) {
  const int m0 = (t / g.tiles_n) * kTile, n0 = (t % g.tiles_n) * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[8][8];
  gemm::mainloop(g.op, m0, n0, 0, g.K, smem, acc);

  if (g.epi == kDz) {
    // dz of each logit: (exp(z - lse) - [v0 + v == target]) / N, zero off
    // the tokens and off the chunk's columns. z - lse <= 0, where __expf
    // errs by a few ulps (far inside the 1e-4 the calls are held to) and
    // costs a fraction of expf's instruction sequence, which showed in
    // the call's time.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + quad(ty, i);
      const bool row = m < g.M;
      const float l = row ? g.lse[m] : 0.f;
      const int tg = row ? g.targets[m] : -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + quad(tx, j);
        float v = 0.f;
        if (row && n < g.N)
          v = (__expf(acc[i][j] - l) - (g.v0 + n == tg ? 1.f : 0.f)) *
              g.inv_n;
        acc[i][j] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + quad(ty, i);
      if (m >= g.M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + quad(tx, 4 * h);
        if (n < g.out_n)
          *reinterpret_cast<float4*>(g.out + m * g.ldo + n) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
              acc[i][4 * h + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + quad(tx, j);
      if (n >= g.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + quad(ty, 4 * h);
        if (m < g.out_m)
          *reinterpret_cast<float4*>(g.out_t + n * g.ldo_t + m) = make_float4(
              acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j],
              acc[4 * h + 3][j]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + quad(ty, i);
    if (m >= g.M) continue;
    float* row = g.out + m * g.ldo;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + quad(tx, j);
      if (n >= g.N) continue;
      row[n] = g.accumulate ? row[n] + acc[i][j] : acc[i][j];
    }
  }
}

// Blocks [0, g0.tiles) compute g0's tiles, the rest g1's. The card
// starts blocks in index order as SMs free up, so g0's go first.
__global__ void __launch_bounds__(kThreads, 2)
    head_xent_gemm_kernel(const Gemm g0, const Gemm g1) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = static_cast<int>(blockIdx.x);
  if (t < g0.tiles)
    gemm_tile(g0, t, smem);
  else
    gemm_tile(g1, t - g0.tiles, smem);
}

cudaError_t launch_gemm(const Gemm& g0, const Gemm& g1, int count,
                        cudaStream_t st) {
  const int blocks = g0.tiles + (count > 1 ? g1.tiles : 0);
  head_xent_gemm_kernel<<<blocks, kThreads, gemm::kSmem, st>>>(g0, g1);
  return cudaGetLastError();
}

// The chunking of the vocabulary: n equal chunks of `width` columns (a
// multiple of the tile), the last one shorter.
void chunks(int V, int* n, int* width) {
  *n = (V + kMaxChunk - 1) / kMaxChunk;
  const int per = (V + *n - 1) / *n;
  *width = (per + kTile - 1) / kTile * kTile;
}

struct Layout {
  long long Np, dp, Vp;     // padded row lengths
  int n_chunks, width;
  long long hT, hc, wT, wc, dz, dzT, total;   // offsets in floats
};

Layout layout(int N, int d, int V) {
  Layout L;
  L.Np = up4(N);
  L.dp = up4(d);
  L.Vp = up4(V);
  chunks(V, &L.n_chunks, &L.width);
  L.hT = 0;
  L.hc = L.hT + d * L.Np;
  L.wT = L.hc + N * L.dp;
  L.wc = L.wT + d * L.Vp;
  L.dz = L.wc + V * L.dp;
  L.dzT = L.dz + N * static_cast<long long>(L.width);
  L.total = L.dzT + static_cast<long long>(L.width) * L.Np;
  return L;
}

Gemm blank() {
  Gemm g = {};
  return g;
}

void set_tiles(Gemm* g, long long rows, long long cols) {
  g->tiles_n = static_cast<int>((cols + kTile - 1) / kTile);
  g->tiles = static_cast<int>((rows + kTile - 1) / kTile) * g->tiles_n;
}

cudaError_t run(const float* h, const float* w, const int* targets,
                const float* lse, float* dh, float* dw, float* scratch,
                int N, int d, int V, cudaStream_t st) {
  const Layout L = layout(N, d, V);
  float *hT = scratch + L.hT, *hc = scratch + L.hc, *wT = scratch + L.wT,
        *wc = scratch + L.wc, *dz = scratch + L.dz, *dzT = scratch + L.dzT;
  const int dp = static_cast<int>(L.dp), Np = static_cast<int>(L.Np),
            Vp = static_cast<int>(L.Vp);
  gemm::prep(h, N, d, hc, dp, hT, Np, false, st);
  gemm::prep(w, V, d, wc, dp, wT, Vp, false, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  for (int c = 0; c < L.n_chunks; ++c) {
    const int v0 = c * L.width;
    const int vc = V - v0 < L.width ? V - v0 : L.width;
    const long long vcp = up4(vc);
    Gemm z = blank();            // z = h w_c^T, its epilogue dz
    z.op.a = hT;
    z.op.lda = L.Np;
    z.op.a_ext = static_cast<int>(L.Np);
    z.op.b = wT + v0;
    z.op.ldb = L.Vp;
    z.op.b_ext = static_cast<int>(L.Vp - v0);
    z.M = N;
    z.N = vc;
    z.K = d;
    set_tiles(&z, L.Np, vcp);
    z.epi = kDz;
    z.out = dz;
    z.ldo = vcp;
    z.out_t = dzT;
    z.ldo_t = L.Np;
    z.out_m = static_cast<int>(L.Np);
    z.out_n = static_cast<int>(vcp);
    z.lse = lse;
    z.targets = targets;
    z.v0 = v0;
    z.inv_n = static_cast<float>(1.0 / N);
    e = launch_gemm(z, z, 1, st);
    if (e != cudaSuccess) return e;
    Gemm gh = blank();           // dh (+)= dz_c w_c
    gh.op.a = dzT;
    gh.op.lda = L.Np;
    gh.op.a_ext = static_cast<int>(L.Np);
    gh.op.b = wc + static_cast<size_t>(v0) * L.dp;
    gh.op.ldb = L.dp;
    gh.op.b_ext = static_cast<int>(L.dp);
    gh.M = N;
    gh.N = d;
    gh.K = vc;
    set_tiles(&gh, N, d);
    gh.epi = kDh;
    gh.out = dh;
    gh.ldo = d;
    gh.accumulate = c > 0;
    Gemm gw = blank();           // dw_c = dz_c^T h
    gw.op.a = dz;
    gw.op.lda = vcp;
    gw.op.a_ext = static_cast<int>(vcp);
    gw.op.b = hc;
    gw.op.ldb = L.dp;
    gw.op.b_ext = static_cast<int>(L.dp);
    gw.M = vc;
    gw.N = d;
    gw.K = N;
    set_tiles(&gw, vc, d);
    gw.epi = kDw;
    gw.out = dw + static_cast<size_t>(v0) * d;
    gw.ldo = d;
    // the deeper tiles first
    e = gw.K >= gh.K ? launch_gemm(gw, gh, 2, st)
                     : launch_gemm(gh, gw, 2, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// -- modes 1 and 2: the tensor cores ----------------------------------------

using bf = __nv_bfloat16;

// The z pass of one chunk: h [N][d] (boxes 64 x 128), w_c [vc][d] (64 x
// 256), dz [N][vc] bf16 with rows `width8` apart (64 x 64); the chunk's
// first column v0.
struct DzParams {
  CUtensorMap h, w, dz;
  const float* lse;
  const int* targets;
  int N, d, vc, v0, tiles_n, tiles;
  float inv_n;
};

// Persistent, as ffn_wgmma.cuh's pass 1: block b of G takes tiles b, b +
// G, ... of [N, vc] (128 x 256), its producer warp keeping the ring full
// while the consumers form the last tile's dz and store it.
__global__ void __launch_bounds__(tc::kThreads, 1)
    head_dz_kernel(const __grid_constant__ DzParams p) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * tc::kStages];
  const tc::Ring r = tc::ring_setup(smem, bars, tc::kHiddenStages);
  const int nk = (p.d + tc::kBK - 1) / tc::kBK;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  if (wg == 2) {
    tc::regs_dec<40>();
    if (threadIdx.x != 256) return;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * tc::kBM;
      const int n0 = (tile % p.tiles_n) * tc::kBN;
      for (int i = 0; i < nk; ++i) {
        uint32_t bar;
        const uint32_t a = tc::produce(r, stage, phase, bar);
        tc::load<tc::kKMajor, tc::kBM>(a, &p.h, bar, m0, i * tc::kBK);
        tc::load<tc::kKMajor, tc::kBN>(a + tc::kABytes, &p.w, bar, n0,
                                       i * tc::kBK);
      }
    }
  } else {
    tc::regs_inc<232>();
    const int t = threadIdx.x % 128;
    const int off = tc::kHiddenStages * tc::kStageBytes + wg * tc::kOutBytes;
    uint8_t* const out = r.base + off;
    const uint32_t out_u32 = r.tiles + off;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * tc::kBM;
      const int n0 = (tile % p.tiles_n) * tc::kBN;
      const int mw = m0 + 64 * wg;
      // this thread's rows r0 (+ 8) and columns c0 + 8 j (+ 1) of the chunk
      const int r0 = mw + 16 * (t / 32) + (t % 32) / 4, c0 = n0 + 2 * (t % 4);
      float acc[128];
      tc::zero(acc);
      tc::consume<tc::kKMajor, tc::kKMajor>(acc, nk, r, stage, phase, wg);
      // dz = (exp(z - lse) - [v0 + col == target]) / N: zero past N and
      // past the chunk; __expf as mode 0's epilogue (z - lse <= 0)
      float l[2];
      int tg[2];
      bool row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row[h] = r0 + 8 * h < p.N;
        l[h] = row[h] ? p.lse[r0 + 8 * h] : 0.f;
        tg[h] = row[h] ? p.targets[r0 + 8 * h] : -1;
      }
#pragma unroll
      for (int i = 0; i < 128; ++i) {
        const int h = (i >> 1) & 1, col = c0 + 8 * (i >> 2) + (i & 1);
        acc[i] = row[h] && col < p.vc
                     ? (__expf(acc[i] - l[h]) -
                        (p.v0 + col == tg[h] ? 1.f : 0.f)) *
                           p.inv_n
                     : 0.f;
      }
      // dz rounded to bf16 and stored once (TMA clips past N and vc)
      tc::staged_free(wg);
      tc::stage_acc(out, acc);
      tc::store_staged(&p.dz, out_u32, wg, mw, n0);
    }
    if (t == 0) tc::bulk_wait();
  }
}

// dh's f32 sum on bf16 storage, rounded into dh once
__global__ void head_xent_round_kernel(const float* __restrict__ src,
                                       bf* __restrict__ dst, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

// Elem: the storage of h and w (f32 rounded into the staged copies, or
// bf16), Out: of dh and dw. dh32: dh's f32 sum on bf16 storage.
template <typename Elem, typename Out>
cudaError_t run_tc(const Elem* h, const Elem* w, const int* targets,
                   const float* lse, Out* dh, Out* dw, bf* hs, bf* ws,
                   bf* dz, float* dh32, int N, int d, int V, int width,
                   int sms, cudaStream_t st) {
  using Tag = xent::bwd_tc;
  constexpr bool kF32 = std::is_same<Out, float>::value;
  tc::Operand ho, wo;
  cudaError_t e;
  if ((e = tc::bind_device(h)) != cudaSuccess ||
      (e = tc::operand<Tag>(h, N, d, hs, st, &ho)) != cudaSuccess ||
      (e = tc::operand<Tag>(w, V, d, ws, st, &wo)) != cudaSuccess)
    return e;
  float* const dh_sum = kF32 ? reinterpret_cast<float*>(dh) : dh32;
  const long long ldz = tc::up8(width);
  DzParams z{};
  if ((e = tc::tensor_map(&z.h, ho.p, N, d, ho.ld, tc::kBM)) != cudaSuccess)
    return e;
  z.lse = lse;
  z.targets = targets;
  z.N = N;
  z.d = d;
  z.inv_n = static_cast<float>(1.0 / N);
  for (int v0 = 0; v0 < V; v0 += width) {
    const int vc = V - v0 < width ? V - v0 : width;
    const bf* wc = wo.p + static_cast<size_t>(v0) * wo.ld;
    z.v0 = v0;
    z.vc = vc;
    z.tiles_n = tc::tiles(vc, tc::kBN);
    z.tiles = tc::tiles(N, tc::kBM) * z.tiles_n;
    if ((e = tc::tensor_map(&z.w, wc, vc, d, wo.ld, tc::kBN)) !=
            cudaSuccess ||
        (e = tc::tensor_map(&z.dz, dz, N, vc, ldz, 64)) != cudaSuccess ||
        (e = tc::launch(head_dz_kernel, z.tiles < sms ? z.tiles : sms,
                        tc::kHiddenSmem, z, st)) != cudaSuccess)
      return e;
    ffn_tc::SliceParams p{};
    // dh [N][d] (+)= dz_c w_c: dz K-major, w_c [vc][d] MN-major, vc deep;
    // dw_c [vc][d] = dz_c^T h: dz MN-major, h [N][d] MN-major, N deep
    if ((e = tc::tensor_map(&p.a[0], dz, N, vc, ldz, tc::kBM)) !=
            cudaSuccess ||
        (e = tc::tensor_map(&p.b[0], wc, vc, d, wo.ld, 64)) != cudaSuccess ||
        (e = tc::tensor_map(&p.a[1], dz, N, vc, ldz, 64)) != cudaSuccess ||
        (e = tc::tensor_map(&p.b[1], ho.p, N, d, ho.ld, 64)) != cudaSuccess)
      return e;
    ffn_tc::product(p, 0, dh_sum, N, d, vc);
    p.add[0] = v0 > 0;
    ffn_tc::product(p, 1, dw + static_cast<size_t>(v0) * d, vc, d, N);
    if ((e = ffn_tc::sliced<Tag, float, tc::kKMajor, tc::kMNMajor, Out,
                        tc::kMNMajor, tc::kMNMajor>(p, nullptr, 1, 0, 0, sms,
                                                    st)) != cudaSuccess)
      return e;
  }
  if (!kF32) {
    const long long n = static_cast<long long>(N) * d;
    head_xent_round_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             st>>>(dh32, reinterpret_cast<bf*>(dh), n);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of scratch a mode-0 call at (N, d, V) needs; -1 for another mode
// (modes 1 and 2 take the pieces of head_xent_bwd_tc_launch).
long long head_xent_bwd_scratch_floats(int N, int d, int V, int mode) {
  if (N < 1 || d < 1 || V < 1 || mode != 0) return -1;
  return layout(N, d, V).total;
}

// h [N, d], w [V, d] f32, lse [N] f32, targets [N] int32 -> dh [N, d]
// and dw [V, d] f32, without the upstream scalar; scratch holds
// head_xent_bwd_scratch_floats(N, d, V, 0) floats, 16-byte aligned. mode
// must be 0 (the CUDA-core passes): modes 1 and 2 are
// head_xent_bwd_tc_launch's. Returns a cudaError_t as int; 0 on success.
int head_xent_bwd_launch(const void* h, const void* w, const int* targets,
                         const float* lse, void* dh, void* dw,
                         float* scratch, int N, int d, int V, int mode,
                         void* stream) {
  if (N < 1 || d < 1 || V < 1 || mode != 0 ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(static_cast<const float*>(h),
                              static_cast<const float*>(w), targets, lse,
                              static_cast<float*>(dh), static_cast<float*>(dw),
                              scratch, N, d, V,
                              static_cast<cudaStream_t>(stream)));
}

// The tensor-core passes, mode 1 (h, w, dh and dw f32, h and w rounded to
// bf16) or 2 (all bf16); lse [N] f32, targets [N] int32. The scratch
// pieces, each 16-byte aligned (d8: d rounded up to 8): the staged bf16
// copies hs [N][d8], ws [V][d8] (mode 1: both; mode 2: null for an
// operand TMA reads in place, which needs a 16-byte aligned base and rows
// a multiple of 8 elements); dz bf16 [N][width8]; dh32 f32 [N][d] (mode 2
// only: dh's sum over the chunks). The vocabulary in chunks of `width`
// columns (a multiple of 256; the last shorter). The passes are
// persistent, on up to sms blocks (the card's SMs). Returns a cudaError_t
// as int; 0 on success.
int head_xent_bwd_tc_launch(const void* h, const void* w, const int* targets,
                            const float* lse, void* dh, void* dw, void* hs,
                            void* ws, void* dz, float* dh32, int N, int d,
                            int V, int width, int mode, int sms,
                            void* stream) {
  if (N < 1 || d < 1 || V < 1 || width < 1 || width % tc::kBN != 0 ||
      (mode != 1 && mode != 2) || sms < 1 || dz == nullptr ||
      (mode == 2 && dh32 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf *hb = static_cast<bf*>(hs), *wb = static_cast<bf*>(ws),
     *dzb = static_cast<bf*>(dz);
  if (mode == 2)
    return static_cast<int>(run_tc(
        static_cast<const bf*>(h), static_cast<const bf*>(w), targets, lse,
        static_cast<bf*>(dh), static_cast<bf*>(dw), hb, wb, dzb, dh32, N, d,
        V, width, sms, st));
  return static_cast<int>(run_tc(
      static_cast<const float*>(h), static_cast<const float*>(w), targets,
      lse, static_cast<float*>(dh), static_cast<float*>(dw), hb, wb, dzb,
      nullptr, N, d, V, width, sms, st));
}

}  // extern "C"
