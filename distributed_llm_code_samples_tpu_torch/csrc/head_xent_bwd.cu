// The fused LM head's backward for Hopper (sm_90a): dh = dz w and dw =
// dz^T h with dz = (exp(h w^T - lse) - onehot(targets)) / N, each logit
// tile computed once.
//
// Replaces the TPU kernel `head_xent_bwd` (bodies `_bwd_dh_kernel` and
// `_bwd_dw_kernel`) in distributed_llm_code_samples_tpu/ops/pallas_xent.py.
// It computes the same function: dz carries the 1/N of the mean and is
// zero on columns past V (the Pallas kernels' padding; here nothing of
// the caller's is padded), and the scalar upstream gradient scales both
// outputs outside the kernels. With mxu_bf16, h, w and dz are rounded to
// bf16 before the products. On bf16 storage (h, w, dh and dw bf16, the
// LM's --dtype bfloat16) it computes what the Pallas kernels compute on
// bf16 refs: h and w widened exactly, z and dz in f32, dz rounded to bf16
// before both products (the kernels' dz.astype(w.dtype)), the products
// summed in f32 and each output rounded to bf16 once. dh, which chunks
// add to, is summed in an f32 copy in the scratch and rounded after the
// last chunk; dw rounds at its one store.
//
// What bounds it on this card: operations. The function needs three
// products (z, dh, dw), 6*N*d*V flops, against 2*N*d + 2*V*d floats that
// must move; at N 8192, d 768, V 50304 that is 1.90 TFLOP, 28.3 ms at the
// f32 FMA rate of 67 TFLOP/s. Two passes that each recompute the logits
// (the Pallas kernels' dh and dw) execute 8*N*d*V, a third more, so the
// logits are computed once here; and the products reach the FMA rate
// only with GEMM tiling, deep enough to hide the loads.
//
// Design. The vocabulary is walked in chunks of at most kMaxChunk columns
// (all but the last of equal size, a multiple of the tile). For each
// chunk c of Vc columns, two launches:
//  1. z_c = h w_c^T, [N, Vc] over d; its epilogue forms dz_c and stores
//     it twice into a bounded scratch, as dz [N][Vc] and as dz^T [Vc][N];
//  2. one launch of two products over their own tiles: dh += dz_c w_c
//     (over the chunk's Vc columns; chunk 0 stores, later chunks add to
//     what dh holds, in chunk order) and dw_c = dz_c^T h (over N).
// So the kernels execute the function's 6*N*d*V flops; dz is written
// twice and read twice, 4*N*V*4 bytes over the vocabulary (6.6 GB at the
// main shape, about 2 ms at 3.35 TB/s). A first launch copies h and w, padded
// (and rounded, with mxu_bf16), into both orientations (h^T, w^T, h, w),
// so that every operand of every product is a row-major [K][M] or [K][N]
// array whose rows are read as 16-byte vectors: no tile is transposed on
// its way into shared memory.
//
// One GEMM core serves the three products (gemm_core.cuh, shared with
// ffn_bwd_dw.cu): a 128 x 128 output tile a block of 256 threads, an
// 8 x 8 register tile a thread, and a 3-deep ring of 16-byte cp.async
// operand tiles in shared memory; two blocks an SM. Arithmetic stays f32
// FMA on the CUDA cores.
// The second launch of a chunk puts the deeper of its two products (dh:
// Vc deep; dw: N deep) first in block order.
// Every output element is summed by one thread in k order and dh's chunks
// are added in chunk order, with no atomics, so two launches on the same
// inputs give the same bits.
//
// Plain C interface, bound with ctypes: the caller allocates dh, dw and
// the scratch (head_xent_bwd_scratch_floats floats), passes the stream,
// and gets the first CUDA error back.

#include <type_traits>

#include "gemm_core.cuh"

namespace xent {
struct bwd_bf16;   // names the bf16 copies in a profile
}

namespace {

using gemm::bf16_round;
using gemm::kThreads;
using gemm::kTile;
using gemm::quad;
using gemm::up4;

constexpr int kMaxChunk = 8192;   // vocabulary columns a chunk, at most

// -- the three products on the GEMM core ------------------------------------

enum Epilogue { kDz = 0, kDh = 1, kDw = 2 };

// out[m][n] = sum over k < K, in order, of a[k][m] * b[k][n], for
// m < M, n < N (gemm_core.cuh's Operands: rows of a and b read up to
// a_ext and b_ext floats).
struct Gemm {
  gemm::Operands op;
  int M, N, K;
  int tiles_n, tiles;
  int epi;
  // kDh, kDw: out [M][ldo], f32 (bf16 when `out_bf16`: each element
  // rounded once at its store); kDh adds to it when `accumulate`
  float* out;
  long long ldo;
  int accumulate;
  int out_bf16;
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
  int round;
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
        acc[i][j] = g.round ? bf16_round(v) : v;
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
  if (g.out_bf16) {
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(g.out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + quad(ty, i);
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + quad(tx, j);
        if (n < g.N) out[m * g.ldo + n] = __float2bfloat16_rn(acc[i][j]);
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

// dh's f32 sum on bf16 storage, rounded into dh once
__global__ void head_xent_round_kernel(const float* __restrict__ src,
                                       __nv_bfloat16* __restrict__ dst,
                                       long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

struct Layout {
  long long Np, dp, Vp;     // padded row lengths
  int n_chunks, width;
  // offsets in floats; dh32: dh's f32 sum on bf16 storage (N * d floats,
  // none on f32 storage)
  long long hT, hc, wT, wc, dz, dzT, dh32, total;
};

Layout layout(int N, int d, int V, bool bf16_storage) {
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
  L.dh32 = L.dzT + static_cast<long long>(L.width) * L.Np;
  L.total = L.dh32 + (bf16_storage ? up4(static_cast<long long>(N) * d) : 0);
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

// Src: the storage type of h and w (and of dh and dw); bf16: round dz
// (and the copies, on f32 storage) to bf16.
template <typename Src>
cudaError_t run(const Src* h, const Src* w, const int* targets,
                const float* lse, Src* dh, Src* dw, float* scratch,
                int N, int d, int V, int bf16, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(Src) == 2;
  using Tag = typename std::conditional<kBf16, xent::bwd_bf16, void>::type;
  const Layout L = layout(N, d, V, kBf16);
  float *hT = scratch + L.hT, *hc = scratch + L.hc, *wT = scratch + L.wT,
        *wc = scratch + L.wc, *dz = scratch + L.dz, *dzT = scratch + L.dzT;
  // dh's sum: dh itself on f32 storage, the f32 copy on bf16
  float* dh_sum = kBf16 ? scratch + L.dh32 : reinterpret_cast<float*>(dh);
  const int dp = static_cast<int>(L.dp), Np = static_cast<int>(L.Np),
            Vp = static_cast<int>(L.Vp);
  gemm::prep<Tag>(h, N, d, hc, dp, hT, Np, kBf16 ? 0 : bf16, st);
  gemm::prep<Tag>(w, V, d, wc, dp, wT, Vp, kBf16 ? 0 : bf16, st);
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
    z.round = bf16;
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
    gh.out = dh_sum;
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
    gw.out = reinterpret_cast<float*>(dw + static_cast<size_t>(v0) * d);
    gw.ldo = d;
    gw.out_bf16 = kBf16;
    // the deeper tiles first
    e = gw.K >= gh.K ? launch_gemm(gw, gh, 2, st)
                     : launch_gemm(gh, gw, 2, st);
    if (e != cudaSuccess) return e;
  }
  if (kBf16) {
    const long long n = static_cast<long long>(N) * d;
    head_xent_round_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             st>>>(dh_sum,
                                   reinterpret_cast<__nv_bfloat16*>(dh), n);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of scratch a call at (N, d, V) in `mode` needs.
long long head_xent_bwd_scratch_floats(int N, int d, int V, int mode) {
  if (N < 1 || d < 1 || V < 1 || mode < 0 || mode > 2) return -1;
  return layout(N, d, V, mode == 2).total;
}

// h [N, d], w [V, d] of one storage type, lse [N] f32, targets [N]
// int32 -> dh [N, d] and dw [V, d] in that type, without the upstream
// scalar; scratch holds head_xent_bwd_scratch_floats(N, d, V, mode)
// floats, 16-byte aligned. mode: 0 f32, 1 f32 with bf16 operands
// (mxu_bf16), 2 bf16 storage. Returns a cudaError_t as int; 0 on success.
int head_xent_bwd_launch(const void* h, const void* w, const int* targets,
                         const float* lse, void* dh, void* dw,
                         float* scratch, int N, int d, int V, int mode,
                         void* stream) {
  if (N < 1 || d < 1 || V < 1 || mode < 0 || mode > 2 ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (mode == 2)
    return static_cast<int>(run(static_cast<const bf*>(h),
                                static_cast<const bf*>(w), targets, lse,
                                static_cast<bf*>(dh), static_cast<bf*>(dw),
                                scratch, N, d, V, 1, st));
  return static_cast<int>(run(static_cast<const float*>(h),
                              static_cast<const float*>(w), targets, lse,
                              static_cast<float*>(dh), static_cast<float*>(dw),
                              scratch, N, d, V, mode, st));
}

}  // extern "C"
