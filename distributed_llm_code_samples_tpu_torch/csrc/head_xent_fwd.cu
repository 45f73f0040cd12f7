// The fused LM head's forward statistics for Hopper (sm_90a): per token
// row, lse = logsumexp(h w^T) over the vocabulary and tz = the target's
// logit, with the [N, V] logits never stored.
//
// Replaces the TPU kernel `head_xent_stats` (body `_fwd_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_xent.py. It computes the
// same function: an online logsumexp over vocab tiles and the target
// column picked by a match that only real vocab columns can make (a
// target outside [0, V) gives tz = 0). The loss, mean(lse - tz), is
// taken outside. With mxu_bf16, h and w are rounded to bf16. On bf16
// storage (h and w bf16, the LM's --dtype bfloat16) the copies widen
// them exactly into the f32 scratch, so the f32 products are the Pallas
// kernel's dot(bf16, bf16) -> f32; the statistics, lse and tz stay f32.
//
// What bounds it: operations. 2*N*d*V flops against N*d + V*d floats
// read; at N 8192, d 768, V 50304 that is 0.63 TFLOP over 180 MB, 9.4 ms
// at the f32 FMA rate of 67 TFLOP/s. So the logit product must reach the
// FMA rate, which takes GEMM tiling deep enough to hide the loads.
//
// Design. The logits run on the GEMM core of gemm_core.cuh, which the
// head's backward runs its z = h w^T on: a 128 x 128 tile a block of 256
// threads, 8 x 8 sums a thread, a 3-deep ring of 16-byte cp.async
// operand tiles; two blocks an SM. Three launches:
//  1. prep: h copied as h^T [d][N4] and w as w^T [d][V4] (N4, V4: N and V
//     rounded up to 4; zero padded; rounded to bf16 with mxu_bf16, once,
//     so the bf16 mode costs what f32 costs), the core's [K][M] and
//     [K][N] operands;
//  2. stats: block b owns the 128 token rows of row tile b % R (R row
//     tiles) and walks the vocab tiles of slice b / R (S slices of L
//     columns, L a multiple of the tile; ops/fused_xent.py's stats_plan
//     picks S so the R * S blocks fill the card's block slots: 64 x 4 at
//     the main shape). For each logit tile its epilogue reduces each row
//     over the tile's real columns (a max and a sum of expf by shuffles
//     over the 16 threads that share the row) and one thread a row folds
//     that into the row's running (max, sum of exp), kept in shared
//     memory behind the operand ring: the mainloop already takes the 128
//     registers a thread has at two blocks an SM. The thread whose column
//     is the row's target stores its logit there too. Nothing else of
//     the logits is stored; the slice's (max, sum, target logit) of each
//     row go to a [3][S][N] scratch;
//  3. merge: each row's S partials combined in slice order into lse and
//     tz. An all-masked slice merges as (-1e30, 0) without a NaN.
// Columns past V, the padding to V4 included, enter neither the max nor
// the sum. No atomics: every sum has one fixed order (k in order in the
// core; the tile's columns in a fixed shuffle tree; tiles and slices in
// order), so two calls give the same bits. expf (not __expf) throughout.
//
// Plain C interface, bound with ctypes: the caller allocates lse, tz and
// the scratch pieces (ops/fused_xent.py's stats_scratch has their
// sizes), passes the stream, and gets the first CUDA error back.

#include "gemm_core.cuh"

namespace xent {
struct stats;   // names the copies in a profile: gemm_prep_kernel<xent::stats>
}

namespace {

using gemm::kThreads;
using gemm::kTile;
using gemm::quad;
using gemm::up4;

constexpr float kNeg = -1e30f;

// Shared bytes: the operand ring, then each row's running max, sum and
// target logit and the rows' targets (128 each).
constexpr size_t kSmem = gemm::kSmem + 4 * kTile * sizeof(float);

struct Stats {
  gemm::Operands op;   // a: h^T [d][N4]; b: w^T [d][V4]
  const int* targets;
  float* part;         // [3][S][N]: max, sum of exp, target logit
  int N, d, V, S, L, row_tiles;
};

// max and sum over the 16 threads that share a tile row (a half-warp)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
    head_xent_stats_kernel(const Stats p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* run_m = smem + gemm::kSmem / sizeof(float);
  float* run_s = run_m + kTile;
  float* run_z = run_s + kTile;
  int* tgt = reinterpret_cast<int*>(run_z + kTile);
  const int b = static_cast<int>(blockIdx.x);
  const int m0 = (b % p.row_tiles) * kTile, slice = b / p.row_tiles;
  const int v0 = slice * p.L, v1 = min(p.V, v0 + p.L);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (tid < kTile) {
    run_m[tid] = kNeg;
    run_s[tid] = 0.f;
    run_z[tid] = 0.f;
    tgt[tid] = m0 + tid < p.N ? p.targets[m0 + tid] : -1;
  }
  // (the mainloop's first barrier makes these visible)

  for (int n0 = v0; n0 < v1; n0 += kTile) {
    float acc[8][8];
    gemm::mainloop(p.op, m0, n0, 0, p.d, smem, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = quad(ty, i);
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n0 + quad(tx, j) < v1) mx = fmaxf(mx, acc[i][j]);
      mx = half_max(mx);
      // every lane reads the row's running max before the sum's
      // shuffles; lane i writes it after them
      const float m_old = run_m[r];
      const float m_new = fmaxf(m_old, mx);
      const int t = tgt[r];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + quad(tx, j);
        if (col < v1) {
          sum += expf(acc[i][j] - m_new);
          if (col == t) run_z[r] = acc[i][j];
        }
      }
      sum = half_sum(sum);
      if (tx == i) {
        run_s[r] = run_s[r] * expf(m_old - m_new) + sum;
        run_m[r] = m_new;
      }
    }
    __syncthreads();   // the running values are read next tile, and the
                       // operand ring is refilled
  }

  if (tid < kTile && m0 + tid < p.N) {
    const size_t at = static_cast<size_t>(slice) * p.N + m0 + tid;
    const size_t plane = static_cast<size_t>(p.S) * p.N;
    p.part[at] = run_m[tid];
    p.part[plane + at] = run_s[tid];
    p.part[2 * plane + at] = run_z[tid];
  }
}

// lse and tz of each row from its S slices' partials, in slice order.
__global__ void head_xent_merge_kernel(const float* __restrict__ part,
                                       float* __restrict__ lse,
                                       float* __restrict__ tz, int N,
                                       int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const size_t plane = static_cast<size_t>(S) * N;
  float m = part[r], s = part[plane + r], z = part[2 * plane + r];
  for (int q = 1; q < S; ++q) {
    const size_t at = static_cast<size_t>(q) * N + r;
    const float m2 = part[at], s2 = part[plane + at];
    const float mx = fmaxf(m, m2);
    s = s * expf(m - mx) + s2 * expf(m2 - mx);
    m = mx;
    z += part[2 * plane + at];
  }
  lse[r] = m + logf(s);
  tz[r] = z;
}

template <typename Src>
cudaError_t run(const Src* h, const Src* w, const int* targets,
                float* lse, float* tz, float* hT, float* wT, float* part,
                int N, int d, int V, int S, int L, int bf16,
                cudaStream_t st) {
  const int N4 = static_cast<int>(up4(N)), V4 = static_cast<int>(up4(V));
  gemm::prep<xent::stats>(h, N, d, nullptr, 0, hT, N4, bf16, st);
  gemm::prep<xent::stats>(w, V, d, nullptr, 0, wT, V4, bf16, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  Stats p;
  p.op = gemm::Operands{hT, wT, N4, V4, N4, V4};
  p.targets = targets;
  p.part = part;
  p.N = N;
  p.d = d;
  p.V = V;
  p.S = S;
  p.L = L;
  p.row_tiles = (N + kTile - 1) / kTile;
  e = cudaFuncSetAttribute(head_xent_stats_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmem));
  if (e != cudaSuccess) return e;
  head_xent_stats_kernel<<<p.row_tiles * S, kThreads, kSmem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  head_xent_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, lse, tz, N,
                                                          S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h [N, d], w [V, d] of one storage type, targets [N] int32 -> lse [N],
// tz [N] f32. The f32 scratch pieces, each 16-byte aligned: hT [d][N4];
// wT [d][V4]; part [3][S][N]. S slices of L vocab columns (L a multiple
// of 128, S = ceil(V / L)). mode: 0 f32, 1 f32 with bf16 operands
// (mxu_bf16), 2 bf16 storage. Returns a cudaError_t as int; 0 on success.
int head_xent_stats_launch(const void* h, const void* w, const int* targets,
                           float* lse, float* tz, float* hT, float* wT,
                           float* part, int N, int d, int V, int S, int L,
                           int mode, void* stream) {
  if (N < 1 || d < 1 || V < 1 || S < 1 || L < 1 || L % kTile != 0 ||
      static_cast<long long>(S - 1) * L >= V ||
      static_cast<long long>(S) * L < V || mode < 0 || mode > 2 ||
      ((reinterpret_cast<size_t>(hT) | reinterpret_cast<size_t>(wT)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (mode == 2)
    return static_cast<int>(run(static_cast<const bf*>(h),
                                static_cast<const bf*>(w), targets, lse, tz,
                                hT, wT, part, N, d, V, S, L, 0, st));
  return static_cast<int>(run(static_cast<const float*>(h),
                              static_cast<const float*>(w), targets, lse, tz,
                              hT, wT, part, N, d, V, S, L, mode, st));
}

}  // extern "C"
