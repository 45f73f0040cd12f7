// The fused LM head's forward statistics for Hopper (sm_90a): per token
// row, lse = logsumexp(h w^T) over the vocabulary and tz = the target's
// logit, with the [N, V] logits never stored.
//
// Replaces the TPU kernel `head_xent_stats` (body `_fwd_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_xent.py. It computes the
// same function: an online logsumexp over vocab tiles and the target
// column picked by a match that only real vocab columns can make (a
// target outside [0, V) gives tz = 0). The loss, mean(lse - tz), is
// taken outside. With mxu_bf16 (mode 1), h and w are rounded to bf16. On
// bf16 storage (mode 2: h and w bf16, the LM's --dtype bfloat16) the
// logits are the Pallas kernel's dot(bf16, bf16) -> f32 of the exact
// bf16 values; the statistics, lse and tz stay f32.
//
// What bounds it: operations. 2*N*d*V flops against N*d + V*d elements
// read; at N 8192, d 768, V 50304 that is 0.63 TFLOP over 180 MB of f32
// (90 MB of bf16): 9.4 ms at the f32 FMA rate of 67 TFLOP/s (mode 0),
// 0.64 ms at the bf16 tensor-core rate of 989 TFLOP/s (modes 1 and 2).
// So the logit product must reach the card's rate for its operand type,
// which takes tiles deep enough to hide the loads.
//
// Mode 0 (f32) runs on the GEMM core of gemm_core.cuh, which the head's
// backward runs its z = h w^T on: a 128 x 128 tile a block of 256
// threads, 8 x 8 sums a thread, a 3-deep ring of 16-byte cp.async
// operand tiles; two blocks an SM. Three launches:
//  1. prep: h copied as h^T [d][N4] and w as w^T [d][V4] (N4, V4: N and V
//     rounded up to 4; zero padded), the core's [K][M] and [K][N]
//     operands;
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
// the sum. expf (not __expf) throughout.
//
// Modes 1 and 2 run on the tensor cores (tc_core.cuh: wgmma m64n256k16
// fed by TMA, a 128 x 256 logit tile a block, two consumer warpgroups of
// 64 rows and a producer warp, a 4-stage ring, persistent blocks). TMA
// reads h [N][d] and w [V][d], both K-major, where they lie on bf16
// storage, or from bf16 copies (mode 1's rounding, or bf16 that TMA
// cannot read in place: a base not 16-byte aligned or rows not a
// multiple of 8 elements). A work item is one (row tile, vocab slice):
// S slices of L columns (a multiple of 256; fused_xent.py's
// stats_tc_plan picks S so that the R * S items fill whole rounds of the
// card's SMs, 64 x 33 at the main shape), block b of G taking items b, b
// + G, ... For each 256-column tile of its slice, in order, a thread
// reduces each of its two rows over its 64 columns of the tile (those
// below V), the row's quad of threads combines the four in a fixed
// shuffle order, and each keeps the row's running (max, sum of exp) in
// registers; the thread holding the target's column keeps its logit.
// The slice's partials go to the same [3][S][N] scratch and the same
// merge. __expf, whose argument is <= 0 in every call here (z - max, the
// old max - the new); the logits the statistics see differ from the f32
// FMA chain's by the tensor cores' sum of each k16 step, far inside the
// 1e-4 the calls are held to.
//
// No atomics in any mode: every sum has one fixed order (k in order in
// the core, k16 steps in order on wgmma; the tile's columns in a fixed
// shuffle tree; tiles and slices in order), so two calls give the same
// bits.
//
// Plain C interface, bound with ctypes: the caller allocates lse, tz and
// the scratch pieces (ops/fused_xent.py's stats_scratch and
// stats_tc_scratch have their sizes), passes the stream, and gets the
// first CUDA error back.

#include "gemm_core.cuh"
#include "tc_core.cuh"

namespace xent {
// name the copies in a profile: gemm_prep_kernel<xent::stats> (mode 0),
// bf16_prep_kernel<xent::stats_tc> (modes 1 and 2)
struct stats;
struct stats_tc;
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

cudaError_t run(const float* h, const float* w, const int* targets,
                float* lse, float* tz, float* hT, float* wT, float* part,
                int N, int d, int V, int S, int L, cudaStream_t st) {
  const int N4 = static_cast<int>(up4(N)), V4 = static_cast<int>(up4(V));
  gemm::prep<xent::stats>(h, N, d, nullptr, 0, hT, N4, false, st);
  gemm::prep<xent::stats>(w, V, d, nullptr, 0, wT, V4, false, st);
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

// -- modes 1 and 2: the tensor cores ----------------------------------------

using bf = __nv_bfloat16;

// h [N][d] (boxes 64 x 128), w [V][d] (64 x 256); slice q of the items
// holds vocab tiles [q per, min(vt, (q + 1) per)); item i is row tile i %
// row_tiles of slice i / row_tiles.
struct StatsTc {
  CUtensorMap h, w;
  const int* targets;
  float* part;   // [3][S][N]: max, sum of exp, target logit
  int N, d, V, S, per, vt, row_tiles, items;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A consumer thread's running statistics of its two rows h (row, row +
// 8), kept in shared memory so that only the accumulators stay in
// registers across a tile's products (ptxas holds the consumers to the
// launch's 168 registers, 128 of them the accumulators): max m[h], sum
// of exp s[h], target logit z[h], the target's column tg[h] (-1 for a
// row past N).
struct RowStats {
  float m[2], s[2], z[2];
  int tg[2], row;
};

// One logit tile of columns [n0, n0 + 256) folded into a thread's two
// rows' statistics: acc[4 j + 2 h + e] is row h's logit at tile column
// c0 + 8 j + e, those below ncols real (kEdge: the tile at V's edge).
template <bool kEdge>
__device__ __forceinline__ void fold_tile(const float (&acc)[128], int c0,
                                          int n0, int ncols, RowStats* rs) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!kEdge || c0 + 8 * j + e < ncols)
          mx = fmaxf(mx, acc[4 * j + 2 * h + e]);
    const float m_old = rs->m[h];
    const float mn = fmaxf(m_old, quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!kEdge || c0 + 8 * j + e < ncols)
          sum += __expf(acc[4 * j + 2 * h + e] - mn);
    rs->s[h] = rs->s[h] * __expf(m_old - mn) + quad_sum(sum);
    rs->m[h] = mn;
    const int col = rs->tg[h] - n0;
    if (col >= 0 && col < ncols) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + 8 * j + e == col) rs->z[h] = acc[4 * j + 2 * h + e];
    }
  }
}

// Persistent: block b of G takes items b, b + G, ..., its producer warp
// filling the ring with each item's tiles in order while the consumers
// fold the last tile.
__global__ void __launch_bounds__(tc::kThreads, 1)
    head_stats_tc_kernel(const __grid_constant__ StatsTc p) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * tc::kStages];
  __shared__ RowStats stats[2 * tc::kBM];   // one a consumer thread
  const tc::Ring r = tc::ring_setup(smem, bars, tc::kStages);
  const int nk = (p.d + tc::kBK - 1) / tc::kBK;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  // the producer's walk over three loops takes more than the 40
  // registers the FFN passes give theirs; the consumers need fewer than
  // those passes (no mask bits), so the budget moves: 2 x 128 x 216 + 128
  // x 56 of the SM's 65536
  if (wg == 2) {
    tc::regs_dec<56>();
    if (threadIdx.x != 256) return;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int m0 = (item % p.row_tiles) * tc::kBM;
      const int j0 = (item / p.row_tiles) * p.per;
      // the item's tiles x depth stages, in order
      const int n = (min(p.vt, j0 + p.per) - j0) * nk;
      for (int q = 0; q < n; ++q) {
        uint32_t bar;
        const uint32_t a = tc::produce(r, stage, phase, bar);
        const int i = q % nk;
        tc::load<tc::kKMajor, tc::kBM>(a, &p.h, bar, m0, i * tc::kBK);
        tc::load<tc::kKMajor, tc::kBN>(a + tc::kABytes, &p.w, bar,
                                       (j0 + q / nk) * tc::kBN, i * tc::kBK);
      }
    }
  } else {
    tc::regs_inc<216>();
    RowStats* rs = stats + threadIdx.x;
    const int t = threadIdx.x % 128;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      // this thread's rows r0 and r0 + 8
      const int r0 = (item % p.row_tiles) * tc::kBM + 64 * wg +
                     16 * (t / 32) + (t % 32) / 4;
      rs->row = r0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs->tg[h] = r0 + 8 * h < p.N ? p.targets[r0 + 8 * h] : -1;
        rs->m[h] = kNeg;
        rs->s[h] = 0.f;
        rs->z[h] = 0.f;
      }
      const int j0 = (item / p.row_tiles) * p.per;
      for (int j = j0; j < min(p.vt, j0 + p.per); ++j) {
        float acc[128];
        tc::zero(acc);
        tc::consume<tc::kKMajor, tc::kKMajor>(acc, nk, r, stage, phase, wg);
        const int n0 = j * tc::kBN, ncols = min(tc::kBN, p.V - n0);
        if (ncols == tc::kBN)
          fold_tile<false>(acc, 2 * (t % 4), n0, ncols, rs);
        else
          fold_tile<true>(acc, 2 * (t % 4), n0, ncols, rs);
      }
      // the slice's partials of both rows (z from the one thread of the
      // quad that holds the target's column: the others add zeros)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float zq = quad_sum(rs->z[h]);
        const int row = rs->row + 8 * h;
        if (t % 4 == 0 && row < p.N) {
          const size_t at =
              static_cast<size_t>(item / p.row_tiles) * p.N + row;
          const size_t plane = static_cast<size_t>(p.S) * p.N;
          p.part[at] = rs->m[h];
          p.part[plane + at] = rs->s[h];
          p.part[2 * plane + at] = zq;
        }
      }
    }
  }
}

// Elem: the storage of h and w (f32 rounded into the staged copies, or
// bf16).
template <typename Elem>
cudaError_t run_tc(const Elem* h, const Elem* w, const int* targets,
                   float* lse, float* tz, bf* hs, bf* ws, float* part, int N,
                   int d, int V, int S, int L, int sms, cudaStream_t st) {
  using Tag = xent::stats_tc;
  tc::Operand ho, wo;
  cudaError_t e;
  if ((e = tc::bind_device(h)) != cudaSuccess ||
      (e = tc::operand<Tag>(h, N, d, hs, st, &ho)) != cudaSuccess ||
      (e = tc::operand<Tag>(w, V, d, ws, st, &wo)) != cudaSuccess)
    return e;
  StatsTc p{};
  if ((e = tc::tensor_map(&p.h, ho.p, N, d, ho.ld, tc::kBM)) !=
          cudaSuccess ||
      (e = tc::tensor_map(&p.w, wo.p, V, d, wo.ld, tc::kBN)) != cudaSuccess)
    return e;
  p.targets = targets;
  p.part = part;
  p.N = N;
  p.d = d;
  p.V = V;
  p.S = S;
  p.per = L / tc::kBN;
  p.vt = tc::tiles(V, tc::kBN);
  p.row_tiles = tc::tiles(N, tc::kBM);
  p.items = p.row_tiles * S;
  if ((e = tc::launch(head_stats_tc_kernel, p.items < sms ? p.items : sms,
                      tc::kSliceSmem, p, st)) != cudaSuccess)
    return e;
  head_xent_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, lse, tz, N,
                                                          S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h [N, d], w [V, d] f32, targets [N] int32 -> lse [N], tz [N] f32 (mode
// 0, the GEMM core; modes 1 and 2 are head_xent_stats_tc_launch's). The
// f32 scratch pieces, each 16-byte aligned: hT [d][N4]; wT [d][V4]; part
// [3][S][N]. S slices of L vocab columns (L a multiple of 128, S =
// ceil(V / L)). Returns a cudaError_t as int; 0 on success.
int head_xent_stats_launch(const void* h, const void* w, const int* targets,
                           float* lse, float* tz, float* hT, float* wT,
                           float* part, int N, int d, int V, int S, int L,
                           int mode, void* stream) {
  if (N < 1 || d < 1 || V < 1 || S < 1 || L < 1 || L % kTile != 0 ||
      static_cast<long long>(S - 1) * L >= V ||
      static_cast<long long>(S) * L < V || mode != 0 ||
      ((reinterpret_cast<size_t>(hT) | reinterpret_cast<size_t>(wT)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(static_cast<const float*>(h),
                              static_cast<const float*>(w), targets, lse, tz,
                              hT, wT, part, N, d, V, S, L,
                              static_cast<cudaStream_t>(stream)));
}

// The tensor-core statistics, mode 1 (h, w f32, rounded to bf16) or 2
// (h, w bf16); targets [N] int32 -> lse [N], tz [N] f32. The scratch
// pieces, each 16-byte aligned (d8: d rounded up to 8): the staged bf16
// copies hs [N][d8], ws [V][d8] (mode 1: both; mode 2: null for an
// operand TMA reads in place, which needs a 16-byte aligned base and rows
// a multiple of 8 elements); part f32 [3][S][N]. S slices of L vocab
// columns (L a multiple of 256, S = ceil(V / L)); the blocks are
// persistent, on up to sms (the card's SMs). Returns a cudaError_t as
// int; 0 on success.
int head_xent_stats_tc_launch(const void* h, const void* w,
                              const int* targets, float* lse, float* tz,
                              void* hs, void* ws, float* part, int N, int d,
                              int V, int S, int L, int mode, int sms,
                              void* stream) {
  if (N < 1 || d < 1 || V < 1 || S < 1 || L < 1 || L % tc::kBN != 0 ||
      static_cast<long long>(S - 1) * L >= V ||
      static_cast<long long>(S) * L < V || (mode != 1 && mode != 2) ||
      sms < 1 || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf *hb = static_cast<bf*>(hs), *wb = static_cast<bf*>(ws);
  if (mode == 2)
    return static_cast<int>(run_tc(static_cast<const bf*>(h),
                                   static_cast<const bf*>(w), targets, lse,
                                   tz, hb, wb, part, N, d, V, S, L, sms, st));
  return static_cast<int>(run_tc(static_cast<const float*>(h),
                                 static_cast<const float*>(w), targets, lse,
                                 tz, hb, wb, part, N, d, V, S, L, sms, st));
}

}  // extern "C"
