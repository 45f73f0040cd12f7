// FFN weight gradients for Hopper (sm_90a):
//   dw1 = (1[h > 0] * (dy w2))^T x,   dw2 = dy^T relu(h),   h = x w1^T.
//
// Replaces the TPU kernel `ffn_bwd_dw_pallas` (body `_bwd_dw_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function, with h recomputed from the block input and the mask
// where(h <= 0, 0, da) (NaN passes). With mxu_bf16, x, dy, w1 and w2 are
// rounded to bf16 and so are a = relu(h) and dh (pallas_ffn.py:231-242);
// sums are f32 either way. On bf16 storage the operands are bf16 already,
// a and dh are rounded to bf16 and dw1, dw2 are stored in bf16, each
// element rounded once from its f32 sum over every token
// (pallas_ffn.py:235-247).
//
// What bounds it: operations. 8*T*d*ffn flops (h, da, dw1, dw2) against
// 2*T*d + 4*d*ffn elements moved; at the main shape (T 8192, d 768,
// ffn 3072) 155 GFLOP: 2.31 ms at the f32 FMA rate of 67 TFLOP/s (mode
// 0), 0.156 ms at the bf16 tensor-core rate of 989 TFLOP/s (modes 1 and
// 2, bf16 operands).
//
// Mode 0 (f32) is unchanged: four products on the f32 GEMM core of
// gemm_core.cuh (a 128 x 128 tile a block of 256 threads, 8 x 8 sums a
// thread, a 3-deep ring of 16-byte cp.async; two blocks an SM), in the
// passes of ffn_gemm.cuh:
//   prep: x and dy copied as [T][d4] and [d][T4], w1 as [d][ffn4] and w2
//     as [d][ffn4] (d4, T4, ffn4: rounded up to 4; zero padded), so that
//     every operand of every product is a row-major [K][M] or [K][N]
//     array read as 16-byte vectors;
//   pass 1: a block owns a [128 tokens x 128 ffn] tile; it sums h over d,
//     writes a = relu(h) to a [T][ffn4] scratch and keeps only h's 64
//     mask bits a thread, then sums da = dy w2 over d in the same
//     registers and writes dh = mask ? da : 0 to a second [T][ffn4]
//     scratch;
//   pass 2: dw1 = dh^T x and dw2 = dy^T a, with the token axis as the
//     depth, split into S slices (ops/fused_ffn.py's dw_plan: the fewest
//     that fill four waves of 264 block slots), each block one tile over
//     one slice in order, the partials to [S][ffn][d] and [S][d][ffn];
//   reduce (only when S > 1): each output element is the sum of its S
//     partials in slice order.
//
// Modes 1 and 2 run on the tensor cores, the passes of ffn_wgmma.cuh:
// wgmma m64n256k16 on bf16 tiles that TMA brings into a 4-stage ring, a
// 128 x 256 tile a block, two consumer warpgroups and a producer warp.
// Against the bound: the products run at the bf16 rate, with no f32
// copies of the operands (mode 2 reads x, dy, w1 and w2 where they lie;
// mode 1 rounds them into a bf16 copy first), and a and dh cross device
// memory once as bf16 (2 x 2 x T x ffn bytes, 0.1 GB at the main shape).
//   pass 1: h = x w1^T (both K-major), its mask as bits, a = relu(h) out
//     as bf16 [T][ffn8]; da = dy w2 (w2 MN-major) and dh out as bf16;
//   pass 2: dw1 = dh^T x and dw2 = dy^T a, all four operands MN-major
//     (the token axis, their rows, is the depth); of their 72 + 72 tiles
//     at the main shape 132 fill one round of the SMs over all tokens,
//     and the last 12 run in 11 token slices each, in one more round of
//     1/11 the depth (fused_ffn.py's tc_dw_plan), their f32 partials
//     summed in slice order; each output rounded once.
// No atomics either way: two calls give the same bits. Ragged T, d and
// ffn are masked in the loads (zero past the edge) and the stores.
//
// Plain C interface, bound with ctypes: the caller allocates dw1, dw2 and
// every scratch piece (ops/fused_ffn.py's dw_scratch and tc_dw_scratch
// have their sizes), passes the stream, and gets the first CUDA error
// back.

#include "ffn_wgmma.cuh"

namespace {

using gemm::up4;
using ffn_gemm::dw;
using bf = __nv_bfloat16;

cudaError_t launch(const float* x, const float* dy, const float* w1,
                   const float* w2, float* dw1, float* dw2, float* xT,
                   float* dyT, float* xc, float* dyc, float* w1T, float* w2c,
                   float* a, float* dh, float* part1, float* part2, int T,
                   int d, int ffn, int S, int L, cudaStream_t st) {
  const int T4 = static_cast<int>(up4(T)), d4 = static_cast<int>(up4(d)),
            f4 = static_cast<int>(up4(ffn));
  gemm::prep<dw>(x, T, d, xc, d4, xT, T4, false, st);
  gemm::prep<dw>(dy, T, d, dyc, d4, dyT, T4, false, st);
  gemm::prep<dw>(w1, ffn, d, nullptr, 0, w1T, f4, false, st);
  gemm::prep<dw>(w2, d, ffn, w2c, f4, nullptr, 0, false, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // h = x w1^T and da = dy w2, [T][ffn4]
  e = ffn_gemm::hidden<dw, ffn_gemm::kStoreA | ffn_gemm::kStoreDh, false>(
      ffn_gemm::Hidden{gemm::Operands{xT, w1T, T4, f4, T4, f4},
                       gemm::Operands{dyT, w2c, T4, f4, T4, f4}, a, dh, T,
                       f4, 0, d},
      st);
  if (e != cudaSuccess) return e;
  return ffn_gemm::sliced<dw, float>(
      ffn_gemm::product(dh, f4, f4, xc, d4, d4, ffn, d),    // dw1 = dh^T x
      ffn_gemm::product(dyc, d4, d4, a, f4, f4, d, ffn),    // dw2 = dy^T a
      dw1, dw2, part1, part2, T, S, L, st);
}

// Modes 1 and 2: Elem the storage (f32 rounded into the staged copies,
// or bf16), Out the outputs'.
template <typename Elem, typename Out>
cudaError_t launch_tc(const Elem* x, const Elem* dy, const Elem* w1,
                      const Elem* w2, Out* dw1, Out* dw2, bf* xs, bf* dys,
                      bf* w1s, bf* w2s, bf* a, bf* dh, float* part, int T,
                      int d, int ffn, int S, int L, int U, int sms,
                      cudaStream_t st) {
  ffn_tc::Operand xo, dyo, w1o, w2o;
  cudaError_t e;
  if ((e = ffn_tc::bind_device(x)) != cudaSuccess ||
      (e = ffn_tc::operand<dw>(x, T, d, xs, st, &xo)) != cudaSuccess ||
      (e = ffn_tc::operand<dw>(dy, T, d, dys, st, &dyo)) != cudaSuccess ||
      (e = ffn_tc::operand<dw>(w1, ffn, d, w1s, st, &w1o)) != cudaSuccess ||
      (e = ffn_tc::operand<dw>(w2, d, ffn, w2s, st, &w2o)) != cudaSuccess)
    return e;
  // a = relu(h), dh: bf16 [T][ffn8]
  if ((e = ffn_tc::hidden<dw, true, true>(xo, w1o, dyo, w2o, a, dh, T, d,
                                          ffn, sms, st)) != cudaSuccess)
    return e;
  const long long f8 = ffn_tc::up8(ffn);
  ffn_tc::SliceParams p{};
  // dw1 [ffn][d] = dh^T x, dw2 [d][ffn] = dy^T a: the tokens are the depth
  if ((e = ffn_tc::tensor_map(&p.a[0], dh, T, ffn, f8, 64)) != cudaSuccess ||
      (e = ffn_tc::tensor_map(&p.b[0], xo.p, T, d, xo.ld, 64)) !=
          cudaSuccess ||
      (e = ffn_tc::tensor_map(&p.a[1], dyo.p, T, d, dyo.ld, 64)) !=
          cudaSuccess ||
      (e = ffn_tc::tensor_map(&p.b[1], a, T, ffn, f8, 64)) != cudaSuccess)
    return e;
  ffn_tc::product(p, 0, dw1, ffn, d, T);
  ffn_tc::product(p, 1, dw2, d, ffn, T);
  return ffn_tc::sliced<dw, Out, ffn_tc::kMNMajor, ffn_tc::kMNMajor>(
      p, part, S, L, U, sms, st);
}

}  // namespace

extern "C" {

// x, dy [T, d], w1 [ffn, d], w2 [d, ffn] -> dw1 [ffn, d], dw2 [d, ffn];
// all f32 (mode 0: the CUDA-core passes). The f32 scratch pieces, each
// 16-byte aligned (T4, d4, ffn4: T, d and ffn rounded up to 4): xT, dyT
// [d][T4]; xc, dyc [T][d4]; w1T, w2c [d][ffn4]; a, dh [T][ffn4]; part1
// [S][ffn][d] and part2 [S][d][ffn] (unused when S is 1). S slices of L
// tokens (S = ceil(T / L)). mode must be 0: modes 1 and 2 are
// ffn_bwd_dw_tc_launch's. Returns a cudaError_t as int; 0 on success.
int ffn_bwd_dw_launch(const void* x, const void* dy, const void* w1,
                      const void* w2, void* dw1, void* dw2, float* xT,
                      float* dyT, float* xc, float* dyc, float* w1T,
                      float* w2c, float* a, float* dh, float* part1,
                      float* part2, int T, int d, int ffn, int S, int L,
                      int mode, void* stream) {
  if (T < 1 || d < 1 || ffn < 1 || !ffn_gemm::covers(T, S, L) || mode != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(dw1), static_cast<float*>(dw2), xT, dyT, xc, dyc,
      w1T, w2c, a, dh, part1, part2, T, d, ffn, S, L,
      static_cast<cudaStream_t>(stream)));
}

// The tensor-core passes, mode 1 (x, dy, w1, w2 and the outputs f32, the
// operands rounded to bf16) or 2 (all bf16). The scratch pieces, each
// 16-byte aligned (d8, ffn8: d and ffn rounded up to 8): the staged bf16
// copies xs, dys [T][d8], w1s [ffn][d8], w2s [d][ffn8] (mode 1: all four;
// mode 2: null for an operand TMA reads in place, which needs a 16-byte
// aligned base and rows a multiple of 8 elements); a, dh bf16
// [T][ffn8]; part, f32 [S][tiles - U][128][256] (unused when S is 1).
// Pass 2's plan: dw1's and dw2's 128 x 256 tiles, [0, U) over all T
// tokens, the others over S slices of L tokens (S = ceil(T / L), L a
// multiple of 64; S 1: every tile whole). The passes are persistent, on
// up to sms blocks (the card's SMs). Returns a cudaError_t as int; 0 on
// success.
int ffn_bwd_dw_tc_launch(const void* x, const void* dy, const void* w1,
                         const void* w2, void* dw1, void* dw2, void* xs,
                         void* dys, void* w1s, void* w2s, void* a, void* dh,
                         float* part, int T, int d, int ffn, int S, int L,
                         int U, int mode, int sms, void* stream) {
  const int all = ffn_tc::tiles(ffn, ffn_tc::kBM) *
                      ffn_tc::tiles(d, ffn_tc::kBN) +
                  ffn_tc::tiles(d, ffn_tc::kBM) *
                      ffn_tc::tiles(ffn, ffn_tc::kBN);
  if (T < 1 || d < 1 || ffn < 1 || !ffn_tc::plan_ok(T, all, S, L, U) ||
      (mode != 1 && mode != 2) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf *xb = static_cast<bf*>(xs), *dyb = static_cast<bf*>(dys),
     *w1b = static_cast<bf*>(w1s), *w2b = static_cast<bf*>(w2s),
     *ab = static_cast<bf*>(a), *dhb = static_cast<bf*>(dh);
  if (mode == 2)
    return static_cast<int>(launch_tc(
        static_cast<const bf*>(x), static_cast<const bf*>(dy),
        static_cast<const bf*>(w1), static_cast<const bf*>(w2),
        static_cast<bf*>(dw1), static_cast<bf*>(dw2), xb, dyb, w1b, w2b, ab,
        dhb, part, T, d, ffn, S, L, U, sms, st));
  return static_cast<int>(launch_tc(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(dw1), static_cast<float*>(dw2), xb, dyb, w1b, w2b,
      ab, dhb, part, T, d, ffn, S, L, U, sms, st));
}

}  // extern "C"
