// FFN input gradient for Hopper (sm_90a):
//   dx = (1[h > 0] * (dy w2)) w1,  h = x w1^T recomputed.
//
// Replaces the TPU kernel `ffn_bwd_dx_pallas` (body `_bwd_dx_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function: the block input is the only residual, h is recomputed,
// and the mask is where(h <= 0, 0, da) (NaN passes). With mxu_bf16, x,
// dy, w1 and w2 are rounded to bf16 and so is dh (pallas_ffn.py:176-182);
// sums are f32 either way. On bf16 storage the operands are bf16 already,
// dh is rounded to bf16 and dx is stored in bf16, rounded once from its
// f32 sum (pallas_ffn.py:180-187).
//
// What bounds it: operations. 6*T*d*ffn flops (h, da and dx, each
// 2*T*d*ffn) against 3*T*d + 2*d*ffn elements moved; at the main shape
// (T 8192, d 768, ffn 3072) 116 GFLOP: 1.73 ms at the f32 FMA rate of
// 67 TFLOP/s (mode 0), 0.117 ms at the bf16 tensor-core rate of
// 989 TFLOP/s (modes 1 and 2, bf16 operands).
//
// The Pallas kernel keeps a [256, d] f32 accumulator and its hidden
// tiles in VMEM and never writes dh out. A Hopper block cannot hold a
// [128 x d] accumulator in registers at d 768, and fusing on output
// tiles would recompute h and da once per band of dx columns. So dh goes
// to device memory once.
//
// Mode 0 (f32) is unchanged: three products on the f32 GEMM core of
// gemm_core.cuh (a 128 x 128 tile a block of 256 threads, 8 x 8 sums a
// thread, a 3-deep ring of 16-byte cp.async; two blocks an SM), in the
// passes of ffn_gemm.cuh:
//   prep: x and dy copied as [d][T4], w1 as [d][ffn4] and [ffn][d4], w2
//     as [d][ffn4] (T4, d4, ffn4: rounded up to 4; zero padded);
//   pass 1: a 128 ffn x 128 token tile a block, computed transposed so
//     that its rows are pass 2's [K][M] operand: h^T = w1 x^T over d,
//     kept as 64 mask bits a thread, then da^T = w2^T dy^T over d in the
//     same registers, and dh^T [ffn][T4] = where(h <= 0, 0, da) out
//     (2 x 4 x T x ffn bytes written and read, 0.2 GB at the main shape);
//   pass 2: dx = dh w1 with ffn as the depth, a 128 x 128 tile of [T, d]
//     a block, split into S slices only where the output's tiles would
//     not fill one wave (ops/fused_ffn.py's out_plan: unsplit at the main
//     shape, which chip_smoke.py's ffn-*-slices sweep found fastest);
//   reduce (only when S > 1): each dx element the sum of its S partials
//     in slice order.
//
// Modes 1 and 2 run on the tensor cores, the passes of ffn_wgmma.cuh:
// wgmma m64n256k16 on bf16 tiles that TMA brings into a 4-stage ring, a
// 128 x 256 tile a block, two consumer warpgroups and a producer warp.
// Against the bound: the products run at the bf16 rate, with no f32
// copies of the operands (mode 2 reads x, dy, w1 and w2 where they lie;
// mode 1 rounds them into a bf16 copy first), and dh crosses device
// memory once as bf16 (2 x 2 x T x ffn bytes, 0.1 GB at the main shape).
//   pass 1: h = x w1^T (both K-major), its mask as bits; da = dy w2 (w2
//     MN-major) and dh out as bf16 [T][ffn8], the layout pass 2 reads as
//     a K-major A;
//   pass 2: dx = dh w1 (w1 MN-major) with ffn as the depth; the tiles
//     that fill whole rounds of the SMs run over all of ffn, the rest in
//     slices where they would leave a round part idle (fused_ffn.py's
//     tc_dx_plan), their f32 partials summed in slice order.
// No atomics either way: two calls give the same bits. Ragged T, d and
// ffn are masked in the loads (zero past the edge) and the stores.
//
// Plain C interface, bound with ctypes: the caller allocates dx and every
// scratch piece (ops/fused_ffn.py's dx_scratch and tc_dx_scratch have
// their sizes), passes the stream, and gets the first CUDA error back.

#include "ffn_wgmma.cuh"

namespace {

using gemm::up4;
using Tag = ffn_gemm::dx;
using bf = __nv_bfloat16;

cudaError_t launch(const float* x, const float* dy, const float* w1,
                   const float* w2, float* dx, float* xT, float* dyT,
                   float* w1T, float* w2c, float* w1c, float* dhT,
                   float* part, int T, int d, int ffn, int S, int L,
                   cudaStream_t st) {
  const int T4 = static_cast<int>(up4(T)), d4 = static_cast<int>(up4(d)),
            f4 = static_cast<int>(up4(ffn));
  gemm::prep<Tag>(x, T, d, nullptr, 0, xT, T4, false, st);
  gemm::prep<Tag>(dy, T, d, nullptr, 0, dyT, T4, false, st);
  gemm::prep<Tag>(w1, ffn, d, w1c, d4, w1T, f4, false, st);
  gemm::prep<Tag>(w2, d, ffn, w2c, f4, nullptr, 0, false, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // h^T = w1 x^T, da^T = w2^T dy^T; dh^T [ffn][T4] out
  e = ffn_gemm::hidden<Tag, ffn_gemm::kStoreDh, false>(
      ffn_gemm::Hidden{gemm::Operands{w1T, xT, f4, T4, f4, T4},
                       gemm::Operands{w2c, dyT, f4, T4, f4, T4}, nullptr, dhT,
                       ffn, T4, 0, d},
      st);
  if (e != cudaSuccess) return e;
  return ffn_gemm::sliced<Tag, float>(
      ffn_gemm::product(dhT, T4, T4, w1c, d4, d4, T, d),   // dx = dh w1
      ffn_gemm::Product{}, dx, nullptr, part, nullptr, ffn, S, L, st);
}

// Modes 1 and 2: Elem the storage (f32 rounded into the staged copies,
// or bf16), Out the output's.
template <typename Elem, typename Out>
cudaError_t launch_tc(const Elem* x, const Elem* dy, const Elem* w1,
                      const Elem* w2, Out* dx, bf* xs, bf* dys, bf* w1s,
                      bf* w2s, bf* dh, float* part, int T, int d, int ffn,
                      int S, int L, int U, int sms, cudaStream_t st) {
  ffn_tc::Operand xo, dyo, w1o, w2o;
  cudaError_t e;
  if ((e = ffn_tc::bind_device(x)) != cudaSuccess ||
      (e = ffn_tc::operand<Tag>(x, T, d, xs, st, &xo)) != cudaSuccess ||
      (e = ffn_tc::operand<Tag>(dy, T, d, dys, st, &dyo)) != cudaSuccess ||
      (e = ffn_tc::operand<Tag>(w1, ffn, d, w1s, st, &w1o)) != cudaSuccess ||
      (e = ffn_tc::operand<Tag>(w2, d, ffn, w2s, st, &w2o)) != cudaSuccess)
    return e;
  // dh: bf16 [T][ffn8]
  if ((e = ffn_tc::hidden<Tag, false, true>(xo, w1o, dyo, w2o, nullptr, dh,
                                            T, d, ffn, sms, st)) !=
      cudaSuccess)
    return e;
  ffn_tc::SliceParams p{};
  // dx [T][d] = dh w1: dh K-major, w1 [ffn][d] MN-major, ffn the depth
  if ((e = ffn_tc::tensor_map(&p.a[0], dh, T, ffn, ffn_tc::up8(ffn),
                              ffn_tc::kBM)) != cudaSuccess ||
      (e = ffn_tc::tensor_map(&p.b[0], w1o.p, ffn, d, w1o.ld, 64)) !=
          cudaSuccess)
    return e;
  ffn_tc::product(p, 0, dx, T, d, ffn);
  return ffn_tc::sliced<Tag, Out, ffn_tc::kKMajor, ffn_tc::kMNMajor>(
      p, part, S, L, U, sms, st);
}

}  // namespace

extern "C" {

// x, dy [T, d], w1 [ffn, d], w2 [d, ffn] -> dx [T, d], all f32 (mode 0:
// the CUDA-core passes). The f32 scratch pieces, each 16-byte aligned
// (T4, d4, ffn4: T, d and ffn rounded up to 4): xT, dyT [d][T4]; w1T,
// w2c [d][ffn4]; w1c [ffn][d4]; dhT [ffn][T4]; part [S][T][d] (unused
// when S is 1). S slices of L ffn rows (S = ceil(ffn / L)). mode must be
// 0: modes 1 and 2 are ffn_bwd_dx_tc_launch's. Returns a cudaError_t as
// int; 0 on success.
int ffn_bwd_dx_launch(const void* x, const void* dy, const void* w1,
                      const void* w2, void* dx, float* xT, float* dyT,
                      float* w1T, float* w2c, float* w1c, float* dhT,
                      float* part, int T, int d, int ffn, int S, int L,
                      int mode, void* stream) {
  if (T < 1 || d < 1 || ffn < 1 || !ffn_gemm::covers(ffn, S, L) ||
      mode != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(dx), xT, dyT, w1T, w2c, w1c, dhT, part, T, d, ffn,
      S, L, static_cast<cudaStream_t>(stream)));
}

// The tensor-core passes, mode 1 (x, dy, w1, w2 and dx f32, the operands
// rounded to bf16) or 2 (all bf16). The scratch pieces, each 16-byte
// aligned (d8, ffn8: d and ffn rounded up to 8): the staged bf16 copies
// xs, dys [T][d8], w1s [ffn][d8], w2s [d][ffn8] (mode 1: all four; mode
// 2: null for an operand TMA reads in place, which needs a 16-byte
// aligned base and rows a multiple of 8 elements); dh bf16 [T][ffn8];
// part, f32 [S][tiles - U][128][256] (unused when S is 1). Pass 2's plan:
// dx's 128 x 256 tiles, [0, U) over all ffn rows, the others over S
// slices of L (S = ceil(ffn / L), L a multiple of 64; S 1: every tile
// whole). The passes are persistent, on up to sms blocks (the card's
// SMs). Returns a cudaError_t as int; 0 on success.
int ffn_bwd_dx_tc_launch(const void* x, const void* dy, const void* w1,
                         const void* w2, void* dx, void* xs, void* dys,
                         void* w1s, void* w2s, void* dh, float* part, int T,
                         int d, int ffn, int S, int L, int U, int mode,
                         int sms, void* stream) {
  const int all = ffn_tc::tiles(T, ffn_tc::kBM) * ffn_tc::tiles(d, ffn_tc::kBN);
  if (T < 1 || d < 1 || ffn < 1 || !ffn_tc::plan_ok(ffn, all, S, L, U) ||
      (mode != 1 && mode != 2) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf *xb = static_cast<bf*>(xs), *dyb = static_cast<bf*>(dys),
     *w1b = static_cast<bf*>(w1s), *w2b = static_cast<bf*>(w2s),
     *dhb = static_cast<bf*>(dh);
  if (mode == 2)
    return static_cast<int>(launch_tc(
        static_cast<const bf*>(x), static_cast<const bf*>(dy),
        static_cast<const bf*>(w1), static_cast<const bf*>(w2),
        static_cast<bf*>(dx), xb, dyb, w1b, w2b, dhb, part, T, d, ffn, S, L,
        U, sms, st));
  return static_cast<int>(launch_tc(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(dx), xb, dyb, w1b, w2b, dhb, part, T, d, ffn, S, L,
      U, sms, st));
}

}  // extern "C"
