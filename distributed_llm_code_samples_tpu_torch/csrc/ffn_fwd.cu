// FFN forward for Hopper (sm_90a): y = relu(x w1^T) w2^T.
//
// Replaces the TPU kernel `ffn_fwd_pallas` (body `_fwd_kernel`) in
// distributed_llm_code_samples_tpu/ops/pallas_ffn.py. It computes the
// same function, relu as where(h <= 0, 0, h) (NaN passes). With
// mxu_bf16, x, w1 and w2 are rounded to bf16 and so is a = relu(h)
// (pallas_ffn.py:117-122); sums are f32 either way. On bf16 storage the
// operands are bf16 already, a is rounded to bf16 and y is stored in bf16,
// rounded once from its f32 sum (pallas_ffn.py:119-126).
//
// What bounds it: operations. 4*T*d*ffn flops against T*d + 2*d*ffn + T*d
// floats moved; at the main shape (T 8192, d 768, ffn 3072) 77 GFLOP over
// 69 MB: 1.15 ms at the f32 FMA rate of 67 TFLOP/s (mode 0), some 1100
// flops a byte, far above the ~20 an H100 needs in f32 before arithmetic
// is the limit (67 TFLOP/s over 3.35 TB/s).
//
// Mode 0 (f32) runs two products on the f32 GEMM core of gemm_core.cuh
// (a 128 x 128 tile a block of 256 threads, 8 x 8 sums a thread, a
// 3-deep ring of 16-byte cp.async; two blocks an SM), in the passes of
// ffn_gemm.cuh. The Pallas kernel keeps a [256, d] f32 accumulator and
// its [256, 512] hidden tile in VMEM and never writes the hidden
// activation out. A Hopper block cannot hold a [128 x d] accumulator in
// registers at d 768, and fusing both products on 128 x 128 tiles would
// recompute h once per 128-column band of y. So the hidden activation
// goes to device memory once, as a^T: 2 x 4 x T x ffn bytes written and
// read, 0.2 GB or about 0.06 ms at 3.35 TB/s at the main shape, 5% of the
// bound.
//   prep: x copied as [d][T4], w1 as [d][ffn4], w2 as [ffn][d4] (T4, d4,
//     ffn4: rounded up to 4; zero padded);
//   pass 1: a^T [ffn][T4] = relu(w1 x^T), a 128 ffn x 128 token tile a
//     block (1536 blocks, 5.8 waves of 264 slots at the main shape),
//     computed transposed so that its rows are pass 2's [K][M] operand;
//   pass 2: y = a w2^T with ffn as the depth, a 128 x 128 tile of
//     [T, d] a block. The ffn axis splits into S slices, each summed in
//     order into [S][T][d] partials, only where the output's tiles would
//     not fill one wave of block slots (ops/fused_ffn.py's out_plan): at
//     the main shape its 64 x 6 tiles run unsplit, 1.45 waves of 264
//     slots, which chip_smoke.py's ffn-*-slices sweep found fastest on an
//     H100 (the partials and their reduce cost more than the last wave);
//   reduce (only when S > 1): each y element the sum of its S partials
//     in slice order.
//
// Modes 1 and 2 run on the tensor cores, the passes of ffn_wgmma.cuh:
// wgmma m64n256k16 on bf16 tiles that TMA brings into a ring, a
// 128 x 256 tile a block, two consumer warpgroups and a producer warp.
// Against the bound (77 GFLOP, 0.078 ms at the bf16 tensor-core rate of
// 989 TFLOP/s): no f32 copies of the operands (mode 2 reads x, w1 and
// w2 where they lie; mode 1 rounds them into a bf16 copy first), and a
// crosses device memory once as bf16 (2 x 2 x T x ffn bytes, 0.1 GB at
// the main shape).
//   pass 1: h = x w1^T (both K-major), a = relu(h) out as bf16 [T][ffn8]
//     (an h near zero summed again, as the backward kernels' pass 1 sums
//     it, so a has the bits ffn_bwd_dw's pass 1 stores); no second
//     product;
//   pass 2: y = a w2^T, a K-major and w2 [d][ffn] a K-major B, ffn the
//     depth; the tiles that fill whole rounds of the SMs run over all of
//     ffn, the rest in slices where they would leave a round part idle
//     (fused_ffn.py's tc_fwd_plan), their f32 partials summed in slice
//     order; y rounded once (mode 2) or stored f32 (mode 1).
// No atomics either way: two calls give the same bits. Ragged T, d and
// ffn are masked in the loads (zero past the edge) and the stores.
//
// Plain C interface, bound with ctypes: the caller allocates y and every
// scratch piece (ops/fused_ffn.py's fwd_scratch and tc_fwd_scratch have
// their sizes), passes the stream, and gets the first CUDA error back.

#include "ffn_wgmma.cuh"

namespace {

using ffn_gemm::fwd;
using gemm::up4;
using bf = __nv_bfloat16;

cudaError_t launch(const float* x, const float* w1, const float* w2,
                   float* y, float* xT, float* w1T, float* w2T, float* aT,
                   float* part, int T, int d, int ffn, int S, int L,
                   cudaStream_t st) {
  const int T4 = static_cast<int>(up4(T)), d4 = static_cast<int>(up4(d)),
            f4 = static_cast<int>(up4(ffn));
  gemm::prep<fwd>(x, T, d, nullptr, 0, xT, T4, false, st);
  gemm::prep<fwd>(w1, ffn, d, nullptr, 0, w1T, f4, false, st);
  gemm::prep<fwd>(w2, d, ffn, nullptr, 0, w2T, d4, false, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // a^T = relu(w1 x^T), [ffn][T4]
  e = ffn_gemm::hidden<fwd, ffn_gemm::kStoreA, false>(
      ffn_gemm::Hidden{gemm::Operands{w1T, xT, f4, T4, f4, T4}, {}, aT,
                       nullptr, ffn, T4, 0, d},
      st);
  if (e != cudaSuccess) return e;
  return ffn_gemm::sliced<fwd, float>(
      ffn_gemm::product(aT, T4, T4, w2T, d4, d4, T, d),   // y = a w2^T
      ffn_gemm::Product{}, y, nullptr, part, nullptr, ffn, S, L, st);
}

// Modes 1 and 2: Elem the storage (f32 rounded into the staged copies,
// or bf16), Out the output's.
template <typename Elem, typename Out>
cudaError_t launch_tc(const Elem* x, const Elem* w1, const Elem* w2, Out* y,
                      bf* xs, bf* w1s, bf* w2s, bf* a, float* part, int T,
                      int d, int ffn, int S, int L, int U, int sms,
                      cudaStream_t st) {
  ffn_tc::Operand xo, w1o, w2o;
  cudaError_t e;
  if ((e = ffn_tc::bind_device(x)) != cudaSuccess ||
      (e = ffn_tc::operand<fwd>(x, T, d, xs, st, &xo)) != cudaSuccess ||
      (e = ffn_tc::operand<fwd>(w1, ffn, d, w1s, st, &w1o)) != cudaSuccess ||
      (e = ffn_tc::operand<fwd>(w2, d, ffn, w2s, st, &w2o)) != cudaSuccess)
    return e;
  // a = relu(h): bf16 [T][ffn8]
  if ((e = ffn_tc::hidden<fwd, true, false>(xo, w1o, ffn_tc::Operand{},
                                            ffn_tc::Operand{}, a, nullptr,
                                            T, d, ffn, sms, st)) !=
      cudaSuccess)
    return e;
  ffn_tc::SliceParams p{};
  // y [T][d] = a w2^T: a K-major, w2 [d][ffn] K-major, ffn the depth
  if ((e = ffn_tc::tensor_map(&p.a[0], a, T, ffn, ffn_tc::up8(ffn),
                              ffn_tc::kBM)) != cudaSuccess ||
      (e = ffn_tc::tensor_map(&p.b[0], w2o.p, d, ffn, w2o.ld,
                              ffn_tc::kBN)) != cudaSuccess)
    return e;
  ffn_tc::product(p, 0, y, T, d, ffn);
  return ffn_tc::sliced<fwd, Out, ffn_tc::kKMajor, ffn_tc::kKMajor>(
      p, part, S, L, U, sms, st);
}

}  // namespace

extern "C" {

// x [T, d], w1 [ffn, d], w2 [d, ffn] -> y [T, d], all f32 (mode 0: the
// CUDA-core passes). The f32 scratch pieces, each 16-byte aligned (T4,
// d4, ffn4: T, d and ffn rounded up to 4): xT [d][T4]; w1T [d][ffn4]; w2T
// [ffn][d4]; aT [ffn][T4]; part [S][T][d] (unused when S is 1). S slices
// of L ffn columns (S = ceil(ffn / L)). mode must be 0: modes 1 and 2 are
// ffn_fwd_tc_launch's. Returns a cudaError_t as int; 0 on success.
int ffn_fwd_launch(const void* x, const void* w1, const void* w2, void* y,
                   float* xT, float* w1T, float* w2T, float* aT, float* part,
                   int T, int d, int ffn, int S, int L, int mode,
                   void* stream) {
  if (T < 1 || d < 1 || ffn < 1 || !ffn_gemm::covers(ffn, S, L) ||
      mode != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<float*>(y), xT, w1T, w2T,
      aT, part, T, d, ffn, S, L, static_cast<cudaStream_t>(stream)));
}

// The tensor-core passes, mode 1 (x, w1, w2 and y f32, the operands
// rounded to bf16) or 2 (all bf16). The scratch pieces, each 16-byte
// aligned (d8, ffn8: d and ffn rounded up to 8): the staged bf16 copies
// xs [T][d8], w1s [ffn][d8], w2s [d][ffn8] (mode 1: all three; mode 2:
// null for an operand TMA reads in place, which needs a 16-byte aligned
// base and rows a multiple of 8 elements); a bf16 [T][ffn8]; part, f32
// [S][tiles - U][128][256] (unused when S is 1). Pass 2's plan: y's
// 128 x 256 tiles, [0, U) over all ffn columns, the others over S slices
// of L (S = ceil(ffn / L), L a multiple of 64; S 1: every tile whole).
// The passes are persistent, on up to sms blocks (the card's SMs).
// Returns a cudaError_t as int; 0 on success.
int ffn_fwd_tc_launch(const void* x, const void* w1, const void* w2,
                      void* y, void* xs, void* w1s, void* w2s, void* a,
                      float* part, int T, int d, int ffn, int S, int L,
                      int U, int mode, int sms, void* stream) {
  const int all = ffn_tc::tiles(T, ffn_tc::kBM) * ffn_tc::tiles(d, ffn_tc::kBN);
  if (T < 1 || d < 1 || ffn < 1 || !ffn_tc::plan_ok(ffn, all, S, L, U) ||
      (mode != 1 && mode != 2) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf *xb = static_cast<bf*>(xs), *w1b = static_cast<bf*>(w1s),
     *w2b = static_cast<bf*>(w2s), *ab = static_cast<bf*>(a);
  if (mode == 2)
    return static_cast<int>(launch_tc(
        static_cast<const bf*>(x), static_cast<const bf*>(w1),
        static_cast<const bf*>(w2), static_cast<bf*>(y), xb, w1b, w2b, ab,
        part, T, d, ffn, S, L, U, sms, st));
  return static_cast<int>(launch_tc(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<float*>(y), xb, w1b, w2b,
      ab, part, T, d, ffn, S, L, U, sms, st));
}

}  // extern "C"
