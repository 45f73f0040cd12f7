// The tensor-core machinery the bf16 passes of the port's kernels share
// on Hopper (sm_90a): the PTX of TMA, mbarriers and wgmma, shared-memory
// descriptors of 128-byte swizzled tiles, the producer / consumer ring of
// a 128 x 256 tile a block (two consumer warpgroups of 64 rows and one
// producer warp), the epilogue stores of a warpgroup's accumulators, the
// bf16 staging copy, and the host's tensor maps. Used by the FFN passes
// (ffn_wgmma.cuh), the fused head's statistics and backward
// (head_xent_fwd.cu, head_xent_bwd.cu) and the flash forward on bf16
// storage (flash_attn_fwd.cu).
//
// Products are bf16 x bf16 -> f32 on wgmma.mma_async: m64n256k16 with
// both operands in shared memory (the ring's tiles), and m64n64k16 with A
// in shared memory or in registers. An operand tile is K-major (a
// [rows][K] array: one box of 64 K x rows) or MN-major (a [K][cols]
// array: boxes of 64 columns x 64 K rows, read through wgmma's transpose
// bit), 128-byte swizzled as TMA lays it. TMA zero-fills loads past an
// array's edge and clips its stores there. The tensor maps come from
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint at run
// time, so nothing links -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;   // output rows a block: two warpgroups of 64
constexpr int kBN = 256;   // output columns a block: one m64n256k16
constexpr int kBK = 64;    // depth a stage: one 128-byte swizzled row
constexpr int kStages = 4;         // pass 2's ring
constexpr int kHiddenStages = 3;   // pass 1's, beside its store buffers
constexpr int kThreads = 384;
constexpr int kABytes = kBM * kBK * 2;      // 16 KB
constexpr int kBBytes = kBN * kBK * 2;      // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBox = 64 * kBK * 2;          // one MN-major box, 8 KB
// pass 1 stores each warpgroup's 64 x 256 bf16 outputs through a buffer
// of four 64 x 64 boxes, 128-byte swizzled, by TMA
constexpr int kOutBytes = 64 * kBN * 2;     // 32 KB a warpgroup
// the ring (and pass 1's store buffers), and room to align it to the
// 1024 bytes of a swizzle atom
constexpr size_t kSliceSmem =
    static_cast<size_t>(kStages) * kStageBytes + 1024;
constexpr size_t kHiddenSmem =
    static_cast<size_t>(kHiddenStages) * kStageBytes + 2 * kOutBytes + 1024;
static_assert(kSliceSmem <= 232448 - 2 * kStages * 8 &&
                  kHiddenSmem <= 232448 - 2 * kStages * 8,
              "shared memory over 227 KB");

enum : int { kKMajor = 0, kMNMajor = 1 };

// -- PTX ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at (c0 innermost, c1) into shared memory at dst,
// completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The box of a 3-D `map` at (c0 innermost, c1, c2) into shared memory at
// dst, completing on bar
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// shared memory at src to the box of `map` at (c0, c1); clipped at the
// array's edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's TMA stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until this thread's TMA stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread visible to TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg (named barrier wg + 1)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from touching the accumulators across an
// asynchronous wgmma (they are read after the wait that follows it)
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A wgmma shared-memory descriptor of a 128-byte swizzled tile:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// k16 step kk of an operand tile at `tile`. K-major: rows of 128 bytes
// (64 k), 8-row groups 1024 bytes apart, a step 32 bytes along the row.
// MN-major: K rows of 128 bytes (64 of M or N), 8-K-row groups 1024
// bytes apart, 64-column boxes kBox apart, a step 16 K rows down.
template <int kMajor>
__device__ __forceinline__ uint64_t step_desc(uint32_t tile, int kk) {
  return kMajor == kKMajor ? desc(tile + 32 * kk, 16, 1024)
                           : desc(tile + 2048 * kk, kBox, 1024);
}

// d (+)= A B over one k16 step: m64n256k16, bf16 in, f32 sums.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// d (+)= A B over one k16 step: m64n64k16, A and B in shared memory.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// d (+)= A B over one k16 step: m64n64k16, A from registers (a
// warpgroup's 64 x 16 bf16 fragment: thread t holds rows 16 (t / 32) +
// (t % 32) / 4 (+ 8) and columns 2 (t % 4) (+ 1) (+ 8), a[0] row, a[1]
// row + 8, a[2] row at column + 8, a[3] row + 8 at column + 8, two bf16
// a register; the layout of a k16 slice of an m64nN accumulator), B in
// shared memory.
template <int kTB>
__device__ __forceinline__ void wgmma64_rs(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTB));
}

// Orders the compiler's reads and writes of registers that an
// asynchronous wgmma reads or writes: before wg_fence (writes done) and
// after the wait that ends the wgmma (reads not hoisted above it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// -- the pieces of a block ---------------------------------------------------

// One stage's A (kRows 128) or B (256) tile of rows [row0, +kRows) and
// depth [k0, +64): K-major one box, MN-major kRows / 64 boxes.
template <int kMajor, int kRows>
__device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map,
                                     uint32_t bar, int row0, int k0) {
  if (kMajor == kKMajor) {
    tma_load(dst, map, bar, k0, row0);
  } else {
#pragma unroll
    for (int j = 0; j < kRows / 64; ++j)
      tma_load(dst + j * kBox, map, bar, row0 + 64 * j, k0);
  }
}

// The ring: its 1024-byte aligned tiles and its barriers, full (one
// arrival: the producer's, plus the bytes) and empty (one arrival a
// consumer warpgroup), set up by thread 0 before the roles split.
struct Ring {
  uint32_t tiles, full, empty;
  int stages;
  uint8_t* base;   // tiles' generic address
};

__device__ __forceinline__ Ring ring_setup(uint8_t* smem, uint64_t* bars,
                                           int stages) {
  Ring r;
  r.tiles = (smem_u32(smem) + 1023) & ~1023u;
  r.base = smem + (r.tiles - smem_u32(smem));
  r.full = smem_u32(bars);
  r.empty = r.full + 8 * kStages;
  r.stages = stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(r.full + 8 * s, 1);
      bar_init(r.empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer's next stage: wait until it is free, announce its bytes.
// Returns the stage's A tile; B follows at + kABytes.
__device__ __forceinline__ uint32_t produce(const Ring& r, int& stage,
                                            uint32_t& phase, uint32_t& bar) {
  bar_wait(r.empty + 8 * stage, phase ^ 1);
  bar = r.full + 8 * stage;
  bar_expect(bar, kStageBytes);
  const uint32_t a = r.tiles + stage * kStageBytes;
  if (++stage == r.stages) {
    stage = 0;
    phase ^= 1;
  }
  return a;
}

// acc += the next n stages of the ring (warpgroup wg's 64 rows of A),
// one k-tile's four wgmma in flight while the previous one's stage is
// released.
template <int kTA, int kTB>
__device__ __forceinline__ void consume(float (&acc)[128], int n,
                                        const Ring& r, int& stage,
                                        uint32_t& phase, int wg) {
  const bool leader = threadIdx.x % 128 == 0;
  int prev = -1;
  for (int i = 0; i < n; ++i) {
    bar_wait(r.full + 8 * stage, phase);
    const uint32_t a = r.tiles + stage * kStageBytes + wg * (kABytes / 2);
    const uint32_t b = r.tiles + stage * kStageBytes + kABytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma<kTA, kTB>(acc, step_desc<kTA>(a, kk), step_desc<kTB>(b, kk));
    wg_commit();
    wg_wait<1>();
    if (prev >= 0 && leader) bar_arrive(r.empty + 8 * prev);
    prev = stage;
    if (++stage == r.stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  if (leader && prev >= 0) bar_arrive(r.empty + 8 * prev);
}

__device__ __forceinline__ void zero(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
}

// Two neighbouring outputs (c, c + 1) of a row, those below ncols;
// paired where the row keeps pairs aligned (vec).
__device__ __forceinline__ void put2(bf16* row, int c, int ncols, bool vec,
                                     float v0, float v1) {
  if (vec && c + 1 < ncols) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) =
        __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (c < ncols) row[c] = __float2bfloat16_rn(v0);
  if (c + 1 < ncols) row[c + 1] = __float2bfloat16_rn(v1);
}

__device__ __forceinline__ void put2(float* row, int c, int ncols, bool vec,
                                     float v0, float v1) {
  if (vec && c + 1 < ncols) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
    return;
  }
  if (c < ncols) row[c] = v0;
  if (c + 1 < ncols) row[c + 1] = v1;
}

__device__ __forceinline__ float value(const float* p) { return *p; }
__device__ __forceinline__ float value(const bf16* p) {
  return __bfloat162float(*p);
}

// A warpgroup's 64 x 256 accumulators out to rows < rows and columns <
// ncols of out [.][ld], the tile's corner at (m0, n0); with `add`, each
// output is what out holds plus the accumulator, rounded once. Thread t
// of the warpgroup holds rows m0 + 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns n0 + 8 j + 2 (t % 4) (+ 1), j < 32: acc[4 j + 2 h + e] at row
// + 8 h, column + e.
template <typename Out>
__device__ __forceinline__ void store_acc(Out* out, long long ld, int rows,
                                          int ncols, bool vec, bool add,
                                          int m0, int n0,
                                          const float (&acc)[128]) {
  const int t = threadIdx.x % 128;
  const int r = m0 + 16 * (t / 32) + (t % 32) / 4;
  const int c = n0 + 2 * (t % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= rows) continue;
    Out* row = out + static_cast<size_t>(r + 8 * h) * ld;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int cj = c + 8 * j;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (add) {
        if (cj < ncols) v0 = value(row + cj) + v0;
        if (cj + 1 < ncols) v1 = value(row + cj + 1) + v1;
      }
      put2(row, cj, ncols, vec, v0, v1);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}


// A warpgroup's 64 x 256 accumulators as bf16 into its store buffer
// `out`: four boxes of 64 rows x 128 bytes (64 columns), each row's
// 16-byte chunks swizzled as TMA's 128-byte mode lays them. A warp's
// 4-byte writes of one column pair hit 32 distinct banks.
__device__ __forceinline__ uint8_t* staged(uint8_t* out, int row, int col) {
  const int j = col / 8;
  return out + (j / 8) * 8192 + row * 128 + (((j % 8) ^ (row & 7)) << 4) +
         (col % 8) * 2;
}

__device__ __forceinline__ void stage_acc(uint8_t* out,
                                          const float (&acc)[128]) {
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(staged(out, r + 8 * h, c + 8 * j)) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// Warpgroup wg's store buffer out to `map` at (row m, column n0): its
// writes made visible to TMA, then one thread stores the four boxes
// (TMA clips them at the array's edges).
__device__ __forceinline__ void store_staged(const CUtensorMap* map,
                                             uint32_t out, int wg, int m,
                                             int n0) {
  fence_async_smem();
  wg_sync(wg);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int b = 0; b < 4; ++b) tma_store(map, out + b * 8192, n0 + 64 * b, m);
    bulk_commit();
  }
}

// The store buffer free again: the last TMA store has read it.
__device__ __forceinline__ void staged_free(int wg) {
  if (threadIdx.x % 128 == 0) bulk_wait_read();
  wg_sync(wg);
}

__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

// src [R][C] (f32 rounded to bf16, or bf16 copied) -> dst [R][ld] bf16,
// zero in columns [C, ld).
template <typename Tag, typename Src>
__global__ void bf16_prep_kernel(const Src* __restrict__ src, int R, int C,
                                 bf16* __restrict__ dst, int ld) {
  const long long n = static_cast<long long>(R) * ld;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    const long long row = i / ld;
    const int c = static_cast<int>(i - row * ld);
    dst[i] = c < C ? to_bf16(src[row * C + c]) : __float2bfloat16_rn(0.f);
  }
}

// -- host side ---------------------------------------------------------------

__host__ __device__ inline long long up8(long long v) {
  return (v + 7) / 8 * 8;
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded
inline Encode encoder() {
  static const Encode fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                  &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(f)
               : nullptr;
  }();
  return fn;
}

// The caller's thread may hold no current context (a thread of its own,
// or autograd's device thread, which sets its device lazily), and
// cuTensorMapEncodeTiled, a libcuda call, needs one: make current the
// primary context of the device that holds p.
inline cudaError_t bind_device(const void* p) {
  cudaPointerAttributes at{};
  const cudaError_t e = cudaPointerGetAttributes(&at, p);
  return e != cudaSuccess ? e : cudaSetDevice(at.device);
}

// The tensor map of a row-major [rows][cols] bf16 array whose rows are ld
// elements apart, read in 128-byte swizzled boxes of 64 columns x
// box_rows rows; zero past the edges.
inline cudaError_t tensor_map(CUtensorMap* m, const bf16* base, long long rows,
                              long long cols, long long ld, int box_rows) {
  const Encode fn = encoder();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || ld % 8 != 0)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elems[2] = {1, 1};
  const CUresult e = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<bf16*>(base), dims, strides, box, elems,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return e == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a [batch][rows][cols] bf16 array whose rows are ld
// elements apart (batches rows * ld apart), read in 128-byte swizzled
// boxes of 64 columns x box_rows rows of one batch; zero past each
// batch's rows and past cols.
inline cudaError_t tensor_map3(CUtensorMap* m, const bf16* base,
                               long long batch, long long rows,
                               long long cols, long long ld, int box_rows) {
  const Encode fn = encoder();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || ld % 8 != 0)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(rows * ld) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elems[3] = {1, 1, 1};
  const CUresult e = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<bf16*>(base), dims, strides, box, elems,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return e == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 operand [R][C] as TMA reads it: the caller's array (bf16 storage,
// ld = C) or, where `staged` is given, a copy [R][up8(C)] made there
// (f32 rounded to bf16, or bf16 that TMA cannot read in place).
struct Operand {
  const bf16* p;
  long long ld;
};

template <typename Tag, typename Elem>
cudaError_t operand(const Elem* src, int R, int C, bf16* staged,
                    cudaStream_t st, Operand* out) {
  if (staged == nullptr) {
    if (!std::is_same<Elem, bf16>::value) return cudaErrorInvalidValue;
    *out = Operand{reinterpret_cast<const bf16*>(src), C};
    return cudaSuccess;
  }
  const int ld = static_cast<int>(up8(C));
  bf16_prep_kernel<Tag, Elem><<<1024, 256, 0, st>>>(src, R, C, staged, ld);
  *out = Operand{staged, ld};
  return cudaGetLastError();
}

template <typename Kern, typename Params>
cudaError_t launch(Kern kern, int blocks, size_t smem, const Params& p,
                   cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

inline int tiles(long long n, int tile) {
  return static_cast<int>((n + tile - 1) / tile);
}

}  // namespace tc
