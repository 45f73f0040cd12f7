// Paged decode attention for Hopper (sm_90a): single-query attention of
// every (slot, KV head) straight from the paged KV pool, the KV walk split
// across blocks ("flash decoding").
//
// Replaces the TPU kernel `paged_decode_attn` in
// distributed_llm_code_samples_tpu/ops/pallas_paged_attention.py
// (`_walk_kernel`, `_walk_kernel_q8`, body `_tile`). It computes the same
// function: for slot i and query head hq = h*G + g,
//   s[t] = (q[i, hq] . k[table[i, t/blk], h, t%blk]) / sqrt(dh)   t < len[i]
//   s[t] = -1e30                                                   t >= len[i]
//   y[i, hq] = sum_t softmax(s)[t] * v[table[i, t/blk], h, t%blk]
// with bf16 widened by __bfloat162float and int8 widened to f32 and
// multiplied by its block's scale (k_scale[table[i, j], h]), then the dot,
// then the divide by sqrt(dh): the order of the TPU kernel's `_tile`.
// Compute and output are f32.
//
// What bounds it: the bytes it reads. A decode step does 2 flops per KV
// element it loads, far below the ~20 flop/byte an H100 needs (67 TFLOP/s
// f32 over 3.35 TB/s) before arithmetic is the limit, so the least time
// is (live KV bytes at the storage type + int8 scales + q + y) / 3.35 TB/s:
// 2.5 us at the serving shape (8 slots, 12 heads, dh 64, 8.3 MB of live
// f32 KV). At that size what a kernel can lose is latency, not bandwidth:
// the first design (one block a (slot, head), a warp a position, the K row
// loaded behind its table entry) ran some 80 dependent HBM round trips a
// warp, 0.09 ms on an NVIDIA H100 80GB HBM3.
//
// Design: one block of kThreads a (slot i, KV head h, split s), where a
// split is `pos` consecutive positions, a whole number of paged blocks
// (ops/paged_attention.py split_plan fixes pos and the number of splits
// from the shapes alone: the lengths never go back to the host). The grid
// is split-major, so every slot-head's first splits are scheduled first;
// a block whose split starts at or past len[i] exits after its first
// round trip. Three round trips to device memory:
//   1. len[i], the split's table entries and the G query rows, all
//      issued together;
//   2. every K and V row of the split's live paged blocks (each block's
//      [blk, dh] head tile is contiguous in the pool), all issued before
//      anything waits: 16-byte cp.async into shared memory at the
//      storage type (plain loads when a tile is not 16-byte aligned),
//      with the int8 scales;
//   3. the merge: the split's (m, l, acc) go to a workspace, and the last
//      of the slot-head's live splits to finish (an acquire-release
//      atomic counter in the workspace, which that block resets to 0, so
//      no memset a call) merges them in split order, in registers at
//      the serving shapes (merge_splits):
//        m = max_s m_s,  l = sum_s l_s exp(m_s - m),
//        y = (sum_s acc_s exp(m_s - m)) / l,
//      so repeats are bit-identical whatever order the blocks ran in. A
//      slot whose length fits one split writes y itself (the same bits:
//      exp(0) = 1).
// Within a split: the G score rows s = (q . k) / sqrt(dh) from shared
// memory, four elements a load, a rotated start so a warp's loads fall
// in distinct banks; per row m = max s, p = exp(s - m), l = sum p (a warp
// a row); acc = sum_t p v, one thread a (row, d). Where G x live or G x dh
// would leave half the block idle, two lanes share an output and add by
// a shuffle. The G query heads of a KV head share its K/V tile. Sums run
// in another order than the plain version's softmax-then-PV, so the two
// agree to f32 rounding, not bit for bit. Shared memory grows with the
// split, not with the table (split_plan gives its bytes; only the merge's
// 2 x splits x G floats follow the table's length).
//
// Plain C interface, bound with ctypes: the caller allocates `y` and the
// workspace (counters zeroed once), passes the stream, and gets
// cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;             // decode_attn's mask value
constexpr size_t kMaxSmem = 232448;         // 227 KB a block may use on sm_90

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float widen<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// Four consecutive elements of a shared tile, widened (p 4-element
// aligned: 16 bytes of f32, 8 of bf16, 4 of int8).
template <typename T>
__device__ __forceinline__ float4 widen4(const T* p);
template <>
__device__ __forceinline__ float4 widen4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 widen4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <>
__device__ __forceinline__ float4 widen4<int8_t>(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// atomicAdd with acquire-release semantics at device scope.
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of one block, in this order: the K and V tiles [pos, dh]
// at the storage type (16-byte aligned), then f32 q [G, dh], scores
// [G, pos], (m, l) [2, G], the merge's (m_s, l_s) then weights
// [2, splits, G] and merged l [G], the split's k and v scales
// [2, pos / blk]; then int32 table entries [pos / blk] and one flag.
struct Smem {
  int g, dh, pos, bps, splits;
  size_t tile_bytes;
  __host__ __device__ Smem(int g_, int dh_, int pos_, int blk, int splits_,
                           int itemsize)
      : g(g_), dh(dh_), pos(pos_), bps(pos_ / blk), splits(splits_),
        tile_bytes(round16(static_cast<size_t>(pos_) * dh_ * itemsize)) {}
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(g) * dh + static_cast<size_t>(g) * pos +
           2 * g + 2 * static_cast<size_t>(splits) * g + g + 2 * bps;
  }
  __host__ __device__ size_t bytes() const {
    return 2 * tile_bytes + 4 * (floats() + bps + 1);
  }
};

struct Args {
  const float* q;
  const void* pool_k;
  const void* pool_v;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  float* y;
  float* part;           // [b * hkv, splits, G * dh + 2G]: acc, m, l
  unsigned* counters;    // [b * hkv], 0 between calls
  int hq, hkv, blk, dh, mb, pos, splits;
  int vec;               // 16-byte cp.async of the tiles
};

constexpr int kInRegs = 6;   // splits a register merge takes

// The merge of slot-head ih's `live` splits, in split order, into y:
//   m = max_s m_s,  l = sum_s l_s exp(m_s - m),
//   y = (sum_s acc_s exp(m_s - m)) / l.
// Partials were written by other blocks: loads bypass L1. With at most
// kInRegs splits and an output a thread (the serving shapes) each thread
// loads its output's (m_s, l_s, acc_s) in one round trip and merges in
// registers, with no barrier; else the weights go through shared memory
// (mrg: 2 * splits * G floats, lsum: G floats), one thread a row. Both
// add the same terms in the same order.
__device__ void merge_splits(const Args& a, int ih, int live, int g_n,
                             float* mrg, float* lsum, float* y) {
  const int per = g_n * a.dh + 2 * g_n;
  const float* base = a.part + static_cast<size_t>(ih) * a.splits * per;
  const float* stat = base + g_n * a.dh;     // + s * per: m [G], l [G]
  if (live <= kInRegs && g_n * a.dh <= kThreads) {
    const int e = threadIdx.x;
    if (e >= g_n * a.dh) return;
    const int g = e / a.dh;
    float mv[kInRegs], lv[kInRegs], av[kInRegs];
#pragma unroll
    for (int s = 0; s < kInRegs; ++s) {
      if (s < live) {
        const size_t o = static_cast<size_t>(s) * per;
        mv[s] = __ldcg(stat + o + g);
        lv[s] = __ldcg(stat + o + g_n + g);
        av[s] = __ldcg(base + o + e);
      }
    }
    float m = kNeg;
#pragma unroll
    for (int s = 0; s < kInRegs; ++s)
      if (s < live) m = fmaxf(m, mv[s]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int s = 0; s < kInRegs; ++s) {
      if (s < live) {
        const float w = expf(mv[s] - m);
        l += lv[s] * w;
        acc += av[s] * w;
      }
    }
    y[e] = acc / l;
    return;
  }
  float* ms = mrg;                      // [live, G]: m_s, then the weights
  float* ls = mrg + a.splits * g_n;     // [live, G]: l_s
  for (int e = threadIdx.x; e < live * g_n; e += kThreads) {
    const size_t o = static_cast<size_t>(e / g_n) * per + e % g_n;
    ms[e] = __ldcg(stat + o);
    ls[e] = __ldcg(stat + o + g_n);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < g_n; g += kThreads) {
    float m = kNeg;
    for (int s = 0; s < live; ++s) m = fmaxf(m, ms[s * g_n + g]);
    float l = 0.f;
    for (int s = 0; s < live; ++s) {
      const float w = expf(ms[s * g_n + g] - m);
      ms[s * g_n + g] = w;
      l += ls[s * g_n + g] * w;
    }
    lsum[g] = l;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g_n * a.dh; e += kThreads) {
    const int g = e / a.dh;
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s)
      acc += __ldcg(base + static_cast<size_t>(s) * per + e) * ms[s * g_n + g];
    y[e] = acc / lsum[g];
  }
}

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(Args a) {
  // split-major: every slot-head's split 0 first, the splits that start
  // past most lengths (and exit at once) last
  const int nih = static_cast<int>(gridDim.x) / a.splits;   // b * hkv
  const int s = static_cast<int>(blockIdx.x) / nih;
  const int ih = static_cast<int>(blockIdx.x) % nih;        // i * hkv + h
  const int i = ih / a.hkv, h = ih % a.hkv;
  const int g_n = a.hq / a.hkv, dh = a.dh, blk = a.blk, pos = a.pos;
  const int tcap = a.mb * blk;
  const Smem lay(g_n, dh, pos, blk, a.splits, sizeof(T));
  const int bps = lay.bps;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + lay.tile_bytes);
  float* q_s = reinterpret_cast<float*>(smem + 2 * lay.tile_bytes);
  float* s_s = q_s + g_n * dh;          // [G, pos]
  float* m_s = s_s + g_n * pos;         // [G]
  float* l_s = m_s + g_n;               // [G]
  float* mrg_s = l_s + g_n;             // [2, splits, G]
  float* lsum_s = mrg_s + 2 * a.splits * g_n;   // [G]
  float* ksc_s = lsum_s + g_n;          // [bps]
  float* vsc_s = ksc_s + bps;           // [bps]
  int* tab_s = reinterpret_cast<int*>(vsc_s + bps);
  int* flag_s = tab_s + bps;

  // round trip 1: the length, the split's table entries, q
  const size_t qy_off = (static_cast<size_t>(i) * a.hq + h * g_n) * dh;
  for (int e = threadIdx.x; e < bps; e += kThreads)
    tab_s[e] = a.tables[static_cast<size_t>(i) * a.mb +
                        min(s * bps + e, a.mb - 1)];
  for (int e = threadIdx.x; e < g_n * dh; e += kThreads)
    q_s[e] = a.q[qy_off + e];
  // callers guarantee 1 <= len <= tcap; clamped so y is always written
  const int len = max(1, min(a.lengths[i], tcap));
  __syncthreads();
  const int t0 = s * pos;
  if (t0 >= len) return;
  const int live = min(pos, len - t0);               // live positions
  const int nblk = (live + blk - 1) / blk;           // live paged blocks
  const int nsplit = (len + pos - 1) / pos;          // live splits

  // round trip 2: every K and V row of the live blocks, then the scales
  const size_t tile = static_cast<size_t>(blk) * dh;   // elements a block
  if (a.vec) {
    const int per16 = static_cast<int>(tile * sizeof(T) / 16);
    const int n16 = nblk * per16;
    const char* pk = static_cast<const char*>(a.pool_k);
    const char* pv = static_cast<const char*>(a.pool_v);
    for (int e = threadIdx.x; e < 2 * n16; e += kThreads) {
      const bool is_v = e >= n16;
      const int r = is_v ? e - n16 : e;
      const int jb = r / per16, off = r % per16;
      const size_t src = ((static_cast<size_t>(tab_s[jb]) * a.hkv + h) *
                              tile * sizeof(T)) +
                         static_cast<size_t>(off) * 16;
      unsigned char* dst = (is_v ? reinterpret_cast<unsigned char*>(v_s)
                                 : reinterpret_cast<unsigned char*>(k_s)) +
                           (static_cast<size_t>(jb) * per16 + off) * 16;
      cp_async16(dst, (is_v ? pv : pk) + src);
    }
  } else {
    const T* pk = static_cast<const T*>(a.pool_k);
    const T* pv = static_cast<const T*>(a.pool_v);
    const int n = nblk * static_cast<int>(tile);
    for (int e = threadIdx.x; e < 2 * n; e += kThreads) {
      const bool is_v = e >= n;
      const int r = is_v ? e - n : e;
      const int jb = r / static_cast<int>(tile);
      const size_t src = (static_cast<size_t>(tab_s[jb]) * a.hkv + h) * tile +
                         r % static_cast<int>(tile);
      (is_v ? v_s : k_s)[r] = (is_v ? pv : pk)[src];
    }
  }
  if (kScaled) {
    for (int e = threadIdx.x; e < nblk; e += kThreads) {
      const size_t at = static_cast<size_t>(tab_s[e]) * a.hkv + h;
      ksc_s[e] = a.k_scale[at];
      vsc_s[e] = a.v_scale[at];
    }
  }
  if (a.vec) cp_async_wait_all();
  __syncthreads();

  // scores: s = (q . k) / sqrt(dh). With dh a multiple of 4: four
  // elements a load and four partial sums (added pairwise), one thread a
  // (row g, position t), or two lanes, a half of dh each (added by a
  // shuffle), when that still leaves lanes idle and dh is a multiple of
  // 8; each starts at a rotated pack (nh t + half) so a quarter-warp's
  // 16-byte shared loads fall in distinct banks. Else one thread a
  // (g, t), one element a load from a rotated start.
  const float root_dh = sqrtf(static_cast<float>(dh));
  if (dh % 4 == 0) {
    const int nh = dh % 8 == 0 && 2 * g_n * live <= kThreads ? 2 : 1;
    const int half_n = dh / (4 * nh);     // 4-element packs a lane
    const int items = nh * g_n * live;
    for (int base = 0; base < items; base += kThreads) {
      const int e = base + static_cast<int>(threadIdx.x);
      const int half = e % nh, g = (e / nh) / live, t = (e / nh) % live;
      float part = 0.f;
      if (e < items) {
        const T* krow = k_s + static_cast<size_t>(t) * dh + 4 * half * half_n;
        const float* qrow = q_s + g * dh + 4 * half * half_n;
        const float sc = kScaled ? ksc_s[t / blk] : 1.f;
        int p = (nh * t + half) % half_n;
        float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int k = 0; k < half_n; ++k) {
          float4 kv = widen4<T>(krow + 4 * p);
          if (kScaled) {
            kv.x *= sc;
            kv.y *= sc;
            kv.z *= sc;
            kv.w *= sc;
          }
          const float4 qv = *reinterpret_cast<const float4*>(qrow + 4 * p);
          a4.x += qv.x * kv.x;
          a4.y += qv.y * kv.y;
          a4.z += qv.z * kv.z;
          a4.w += qv.w * kv.w;
          p = p + 1 == half_n ? 0 : p + 1;
        }
        part = (a4.x + a4.y) + (a4.z + a4.w);
      }
      if (nh == 2) part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (e < items && half == 0) s_s[g * pos + t] = part / root_dh;
    }
  } else {
    for (int e = threadIdx.x; e < g_n * live; e += kThreads) {
      const int g = e / live, t = e % live;
      const T* krow = k_s + static_cast<size_t>(t) * dh;
      const float* qrow = q_s + g * dh;
      const float sc = kScaled ? ksc_s[t / blk] : 1.f;
      float acc = 0.f;
      int d = t % dh;
#pragma unroll 8
      for (int k = 0; k < dh; ++k) {
        float kv = widen<T>(krow[d]);
        if (kScaled) kv *= sc;
        acc += qrow[d] * kv;
        d = d + 1 == dh ? 0 : d + 1;
      }
      s_s[g * pos + t] = acc / root_dh;
    }
  }
  __syncthreads();

  // per row: m = max s, p = exp(s - m) in place, l = sum p (a warp a row)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < g_n; g += kWarps) {
    float* row = s_s + g * pos;
    float m = kNeg;
    for (int t = lane; t < live; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < live; t += 32) {
      const float p = expf(row[t] - m);
      row[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  __syncthreads();

  // acc = sum_t p v over the live positions, four partial sums over the
  // positions added pairwise at the end: one thread a (row g, d), or,
  // when G * dh is at most half the block, two, lanes l and l + 16 of a
  // warp over the even and the odd positions, added by a shuffle. A slot
  // of one split divides and writes y, else the split's partial.
  const int per = g_n * dh + 2 * g_n;
  float* part = a.part + (static_cast<size_t>(ih) * a.splits + s) * per;
  auto pv_sum = [&](int g, int d, int t, int step) {
    const float* p = s_s + g * pos;
    auto pv = [&](int u) {
      float vv = widen<T>(v_s[static_cast<size_t>(u) * dh + d]);
      if (kScaled) vv *= vsc_s[u / blk];
      return p[u] * vv;
    };
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 2
    for (; t + 3 * step < live; t += 4 * step) {
      a0 += pv(t);
      a1 += pv(t + step);
      a2 += pv(t + 2 * step);
      a3 += pv(t + 3 * step);
    }
    for (; t < live; t += step) a0 += pv(t);
    return (a0 + a1) + (a2 + a3);
  };
  auto put = [&](int o, float acc) {
    if (nsplit == 1)
      a.y[qy_off + o] = acc / l_s[o / dh];
    else
      part[o] = acc;
  };
  if (2 * g_n * dh <= kThreads && (g_n * dh) % 16 == 0) {
    const int o = (threadIdx.x >> 5) * 16 + (lane & 15), half = lane >> 4;
    float acc = o < g_n * dh ? pv_sum(o / dh, o % dh, half, 2) : 0.f;
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    if (o < g_n * dh && half == 0) put(o, acc);
  } else {
    for (int o = threadIdx.x; o < g_n * dh; o += kThreads)
      put(o, pv_sum(o / dh, o % dh, 0, 1));
  }
  if (nsplit == 1) return;
  for (int g = threadIdx.x; g < g_n; g += kThreads) {
    part[g_n * dh + g] = m_s[g];
    part[g_n * dh + g_n + g] = l_s[g];
  }

  // the last of the live splits to finish merges and resets the counter:
  // the barrier orders the block's partial stores before thread 0's
  // acquire-release add, which publishes them and, in the last block,
  // sees every other split's (no fence for each thread)
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned done = add_acq_rel(a.counters + ih, 1u);
    *flag_s = done == static_cast<unsigned>(nsplit - 1);
    if (*flag_s) a.counters[ih] = 0u;
  }
  __syncthreads();
  if (!*flag_s) return;
  merge_splits(a, ih, nsplit, g_n, mrg_s, lsum_s, a.y + qy_off);
}

template <typename T, bool kScaled>
cudaError_t launch(const Args& a, int b, size_t smem, cudaStream_t stream) {
  void (*kern)(Args) = paged_split_kernel<T, kScaled>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = static_cast<unsigned>(b) * a.hkv * a.splits;
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int itemsize(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 1; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the split kernel needs
// (ops/paged_attention.py split_plan computes the same).
size_t paged_decode_attn_smem_bytes(int g, int dh, int pos, int blk,
                                    int splits, int dtype) {
  return Smem(g, dh, pos, blk, splits, itemsize(dtype)).bytes();
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 (k_scale/v_scale [n_blocks, H_kv]).
// pos, splits: the plan (pos a multiple of blk, splits * pos >= mb * blk
// > (splits - 1) * pos). part: b * hkv * splits * (G * dh + 2G) floats;
// counters: b * hkv words, zero. vec: the pools 16-byte aligned and
// blk * dh * itemsize a multiple of 16. Returns a cudaError_t as int; 0
// on success.
int paged_decode_attn_launch(const float* q, const void* pool_k,
                             const void* pool_v, const float* k_scale,
                             const float* v_scale, const int* tables,
                             const int* lengths, float* y, float* part,
                             unsigned* counters, int b, int hq, int hkv,
                             int blk, int dh, int mb, int pos, int splits,
                             int dtype, int vec, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || blk < 1 || dh < 1 || mb < 1 ||
      pos < blk || pos % blk != 0 || splits < 1 ||
      static_cast<long long>(splits) * pos < static_cast<long long>(mb) * blk ||
      static_cast<long long>(splits - 1) * pos >=
          static_cast<long long>(mb) * blk ||
      dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = paged_decode_attn_smem_bytes(hq / hkv, dh, pos, blk,
                                                   splits, dtype);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (static_cast<size_t>(blk) * dh * itemsize(dtype)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {q,     pool_k, pool_v, k_scale, v_scale, tables, lengths,
                  y,     part,   counters, hq,    hkv,     blk,    dh,
                  mb,    pos,    splits, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch<float, false>(a, b, smem, st);
      break;
    case 1:
      e = launch<__nv_bfloat16, false>(a, b, smem, st);
      break;
    default:
      if (k_scale == nullptr || v_scale == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      e = launch<int8_t, true>(a, b, smem, st);
      break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
