// Peer collectives for Hopper (sm_90a) over peer-mapped memory: one ring
// hop, the all-reduce, reduce-scatter and all-gather, and the dense
// all-to-all.
//
// Replaces the TPU kernels of distributed_llm_code_samples_tpu/ops/
// pallas_ring.py: `ppermute_dma` (:151), `ring_all_reduce` (:190;
// ring_all_reduce_kernel below, no longer a ring), `ring_reduce_scatter`
// (:328; ring_reduce_scatter_kernel below, no longer a ring),
// `ring_all_gather` (:406; all_to_all_kernel<true> below, no longer a
// ring) and `all_to_all_dma` (:490; all_to_all_kernel<false>). Every
// kernel computes the same function with the same chunks (the leading-dim
// n-split), and each chunk is summed in the Pallas kernels' order: at
// reduce step s rank r adds its own copy of chunk (v - s - 1) mod n to
// the partial its left neighbour sent (v = r for the all-reduce, r - 1
// for the reduce-scatter, so that rank r owns chunk r). So rank r's chunk
// of the reduce-scatter is
//   x_{r+1}[r] + x_{r+2}[r] + ... + x_{r-1}[r], then + x_r[r],
// and chunk c of the all-reduce is
//   x_c[c] + x_{c+1}[c] + ... + x_{c-1}[c],
// added left to right, the order their receivers sum in.
//
// Every kernel moves 4-byte words: a bf16 tensor (an even number of
// elements a chunk) is passed as the words of its bytes. The all-gather,
// the hop and the all-to-all move them as they are. The all-reduce and
// the reduce-scatter of bf16 (Params::bf16) add the two elements of each
// word in f32 and round each partial sum to bf16 after every add, in the
// same order, as the Pallas kernels' adds on bf16 refs do
// (pallas_ring.py:236, :374); their landing regions hold words as
// before, and the all-reduce pushes on the rounded sums.
//
// What bounds them: bytes over NVLink. Of a tensor of S bytes each rank
// sends (and receives) 2(n-1)/n S for the all-reduce and (n-1)/n S for
// the reduce-scatter and the all-gather (S the gathered size), S for the
// hop, against about 450 GB/s a direction on an H100 SXM. At n 4 and
// S 9.44 MB (one FFN layer's f32 weight at d 768) that is 14.2 MB, or
// 31 us, for the all-reduce and 7.1 MB, 16 us, for the others.
//
// Every kernel stores straight into peers' workspaces over NVLink
// (ring_common.cuh has the layout), where a Pallas kernel starts remote
// DMAs and waits on semaphores; a flag word in the receiver's workspace,
// stored after a system fence, says that a range has landed. Every wait
// of every kernel ends at a deadline (wait_for): a missing peer leaves
// an error code in the workspace instead of hanging the card.
//
// The hop (ring_hop_kernel) moves rank r's whole tensor to rank r + 1:
// S bytes over one NVLink direction, 21 us at 9.44 MB and 450 GB/s, plus
// the 5.4 us floor every launch pays behind an L2 flush. A ring step
// pays besides a round trip before its first store (a neighbour barrier)
// and holds each block's copy-out behind its own push. This design:
//  - No barrier: the tensor lands in one of the two regions the other
//    kernels use in turn, one slot a region, and the sender waits only
//    for the right neighbour's release of that region's last use (freed,
//    which has almost always long happened).
//  - The tensor splits into P ranges (64 on four cards). A rank runs 2P
//    blocks: P push their range into the right neighbour's region,
//    kUnroll 16-byte loads in flight a thread, and flag it (landed); P
//    copy their range out of this rank's region as soon as the left
//    neighbour's flag for it lands, and release it to every peer.
// On four H100s at 700 W its trace shows the pushes ending 28-30 us after
// entry (about 320 GB/s a direction: the ranges land together, the links
// carrying every block's stores at once) and the copy-outs 6-8 us later.
// Bulk copies in place of the push's 16-byte stores (cp.async.bulk from
// the tensor into shared memory and on into the peer's region, one
// thread of a push block issuing them through four 16 KB stages;
// patches/ring_hop_bulk_push.patch) ran 2-3% slower at 32 and 64 ranges.
//
// The all-to-all (all_to_all_kernel) moves chunk j of rank r's input (the
// leading-dim n-split) to chunk r of rank j's output, a copy and no sum.
// Each rank sends (n-1)/n of its tensor, a different part to every peer,
// so at n 4 and the EP dispatch's 12.58 MB a rank it is 9.44 MB, 21 us
// of one NVLink direction. Its time goes to the pushes over the links
// (most of a call at that size on NVIDIA H100 80GB HBM3 at 700 W, by the
// kernel's own trace), then to the landed chunks' copy-out, a second
// pass over the card's memory, and to the flags. So the links
// must all be loaded from the start, with many loads in flight, no
// round trip before the first store, and the copy-out overlapped.
// This design:
//  - A chunk splits into P ranges. A rank runs (2n - 1) x P blocks: P
//    copy its own chunk; for each peer j (the k-th after it) P push their
//    range of chunk j into j's workspace, so all peers' links carry data
//    at once; and for each peer s (the k-th before it) P copy out their
//    range of the chunk s pushed here as soon as its flag (landed)
//    lands, while other ranges are still on the links. Each thread keeps
//    kUnroll 16-byte loads in flight before its stores. (A flag for each
//    quarter of a range let no quarter arrive early: the links carry
//    every block's stores at once, and the fences cost more than the
//    overlap gained.) Flags are stored relaxed after one system fence
//    (signal), as the reduce-scatter's.
//  - No entry barrier: the chunks land in one of two regions, used in
//    turn from call to call (the data region, then the staging slots).
//    The last of a rank's n copies of range b (its own chunk's and the
//    n - 1 copy-outs, counted in copied) releases the range to every
//    peer (freed); the sender of the call after next waits for that
//    release before it stores into the same region, which by then has
//    almost always long happened.
//
// The all-gather is the same kernel (all_to_all_kernel<true>) with one
// source for every peer: rank r's input, one chunk, lands at chunk r of
// every output, its own too. A ring of n-1 dependent steps keeps one
// link busy at a time, each step behind its left neighbour's flag, a
// system fence and a release store; pushing to every peer at once loads
// every link (on four H100s at 700 W: 0.038 ms for the 9.44 MB gathered
// at n 4, the ring 0.049). It shares the landing regions and their
// bookkeeping, so FSDP's stream of gathers and reduce-scatters runs with
// no barrier. A region holds n chunk slots (slot s for rank s),
// the n x shard bytes that workspace_bytes gives it (ops/ring.py).
//
// The reduce-scatter (ring_reduce_scatter_kernel) moves the same bytes
// as the ring, (n-1)/n of the tensor a rank, but not through n-1
// dependent steps, each with its link latency and system fence in series
// and one link busy. It is the all-to-all's design with the sum at the
// receiver:
//  - A chunk splits into P ranges. A rank runs n x P blocks: for each
//    peer j (the k-th after it) P push their range of chunk j into j's
//    landing slot for this rank and flag it (landed), all links loaded
//    at once, kUnroll 16-byte loads in flight a thread. Then all n x P
//    blocks sum, n to a range: each waits for its range from the n-1
//    sources and sums its n-th of it in the ring's order (the source
//    after it first, its own chunk last) straight into the output; the
//    last of the n releases the range to every sender (freed). The
//    ranges land together at the end of the pushes (the links carry
//    every block's stores at once), so the sum is a tail after them, a
//    pass over 4 chunks read and one written; spread over every block of
//    the rank it has every SM's loads in flight, where P blocks alone
//    had a quarter of them (by the kernel's own trace). No byte is
//    copied out on its own. Its flags are stored relaxed after one
//    system fence (signal, and the release's loop), not as release
//    stores, each of which costs a fence of its own on the link.
//    At n 4 and 9.44 MB on four H100s its trace shows the pushes ending
//    about 25 us after entry (some 290 GB/s a direction, against 450)
//    and the sums about 6 us later.
//  - It shares the all-to-all's two landing regions, used in turn across
//    every op's calls, and their bookkeeping. A region holds the n-1
//    slots of chunks, slot k - 1 for the k-th rank after the receiver,
//    so that the receiver reads its slots in order.
// The all-reduce (ring_all_reduce_kernel) is the reduce-scatter's push
// and sum, then the all-gather's push, in one launch. A ring takes 2(n-1)
// dependent steps, each behind its left neighbour's flag and two fences,
// with one link busy at a time (on four H100s at 700 W: 0.083 ms for
// 9.44 MB at n 4). Here:
//  - Push: as the reduce-scatter, n x P blocks a rank; blocks of role
//    k - 1 push range b of chunk j = r + k into j's landing slot and flag
//    it (landed), all links loaded at once.
//  - Sum: every block waits for its range from the n-1 sources and sums
//    its n-th of it in the all-reduce's order (its own copy first, then
//    slot 0, 1, ...: the k-th rank after it), into its output's chunk r
//    and straight on to slot r of every peer's other region, with no
//    whole-chunk handoff. The last of the n blocks of a range flags it to
//    every peer (gathered) after a fence; each block fences its own
//    stores before it counts itself done.
//  - Gather: the same block then copies its n-th of range b of each
//    peer's summed chunk out of its own other region as the peer's flag
//    lands; the last of the n releases range b to every peer (freed).
//  - Regions: the pushes land in this call's region, the sums in the
//    other, so a call counts as two region uses (ops/ring.py,
//    region_plan and region_record). The pushes wait for the releases of
//    the last call whose slots there peers release; the sums need no
//    release: a block stores into peer j's other region only after j's
//    push of this call has landed here, so j has ended every earlier
//    call. After the call its push region is free once it has ended on
//    the sender (a rank ends only after every peer's gathered flags,
//    which follow those peers' sums, the reads of that region), and its
//    gather region is released by the copy-outs (freed), so the next
//    call lands in the push region with nothing to wait for. A region
//    holds n chunk slots for the sums, n-1 for the pushes: workspace_bytes
//    gives it the tensor's bytes.
//
// The releases. A call stores into a peer's region only once the peer
// has released (freed) every range of the region's last user, and a
// release of call e by rank j says that j has read range b of every slot
// it holds from call e and, its calls running in stream order, all it
// held from earlier ones. So every kernel releases range b to every
// peer, after the last of its readers of that range: the hop's one
// copy-out block, the n copies of the all-to-all and the all-gather
// (copied), the n sums of the reduce-scatter (summed), the n gathers of
// the all-reduce (copied). A release to the source alone would not do:
// a call that reads from one peer (the hop) lets a rank run ahead of a
// peer still reading, from a slow third rank, the slots of the call
// before, which the next call may store over.
//
// Loopback: the n workspaces of one card, one cooperative launch of every
// rank's blocks (all resident at once, as the waits between blocks need).
//
// Plain C interface, bound with ctypes; every entry takes the device
// index and makes it current first (this library's runtime keeps its own
// current device, apart from PyTorch's).

#include <cuda_bf16.h>

#include <cstring>

#include "ring_common.cuh"

namespace ring {
namespace {

// Block-wide wait until *flag(q) >= target for every q < count (count
// at most blockDim.x): thread q polls flag(q), to the deadline, as
// wait_for does, and leaves step(q) in the error code.
template <typename Flag, typename Step>
__device__ __forceinline__ bool wait_each(const Ctx& c, int count,
                                          uint64_t target, Flag flag,
                                          Step step) {
  int ok = 1;
  const int q = static_cast<int>(threadIdx.x);
  if (q < count) {
    uint64_t* err = err_word(c.me);
    const uint64_t* f = flag(q);
    const uint64_t t0 = now_ns();
    while (ld_acquire(f) < target) {
      if (ld_acquire(err) != 0) {
        ok = 0;
        break;
      }
      if (now_ns() - t0 > c.timeout_ns) {
        atomicCAS(reinterpret_cast<unsigned long long*>(err), 0ull,
                  static_cast<unsigned long long>(error_code(c, step(q))));
        ok = 0;
        break;
      }
    }
  }
  return __syncthreads_and(ok) != 0;
}

constexpr int kUnroll = 4;   // 16-byte loads in flight a thread

// y[i] = x[i] for i in the block's range [c.lo, c.hi) of a chunk; x may
// have been written by a peer (loads bypass L1).
__device__ __forceinline__ void copy_range(const Ctx& c, float* y,
                                           const float* x) {
  const long long step = blockDim.x;
  if (c.vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    const long long hi = c.hi / 4;
    long long i = c.lo / 4 + threadIdx.x;
    for (; i + (kUnroll - 1) * step < hi; i += kUnroll * step) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(x4 + i + u * step);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) y4[i + u * step] = v[u];
    }
    for (; i < hi; i += step) y4[i] = __ldcg(x4 + i);
  } else {
    for (long long i = c.lo + threadIdx.x; i < c.hi; i += step)
      y[i] = __ldcg(x + i);
  }
}

// The trace: when set (ring_a2a_trace, passed in Params::stamps), thread
// 0 of each block stores %globaltimer at the block's phases into
// stamps[blockIdx * kStamps + phase]: 0 entry; 1 its stores may start
// (after the release wait) and 2 its ranges stored and flagged
// (own-chunk and pushing blocks); 3 its range arrived and 4 copied out
// (or summed: the all-reduce's sums also stored on to every peer and
// flagged) and released (copy-out and summing blocks); 5 the
// all-reduce's gathered parts copied out and released.
constexpr int kStamps = 6;

__device__ __forceinline__ void stamp(const Params& p, int phase) {
  if (p.stamps != nullptr && threadIdx.x == 0)
    p.stamps[blockIdx.x * kStamps + phase] = now_ns();
}

// Range b of the P = p.nblk ranges a chunk: [c.lo, c.hi), a multiple of
// 4 floats long, so each range stays float4-aligned.
__device__ __forceinline__ void set_range(Ctx& c, const Params& p, int b) {
  const long long per = ((p.chunk + p.nblk - 1) / p.nblk + 3) / 4 * 4;
  c.lo = min(p.chunk, static_cast<long long>(b) * per);
  c.hi = min(p.chunk, c.lo + per);
}

// A call's entry: a rank poisoned by an earlier timeout does nothing.
__device__ __forceinline__ bool open_call(const Ctx& c) {
  int ok = 1;
  if (threadIdx.x == 0) ok = ld_acquire(err_word(c.me)) == 0;
  return __syncthreads_and(ok) != 0;
}

// This call's landing region in a workspace (0: data, 1: staging), and
// the other one, where the all-reduce gathers.
__device__ __forceinline__ float* region(const Ctx& c, const Params& p,
                                         char* ws) {
  return p.region ? stage(c, ws) : data(ws);
}
__device__ __forceinline__ float* other_region(const Ctx& c, const Params& p,
                                               char* ws) {
  return p.region ? data(ws) : stage(c, ws);
}

// Wait until peer j has released every range of the last call that used
// this call's region (that call may have split its chunks otherwise):
// j has read all it held there.
__device__ __forceinline__ bool wait_freed(const Ctx& c, const Params& p,
                                           int j) {
  return wait_each(
      c, p.prev_nblk, static_cast<uint64_t>(p.prev_epoch),
      [&](int q) { return freed(c.me, j, q); },
      [&](int) { return kMaxRanks + j; });
}

// Thread 0 of the last block to read range b of this rank's slots (the
// hop's one copy-out block of range b): range b of the slots this rank
// fills in every peer's workspace released, one system fence, then
// relaxed flag stores (release stores here, a fence
// each, held the reduce-scatter's end back by about 6 us at the main
// shape on four H100s, by its trace).
__device__ __forceinline__ void release_all(const Ctx& c, const Params& p,
                                            int b) {
  __threadfence_system();
  for (int k = 1; k < c.n; ++k)
    st_relaxed(freed(p.ws[(c.r + k) % c.n], c.r, b), c.epoch);
}

// Rank r's block `local` of 2P: range b = local % P. Blocks local < P
// push range b of the tensor into the right neighbour's slot of this
// call's region, once it has released the region's last use, and flag
// it; the other P copy range b of what the left neighbour pushed here
// out into the output as soon as it lands, while other ranges are still
// on the link, and release it to every peer.
__global__ void __launch_bounds__(kThreads) ring_hop_kernel(Params p) {
  Ctx c = make_ctx(p, kHop, 2 * p.nblk);
  const int n = p.n, b = c.b % p.nblk;
  set_range(c, p, b);
  stamp(p, 0);
  if (!open_call(c)) return;
  if (c.b < p.nblk) {
    const int right = (c.r + 1) % n;
    if (!wait_freed(c, p, right)) return;
    stamp(p, 1);
    copy_range(c, region(c, p, p.ws[right]), c.x);
    signal(landed(p.ws[right], c.r, b), c.epoch);
    stamp(p, 2);
  } else {
    const int left = (c.r + n - 1) % n;
    if (!wait_for(c, landed(c.me, left, b), c.epoch, left)) return;
    stamp(p, 3);
    copy_range(c, c.y, region(c, p, c.me));
    __syncthreads();
    if (threadIdx.x == 0) release_all(c, p, b);
    stamp(p, 4);
  }
}

// Rank r's block `local` of (2n - 1) * P: role = local / P (0: its own
// chunk; k in [1, n): pushes to the k-th peer after it; n - 1 + k: copies
// out what the k-th peer before it pushed), range b = local % P. The
// all-to-all (kGather false) sends chunk j of its input to peer j; the
// all-gather (kGather true) sends its whole input, one chunk, to every
// peer and keeps it as chunk r of its own output.
template <bool kGather>
__global__ void __launch_bounds__(kThreads) all_to_all_kernel(Params p) {
  const int n = p.n;
  Ctx c = make_ctx(p, kGather ? kAllGather : kAllToAll, (2 * n - 1) * p.nblk);
  const int local = c.b;
  const int role = local / p.nblk, b = local % p.nblk;
  set_range(c, p, b);
  const long long e = p.chunk;
  stamp(p, 0);
  if (!open_call(c)) return;
  if (role > 0 && role < n) {
    // push range b of the chunk for j into rank j's slot r, once j has
    // read what it held in the last call that used the region (its every
    // range: that call may have split the chunk otherwise)
    const int j = (c.r + role) % n;
    if (!wait_freed(c, p, j)) return;
    stamp(p, 1);
    copy_range(c, region(c, p, p.ws[j]) + c.r * e,
               kGather ? c.x : c.x + j * e);
    signal(landed(p.ws[j], c.r, b), c.epoch);
    stamp(p, 2);
    return;
  }
  if (role == 0) {
    stamp(p, 1);
    copy_range(c, c.y + c.r * e, kGather ? c.x : c.x + c.r * e);
  } else {
    // rank s, the k-th before this one, pushes here as to its k-th peer
    const int s = (c.r + 2 * n - 1 - role) % n;
    if (!wait_for(c, landed(c.me, s, b), c.epoch, s)) return;
    stamp(p, 3);
    copy_range(c, c.y + s * e, region(c, p, c.me) + s * e);
  }
  // count this copy of range b done (n a call: the own chunk's and the
  // n - 1 copy-outs); the last releases range b to every peer, so that a
  // release says every slot's range b has been read
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const uint64_t done = atomicAdd(copied(c.me, b), 1ull);
    if (done % n == static_cast<uint64_t>(n - 1)) release_all(c, p, b);
  }
  stamp(p, role == 0 ? 2 : 4);
}

constexpr int kSumUnroll = 2;   // 16-byte indices in flight a thread

// b + a of two 4-byte words: f32, or (kBf16) the two bf16 elements each
// word holds (element 0 in the low half), each pair added in f32 and
// rounded to bf16 once, to nearest even, as PyTorch adds bf16 tensors
// and as the Pallas kernels' adds on bf16 refs do (pallas_ring.py:236,
// :374). So a sum in a given order has the same bits on every route.
template <bool kBf16>
__device__ __forceinline__ float add1(float b, float a) {
  if (!kBf16) return b + a;
  const unsigned ub = __float_as_uint(b), ua = __float_as_uint(a);
  const float lo = __uint_as_float(ub << 16) + __uint_as_float(ua << 16);
  const float hi =
      __uint_as_float(ub & 0xffff0000u) + __uint_as_float(ua & 0xffff0000u);
  return __uint_as_float(
      static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
      static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// add1 on each word of a 16-byte vector: 4 floats or 8 bf16 elements.
template <bool kBf16>
__device__ __forceinline__ float4 add4(float4 b, float4 a) {
  return make_float4(add1<kBf16>(b.x, a.x), add1<kBf16>(b.y, a.y),
                     add1<kBf16>(b.z, a.z), add1<kBf16>(b.w, a.w));
}

// y[i] for i in the block's range [c.lo, c.hi) of a chunk (in words): the
// N - 1 slots of `slots` (chunk words apart, written by peers: loads
// bypass L1), then own, added left to right: acc = slot 0; acc = slot k
// + acc; y = own + acc, each add rounded to bf16 with kBf16. Every load
// of an index is issued before its adds.
template <int N, bool kBf16>
__device__ __forceinline__ void sum_range(const Ctx& c, float* y,
                                          const float* slots,
                                          const float* own) {
  const long long step = blockDim.x, e = c.chunk;
  if (c.vec) {
    float4* y4 = reinterpret_cast<float4*>(y);
    const float4* o4 = reinterpret_cast<const float4*>(own);
    const float4* s4 = reinterpret_cast<const float4*>(slots);
    const long long e4 = e / 4, hi = c.hi / 4;
    long long i = c.lo / 4 + threadIdx.x;
    for (; i + (kSumUnroll - 1) * step < hi; i += kSumUnroll * step) {
      float4 v[N][kSumUnroll];
#pragma unroll
      for (int k = 0; k < N - 1; ++k)
#pragma unroll
        for (int u = 0; u < kSumUnroll; ++u)
          v[k][u] = __ldcg(s4 + k * e4 + i + u * step);
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        v[N - 1][u] = __ldcg(o4 + i + u * step);
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        float4 acc = v[0][u];
#pragma unroll
        for (int k = 1; k < N; ++k) acc = add4<kBf16>(v[k][u], acc);
        y4[i + u * step] = acc;
      }
    }
    for (; i < hi; i += step) {
      float4 acc = __ldcg(s4 + i);
#pragma unroll
      for (int k = 1; k < N - 1; ++k)
        acc = add4<kBf16>(__ldcg(s4 + k * e4 + i), acc);
      y4[i] = add4<kBf16>(__ldcg(o4 + i), acc);
    }
  } else {
    for (long long i = c.lo + threadIdx.x; i < c.hi; i += step) {
      float acc = __ldcg(slots + i);
#pragma unroll
      for (int k = 1; k < N - 1; ++k)
        acc = add1<kBf16>(__ldcg(slots + k * e + i), acc);
      y[i] = add1<kBf16>(__ldcg(own + i), acc);
    }
  }
}

// sum_range for the ring's n ranks, in f32 or bf16 pairs.
template <bool kBf16>
__device__ __forceinline__ void sum_any(const Ctx& c, float* y,
                                        const float* slots,
                                        const float* own) {
  switch (c.n) {
    case 2: sum_range<2, kBf16>(c, y, slots, own); break;
    case 3: sum_range<3, kBf16>(c, y, slots, own); break;
    case 4: sum_range<4, kBf16>(c, y, slots, own); break;
    case 5: sum_range<5, kBf16>(c, y, slots, own); break;
    case 6: sum_range<6, kBf16>(c, y, slots, own); break;
    case 7: sum_range<7, kBf16>(c, y, slots, own); break;
    default: sum_range<8, kBf16>(c, y, slots, own); break;
  }
}

// Rank r's block `local` of n * P: role = local / P, range b = local % P.
// A block of role k - 1 (k in [1, n)) first pushes range b of chunk
// j = r + k into j's landing slot for this rank and flags it; rank j's
// region holds the chunk of the k-th rank after it in slot k - 1. Then
// every block (role n - 1 has nothing to push) waits for range b from
// the n - 1 sources and sums its part `role` of the range, one of n, in
// the ring's order; the last of the n to finish releases the range to
// every sender.
__global__ void __launch_bounds__(kThreads)
    ring_reduce_scatter_kernel(Params p) {
  const int n = p.n;
  Ctx c = make_ctx(p, kReduceScatter, n * p.nblk);
  const int local = c.b;
  const int role = local / p.nblk, b = local % p.nblk;
  const long long e = p.chunk;
  set_range(c, p, b);
  stamp(p, 0);
  if (!open_call(c)) return;
  if (role < n - 1) {
    const int j = (c.r + role + 1) % n;
    if (!wait_freed(c, p, j)) return;
    stamp(p, 1);
    copy_range(c, region(c, p, p.ws[j]) + (n - role - 2) * e, c.x + j * e);
    signal(landed(p.ws[j], c.r, b), c.epoch);
    stamp(p, 2);
  }
  // the n - 1 sources' range b, then this block's part of its sum
  if (!wait_each(
          c, n - 1, c.epoch,
          [&](int q) { return landed(c.me, (c.r + q + 1) % n, b); },
          [&](int q) { return (c.r + q + 1) % n; }))
    return;
  stamp(p, 3);
  const long long part = ((c.hi - c.lo + n - 1) / n + 3) / 4 * 4;
  c.lo = min(c.hi, c.lo + role * part);
  c.hi = min(c.hi, c.lo + part);
  const float* slots = region(c, p, c.me);
  const float* own = c.x + c.r * e;
  if (p.bf16)
    sum_any<true>(c, c.y, slots, own);
  else
    sum_any<false>(c, c.y, slots, own);
  // count this part done (n a call); the last releases range b of every
  // source's slot
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const uint64_t done = atomicAdd(summed(c.me, b), 1ull);
    if (done % n == static_cast<uint64_t>(n - 1)) release_all(c, p, b);
  }
  stamp(p, 4);
}

// The all-reduce's sum of the block's range [c.lo, c.hi) of this rank's
// chunk (in words): own first, then the N - 1 slots of `slots` (chunk
// words apart, written by peers: loads bypass L1), added left to right:
// acc = own; acc = slot k + acc, each add rounded to bf16 with kBf16.
// Each sum, as rounded, goes to y and on to the N - 1 peers' dst. Every
// load of an index is in flight before its adds.
template <int N, bool kBf16>
__device__ __forceinline__ void reduce_range(const Ctx& c, float* y,
                                             float* const* dst,
                                             const float* slots,
                                             const float* own) {
  const long long step = blockDim.x, e = c.chunk;
  if (c.vec) {
    float4* y4 = reinterpret_cast<float4*>(y);
    const float4* o4 = reinterpret_cast<const float4*>(own);
    const float4* s4 = reinterpret_cast<const float4*>(slots);
    const long long e4 = e / 4, hi = c.hi / 4;
    long long i = c.lo / 4 + threadIdx.x;
    for (; i + (kSumUnroll - 1) * step < hi; i += kSumUnroll * step) {
      float4 v[N][kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) v[0][u] = __ldcg(o4 + i + u * step);
#pragma unroll
      for (int k = 1; k < N; ++k)
#pragma unroll
        for (int u = 0; u < kSumUnroll; ++u)
          v[k][u] = __ldcg(s4 + (k - 1) * e4 + i + u * step);
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        float4 acc = v[0][u];
#pragma unroll
        for (int k = 1; k < N; ++k) acc = add4<kBf16>(v[k][u], acc);
        y4[i + u * step] = acc;
#pragma unroll
        for (int k = 0; k < N - 1; ++k)
          reinterpret_cast<float4*>(dst[k])[i + u * step] = acc;
      }
    }
    for (; i < hi; i += step) {
      float4 acc = __ldcg(o4 + i);
#pragma unroll
      for (int k = 1; k < N; ++k)
        acc = add4<kBf16>(__ldcg(s4 + (k - 1) * e4 + i), acc);
      y4[i] = acc;
#pragma unroll
      for (int k = 0; k < N - 1; ++k)
        reinterpret_cast<float4*>(dst[k])[i] = acc;
    }
  } else {
    for (long long i = c.lo + threadIdx.x; i < c.hi; i += step) {
      float acc = __ldcg(own + i);
#pragma unroll
      for (int k = 1; k < N; ++k)
        acc = add1<kBf16>(__ldcg(slots + (k - 1) * e + i), acc);
      y[i] = acc;
#pragma unroll
      for (int k = 0; k < N - 1; ++k) dst[k][i] = acc;
    }
  }
}

// reduce_range for the ring's n ranks, in f32 or bf16 pairs.
template <bool kBf16>
__device__ __forceinline__ void reduce_any(const Ctx& c, float* y,
                                           float* const* dst,
                                           const float* slots,
                                           const float* own) {
  switch (c.n) {
    case 2: reduce_range<2, kBf16>(c, y, dst, slots, own); break;
    case 3: reduce_range<3, kBf16>(c, y, dst, slots, own); break;
    case 4: reduce_range<4, kBf16>(c, y, dst, slots, own); break;
    case 5: reduce_range<5, kBf16>(c, y, dst, slots, own); break;
    case 6: reduce_range<6, kBf16>(c, y, dst, slots, own); break;
    case 7: reduce_range<7, kBf16>(c, y, dst, slots, own); break;
    default: reduce_range<8, kBf16>(c, y, dst, slots, own); break;
  }
}

// Rank r's block `local` of n * P: role = local / P, range b = local % P.
// Push, as the reduce-scatter's: a block of role k - 1 (k in [1, n))
// pushes range b of chunk j = r + k into j's landing slot for this rank
// (slot k' - 1 of j's region, for the k'-th rank after j) and flags it.
// Sum: every block waits for range b from the n - 1 sources and sums its
// part `role` of the range, one of n, in the all-reduce's order (its own
// copy first, then the ranks after it), into its output's chunk r and
// straight on to slot r of every peer's other region; the last of the n
// to finish flags range b to every peer (gathered). Gather: the block
// then copies its part of range b of every peer's summed chunk out of
// its own other region as each lands; the last of the n releases range b
// to every peer (freed).
__global__ void __launch_bounds__(kThreads) ring_all_reduce_kernel(Params p) {
  const int n = p.n;
  Ctx c = make_ctx(p, kAllReduce, n * p.nblk);
  const int local = c.b;
  const int role = local / p.nblk, b = local % p.nblk;
  const long long e = p.chunk;
  set_range(c, p, b);
  stamp(p, 0);
  if (!open_call(c)) return;
  if (role < n - 1) {
    const int j = (c.r + role + 1) % n;
    if (!wait_freed(c, p, j)) return;
    stamp(p, 1);
    copy_range(c, region(c, p, p.ws[j]) + (n - role - 2) * e, c.x + j * e);
    signal(landed(p.ws[j], c.r, b), c.epoch);
    stamp(p, 2);
  }
  if (!wait_each(
          c, n - 1, c.epoch,
          [&](int q) { return landed(c.me, (c.r + q + 1) % n, b); },
          [&](int q) { return (c.r + q + 1) % n; }))
    return;
  stamp(p, 3);
  const long long part = ((c.hi - c.lo + n - 1) / n + 3) / 4 * 4;
  c.lo = min(c.hi, c.lo + role * part);
  c.hi = min(c.hi, c.lo + part);
  // every peer's gather slot for this rank's chunk; no release to wait
  // for: a peer's push of this call has landed here, so it has ended
  // every call before and read what those left in its regions
  float* dst[kMaxRanks - 1];
#pragma unroll
  for (int k = 1; k < kMaxRanks; ++k)
    dst[k - 1] = k < n ? other_region(c, p, p.ws[(c.r + k) % n]) + c.r * e
                       : nullptr;
  const float* slots = region(c, p, c.me);
  const float* own = c.x + c.r * e;
  float* y = c.y + c.r * e;
  if (p.bf16)
    reduce_any<true>(c, y, dst, slots, own);
  else
    reduce_any<false>(c, y, dst, slots, own);
  // count this part done (n a call): its stores to the peers fenced
  // first; the last flags range b to every peer after one more fence
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    const uint64_t done = atomicAdd(summed(c.me, b), 1ull);
    if (done % n == static_cast<uint64_t>(n - 1)) {
      __threadfence_system();
      for (int k = 1; k < n; ++k)
        st_relaxed(gathered(p.ws[(c.r + k) % n], c.r, b), c.epoch);
    }
  }
  stamp(p, 4);
  // the gather: this block's part of range b of each peer's sum
  for (int k = 1; k < n; ++k) {
    const int s = (c.r + k) % n;
    if (!wait_for(c, gathered(c.me, s, b), c.epoch, 2 * kMaxRanks + s))
      return;
    copy_range(c, c.y + s * e, other_region(c, p, c.me) + s * e);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const uint64_t done = atomicAdd(copied(c.me, b), 1ull);
    if (done % n == static_cast<uint64_t>(n - 1)) release_all(c, p, b);
  }
  stamp(p, 5);
}

// the trace buffer of each device's calls (ring_a2a_trace), host side
constexpr int kMaxDevices = 64;
unsigned long long* trace_stamps[kMaxDevices] = {};

const void* const kKernels[5] = {
    (const void*)(ring_hop_kernel),
    (const void*)(ring_all_reduce_kernel),
    (const void*)(ring_reduce_scatter_kernel),
    (const void*)(all_to_all_kernel<true>),
    (const void*)(all_to_all_kernel<false>)};

}  // namespace
}  // namespace ring

extern "C" {

// One call of collective `op` (0 hop, 1 all-reduce, 2 reduce-scatter,
// 3 all-gather, 4 all-to-all). ws: n workspace addresses as mapped in
// this process (the hop stores into its right neighbour's, the other
// ops into every peer's). in / out: one address (dist, rank >= 0) or n
// (loopback, rank < 0). chunk: 4-byte words a chunk. nblk: ranges a chunk
// (2 * nblk blocks a rank for the hop, (2n - 1) * nblk for the all-to-all
// and the all-gather, n * nblk for the reduce-scatter and the
// all-reduce). bf16: 1 when the words of an all-reduce or a
// reduce-scatter hold bf16 pairs (the other ops move bytes: 0).
// prev_epoch, prev_nblk, region: as Params. The launch goes on `stream`;
// returns a cudaError_t as int.
int ring_launch(int device, int op, const unsigned long long* ws,
                const unsigned long long* in, const unsigned long long* out,
                int n, int rank, long long chunk, long long stage_off,
                long long epoch, long long timeout_ns, int nblk, int vec,
                int bf16, long long prev_epoch, int prev_nblk, int region,
                void* stream) {
  using namespace ring;
  const int blocks_a_rank =
      op == kAllToAll || op == kAllGather        ? (2 * n - 1) * nblk
      : op == kReduceScatter || op == kAllReduce ? n * nblk
                                                 : 2 * nblk;
  if (op < 0 || op > 4 || n < 2 || n > kMaxRanks || rank >= n ||
      nblk < 1 || nblk > kMaxBlocks || chunk < 1 || epoch < 1 ||
      prev_epoch < 0 || prev_epoch >= epoch || prev_nblk < 0 ||
      prev_nblk > kMaxBlocks || (prev_nblk > 0) != (prev_epoch > 0) ||
      region < 0 || region > 1 || bf16 < 0 || bf16 > 1 ||
      (bf16 && op != kAllReduce && op != kReduceScatter))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p = {};
  const int here = rank < 0 ? n : 1;
  for (int i = 0; i < n; ++i) p.ws[i] = reinterpret_cast<char*>(ws[i]);
  for (int i = 0; i < here; ++i) {
    p.in[i] = reinterpret_cast<const float*>(in[i]);
    p.out[i] = reinterpret_cast<float*>(out[i]);
  }
  p.chunk = chunk;
  p.stage_off = stage_off;
  p.epoch = epoch;
  p.timeout_ns = timeout_ns;
  p.n = n;
  p.rank = rank;
  p.nblk = nblk;
  p.vec = vec;
  p.bf16 = bf16;
  p.prev_epoch = prev_epoch;
  p.prev_nblk = prev_nblk;
  p.region = region;
  p.stamps = device >= 0 && device < kMaxDevices ? trace_stamps[device]
                                                 : nullptr;
  void* args[] = {&p};
  const dim3 grid(static_cast<unsigned>(blocks_a_rank * here)),
      block(kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = rank < 0 ? cudaLaunchCooperativeKernel(kKernels[op], grid, block, args,
                                             0, st)
               : cudaLaunchKernel(kKernels[op], grid, block, args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Trace the calls that follow on `device` into `stamps`
// (kStamps words a block of the launch, zeroed by the caller), or stop
// with nullptr.
int ring_a2a_trace(int device, void* stamps) {
  using namespace ring;
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  trace_stamps[device] = static_cast<unsigned long long*>(stamps);
  return 0;
}

// A zeroed workspace of `bytes` on `device`.
int ring_ws_alloc(int device, long long bytes, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(out, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaMemset(*out, 0, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}

int ring_ws_free(int device, void* p) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFree(p);
  return static_cast<int>(e);
}

// The 64-byte IPC handle of a workspace, into handle[64].
int ring_ws_handle(int device, void* p, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), p);
  return static_cast<int>(e);
}

// Map a peer's workspace from its handle; peer access is enabled lazily.
int ring_ws_open(int device, const void* handle, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    cudaIpcMemHandle_t h;
    memcpy(&h, handle, sizeof(h));
    e = cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
  }
  return static_cast<int>(e);
}

int ring_ws_close(int device, void* p) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaIpcCloseMemHandle(p);
  return static_cast<int>(e);
}

// The error word of a workspace, after the device has finished its work.
int ring_ws_error(int device, const void* p, unsigned long long* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpy(out, p, 8, cudaMemcpyDeviceToHost);
  return static_cast<int>(e);
}

}  // extern "C"
