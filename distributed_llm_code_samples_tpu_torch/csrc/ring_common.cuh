// Shared pieces of the peer collectives (ring_collectives.cu): the peer
// workspace layout, the kernel parameters, flag words with system-scope
// release/acquire, and a deadline-bounded block-wide wait.
//
// A rank's workspace is one cudaMalloc on its card, mapped into every
// other rank's process through CUDA IPC (or, in loopback, n workspaces on
// one card in one process). Every kernel writes only into workspaces:
// never into a peer's PyTorch tensors, which are not IPC-mapped.
//
//   [0, 8)             error word: 0, or the code of the first wait that
//                      passed its deadline (see error_code)
//   [256, 256 + 8*64)  arrive[b] (the hop): written by the left
//                      neighbour's block b, epoch * 64 + 1 once its data
//                      is here
//   [1024, 1024+8*64)  ready[b] (the hop): written by the right
//                      neighbour's block b, the epoch of the call it has
//                      entered
//   [2048, 2048+8*64)  summed[b] (reduce-scatter, all-reduce): this
//                      rank's own count of the parts of range b summed,
//                      n a call
//   [3072, 3072+8*64)  copied[b] (all-reduce): this rank's own count of
//                      the parts of range b copied out of its gather
//                      slots, n a call
//   [4096, 8192)       landed[j][b] (the push designs): written by rank
//                      j, the epoch of the call once range b of its chunk
//                      has landed here
//   [8192, 12288)      entered[j] (the push designs): written
//                      by rank j, the epoch of the call it has entered
//                      (the entry barrier of a call that follows the hop)
//   [12288, 16384)     freed[j][b] (the push designs): written
//                      by rank j, the epoch of the call whose range b it
//                      has read out of the slot this rank fills in j's
//                      workspace
//   [16384, 20480)     gathered[j][b] (all-reduce): written by rank j,
//                      the epoch of the call once range b of its summed
//                      chunk has landed here
//   [20480, ...)       data region: capacity bytes (the hop lands here;
//                      the push designs' chunks in calls of even count)
//   [stage_off, ...)   staging slots: capacity bytes (the push designs'
//                      chunks in calls of odd count)
//
// Flags only grow. Each call carries an epoch that every rank counts the
// same way (one a call, the same call sequence on every rank), so a flag
// left by an earlier call can never satisfy a wait of this one, and no
// flag is ever reset (the Pallas kernels instead drain their semaphores
// back to zero, pallas_ring.py:124-135).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

constexpr int kMaxRanks = 8;
constexpr int kMaxBlocks = 64;      // blocks a rank; flag words a link
constexpr int kThreads = 512;
constexpr uint64_t kStepsPerEpoch = 64;   // the hop's arrive flags
constexpr long long kErrOff = 0;
constexpr long long kArriveOff = 256;
constexpr long long kReadyOff = 1024;
constexpr long long kSummedOff = 2048;
constexpr long long kCopiedOff = 3072;
constexpr long long kLandedOff = 4096;
constexpr long long kEnteredOff = 8192;
constexpr long long kFreedOff = 12288;
constexpr long long kGatheredOff = 16384;
constexpr long long kDataOff = 20480;

enum Op {
  kHop = 0,
  kAllReduce = 1,
  kReduceScatter = 2,
  kAllGather = 3,
  kAllToAll = 4
};

struct Params {
  char* ws[kMaxRanks];          // every rank's workspace as mapped here
  const float* in[kMaxRanks];   // dist: in[0]; loopback: one a rank
  float* out[kMaxRanks];
  long long chunk;              // floats a ring chunk
  long long stage_off;          // bytes from a workspace to its slots
  long long epoch;              // >= 1, one more every call
  long long timeout_ns;
  int n;
  int rank;                     // < 0: loopback, rank = blockIdx over
                                // the blocks a rank
  int nblk;                     // blocks a rank (the hop); ranges a
                                // chunk (all-to-all, all-gather: (2n - 1)
                                // * nblk blocks a rank; reduce-scatter,
                                // all-reduce: n * nblk)
  int vec;                      // 1: 16-byte aligned, chunk % 4 == 0
  // the push designs: the landing region of this call (0 data, 1
  // staging; the all-reduce gathers in the other one), the epoch of the
  // last call whose slots there peers release (0: none) and that call's
  // ranges a chunk, and whether the call opens with the entry barrier
  long long prev_epoch;
  int prev_nblk;
  int region;
  int barrier;
  // the push designs' trace (ring_a2a_trace), or nullptr: a kernel
  // parameter, so an untraced block reads no global word to know
  unsigned long long* stamps;
};

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// What one block of one rank works on.
struct Ctx {
  int n, r, b, left, right;
  long long lo, hi;     // the block's element range within a chunk
  long long chunk;
  char* me;             // this rank's workspace
  char* lw;             // the left neighbour's
  char* rw;             // the right neighbour's
  const float* x;
  float* y;
  uint64_t base;        // epoch * kStepsPerEpoch
  uint64_t epoch;
  uint64_t timeout_ns;
  long long stage_off;
  bool vec;
  int op;
};

__device__ __forceinline__ Ctx make_ctx(const Params& p, int op) {
  Ctx c;
  const bool loop = p.rank < 0;
  c.op = op;
  c.n = p.n;
  c.r = loop ? static_cast<int>(blockIdx.x) / p.nblk : p.rank;
  c.b = loop ? static_cast<int>(blockIdx.x) % p.nblk
             : static_cast<int>(blockIdx.x);
  c.left = (c.r + c.n - 1) % c.n;
  c.right = (c.r + 1) % c.n;
  c.chunk = p.chunk;
  // a multiple of 4 floats a block, so each range stays float4-aligned
  const long long per = ((p.chunk + p.nblk - 1) / p.nblk + 3) / 4 * 4;
  c.lo = min(p.chunk, static_cast<long long>(c.b) * per);
  c.hi = min(p.chunk, c.lo + per);
  c.me = p.ws[c.r];
  c.lw = p.ws[c.left];
  c.rw = p.ws[c.right];
  c.x = p.in[loop ? c.r : 0];
  c.y = p.out[loop ? c.r : 0];
  c.epoch = static_cast<uint64_t>(p.epoch);
  c.base = c.epoch * kStepsPerEpoch;
  c.timeout_ns = static_cast<uint64_t>(p.timeout_ns);
  c.stage_off = p.stage_off;
  c.vec = p.vec != 0;
  return c;
}

__device__ __forceinline__ uint64_t* err_word(char* ws) {
  return reinterpret_cast<uint64_t*>(ws + kErrOff);
}
__device__ __forceinline__ uint64_t* arrive(char* ws, int b) {
  return reinterpret_cast<uint64_t*>(ws + kArriveOff) + b;
}
__device__ __forceinline__ uint64_t* ready(char* ws, int b) {
  return reinterpret_cast<uint64_t*>(ws + kReadyOff) + b;
}
__device__ __forceinline__ unsigned long long* summed(char* ws, int b) {
  return reinterpret_cast<unsigned long long*>(ws + kSummedOff) + b;
}
__device__ __forceinline__ unsigned long long* copied(char* ws, int b) {
  return reinterpret_cast<unsigned long long*>(ws + kCopiedOff) + b;
}
__device__ __forceinline__ uint64_t* landed(char* ws, int src, int b) {
  return reinterpret_cast<uint64_t*>(ws + kLandedOff) + src * kMaxBlocks +
         b;
}
__device__ __forceinline__ uint64_t* entered(char* ws, int src) {
  return reinterpret_cast<uint64_t*>(ws + kEnteredOff) + src;
}
__device__ __forceinline__ uint64_t* freed(char* ws, int dst, int b) {
  return reinterpret_cast<uint64_t*>(ws + kFreedOff) + dst * kMaxBlocks + b;
}
__device__ __forceinline__ uint64_t* gathered(char* ws, int src, int b) {
  return reinterpret_cast<uint64_t*>(ws + kGatheredOff) + src * kMaxBlocks +
         b;
}
__device__ __forceinline__ float* data(char* ws) {
  return reinterpret_cast<float*>(ws + kDataOff);
}
__device__ __forceinline__ float* stage(const Ctx& c, char* ws) {
  return reinterpret_cast<float*>(ws + c.stage_off);
}

// Read by the host when a wait passes its deadline: the op, the step it
// waited for (the hop: 0, or -1 at the entry barrier; the push designs:
// -1 at the entry barrier, the source rank of a pushed chunk, kMaxRanks +
// the peer whose release of its landing slot it waited for, or 2 *
// kMaxRanks + the peer whose summed chunk it waited for), the block and
// the rank (each + 1, so that 0 means no error).
__device__ __forceinline__ uint64_t error_code(const Ctx& c, int step) {
  return (static_cast<uint64_t>(c.op + 1) << 48) |
         (static_cast<uint64_t>(step + 1) << 32) |
         (static_cast<uint64_t>(c.b + 1) << 16) |
         static_cast<uint64_t>(c.r + 1);
}

// Block-wide wait until *flag >= target. Thread 0 polls with acquire
// loads (system scope: the writer is another card) until a deadline on
// %globaltimer; the barrier then orders every thread's later loads after
// its acquire. On a timeout it leaves its code in this rank's error word;
// it also gives up once another block of the rank has failed. Returns
// false on every thread when it gave up: the caller returns, the kernel
// ends, and the host reads the error word after its synchronise.
__device__ __forceinline__ bool wait_for(const Ctx& c, const uint64_t* flag,
                                         uint64_t target, int step) {
  int ok = 1;
  if (threadIdx.x == 0) {
    uint64_t* err = err_word(c.me);
    const uint64_t t0 = now_ns();
    while (ld_acquire(flag) < target) {
      if (ld_acquire(err) != 0) {
        ok = 0;
        break;
      }
      if (now_ns() - t0 > c.timeout_ns) {
        atomicCAS(reinterpret_cast<unsigned long long*>(err), 0ull,
                  static_cast<unsigned long long>(error_code(c, step)));
        ok = 0;
        break;
      }
    }
  }
  return __syncthreads_and(ok) != 0;
}

// A relaxed store at system scope. After a __threadfence_system() it
// publishes as st_release does (a fence then a strong store is a release
// pattern), without the second fence a release store makes: several
// flags stored after one fence cost one fence.
__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Publish: every thread's stores to the peer are issued before the
// barrier; one thread then fences at system scope and stores the flag
// with release semantics. The data is visible before the flag is.
__device__ __forceinline__ void publish(uint64_t* flag, uint64_t v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release(flag, v);
  }
}

// publish() with a relaxed flag store after the fence: the same release
// pattern, one fence instead of two. The push designs' flags (landed,
// freed) use it; a release store's own fence, on top of the
// explicit one, held its flags back by some 2 us each at the main shape
// on four H100s.
__device__ __forceinline__ void signal(uint64_t* flag, uint64_t v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_relaxed(flag, v);
  }
}

// Kernel entry: a rank poisoned by an earlier timeout does nothing. Else
// tell the left neighbour that this rank has entered the call (so it has
// finished the previous one: kernels on one stream run in order), and
// wait until the right neighbour says the same. Only then may this rank
// write into the right neighbour's workspace: no write lands in a
// workspace whose owner is still reading the previous call's data (the
// neighbour barrier of pallas_ring.py:138-148).
__device__ __forceinline__ bool enter(const Ctx& c) {
  int ok = 1;
  if (threadIdx.x == 0) ok = ld_acquire(err_word(c.me)) == 0;
  if (!__syncthreads_and(ok)) return false;
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release(ready(c.lw, c.b), c.epoch);
  }
  return wait_for(c, ready(c.me, c.b), c.epoch, -1);
}

}  // namespace ring
