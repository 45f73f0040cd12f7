// Shared pieces of the peer collectives (ring_collectives.cu): the peer
// workspace layout, the kernel parameters, flag words stored after a
// system fence and read with acquire loads, and a deadline-bounded
// block-wide wait.
//
// A rank's workspace is one cudaMalloc on its card, mapped into every
// other rank's process through CUDA IPC (or, in loopback, n workspaces on
// one card in one process). Every kernel writes only into workspaces:
// never into a peer's PyTorch tensors, which are not IPC-mapped.
//
//   [0, 8)             error word: 0, or the code of the first wait that
//                      passed its deadline (see error_code)
//   [2048, 2048+8*64)  summed[b] (reduce-scatter, all-reduce): this
//                      rank's own count of the parts of range b summed,
//                      n a call
//   [3072, 3072+8*64)  copied[b] (all-reduce, all-to-all, all-gather):
//                      this rank's own count of the parts of range b
//                      copied out of its slots (the all-reduce's gather
//                      slots; the all-to-all's own chunk counts too), n
//                      a call
//   [4096, 8192)       landed[j][b]: written by rank j, the epoch of the
//                      call once range b of its chunk has landed here
//   [12288, 16384)     freed[j][b]: written by rank j, the epoch of the
//                      call whose range b it has read out of every slot
//                      it held, this rank's too (or of a later call: a
//                      release covers every earlier one)
//   [16384, 20480)     gathered[j][b] (all-reduce): written by rank j,
//                      the epoch of the call once range b of its summed
//                      chunk has landed here
//   [20480, ...)       data region: capacity bytes (the chunks of calls
//                      of even count)
//   [stage_off, ...)   staging slots: capacity bytes (the chunks of
//                      calls of odd count)
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
constexpr long long kErrOff = 0;
constexpr long long kSummedOff = 2048;
constexpr long long kCopiedOff = 3072;
constexpr long long kLandedOff = 4096;
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
  int nblk;                     // ranges a chunk (the hop: 2 * nblk
                                // blocks a rank; all-to-all, all-gather:
                                // (2n - 1) * nblk; reduce-scatter,
                                // all-reduce: n * nblk)
  int vec;                      // 1: 16-byte aligned, chunk % 4 == 0
  int bf16;                     // 1: the all-reduce's and the
                                // reduce-scatter's words hold bf16 pairs
                                // (their sums round to bf16 each add)
  // the landing region of this call (0 data, 1 staging; the all-reduce
  // gathers in the other one), and the epoch of the last call whose
  // slots there peers release (0: none) and that call's ranges a chunk
  long long prev_epoch;
  int prev_nblk;
  int region;
  // the trace (ring_a2a_trace), or nullptr: a kernel parameter, so an
  // untraced block reads no global word to know
  unsigned long long* stamps;
};

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// What one block of one rank works on.
struct Ctx {
  int n, r, b;
  long long lo, hi;     // the block's element range within a chunk
  long long chunk;
  char* me;             // this rank's workspace
  const float* x;
  float* y;
  uint64_t epoch;
  uint64_t timeout_ns;
  long long stage_off;
  bool vec;
  int op;
};

// The context of rank r's block b of the per_rank blocks a rank (in
// loopback the launch holds every rank's blocks in turn); b is also its
// block in error codes. The range is set by the kernel (set_range).
__device__ __forceinline__ Ctx make_ctx(const Params& p, int op,
                                        int per_rank) {
  Ctx c;
  const bool loop = p.rank < 0;
  c.op = op;
  c.n = p.n;
  c.r = loop ? static_cast<int>(blockIdx.x) / per_rank : p.rank;
  c.b = static_cast<int>(blockIdx.x) % per_rank;
  c.lo = c.hi = 0;
  c.chunk = p.chunk;
  c.me = p.ws[c.r];
  c.x = p.in[loop ? c.r : 0];
  c.y = p.out[loop ? c.r : 0];
  c.epoch = static_cast<uint64_t>(p.epoch);
  c.timeout_ns = static_cast<uint64_t>(p.timeout_ns);
  c.stage_off = p.stage_off;
  c.vec = p.vec != 0;
  return c;
}

__device__ __forceinline__ uint64_t* err_word(char* ws) {
  return reinterpret_cast<uint64_t*>(ws + kErrOff);
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
// waited for (the source rank of a pushed chunk, kMaxRanks + the peer
// whose release of its landing slot it waited for, or 2 * kMaxRanks +
// the peer whose summed chunk it waited for), the block and the rank
// (each + 1, so that 0 means no error).
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
// publishes as a release store would (a fence then a strong store is a
// release pattern), without the second fence a release store makes:
// several flags stored after one fence cost one fence.
__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Publish: every thread's stores to the peer are issued before the
// barrier; one thread then fences at system scope and stores the flag
// relaxed, so the data is visible before the flag is. (A release store's
// own fence, on top of the explicit one, held the flags back by some
// 2 us each at the main shape on four H100s.)
__device__ __forceinline__ void signal(uint64_t* flag, uint64_t v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_relaxed(flag, v);
  }
}

}  // namespace ring
