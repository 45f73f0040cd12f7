// Peer collectives for Hopper (sm_90a) over peer-mapped memory: one ring
// hop, the ring all-reduce, reduce-scatter and all-gather, and the dense
// all-to-all.
//
// Replaces the TPU kernels of distributed_llm_code_samples_tpu/ops/
// pallas_ring.py: `ppermute_dma` (:151), `ring_all_reduce` (:190),
// `ring_reduce_scatter` (:328), `ring_all_gather` (:406) and
// `all_to_all_dma` (:490; all_to_all_kernel below). The ring kernels compute
// the same functions with the same chunks (the leading-dim n-split) and
// the same ring schedule, so each chunk is summed in the Pallas kernels'
// order: at reduce step s rank r adds its own copy of chunk
// (v - s - 1) mod n to the partial its left neighbour sent (v = r for the
// all-reduce, r - 1 for the reduce-scatter, so that rank r owns chunk r).
//
// What bounds them: bytes over NVLink. Of a tensor of S bytes each rank
// sends (and receives) 2(n-1)/n S for the all-reduce and (n-1)/n S for
// the reduce-scatter and the all-gather (S the gathered size), S for the
// hop, against about 450 GB/s a direction on an H100 SXM. At n 4 and
// S 9.44 MB (one FFN layer's f32 weight at d 768) that is 14.2 MB, or
// 31 us, for the all-reduce and 7.1 MB, 16 us, for the others.
//
// Design. A Pallas kernel issues remote DMAs and waits on semaphores; on
// Hopper a rank's threads store straight into its right neighbour's
// workspace over NVLink (ring_common.cuh has the layout), and a flag word
// in the receiver's workspace, stored with release semantics after a
// system fence, says that a step's data has landed. Each kernel splits a
// chunk into nblk contiguous ranges, one a block, and block b of a rank
// talks only to block b of its neighbours: nblk independent rings, no
// synchronisation between the blocks of one rank. Within a call every
// step writes a different place (n-1 staging slots for a reduce phase,
// chunk c at its own offset for a gather phase), so no slot is reused and
// no capacity handshake is needed; across calls the entry barrier (enter)
// keeps a rank from writing into a neighbour that is still in the
// previous call. The reduce phases fuse the add with the send: at step s
// a block reads its own chunk and the partial its left neighbour left in
// slot s-1, and stores the sum into its right neighbour's slot s. The
// all-reduce's second phase lands in the data region, apart from the
// staging slots, so it needs no phase handoff. The all-gather and the hop
// land chunks in the receiver's data region and copy them from there into
// the receiver's output. Every wait ends at a deadline (wait_for): a
// missing peer leaves an error code in the workspace instead of hanging
// the card.
//
// The all-to-all (all_to_all_kernel) moves chunk j of rank r's input (the
// leading-dim n-split) to chunk r of rank j's output, a copy and no sum.
// Each rank sends (n-1)/n of its tensor, a different part to every peer,
// so at n 4 and the EP dispatch's 12.58 MB a rank it is 9.44 MB, 21 us
// of one NVLink direction. Block b of rank r stores its range of chunk j
// straight into rank j's data region at chunk r, for every peer j, then
// raises one flag in each peer (a2a_arrive[r][b]); it copies its own
// chunk r from input to output, and then each chunk that arrived from
// the peers out of its own workspace. Entry waits for every peer
// (a2a_ready), the full barrier of pallas_ring.py:472-487: no rank stores
// into a workspace whose owner may still be copying out the previous
// call's chunks.
//
// Loopback: the n workspaces of one card, one cooperative launch of n x
// nblk blocks (all resident at once, as the waits between blocks need).
//
// Plain C interface, bound with ctypes; every entry takes the device
// index and makes it current first (this library's runtime keeps its own
// current device, apart from PyTorch's).

#include <cstring>

#include "ring_common.cuh"

namespace ring {
namespace {

__global__ void __launch_bounds__(kThreads) ring_hop_kernel(Params p) {
  const Ctx c = make_ctx(p, kHop);
  if (!enter(c)) return;
  move(c, data(c.rw), nullptr, c.x, nullptr);
  publish(arrive(c.rw, c.b), c.base + 1);
  if (!wait_for(c, arrive(c.me, c.b), c.base + 1, 0)) return;
  move(c, c.y, nullptr, data(c.me), nullptr);
}

// The reduce phase of the ring with virtual rank v: at step s the block
// sends its partial of chunk (v - s) mod n to the right neighbour's slot
// s (at s = 0 its own copy, later its own copy plus the partial that
// arrived in slot s-1). Returns false if a wait gave up; else the partial
// of chunk (v + 1) mod n has arrived in slot n-2.
__device__ __forceinline__ bool reduce_phase(const Ctx& c, int v) {
  const int n = c.n;
  const long long e = c.chunk;
  for (int s = 0; s < n - 1; ++s) {
    const int send = ((v - s) % n + n) % n;
    if (s > 0 && !wait_for(c, arrive(c.me, c.b), c.base + s, s - 1))
      return false;
    move(c, stage(c, c.rw, s), nullptr, c.x + send * e,
         s > 0 ? stage(c, c.me, s - 1) : nullptr);
    publish(arrive(c.rw, c.b), c.base + s + 1);
  }
  return wait_for(c, arrive(c.me, c.b), c.base + n - 1, n - 2);
}

__global__ void __launch_bounds__(kThreads)
    ring_reduce_scatter_kernel(Params p) {
  const Ctx c = make_ctx(p, kReduceScatter);
  if (!enter(c)) return;
  if (!reduce_phase(c, (c.r + c.n - 1) % c.n)) return;
  move(c, c.y, nullptr, c.x + c.r * c.chunk, stage(c, c.me, c.n - 2));
}

__global__ void __launch_bounds__(kThreads) ring_all_reduce_kernel(Params p) {
  const Ctx c = make_ctx(p, kAllReduce);
  const int n = c.n;
  const long long e = c.chunk;
  if (!enter(c)) return;
  if (!reduce_phase(c, c.r)) return;
  // the owned chunk, fully reduced: into the output and on to the right
  // neighbour's data region (gather step 0, flag step n-1)
  const int own = (c.r + 1) % n;
  move(c, data(c.rw) + own * e, c.y + own * e, c.x + own * e,
       stage(c, c.me, n - 2));
  publish(arrive(c.rw, c.b), c.base + n);
  // gather steps 1 .. n-2: forward what the left neighbour sent
  for (int s = 1; s < n - 1; ++s) {
    if (!wait_for(c, arrive(c.me, c.b), c.base + n - 1 + s, n - 2 + s))
      return;
    const int k = ((c.r + 1 - s) % n + n) % n;
    move(c, data(c.rw) + k * e, c.y + k * e, data(c.me) + k * e, nullptr);
    publish(arrive(c.rw, c.b), c.base + n + s);
  }
  if (!wait_for(c, arrive(c.me, c.b), c.base + 2 * n - 2, 2 * n - 3)) return;
  const int last = (c.r + 2) % n;
  move(c, c.y + last * e, nullptr, data(c.me) + last * e, nullptr);
}

__global__ void __launch_bounds__(kThreads) ring_all_gather_kernel(Params p) {
  const Ctx c = make_ctx(p, kAllGather);
  const int n = c.n;
  const long long e = c.chunk;
  if (!enter(c)) return;
  // step s sends chunk (r - s) mod n: this rank's own block at s = 0, then
  // the chunk that arrived at step s-1
  for (int s = 0; s < n - 1; ++s) {
    const int k = ((c.r - s) % n + n) % n;
    if (s > 0 && !wait_for(c, arrive(c.me, c.b), c.base + s, s - 1)) return;
    move(c, data(c.rw) + k * e, c.y + k * e,
         s > 0 ? data(c.me) + k * e : c.x, nullptr);
    publish(arrive(c.rw, c.b), c.base + s + 1);
  }
  if (!wait_for(c, arrive(c.me, c.b), c.base + n - 1, n - 2)) return;
  const int last = (c.r + 1) % n;
  move(c, c.y + last * e, nullptr, data(c.me) + last * e, nullptr);
}

// Entry of the all-to-all: tell every peer that this rank's block b has
// entered the call, then wait until every peer's block b says the same.
__device__ __forceinline__ bool enter_all(const Ctx& c, const Params& p) {
  int ok = 1;
  if (threadIdx.x == 0) ok = ld_acquire(err_word(c.me)) == 0;
  if (!__syncthreads_and(ok)) return false;
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int k = 1; k < c.n; ++k)
      st_release(a2a_ready(p.ws[(c.r + k) % c.n], c.r, c.b), c.epoch);
  }
  for (int k = 1; k < c.n; ++k) {
    if (!wait_for(c, a2a_ready(c.me, (c.r + k) % c.n, c.b), c.epoch, -1))
      return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) all_to_all_kernel(Params p) {
  const Ctx c = make_ctx(p, kAllToAll);
  const int n = c.n;
  const long long e = c.chunk;
  if (!enter_all(c, p)) return;
  // rank r + k is the first peer rank r stores to: the n ranks start on n
  // different targets
  for (int k = 1; k < n; ++k) {
    const int j = (c.r + k) % n;
    move(c, data(p.ws[j]) + c.r * e, nullptr, c.x + j * e, nullptr);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int k = 1; k < n; ++k)
      st_release(a2a_arrive(p.ws[(c.r + k) % n], c.r, c.b), c.base + 1);
  }
  move(c, c.y + c.r * e, nullptr, c.x + c.r * e, nullptr);
  // rank r - k stored to this rank k-th
  for (int k = 1; k < n; ++k) {
    const int j = (c.r + n - k) % n;
    if (!wait_for(c, a2a_arrive(c.me, j, c.b), c.base + 1, j)) return;
    move(c, c.y + j * e, nullptr, data(c.me) + j * e, nullptr);
  }
}

const void* const kKernels[5] = {
    (const void*)(ring_hop_kernel),
    (const void*)(ring_all_reduce_kernel),
    (const void*)(ring_reduce_scatter_kernel),
    (const void*)(ring_all_gather_kernel),
    (const void*)(all_to_all_kernel)};

}  // namespace
}  // namespace ring

extern "C" {

// One call of collective `op` (0 hop, 1 all-reduce, 2 reduce-scatter,
// 3 all-gather, 4 all-to-all). ws: n workspace addresses as mapped in
// this process (the ring kernels read this rank's and its two
// neighbours', the all-to-all every one). in / out:
// one address (dist, rank >= 0) or n (loopback, rank < 0). chunk: floats
// a chunk. The launch goes on `stream`; returns a cudaError_t as int.
int ring_launch(int device, int op, const unsigned long long* ws,
                const unsigned long long* in, const unsigned long long* out,
                int n, int rank, long long chunk, long long stage_off,
                long long epoch, long long timeout_ns, int nblk, int vec,
                void* stream) {
  using namespace ring;
  if (op < 0 || op > 4 || n < 2 || n > kMaxRanks || rank >= n ||
      nblk < 1 || nblk > kMaxBlocks || chunk < 1 || epoch < 1)
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
  void* args[] = {&p};
  const dim3 grid(static_cast<unsigned>(nblk * here)), block(kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = rank < 0 ? cudaLaunchCooperativeKernel(kKernels[op], grid, block, args,
                                             0, st)
               : cudaLaunchKernel(kKernels[op], grid, block, args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
