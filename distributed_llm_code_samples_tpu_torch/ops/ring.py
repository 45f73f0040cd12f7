"""Collectives over peer-mapped memory: the ring's one hop, all-reduce,
reduce-scatter and all-gather, the ``comm="pallas_ring"`` transport of
DDP and FSDP, and the dense all-to-all, the ``comm="pallas_a2a"``
transport of expert parallelism.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_ring.py``
(``ppermute_dma``, ``ring_all_reduce``, ``ring_reduce_scatter``,
``ring_all_gather``, ``all_to_all_dma``, ``all_to_all_dma_dims``), with
its conventions: chunks are the leading-dim n-split, the reduce-scatter
leaves summed chunk r on rank r, the all-gather puts rank i's block at
chunk i, the hop moves rank r's block to rank r+1, the all-to-all moves
chunk j of rank r to chunk r of rank j, and a leading dim that does not
split into n chunks raises. Each chunk is summed in the Pallas kernels'
ring order.

Each wrapper takes the tensor and the ring: a ``Ring`` (the ranks: ``n``,
this ``rank``, the ``torch.distributed`` group and, on the card, a
``PeerWorkspace`` or a ``Loopback``) or a rank's mesh view
(``parallel/mesh.py``), whose ``Ring`` it opens at first use, as the JAX
kernels take the axis name. On a CUDA tensor it launches its
kernel (``csrc/ring_collectives.cu``, built at first use by
``ops/_build.py``, bound with ctypes) or raises; on a CPU tensor it runs
its plain version, the same exchange on ``torch.distributed``
point-to-point (``*_ref``). There is no fallback from a kernel to the
plain version or to NCCL. ``loopback_ref`` computes the same results over
the n per-rank tensors of one process, the plain version of a loopback
call. The kernels and the plain versions add the same f32 pairs in the
same order, so they agree bit for bit; on bf16 tensors (``--dtype
bfloat16``) the all-reduce and the reduce-scatter round each add to
bf16, in that order on both sides, as the Pallas kernels' adds on bf16
refs do, and the hop, the all-gather and the all-to-all move the bf16
bytes as 4-byte words (a hop or all-to-all chunk of an odd element
count through copies padded by one element a chunk).

The kernels store into peers' workspaces, never into peers' tensors
(PyTorch's allocator does not map them to other processes): a
``PeerWorkspace`` is one ``cudaMalloc`` a rank, its CUDA IPC handle
crossing the process group, mapped by every other rank. In loopback
one process holds the n workspaces of n virtual ranks on one card, and a
call is one cooperative launch for all of them.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from . import _build

LIB = "ring_collectives"
HOP, ALL_REDUCE, REDUCE_SCATTER, ALL_GATHER, ALL_TO_ALL = (
    "ppermute_dma", "ring_all_reduce", "ring_reduce_scatter",
    "ring_all_gather", "all_to_all_dma")
_OPS = {HOP: 0, ALL_REDUCE: 1, REDUCE_SCATTER: 2, ALL_GATHER: 3,
        ALL_TO_ALL: 4}
# not kernels: a loopback mesh's ``torch.distributed`` collectives in
# plain torch (parallel/collectives.py), each over the ranks' dim-0
# tensors: the sum in rank order, the concatenation in rank order, the
# sum's block of each rank, the elementwise max, the ring's one hop
# (rank r's tensor to rank r+1, ``lax.ppermute``) and the dense
# all-to-all (chunk j of rank r to chunk r of rank j)
SUM, CAT, SUM_SCATTER, MAX, PERM, A2A = ("sum", "cat", "sum_scatter", "max",
                                         "perm", "a2a")
_PLAIN = (SUM, CAT, SUM_SCATTER, MAX, PERM, A2A)
# csrc/ring_common.cuh: kMaxRanks, kDataOff
_MAX_RANKS = 8
_DATA_OFF = 20480
# csrc/ring_common.cuh: kMaxBlocks, flag words a source rank
_MAX_BLOCKS = 64
# the hop splits its tensor into this many ranges (at most); a range is
# pushed to the right neighbour and copied out of the landing region by a
# block of its own: 2 * HOP_RANGES blocks a rank
HOP_RANGES = 64
_HOP_FLOATS_PER_RANGE = 4096
# the all-to-all splits a chunk into this many ranges (at most); a range
# is copied, pushed to each peer and copied out of the landing region by
# a block of its own: (2n - 1) * A2A_RANGES blocks a rank
A2A_RANGES = 32
_A2A_FLOATS_PER_RANGE = 4096
# the reduce-scatter's ranges a chunk (at most): a range is pushed to each
# peer by a block of its own, and every block then sums an n-th of its
# range: n * RS_RANGES blocks a rank
RS_RANGES = 32
_RS_FLOATS_PER_RANGE = 4096
# the all-reduce's ranges a chunk (at most): pushed and summed as the
# reduce-scatter's, and each block then copies out an n-th of its range
# of every peer's sum: n * AR_RANGES blocks a rank
AR_RANGES = 32
_AR_FLOATS_PER_RANGE = 4096
# a loopback call is one cooperative launch of n * (2n - 1) * ranges or
# n * n * ranges blocks, all resident at once: at most one a streaming
# multiprocessor (the hop's n * 2 * ranges: two, _hop_ranges)
_LOOPBACK_BLOCKS = 128
# how long a kernel waits for a neighbour before it gives up and leaves
# an error code (a late neighbour is seconds behind, a lost one forever)
WAIT_TIMEOUT_S = 30.0


# -- the workspace -----------------------------------------------------------

def _lib():
    lib = _build.load_library(LIB)
    if lib.ring_launch.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ring_launch.argtypes = [i, i, vp, vp, vp, i, i, ll, ll, ll, ll,
                                    i, i, i, ll, i, i, vp]
        for fn, args in (("ring_ws_alloc", [i, ll, vp]),
                         ("ring_ws_free", [i, vp]),
                         ("ring_ws_handle", [i, vp, vp]),
                         ("ring_ws_open", [i, vp, vp]),
                         ("ring_ws_close", [i, vp]),
                         ("ring_ws_error", [i, vp, vp]),
                         ("ring_a2a_trace", [i, vp])):
            getattr(lib, fn).argtypes = args
        for fn in ("ring_launch", "ring_ws_alloc", "ring_ws_free",
                   "ring_ws_handle", "ring_ws_open", "ring_ws_close",
                   "ring_ws_error", "ring_a2a_trace"):
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def describe_error(code: int) -> str:
    """The kernel's error word (``error_code`` in ring_common.cuh) in
    words."""
    op = (code >> 48) - 1
    step = ((code >> 32) & 0xFFFF) - 1
    names = {v: k for k, v in _OPS.items()}
    if step < _MAX_RANKS:
        where = f"rank {step}'s chunk"
    elif step < 2 * _MAX_RANKS:
        where = f"rank {step - _MAX_RANKS}'s release of its landing slot"
    else:
        where = f"rank {step - 2 * _MAX_RANKS}'s summed chunk"
    return (f"{names.get(op, op)} rank {(code & 0xFFFF) - 1} block "
            f"{((code >> 16) & 0xFFFF) - 1} gave up waiting at {where}")


class PeerWorkspace:
    """The collectives' peer memory on the card.

    ``PeerWorkspace(capacity, device, group=g)``: each rank of ``g``
    ``cudaMalloc``s one workspace (``csrc/ring_common.cuh`` has its
    layout: flag words, a data region of ``capacity`` bytes and as much
    again of staging slots), publishes its ``cudaIpcGetMemHandle`` over
    ``g`` and opens every other rank's handle (the hop stores into its
    right neighbour's, the other ops into every peer's), peer access
    enabled lazily. It raises if a peer's card has no peer access to
    this one: nothing goes through the host.

    ``PeerWorkspace(capacity, device, n=n)`` (loopback): n workspaces on
    one card in this process, for n virtual ranks.

    ``close()`` unmaps the neighbours' workspaces and frees this rank's
    (collective: every rank calls it). ``epoch`` counts the calls; every
    rank makes the same calls in the same order, so the epochs agree.
    """

    def __init__(self, capacity: int, device, group=None,
                 n: Optional[int] = None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a PeerWorkspace lives on a card, not "
                             f"{device}")
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        self.device = torch.device("cuda", self.index)
        self.capacity = -(-int(capacity) // 256) * 256
        self.stage_off = _DATA_OFF + self.capacity
        self.bytes = self.stage_off + self.capacity
        self.group = group
        self.loopback = group is None
        self.n = n if self.loopback else dist.get_world_size(group)
        if not 2 <= self.n <= _MAX_RANKS:
            raise ValueError(f"ring of {self.n} ranks: the kernels take 2 "
                             f"to {_MAX_RANKS}")
        self.rank = None if self.loopback else dist.get_rank(group)
        self.epoch = 0
        # the landing regions: their uses so far, and the epoch and the
        # ranges a chunk of the last call that used each region
        self.region_calls = 0
        self.region_last = [(0, 0), (0, 0)]
        self._own: list[int] = []      # cudaMalloc'd here
        self._opened: list[int] = []   # mapped from a peer's handle
        lib = _lib()
        try:
            for _ in range(self.n if self.loopback else 1):
                p = ctypes.c_void_p()
                _ok(lib.ring_ws_alloc(self.index, self.bytes,
                                      ctypes.byref(p)), "cudaMalloc")
                self._own.append(p.value)
            if self.loopback:
                self.peers = list(self._own)
            else:
                self.peers = self._exchange(lib)
        except BaseException:
            self._release(lib)
            raise
        self._table = (ctypes.c_ulonglong * self.n)(
            *[p or 0 for p in self.peers])

    def _exchange(self, lib) -> list:
        r, n = self.rank, self.n
        handle = ctypes.create_string_buffer(64)
        _ok(lib.ring_ws_handle(self.index, self._own[0], handle),
            "cudaIpcGetMemHandle")
        mine = (self.index, bytes(handle.raw))
        every = [None] * n
        dist.all_gather_object(every, mine, group=self.group)
        peers = [None] * n
        peers[r] = self._own[0]
        for j in (j for j in range(n) if j != r):
            dev, h = every[j]
            if dev != self.index and not torch.cuda.can_device_access_peer(
                    self.index, dev):
                raise RuntimeError(
                    f"rank {r} (cuda:{self.index}) has no peer access to "
                    f"rank {j} (cuda:{dev}); the ring kernels store over "
                    "NVLink/PCIe peer mappings and never through the host")
            p = ctypes.c_void_p()
            _ok(lib.ring_ws_open(self.index, ctypes.create_string_buffer(
                h, 64), ctypes.byref(p)),
                f"cudaIpcOpenMemHandle of rank {j}'s workspace")
            self._opened.append(p.value)
            peers[j] = p.value
        return peers

    def _release(self, lib) -> None:
        for p in self._opened:
            lib.ring_ws_close(self.index, p)
        for p in self._own:
            lib.ring_ws_free(self.index, p)
        self._opened, self._own = [], []

    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def errors(self) -> list[int]:
        """The error word of each workspace this process owns (after the
        card has finished its work); 0 where no wait gave up."""
        lib, out = _lib(), []
        for p in self._own:
            w = ctypes.c_ulonglong()
            _ok(lib.ring_ws_error(self.index, p, ctypes.byref(w)),
                "reading the ring's error word")
            out.append(w.value)
        return out

    def check(self) -> None:
        """Raise if a kernel's wait passed its deadline: a neighbour never
        came. Reads the error words, so it synchronises the card."""
        bad = [c for c in self.errors() if c]
        if bad:
            raise RuntimeError("ring collective timed out: "
                               + "; ".join(map(describe_error, bad)))

    def close(self) -> None:
        if not self._own:
            return
        lib = _lib()
        torch.cuda.synchronize(self.device)
        if not self.loopback:
            # no neighbour still stores into this rank's memory ...
            dist.barrier(group=self.group)
            for p in self._opened:
                lib.ring_ws_close(self.index, p)
            self._opened = []
            # ... and every neighbour has unmapped it before it is freed
            dist.barrier(group=self.group)
        self._release(lib)


def _plain(op: str, xs: list) -> list:
    """The plain collective ``op`` (``SUM``, ``CAT``, ``SUM_SCATTER``,
    ``MAX``, ``PERM``, ``A2A``) over one dim-0 tensor a rank: one output
    a rank, in rank order."""
    if op == PERM:
        return loopback_ref(HOP, xs)
    if op == A2A:
        return loopback_ref(ALL_TO_ALL, xs)
    if op == CAT:
        out = torch.cat(xs)
        return [out] + [out.clone() for _ in xs[1:]]
    total = xs[0].clone()
    for x in xs[1:]:
        if op == MAX:
            torch.maximum(total, x, out=total)
        else:
            total += x
    if op == SUM_SCATTER:
        return [c.clone() for c in total.chunk(len(xs))]
    return [total] + [total.clone() for _ in xs[1:]]


class Loopback:
    """n virtual ranks as n threads of one process on one card. Each
    collective call waits until all n threads have handed in their
    operands; one of them then makes the one cooperative launch that
    serves all n (or, for the plain collectives ``_PLAIN``, computes
    every output in plain torch), and each thread takes its own output.
    All threads use the device's default stream, so their work is ordered
    around the launch. The kernels need ``workspace``, a
    ``PeerWorkspace`` of n regions that its owner attaches; the plain
    collectives need none, and neither does a kernel's call on CPU
    tensors (n threads on the CPU), which runs ``loopback_ref``.
    ``abort()`` releases the threads waiting in a call (a rank that
    failed elsewhere)."""

    def __init__(self, n: int, timeout: float = 10 * WAIT_TIMEOUT_S):
        self.workspace: Optional[PeerWorkspace] = None
        self.n = n
        self._ops: list = [None] * self.n
        self._ins: list = [None] * self.n
        self._outs: list = []
        self._error: Optional[BaseException] = None
        self._barrier = threading.Barrier(self.n, action=self._launch,
                                          timeout=timeout)

    def _launch(self) -> None:
        try:
            if len(set(self._ops)) != 1:
                raise RuntimeError(f"loopback ranks called different "
                                   f"collectives: {self._ops}")
            if self._ops[0] in _PLAIN:
                self._outs = _plain(self._ops[0], self._ins)
            elif not _build.on_card(self._ops[0], *self._ins):
                # CPU threads: the kernel's plain version of the call
                self._outs = loopback_ref(self._ops[0], self._ins)
            elif self.workspace is None:
                raise RuntimeError(f"loopback {self._ops[0]} is a kernel: "
                                   "it needs the ranks' workspace")
            else:
                self._outs = loopback(self._ops[0], self._ins,
                                      self.workspace)
        except BaseException as e:
            self._error = e
            raise

    def call(self, op: str, x: torch.Tensor, rank: int) -> torch.Tensor:
        self._ops[rank], self._ins[rank] = op, x
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise RuntimeError(f"loopback {op} did not complete on rank "
                               f"{rank}") from self._error
        return self._outs[rank]

    def abort(self) -> None:
        self._barrier.abort()


@dataclass
class Ring:
    """The ranks of a ring collective: ``n``, this ``rank``, the
    ``torch.distributed`` group the plain version runs on, and on the card
    either the rank's ``PeerWorkspace`` or the process's ``Loopback``."""
    n: int
    rank: int
    group: Any = None
    workspace: Optional[PeerWorkspace] = None
    loopback: Optional[Loopback] = None


# -- the kernels -------------------------------------------------------------

def _ranges(chunk: int, most: int, floats: int, blocks_a_range: int,
            loopback: bool) -> int:
    """Ranges a chunk of a ring kernel splits into: at most ``most``, of
    at least ``floats`` floats, and in loopback few enough that the n
    ranks' ``blocks_a_range`` blocks for each stay resident."""
    cap = _MAX_BLOCKS
    if loopback:
        cap = min(cap, _LOOPBACK_BLOCKS // blocks_a_range)
    return max(1, min(most, cap, -(-chunk // floats)))


def _hop_ranges(chunk: int, n: int, loopback: bool) -> int:
    """Ranges the hop's tensor splits into (2 * ranges blocks a rank). Its
    blocks hold no shared memory and 40 registers a thread (ptxas), so
    two a streaming multiprocessor stay resident: a loopback launch of n
    * 2 * ranges blocks takes up to 2 * ``_LOOPBACK_BLOCKS``."""
    return _ranges(chunk, HOP_RANGES, _HOP_FLOATS_PER_RANGE, n, loopback)


def _a2a_ranges(chunk: int, n: int, loopback: bool) -> int:
    """Ranges a chunk of the all-to-all or the all-gather splits into
    ((2n - 1) * ranges blocks a rank)."""
    return _ranges(chunk, A2A_RANGES, _A2A_FLOATS_PER_RANGE,
                   n * (2 * n - 1), loopback)


def _rs_ranges(chunk: int, n: int, loopback: bool) -> int:
    """Ranges a chunk of the reduce-scatter splits into (n * ranges blocks
    a rank)."""
    return _ranges(chunk, RS_RANGES, _RS_FLOATS_PER_RANGE, n * n, loopback)


def _ar_ranges(chunk: int, n: int, loopback: bool) -> int:
    """Ranges a chunk of the all-reduce splits into (n * ranges blocks a
    rank); the pushes, the sums and the gather share them. Its blocks
    wait for each other's sums after their own, so a rank's launch must
    be resident at once across the cards too: at most
    ``_LOOPBACK_BLOCKS`` blocks, one a streaming multiprocessor."""
    ranges = _ranges(chunk, AR_RANGES, _AR_FLOATS_PER_RANGE, n * n,
                     loopback)
    return min(ranges, max(1, _LOOPBACK_BLOCKS // n))


def region_plan(calls: int, last):
    """Where a call lands, from the calls before it on its workspace:
    ``(region, prev)``. It takes region ``calls % 2`` (``calls``: the
    region uses so far, as ``region_record`` counts them; the all-reduce
    gathers in the other region), whose last user that peers release is
    ``prev = last[region]`` as ``(epoch, ranges)`` (``(0, 0)``: none)."""
    region = calls % 2
    return region, tuple(last[region])


def region_record(op: str, calls: int, last, epoch: int, ranges: int):
    """The bookkeeping after a call of ``op`` at ``epoch`` that split its
    chunks into ``ranges``: the new ``(calls, last)``. A call records
    ``(epoch, ranges)`` for its region, whose slots its receivers
    release, and counts one use. Each receiver releases a range to every
    peer once it has read that range of every slot it holds (the hop's
    one slot too; csrc/ring_collectives.cu, "The releases"), so a later
    call's wait for one peer's release covers all that peer holds there
    from this call and the ones before. The all-reduce counts two: its
    pushes' region is free once the call has ended on the sender (every
    peer's sums, which read it, come before the gathered flags the sender
    waits for), so it records ``(0, 0)`` there, and ``(epoch, ranges)``
    for its gather's region, which the copy-outs release."""
    last = [tuple(x) for x in last]
    region = calls % 2
    if op == ALL_REDUCE:
        last[region], last[1 - region] = (0, 0), (epoch, ranges)
        return calls + 2, last
    last[region] = (epoch, ranges)
    return calls + 1, last


def _out_shape(op: str, shape, n: int):
    if op == REDUCE_SCATTER:
        return (shape[0] // n,) + tuple(shape[1:])
    if op == ALL_GATHER:
        return (n * shape[0],) + tuple(shape[1:])
    return tuple(shape)


def _chunk(op: str, numel: int, n: int) -> int:
    return numel if op in (HOP, ALL_GATHER) else numel // n


def _words(ts, op: str = ALL_GATHER, n: int = 1) -> list:
    """bf16 tensors as the float32 words of the same bytes: the kernels
    move 4-byte words, and the sums add the two bf16 elements of each
    (csrc/ring_collectives.cu), so the output has the bits of the plain
    version's. Each chunk must hold an even number of elements (a word
    must not straddle two chunks)."""
    for t in ts:
        per = t.numel() // n if op in (ALL_REDUCE, REDUCE_SCATTER) \
            else t.numel()
        if per % 2:
            raise ValueError(f"a bf16 {op} moves 4-byte words: a chunk of "
                             f"{tuple(t.shape)} over {n} ranks has an odd "
                             f"number of elements ({per})")
    return [t.reshape(-1).view(torch.float32) for t in ts]


def _parts(op: str, n: int) -> int:
    """The chunks a hop's or an all-to-all's tensor splits into."""
    return n if op == ALL_TO_ALL else 1


def _odd(op: str, x: torch.Tensor, n: int) -> bool:
    """Whether a bf16 hop or all-to-all of ``x`` has chunks of an odd
    element count, which move through copies padded by one element a
    chunk (``_launch``)."""
    return (x.dtype == torch.bfloat16 and op in (HOP, ALL_TO_ALL)
            and x.numel() // _parts(op, n) % 2 == 1)


def _padded(t: torch.Tensor, parts: int) -> torch.Tensor:
    """``t`` as ``[parts, chunk + 1]``: each chunk and one zero after it."""
    return torch.nn.functional.pad(t.reshape(parts, -1), (0, 1))


def _launch(op: str, ins, outs, ws: PeerWorkspace, rank: int) -> None:
    """One launch over ``ws`` (``rank < 0``: loopback, one input and
    output a rank); counts one launch of ``op``, or of ``op[bf16]`` on bf16
    tensors (the hop's, the all-gather's and the all-to-all's moved as
    bytes, the all-reduce's and the reduce-scatter's summed in bf16). A
    bf16 hop or all-to-all whose chunks hold an odd element count moves
    copies of its chunks padded by one element each, and its outputs are
    copied out of the padded ones after the launch."""
    count_as = op
    bf16 = ins[0].dtype == torch.bfloat16
    staged = None
    if _odd(op, ins[0], ws.n):
        parts = _parts(op, ws.n)
        staged = outs
        ins = [_padded(t, parts) for t in ins]
        outs = [torch.empty_like(t) for t in ins]
    if bf16:
        ins, outs = _words(ins, op, ws.n), _words(outs, op)
        count_as = op + "[bf16]"
    n = ws.n
    chunk = _chunk(op, ins[0].numel(), n)
    need = workspace_bytes(op, ins[0], n)
    if need > ws.capacity:
        raise ValueError(f"{op} of {tuple(ins[0].shape)} needs {need} "
                         f"bytes of workspace, it has {ws.capacity}")
    ptrs = [t.data_ptr() for t in list(ins) + list(outs)]
    vec = int(chunk % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    as_table = lambda ts: (ctypes.c_ulonglong * len(ts))(  # noqa: E731
        *[t.data_ptr() for t in ts])
    stream = torch.cuda.current_stream(ws.device).cuda_stream
    epoch = ws.next_epoch()
    if op in (ALL_TO_ALL, ALL_GATHER):
        nblk = _a2a_ranges(chunk, n, rank < 0)
    elif op == REDUCE_SCATTER:
        nblk = _rs_ranges(chunk, n, rank < 0)
    elif op == ALL_REDUCE:
        nblk = _ar_ranges(chunk, n, rank < 0)
    else:
        nblk = _hop_ranges(chunk, n, rank < 0)
    region, prev = region_plan(ws.region_calls, ws.region_last)
    rc = _lib().ring_launch(
        ws.index, _OPS[op], ws._table, as_table(ins), as_table(outs), n,
        rank, chunk, ws.stage_off, epoch, int(WAIT_TIMEOUT_S * 1e9), nblk,
        vec, int(bf16 and op in (ALL_REDUCE, REDUCE_SCATTER)), *prev,
        region, stream)
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")
    ws.region_calls, ws.region_last = region_record(
        op, ws.region_calls, ws.region_last, epoch, nblk)
    _build.count_launch(count_as)
    if staged is not None:
        for o, p in zip(staged, outs):
            padded = p.view(torch.bfloat16).reshape(parts, -1)
            o.copy_(padded[:, :-1].reshape(o.shape))


def _check_split(op: str, x: torch.Tensor, n: int) -> None:
    if op in (ALL_REDUCE, REDUCE_SCATTER) and x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by ring "
                         f"size {n} (chunk unit of the ring)")
    if op == ALL_TO_ALL and (x.ndim == 0 or x.shape[0] % n):
        raise ValueError(f"leading dim {x.shape[0] if x.ndim else None} not "
                         f"divisible by {n} peers (the split unit of "
                         "all_to_all)")


def loopback(op: str, xs, ws: PeerWorkspace) -> list:
    """One collective over the n virtual ranks of a loopback workspace:
    ``xs`` holds one tensor a rank; returns one output a rank."""
    xs = list(xs)
    n = ws.n
    if len(xs) != n:
        raise ValueError(f"loopback {op} takes {n} tensors, got {len(xs)}")
    if len({(tuple(x.shape), x.dtype) for x in xs}) != 1:
        raise ValueError(f"loopback {op}: the ranks' tensors differ in "
                         "shape or type")
    for x in xs:
        _build.on_card(op, x)
        if x.device != ws.device:
            raise ValueError(f"{op}: tensor on {x.device}, workspace on "
                             f"{ws.device}")
    _check_split(op, xs[0], n)
    outs = [torch.empty(_out_shape(op, x.shape, n), dtype=x.dtype,
                        device=x.device) for x in xs]
    _launch(op, xs, outs, ws, -1)
    return outs


def workspace_bytes(op: str, x: torch.Tensor, n: int) -> int:
    """The workspace a call of ``op`` on ``x`` over n ranks needs (its
    ``capacity``: the data region and the staging slots have as much
    each): either region holds the hop's block (one slot), the incoming
    chunks of the all-to-all and of the all-gather (a chunk
    slot for each rank, at the rank's offset: n shards for the
    all-gather), of the reduce-scatter (n-1 chunk slots), and of the
    all-reduce (n-1 pushed chunk slots in one region, n summed ones in
    the other: the tensor). A bf16 hop or all-to-all of odd chunks needs
    room for their padded copies (``_launch``)."""
    nbytes = (x.numel() + (_parts(op, n) if _odd(op, x, n) else 0)) \
        * x.element_size()
    return {HOP: nbytes, ALL_REDUCE: nbytes, ALL_GATHER: n * nbytes,
            ALL_TO_ALL: nbytes, REDUCE_SCATTER: (n - 1) * nbytes // n}[op]


def _as_ring(op: str, x: torch.Tensor, ring) -> Ring:
    """``ring`` itself, or the ``Ring`` of a rank's mesh view (opened
    with room for this call at its first use; the all-to-all's users
    launch no ring kernel, so it opens without the one-hop probe)."""
    if isinstance(ring, Ring):
        return ring
    return ring.ring(workspace_bytes(op, x, ring.size),
                     probe=op != ALL_TO_ALL)


def _collective(op: str, x: torch.Tensor, ring) -> torch.Tensor:
    n = ring.n if isinstance(ring, Ring) else ring.size
    _check_split(op, x, n)
    if n == 1:
        return x
    ring = _as_ring(op, x, ring)
    if ring.loopback is not None:
        return ring.loopback.call(op, x, ring.rank)
    if not _build.on_card(op, x):
        return _REFS[op](x, ring)
    ws = ring.workspace
    if ws is None:
        raise RuntimeError(f"{op} on the card needs the ring's "
                           "PeerWorkspace (Ring.workspace)")
    if x.device != ws.device:
        raise ValueError(f"{op}: tensor on {x.device}, workspace on "
                         f"{ws.device}")
    out = torch.empty(_out_shape(op, x.shape, n), dtype=x.dtype,
                      device=x.device)
    _launch(op, [x], [out], ws, ring.rank)
    return out


def ppermute_dma(x: torch.Tensor, ring) -> torch.Tensor:
    """One ring hop: rank r's block lands on rank ``(r+1) % n``
    (``lax.ppermute(perm=[(i, (i+1) % n)])``). The kernel pushes it into
    the neighbour's landing region, range by range, and the neighbour
    copies each range out as it lands; the plain version is one
    ``isend``/``irecv`` pair. It takes float32 or bf16 (any element
    count: bf16 as the float32 words of its bytes, counted as
    ``ppermute_dma[bf16]``)."""
    return _collective(HOP, x, ring)


def ring_all_reduce(x: torch.Tensor, ring) -> torch.Tensor:
    """The sum over the ranks (``lax.psum``), each chunk summed in the
    ring's order. The kernel is one launch: every chunk pushed to its
    owner, summed there, and pushed on to every peer; the plain version
    is the 2(n-1)-step ring (reduce-scatter, then all-gather).
    ``x.shape[0]`` must divide by n."""
    return _collective(ALL_REDUCE, x, ring)


def ring_reduce_scatter(x: torch.Tensor, ring) -> torch.Tensor:
    """``reduce_scatter(x, dim=0)``: rank r returns the summed chunk r,
    ``[rows / n, ...]``. ``x.shape[0]`` must divide by n."""
    return _collective(REDUCE_SCATTER, x, ring)


def ring_all_gather(x: torch.Tensor, ring) -> torch.Tensor:
    """``all_gather(x, dim=0)``: ``[n * rows, ...]`` with chunk i rank
    i's block. The kernel is the all-to-all's push with one source for
    every peer (``all_to_all_kernel<true>``); the plain version is the
    ring of hops. It takes float32 or bf16 (FSDP's ``mixed`` gathers);
    a bf16 tensor (an even number of elements) reaches the same kernel
    as the float32 words of its bytes, and its launches count as
    ``ring_all_gather[bf16]``."""
    return _collective(ALL_GATHER, x, ring)


def all_to_all_dma(x: torch.Tensor, ring) -> torch.Tensor:
    """The dense all-to-all over the leading dim (``all_to_all(x,
    split_dim=0, concat_dim=0)``): chunk j of rank r lands at chunk r of
    rank j, each (source, destination) pair a direct store. ``x.shape[0]``
    must divide by n. It takes float32 or bf16 (bf16 as the float32 words
    of its bytes, counted as ``all_to_all_dma[bf16]``; chunks of any
    element count)."""
    return _collective(ALL_TO_ALL, x, ring)


# phases a block stamps when traced (csrc/ring_collectives.cu, kStamps):
# the all-to-all's and the hop's own-chunk and pushing blocks the first
# three, their copy-out blocks "entry", "arrived" and "released"; the
# all-reduce's blocks also "copied"
A2A_PHASES = ("entry", "start", "pushed", "arrived", "released", "copied")


def traced(call, device) -> torch.Tensor:
    """Run ``call()`` (one launch of a ring kernel on ``device``) with the
    kernel's trace on: returns ``[blocks, len(A2A_PHASES)]`` int64
    %globaltimer stamps in ns (0 where a block has no such phase; the
    all-gather's and the hop's blocks stamp as the all-to-all's; every
    block of the reduce-scatter and of the all-reduce sums, so each
    stamps "arrived"
    and "released" (the all-reduce's: its sums stored on to every peer
    and flagged), and their pushing blocks also "start" and "pushed";
    the all-reduce's blocks stamp "copied" once their part of every
    peer's sum is copied out)."""
    device = torch.device(device)
    lib = _lib()
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    # a row for each block of the largest launch
    stamps = torch.zeros((2 * _MAX_RANKS - 1) * _MAX_BLOCKS, len(A2A_PHASES),
                         dtype=torch.int64, device=device)
    _ok(lib.ring_a2a_trace(index, stamps.data_ptr()), "tracing")
    try:
        call()
        torch.cuda.synchronize(device)
    finally:
        _ok(lib.ring_a2a_trace(index, None), "tracing")
    return stamps[stamps[:, 0] > 0]


def tiled_all_to_all(x: torch.Tensor, ring, split_dim: int, concat_dim: int,
                     exchange=all_to_all_dma) -> torch.Tensor:
    """``exchange`` (a dim-0 all-to-all) in the tiled form: ``split_dim``
    splits into n blocks, block j goes to rank j, and the n received
    blocks concatenate along ``concat_dim`` in rank order."""
    n = ring.n if isinstance(ring, Ring) else ring.size
    if n == 1:
        return x
    xm = x.movedim(split_dim, 0).contiguous()
    k = exchange(xm, ring)
    kb = k.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
    return torch.cat([kb[j].movedim(0, split_dim) for j in range(n)],
                     dim=concat_dim)


class _AllToAllDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, split_dim, concat_dim):
        ctx.ring, ctx.dims = ring, (split_dim, concat_dim)
        return tiled_all_to_all(x, ring, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, dy):
        split_dim, concat_dim = ctx.dims
        return (all_to_all_dma_dims(dy, ctx.ring, concat_dim, split_dim),
                None, None, None)


def all_to_all_dma_dims(x: torch.Tensor, ring, split_dim: int,
                        concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all of ``split_dim`` into ``concat_dim`` over the
    ``all_to_all_dma`` kernel (``pallas_ring.py:571``): the split dim
    moves to the front for the dim-0 exchange and the received blocks
    concatenate along ``concat_dim``. Differentiable: its backward is the
    same exchange with the dims swapped. (The expert-parallel step calls
    the exchanges from the rank's own thread instead: a loopback rank
    must not block PyTorch's one autograd thread of the card.)"""
    return _AllToAllDims.apply(x, ring, split_dim, concat_dim)


# -- plain versions ----------------------------------------------------------

def _hop(send: torch.Tensor, recv: torch.Tensor, ring: Ring) -> None:
    """Send ``send`` to the right neighbour while ``recv`` fills from the
    left one (one batch, so NCCL cannot deadlock on a 2-ring)."""
    r, n = ring.rank, ring.n
    ops = [dist.P2POp(dist.isend, send, (r + 1) % n, group=ring.group),
           dist.P2POp(dist.irecv, recv, (r - 1) % n, group=ring.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ppermute_dma_ref(x: torch.Tensor, ring) -> torch.Tensor:
    ring = _as_ring(HOP, x, ring)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _hop(x.contiguous(), out, ring)
    return out


def _reduce_phase(acc: torch.Tensor, v: int, ring: Ring) -> None:
    """The reduce phase on ``acc [n, chunk]`` with virtual rank ``v``: at
    step s send chunk (v - s) mod n, add what arrives to chunk
    (v - s - 1) mod n (own + received, the kernel's f32 add)."""
    n = ring.n
    buf = torch.empty_like(acc[0])
    for s in range(n - 1):
        _hop(acc[(v - s) % n], buf, ring)
        acc[(v - s - 1) % n] += buf


def ring_all_reduce_ref(x: torch.Tensor, ring) -> torch.Tensor:
    ring = _as_ring(ALL_REDUCE, x, ring)
    n, r = ring.n, ring.rank
    _check_split(ALL_REDUCE, x, n)
    acc = x.contiguous().clone().reshape(n, -1)
    _reduce_phase(acc, r, ring)
    buf = torch.empty_like(acc[0])
    for s in range(n - 1):
        _hop(acc[(r + 1 - s) % n], buf, ring)
        acc[(r - s) % n] = buf
    return acc.reshape(x.shape)


def ring_reduce_scatter_ref(x: torch.Tensor, ring) -> torch.Tensor:
    ring = _as_ring(REDUCE_SCATTER, x, ring)
    n, r = ring.n, ring.rank
    _check_split(REDUCE_SCATTER, x, n)
    acc = x.contiguous().clone().reshape(n, -1)
    _reduce_phase(acc, (r - 1) % n, ring)
    return acc[r].reshape(_out_shape(REDUCE_SCATTER, x.shape, n))


def ring_all_gather_ref(x: torch.Tensor, ring) -> torch.Tensor:
    ring = _as_ring(ALL_GATHER, x, ring)
    n, r = ring.n, ring.rank
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[r] = x
    for s in range(n - 1):
        _hop(out[(r - s) % n], out[(r - s - 1) % n], ring)
    return out.reshape(_out_shape(ALL_GATHER, x.shape, n))


def all_to_all_dma_ref(x: torch.Tensor, ring) -> torch.Tensor:
    """The all-to-all as n-1 ``isend``/``irecv`` pairs in one batch: chunk
    j to rank j, rank j's chunk r into chunk j."""
    ring = _as_ring(ALL_TO_ALL, x, ring)
    n, r = ring.n, ring.rank
    _check_split(ALL_TO_ALL, x, n)
    src = x.contiguous().reshape(n, -1)
    out = torch.empty_like(src)
    out[r] = src[r]
    ops = []
    for j in (j for j in range(n) if j != r):
        ops += [dist.P2POp(dist.isend, src[j], j, group=ring.group),
                dist.P2POp(dist.irecv, out[j], j, group=ring.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.reshape(x.shape)


_REFS = {HOP: ppermute_dma_ref, ALL_REDUCE: ring_all_reduce_ref,
         REDUCE_SCATTER: ring_reduce_scatter_ref,
         ALL_GATHER: ring_all_gather_ref, ALL_TO_ALL: all_to_all_dma_ref}


def loopback_ref(op: str, xs) -> list:
    """The plain version of ``loopback``: the same sums in the same ring
    order, or the same chunks moved, over the n per-rank tensors of one
    process."""
    xs = list(xs)
    n = len(xs)
    _check_split(op, xs[0], n)
    if op == HOP:
        return [xs[(r - 1) % n].clone() for r in range(n)]
    if op == ALL_TO_ALL:
        parts = [x.contiguous().reshape(n, -1) for x in xs]
        return [torch.stack([parts[j][r] for j in range(n)]).reshape(
            xs[0].shape) for r in range(n)]
    if op == ALL_GATHER:
        full = torch.cat([x.contiguous() for x in xs])
        return [full.clone() for _ in range(n)]
    parts = [x.contiguous().reshape(n, -1) for x in xs]

    def summed(c: int, start: int):
        # chunk c starts at rank `start`; each next rank adds its own copy
        acc = parts[start][c].clone()
        for k in range(1, n):
            acc = parts[(start + k) % n][c] + acc
        return acc

    if op == ALL_REDUCE:
        full = torch.stack([summed(c, c) for c in range(n)]).reshape(
            xs[0].shape)
        return [full.clone() for _ in range(n)]
    shape = _out_shape(op, xs[0].shape, n)
    return [summed(r, (r + 1) % n).reshape(shape) for r in range(n)]
