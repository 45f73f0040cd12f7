"""The tied LM head and its cross-entropy in hand-written kernels: the
forward's per-row statistics and the backward's two gradients, with the
``[N, V]`` logits never stored whole (the forward keeps none, the
backward one bounded chunk of their gradient at a time). The training
path's ``head_impl="fused"``.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_xent.py``
(``head_xent_stats``, ``head_xent_fwd``, ``head_xent_bwd``,
``head_xent``). On a CUDA tensor each wrapper launches its CUDA kernels
(``csrc/head_xent_fwd.cu``'s sliced statistics and merge, on the GEMM
core of ``csrc/gemm_core.cuh`` in f32 and on the tensor cores with bf16
operands, ``csrc/tc_core.cuh``; ``csrc/head_xent_bwd.cu``'s chunked
products, on that core in f32 and on the tensor cores with bf16
operands, ``csrc/ffn_wgmma.cuh``; built at first use by
``ops/_build.py``, bound with ctypes) or raises; on a CPU tensor it
runs its plain PyTorch version ``*_ref``. There is no fallback from a
kernel to its plain version.

``h [N, d]``, ``w [V, d]`` (the tied embedding), ``targets [N]`` int. A
target outside ``[0, V)`` matches no column. The kernels mask the vocab
edge themselves, so the caller's ``w`` is never padded (the JAX package
pads it to its vocab tile). ``mxu_bf16`` rounds h and w, and the logit
gradient before its products, to bf16; sums and statistics stay f32.
Default off.

On bf16 storage (``h`` and ``w`` bf16, the LM's ``--dtype bfloat16``)
each function computes what the Pallas kernels compute on bf16 arrays:
the logits in f32 from the exact bf16 values (``preferred_element_type
=jnp.float32``), ``lse`` and ``tz`` f32, the logit gradient rounded to
bf16 before both products (``dz.astype(w.dtype)``, whatever
``mxu_bf16`` says), the products summed in f32 and ``dh``, ``dw``
rounded to bf16 once. The kernels count their launches as
``head_xent_stats[bf16]`` and ``head_xent_bwd[bf16]``. ``dy * dh`` with
the f32 scalar ``dy`` keeps bf16 (where JAX's wrapper promotes both
gradients to f32).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
# the GEMM core's (csrc/gemm_core.cuh) tile and blocks an SM, shared
# with the FFN kernels, and the tensor-core passes' (csrc/tc_core.cuh)
# tile, row rule, staging rule and scratch layout
from .fused_ffn import (BLOCKS_PER_SM, H100_SMS, TC_BM, TC_BN, TC_ROW, TILE,
                        _layout, _sms, _tc_layout, _up, tc_staged)

FWD, BWD = "head_xent_fwd", "head_xent_bwd"
STATS_COUNT, BWD_COUNT = "head_xent_stats", "head_xent_bwd"


def _op(t: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if mxu_bf16 else t


def _widen(t: torch.Tensor) -> torch.Tensor:
    """bf16 storage as f32, exactly; f32 as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _target_logit(z, targets):
    """``z[i, t_i]`` where ``0 <= t_i < V``, else 0."""
    t = targets.long()
    valid = (t >= 0) & (t < z.shape[-1])
    tz = torch.gather(z, -1, torch.where(valid, t, 0)[:, None])[:, 0]
    return torch.where(valid, tz, torch.zeros((), dtype=z.dtype,
                                              device=z.device))


# -- plain versions --------------------------------------------------------

def head_xent_stats_ref(h, w, targets, *, mxu_bf16: bool = False):
    """``(lse [N], tz [N])``: ``logsumexp(h w^T)`` per row and the target
    logit (0 for a target outside ``[0, V)``); f32 also on bf16
    storage."""
    z = _op(_widen(h), mxu_bf16) @ _op(_widen(w), mxu_bf16).T
    m = z.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(z - m).sum(dim=-1, keepdim=True)))[:, 0]
    return lse, _target_logit(z, targets)


def head_xent_bwd_ref(dy, h, w, targets, lse, *, mxu_bf16: bool = False):
    """``(dh, dw) = dy * (dz w, dz^T h)`` with ``dz = (exp(h w^T - lse) -
    onehot(targets)) / N``; on bf16 storage ``dz`` is rounded to bf16
    before the f32 products and each product once after them."""
    store = h.dtype
    hm, wm = _op(_widen(h), mxu_bf16), _op(_widen(w), mxu_bf16)
    z = hm @ wm.T
    n, v = z.shape
    cols = torch.arange(v, device=z.device)
    onehot = (cols[None, :] == targets.long()[:, None]).to(z.dtype)
    dz = (torch.exp(z - lse[:, None]) - onehot) * (1.0 / n)
    dz = _widen(dz.to(store)) if store == torch.bfloat16 else _op(dz, mxu_bf16)
    return dy * (dz @ wm).to(store), dy * (dz.T @ hm).to(store)


# -- the kernels -----------------------------------------------------------

def _check(h, w, targets):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"h [N, d] and w [V, d] expected, got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    if h.dtype != w.dtype:
        raise ValueError(f"h and w must share one storage type, got "
                         f"{h.dtype} and {w.dtype}")
    if targets.shape != (h.shape[0],):
        raise ValueError(f"targets {tuple(targets.shape)} must be "
                         f"[{h.shape[0]}]")
    if min(h.shape[0], h.shape[1], w.shape[0]) < 1:
        raise ValueError("N, d and V must be at least 1")
    if targets.device != h.device:
        raise ValueError(f"targets must be on {h.device}")
    return h.shape[0], h.shape[1], w.shape[0]


def _targets32(targets):
    return targets.to(torch.int32).contiguous()


def _mode(h, mxu_bf16: bool) -> tuple[int, str]:
    """The kernels' mode (0 f32, 1 f32 with bf16 operands, 2 bf16
    storage) and the suffix its launches count under."""
    if h.dtype == torch.bfloat16:
        return 2, "[bf16]"
    return int(bool(mxu_bf16)), ""


# -- the statistics' plan and scratch (csrc/head_xent_fwd.cu) ---------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stats_plan(n: int, v: int, sms: int = H100_SMS):
    """``(S, L)``: the statistics kernel's vocabulary cut into S slices of
    L columns (L a multiple of ``TILE``, the last slice shorter; S =
    ceil(V / L)): as many slices as let its ``ceil(N / TILE) * S``
    blocks fit one wave of the card's ``sms * BLOCKS_PER_SM`` block
    slots, at least one and at most one a vocab tile. 64 row tiles x 4
    slices at the main shape."""
    vt = _cdiv(v, TILE)
    want = max(1, min(sms * BLOCKS_PER_SM // _cdiv(n, TILE), vt))
    per = _cdiv(vt, want)
    return _cdiv(vt, per), per * TILE


def stats_scratch(n: int, d: int, v: int, plan) -> dict:
    """The statistics kernel's scratch pieces (``fused_ffn._layout``):
    ``h^T`` as ``[d, N4]``, ``w^T`` as ``[d, V4]`` (4-rounded rows) and
    the slices' partials ``[3, S, N]`` (max, sum of exp, target
    logit)."""
    return _layout({"hT": (d, _up(n, 4)), "wT": (d, _up(v, 4)),
                    "part": (3, plan[0], n)})


def _staged_pieces(n: int, d: int, v: int, staged) -> dict:
    """The staged bf16 copies of h and w that both tensor-core kernels
    take first: ``hs [N, d8]``, ``ws [V, d8]`` where ``staged`` names
    them (``tc_staged``), 2 bytes an element."""
    d8 = _up(d, TC_ROW)
    return {k: (shape, 2) for k, shape in (("hs", (n, d8)), ("ws", (v, d8)))
            if k in staged}


def stats_tc_plan(n: int, v: int, sms: int = H100_SMS):
    """``(S, L)``: the tensor-core statistics' vocabulary cut into S
    slices of L columns (L a multiple of ``TC_BN``, the last slice
    shorter; S = ceil(V / L)). A work item is one (row tile of
    ``TC_BM``, slice), and the card's ``sms`` persistent blocks take the
    items in turn, one a block at a time, so a block's work is at most
    ceil(R * S / sms) items of L / TC_BN tiles (R row tiles). The plan
    takes the slices that make that least, and of those the widest (the
    fewest partials to merge): 33 slices of 6 tiles at the main shape
    (64 x 33 = 2112 items, 16 whole rounds of an H100's 132 SMs), 2 of
    25 on one TP rank's 12576 rows (128 items, one round)."""
    rows, vt = _cdiv(n, TC_BM), _cdiv(v, TC_BN)
    best = None
    for per in range(1, vt + 1):
        s = _cdiv(vt, per)
        if _cdiv(vt, s) != per:           # the same slices as a wider per
            continue
        cost = _cdiv(rows * s, sms) * per
        if best is None or cost <= best[0]:
            best = (cost, s, per)
    return best[1], best[2] * TC_BN


def stats_tc_scratch(n: int, d: int, v: int, plan, staged=()) -> dict:
    """The tensor-core statistics' scratch (``fused_ffn._tc_layout``, in
    ``head_xent_stats_tc_launch``'s pointer order): the staged bf16
    copies (``tc_staged``: ``hs [N, d8]``, ``ws [V, d8]``) and the
    slices' f32 partials ``part [3, S, N]``."""
    pieces = _staged_pieces(n, d, v, staged)
    pieces["part"] = ((3, plan[0], n), 4)
    return _tc_layout(pieces)


_STATS_TC_PIECES = ("hs", "ws", "part")


def head_xent_stats(h, w, targets, *, mxu_bf16: bool = False):
    """``(lse [N], tz [N])``: one block per (row tile, vocab slice) folds
    each logit tile into running statistics, then a merge over the
    slices (``csrc/head_xent_fwd.cu``). f32 (mode 0): h and w copied into
    the GEMM core's operand layout, the slices of ``stats_plan``, the
    scratch (``stats_scratch``) one f32 buffer. With bf16 operands
    (``mxu_bf16``, or bf16 storage) on the tensor cores: TMA reads h and
    w (or their staged bf16 copies, ``tc_staged``), the slices of
    ``stats_tc_plan``, the scratch (``stats_tc_scratch``) one byte
    buffer. CPU tensors run ``head_xent_stats_ref``."""
    n, d, v = _check(h, w, targets)
    if not _build.on_card(FWD, h, w):
        return head_xent_stats_ref(h, w, targets, mxu_bf16=mxu_bf16)
    t32 = _targets32(targets)
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    tz = torch.empty_like(lse)
    ptrs = [h.data_ptr(), w.data_ptr(), t32.data_ptr(), lse.data_ptr(),
            tz.data_ptr()]
    mode, suffix = _mode(h, mxu_bf16)
    if mode:
        plan = stats_tc_plan(n, v, _sms(h))
        staged = tc_staged(mode, {"hs": (h.data_ptr(), d),
                                  "ws": (w.data_ptr(), d)})
        pieces = stats_tc_scratch(n, d, v, plan, staged)
        scratch = torch.empty(pieces["total"], dtype=torch.uint8,
                              device=h.device)
        base = scratch.data_ptr()
        ptrs += [base + pieces[p][1] if p in pieces else 0
                 for p in _STATS_TC_PIECES]
        _build.launch(FWD, "head_xent_stats_tc_launch", ptrs,
                      (n, d, v, *plan, mode, _sms(h)), h.device,
                      STATS_COUNT + suffix)
        return lse, tz
    plan = stats_plan(n, v, _sms(h))
    pieces = stats_scratch(n, d, v, plan)
    scratch = torch.empty(pieces.pop("total"), dtype=torch.float32,
                          device=h.device)
    base = scratch.data_ptr()
    _build.launch(FWD, "head_xent_stats_launch",
                  ptrs + [base + 4 * off for _, off in pieces.values()],
                  (n, d, v, *plan, 0), h.device, STATS_COUNT)
    return lse, tz


def head_xent_fwd(h, w, targets, *, mxu_bf16: bool = False):
    """``(loss, lse)``: ``mean_i(lse_i - tz_i)``; lse is the backward's
    one softmax residual."""
    lse, tz = head_xent_stats(h, w, targets, mxu_bf16=mxu_bf16)
    return (lse - tz).mean(), lse


# -- the backward's chunks and scratch (csrc/head_xent_bwd.cu) --------------

# mode 0 (f32): the most vocabulary columns a chunk (kMaxChunk)
BWD_MAX_CHUNK = 8192
# modes 1 and 2 (the tensor cores): the most vocabulary columns a chunk.
# At the main shape it gives 6 chunks of 8448 columns (the last 8064):
# each chunk's 192 dh tiles and 198 dw tiles fill 2.95 rounds of an
# H100's 132 SMs, and dz takes 138 MB of scratch. On an H100 at the main
# shape (chip_smoke.py's head-tc-chunks, PERF.md) it ran within 1% of
# the fastest chunk, 25344, with a third of its scratch; 2048 ran 41%
# slower, one chunk of the whole vocabulary 9%.
HEAD_TC_CHUNK = 8448


def bwd_scratch_floats(n: int, d: int, v: int) -> int:
    """Floats of mode 0's scratch (``head_xent_bwd_scratch_floats``):
    ``h^T [d, N4]``, ``h [N, d4]``, ``w^T [d, V4]``, ``w [V, d4]``, and
    one chunk's ``dz [N, width]`` and ``dz^T [width, N4]`` (4-rounded
    rows; chunks of equal width, a multiple of the GEMM tile)."""
    n4, d4, v4 = _up(n, 4), _up(d, 4), _up(v, 4)
    k = _cdiv(v, BWD_MAX_CHUNK)
    width = _up(_cdiv(v, k), TILE)
    return d * n4 + n * d4 + d * v4 + v * d4 + n * width + width * n4


def head_tc_plan(v: int, chunk: int | None = None):
    """``(chunks, width)``: the tensor-core backward's vocabulary in
    chunks of ``width`` columns (a multiple of the tile width TC_BN, the
    last chunk shorter), as few as keep each at most ``chunk`` wide
    (``HEAD_TC_CHUNK`` by default; one chunk when V is under one
    tile)."""
    chunk = HEAD_TC_CHUNK if chunk is None else chunk
    k = _cdiv(v, max(chunk, TC_BN))
    width = _up(_cdiv(v, k), TC_BN)
    return _cdiv(v, width), width


def head_tc_chunks(v: int, plan) -> list[tuple[int, int]]:
    """The column range ``[v0, v1)`` of each chunk of ``plan``, in the
    order the kernel walks them (and adds them into ``dh``)."""
    return [(v0, min(v, v0 + plan[1])) for v0 in range(0, v, plan[1])]


def head_tc_scratch(n: int, d: int, v: int, plan, mode: int,
                    staged=()) -> dict:
    """The tensor-core backward's scratch (``fused_ffn._tc_layout``, in
    ``head_xent_bwd_tc_launch``'s pointer order): the staged bf16 copies
    (``tc_staged``: ``hs [N, d8]``, ``ws [V, d8]``), one chunk's ``dz`` as
    bf16 ``[N, width8]`` and, on bf16 storage (mode 2), dh's f32 sum
    ``dh32 [N, d]``."""
    pieces = _staged_pieces(n, d, v, staged)
    pieces["dz"] = ((n, _up(plan[1], TC_ROW)), 2)
    if mode == 2:
        pieces["dh32"] = ((n, d), 4)
    return _tc_layout(pieces)


_TC_PIECES = ("hs", "ws", "dz", "dh32")


def _bwd_scratch_floats(n: int, d: int, v: int) -> int:
    fn = _build.load_library(BWD).head_xent_bwd_scratch_floats
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(n, d, v, 0))


def head_xent_bwd(dy, h, w, targets, lse, *, mxu_bf16: bool = False):
    """``(dh, dw)`` with each logit tile computed once: for each chunk of
    the vocabulary one launch forms the chunk's ``dz`` in a bounded
    scratch and one takes ``dh += dz w_c`` and ``dw_c = dz^T h`` from it
    (``csrc/head_xent_bwd.cu``): in f32 on the CUDA cores, with bf16
    operands (``mxu_bf16``, or bf16 storage) on the tensor cores in the
    chunks of ``head_tc_plan``, ``dz`` stored once as bf16
    (``head_tc_scratch``). ``dz`` carries ``1/N``; the scalar ``dy``
    scales both outside the kernels. ``dh`` and ``dw`` take the storage
    type of ``h`` and ``w``; ``lse`` is f32. CPU tensors run
    ``head_xent_bwd_ref``."""
    n, d, v = _check(h, w, targets)
    if lse.shape != (n,):
        raise ValueError(f"lse {tuple(lse.shape)} must be [{n}]")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    if not _build.on_card(BWD, h, w, lse):
        return head_xent_bwd_ref(dy, h, w, targets, lse, mxu_bf16=mxu_bf16)
    t32 = _targets32(targets)
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    ptrs = [h.data_ptr(), w.data_ptr(), t32.data_ptr(), lse.data_ptr(),
            dh.data_ptr(), dw.data_ptr()]
    mode, suffix = _mode(h, mxu_bf16)
    if mode:
        plan = head_tc_plan(v)
        staged = tc_staged(mode, {"hs": (h.data_ptr(), d),
                                  "ws": (w.data_ptr(), d)})
        pieces = head_tc_scratch(n, d, v, plan, mode, staged)
        scratch = torch.empty(pieces["total"], dtype=torch.uint8,
                              device=h.device)
        base = scratch.data_ptr()
        ptrs += [base + pieces[p][1] if p in pieces else 0
                 for p in _TC_PIECES]
        _build.launch(BWD, "head_xent_bwd_tc_launch", ptrs,
                      (n, d, v, plan[1], mode, _sms(h)), h.device,
                      BWD_COUNT + suffix)
        return dy * dh, dy * dw
    scratch = torch.empty(_bwd_scratch_floats(n, d, v),
                          dtype=torch.float32, device=h.device)
    _build.launch(BWD, "head_xent_bwd_launch", ptrs + [scratch.data_ptr()],
                  (n, d, v, 0), h.device, BWD_COUNT)
    return dy * dh, dy * dw


class _HeadXent(torch.autograd.Function):
    """Forward and backward are the kernels; residuals are ``(h, w,
    targets, lse)``."""

    @staticmethod
    def forward(ctx, h, w, targets, mxu_bf16):
        loss, lse = head_xent_fwd(h, w, targets, mxu_bf16=mxu_bf16)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.mxu_bf16 = mxu_bf16
        return loss

    @staticmethod
    def backward(ctx, dy):
        dh, dw = head_xent_bwd(dy, *ctx.saved_tensors, mxu_bf16=ctx.mxu_bf16)
        return dh, dw, None, None


def head_xent(h, w, targets, mxu_bf16: bool = False):
    """Row-mean cross-entropy of the tied head ``h w^T``, computed and
    differentiated by the kernels; ``targets`` takes no gradient."""
    return _HeadXent.apply(h, w, targets, mxu_bf16)
