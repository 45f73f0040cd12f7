"""Flash attention in two hand-written kernels: the forward, which
returns ``(y, lse)``, and the backward, which recomputes the score tiles
from ``(q, k, v, y, lse)``. The training path's ``attn_impl="flash"``.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_attention.py``
(``flash_attention_fwd``, ``flash_attention_bwd``, ``flash_attention``,
``flash_mha``). On a CUDA tensor each wrapper launches its CUDA kernels
(``csrc/flash_attn_fwd.cu``: on the CUDA cores under ``FWD_PLAN`` in
f32, on the tensor cores (``FWD_TC``) on bf16 storage;
``csrc/flash_attn_bwd.cu``'s dkv and dq kernels: on the CUDA cores under
``BWD_PLAN`` in f32, on the tensor cores (``BWD_TC``, ``DQ_TC``) on
bf16 storage; built at first use by ``ops/_build.py``, bound with
ctypes) or raises; on a CPU tensor it runs its plain PyTorch version
``*_ref``. There is no fallback from a kernel to its plain version.

Shapes: ``q [..., Tq, dh]``, ``k, v [..., Tk, dh]``, any leading dims
(batch and heads), which one launch covers: the JAX package ``vmap``s a
single-head kernel over them. The kernels take ``dh <= 64``.

``mxu_bf16`` is the Pallas kernels' operand mode: q, k, v and dy are
rounded to bf16, and so are the probability and score-gradient tiles
before the products they feed; products, sums and the softmax
statistics stay f32. Default off (all f32). The scale ``1/sqrt(dh)``
multiplies each score product after it, as in the Pallas kernels.

Storage is f32 or bf16 (the LM's ``mixed`` trunk). With bf16 q, k, v
(and dy, y) the outputs y, dq, dk and dv are bf16 and ``lse`` f32, as
the JAX kernels' ``out_shape``s give them; the arithmetic is the
``mxu_bf16`` arithmetic on the bf16 values (the JAX kernels round p and
ds to the operands' dtype before their products), each output rounded
to bf16 once. The kernels read bf16 tiles (half the bytes) by TMA, run
their products on wgmma and count their launches as ``<name>[bf16]``:
the forward rounds ``p`` to bf16 against its tile's running max, as the
Pallas kernel rounds it; the backward forms ``ds`` from the unrounded
``p`` and rounds both before their products.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_ffn import TC_ROW, _layout, _tc_layout, _up, tc_staged

FWD, BWD = "flash_attn_fwd", "flash_attn_bwd"
DQ, DKV = "flash_attn_dq", "flash_attn_dkv"     # the backward's launches
MAX_DH = 64
_NEG = -1e30


BF16 = "[bf16]"     # the suffix of a bf16-storage launch's count


def _op(t: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if mxu_bf16 else t


def _keep(tq: int, tk: int, causal: bool, device):
    """``[Tq, Tk]`` True where query i may see key j, or None."""
    if not causal:
        return None
    return (torch.arange(tq, device=device)[:, None]
            >= torch.arange(tk, device=device)[None, :])


# -- plain versions --------------------------------------------------------

def _widened(*ts):
    return (t.float() for t in ts)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            mxu_bf16: bool = False):
    """``(y, lse)``: softmax attention with the scores ``(q k^T) *
    dh^-0.5`` masked to -1e30 (causal), ``lse = logsumexp`` of each row.
    bf16 operands run the ``mxu_bf16`` arithmetic on their f32 values; y
    comes back bf16."""
    if q.dtype == torch.bfloat16:
        y, lse = flash_attention_fwd_ref(*_widened(q, k, v), causal=causal,
                                         mxu_bf16=True)
        return y.to(torch.bfloat16), lse
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = (_op(q, mxu_bf16) @ _op(k, mxu_bf16).transpose(-1, -2)) * scale
    keep = _keep(q.shape[-2], k.shape[-2], causal, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full((), _NEG, dtype=s.dtype,
                                            device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), dtype=p.dtype,
                                             device=p.device))
    l = p.sum(dim=-1, keepdim=True)
    y = (_op(p, mxu_bf16) @ _op(v, mxu_bf16)) / l
    return y, (m + torch.log(l))[..., 0]


def flash_attention_bwd_ref(dy, q, k, v, y, lse, *, causal: bool = True,
                            mxu_bf16: bool = False):
    """``(dq, dk, dv)`` from the flash residuals: ``p = exp(s - lse)``
    (zero where masked), ``D = rowsum(dy * y)``, ``ds = p * (dy v^T -
    D)``, ``dq = ds k * scale``, ``dk = ds^T q * scale``, ``dv = p^T
    dy``. bf16 operands (q, k, v, dy, y) run the ``mxu_bf16`` arithmetic
    on their f32 values; the gradients come back bf16."""
    if q.dtype == torch.bfloat16:
        grads = flash_attention_bwd_ref(*_widened(dy, q, k, v, y), lse,
                                        causal=causal, mxu_bf16=True)
        return tuple(g.to(torch.bfloat16) for g in grads)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    d = (dy * y).sum(dim=-1, keepdim=True)
    qm, km, vm, dym = (_op(t, mxu_bf16) for t in (q, k, v, dy))
    s = (qm @ km.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    keep = _keep(q.shape[-2], k.shape[-2], causal, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), dtype=p.dtype,
                                             device=p.device))
    ds = _op(p * (dym @ vm.transpose(-1, -2) - d), mxu_bf16)
    dq = (ds @ km) * scale
    dk = (ds.transpose(-1, -2) @ qm) * scale
    dv = _op(p, mxu_bf16).transpose(-1, -2) @ dym
    return dq, dk, dv


# -- the kernels -----------------------------------------------------------

def _check(q, k, v):
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one storage type, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() < 2 or k.shape != v.shape or k.dim() != q.dim():
        raise ValueError(f"q [..., Tq, dh] and k, v [..., Tk, dh] expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[:-2] != k.shape[:-2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in their leading dims or head dim")
    if min(q.shape[-2], k.shape[-2], q.shape[-1]) < 1:
        raise ValueError("Tq, Tk and dh must be at least 1")
    bh = q.numel() // (q.shape[-2] * q.shape[-1])
    return bh, q.shape[-2], k.shape[-2], q.shape[-1]


def _kernel_dims(name, dh):
    if dh > MAX_DH:
        raise ValueError(f"{name}: the kernel takes head dims up to {MAX_DH}, "
                         f"got {dh}")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        mxu_bf16: bool = False):
    """``(y [..., Tq, dh], lse [..., Tq])``, one launch over every head;
    no ``[Tq, Tk]`` tile reaches device memory. CPU tensors run
    ``flash_attention_fwd_ref``."""
    bh, tq, tk, dh = _check(q, k, v)
    if not _build.on_card(FWD, q, k, v):
        return flash_attention_fwd_ref(q, k, v, causal=causal,
                                       mxu_bf16=mxu_bf16)
    _kernel_dims(FWD, dh)
    y = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
            lse.data_ptr()]
    if q.dtype == torch.bfloat16:
        staged = tc_staged(2, {"qs": (q.data_ptr(), dh),
                               "ks": (k.data_ptr(), dh),
                               "vs": (v.data_ptr(), dh)})
        pieces = fwd_tc_scratch(bh, tq, tk, dh, staged)
        scratch = torch.empty(pieces["total"], dtype=torch.uint8,
                              device=q.device)
        ptrs += [scratch.data_ptr() + pieces[p][1] if p in pieces else 0
                 for p in ("qs", "ks", "vs")]
        _build.launch(FWD, "flash_attn_fwd_tc_launch", ptrs,
                      (bh, tq, tk, dh, int(bool(causal))), q.device,
                      FWD + BF16)
        return y, lse
    _build.launch(FWD, "flash_attn_fwd_launch", ptrs,
                  (bh, tq, tk, dh, int(bool(causal)), *FWD_PLAN,
                   int(bool(mxu_bf16))), q.device, FWD)
    return y, lse


# -- the forward's plans (csrc/flash_attn_fwd.cu) ----------------------------

# (query tile, key tile, stages of the K/V ring) the kernel takes: a block
# of 2 x query tile threads, 16 a row group of 8 query rows, each holding
# 8 rows x key tile / 16 keys of the score tile. chip_smoke.py's
# flash-fwd-tiles line times each at the main shape (PERF.md).
FWD_PLANS = ((64, 64, 2), (128, 64, 2), (64, 128, 2), (64, 64, 3))
FWD_PLAN = (64, 64, 2)
# shared memory of an SM on sm_90, the most a block may take, and what
# the runtime keeps for itself a block
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233472, 232448, 1024


def fwd_smem_bytes(plan) -> int:
    """Shared memory of a forward block (``fwd_floats`` in the kernel): q
    ``[query tile][dh + 4]``, the ring's stages of k and v ``[key
    tile][dh + 4]`` and p ``[query tile][key tile + 4]``, f32."""
    query_tile, key_tile, stages = plan
    ld = MAX_DH + 4
    return 4 * (query_tile * ld + stages * 2 * key_tile * ld
                + query_tile * (key_tile + 4))


def fwd_blocks_per_sm(plan) -> int:
    """Forward blocks an SM holds at once, by shared memory and by
    threads (2048 an SM); the registers (at most 255 a thread) allow
    at least as many."""
    by_smem = SMEM_PER_SM // (fwd_smem_bytes(plan) + SMEM_RESERVED)
    return min(by_smem, 2048 // (2 * plan[0]))


# -- the forward on the tensor cores (bf16 storage) ------------------------

# flash_fwd_tc_kernel's tiles (csrc/flash_attn_fwd.cu, fwd_tc): a block of
# two consumer warpgroups (64 query rows each) and a producer warp per
# (head, query tile), a ring of (K, V) stages of key tile keys, q kept
# once; bf16 boxes of 64 head-dim columns (128 bytes) a row.
FWD_TC = dict(query_tile=128, key_tile=64, stages=4, threads=288)


def fwd_tc_smem_bytes() -> int:
    """Shared memory of a tensor-core forward block: q ``[query tile][64]``
    and the ring's stages of k and v ``[key tile][64]``, bf16, and the
    1024 bytes that align them to a swizzle atom."""
    row = 64 * 2
    return (FWD_TC["query_tile"] * row
            + FWD_TC["stages"] * 2 * FWD_TC["key_tile"] * row + 1024)


def fwd_tc_walk(tq: int, tk: int, causal: bool):
    """``[(query tile start, block key tiles, (warpgroup 0's, 1's))]``
    in the kernel's launch order over one head: the last query tile
    first; a block loads the key tiles up to its last row's diagonal
    (all of them when not causal), and each warpgroup computes those up
    to its own 64 rows' (none for rows wholly past Tq) and releases the
    rest unread."""
    return _row_walk(tq, tk, causal, FWD_TC["query_tile"],
                     FWD_TC["key_tile"])


def _row_walk(tq: int, tk: int, causal: bool, qt: int, kt: int):
    every = -(-tk // kt)

    def tiles(q0, q1):
        if q0 >= tq:
            return 0
        return min(every, (min(q1, tq) - 1) // kt + 1) if causal else every
    nq = -(-tq // qt)
    return [(q0, tiles(q0, q0 + qt),
             (tiles(q0, q0 + qt // 2), tiles(q0 + qt // 2, q0 + qt)))
            for q0 in ((nq - 1 - i) * qt for i in range(nq))]


def fwd_tc_scratch(bh: int, tq: int, tk: int, dh: int, staged=()) -> dict:
    """The tensor-core forward's scratch (``fused_ffn._tc_layout``, in
    ``flash_attn_fwd_tc_launch``'s pointer order): zero-padded bf16
    copies ``[BH * T, dh8]`` of the operands that ``tc_staged`` names
    (TMA reads a base 16-byte aligned, rows a multiple of 8 elements)."""
    d8 = _up(dh, TC_ROW)
    shapes = {"qs": (bh * tq, d8), "ks": (bh * tk, d8), "vs": (bh * tk, d8)}
    return _tc_layout({k: (shapes[k], 2) for k in ("qs", "ks", "vs")
                       if k in staged})


# -- the backward's plan and scratch (csrc/flash_attn_bwd.cu) -------------

# The dkv launch's key tile (64 or 128 keys a block of 16 warps) and the
# stages of its query-tile ring (1: each tile copied after the last one's
# products; 2: the next tile's copy in flight while this one computes).
# chip_smoke.py's flash-bwd-tiles line times all four (PERF.md).
BWD_PLAN = (128, 2)
# the ds^T scratch's padding: keys to the largest key tile, queries to
# the query tile of both launches
SCRATCH_KEYS, QUERY_TILE = 128, 64


def bwd_scratch(bh: int, tq: int, tk: int) -> dict:
    """The backward's scratch pieces (``fused_ffn._layout``): ``D =
    rowsum(dy * y)`` as ``[BH, Tq]`` and ``ds^T`` as ``[BH, Tk128,
    Tq64]`` (Tk rounded up to ``SCRATCH_KEYS``, Tq to ``QUERY_TILE``).
    The dkv launch writes D and the ``ds^T`` tiles the causal mask
    leaves; the dq launch reads only those."""
    return _layout({"D": (bh, tq),
                    "dsT": (bh, _up(tk, SCRATCH_KEYS), _up(tq, QUERY_TILE))})


# -- the backward on the tensor cores (bf16 storage) -----------------------

# flash_dkv_tc_kernel's tiles (csrc/flash_attn_bwd.cu, bwd_tc): a block of
# two consumer warpgroups (64 keys each) and a producer warp per (head,
# key tile), K and V kept once, a ring of (Q, dY) stages of query tile
# rows; flash_dq_tc_kernel's: a block per (head, query tile), two
# warpgroups of 64 rows, Q and dY kept once, a ring of (K, V) stages of
# key tile keys. bf16 boxes of 64 head-dim columns (128 bytes) a row.
BWD_TC = dict(key_tile=128, query_tile=64, stages=4, threads=288)
DQ_TC = dict(query_tile=128, key_tile=64, stages=4, threads=288)


def bwd_tc_smem_bytes() -> dict:
    """Shared memory of a block of each tensor-core launch: the operands
    kept for the walk (``[128][64]`` bf16 twice), the ring's stages of
    two ``[64][64]`` bf16 tiles and the 1024 bytes that align them to a
    swizzle atom; the dkv block adds each stage's lse and D (64 f32
    each)."""
    row = 64 * 2
    kept = 2 * 128 * row
    ring = BWD_TC["stages"] * 2 * 64 * row
    return {"dkv": kept + ring + 1024 + BWD_TC["stages"] * 2 * 64 * 4,
            "dq": kept + ring + 1024}


def dkv_tc_walk(tq: int, tk: int, causal: bool):
    """``[(key tile start, block query tiles, (warpgroup 0's, 1's))]`` in
    the dkv kernel's launch order over one head: the first key tile (the
    longest causal walk) first; a block loads the query tiles (their
    starts) from the one holding its first key on when causal (all of
    them otherwise), and each warpgroup computes those that hold a query
    on or below its 64 keys' diagonal (none for keys wholly past Tk) and
    releases the rest unread."""
    kb, qt = BWD_TC["key_tile"], BWD_TC["query_tile"]
    nq = -(-tq // qt)
    out = []
    for k0 in range(0, tk, kb):
        first = min(nq, k0 // qt) if causal else 0
        block = [i * qt for i in range(first, nq)]
        halves = tuple([q0 for q0 in block
                        if kw < tk and (not causal or q0 + qt - 1 >= kw)]
                       for kw in (k0, k0 + kb // 2))
        out.append((k0, block, halves))
    return out


def dq_tc_walk(tq: int, tk: int, causal: bool):
    """The dq kernel's walk, as ``fwd_tc_walk`` gives the forward's: its
    blocks are laid out as the forward's."""
    return _row_walk(tq, tk, causal, DQ_TC["query_tile"], DQ_TC["key_tile"])


def bwd_tc_scratch(bh: int, tq: int, tk: int, dh: int, staged=()) -> dict:
    """The tensor-core backward's scratch (``fused_ffn._tc_layout``, in
    the launches' pointer order): ``D = rowsum(dy * y)`` as ``[BH * Tq]``
    f32, and zero-padded bf16 copies ``[BH * T, dh8]`` of the operands
    that ``tc_staged`` names. No ``ds^T``: the dq launch computes its
    tiles again."""
    d8 = _up(dh, TC_ROW)
    shapes = {"qs": (bh * tq, d8), "ks": (bh * tk, d8), "vs": (bh * tk, d8),
              "dys": (bh * tq, d8)}
    pieces = {"D": ((bh * tq,), 4)}
    pieces.update({k: (shapes[k], 2) for k in ("qs", "ks", "vs", "dys")
                   if k in staged})
    return _tc_layout(pieces)


def flash_attention_bwd(dy, q, k, v, y, lse, *, causal: bool = True,
                        mxu_bf16: bool = False):
    """``(dq, dk, dv)`` in two launches: the dkv launch (``D =
    rowsum(dy * y)``, then a block per key tile: s, p, dp and ds, dk and
    dv) and the dq launch (a block per query tile: ``dq = ds k``). In f32
    the dkv launch also writes ``ds^T`` into the scratch ``bwd_scratch``,
    which the dq launch reads; on bf16 storage (the tensor cores) the dq
    launch computes s, p, dp and ds again, and the scratch
    (``bwd_tc_scratch``) holds D and the staged copies alone. CPU tensors
    run ``flash_attention_bwd_ref``."""
    bh, tq, tk, dh = _check(q, k, v)
    if dy.shape != q.shape or y.shape != q.shape \
            or lse.shape != q.shape[:-1]:
        raise ValueError(f"dy {tuple(dy.shape)}, y {tuple(y.shape)} must "
                         f"match q {tuple(q.shape)} and lse "
                         f"{tuple(lse.shape)} its leading dims")
    if dy.dtype != q.dtype or y.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise ValueError(f"dy and y take q's storage type ({q.dtype}) and "
                         f"lse is float32; got {dy.dtype}, {y.dtype}, "
                         f"{lse.dtype}")
    if not _build.on_card(BWD, q, k, v, dy, y, lse):
        return flash_attention_bwd_ref(dy, q, k, v, y, lse, causal=causal,
                                       mxu_bf16=mxu_bf16)
    _kernel_dims(BWD, dh)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dims = (bh, tq, tk, dh, int(bool(causal)))
    if q.dtype == torch.bfloat16:
        staged = tc_staged(2, {n: (t.data_ptr(), dh) for n, t in (
            ("qs", q), ("ks", k), ("vs", v), ("dys", dy))})
        pieces = bwd_tc_scratch(bh, tq, tk, dh, staged)
        scratch = torch.empty(pieces["total"], dtype=torch.uint8,
                              device=q.device)
        d_ptr = scratch.data_ptr() + pieces["D"][1]
        copies = [scratch.data_ptr() + pieces[p][1] if p in pieces else 0
                  for p in ("qs", "ks", "vs", "dys")]
        ops = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(),
               lse.data_ptr()]
        _build.launch(BWD, "flash_attn_dkv_tc_launch",
                      ops + [y.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             d_ptr] + copies, dims, q.device, DKV + BF16)
        _build.launch(BWD, "flash_attn_dq_tc_launch",
                      ops + [d_ptr, dq.data_ptr()] + copies, dims, q.device,
                      DQ + BF16)
        return dq, dk, dv
    pieces = bwd_scratch(bh, tq, tk)
    scratch = torch.empty(pieces["total"], dtype=torch.float32,
                          device=q.device)
    d_ptr, ds_ptr = (scratch.data_ptr() + 4 * pieces[n][1]
                     for n in ("D", "dsT"))
    _build.launch(BWD, "flash_attn_dkv_launch",
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(),
                   lse.data_ptr(), y.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), d_ptr, ds_ptr],
                  (*dims, *BWD_PLAN, int(bool(mxu_bf16))), q.device, DKV)
    _build.launch(BWD, "flash_attn_dq_launch",
                  [k.data_ptr(), ds_ptr, dq.data_ptr()],
                  (*dims, int(bool(mxu_bf16))), q.device, DQ)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward and backward are the kernels; residuals are ``(q, k, v, y,
    lse)`` only (the flash policy: no probabilities saved)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, mxu_bf16):
        y, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     mxu_bf16=mxu_bf16)
        ctx.save_for_backward(q, k, v, y, lse)
        ctx.causal, ctx.mxu_bf16 = causal, mxu_bf16
        return y

    @staticmethod
    def backward(ctx, dy):
        dq, dk, dv = flash_attention_bwd(dy.contiguous(), *ctx.saved_tensors,
                                         causal=ctx.causal,
                                         mxu_bf16=ctx.mxu_bf16)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, mxu_bf16: bool = False):
    """Attention computed by the kernels and differentiated by them."""
    return _FlashAttention.apply(q, k, v, causal, mxu_bf16)


def flash_mha(q, k, v, causal: bool = True, mxu_bf16: bool = False):
    """Multi-head flash attention over a leading heads axis: ``q [...,
    H, T, dh]``; ``k, v [..., H_kv, T, dh]`` with ``H % H_kv == 0`` fan
    each KV head out to its query group (``repeat_interleave``, JAX's
    ``jnp.repeat``), whose backward sums the group's gradients. The
    operands are staged contiguous for the kernels."""
    hq, hkv = q.shape[-3], k.shape[-3]
    if hq != hkv:
        if hq % hkv:
            raise ValueError(f"query heads {hq} not divisible by kv heads "
                             f"{hkv}")
        k = k.repeat_interleave(hq // hkv, dim=-3)
        v = v.repeat_interleave(hq // hkv, dim=-3)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal, mxu_bf16)


flash_mha.supports_gqa = True
