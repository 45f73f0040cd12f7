"""Flash attention in two hand-written kernels: the forward, which
returns ``(y, lse)``, and the backward, which recomputes the score tiles
from ``(q, k, v, y, lse)``. The training path's ``attn_impl="flash"``.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_attention.py``
(``flash_attention_fwd``, ``flash_attention_bwd``, ``flash_attention``,
``flash_mha``). On a CUDA tensor each wrapper launches its CUDA kernels
(``csrc/flash_attn_fwd.cu`` under ``FWD_PLAN``;
``csrc/flash_attn_bwd.cu``'s dkv and dq kernels under ``BWD_PLAN``;
built at first use by ``ops/_build.py``, bound with ctypes) or raises;
on a CPU tensor it runs its plain PyTorch version ``*_ref``. There is
no fallback from a kernel to its plain version.

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
to bf16 once. The kernels read bf16 tiles (half the bytes) and count
their launches as ``<name>[bf16]``.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_ffn import _layout, _up

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
    bf16 = q.dtype == torch.bfloat16
    y = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _build.launch(FWD, "flash_attn_fwd_launch",
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
                   lse.data_ptr()],
                  (bh, tq, tk, dh, int(bool(causal)), *FWD_PLAN,
                   int(bool(mxu_bf16)), int(bf16)), q.device,
                  FWD + BF16 * bf16)
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


def flash_attention_bwd(dy, q, k, v, y, lse, *, causal: bool = True,
                        mxu_bf16: bool = False):
    """``(dq, dk, dv)`` with the score tiles recomputed once: the dkv
    launch (``D = rowsum(dy * y)``, then a block per key tile: s, p, dp
    and ds, dk and dv, and ``ds^T`` into the scratch ``bwd_scratch``) and
    the dq launch (a block per query tile: ``dq = ds k`` from the
    scratch). CPU tensors run ``flash_attention_bwd_ref``."""
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
    pieces = bwd_scratch(bh, tq, tk)
    scratch = torch.empty(pieces["total"], dtype=torch.float32,
                          device=q.device)
    d_ptr, ds_ptr = (scratch.data_ptr() + 4 * pieces[n][1]
                     for n in ("D", "dsT"))
    dims = (bh, tq, tk, dh, int(bool(causal)))
    bf16 = q.dtype == torch.bfloat16
    _build.launch(BWD, "flash_attn_dkv_launch",
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(),
                   lse.data_ptr(), y.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), d_ptr, ds_ptr],
                  (*dims, *BWD_PLAN, int(bool(mxu_bf16)), int(bf16)),
                  q.device, DKV + BF16 * bf16)
    _build.launch(BWD, "flash_attn_dq_launch",
                  [k.data_ptr(), ds_ptr, dq.data_ptr()],
                  (*dims, int(bool(mxu_bf16)), int(bf16)), q.device,
                  DQ + BF16 * bf16)
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
