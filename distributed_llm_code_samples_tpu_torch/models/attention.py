"""Attention, as in the JAX package's ``models/attention.py``: the causal
mask, the hand-VJP softmax attention (``attention``, an
``autograd.Function``) with its multi-head and grouped-query forms, the
training path's oracle; rotary positions and the attention that rotates
q and k with them (``rope_mha``); and the serving pieces, the paged-KV
gather and prefill-chunk attention. Layouts are the JAX ones
(``[H, T, dh]``); where JAX ``vmap``s over heads and batch, the port
takes any leading dims and lets the matrix products batch over them."""

from __future__ import annotations

import torch


def causal_mask(tq: int, tk: int, q_offset=0, device=None,
                k_offset=0) -> torch.Tensor:
    """True where query position may attend key position
    (``q_offset + i >= k_offset + j``); the offsets are the global
    positions of sequence blocks (``parallel/sequence.py``'s ring)."""
    q_pos = q_offset + torch.arange(tq, device=device)[:, None]
    return q_pos >= k_offset + torch.arange(tk, device=device)[None, :]


def attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool = True):
    """Softmax attention ``[..., T, d]``; returns ``(y, (p,))`` with the
    probabilities saved for the hand backward."""
    d = q.shape[-1]
    s = (q @ k.transpose(-1, -2)) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    if causal:
        s = torch.where(causal_mask(q.shape[-2], k.shape[-2],
                                    device=q.device), s,
                        torch.tensor(-torch.inf, dtype=s.dtype,
                                     device=s.device))
    # jax.nn.softmax's steps, each rounded to the operands' dtype (in the
    # bf16 trunk of the LM's mixed policy, exp is rounded before the sum)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return p @ v, (p,)


def attn_bwd(dy, q, k, v, p, causal: bool = True):
    """Hand VJP of ``y = p v``, ``p = softmax(q k^T / sqrt(d))``:
    ``dv = p^T dy``; ``dp = dy v^T``; ``ds = p * (dp - rowsum(dp * p))``;
    ``dq = ds k / sqrt(d)``; ``dk = ds^T q / sqrt(d)``."""
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=q.dtype, device=q.device))
    dv = p.transpose(-1, -2) @ dy
    dp = dy @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return (ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale, dv


class _Attention(torch.autograd.Function):
    """Residuals: q, k, v and the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        y, (p,) = attn_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, p)
        ctx.causal = causal
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*attn_bwd(dy, *ctx.saved_tensors, ctx.causal), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Attention whose differentiation rule is ``attn_bwd``; any leading
    dims batch (the JAX op is single-head, ``vmap``ped)."""
    return _Attention.apply(q, k, v, causal)


def mha(q, k, v, causal: bool = True) -> torch.Tensor:
    """Multi-head attention over a leading heads axis (``[..., H, T, d]``,
    the same for k and v)."""
    return attention(q, k, v, causal)


def gqa(q, k, v, causal: bool = True) -> torch.Tensor:
    """Grouped-query attention: ``q [..., H, T, dh]``, ``k/v [..., H_kv,
    T, dh]`` with ``H % H_kv == 0``; each KV head serves ``H / H_kv``
    consecutive query heads. The KV heads are broadcast (``expand``), so
    their gradients sum over the group."""
    hq, hkv = q.shape[-3], k.shape[-3]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not divisible by kv heads {hkv}")
    g = hq // hkv
    lead, (t, dh) = q.shape[:-3], q.shape[-2:]
    qg = q.reshape(*lead, hkv, g, t, dh)
    kg = k.unsqueeze(-3).expand(*lead, hkv, g, *k.shape[-2:])
    vg = v.unsqueeze(-3).expand(*lead, hkv, g, *v.shape[-2:])
    return attention(qg, kg, vg, causal).reshape(q.shape)


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding: rotate each head-dim pair
    ``(x_i, x_{i+dh/2})`` by ``pos * base^(-2i/dh)``. ``x [..., T, dh]``
    (``dh`` even), ``positions [..., T]``."""
    dh = x.shape[-1]
    if dh % 2:
        raise ValueError(f"rope needs an even head dim, got {dh}")
    half = dh // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs   # [T, half]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rope_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool = True) -> torch.Tensor:
    """Multi-head attention with rotary positions: q and k rotated by
    their in-window indices (``0..T-1``) before the hand-VJP ``mha``, or
    ``gqa`` where k has fewer heads (``[..., H, T, dh]``). The trainers'
    ``attn_impl="rope"``. The rotation is linear, so autograd's transpose
    of it (the inverse rotation) differentiates it, as ``jax.vjp`` does
    in the JAX op."""
    pos = torch.arange(q.shape[-2], device=q.device)
    op = mha if q.shape[-3] == k.shape[-3] else gqa
    return op(rope(q, pos), rope(k, pos), v, causal)


rope_mha.supports_gqa = True   # fewer k heads compose (attn_sublayer)


def gather_paged_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                    table: torch.Tensor):
    """One sequence's contiguous KV view from one layer's block pool.
    ``pool_k/pool_v [n_blocks, H_kv, block, dh]``, ``table [max_blocks]``
    int physical block ids in sequence order. Returns ``(k, v)`` each
    ``[H_kv, max_blocks * block, dh]``; positions past the sequence read
    whatever the table's tail blocks hold, and callers mask them."""
    t = table.long()
    k = pool_k[t]                                   # [MB, H_kv, block, dh]
    v = pool_v[t]
    mb, hkv, blk, dh = k.shape
    k = k.permute(1, 0, 2, 3).reshape(hkv, mb * blk, dh)
    v = v.permute(1, 0, 2, 3).reshape(hkv, mb * blk, dh)
    return k, v


def chunk_attn(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               q_offset) -> torch.Tensor:
    """Prefill-chunk attention of ``Tq`` queries against a gathered cache
    that already holds the chunk's own keys: ``q [H, Tq, dh]``,
    ``ck/cv [H_kv, T_cap, dh]``. Query ``i`` (global position
    ``q_offset + i``) sees cache positions ``<= q_offset + i``."""
    h, tq, dh = q.shape
    hkv, tcap, _ = ck.shape
    if h % hkv:
        raise ValueError(f"query heads {h} not divisible by kv heads {hkv}")
    qg = q.reshape(hkv, h // hkv, tq, dh)
    s = torch.einsum("kgqd,ktd->kgqt", qg, ck) / torch.sqrt(
        torch.tensor(dh, dtype=q.dtype, device=q.device))
    mask = causal_mask(tq, tcap, q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                          device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("kgqt,ktd->kgqd", p, cv).reshape(h, tq, dh)
