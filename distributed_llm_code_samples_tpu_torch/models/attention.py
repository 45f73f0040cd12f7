"""Attention pieces of the serving path, as in the JAX package's
``models/attention.py``: the causal mask, rotary positions, the paged-KV
gather and prefill-chunk attention. Layouts are the JAX ones
(``[H, T, dh]``)."""

from __future__ import annotations

import torch


def causal_mask(tq: int, tk: int, q_offset=0, device=None) -> torch.Tensor:
    """True where query position may attend key position
    (``q_offset + i >= j``)."""
    q_pos = q_offset + torch.arange(tq, device=device)[:, None]
    return q_pos >= torch.arange(tk, device=device)[None, :]


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
