"""Block/paged KV cache: the decode engine's memory layout, as in the JAX
package's ``decode/paged.py``.

The cache is one pool of fixed-size blocks per layer
(``k/v [L, n_blocks, H_kv, block, dh]``) and each sequence names its
blocks through an int32 block table. Physical block 0 is the scratch
block: unassigned table entries and padded bucket rows point at it, and
nothing is ever read from it unmasked.

``kv_dtype``: ``"f32"`` exact; ``"bf16"`` cast on write, widened on read;
``"int8"`` symmetric per-(layer, block, kv-head) scales ``amax/127``,
with a write re-quantizing the touched block over its valid rows only.

Unlike the JAX module, whose functions return a new pool, the writes
here update the pool's tensors in place and return the same ``PagedKV``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.attention import gather_paged_kv
from ..ops.paged_attention import paged_decode_attn

KV_DTYPES = ("f32", "bf16", "int8")

# physical block 0 is the scratch block (see module docstring)
SCRATCH_BLOCK = 0


@dataclass
class PagedKV:
    """The block pool. ``k/v [L, n_blocks, H_kv, block, dh]`` in the
    storage dtype; ``k_scale/v_scale [L, n_blocks, H_kv]`` f32 per-block
    scales (``None`` unless ``kv_dtype="int8"``)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None

    @property
    def block_size(self) -> int:
        return self.k.shape[3]


def storage_dtype(kv_dtype: str) -> torch.dtype:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[kv_dtype]


def kv_bytes_per_token(kv_dtype: str, n_layers: int, kv_heads: int,
                       head_dim: int) -> float:
    """Stored KV bytes per cached position (int8 scales not counted)."""
    per_elt = {"f32": 4, "bf16": 2, "int8": 1}[kv_dtype]
    return 2 * n_layers * kv_heads * head_dim * per_elt


def init_pool(n_layers: int, n_blocks: int, kv_heads: int, block_size: int,
              head_dim: int, kv_dtype: str = "f32",
              device="cpu") -> PagedKV:
    """Zero-filled pool. ``n_blocks`` includes the scratch block."""
    if n_blocks < 2:
        raise ValueError(f"n_blocks must be >= 2 (block {SCRATCH_BLOCK} "
                         f"is the reserved scratch block), got {n_blocks}")
    shape = (n_layers, n_blocks, kv_heads, block_size, head_dim)
    dt = storage_dtype(kv_dtype)

    def scale():
        return (torch.zeros(n_layers, n_blocks, kv_heads,
                            dtype=torch.float32, device=device)
                if kv_dtype == "int8" else None)

    return PagedKV(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   k_scale=scale(), v_scale=scale())


def _quantize(x: torch.Tensor, valid: torch.Tensor):
    """Symmetric int8 quantization of blocks ``x [..., block, dh]`` f32
    over the rows ``valid [..., block]``: ``scale = amax/127``, codes
    rounded half to even and clipped to +-127. An all-invalid or all-zero
    block gets scale 0 and zero codes."""
    masked = torch.where(valid[..., None], x.abs(), torch.zeros_like(x))
    amax = masked.amax(dim=(-2, -1))
    scale = amax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[..., None, None]), -127, 127)
    q = torch.where((scale > 0)[..., None, None], q, torch.zeros_like(q))
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale``; ``q [..., block, dh]``, ``scale [...]``."""
    return q.to(torch.float32) * scale[..., None, None]


def write_rows(pool: PagedKV, layer: int, phys: torch.Tensor,
               off: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
               kv_dtype: str) -> PagedKV:
    """Write ``N`` new KV rows in place: row ``i`` lands at ``(layer,
    phys[i], :, off[i], :)``; ``k_new/v_new [N, H_kv, dh]`` f32. At int8
    each touched block is dequantized, given its new row, and
    re-quantized over rows ``0..off[i]``. Duplicate ``phys`` entries are
    only ever the scratch block (padded bucket rows); which of them lands
    last is unspecified and nothing reads it unmasked."""
    hkv = pool.k.shape[2]
    phys = phys.long()
    off = off.long()
    if kv_dtype != "int8":
        heads = torch.arange(hkv, device=phys.device)
        idx = (phys[:, None], heads[None, :], off[:, None])
        pool.k[layer][idx] = k_new.to(pool.k.dtype)
        pool.v[layer][idx] = v_new.to(pool.v.dtype)
        return pool
    blk = pool.block_size
    rows = torch.arange(blk, device=phys.device)
    valid = (rows[None, :] <= off[:, None])[:, None, :].expand(
        off.shape[0], hkv, blk)
    ins = rows[None, None, :, None] == off[:, None, None, None]
    for side, scale, new in ((pool.k, pool.k_scale, k_new),
                             (pool.v, pool.v_scale, v_new)):
        old = _dequantize(side[layer][phys], scale[layer][phys])
        cur = torch.where(ins, new[:, :, None, :], old)
        q, s = _quantize(cur, valid)
        side[layer][phys] = q
        scale[layer][phys] = s
    return pool


def write_chunk(pool: PagedKV, layer: int, table: torch.Tensor, pos0: int,
                k_new: torch.Tensor, v_new: torch.Tensor,
                kv_dtype: str) -> PagedKV:
    """Write one sequence's prefill chunk ``k_new/v_new [C, H_kv, dh]`` at
    positions ``pos0 .. pos0+C-1`` through ``table [max_blocks]``, in
    place. Power-of-two chunks never straddle a block, so a chunk either
    part-fills one block (``C < block``) or covers ``C/block`` whole
    blocks."""
    c = k_new.shape[0]
    blk = pool.block_size
    positions = pos0 + torch.arange(c, device=table.device)
    phys = table.long()[positions // blk]
    off = positions % blk
    if kv_dtype != "int8" or c < blk:
        if kv_dtype == "int8":
            return _int8_partial_chunk(pool, layer, phys[0], off, k_new,
                                       v_new)
        return write_rows(pool, layer, phys, off, k_new, v_new, kv_dtype)
    if c % blk:
        raise ValueError(f"chunk {c} > block {blk} must be a whole "
                         "multiple (power-of-two buckets guarantee it)")
    nb = c // blk
    hkv, dh = pool.k.shape[2], pool.k.shape[4]
    blocks = table.long()[pos0 // blk + torch.arange(nb, device=table.device)]
    valid = torch.ones(nb, hkv, blk, dtype=torch.bool, device=table.device)
    for side, scale, new in ((pool.k, pool.k_scale, k_new),
                             (pool.v, pool.v_scale, v_new)):
        shaped = new.reshape(nb, blk, hkv, dh).permute(0, 2, 1, 3)
        q, s = _quantize(shaped, valid)
        side[layer][blocks] = q
        scale[layer][blocks] = s
    return pool


def _int8_partial_chunk(pool: PagedKV, layer: int, phys, off: torch.Tensor,
                        k_new: torch.Tensor,
                        v_new: torch.Tensor) -> PagedKV:
    """int8 chunk write inside ONE block (``C < block``): dequantize the
    block, insert the ``C`` rows at ``off``, re-quantize over rows
    ``0..max(off)``."""
    blk = pool.block_size
    hkv, dh = pool.k.shape[2], pool.k.shape[4]
    dev = off.device
    rows = torch.arange(blk, device=dev)
    valid = (rows <= off[-1])[None, :].expand(hkv, blk)
    hit = torch.zeros(blk, dtype=torch.bool, device=dev)
    hit[off] = True
    for side, scale, new in ((pool.k, pool.k_scale, k_new),
                             (pool.v, pool.v_scale, v_new)):
        old = _dequantize(side[layer][phys], scale[layer][phys])
        upd = torch.zeros(blk, hkv, dh, dtype=new.dtype, device=dev)
        upd[off] = new
        cur = torch.where(hit[None, :, None], upd.permute(1, 0, 2), old)
        q, s = _quantize(cur, valid)
        side[layer][phys] = q
        scale[layer][phys] = s
    return pool


def scrub_blocks(pool: PagedKV, blocks) -> PagedKV:
    """Zero the named physical blocks (values and int8 scales) in every
    layer, in place: a failed sequence's blocks may hold NaN, the one
    thing the masks cannot hide (``0 * nan == nan``)."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long,
                          device=pool.k.device)
    pool.k[:, idx] = 0
    pool.v[:, idx] = 0
    if pool.k_scale is not None:
        pool.k_scale[:, idx] = 0.0
        pool.v_scale[:, idx] = 0.0
    return pool


def fused_decode_attn(pool: PagedKV, layer: int, q: torch.Tensor,
                      tables: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Single-query attention for one layer straight from the pool
    (``ops/paged_attention.py``): the CUDA kernel on the card, its plain
    version on the CPU. ``q [B, H, dh]`` f32, ``tables [B, MB]`` int32,
    ``lengths [B]`` int32 attendable positions (the engine passes
    ``lengths + 1``)."""
    ks = None if pool.k_scale is None else pool.k_scale[layer]
    vs = None if pool.v_scale is None else pool.v_scale[layer]
    return paged_decode_attn(q, pool.k[layer], pool.v[layer], ks, vs,
                             tables, lengths)


def gather_layer(pool: PagedKV, layer: int, table: torch.Tensor):
    """One sequence's dequantized contiguous KV view for one layer:
    ``table [max_blocks]`` -> ``(k, v)`` each ``[H_kv, T_cap, dh]`` f32."""
    k, v = gather_paged_kv(pool.k[layer], pool.v[layer], table)
    if pool.k_scale is None:
        return k.to(torch.float32), v.to(torch.float32)
    blk = pool.block_size
    t = table.long()
    ks = pool.k_scale[layer][t].T.repeat_interleave(blk, dim=1)
    vs = pool.v_scale[layer][t].T.repeat_interleave(blk, dim=1)
    return k.to(torch.float32) * ks[..., None], v.to(torch.float32) * vs[
        ..., None]
