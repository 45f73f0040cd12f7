"""Paged decode attention: single-query attention straight from the
paged KV pool, the decode engine's ``kernel="fused"`` path.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_paged_attention.py``
(``paged_decode_attn``). On a CUDA tensor ``paged_decode_attn`` launches
the hand-written kernel ``csrc/paged_decode_attn.cu`` (built at first use
by ``ops/_build.py``, bound with ctypes) or raises; on a CPU tensor it
runs ``paged_decode_attn_ref``, the plain PyTorch version of the same
function. There is no fallback from the kernel to the plain version.

The plain version is the gather two-pass the engine's ``kernel="gather"``
path runs (gather each slot's blocks into a contiguous view, dequantize,
then ``decode_attn``'s op order: dot, divide by sqrt(dh), mask to -1e30,
softmax, PV). The kernel agrees with it to f32 rounding: it sums in
another order, so the two are not bit-identical.
"""

from __future__ import annotations

import torch

from . import _build

NAME = "paged_decode_attn"
_NEG = -1e30
# the kernel's block width and shared-memory ceiling (csrc/paged_decode_attn.cu)
_WARPS = 8
_MAX_SMEM = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def smem_bytes(g: int, dh: int, tcap: int) -> int:
    """Shared memory one kernel block needs: q ``[G, dh]``, the score row
    ``[G, tcap]``, per-warp ``p.V`` partials ``[8, G, dh]`` and a
    reduction scratch, all f32 (the kernel's ``smem_floats``)."""
    return 4 * (g * dh + g * tcap + _WARPS * g * dh + _WARPS)


def _check(q, pool_k, pool_v, k_scale, v_scale, tables, lengths):
    if q.dim() != 3 or pool_k.dim() != 4:
        raise ValueError("q must be [B, H, dh] and pool_k [n_blocks, H_kv, "
                         "block, dh]")
    b, hq, dh = q.shape
    nb, hkv, blk, dh2 = pool_k.shape
    if dh2 != dh:
        raise ValueError(f"q head dim {dh} != pool head dim {dh2}")
    if hq % hkv:
        raise ValueError(f"query heads {hq} not divisible by kv heads {hkv}")
    if pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype:
        raise ValueError("pool_k and pool_v must share shape and dtype")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale/v_scale must both be set or both None")
    if (k_scale is not None) != (pool_k.dtype == torch.int8):
        raise ValueError("k_scale/v_scale go with an int8 pool, and only "
                         "with one")
    if k_scale is not None and (tuple(k_scale.shape) != (nb, hkv)
                                or tuple(v_scale.shape) != (nb, hkv)):
        raise ValueError(f"scales must be [{nb}, {hkv}]")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables must be [{b}, MB]")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [{b}]")
    return b, hq, dh, nb, hkv, blk, tables.shape[1]


def paged_decode_attn_ref(q, pool_k, pool_v, k_scale, v_scale, tables,
                          lengths):
    """Plain PyTorch version: gather, dequantize, ``decode_attn``.
    Same arguments and result as ``paged_decode_attn``."""
    b, hq, dh, nb, hkv, blk, mb = _check(q, pool_k, pool_v, k_scale,
                                         v_scale, tables, lengths)
    t = tables.long()
    k = pool_k[t].float()                          # [B, MB, H_kv, blk, dh]
    v = pool_v[t].float()
    if k_scale is not None:
        k = k * k_scale[t][..., None, None]
        v = v * v_scale[t][..., None, None]
    k = k.permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * blk, dh)
    v = v.permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * blk, dh)
    qg = q.reshape(b, hkv, hq // hkv, dh)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k) / torch.sqrt(
        torch.tensor(dh, dtype=q.dtype, device=q.device))
    mask = (torch.arange(mb * blk, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.tensor(_NEG, dtype=s.dtype,
                                          device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bktd->bkgd", p, v).reshape(b, hq, dh)


def _ptr(x):
    return None if x is None else x.data_ptr()


def paged_decode_attn(q, pool_k, pool_v, k_scale, v_scale, tables, lengths):
    """Fused single-query attention against a paged KV pool.

    ``q [B, H, dh]`` f32; ``pool_k/pool_v [n_blocks, H_kv, block, dh]``
    (one layer's pool, f32/bf16/int8); ``k_scale/v_scale [n_blocks, H_kv]``
    f32 per-block int8 scales (None for f32/bf16); ``tables [B, MB]``
    int32 physical block ids; ``lengths [B]`` int32 attendable positions,
    each in ``[1, MB * block]``. Returns ``y [B, H, dh]`` f32.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    b, hq, dh, nb, hkv, blk, mb = _check(q, pool_k, pool_v, k_scale,
                                         v_scale, tables, lengths)
    if q.device.type == "cpu":
        return paged_decode_attn_ref(q, pool_k, pool_v, k_scale, v_scale,
                                     tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attn runs on cpu or cuda, not "
                         f"{q.device}")
    tensors = (q, pool_k, pool_v, k_scale, v_scale, tables, lengths)
    if any(x is not None and x.device != q.device for x in tensors):
        raise ValueError("all operands must be on q's device")
    if any(x is not None and not x.is_contiguous() for x in tensors):
        raise ValueError("all operands must be contiguous")
    if q.dtype != torch.float32:
        raise ValueError(f"q must be float32, got {q.dtype}")
    if pool_k.dtype not in _DTYPE_CODES:
        raise ValueError(f"pool dtype {pool_k.dtype} not in f32/bf16/int8")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or v_scale.dtype != torch.float32):
        raise ValueError("scales must be float32")
    need = smem_bytes(hq // hkv, dh, mb * blk)
    if need > _MAX_SMEM:
        raise ValueError(
            f"paged_decode_attn needs {need} bytes of shared memory for a "
            f"score row of {mb * blk} positions x {hq // hkv} query rows; "
            f"a block has {_MAX_SMEM}")
    y = torch.empty_like(q)
    _build.launch(NAME, "paged_decode_attn_launch",
                  [_ptr(t) for t in tensors] + [_ptr(y)],
                  (b, hq, hkv, blk, dh, mb, _DTYPE_CODES[pool_k.dtype]),
                  q.device, NAME)
    return y
