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
softmax, PV). The kernel splits each slot's KV walk into splits of
``split_plan``'s positions, one block a (slot, KV head, split), and
merges the splits' softmax statistics in split order: it agrees with the
plain version to f32 rounding, not bit for bit, and a repeat gives the
same bits.
"""

from __future__ import annotations

import torch

from . import _build

NAME = "paged_decode_attn"
_NEG = -1e30
# positions a split aims at (a whole number of paged blocks; split_plan);
# chip_smoke.py's paged-splits sweep sets it
SPLIT_POSITIONS = 64
# a block's shared-memory ceiling on sm_90 (csrc/paged_decode_attn.cu)
_MAX_SMEM = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# per (device, stream): the merge's counters (zero between calls: the
# merging block resets its own) and the splits' partials, grown when a
# call needs more. Calls on one stream run in order and may share them;
# calls on two streams of a card may overlap, so each stream has its own.
_WORKSPACE: dict = {}


def smem_bytes(g: int, dh: int, pos: int, blk: int, splits: int,
               itemsize: int = 4) -> int:
    """Shared memory one block of the kernel needs (its ``Smem``): the
    split's K and V tiles ``[pos, dh]`` at the storage type (each rounded
    up to 16 bytes), then f32 q ``[G, dh]``, scores ``[G, pos]``, the
    split's (m, l) ``[2, G]``, the merge's ``[2, splits, G]`` and merged
    l ``[G]``, the scales ``[2, pos / blk]``, int32 table entries
    ``[pos / blk]`` and a flag."""
    bps = pos // blk
    tile = -(-pos * dh * itemsize // 16) * 16
    floats = g * dh + g * pos + 2 * g + 2 * splits * g + g + 2 * bps
    return 2 * tile + 4 * (floats + bps + 1)


def split_plan(b: int, hq: int, hkv: int, dh: int, blk: int, mb: int,
               itemsize: int = 4):
    """``(pos, splits, grid, smem, workspace)``: the kernel's split of a
    table of ``mb`` blocks of ``blk`` positions into ``splits`` splits of
    ``pos`` positions (a whole number of blocks, about
    ``SPLIT_POSITIONS``, halved until a block's shared memory fits), its
    grid ``(b, hkv, splits)``, one block's shared bytes
    (``smem_bytes``) and the workspace bytes: ``b * hkv`` counters and
    the partials ``[b * hkv, splits, G * dh + 2G]`` f32. From shapes
    alone: the lengths never come back to the host. ``itemsize``: the
    pool's bytes an element."""
    g = hq // hkv
    bps = max(1, min(mb, SPLIT_POSITIONS // blk))
    while True:
        pos, splits = bps * blk, -(-mb // bps)
        smem = smem_bytes(g, dh, pos, blk, splits, itemsize)
        if smem <= _MAX_SMEM or bps == 1:
            break
        bps = (bps + 1) // 2
    if smem > _MAX_SMEM:
        raise ValueError(
            f"paged_decode_attn needs {smem} bytes of shared memory for a "
            f"split of one block of {blk} positions x {dh} x {g} query "
            f"rows over {splits} splits; a block has {_MAX_SMEM}")
    work = 4 * b * hkv + 4 * b * hkv * splits * (g * dh + 2 * g)
    return pos, splits, (b, hkv, splits), smem, work


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
    pos, splits, _, _, _ = split_plan(b, hq, hkv, dh, blk, mb,
                                      pool_k.element_size())
    g = hq // hkv
    counters, part = _workspace(q.device, b * hkv,
                                b * hkv * splits * (g * dh + 2 * g))
    vec = int((blk * dh * pool_k.element_size()) % 16 == 0
              and pool_k.data_ptr() % 16 == 0
              and pool_v.data_ptr() % 16 == 0)
    y = torch.empty_like(q)
    _build.launch(NAME, "paged_decode_attn_launch",
                  [_ptr(t) for t in tensors] + [_ptr(y), _ptr(part),
                                                 _ptr(counters)],
                  (b, hq, hkv, blk, dh, mb, pos, splits,
                   _DTYPE_CODES[pool_k.dtype], vec),
                  q.device, NAME)
    return y


def _workspace(device, n_counters: int, n_floats: int):
    """The ``(counters, partials)`` of ``device``'s current stream, grown
    to at least these sizes. A grown counter buffer starts at zero; every
    call leaves its counters at zero."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counters, part = _WORKSPACE.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    if part is None or part.numel() < n_floats:
        part = torch.empty(max(n_floats, 1), dtype=torch.float32,
                           device=device)
    _WORKSPACE[key] = (counters, part)
    return counters, part

