"""The paged decode attention kernel's plan on the CPU
(``ops/paged_attention.py``): the split of each slot's KV walk
(``split_plan``) and the arithmetic of the splits and their merge.

The kernel (``csrc/paged_decode_attn.cu``) cannot run here, so
``_split_model`` writes out what it does: for each slot and KV head,
each live split of ``pos`` positions computes its G score rows
``(q . k) / sqrt(dh)`` over its live positions, ``m = max s``,
``l = sum exp(s - m)`` and ``acc = sum exp(s - m) v``; the splits merge
in split order, ``m = max m_s``, ``l = sum l_s exp(m_s - m)``,
``y = (sum acc_s exp(m_s - m)) / l``. It is held against the JAX
package's Pallas ``paged_decode_attn`` in interpret mode and against the
port's plain version, f32, bf16 and int8 pools, at lengths 1, pos - 1,
pos, pos + 1, blk + 1 and the whole table. Tolerance: atol 1e-6, as
``test_torch_paged_attention.py`` (sums in other orders; not bitwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.decode import init_pool as j_init_pool
from distributed_llm_code_samples_tpu.decode.paged import (
    _quantize as j_quantize)
from distributed_llm_code_samples_tpu.ops.pallas_paged_attention import (
    interpret_supported, paged_decode_attn as j_paged)
from distributed_llm_code_samples_tpu_torch.ops import paged_attention as pa

ATOL = 1e-6
MAX_SMEM = 232448


def _plan_case(name):
    """(b, hq, hkv, dh, blk, mb) of chip_smoke.py's kernel cases (the
    serving and ragged ones share their shapes; GQA has 4 KV heads) and
    of a table of 8192 positions, G 8, dh 128."""
    return {"serving": (8, 12, 12, 64, 16, 64),
            "gqa": (8, 12, 4, 64, 16, 64),
            "long": (4, 64, 8, 128, 16, 512)}[name]


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("name", ["serving", "gqa", "long"])
def test_split_plan_at_the_kernel_cases(name, itemsize):
    b, hq, hkv, dh, blk, mb = _plan_case(name)
    g = hq // hkv
    pos, splits, grid, smem, work = pa.split_plan(b, hq, hkv, dh, blk, mb,
                                                  itemsize)
    assert pos == 64 and pos % blk == 0
    assert splits == -(-mb * blk // pos) and grid == (b, hkv, splits)
    assert smem == pa.smem_bytes(g, dh, pos, blk, splits, itemsize)
    assert smem <= MAX_SMEM
    assert work == 4 * b * hkv * (1 + splits * (g * dh + 2 * g))
    # the K and V tiles at the storage type, 16-byte rounded, lead
    assert smem == 2 * (-(-pos * dh * itemsize // 16) * 16) + 4 * (
        g * dh + g * pos + 2 * g + 2 * splits * g + g + 3 * (pos // blk) + 1)


def test_split_plan_serving_numbers():
    # 8 slots x 12 heads x 16 splits of 64 positions (4 blocks of 16)
    pos, splits, grid, smem, work = pa.split_plan(8, 12, 12, 64, 16, 64)
    assert (pos, splits, grid) == (64, 16, (8, 12, 16))
    assert smem == 2 * 64 * 64 * 4 + 4 * (64 + 64 + 2 + 32 + 1 + 12 + 1)
    assert work == 4 * 96 + 4 * 96 * 16 * 66


def test_long_table_that_the_score_row_design_refused():
    """tcap 8192, G 8, dh 128: the old kernel's [G, tcap] score row needed
    some 300 KB; a split's shared memory does not grow with the table
    but for the merge's 2 x splits x G floats."""
    b, hq, hkv, dh, blk, mb = _plan_case("long")
    old = 4 * (8 * 128 + 8 * 8192 + 8 * 8 * 128 + 8)
    assert old > MAX_SMEM
    _, splits, _, smem, _ = pa.split_plan(b, hq, hkv, dh, blk, mb)
    _, _, _, short, _ = pa.split_plan(b, hq, hkv, dh, blk, 64)
    assert splits == 128 and smem < MAX_SMEM // 2
    assert smem - short == 4 * 2 * (splits - 16) * 8


@pytest.mark.parametrize("want,pos", [(32, 32), (64, 64), (128, 128),
                                      (256, 256), (8, 16), (100, 96)])
def test_split_positions_are_whole_blocks(monkeypatch, want, pos):
    monkeypatch.setattr(pa, "SPLIT_POSITIONS", want)
    got, splits, _, _, _ = pa.split_plan(8, 12, 12, 64, 16, 64)
    assert got == pos and splits == -(-1024 // pos)


def test_split_plan_halves_a_split_that_does_not_fit(monkeypatch):
    """256 positions of f32 dh 256 need 512 KB of tiles: the plan halves
    the split until a block fits, and refuses one paged block that
    cannot."""
    monkeypatch.setattr(pa, "SPLIT_POSITIONS", 256)
    pos, _, _, smem, _ = pa.split_plan(1, 8, 8, 256, 16, 64)
    assert pos == 64 and smem <= MAX_SMEM
    assert pa.smem_bytes(1, 256, 128, 16, 8) > MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        pa.split_plan(1, 1, 1, 2048, 16, 4)


# -- the split arithmetic ---------------------------------------------------

BLK, DH, MB = 8, 8, 12


def _case(kv_dtype, hq, hkv, lengths, seed):
    """Numpy inputs: a one-layer pool with random blocks 1.. (block 0 the
    zero scratch block), out-of-order tables with scratch tails."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    nb = 1 + b * MB
    src_k = rng.normal(size=(nb, hkv, BLK, DH)).astype(np.float32)
    src_v = rng.normal(size=(nb, hkv, BLK, DH)).astype(np.float32)
    src_k[0] = src_v[0] = 0.0
    pool = j_init_pool(1, nb, hkv, BLK, DH, kv_dtype)
    if kv_dtype == "int8":
        valid = jnp.ones((nb, hkv, BLK), bool)
        qk, ks = j_quantize(jnp.asarray(src_k), valid)
        qv, vs = j_quantize(jnp.asarray(src_v), valid)
        pool = pool._replace(k=qk[None], v=qv[None], k_scale=ks[None],
                             v_scale=vs[None])
    else:
        pool = pool._replace(k=jnp.asarray(src_k, pool.k.dtype)[None],
                             v=jnp.asarray(src_v, pool.v.dtype)[None])
    lengths = np.asarray(lengths, np.int32)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, MB), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // BLK)
        tables[i, :used] = perm[i * MB:i * MB + used]
    q = rng.normal(size=(b, hq, DH)).astype(np.float32)
    return pool, q, tables, lengths


def _torch_args(pool, q, tables, lengths):
    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(np.array(a.view(np.int16))).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    ks = None if pool.k_scale is None else t(pool.k_scale[0])
    vs = None if pool.v_scale is None else t(pool.v_scale[0])
    return (t(q), t(pool.k[0]), t(pool.v[0]), ks, vs, t(tables),
            t(lengths))


def _split_model(q, pool_k, pool_v, k_scale, v_scale, tables, lengths,
                 pos):
    """The kernel's arithmetic: splits of ``pos`` positions, each with its
    own (m, l, acc), merged in split order."""
    b, hq, dh = q.shape
    hkv, blk = pool_k.shape[1], pool_k.shape[2]
    g = hq // hkv
    tcap = tables.shape[1] * blk
    y = torch.empty(b, hq, dh)
    for i in range(b):
        t = tables[i].long()
        k = pool_k[t].float()                       # [MB, H_kv, blk, dh]
        v = pool_v[t].float()
        if k_scale is not None:                     # widen, then scale
            k = k * k_scale[t][..., None, None]
            v = v * v_scale[t][..., None, None]
        k = k.permute(1, 0, 2, 3).reshape(hkv, tcap, dh)
        v = v.permute(1, 0, 2, 3).reshape(hkv, tcap, dh)
        n = max(1, min(int(lengths[i]), tcap))
        for h in range(hkv):
            qg = q[i, h * g:(h + 1) * g]            # [G, dh]
            parts = []
            for t0 in range(0, n, pos):
                live = min(pos, n - t0)
                s = (qg @ k[h, t0:t0 + live].T) / torch.sqrt(
                    torch.tensor(dh, dtype=torch.float32))
                m = s.max(dim=1).values
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(dim=1), p @ v[h, t0:t0 + live]))
            m = torch.stack([ms for ms, _, _ in parts]).max(dim=0).values
            w = [torch.exp(ms - m) for ms, _, _ in parts]
            l = sum(ls * ws for (_, ls, _), ws in zip(parts, w))
            acc = sum(a * ws[:, None] for (_, _, a), ws in zip(parts, w))
            y[i, h * g:(h + 1) * g] = acc / l[:, None]
    return y


def _lengths(pos):
    return [1, pos - 1, pos, pos + 1, BLK + 1, MB * BLK]


@pytest.mark.parametrize("split_positions", [16, 64])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_split_model_matches_the_plain_version(monkeypatch, kv_dtype, hq,
                                               hkv, split_positions):
    monkeypatch.setattr(pa, "SPLIT_POSITIONS", split_positions)
    pos = pa.split_plan(6, hq, hkv, DH, BLK, MB)[0]
    assert pos == split_positions
    args = _torch_args(*_case(kv_dtype, hq, hkv, _lengths(pos), seed=2))
    got = _split_model(*args, pos)
    want = pa.paged_decode_attn_ref(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    # more than one split at the longer lengths
    assert MB * BLK > pos


@pytest.mark.parametrize("split_positions", [16, 64])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_split_model_matches_jax_pallas_interpret(monkeypatch, kv_dtype, hq,
                                                  hkv, split_positions):
    if not interpret_supported():
        pytest.skip("no scalar-prefetch pallas surface for interpret mode")
    monkeypatch.setattr(pa, "SPLIT_POSITIONS", split_positions)
    pos = pa.split_plan(6, hq, hkv, DH, BLK, MB)[0]
    pool, q, tables, lengths = _case(kv_dtype, hq, hkv, _lengths(pos),
                                     seed=3)
    ks = None if pool.k_scale is None else pool.k_scale[0]
    vs = None if pool.v_scale is None else pool.v_scale[0]
    want = np.asarray(j_paged(jnp.asarray(q), pool.k[0], pool.v[0], ks, vs,
                              jnp.asarray(tables), jnp.asarray(lengths),
                              interpret=True))
    got = _split_model(*_torch_args(pool, q, tables, lengths), pos)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_one_split_writes_the_same_bits_as_the_merge():
    """A slot that fits one split writes acc / l; the merge of one split
    gives the same bits (exp(0) is 1), so the kernel may skip it."""
    args = _torch_args(*_case("f32", 4, 2, [5, 7], seed=4))
    got = _split_model(*args, 64)
    q, k, v = args[0], args[1][args[5].long()], args[2][args[5].long()]
    for i in range(2):
        n = int(args[6][i])
        kk = k[i].permute(1, 0, 2, 3).reshape(2, -1, DH)[:, :n]
        vv = v[i].permute(1, 0, 2, 3).reshape(2, -1, DH)[:, :n]
        for h in range(2):
            s = (q[i, 2 * h:2 * h + 2] @ kk[h].T) / torch.sqrt(
                torch.tensor(DH, dtype=torch.float32))
            p = torch.exp(s - s.max(dim=1).values[:, None])
            direct = (p @ vv[h]) / p.sum(dim=1)[:, None]
            assert torch.equal(got[i, 2 * h:2 * h + 2], direct)
