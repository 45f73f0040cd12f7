"""The flash backward on bf16 storage on the CPU
(``ops/flash_attention.py``): ``csrc/flash_attn_bwd.cu``'s
``flash_dkv_tc_kernel`` and ``flash_dq_tc_kernel`` run their products on
wgmma, and the wrapper hands them tile plans (``BWD_TC``, ``DQ_TC``),
walks of tiles, a scratch and a staging decision that these tests hold.

The kernels cannot run here. These hold the plain Python functions: a
block of either launch fits an SM's shared memory; the dkv walk (a block
per 128 keys, two warpgroups of 64) and the dq walk (a block per 128
query rows) each cover every visible (query, key) pair exactly once and
skip only tiles the mask empties, causal and not, at Tq = Tk, at Tq !=
Tk and at ragged T; the staged copies are aligned for TMA and exactly
where TMA cannot read an operand in place; the scratch holds D and those
copies and no ``ds^T``. Then a torch model of the kernels' arithmetic
(tiles in the kernels' order: s and dp in f32, p = exp(s * scale - lse)
kept in f32, ds from that unrounded p, bf16(p) and bf16(ds) into the
products, f32 sums, dq, dk and dv rounded to bf16 once) is held against
JAX's Pallas ``flash_attention_bwd`` in interpret mode on bf16 with
64-row blocks, which rounds p and ds at the same points: each gradient
within one bf16 step of JAX's in at most 2% of its elements (the f32
sums run in other orders, and JAX scales each tile's product where the
kernels scale the sum, so an output near a rounding tie can go to the
other neighbour). Two controls must fail: p rounded before ds is formed,
and the diagonal tile's mask dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.ops import pallas_attention as j_fa
from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
    tensor_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import flash_attention as fa
from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff

KB, QT = fa.BWD_TC["key_tile"], fa.BWD_TC["query_tile"]
QB, KT = fa.DQ_TC["query_tile"], fa.DQ_TC["key_tile"]
SHAPES = [(512, 512), (200, 200), (1024, 1024), (80, 130), (130, 80),
          (64, 64), (257, 257), (37, 37)]


def test_a_block_of_either_launch_fits_an_sm():
    """The kept operands (two [128][64] bf16 boxes), four stages of two
    [64][64] boxes and the swizzle atom's alignment: 99328 bytes; the dkv
    block adds four stages of lse and D (2048 bytes). Each under the 227
    KB a block may take; two such blocks would fit an SM's shared memory
    (registers decide, on the card). Threads: two consumer warpgroups
    and a producer warp."""
    smem = fa.bwd_tc_smem_bytes()
    assert smem["dq"] == 2 * 128 * 128 + 4 * 2 * 64 * 128 + 1024 == 99328
    assert smem["dkv"] == smem["dq"] + 4 * 2 * 64 * 4
    for n in smem.values():
        assert n <= fa.SMEM_PER_BLOCK
        assert 2 * (n + fa.SMEM_RESERVED) <= fa.SMEM_PER_SM
    assert fa.BWD_TC["threads"] == fa.DQ_TC["threads"] == 2 * 128 + 32
    assert (KB, QT, QB, KT) == (128, 64, 128, 64)


def visible(tq, tk, causal):
    return {(q, k) for q in range(tq) for k in range(tk)
            if not causal or q >= k}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", SHAPES)
def test_dkv_walk_covers_every_visible_pair_once(tq, tk, causal):
    """Each visible pair's key belongs to one warpgroup of one block, and
    that warpgroup computes the query tile holding the pair once; every
    tile a block loads and a warpgroup skips holds no visible pair of
    its keys; the first key tile (the longest causal walk) comes first."""
    walk = fa.dkv_tc_walk(tq, tk, causal)
    assert [w[0] for w in walk] == list(range(0, tk, KB))
    seen = {}
    for k0, block, halves in walk:
        assert block == sorted(block) and len(set(block)) == len(block)
        for half, tiles in enumerate(halves):
            keys = range(k0 + 64 * half, min(tk, k0 + 64 * half + 64))
            assert set(tiles) <= set(block)
            for q0 in block:
                pairs = [(q, k) for q in range(q0, min(tq, q0 + QT))
                         for k in keys if not causal or q >= k]
                if q0 not in tiles:
                    assert not pairs, (k0, half, q0)
                for pair in pairs:
                    seen[pair] = seen.get(pair, 0) + 1
    assert set(seen) == visible(tq, tk, causal)
    assert set(seen.values()) == {1}
    if len(walk) > 1 and causal and tq >= tk:
        assert len(walk[0][1]) >= len(walk[-1][1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", SHAPES)
def test_dq_walk_covers_every_visible_pair_once(tq, tk, causal):
    """Each visible pair's query row belongs to one warpgroup of one
    block, which computes the key tile holding the pair once; a
    warpgroup computes no tile wholly past its rows' diagonal or Tk; the
    last query tile comes first."""
    walk = fa.dq_tc_walk(tq, tk, causal)
    assert [w[0] for w in walk] == sorted((w[0] for w in walk),
                                          reverse=True)
    assert sorted(w[0] for w in walk) == list(range(0, tq, QB))
    seen = {}
    for q0, block, halves in walk:
        assert block == max(halves) and block <= -(-tk // KT)
        for half, n in enumerate(halves):
            rows = range(q0 + 64 * half, min(tq, q0 + 64 * half + 64))
            for j in range(block):
                pairs = [(q, k) for q in rows
                         for k in range(j * KT, min(tk, j * KT + KT))
                         if not causal or q >= k]
                if j >= n:
                    assert not pairs, (q0, half, j)
                for pair in pairs:
                    seen[pair] = seen.get(pair, 0) + 1
    assert set(seen) == visible(tq, tk, causal)
    assert set(seen.values()) == {1}


def test_walks_at_the_main_shape():
    """T 512 causal: 4 key blocks a head loading 8, 6, 4 and 2 query
    tiles, 36 warpgroup tiles of 64 x 64 (the second warpgroup skips its
    block's first tile); the dq launch's 4 query blocks load 8, 6, 4 and
    2 key tiles, 36 warpgroup tiles; the causal pairs fill 32.06."""
    dkv = fa.dkv_tc_walk(512, 512, True)
    assert [len(w[1]) for w in dkv] == [8, 6, 4, 2]
    assert [tuple(len(h) for h in w[2]) for w in dkv] == [
        (8, 7), (6, 5), (4, 3), (2, 1)]
    dq = fa.dq_tc_walk(512, 512, True)
    assert [w[1] for w in dq] == [8, 6, 4, 2]
    assert sum(sum(w[2]) for w in dq) == 36
    assert round(512 * 513 / 2 / 64 ** 2, 2) == 32.06


@pytest.mark.parametrize("staged", [(), ("qs",), ("qs", "ks", "vs", "dys")])
def test_scratch_holds_d_and_the_staged_copies_alone(staged):
    """D [BH Tq] f32 first, then zero-padded bf16 copies [BH T, dh8] of
    the staged operands alone, in the launches' pointer order, each
    256-byte aligned; no ds^T at any shape (the f32 scratch's ds^T would
    be [BH, Tk128, Tq64])."""
    bh, tq, tk, dh = 4, 100, 130, 36
    pieces = fa.bwd_tc_scratch(bh, tq, tk, dh, staged)
    assert [k for k in pieces if k != "total"] == ["D", *staged]
    assert pieces["D"] == ((bh * tq,), 0)
    rows = {"qs": bh * tq, "ks": bh * tk, "vs": bh * tk, "dys": bh * tq}
    end = 4 * bh * tq
    for name in staged:
        shape, off = pieces[name]
        assert shape == (rows[name], 40) and off % ff.TC_PIECE == 0
        assert off >= end
        end = off + 2 * rows[name] * 40
    assert pieces["total"] >= end
    main = fa.bwd_tc_scratch(192, 512, 512, 64)
    assert "dsT" not in main and main["total"] == 4 * 192 * 512
    assert 4 * 192 * 512 * 512 > 100 * main["total"]   # the f32 ds^T


def test_staging_decision():
    """Staged where TMA cannot read in place: a base not 16-byte aligned
    or dh not a multiple of 8 (the ragged dh 40 reads in place)."""
    ops = {"qs": (4096, 40), "ks": (8192, 40), "vs": (4098, 40),
           "dys": (4104, 40)}
    assert ff.tc_staged(2, ops) == ("vs", "dys")
    assert ff.tc_staged(2, {"qs": (4096, 36), "dys": (4096, 36)}) == (
        "qs", "dys")


# -- the tensor-core arithmetic against JAX's Pallas kernel ----------------

def tc_model(dy, q, k, v, y, lse, causal, control=None):
    """What the two tensor-core launches compute, in torch, every head
    at once: D = rowsum(dy y) in f32; the dkv launch, per 64 keys, the
    64-row query tiles in order from the one holding its first key
    (causal): s^T and dp^T in f32, p = exp(s * scale - lse) (0 where
    masked), ds = p (dp - D), dv += bf16(p)^T dy and dk += bf16(ds)^T q in
    f32; the dq launch, per 64 query rows, the 64-key tiles in order up
    to the diagonal: dq += bf16(ds) k in f32; dk and dq times the scale,
    all three rounded to bf16 once. ``control``: "round_p" forms ds from
    bf16(p); "no_diag_mask" drops the mask on tiles that cross the
    diagonal."""
    dyf, qf, kf, vf, yf = (x.float() for x in (dy, q, k, v, y))
    tq, tk, dh = qf.shape[-2], kf.shape[-2], qf.shape[-1]
    scale = 1.0 / dh ** 0.5
    d = (dyf * yf).sum(-1)

    def tile(rows, keys):
        s = (qf[..., rows, :] @ kf[..., keys, :].transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., rows, None])
        keep = rows[:, None] >= keys[None, :] if causal else \
            torch.ones(len(rows), len(keys), dtype=torch.bool)
        if control == "no_diag_mask":
            keep = keep | bool(rows[-1] >= keys[0])
        p = torch.where(keep, p, torch.tensor(0.0))
        dp = dyf[..., rows, :] @ vf[..., keys, :].transpose(-1, -2)
        pd = p.bfloat16().float() if control == "round_p" else p
        ds = pd * (dp - d[..., rows, None])
        return p.bfloat16().float(), ds.bfloat16().float()

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, tk, 64):
        keys = torch.arange(k0, min(tk, k0 + 64))
        for q0 in range(0, tq, QT):
            if causal and q0 + QT - 1 < k0:
                continue
            rows = torch.arange(q0, min(tq, q0 + QT))
            p, ds = tile(rows, keys)
            dv[..., keys, :] += p.transpose(-1, -2) @ dyf[..., rows, :]
            dk[..., keys, :] += ds.transpose(-1, -2) @ qf[..., rows, :]
    dq = torch.zeros_like(qf)
    for r0 in range(0, tq, 64):
        rows = torch.arange(r0, min(tq, r0 + 64))
        for k0 in range(0, tk, KT):
            if causal and k0 > rows[-1]:
                break
            keys = torch.arange(k0, min(tk, k0 + KT))
            dq[..., rows, :] += tile(rows, keys)[1] @ kf[..., keys, :]
    return ((dq * scale).bfloat16(), (dk * scale).bfloat16(),
            dv.bfloat16())


def bf16_steps(got, want):
    """``(max steps, share that differ)``, a step at the larger of an
    element's magnitude and the output's RMS (chip_smoke.py's measure)."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, dtype=np.float32).astype(np.float64)
    rms = np.sqrt((w ** 2).mean())
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), rms))
    return (float((np.abs(g - w) / np.ldexp(1.0, e - 8)).max()),
            float((g != w).mean()))


def jax_case(h, t, dh, causal, seed):
    """bf16 q, k, v, dy made with numpy, y and lse from JAX's Pallas
    forward: JAX's Pallas backward in interpret mode with 64-row blocks,
    and the same operands as torch tensors."""
    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(rng.normal(size=(h, t, dh)), jnp.bfloat16)
               for _ in range(3))
    dy = jnp.asarray(0.1 * rng.normal(size=(h, t, dh)), jnp.bfloat16)
    kw = dict(causal=causal, interpret=True, mxu_bf16=True)
    y, lse = jax.vmap(lambda a, b, c: j_fa.flash_attention_fwd(
        a, b, c, block_q=64, block_k=64, **kw))(q, k, v)
    want = jax.vmap(lambda g, a, b, c, o, l: j_fa.flash_attention_bwd(
        g, a, b, c, o, l, block_q=64, block_k=64, **kw))(dy, q, k, v, y,
                                                         lse)
    ours = [tensor_from_numpy(np.asarray(x)) for x in (dy, q, k, v, y, lse)]
    return ours, [np.asarray(w, np.float32) for w in want]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,dh", [(192, 64), (128, 40)])
def test_tc_model_matches_jax_pallas_interpret(t, dh, causal):
    """Two heads on bf16 storage: dq, dk and dv each within one bf16 step
    of JAX's in at most 2% of their elements."""
    ours, want = jax_case(2, t, dh, causal, t + dh + causal)
    got = tc_model(*ours, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        most, share = bf16_steps(g, w)
        assert most <= 1 and share <= 0.02, (most, share)


@pytest.mark.parametrize("tq,tk,dh", [(200, 200, 40), (80, 130, 64),
                                      (130, 80, 64)])
def test_tc_model_equals_the_plain_version_on_ragged_shapes(tq, tk, dh):
    """No tile divides T (and Tq != Tk), causal and not: each gradient
    within the card's bf16 limit of the plain version, FFN_TOL[True] plus
    one bf16 step of its largest element."""
    rng = np.random.default_rng(tq + tk + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, dh)).astype(
        np.float32)).bfloat16() for n in (tq, tk, tk))
    dy = torch.from_numpy(0.1 * rng.normal(size=(2, tq, dh)).astype(
        np.float32)).bfloat16()
    for causal in (True, False):
        y, lse = fa.flash_attention_fwd_ref(q, k, v, causal=causal)
        got = tc_model(dy, q, k, v, y, lse, causal)
        want = fa.flash_attention_bwd_ref(dy, q, k, v, y, lse, causal=causal)
        for g, w in zip(got, want):
            err = float((g.float() - w.float()).abs().max())
            assert err <= (2e-3 + 2 ** -8) * float(w.float().abs().max()), \
                (causal, err)


@pytest.mark.parametrize("control", ["round_p", "no_diag_mask"])
def test_tc_model_controls_fail(control):
    """p rounded to bf16 before ds is formed, or the diagonal tile's mask
    dropped: some gradient leaves JAX's arithmetic in more than 2% of its
    elements or by more than one bf16 step."""
    ours, want = jax_case(2, 192, 64, True, 11)
    got = tc_model(*ours, True, control=control)
    worst = [bf16_steps(g, w) for g, w in zip(got, want)]
    assert any(most > 1 or share > 0.02 for most, share in worst), worst
