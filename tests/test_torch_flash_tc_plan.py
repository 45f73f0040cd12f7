"""The flash forward on bf16 storage on the CPU
(``ops/flash_attention.py``): ``csrc/flash_attn_fwd.cu``'s
``flash_fwd_tc_kernel`` runs its products on wgmma, and the wrapper
hands it a tile plan (``FWD_TC``), a walk of key tiles and a staging
decision that these tests hold.

The kernel cannot run here. These hold the plain Python functions: two
blocks of the plan fit an SM's shared memory; each block walks the key
tiles its rows need (up to the causal diagonal), and each of its two
warpgroups computes those up to its own 64 rows' diagonal and releases
the rest; the staged copies are aligned for TMA and exactly where TMA
cannot read an operand in place. Then a torch model of the kernel's
arithmetic (per 64 query rows, 64-key tiles in order: f32 scores times
the scale, masked, an online max and sum, p rounded to bf16 against the
tile's running max before ``p v`` in f32, y rounded to bf16 once) is
held against JAX's Pallas ``flash_attention_fwd`` in interpret mode on
bf16 with 64-row blocks, which rounds p at the same points: y within one
bf16 step in at most 2% of its elements (the scores' f32 sums run in
other orders, so a p near a rounding tie can go to the other
neighbour), lse within 1e-5. A control that keeps p in f32 fails it.
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

KT = fa.FWD_TC["key_tile"]
QT = fa.FWD_TC["query_tile"]


def test_a_block_fits_an_sm():
    """q (128 rows x 128 bytes) and four stages of K and V (64 rows x 128
    bytes each), aligned to a swizzle atom: 82944 bytes a block, under
    the 227 KB a block may take; two such blocks would fit an SM's
    shared memory (registers decide, on the card). Threads: two consumer
    warpgroups and a producer warp."""
    smem = fa.fwd_tc_smem_bytes()
    assert smem == 128 * 128 + 4 * 2 * 64 * 128 + 1024 == 82944
    assert smem <= fa.SMEM_PER_BLOCK
    assert 2 * (smem + fa.SMEM_RESERVED) <= fa.SMEM_PER_SM
    assert fa.FWD_TC["threads"] == 2 * 128 + 32


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(512, 512), (200, 200), (1024, 1024),
                                   (80, 130), (64, 64), (257, 257)])
def test_walk_reads_every_needed_tile_once(tq, tk, causal):
    """Every (query row, visible key) pair falls in a key tile that the
    row's warpgroup computes; no warpgroup computes a tile wholly past
    its rows' diagonal or past Tk; a block loads the tiles of its busier
    warpgroup; the last query tile comes first."""
    walk = fa.fwd_tc_walk(tq, tk, causal)
    assert [w[0] for w in walk] == sorted((w[0] for w in walk),
                                          reverse=True)
    assert sorted(w[0] for w in walk) == list(range(0, tq, QT))
    every = -(-tk // KT)
    for q0, block, halves in walk:
        assert block == max(halves) and block <= every
        for half, tiles in enumerate(halves):
            rows = range(q0 + 64 * half, min(tq, q0 + 64 * half + 64))
            if not rows:
                assert tiles == 0
                continue
            last = max(min(r, tk - 1) if causal else tk - 1 for r in rows)
            assert tiles == last // KT + 1


def test_walk_at_the_main_shape():
    """T 512 causal: 4 query tiles a head, 8 + 6 + 4 + 2 = 20 key-tile
    loads, 36 warpgroup tiles of 64 x 64 against the 32.06 the causal
    pairs fill."""
    walk = fa.fwd_tc_walk(512, 512, True)
    assert [w[1] for w in walk] == [8, 6, 4, 2]
    assert sum(sum(w[2]) for w in walk) == 36
    assert round(512 * 513 / 2 / 64 ** 2, 2) == 32.06


@pytest.mark.parametrize("staged", [(), ("qs",), ("qs", "ks", "vs")])
def test_scratch_holds_the_staged_copies(staged):
    """Zero-padded bf16 copies [BH T, dh8] of the staged operands alone,
    in the launch's pointer order, each 256-byte aligned."""
    bh, tq, tk, dh = 4, 100, 130, 36
    pieces = fa.fwd_tc_scratch(bh, tq, tk, dh, staged)
    rows = {"qs": bh * tq, "ks": bh * tk, "vs": bh * tk}
    end = 0
    assert [k for k in pieces if k != "total"] == list(staged)
    for name in staged:
        shape, off = pieces[name]
        assert shape == (rows[name], 40) and off % ff.TC_PIECE == 0
        assert off >= end
        end = off + 2 * rows[name] * 40
    assert pieces["total"] >= end


def test_staging_decision():
    """Staged where TMA cannot read in place: a base not 16-byte aligned
    or dh not a multiple of 8 (the ragged dh 40 reads in place)."""
    assert ff.tc_staged(2, {"qs": (4096, 40), "ks": (8192, 64),
                            "vs": (4098, 64)}) == ("vs",)
    assert ff.tc_staged(2, {"qs": (4096, 36)}) == ("qs",)


# -- the tensor-core arithmetic against JAX's Pallas kernel ----------------

def tc_model(q, k, v, causal, round_p=True):
    """What ``flash_fwd_tc_kernel`` computes, in torch, one head at a
    time: per 64 query rows, the 64-key tiles in order; s = (q k^T) *
    scale in f32, -1e30 where masked; m_new = max(m, rowmax), alpha =
    exp(m - m_new), p = exp(s - m_new) (0 where masked), l = alpha l +
    sum p, o = alpha o + bf16(p) v in f32; y = bf16(o / l), lse = m + log
    l. ``round_p=False`` is the control: p kept in f32."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    tq, tk, dh = qf.shape[-2], kf.shape[-2], qf.shape[-1]
    scale = 1.0 / dh ** 0.5
    ys, lses = [], []
    for r0 in range(0, tq, 64):
        rows = torch.arange(r0, min(tq, r0 + 64))
        m = torch.full(qf.shape[:-2] + (len(rows),), -1e30)
        l = torch.zeros_like(m)
        o = torch.zeros(qf.shape[:-2] + (len(rows), dh))
        for k0 in range(0, tk, KT):
            if causal and k0 > rows[-1]:
                break
            keys = torch.arange(k0, min(tk, k0 + KT))
            s = (qf[..., rows, :] @ kf[..., keys, :].transpose(-1, -2)) \
                * scale
            keep = (rows[:, None] >= keys[None, :]) if causal else \
                torch.ones(len(rows), len(keys), dtype=torch.bool)
            s = torch.where(keep, s, torch.tensor(-1e30))
            mn = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - mn)
            p = torch.where(keep, torch.exp(s - mn[..., None]),
                            torch.tensor(0.0))
            l = alpha * l + p.sum(dim=-1)
            pv = p.to(torch.bfloat16).float() if round_p else p
            o = alpha[..., None] * o + pv @ vf[..., keys, :]
            m = mn
        ys.append((o / l[..., None]).to(torch.bfloat16))
        lses.append(m + torch.log(l))
    return torch.cat(ys, -2), torch.cat(lses, -1)


def bf16_steps(got, want):
    """``(max steps, share that differ)``, a step at the larger of an
    element's magnitude and the output's RMS (chip_smoke.py's measure)."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, dtype=np.float32).astype(np.float64)
    rms = np.sqrt((w ** 2).mean())
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), rms))
    return (float((np.abs(g - w) / np.ldexp(1.0, e - 8)).max()),
            float((g != w).mean()))


def jax_inputs(h, t, dh, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=(h, t, dh)), jnp.bfloat16)
            for _ in range(3)]


def jax_fwd(q, k, v, causal):
    return jax.vmap(lambda a, b, c: j_fa.flash_attention_fwd(
        a, b, c, causal=causal, block_q=64, block_k=64, interpret=True,
        mxu_bf16=True))(q, k, v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,dh", [(192, 64), (128, 40)])
def test_tc_model_matches_jax_pallas_interpret(t, dh, causal):
    """Two heads on bf16 storage: y within one bf16 step of JAX's in at
    most 2% of its elements, lse within 1e-5 of JAX's largest."""
    jq, jk, jv = jax_inputs(2, t, dh, t + dh + causal)
    want_y, want_lse = jax_fwd(jq, jk, jv, causal)
    got_y, got_lse = tc_model(*(tensor_from_numpy(np.asarray(x))
                                for x in (jq, jk, jv)), causal)
    assert got_y.dtype == torch.bfloat16
    most, share = bf16_steps(got_y, np.asarray(want_y, np.float32))
    assert most <= 1 and share <= 0.02, (most, share)
    err = float(np.abs(got_lse.numpy() - np.asarray(want_lse)).max())
    assert err <= 1e-5 * float(np.abs(np.asarray(want_lse)).max()), err


def test_tc_model_equals_the_plain_version_on_ragged_shapes():
    """At T 200, dh 40 (no tile divides T) and at Tq 80, Tk 130, causal
    and not: y within the card's bf16 limit of the plain version (which
    rounds p against the row's final max), TOL[True] plus one bf16 step
    of its largest element; lse within 1e-5."""
    rng = np.random.default_rng(3)
    for tq, tk, dh in ((200, 200, 40), (80, 130, 64)):
        q, k, v = (torch.from_numpy(rng.normal(size=(2, n, dh)).astype(
            np.float32)).bfloat16() for n in (tq, tk, tk))
        for causal in (True, False):
            y, lse = tc_model(q, k, v, causal)
            want_y, want_lse = fa.flash_attention_fwd_ref(q, k, v,
                                                          causal=causal)
            err = float((y.float() - want_y.float()).abs().max())
            assert err <= (2e-3 + 2 ** -8) * float(want_y.float().abs()
                                                   .max()), err
            assert float((lse - want_lse).abs().max()) <= \
                1e-5 * float(want_lse.abs().max())


def test_tc_model_control_keeping_p_in_f32_fails():
    """p kept in f32 (no rounding before ``p v``): y leaves JAX's
    tile-by-tile rounding in more than 2% of its elements."""
    jq, jk, jv = jax_inputs(2, 192, 64, 11)
    want_y, _ = jax_fwd(jq, jk, jv, True)
    got_y, _ = tc_model(*(tensor_from_numpy(np.asarray(x))
                          for x in (jq, jk, jv)), True, round_p=False)
    _, share = bf16_steps(got_y, np.asarray(want_y, np.float32))
    assert share > 0.02, share
