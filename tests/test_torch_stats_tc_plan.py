"""The tensor-core statistics of the fused head on the CPU
(``ops/fused_xent.py``): modes 1 (``mxu_bf16`` on f32) and 2 (bf16
storage) of ``csrc/head_xent_fwd.cu`` run ``head_stats_tc_kernel`` on
``csrc/tc_core.cuh``, and the wrapper hands it a slice plan, scratch and
a staging decision that these tests hold.

The kernel cannot run here. These hold the plain Python functions: the
slices of ``stats_tc_plan`` cover the vocabulary in order, each a whole
number of 256-column tiles but the last, and the plan is the one that
makes a block's work least on the card's persistent blocks; the scratch
pieces are aligned for TMA and as large as the kernel reads and writes;
an operand is staged into a bf16 copy exactly where TMA cannot read it
in place (and always in mode 1). Then a torch model of the kernel's
arithmetic (row tiles of 128, slices of 256-column tiles walked in order
with a running max and sum of exp, the target's logit picked by its
column, the slices merged in order as ``head_xent_merge_kernel`` merges
them) is held against JAX's Pallas ``head_xent_stats`` in interpret mode
on bf16 storage and under ``mxu_bf16``: within 1e-5 of JAX's largest
output (both sum f32 products of the same bf16 values, in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.ops import pallas_xent as jx
from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
    tensor_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff
from distributed_llm_code_samples_tpu_torch.ops import fused_xent as fx

# (N, V): the LM's main shape, one TP rank's vocab shard, chip_smoke.py's
# ragged head, a prime V, a vocabulary under one tile, one column
PLANS = ((8192, 50304), (8192, 12576), (1000, 50257), (300, 16411),
         (37, 201), (8192, 1), (1, 50304))


def _cdiv(a, b):
    return -(-a // b)


def _slices(v, plan):
    """The column range of each slice as the kernel walks it: slice q
    holds tiles [q per, min(vt, (q + 1) per))."""
    s, length = plan
    per, vt = length // ff.TC_BN, _cdiv(v, ff.TC_BN)
    return [(q * per * ff.TC_BN, min(v, min(vt, (q + 1) * per) * ff.TC_BN))
            for q in range(s)]


def _cost(n, v, s, sms=ff.H100_SMS):
    """Tiles a block takes at most: whole rounds of items of per tiles."""
    vt = _cdiv(v, ff.TC_BN)
    return _cdiv(_cdiv(n, ff.TC_BM) * s, sms) * _cdiv(vt, s)


@pytest.mark.parametrize("n,v", PLANS)
def test_slices_cover_the_vocabulary_in_order(n, v):
    """No gap, no overlap, from column 0 to V; every slice a whole number
    of TC_BN-column tiles, all but the last as wide as the first; the
    launch's own check ((S - 1) L < V <= S L) holds."""
    s, length = fx.stats_tc_plan(n, v)
    assert length % ff.TC_BN == 0 and s >= 1
    assert (s - 1) * length < v <= s * length
    bounds = _slices(v, (s, length))
    assert bounds[0][0] == 0 and bounds[-1][1] == v
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2 and hi - lo == length
    assert all(lo < hi for lo, hi in bounds)


@pytest.mark.parametrize("n,v", PLANS)
def test_plan_makes_a_blocks_work_least(n, v):
    """No other slicing gives a block fewer tiles on 132 persistent
    blocks, and of the slicings that tie the plan is the widest."""
    s, length = fx.stats_tc_plan(n, v)
    vt = _cdiv(v, ff.TC_BN)
    costs = {_cdiv(vt, per): _cost(n, v, _cdiv(vt, per))
             for per in range(1, vt + 1)}
    assert costs[s] == min(costs.values())
    assert length // ff.TC_BN == max(_cdiv(vt, k) for k, c in costs.items()
                                     if c == costs[s])


def test_plan_at_the_main_shape_and_the_tp_shard():
    """33 slices of 6 tiles at the main shape: 64 x 33 = 2112 items, 16
    whole rounds of an H100's 132 SMs, 96 tiles a block against 95.5 of
    a perfect split. One TP rank's 12576 rows: 2 slices of 25, 128 items
    in one round."""
    assert fx.stats_tc_plan(8192, 50304) == (33, 6 * 256)
    assert 64 * 33 == 16 * ff.H100_SMS and _cost(8192, 50304, 33) == 96
    assert fx.stats_tc_plan(8192, 12576) == (2, 25 * 256)
    assert _cost(8192, 12576, 2) == 25


def _check_layout(pieces, want):
    names = [k for k in pieces if k != "total"]
    assert names == list(want)
    end = 0
    for name in names:
        shape, off = pieces[name]
        assert tuple(shape) == want[name][0]
        assert off % ff.TC_PIECE == 0 and off >= end
        end = off + want[name][1] * int(np.prod(shape))
    assert pieces["total"] >= end


@pytest.mark.parametrize("staged", [(), ("hs", "ws"), ("ws",)])
@pytest.mark.parametrize("n,d,v", [(8192, 768, 50304), (1000, 200, 50257),
                                   (131, 45, 8209)])
def test_scratch_holds_what_the_kernel_reads(n, d, v, staged):
    """Staged copies [rows, d8] of bf16 where asked, then the partials
    [3, S, N] f32, each piece 256-byte aligned, in the launch's pointer
    order."""
    plan = fx.stats_tc_plan(n, v)
    d8 = -(-d // 8) * 8
    want = {k: (shape, 2) for k, shape in (("hs", (n, d8)),
                                            ("ws", (v, d8)))
            if k in staged}
    want["part"] = ((3, plan[0], n), 4)
    _check_layout(fx.stats_tc_scratch(n, d, v, plan, staged), want)


def test_staging_decision():
    """Mode 1 stages both operands; mode 2 those TMA cannot read: a base
    not 16-byte aligned or rows not a multiple of 8 elements."""
    ops = {"hs": (4096, 768), "ws": (8192, 768)}
    assert ff.tc_staged(1, ops) == ("hs", "ws")
    assert ff.tc_staged(2, ops) == ()
    assert ff.tc_staged(2, {"hs": (4098, 768), "ws": (8192, 45)}) == \
        ("hs", "ws")


# -- the tensor-core arithmetic against JAX's Pallas kernel ----------------

def stats_model(h, w, targets, plan):
    """What ``head_stats_tc_kernel`` and the merge compute, in torch: h
    and w as bf16 (rounded on f32 storage), widened to f32; for each row
    tile of 128 and each slice of ``plan``, the slice's 256-column tiles
    in order, each folding its logits (f32 sums) into the rows' running
    max and sum of exp; a target's logit taken from the tile that holds
    its column; then the slices merged in order (max, rescaled sums,
    summed target logits) and lse = max + log(sum)."""
    hm, wm = (x.to(torch.bfloat16).float() for x in (h, w))
    n, v = hm.shape[0], wm.shape[0]
    t = targets.long()
    parts = []
    for lo, hi in _slices(v, plan):
        m = torch.full((n,), -1e30)
        s = torch.zeros(n)
        z = torch.zeros(n)
        for r0 in range(0, n, ff.TC_BM):
            rows = slice(r0, min(n, r0 + ff.TC_BM))
            for c0 in range(lo, hi, ff.TC_BN):
                c1 = min(hi, c0 + ff.TC_BN)
                zt = hm[rows] @ wm[c0:c1].T
                mn = torch.maximum(m[rows], zt.amax(dim=1))
                s[rows] = s[rows] * torch.exp(m[rows] - mn) + torch.exp(
                    zt - mn[:, None]).sum(dim=1)
                m[rows] = mn
                tr = t[rows]
                hit = (tr >= c0) & (tr < c1)
                z[rows] = torch.where(hit, zt.gather(
                    1, torch.where(hit, tr - c0, 0)[:, None])[:, 0],
                    z[rows])
        parts.append((m, s, z))
    m, s, z = parts[0]
    for m2, s2, z2 in parts[1:]:
        mx = torch.maximum(m, m2)
        s = s * torch.exp(m - mx) + s2 * torch.exp(m2 - mx)
        m, z = mx, z + z2
    return m + torch.log(s), z


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("bf16", [True, False])
def test_stats_model_matches_jax_pallas_interpret(bf16, slices):
    """N 160 (a row tile and a ragged one), d 32, V 1000 (four tiles, the
    last 232 columns) in one slice and in three; targets -1, V and V +
    55 beside in-range ones, the first and the last column. lse and tz
    within 1e-5 of JAX's largest output, on bf16 storage (mode 2) and
    under ``mxu_bf16`` on f32 (mode 1)."""
    n, d, v = 160, 32, 1000
    rng = np.random.default_rng(v + slices + (7 if bf16 else 0))
    h = rng.normal(size=(n, d))
    w = 0.05 * rng.normal(size=(v, d))
    t = rng.integers(0, v, size=n).astype(np.int32)
    t[:5] = [-1, v, v + 55, 0, v - 1]
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    jh, jw = jnp.asarray(h, dtype), jnp.asarray(w, dtype)
    want = jx.head_xent_stats(jh, jw, t, interpret=True, mxu_bf16=not bf16)
    per = -(-4 // slices)
    plan = (-(-4 // per), per * ff.TC_BN)
    got = stats_model(tensor_from_numpy(np.asarray(jh)),
                      tensor_from_numpy(np.asarray(jw)),
                      torch.from_numpy(t), plan)
    for g, x in zip(got, want):
        x = np.asarray(x)
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        err = float(np.abs(g.numpy() - x).max())
        assert err <= 1e-5 * float(np.abs(x).max()), err
    assert float(got[1][0]) == 0.0 and float(got[1][1]) == 0.0


def test_stats_model_control_dropping_the_last_tile_fails():
    """The model with its walk cut one tile short (the last 232 columns
    never folded in) misses the 1e-5 limit: the check sees the edge."""
    n, d, v = 64, 32, 1000
    rng = np.random.default_rng(5)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (0.05 * rng.normal(size=(v, d))).astype(np.float32)
    t = rng.integers(0, v, size=n).astype(np.int32)
    t[0] = v - 1
    jh, jw = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jx.head_xent_stats(jh, jw, t, interpret=True, mxu_bf16=False)
    hb, wb = (tensor_from_numpy(np.asarray(x)) for x in (jh, jw))
    got = stats_model(hb, wb[:768], torch.from_numpy(t), (1, 768))
    errs = [float(np.abs(g.numpy() - np.asarray(x)).max())
            / float(np.abs(np.asarray(x)).max()) for g, x in zip(got, want)]
    assert max(errs) > 1e-5
