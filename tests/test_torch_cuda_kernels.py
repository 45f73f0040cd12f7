"""The CUDA kernels of the LM trainer's path (flash attention forward and
backward; the fused head's statistics and backward), the three FFN
kernels, the paged decode attention, the ring kernels and the
all-to-all against their plain versions, on the card (every one of
them also on bf16 storage), and the loopback trainers
that run them (and TP's, which runs none). Every
test here needs a CUDA device with nvcc and skips without one. The file
imports no JAX, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Shapes: a multi-tile one and ragged ones (T and dh, or N, d and V, that
no tile divides; a rectangular Tq != Tk; a target in the last column),
causal and not, both operand modes. Limits: max |kernel - plain| <=
1e-4 * max |plain| in f32 (the sums run in other orders) and 2e-3 with
bf16 operands (an f32-level difference can flip one bf16 rounding); a
repeat on the same inputs is bit-identical.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as p_ff
from distributed_llm_code_samples_tpu_torch.ops import flash_attention as p_fa
from distributed_llm_code_samples_tpu_torch.ops import fused_xent as p_fx
from distributed_llm_code_samples_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_fwd_ref, flash_mha)

TOL = {False: 1e-4, True: 2e-3}
FLASH_SHAPES = ((3, 64, 64, 16), (2, 37, 37, 40), (2, 80, 130, 64))
HEAD_SHAPES = ((64, 32, 384), (37, 20, 201))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def normal(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(
        np.float32)).cuda()


def agree(got, again, want, mxu_bf16):
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        err = float((g - w).abs().max())
        assert err <= TOL[mxu_bf16] * float(w.abs().max()), err


def flash_case(shape):
    h, tq, tk, dh = shape
    rng = np.random.default_rng(tq)
    return (normal(rng, h, tq, dh), normal(rng, h, tk, dh),
            normal(rng, h, tk, dh), normal(rng, h, tq, dh, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_fwd_kernel_matches_plain(card, shape, causal, mxu_bf16):
    q, k, v, _ = flash_case(shape)
    kw = dict(causal=causal, mxu_bf16=mxu_bf16)
    before = _build.launch_counts().get("flash_attn_fwd", 0)
    got = flash_attention_fwd(q, k, v, **kw)
    again = flash_attention_fwd(q, k, v, **kw)
    assert _build.launch_counts()["flash_attn_fwd"] == before + 2
    agree(got, again, flash_attention_fwd_ref(q, k, v, **kw), mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("plan", p_fa.FWD_PLANS)
def test_flash_fwd_plans_agree_with_plain(card, plan, causal, mxu_bf16,
                                          monkeypatch):
    """Every (query tile, key tile, ring stages) plan that chip_smoke.py's
    flash-fwd-tiles sweep times, at the main path's shape, a ragged one
    (T and dh no tile divides) and a rectangular one, with a repeat
    bit-identical."""
    monkeypatch.setattr(p_fa, "FWD_PLAN", plan)
    for shape in ((192, 512, 512, 64), (24, 200, 200, 40), (2, 80, 130, 64),
                  (2, 37, 37, 40)):
        q, k, v, _ = flash_case(shape)
        kw = dict(causal=causal, mxu_bf16=mxu_bf16)
        got = flash_attention_fwd(q, k, v, **kw)
        again = flash_attention_fwd(q, k, v, **kw)
        agree(got, again, flash_attention_fwd_ref(q, k, v, **kw), mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain(card, shape, causal, mxu_bf16):
    q, k, v, dy = flash_case(shape)
    kw = dict(causal=causal, mxu_bf16=mxu_bf16)
    y, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    got = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
    again = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
    agree(got, again, flash_attention_bwd_ref(dy, q, k, v, y, lse, **kw),
          mxu_bf16)


# the backward at chip_smoke.py's FLASH_SHAPES (heads, Tq, Tk, dh): the
# main path's (192 heads of 512, dh 64) and the ragged one (T 200, dh 40)
FLASH_BWD_SHAPES = ((192, 512, 512, 64), (24, 200, 200, 40))


def flash_launches():
    counts = _build.launch_counts()
    return counts.get(p_fa.DQ, 0), counts.get(p_fa.DKV, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES)
def test_flash_bwd_kernels_at_the_main_path_shapes(card, shape, causal,
                                                   mxu_bf16):
    q, k, v, dy = flash_case(shape)
    kw = dict(causal=causal, mxu_bf16=mxu_bf16)
    y, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    dq0, dkv0 = flash_launches()
    got = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
    again = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
    assert flash_launches() == (dq0 + 2, dkv0 + 2)
    agree(got, again, flash_attention_bwd_ref(dy, q, k, v, y, lse, **kw),
          mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("plan", [(128, 2), (128, 1), (64, 2), (64, 1)])
def test_flash_bwd_plans_agree_with_plain(card, plan, causal, mxu_bf16,
                                          monkeypatch):
    """Every (key tile, ring stages) plan that chip_smoke.py's
    flash-bwd-tiles sweep times, at a rectangular ragged shape."""
    monkeypatch.setattr(p_fa, "BWD_PLAN", plan)
    for shape in ((2, 80, 130, 64), (2, 37, 37, 40)):
        q, k, v, dy = flash_case(shape)
        kw = dict(causal=causal, mxu_bf16=mxu_bf16)
        y, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
        got = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
        again = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
        agree(got, again,
              flash_attention_bwd_ref(dy, q, k, v, y, lse, **kw), mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
def test_flash_mha_backward_with_four_heads_on_two_kv_heads(card,
                                                            mxu_bf16):
    """flash_mha's gradients through the kernels: each KV head's the sum
    of its query group's, against the plain backward on the fanned-out
    heads."""
    rng = np.random.default_rng(7)
    b, hq, hkv, t, dh = 2, 4, 2, 96, 32
    q = normal(rng, b, hq, t, dh).requires_grad_()
    k = normal(rng, b, hkv, t, dh).requires_grad_()
    v = normal(rng, b, hkv, t, dh).requires_grad_()
    dy = normal(rng, b, hq, t, dh, scale=0.1)
    dq0, dkv0 = flash_launches()
    flash_mha(q, k, v, causal=True, mxu_bf16=mxu_bf16).backward(dy)
    assert flash_launches() == (dq0 + 1, dkv0 + 1)
    kr, vr = (x.detach().repeat_interleave(hq // hkv, dim=-3)
              for x in (k, v))
    y, lse = flash_attention_fwd_ref(q.detach(), kr, vr, causal=True,
                                     mxu_bf16=mxu_bf16)
    dq, dk, dv = flash_attention_bwd_ref(dy, q.detach(), kr, vr, y, lse,
                                         causal=True, mxu_bf16=mxu_bf16)
    want = (dq, dk.view(b, hkv, hq // hkv, t, dh).sum(2),
            dv.view(b, hkv, hq // hkv, t, dh).sum(2))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        err = float((g - w).abs().max())
        assert err <= TOL[mxu_bf16] * float(w.abs().max()), err


def head_case(shape):
    n, d, v = shape
    rng = np.random.default_rng(n)
    t = torch.from_numpy(rng.integers(0, v, size=n)).cuda()
    t[-1] = v - 1
    return normal(rng, n, d), normal(rng, v, d, scale=0.02), t


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_stats_kernel_matches_plain(card, shape, mxu_bf16):
    h, w, t = head_case(shape)
    got = p_fx.head_xent_stats(h, w, t, mxu_bf16=mxu_bf16)
    again = p_fx.head_xent_stats(h, w, t, mxu_bf16=mxu_bf16)
    agree(got, again, p_fx.head_xent_stats_ref(h, w, t, mxu_bf16=mxu_bf16),
          mxu_bf16)


# the statistics at their edges: chip_smoke.py's ragged shape (33 vocab
# slices), a vocabulary below one tile (one slice), a prime V past one
# slice with d not a multiple of 4
HEAD_STATS_EDGES = ((1000, 200, 50257), (300, 45, 100), (131, 48, 8209))


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", HEAD_STATS_EDGES)
def test_head_stats_kernel_edges_and_bit_equal(card, shape, mxu_bf16):
    """Targets -1 and V match no column (tz exactly 0); the last real
    column (head_case) and the first are found; two calls bit-equal."""
    h, w, t = head_case(shape)
    t[0], t[1], t[2] = -1, shape[2], 0
    before = _build.launch_counts().get(p_fx.STATS_COUNT, 0)
    got = p_fx.head_xent_stats(h, w, t, mxu_bf16=mxu_bf16)
    again = p_fx.head_xent_stats(h, w, t, mxu_bf16=mxu_bf16)
    assert _build.launch_counts()[p_fx.STATS_COUNT] == before + 2
    assert float(got[1][0]) == 0.0 and float(got[1][1]) == 0.0
    agree(got, again, p_fx.head_xent_stats_ref(h, w, t, mxu_bf16=mxu_bf16),
          mxu_bf16)
    # within 1e-4 of float64 on the same inputs (f32 operands)
    if not mxu_bf16:
        want = p_fx.head_xent_stats_ref(h.double(), w.double(), t)
        for g, w64 in zip(got, want):
            err = float((g.double() - w64).abs().max())
            assert err <= 1e-4 * float(w64.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_bwd_kernels_match_plain(card, shape, mxu_bf16):
    h, w, t = head_case(shape)
    lse, _ = p_fx.head_xent_stats_ref(h, w, t)
    dy = torch.tensor(2.0, device="cuda")
    kw = dict(mxu_bf16=mxu_bf16)
    got = p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)
    again = p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)
    agree(got, again, p_fx.head_xent_bwd_ref(dy, h, w, t, lse, **kw),
          mxu_bf16)


@pytest.mark.cuda
def test_head_bwd_bits_unchanged_by_the_shared_core(card):
    """The head backward's f32 bits (mode 0) equal those its build gave
    before its bf16 operand modes moved to the tensor cores (whose digest
    of both modes equalled the one from before its GEMM core moved into
    csrc/gemm_core.cuh): chip_smoke.py's stored digest of one small f32
    call."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    assert chip_smoke.head_bits_digest(torch, np, p_fx) == \
        chip_smoke.HEAD_BITS_SHA256


# the backward's ragged cases: N and V that no 128-wide tile divides, a
# prime V of one chunk and a prime V of three (past the 8192-column
# chunk), d not a multiple of 4 (the padded operand copies)
HEAD_BWD_RAGGED = ((131, 48, 8209), (300, 45, 16411), (1009, 200, 1013))


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", HEAD_BWD_RAGGED)
def test_head_bwd_kernel_ragged_and_bit_equal(card, shape, mxu_bf16):
    h, w, t = head_case(shape)
    t[0] = 0                                     # the first column too
    lse, _ = p_fx.head_xent_stats_ref(h, w, t)
    dy = torch.tensor(1.0, device="cuda")
    kw = dict(mxu_bf16=mxu_bf16)
    before = _build.launch_counts().get(p_fx.BWD_COUNT, 0)
    got = p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)
    again = p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)
    assert _build.launch_counts()[p_fx.BWD_COUNT] == before + 2
    agree(got, again, p_fx.head_xent_bwd_ref(dy, h, w, t, lse, **kw),
          mxu_bf16)
    # within 1e-4 of float64 on the same inputs (f32 operands)
    if not mxu_bf16:
        want = p_fx.head_xent_bwd_ref(dy.double(), h.double(), w.double(),
                                      t, lse.double())
        for g, w64 in zip(got, want):
            err = float((g.double() - w64).abs().max())
            assert err <= 1e-4 * float(w64.abs().max()), err


# the fused head on a vocab shard (the TP head, vp_head_xent): each rank's
# rows of w and the targets shifted by its first row r V/n. (N, d, V,
# ranks): V/n a multiple of 4, then V/n = 50 (JAX's pad-range test) and
# 12573 at the LM's d, not multiples of 4, so the kernels' 4-rounded w^T
# has columns past V/n that a shifted target can name
VOCAB_SHARDS = ((256, 64, 1024, 4), (200, 32, 200, 4),
                (131, 768, 4 * 12573, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VOCAB_SHARDS)
def test_head_kernels_on_a_vocab_shard(card, shape):
    """Shifted targets below 0, at or past V/n, and in the pad range
    ``[V/n, 4-rounded V/n)`` match no column: every rank's lse and tz,
    and its dh and dw given the merged global lse (an external lse),
    within 1e-4 of float64 on the same inputs; the merged lse, the summed
    tz and dh and the joined dw are the whole vocabulary's. The rank's
    own lse in place of the global one fails the same check."""
    n, d, v, ranks = shape
    vl = v // ranks
    rng = np.random.default_rng(v)
    h, w = normal(rng, n, d), normal(rng, v, d, scale=0.02)
    t = rng.integers(0, v, size=n)
    # half the rows target (k + 1) V/n + j, j < 3: rank k sees V/n + j
    j = np.arange(n // 2)
    t[:n // 2] = ((j // 3) % (ranks - 1) + 1) * vl + j % 3
    t = torch.from_numpy(t).cuda()
    dy = torch.tensor(1.0, device="cuda")
    h64, w64 = h.double(), w.double()

    def close(got, want):
        err = float((got.double() - want).abs().max())
        return err <= 1e-4 * float(want.abs().max())

    stats = [p_fx.head_xent_stats(h, w[r * vl:(r + 1) * vl], t - r * vl)
             for r in range(ranks)]
    lse_l = torch.stack([s[0] for s in stats])
    m = lse_l.amax(0)
    lse_g = m + torch.log(torch.exp(lse_l - m).sum(0))
    lse64, tz64 = p_fx.head_xent_stats_ref(h64, w64, t)
    assert close(lse_g, lse64)
    assert close(sum(s[1] for s in stats), tz64)
    dh_sum, dws = 0, []
    for r, (lse_r, tz_r) in enumerate(stats):
        wr, tr = w[r * vl:(r + 1) * vl], t - r * vl
        assert bool(((tr < 0) | (tr >= vl)).any())
        want = p_fx.head_xent_stats_ref(h64, wr.double(), tr)
        assert close(lse_r, want[0]) and close(tz_r, want[1])
        dh, dw = p_fx.head_xent_bwd(dy, h, wr, tr, lse_g)
        want = p_fx.head_xent_bwd_ref(dy.double(), h64, wr.double(), tr,
                                      lse64)
        assert close(dh, want[0]) and close(dw, want[1])
        dh_sum = dh_sum + dh
        dws.append(dw)
        own = p_fx.head_xent_bwd(dy, h, wr, tr, lse_r)
        assert not close(own[1], want[1])           # the control
    full = p_fx.head_xent_bwd_ref(dy.double(), h64, w64, t, lse64)
    assert close(dh_sum, full[0]) and close(torch.cat(dws), full[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,t,dh", [(16, 3, 1, 512, 64),
                                           (2, 6, 2, 96, 32)],
                         ids=["lm-rank-of-4", "two-ranks"])
def test_flash_mha_on_a_ranks_heads_with_gqa_fan_out(card, b, hq, hkv, t,
                                                     dh):
    """flash_mha on one TP rank's heads: 3 query heads on 1 KV head (12
    on 4 over 4 ranks, the LM's 16 x 512 at dh 64) and 6 on 2; forward
    and gradients against the plain versions on the fanned-out heads
    (1e-4 of the largest)."""
    rng = np.random.default_rng(hq)
    q = normal(rng, b, hq, t, dh).requires_grad_()
    k = normal(rng, b, hkv, t, dh).requires_grad_()
    v = normal(rng, b, hkv, t, dh).requires_grad_()
    dy = normal(rng, b, hq, t, dh, scale=0.1)
    y = flash_mha(q, k, v, causal=True)
    y.backward(dy)
    kr, vr = (x.detach().repeat_interleave(hq // hkv, dim=-3)
              for x in (k, v))
    y0, lse = flash_attention_fwd_ref(q.detach(), kr, vr, causal=True)
    dq, dk, dv = flash_attention_bwd_ref(dy, q.detach(), kr, vr, y0, lse,
                                         causal=True)
    want = (y0, dq, dk.view(b, hkv, hq // hkv, t, dh).sum(2),
            dv.view(b, hkv, hq // hkv, t, dh).sum(2))
    for g, w in zip((y.detach(), q.grad, k.grad, v.grad), want):
        err = float((g - w).abs().max())
        assert err <= TOL[False] * float(w.abs().max()), err


# the FFN kernels (T, d, ffn): chip_smoke.py's FFN_SHAPES (the main
# path's shape, then two ragged ones) and one with no dim a multiple of 4
# (the padded operand copies)
DW_SHAPES = ((8192, 768, 3072), (1000, 200, 520), (24, 40, 72),
             (1001, 13, 9))


def ffn_case(shape):
    t, d, f = shape
    rng = np.random.default_rng(t + d)
    return (normal(rng, f, d, scale=0.02), normal(rng, d, f, scale=0.02),
            normal(rng, t, d), normal(rng, t, d, scale=0.1))


# (count name, kernel, plain) in the backward wrappers' argument order
FFN_FNS = {
    "fwd": (p_ff.FWD, lambda dy, *w, **k: p_ff.ffn_fwd_fused(*w, **k),
            lambda dy, *w, **k: p_ff.ffn_fwd_ref(*w, **k)),
    "dx": (p_ff.BWD_DX, p_ff.ffn_bwd_dx_fused, p_ff.ffn_bwd_dx_ref)}


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", DW_SHAPES)
@pytest.mark.parametrize("kernel", sorted(FFN_FNS))
def test_ffn_fwd_and_dx_kernels_match_plain(card, kernel, shape, mxu_bf16):
    name, kern, plain = FFN_FNS[kernel]
    w1, w2, x, dy = ffn_case(shape)
    kw = dict(mxu_bf16=mxu_bf16)
    before = _build.launch_counts().get(name, 0)
    got = kern(dy, w1, w2, x, **kw)
    again = kern(dy, w1, w2, x, **kw)
    assert _build.launch_counts()[name] == before + 2
    agree((got,), (again,), (plain(dy, w1, w2, x, **kw),), mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(FFN_FNS))
def test_ffn_kernels_take_weights_that_are_not_16_byte_aligned(card,
                                                                 kernel):
    """A contiguous view one float into its storage: the kernels read
    their operands only through the padded copies, so any 4-byte aligned
    weights give the same bits."""
    _, kern, plain = FFN_FNS[kernel]
    w1, w2, x, dy = ffn_case((300, 64, 256))
    w1s = torch.empty(w1.numel() + 1, device="cuda")[1:].view_as(w1)
    w2s = torch.empty(w2.numel() + 1, device="cuda")[1:].view_as(w2)
    w1s.copy_(w1)
    w2s.copy_(w2)
    assert w1s.data_ptr() % 16 and w2s.data_ptr() % 16
    got = kern(dy, w1s, w2s, x)
    agree((got,), (kern(dy, w1, w2, x),), (plain(dy, w1, w2, x),), False)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_ffn_bwd_dw_kernel_matches_plain(card, shape, mxu_bf16):
    w1, w2, x, dy = ffn_case(shape)
    kw = dict(mxu_bf16=mxu_bf16)
    before = _build.launch_counts().get(p_ff.BWD_DW, 0)
    got = p_ff.ffn_bwd_dw_fused(dy, w1, w2, x, **kw)
    again = p_ff.ffn_bwd_dw_fused(dy, w1, w2, x, **kw)
    assert _build.launch_counts()[p_ff.BWD_DW] == before + 2
    agree(got, again, p_ff.ffn_bwd_dw_ref(dy, w1, w2, x, **kw), mxu_bf16)


@pytest.mark.cuda
def test_ffn_bwd_dw_bits_unchanged_by_the_shared_passes(card):
    """The weight-gradient kernel's f32 bits (mode 0) equal those its
    build gave before its passes moved into csrc/ffn_gemm.cuh:
    chip_smoke.py's stored digest, through the partials. The
    ``mxu_bf16`` calls it once covered moved to the tensor cores."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    assert chip_smoke.ffn_dw_bits_digest(torch, np, p_ff) == \
        chip_smoke.FFN_DW_BITS_SHA256


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, k, v, _ = flash_case((2, 16, 16, 80))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="float32"):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    h, w, t = head_case((16, 8, 40))
    with pytest.raises(ValueError, match="on"):
        p_fx.head_xent_stats(h, w.cpu(), t)


# -- the ring collectives, in loopback --------------------------------------
#
# n virtual ranks on one card: n workspaces, one cooperative launch. The
# hop and the gather are copies and the sums run in the plain version's
# ring order, so kernel and plain agree bit for bit. Shapes: a slice one
# (f32 rows of 768 floats, the 16-byte path), a ragged one (chunks of
# 105 floats, the scalar path), one whose odd chunk of 25025 floats
# the reduce-scatter splits into several ranges (the scalar path), and
# one of 30000 floats whose 16-byte aligned ranges are not whole 16 KB
# pieces.

RING_OPS = ("ppermute_dma", "ring_all_reduce", "ring_reduce_scatter",
            "ring_all_gather")
RING_SHAPES = {"slice": (256, 768), "ragged": (7, 5, 3),
               "ranged": (25, 1001), "aligned": (30, 1000)}


def ring_inputs(op, n, shape):
    rng = np.random.default_rng(n)
    rows = shape[0] if op in ("ppermute_dma", "ring_all_gather") \
        else n * shape[0]
    return [normal(rng, rows, *shape[1:]) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(RING_SHAPES))
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("op", RING_OPS)
def test_ring_kernel_matches_plain_in_loopback(card, op, n, shape):
    from distributed_llm_code_samples_tpu_torch.ops import ring
    xs = ring_inputs(op, n, RING_SHAPES[shape])
    ws = ring.PeerWorkspace(max(ring.workspace_bytes(op, xs[0], n), 1),
                            "cuda", n=n)
    try:
        before = _build.launch_counts().get(op, 0)
        got = ring.loopback(op, xs, ws)
        again = ring.loopback(op, xs, ws)
        assert _build.launch_counts()[op] == before + 2
        ws.check()
        for g, a, w in zip(got, again, ring.loopback_ref(op, xs)):
            assert g.shape == w.shape
            assert torch.equal(g, w) and torch.equal(a, w)
    finally:
        ws.close()


@pytest.mark.cuda
def test_ring_wait_gives_up_and_raises(card, monkeypatch):
    """A rank whose neighbour never enters the hop waits to its deadline,
    leaves its error word, and the check raises instead of the card
    hanging: its copy-out block (block 1 of its push block and copy-out
    block) for the left neighbour's chunk on a fresh workspace, and its
    push block for the right neighbour's release of the landing slot of
    the call before last."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    monkeypatch.setattr(ring, "WAIT_TIMEOUT_S", 0.2)
    x = torch.ones(4, device="cuda")
    ws = ring.PeerWorkspace(1024, "cuda", n=2)
    try:
        ring._launch(ring.HOP, [x], [torch.empty_like(x)], ws, 0)
        with pytest.raises(RuntimeError, match="ppermute_dma rank 0 block 1 "
                                               "gave up waiting at rank 1's "
                                               "chunk"):
            ws.check()
    finally:
        ws.close()
    # rank 1 enters call 5 with nothing to wait for and pushes its block
    # (it then waits in vain for rank 0's); rank 0 enters the same call
    # with its region last used in call 3, which rank 1 never released:
    # rank 0's push block (block 0) waits to its deadline
    ws = ring.PeerWorkspace(1024, "cuda", n=2)
    try:
        ws.epoch = 4
        ring._launch(ring.HOP, [x], [torch.empty_like(x)], ws, 1)
        ws.epoch, ws.region_calls, ws.region_last = 4, 2, [(3, 1), (4, 1)]
        ring._launch(ring.HOP, [x], [torch.empty_like(x)], ws, 0)
        with pytest.raises(RuntimeError, match="ppermute_dma rank 0 block 0 "
                                               "gave up waiting at rank 1's "
                                               "release of its landing "
                                               "slot"):
            ws.check()
    finally:
        ws.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_hop_at_the_main_path_shape_repeats_bit_identical(card, n):
    """The hop of the main path's [768, 3072] block, 16 calls in a row on
    one workspace (the two landing regions in turn, each call's flags
    after its ranges): every output equals the left neighbour's block,
    bit for bit; the control, a rank's own block, differs."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rng = np.random.default_rng(60 + n)
    xs = [normal(rng, 768, 3072) for _ in range(n)]
    ws = ring.PeerWorkspace(ring.workspace_bytes(ring.HOP, xs[0], n),
                            "cuda", n=n)
    try:
        outs = [ring.loopback(ring.HOP, xs, ws) for _ in range(16)]
        ws.check()
        for got in outs:
            for r in range(n):
                assert torch.equal(got[r], xs[(r - 1) % n])
                assert not torch.equal(got[r], xs[r])
        assert ws.region_calls == 16
    finally:
        ws.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ring_ops_in_sequence_on_one_workspace(card, n):
    """One workspace through the hop, all-gather, reduce-scatter,
    reduce-scatter, all-reduce, hop, all-to-all, all-reduce, all-gather,
    hop, reduce-scatter, all-gather (the landing regions in turn across
    the five kernels, the all-reduce in both, a hop first, between two
    all-reduces and between a gather and a reduce-scatter, an all-gather
    right after an all-to-all and after a reduce-scatter, chunks of
    changing size), twice: every output bit-identical to its plain
    version."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rng = np.random.default_rng(40 + n)
    seq = ((ring.HOP, (3, 17)), (ring.ALL_GATHER, (6, 33)),
           (ring.REDUCE_SCATTER, (n * 64, 48)),
           (ring.REDUCE_SCATTER, (n * 5, 7)), (ring.ALL_REDUCE, (n * 4, 33)),
           (ring.HOP, (5, 7)), (ring.ALL_TO_ALL, (n * 3, 101)),
           (ring.ALL_REDUCE, (n * 256, 768)), (ring.ALL_GATHER, (5, 7)),
           (ring.HOP, (256, 768)), (ring.REDUCE_SCATTER, (n * 256, 768)),
           (ring.ALL_GATHER, (256, 768)))
    ws = ring.PeerWorkspace(4 * n * 256 * 768, "cuda", n=n)
    try:
        for i, (op, shape) in enumerate(seq + seq):
            xs = [normal(rng, *shape) for _ in range(n)]
            got = ring.loopback(op, xs, ws)
            for g, w in zip(got, ring.loopback_ref(op, xs)):
                assert torch.equal(g, w), (i, op)
        # ten calls of one region use and two all-reduces (two each)
        assert ws.region_calls == 2 * (10 + 2 * 2)
        ws.check()
    finally:
        ws.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 4])
def test_all_reduce_at_the_main_path_shapes(card, n):
    """DDP's dw1 [3072, 768] and dw2 [768, 3072] a rank, several ranges a
    chunk, two calls in a row on one workspace (the second pushes into
    the region the first pushed into, with no wait): bit-identical to
    the plain ring, and within 1e-5 of float64 with a control that must
    fail (one rank's input left out)."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rng = np.random.default_rng(50 + n)
    ws = ring.PeerWorkspace(4 * 3072 * 768, "cuda", n=n)
    try:
        for shape in ((3072, 768), (768, 3072)):
            xs = [normal(rng, *shape) for _ in range(n)]
            got = ring.loopback(ring.ALL_REDUCE, xs, ws)
            again = ring.loopback(ring.ALL_REDUCE, xs, ws)
            ws.check()
            want = ring.loopback_ref(ring.ALL_REDUCE, xs)
            f64 = sum(x.double() for x in xs)
            control = f64 - xs[1].double()
            scale = float(f64.abs().max())
            for g, a, w in zip(got, again, want):
                assert torch.equal(g, w) and torch.equal(a, w)
                assert float((g.double() - f64).abs().max()) <= 1e-5 * scale
                assert float((g.double() - control).abs().max()) > \
                    1e-5 * scale
    finally:
        ws.close()


@pytest.mark.cuda
def test_all_reduce_wait_gives_up_and_raises(card, monkeypatch):
    """A rank whose peer never enters the all-reduce waits to its
    deadline for the peer's chunk and the check raises, on a fresh
    workspace and after a hop (no barrier: it pushes, then waits)."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    monkeypatch.setattr(ring, "WAIT_TIMEOUT_S", 0.2)
    x = torch.ones(8, device="cuda")
    for hop_first in (False, True):
        ws = ring.PeerWorkspace(1024, "cuda", n=2)
        try:
            if hop_first:
                ring.loopback(ring.HOP, [x, x], ws)
            ring._launch(ring.ALL_REDUCE, [x], [torch.empty_like(x)], ws, 0)
            with pytest.raises(RuntimeError, match="ring_all_reduce rank 0 "
                                                   r"block \d gave up "
                                                   "waiting at rank 1's "
                                                   "chunk"):
                ws.check()
        finally:
            ws.close()


@pytest.mark.cuda
def test_all_reduce_trace_stamps_every_block_in_phase_order(card):
    """The all-reduce's trace of one loopback call: a row per block, each
    block's entry, arrival, sums stored and flagged, and copy-out in time
    order; the pushing blocks' start and end between entry and their
    arrival's wait; the block that does not push has no push stamps."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    n = 4
    xs = [torch.randn(n * 64, 1000, device="cuda") for _ in range(n)]
    ws = ring.PeerWorkspace(4 * xs[0].numel(), "cuda", n=n)
    try:
        stamps = ring.traced(lambda: ring.loopback(ring.ALL_REDUCE, xs, ws),
                             "cuda").cpu()
        p = ring._ar_ranges(64 * 1000, n, True)
        assert stamps.shape == (n * n * p, len(ring.A2A_PHASES))
        for r in range(n):
            mine = stamps[r * n * p:(r + 1) * n * p]
            push, rest = mine[:(n - 1) * p], mine[(n - 1) * p:]
            assert bool((push[:, 1:3] >= push[:, :2]).all())
            assert bool((rest[:, 1:3] == 0).all())
            assert bool((mine[:, 3] >= mine[:, 0]).all())
            assert bool((mine[:, 4:] >= mine[:, 3:5]).all())
        got = ring.loopback(ring.ALL_REDUCE, xs, ws)
        ws.check()
        for g, w in zip(got, ring.loopback_ref(ring.ALL_REDUCE, xs)):
            assert torch.equal(g, w)
    finally:
        ws.close()


@pytest.mark.cuda
def test_rs_wait_gives_up_and_raises(card, monkeypatch):
    """A rank whose peer never enters the reduce-scatter waits to its
    deadline, leaves its error word, and the check raises: for the
    peer's chunk (on a fresh workspace, and after a hop: no barrier), and
    for the peer's release of the region of the call before last."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    monkeypatch.setattr(ring, "WAIT_TIMEOUT_S", 0.2)
    x = torch.ones(8, device="cuda")
    y = torch.empty(4, device="cuda")
    # every block of the rank waits for rank 1's chunk (each sums a part of
    # it): any may leave its code
    for hop_first in (False, True):
        ws = ring.PeerWorkspace(1024, "cuda", n=2)
        try:
            if hop_first:
                ring.loopback(ring.HOP, [x, x], ws)
            ring._launch(ring.REDUCE_SCATTER, [x], [y], ws, 0)
            with pytest.raises(RuntimeError, match="ring_reduce_scatter rank "
                                                   r"0 block \d gave up "
                                                   "waiting at rank 1's "
                                                   "chunk"):
                ws.check()
        finally:
            ws.close()
    # rank 1 enters call 5 with nothing to wait for and pushes its chunk
    # (it then waits in vain for rank 0's); rank 0 enters the same call
    # with its region last used in call 3, which rank 1 never released:
    # rank 0's pushing block (block 0) waits to its deadline
    ws = ring.PeerWorkspace(1024, "cuda", n=2)
    try:
        ws.epoch = 4
        ring._launch(ring.REDUCE_SCATTER, [x], [y], ws, 1)
        ws.epoch, ws.region_calls, ws.region_last = 4, 2, [(3, 1), (4, 1)]
        ring._launch(ring.REDUCE_SCATTER, [x], [y.clone()], ws, 0)
        with pytest.raises(RuntimeError, match="ring_reduce_scatter rank 0 "
                                               "block 0 gave up waiting at "
                                               "rank 1's release of its "
                                               "landing slot"):
            ws.check()
    finally:
        ws.close()


@pytest.mark.cuda
def test_ring_wrappers_refuse_what_the_kernels_do_not_take(card):
    from distributed_llm_code_samples_tpu_torch.ops import ring
    ws = ring.PeerWorkspace(4096, "cuda", n=2)
    try:
        x = [torch.ones(6, 4, device="cuda") for _ in range(2)]
        with pytest.raises(ValueError, match="not divisible by ring"):
            ring.loopback(ring.ALL_REDUCE, [t[:5] for t in x], ws)
        with pytest.raises(ValueError, match="float32"):
            ring.loopback(ring.ALL_REDUCE, [t.double() for t in x], ws)
        with pytest.raises(ValueError, match="needs"):
            ring.loopback(ring.ALL_GATHER, [torch.ones(1024, device="cuda")
                                            for _ in range(2)], ws)
    finally:
        ws.close()


# the all-to-all at the EP slice's shapes (the dispatch operand [E, C, d]
# and the return's [n*C, E/n, d]), a small one and a ragged one (chunks
# of 35 floats: the scalar path)
A2A_SHAPES = {"dispatch": (8, 512, 768), "return": (2048, 2, 768),
              "small": (8, 6, 16), "ragged": (12, 5, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(A2A_SHAPES))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_a2a_kernel_matches_plain_in_loopback(card, n, shape):
    from distributed_llm_code_samples_tpu_torch.ops import ring
    dims = A2A_SHAPES[shape]
    rows = dims[0] - dims[0] % n
    rng = np.random.default_rng(n)
    xs = [normal(rng, rows, *dims[1:]) for _ in range(n)]
    ws = ring.PeerWorkspace(ring.workspace_bytes(ring.ALL_TO_ALL, xs[0], n),
                            "cuda", n=n)
    try:
        before = _build.launch_counts().get(ring.ALL_TO_ALL, 0)
        got = ring.loopback(ring.ALL_TO_ALL, xs, ws)
        again = ring.loopback(ring.ALL_TO_ALL, xs, ws)
        assert _build.launch_counts()[ring.ALL_TO_ALL] == before + 2
        ws.check()
        for g, a, w, x in zip(got, again, ring.loopback_ref(ring.ALL_TO_ALL,
                                                            xs), xs):
            assert g.shape == w.shape
            assert torch.equal(g, w) and torch.equal(a, w)
            assert not torch.equal(g, x)      # the control: not the input
    finally:
        ws.close()


@pytest.mark.cuda
def test_a2a_kernel_identifying_blocks_after_ring_calls(card):
    """Block j of rank r carries 10 r + j and must land at block r of rank
    j; the same workspace served ring calls before, whose flags cannot
    satisfy the all-to-all's waits."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    n = 4
    ws = ring.PeerWorkspace(4 * 4096, "cuda", n=n)
    try:
        xs = [torch.ones(n, 64, device="cuda") for _ in range(n)]
        ring.loopback(ring.ALL_REDUCE, xs, ws)
        ring.loopback(ring.HOP, xs, ws)
        xs = [(10.0 * r + torch.arange(n, device="cuda"))[:, None]
              .repeat(1, 1000) for r in range(n)]
        for _ in range(3):
            got = ring.loopback(ring.ALL_TO_ALL, xs, ws)
        ws.check()
        for r in range(n):
            want = (10.0 * torch.arange(n, device="cuda") + r)[:, None]
            assert torch.equal(got[r], want.repeat(1, 1000))
        got = ring.loopback(ring.ALL_REDUCE, xs, ws)
        ws.check()
        assert torch.equal(got[0], ring.loopback_ref(ring.ALL_REDUCE,
                                                     xs)[0])
    finally:
        ws.close()


@pytest.mark.cuda
def test_a2a_wait_gives_up_and_raises(card, monkeypatch):
    """A rank whose peer never enters the all-to-all waits to its
    deadline, leaves its error word, and the check raises: for the
    peer's chunk (on a fresh workspace, and after a hop: no barrier),
    and for the peer's release of the landing slot of the call before
    last."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    monkeypatch.setattr(ring, "WAIT_TIMEOUT_S", 0.2)
    x = torch.ones(4, device="cuda")
    for hop_first in (False, True):
        ws = ring.PeerWorkspace(1024, "cuda", n=2)
        try:
            if hop_first:
                ring.loopback(ring.HOP, [x, x], ws)
            ring._launch(ring.ALL_TO_ALL, [x], [torch.empty_like(x)], ws, 0)
            # the copy-out block of rank 1's chunk waits; the others end
            with pytest.raises(RuntimeError, match="all_to_all_dma rank 0 "
                                                   r"block \d gave up "
                                                   "waiting at rank 1's "
                                                   "chunk"):
                ws.check()
        finally:
            ws.close()
    # rank 1 enters call 5 with nothing to wait for and pushes its chunk
    # (it then waits in vain for rank 0's); rank 0 enters the same call
    # with its landing region last used in call 3, which rank 1 never
    # released: rank 0's pushing block (block 1) waits to its deadline
    ws = ring.PeerWorkspace(1024, "cuda", n=2)
    try:
        ws.epoch = 4
        ring._launch(ring.ALL_TO_ALL, [x], [torch.empty_like(x)], ws, 1)
        ws.epoch, ws.region_calls, ws.region_last = 4, 2, [(3, 1), (4, 1)]
        ring._launch(ring.ALL_TO_ALL, [x], [torch.empty_like(x)], ws, 0)
        with pytest.raises(RuntimeError, match="all_to_all_dma rank 0 block "
                                               "1 gave up waiting at rank "
                                               "1's release of its landing "
                                               "slot"):
            ws.check()
    finally:
        ws.close()


@pytest.mark.cuda
def test_a2a_trace_stamps_every_block_in_phase_order(card):
    """The kernel's trace of one loopback call: a row per block, the
    own-chunk and pushing blocks' first three phases and the copy-out
    blocks' entry, arrival and release, each in time order; calls after
    it are not traced."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    n = 4
    xs = [torch.randn(n * 64, 1000, device="cuda") for _ in range(n)]
    ws = ring.PeerWorkspace(4 * xs[0].numel(), "cuda", n=n)
    try:
        stamps = ring.traced(lambda: ring.loopback(ring.ALL_TO_ALL, xs, ws),
                             "cuda").cpu()
        p = ring._a2a_ranges(64 * 1000, n, True)
        per_rank = (2 * n - 1) * p
        assert stamps.shape == (n * per_rank, len(ring.A2A_PHASES))
        for r in range(n):
            mine = stamps[r * per_rank:(r + 1) * per_rank]
            stores, copies = mine[:n * p], mine[n * p:]
            assert bool((stores[:, 1:3] >= stores[:, :2]).all())
            assert bool((stores[:, 3:] == 0).all())
            assert bool((copies[:, 1:3] == 0).all())
            assert bool((copies[:, 3] >= copies[:, 0]).all())
            assert bool((copies[:, 4] >= copies[:, 3]).all())
        got = ring.loopback(ring.ALL_TO_ALL, xs, ws)
        ws.check()
        for g, w in zip(got, ring.loopback_ref(ring.ALL_TO_ALL, xs)):
            assert torch.equal(g, w)
    finally:
        ws.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_a2a_kernel_alternates_regions_between_collectives(card, n):
    """A run of all-to-alls of changing shapes (a chunk that is not a
    multiple of 4 split into several ranges: the scalar path; chunks
    under 8192 floats; the 16-byte path), with ring calls between them on
    the same workspace: every call bit-identical to its plain version,
    and the ring kernels too."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rng = np.random.default_rng(10 + n)
    shapes = ((n * 3, 1001, 7), (n, 2000), (n * 2, 3, 5), (n * 3, 1001, 7),
              (n, 2000))
    ws = ring.PeerWorkspace(4 * n * 3 * 1001 * 7, "cuda", n=n)
    try:
        for i, shape in enumerate(shapes + shapes):
            xs = [normal(rng, *shape) for _ in range(n)]
            got = ring.loopback(ring.ALL_TO_ALL, xs, ws)
            for g, w in zip(got, ring.loopback_ref(ring.ALL_TO_ALL, xs)):
                assert torch.equal(g, w), (i, shape)
            if i in (2, 6):
                ys = [normal(rng, n * 4, 33) for _ in range(n)]
                for op in (ring.ALL_REDUCE, ring.ALL_GATHER):
                    got = ring.loopback(op, ys, ws)
                    for g, w in zip(got, ring.loopback_ref(op, ys)):
                        assert torch.equal(g, w), (i, op)
        ws.check()
    finally:
        ws.close()


@pytest.mark.cuda
def test_loopback_ep_through_the_a2a_kernel(card):
    """Expert parallelism on four virtual ranks of one card, every
    exchange the all-to-all kernel: equal to the grouped dense oracle on
    the same card, with the launch counts of the schedule and no ring
    kernel."""
    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models import init_moe_stack
    from distributed_llm_code_samples_tpu_torch.parallel import (
        EXPERT_AXIS, make_mesh, train_moe_dense, train_moe_ep)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    params = init_moe_stack(gen, 64, 2, 8)
    seeds = make_seed_schedule(8, 7)
    mesh = make_mesh({EXPERT_AXIS: 4}, loopback=True)
    for dispatch in ("dense", "scatter", "gather"):
        _build.reset_launch_counts()
        ep = train_moe_ep(params, seeds, 128, 64, mesh, lr=0.1, k=2,
                          aux_coef=0.01, dispatch=dispatch,
                          comm="pallas_a2a")
        # 2 steps x 2 layers x 4 exchanges, one launch for all ranks
        assert _build.launch_counts() == {"all_to_all_dma": 16}
        dense = train_moe_dense(params, seeds, 128, 64, lr=0.1, k=2,
                                aux_coef=0.01, n_groups=4,
                                dispatch=dispatch)
        for a, b in zip(ep, dense):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert float((ep.w1 - params.w1).abs().max()) > 1e-4


@pytest.mark.cuda
def test_loopback_ddp_and_fsdp_agree_through_the_ring_kernels(card):
    """DDP and FSDP on four virtual ranks of one card, every collective a
    ring kernel: the reference's differential (same final params), with
    the launch counts of the schedule."""
    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, make_mesh, train_ddp, train_fsdp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    params = init_ffn_stack(gen, 64, 2)
    seeds = make_seed_schedule(8, 7)
    mesh = make_mesh({DATA_AXIS: 4}, loopback=True)
    _build.reset_launch_counts()
    ddp = train_ddp(params, seeds, 32, 64, mesh, lr=0.1, comm="pallas_ring")
    counts = _build.launch_counts()
    # 4 ranks x 2 steps x 2 layers x 2 weights, one launch for all ranks;
    # plus the ring's one-hop check when it opens
    assert counts == {"ring_all_reduce": 2 * 2 * 2, "ppermute_dma": 1}
    _build.reset_launch_counts()
    fsdp = train_fsdp(params, seeds, 32, 64, mesh, lr=0.1,
                      comm="pallas_ring")
    assert _build.launch_counts() == {"ring_all_gather": 2 * 2 * 2 * 2,
                                      "ring_reduce_scatter": 2 * 2 * 2,
                                      "ppermute_dma": 1}
    for a, b in zip(ddp, fsdp):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert float((ddp.w1 - params.w1).abs().max()) > 1e-4


@pytest.mark.cuda
def test_loopback_tp_and_hybrid_equal_single(card):
    """TP and TP-SP on four virtual ranks of one card and the hybrid on a
    2 x 2 loopback mesh: their collectives are plain torch within each
    axis group (no kernel launches), and they end where ``train_single``
    (the hybrid with data 1 too) and DDP on two ranks end on the same
    card."""
    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, MODEL_AXIS, make_mesh, train_ddp, train_hybrid,
        train_single, train_tp, train_tp_sp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    params = init_ffn_stack(gen, 64, 2)
    seeds = make_seed_schedule(8, 7)
    single = train_single(params, seeds, 32, 64, lr=0.1)
    _build.reset_launch_counts()
    model4 = make_mesh({MODEL_AXIS: 4}, loopback=True)
    tp = train_tp(params, seeds, 32, 64, model4, lr=0.1)
    sp = train_tp_sp(params, seeds, 32, 64, model4, lr=0.1)
    hybrid = train_hybrid(params, seeds, 32, 64, make_mesh(
        {DATA_AXIS: 2, MODEL_AXIS: 2}, loopback=True), lr=0.1)
    hybrid_tp = train_hybrid(params, seeds, 32, 64, make_mesh(
        {DATA_AXIS: 1, MODEL_AXIS: 4}, loopback=True), lr=0.1)
    assert _build.launch_counts() == {}
    ddp = train_ddp(params, seeds, 32, 64, make_mesh({DATA_AXIS: 2},
                                                     loopback=True),
                    lr=0.1, comm="pallas_ring")
    for got, want in ((tp, single), (sp, single), (hybrid_tp, single),
                      (hybrid, ddp)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert float((tp.w1 - params.w1).abs().max()) > 1e-4


# the paged decode attention (split KV walk, csrc/paged_decode_attn.cu):
# (tag, H, H_kv, dh, block, MB, lengths). The serving shape (more than one
# split for most slots), GQA with ragged lengths (1, a block boundary and
# one past it, the whole table), a table of 8192 positions with G 8 and
# dh 128 (past the old kernel's shared-memory cap), and a tile of 3 x 5
# that is not 16-byte aligned at any storage type (the plain-load path).
PAGED_CASES = (
    ("serving", 12, 12, 64, 16, 64, (57, 320, 65, 148, 84, 211, 120, 276)),
    ("gqa_ragged", 12, 4, 64, 16, 64, (1, 16, 17, 300, 77, 1024, 5, 513)),
    ("long", 64, 8, 128, 16, 512, (8192, 1, 4000, 65)),
    ("unaligned", 6, 3, 5, 3, 30, (1, 3, 4, 90, 64)))
PAGED_TOL = 2e-5


def paged_case(kv_dtype, hq, hkv, dh, blk, mb, lengths, seed):
    from distributed_llm_code_samples_tpu_torch.decode.paged import (
        _quantize)
    rng = np.random.default_rng(seed)
    b = len(lengths)
    nb = 1 + b * mb
    k = normal(rng, nb, hkv, blk, dh)
    v = normal(rng, nb, hkv, blk, dh)
    k[0] = v[0] = 0.0
    ks = vs = None
    if kv_dtype == "int8":
        valid = torch.ones(nb, hkv, blk, dtype=torch.bool, device="cuda")
        k, ks = _quantize(k, valid)
        v, vs = _quantize(v, valid)
    elif kv_dtype == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // blk)
        tables[i, :used] = perm[i * mb:i * mb + used]
    return (normal(rng, b, hq, dh), k.contiguous(), v.contiguous(), ks, vs,
            torch.from_numpy(tables).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_kernel_splits_match_plain(card, case, kv_dtype):
    """More than one split a slot, merged by the last split to finish:
    within 2e-5 of the plain version relative to its largest value, one
    launch counted, a repeat bit-identical."""
    from distributed_llm_code_samples_tpu_torch.ops import paged_attention
    tag, hq, hkv, dh, blk, mb, lengths = case
    args = paged_case(kv_dtype, hq, hkv, dh, blk, mb, lengths, len(tag))
    pos, splits = paged_attention.split_plan(len(lengths), hq, hkv, dh, blk,
                                             mb, args[1].element_size())[:2]
    assert splits > 1 and max(lengths) > pos
    before = _build.launch_counts().get("paged_decode_attn", 0)
    got = paged_attention.paged_decode_attn(*args)
    again = paged_attention.paged_decode_attn(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["paged_decode_attn"] == before + 2
    want = paged_attention.paged_decode_attn_ref(*args)
    assert torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= PAGED_TOL * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_paged_kernel_on_shared_block_tables(card, kv_dtype):
    """Tables in which every slot names the same leading blocks (the
    prefix cache's shared system prompt, 16 blocks) and one slot's table
    is another's (a full hit): each slot agrees with the plain version,
    and the twin slots with each other bit for bit."""
    from distributed_llm_code_samples_tpu_torch.ops import paged_attention
    tag, hq, hkv, dh, blk, mb, lengths = PAGED_CASES[0]
    lengths = tuple(256 + n for n in lengths)
    args = list(paged_case(kv_dtype, hq, hkv, dh, blk, mb, lengths, 7))
    tables = args[5].clone()
    tables[:, :16] = tables[0, :16]
    tables[1] = tables[0]
    lens = args[6].clone()
    lens[1] = lens[0]
    q = args[0].clone()
    q[1] = q[0]
    args[0], args[5], args[6] = q, tables, lens
    before = _build.launch_counts().get("paged_decode_attn", 0)
    got = paged_attention.paged_decode_attn(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["paged_decode_attn"] == before + 1
    want = paged_attention.paged_decode_attn_ref(*args)
    err = float((got - want).abs().max())
    assert err <= PAGED_TOL * float(want.abs().max()), err
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("split_positions", [16, 32, 128, 256])
def test_paged_kernel_at_each_split_size(card, monkeypatch, split_positions):
    """The sweep's split sizes at the serving shape: each agrees with the
    plain version, and the counters are left at zero for the next call."""
    from distributed_llm_code_samples_tpu_torch.ops import paged_attention
    monkeypatch.setattr(paged_attention, "SPLIT_POSITIONS", split_positions)
    tag, hq, hkv, dh, blk, mb, lengths = PAGED_CASES[0]
    args = paged_case("f32", hq, hkv, dh, blk, mb, lengths, split_positions)
    got = paged_attention.paged_decode_attn(*args)
    torch.cuda.synchronize()
    want = paged_attention.paged_decode_attn_ref(*args)
    assert float((got - want).abs().max()) <= PAGED_TOL * float(
        want.abs().max())
    counters, _ = paged_attention._workspace(args[0].device, 0, 0)
    assert int(counters.abs().sum()) == 0


@pytest.mark.cuda
def test_paged_kernel_streams_have_their_own_workspace(card):
    """Two streams of a card may run calls at once: each gets its own
    counters and partials, and both agree with the plain version."""
    from distributed_llm_code_samples_tpu_torch.ops import paged_attention
    tag, hq, hkv, dh, blk, mb, lengths = PAGED_CASES[0]
    args = paged_case("f32", hq, hkv, dh, blk, mb, lengths, 3)
    want = paged_attention.paged_decode_attn_ref(*args)
    streams = [torch.cuda.Stream() for _ in range(2)]
    got, spaces = [], []
    torch.cuda.synchronize()
    for st in streams:
        with torch.cuda.stream(st):
            got.append(paged_attention.paged_decode_attn(*args))
            spaces.append(paged_attention._workspace(args[0].device, 0, 0))
    torch.cuda.synchronize()
    assert spaces[0][0].data_ptr() != spaces[1][0].data_ptr()
    assert spaces[0][1].data_ptr() != spaces[1][1].data_ptr()
    for y in got:
        assert float((y - want).abs().max()) <= PAGED_TOL * float(
            want.abs().max())


@pytest.mark.cuda
def test_paged_shared_memory_plan_equals_the_kernels(card):
    """``smem_bytes`` (the plan) equals the kernel's own ``Smem``."""
    import ctypes
    from distributed_llm_code_samples_tpu_torch.ops import paged_attention
    f = _build.load_library("paged_decode_attn").paged_decode_attn_smem_bytes
    f.argtypes = [ctypes.c_int] * 6
    f.restype = ctypes.c_size_t
    for _, hq, hkv, dh, blk, mb, _ in PAGED_CASES:
        for code, itemsize in ((0, 4), (1, 2), (2, 1)):
            pos, splits = paged_attention.split_plan(1, hq, hkv, dh, blk, mb,
                                                     itemsize)[:2]
            assert f(hq // hkv, dh, pos, blk, splits, code) == \
                paged_attention.smem_bytes(hq // hkv, dh, pos, blk, splits,
                                           itemsize)


# -- bf16 storage: the flash kernels and the ring all-gather ------------------
#
# The LM's mixed trunk hands the flash kernels bf16 q, k, v (and dy, y);
# FSDP's mixed gathers hand the all-gather bf16 shards. The flash kernels
# compute the mxu_bf16 arithmetic on the bf16 values and round each output
# to bf16 once, so kernel and plain agree within TOL[True] of the plain
# output's max plus one bf16 step of it (an f32-level difference can flip
# one rounding); the gather moves the bits.

FLASH_BF16_SHAPES = FLASH_SHAPES + ((192, 512, 512, 64),)


def bf16_flash_case(shape):
    return tuple(t.bfloat16() for t in flash_case(shape))


def agree_bf16(got, again, want):
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, a)
        scale = float(w.float().abs().max())
        bf16_step = 2 ** -8 if w.dtype == torch.bfloat16 else 0.0
        err = float((g.float() - w.float()).abs().max())
        assert err <= (TOL[True] + bf16_step) * scale, err


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_BF16_SHAPES)
def test_flash_fwd_bf16_storage_matches_plain(card, shape, causal):
    q, k, v, _ = bf16_flash_case(shape)
    counts = _build.launch_counts()
    got = flash_attention_fwd(q, k, v, causal=causal)
    again = flash_attention_fwd(q, k, v, causal=causal)
    after = _build.launch_counts()
    assert after["flash_attn_fwd[bf16]"] == \
        counts.get("flash_attn_fwd[bf16]", 0) + 2
    assert after.get("flash_attn_fwd", 0) == counts.get("flash_attn_fwd", 0)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    agree_bf16(got, again, flash_attention_fwd_ref(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_BF16_SHAPES)
def test_flash_bwd_bf16_storage_matches_plain(card, shape, causal):
    q, k, v, dy = bf16_flash_case(shape)
    y, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    counts = _build.launch_counts()
    got = flash_attention_bwd(dy, q, k, v, y, lse, causal=causal)
    again = flash_attention_bwd(dy, q, k, v, y, lse, causal=causal)
    after = _build.launch_counts()
    for name in ("flash_attn_dkv[bf16]", "flash_attn_dq[bf16]"):
        assert after[name] == counts.get(name, 0) + 2
    assert all(g.dtype == torch.bfloat16 for g in got)
    agree_bf16(got, again,
               flash_attention_bwd_ref(dy, q, k, v, y, lse, causal=causal))


@pytest.mark.cuda
def test_flash_f32_bits_unchanged_beside_bf16(card):
    """An f32 call gives the same bits before and after bf16 calls of the
    same kernels (the storage type is a template parameter of its own)."""
    q, k, v, dy = flash_case((3, 64, 64, 16))
    y0, lse0 = flash_attention_fwd(q, k, v)
    g0 = flash_attention_bwd(dy, q, k, v, y0, lse0)
    qb, kb, vb, dyb = (t.bfloat16() for t in (q, k, v, dy))
    yb, lseb = flash_attention_fwd(qb, kb, vb)
    flash_attention_bwd(dyb, qb, kb, vb, yb, lseb)
    y1, lse1 = flash_attention_fwd(q, k, v)
    g1 = flash_attention_bwd(dy, q, k, v, y1, lse1)
    torch.cuda.synchronize()
    for a, b in zip((y0, lse0) + g0, (y1, lse1) + g1):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(768, 768), (192, 3072), (6, 10),
                                   (3, 1002)])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_ring_all_gather_bf16_bits_in_loopback(card, n, shape):
    """The gather of bf16 shards (FSDP's [768, 768] and [192, 3072] under
    mixed, a small one and a ragged one of an odd number of 4-byte words)
    is the float32 gather of the same bytes: bit for bit the plain
    concatenation, bf16 out, counted as ``ring_all_gather[bf16]``."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rng = np.random.default_rng(n)
    xs = [normal(rng, *shape).bfloat16() for _ in range(n)]
    ws = ring.PeerWorkspace(ring.workspace_bytes(ring.ALL_GATHER, xs[0], n),
                            "cuda", n=n)
    try:
        counts = _build.launch_counts()
        got = ring.loopback(ring.ALL_GATHER, xs, ws)
        again = ring.loopback(ring.ALL_GATHER, xs, ws)
        after = _build.launch_counts()
        assert after["ring_all_gather[bf16]"] == \
            counts.get("ring_all_gather[bf16]", 0) + 2
        assert after.get("ring_all_gather", 0) == \
            counts.get("ring_all_gather", 0)
        ws.check()
        for g, a, w in zip(got, again, ring.loopback_ref(ring.ALL_GATHER,
                                                          xs)):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert torch.equal(g.view(torch.int16), w.view(torch.int16))
            assert torch.equal(a.view(torch.int16), w.view(torch.int16))
    finally:
        ws.close()


@pytest.mark.cuda
def test_kernels_refuse_bf16_they_do_not_take(card):
    """No tensor reaches a kernel in a storage type it does not take:
    float16 at the hop, the all-to-all and the fused head's two kernels
    raises, naming the types they take (float32 and bf16 since the
    --dtype bfloat16 slice of the LM, transformer and MoE methods); a
    bf16 gather of an odd element count, a bf16 all-reduce or
    reduce-scatter whose chunk has an odd element count, FFN operands
    and head operands of two storage types raise too."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    ws = ring.PeerWorkspace(1 << 16, "cuda", n=2)
    try:
        xs = [torch.ones(8, 4, device="cuda", dtype=torch.float16)
              for _ in range(2)]
        for op in (ring.HOP, ring.ALL_TO_ALL):
            with pytest.raises(ValueError, match="bfloat16"):
                ring.loopback(op, xs, ws)
        with pytest.raises(ValueError, match="odd"):
            ring.loopback(ring.ALL_GATHER, [torch.ones(3, device="cuda",
                                                       dtype=torch.bfloat16)
                                            for _ in range(2)], ws)
        for op in (ring.ALL_REDUCE, ring.REDUCE_SCATTER):
            with pytest.raises(ValueError, match="odd"):
                ring.loopback(op, [torch.ones(2, 3, device="cuda",
                                              dtype=torch.bfloat16)
                                   for _ in range(2)], ws)
    finally:
        ws.close()
    w1, w2, x, _ = ffn_case((64, 32, 128))
    with pytest.raises(ValueError, match="one storage type"):
        p_ff.ffn_fwd_fused(w1.bfloat16(), w2.bfloat16(), x)
    h, w, t = head_case((16, 8, 40))
    with pytest.raises(ValueError, match="bfloat16"):
        p_fx.head_xent_stats(h.half(), w.half(), t)
    lse, _ = p_fx.head_xent_stats_ref(h, w, t)
    with pytest.raises(ValueError, match="bfloat16"):
        p_fx.head_xent_bwd(torch.tensor(1.0, device="cuda"), h.half(),
                           w.half(), t, lse)
    with pytest.raises(ValueError, match="one storage type"):
        p_fx.head_xent_stats(h.bfloat16(), w, t)

# -- bf16 storage in the FFN kernels and the ring sums (--dtype bfloat16) ---
#
# The FFN kernels on bf16 operands run their bf16-operand mode on copies
# widened to f32 and round each output element once; the plain version
# does the same in another order of f32 sums, so the two agree within a
# bf16 step of the output's largest element over TOL[True]. The ring
# sums round to bf16 after every add in the plain version's order: bit
# for bit. Shapes for the rings keep each chunk an even number of
# elements: the slice one, a ragged one (chunks of 140 elements, 70
# words: the scalar path), one of several ranges (25050 elements, 12525
# words) and an aligned one (30000 elements).

BF16_STEP = 2 ** -8
BF16_RING_SHAPES = {"slice": (256, 768), "ragged": (7, 5, 4),
                    "ranged": (25, 1002), "aligned": (30, 1000)}
FFN_BF16 = dict(FFN_FNS, dw=(p_ff.BWD_DW, p_ff.ffn_bwd_dw_fused,
                             p_ff.ffn_bwd_dw_ref))


def bf16_bits(a, b):
    return a.dtype == b.dtype == torch.bfloat16 and torch.equal(
        a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DW_SHAPES)
@pytest.mark.parametrize("kernel", sorted(FFN_BF16))
def test_ffn_kernels_bf16_storage_match_plain(card, kernel, shape):
    """Each FFN kernel on bf16 x, dy, w1 and w2 (the main, ragged and
    small shapes, and one with no dim a multiple of 4): bf16 outputs,
    two calls bit-equal, within (TOL[True] + one bf16 step) of the largest
    plain output, counted as ``<name>[bf16]`` and never as ``<name>``."""
    name, kern, plain = FFN_BF16[kernel]
    w1, w2, x, dy = (t.bfloat16() for t in ffn_case(shape))
    counts = _build.launch_counts()
    got = kern(dy, w1, w2, x)
    again = kern(dy, w1, w2, x)
    after = _build.launch_counts()
    assert after[name + "[bf16]"] == counts.get(name + "[bf16]", 0) + 2
    assert after.get(name, 0) == counts.get(name, 0)
    tup = (lambda v: v if isinstance(v, tuple) else (v,))
    agree_bf16(tup(got), tup(again), tup(plain(dy, w1, w2, x)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(FFN_BF16))
def test_ffn_bf16_kernels_take_weights_that_are_not_16_byte_aligned(
        card, kernel):
    """bf16 weights one element (2 bytes) into their storage give the
    same bits as aligned ones: the kernels stage them into an aligned
    bf16 copy for TMA and run the same tensor-core passes on it."""
    _, kern, _ = FFN_BF16[kernel]
    w1, w2, x, dy = (t.bfloat16() for t in ffn_case((300, 64, 256)))
    w1s = torch.empty(w1.numel() + 1, device="cuda",
                      dtype=torch.bfloat16)[1:].view_as(w1)
    w2s = torch.empty(w2.numel() + 1, device="cuda",
                      dtype=torch.bfloat16)[1:].view_as(w2)
    w1s.copy_(w1)
    w2s.copy_(w2)
    assert w1s.data_ptr() % 16 and w2s.data_ptr() % 16
    tup = (lambda v: v if isinstance(v, tuple) else (v,))
    for g, w in zip(tup(kern(dy, w1s, w2s, x)), tup(kern(dy, w1, w2, x))):
        assert bf16_bits(g, w)


@pytest.mark.cuda
def test_ffn_f32_bits_unchanged_beside_bf16(card):
    """An f32 call of each FFN kernel (both operand modes, through the
    partials: three token slices for the weight gradients) gives the
    same bits before and after bf16 calls of the same kernels."""
    w1, w2, x, dy = ffn_case((1000, 200, 520))
    tup = (lambda v: v if isinstance(v, tuple) else (v,))

    def run(args):
        return [o.clone() for mx in (False, True)
                for _, kern, _ in FFN_BF16.values()
                for o in tup(kern(*args, mxu_bf16=mx))]

    before = run((dy, w1, w2, x))
    run(tuple(t.bfloat16() for t in (dy, w1, w2, x)))
    for a, b in zip(before, run((dy, w1, w2, x))):
        assert torch.equal(a, b)


# -- the tensor-core passes of the FFN kernels (modes 1 and 2) ------------
#
# ffn_fwd, ffn_bwd_dx and ffn_bwd_dw with bf16 operands (mxu_bf16 on f32
# storage, mode 1; bf16 storage, mode 2) run wgmma fed by TMA
# (csrc/ffn_wgmma.cuh).
# Shapes: DW_SHAPES, then a T under one slice of the weight gradients, a
# ragged T whose last token slice is partial and a ragged ffn whose last
# slice of the input gradient is partial. The reference is float64 on the
# kernel's bf16 operands with its roundings (a and dh to bf16); mode 2's
# outputs are held in bf16 steps as chip_smoke.py holds them
# (BF16_SHARE), mode 1's f32 outputs to TOL[True] of the largest.

TC_SHAPES = DW_SHAPES + ((100, 64, 256), (5000, 200, 520), (256, 72, 3000))
BF16_SHARE = 0.05


def tc_args(shape, mode):
    w1, w2, x, dy = ffn_case(shape)
    if mode == 2:
        return tuple(v.bfloat16() for v in (dy, w1, w2, x)), {}
    return (dy, w1, w2, x), dict(mxu_bf16=True)


def tc_want64(kernel, dy, w1, w2, x):
    """float64 on the bf16-rounded operands, a and dh rounded to bf16."""
    x, dy, w1, w2 = (v.bfloat16().double() for v in (x, dy, w1, w2))
    h = x @ w1.T
    if kernel == "fwd":
        return (torch.where(h <= 0, 0.0, h).bfloat16().double() @ w2.T,)
    dh = torch.where(h <= 0, 0.0, dy @ w2).bfloat16().double()
    if kernel == "dx":
        return (dh @ w1,)
    return dh.T @ x, dy.T @ torch.where(h <= 0, 0.0, h).bfloat16().double()


def bf16_step_share(got, want):
    """``(max steps, share that differ)`` of bf16 ``got`` against float64
    ``want`` rounded to bf16, a step at the larger of an element's
    magnitude and the output's RMS."""
    w = want.bfloat16().double()
    g = got.double()
    rms = w.pow(2).mean().sqrt()
    _, e = torch.frexp(torch.maximum(torch.maximum(g.abs(), w.abs()), rms))
    steps = (g - w).abs() / torch.ldexp(torch.ones_like(w), e - 8)
    return float(steps.max()), float((g != w).double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("shape", TC_SHAPES)
@pytest.mark.parametrize("kernel", ["fwd", "dx", "dw"])
def test_ffn_tc_passes_against_float64(card, kernel, shape, mode):
    """Both modes at every shape: two calls bit-equal, counted once each
    (as ``<name>[bf16]`` on bf16 storage), mode 2 within one bf16 step of
    float64 in at most BF16_SHARE of the elements, mode 1 within
    TOL[True]."""
    name, kern, _ = FFN_BF16[kernel]
    args, kw = tc_args(shape, mode)
    count = name + "[bf16]" if mode == 2 else name
    before = _build.launch_counts().get(count, 0)
    tup = (lambda v: v if isinstance(v, tuple) else (v,))
    got, again = tup(kern(*args, **kw)), tup(kern(*args, **kw))
    torch.cuda.synchronize()
    assert _build.launch_counts()[count] == before + 2
    for g, a, w in zip(got, again, tc_want64(kernel, *args)):
        assert g.dtype == args[0].dtype and torch.equal(g, a)
        if mode == 2:
            most, share = bf16_step_share(g, w)
            assert most <= 1 and share <= BF16_SHARE, (most, share)
        else:
            err = float((g.double() - w).abs().max())
            assert err <= TOL[True] * float(w.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "dx", "dw"])
def test_ffn_tc_activations_not_16_byte_aligned(card, kernel):
    """bf16 x and dy one element into their storage go through the
    kernel's staged copies and give the bits of aligned ones."""
    _, kern, _ = FFN_BF16[kernel]
    (dy, w1, w2, x), _ = tc_args((300, 64, 256), 2)
    xs, dys = (torch.empty(v.numel() + 1, device="cuda",
                           dtype=torch.bfloat16)[1:].view_as(v)
               for v in (x, dy))
    xs.copy_(x)
    dys.copy_(dy)
    assert xs.data_ptr() % 16 and dys.data_ptr() % 16
    tup = (lambda v: v if isinstance(v, tuple) else (v,))
    for g, w in zip(tup(kern(dys, w1, w2, xs)), tup(kern(dy, w1, w2, x))):
        assert bf16_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("kernel", ["fwd", "dx", "dw"])
def test_ffn_tc_nan_in_h_passes_the_mask(card, kernel, mode):
    """A NaN in x makes a row of h NaN. where(h <= 0, 0, da) lets da
    through there, as the plain version does: dx's row stays finite and
    agrees; every output has NaN exactly where the plain version's has
    (the forward's y: that row, a = relu(h) keeping the NaN)."""
    _, kern, plain = FFN_BF16[kernel]
    (dy, w1, w2, x), kw = tc_args((300, 64, 256), mode)
    x = x.clone()
    x[5, 3] = float("nan")
    tup = (lambda v: v if isinstance(v, tuple) else (v,))
    got, want = tup(kern(dy, w1, w2, x, **kw)), tup(plain(dy, w1, w2, x, **kw))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        if not bool(ok.any()):      # dw2 sums a's NaN row into every element
            continue
        scale = float(w[ok].float().abs().max())
        err = float((g[ok].float() - w[ok].float()).abs().max())
        assert err <= (TOL[True] + 2 ** -8) * scale, err
    if kernel == "dx":
        assert bool(torch.isfinite(got[0][5].float()).all())


@pytest.mark.cuda
def test_ffn_tc_from_a_thread_of_its_own_and_from_autograd(card):
    """The tensor-core passes encode their TMA maps with a libcuda call,
    which needs a current context on the calling thread: called from a
    new thread, and from the fused block's backward on autograd's device
    thread, they give the main thread's bits."""
    import threading
    from distributed_llm_code_samples_tpu_torch.ops.fused_ffn import (
        fused_ffn_block)
    (dy, w1, w2, x), _ = tc_args((300, 64, 256), 2)
    want = (p_ff.ffn_bwd_dx_fused(dy, w1, w2, x),
            *p_ff.ffn_bwd_dw_fused(dy, w1, w2, x),
            p_ff.ffn_fwd_fused(w1, w2, x))
    got = []
    th = threading.Thread(target=lambda: got.extend(
        (p_ff.ffn_bwd_dx_fused(dy, w1, w2, x),
         *p_ff.ffn_bwd_dw_fused(dy, w1, w2, x),
         p_ff.ffn_fwd_fused(w1, w2, x))))
    th.start()
    th.join()
    assert len(got) == 4
    for g, w in zip(got, want):
        assert bf16_bits(g, w)
    w1g, w2g, xg = (v.clone().requires_grad_() for v in (w1, w2, x))
    y = fused_ffn_block(w1g, w2g, xg)
    y.backward(dy)
    for g, w in zip((xg.grad, w1g.grad, w2g.grad, y.detach()), want):
        assert bf16_bits(g, w)


@pytest.mark.cuda
def test_ffn_f32_bits_unchanged_beside_tc_calls(card):
    """f32 calls of all three kernels (mode 0, the CUDA-core passes; the
    weight gradients through three token slices) give the same bits
    before and after tensor-core calls of both backward kernels in both
    modes."""
    w1, w2, x, dy = ffn_case((1000, 200, 520))
    tup = (lambda v: v if isinstance(v, tuple) else (v,))

    def f32_calls():
        return [o.clone() for _, kern, _ in FFN_BF16.values()
                for o in tup(kern(dy, w1, w2, x))]

    before = f32_calls()
    for mode in (1, 2):
        args, kw = tc_args((1000, 200, 520), mode)
        for kernel in ("dx", "dw"):
            FFN_BF16[kernel][1](*args, **kw)
    for a, b in zip(before, f32_calls()):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(BF16_RING_SHAPES))
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("op", ["ring_all_reduce", "ring_reduce_scatter"])
def test_ring_bf16_sums_bits_in_loopback(card, op, n, shape):
    """The all-reduce and the reduce-scatter of bf16 tensors: every
    partial sum rounded to bf16 in the ring's order, bit for bit the
    plain version's, two calls bit-equal, bf16 out, counted as
    ``<op>[bf16]``."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    xs = [x.bfloat16() for x in ring_inputs(op, n, BF16_RING_SHAPES[shape])]
    ws = ring.PeerWorkspace(max(ring.workspace_bytes(op, xs[0], n), 1),
                            "cuda", n=n)
    try:
        counts = _build.launch_counts()
        got = ring.loopback(op, xs, ws)
        again = ring.loopback(op, xs, ws)
        after = _build.launch_counts()
        assert after[op + "[bf16]"] == counts.get(op + "[bf16]", 0) + 2
        assert after.get(op, 0) == counts.get(op, 0)
        ws.check()
        for g, a, w in zip(got, again, ring.loopback_ref(op, xs)):
            assert g.shape == w.shape
            assert bf16_bits(g, w) and bf16_bits(a, w)
    finally:
        ws.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ring_bf16_sums_in_sequence_with_f32_calls(card, n):
    """bf16 all-reduces and reduce-scatters mixed into a sequence of f32
    and bf16 calls of every ring op on one workspace (the landing regions
    in turn, DDP's dw1 and dw2 of the main path among them): every
    output bit-identical to its plain version."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rng = np.random.default_rng(70 + n)
    bf, f32 = torch.bfloat16, torch.float32
    seq = ((ring.ALL_REDUCE, (n * 768, 768), bf),
           (ring.ALL_GATHER, (6, 34), bf),
           (ring.REDUCE_SCATTER, (n * 64, 48), bf),
           (ring.HOP, (5, 7), f32), (ring.ALL_REDUCE, (n * 4, 34), f32),
           (ring.ALL_REDUCE, (n * 4, 34), bf),
           (ring.REDUCE_SCATTER, (n * 5, 8), f32),
           (ring.ALL_TO_ALL, (n * 3, 101), f32),
           (ring.REDUCE_SCATTER, (n * 192, 3072), bf),
           (ring.ALL_REDUCE, (3072, 768), bf),
           (ring.ALL_REDUCE, (768, 3072), bf))
    ws = ring.PeerWorkspace(4 * 3072 * 768, "cuda", n=n)
    try:
        for i, (op, shape, dtype) in enumerate(seq + seq):
            xs = [normal(rng, *shape).to(dtype) for _ in range(n)]
            got = ring.loopback(op, xs, ws)
            for g, w in zip(got, ring.loopback_ref(op, xs)):
                assert g.dtype == dtype and torch.equal(
                    g.view(torch.int16), w.view(torch.int16)), (i, op)
        ws.check()
    finally:
        ws.close()


# -- the fused head, the hop and the all-to-all on bf16 storage ------------

def bf16_near(got, want, share=0.05):
    """``got`` (bf16) within one bf16 step of ``want`` rounded to bf16, a
    step at the larger of an element's magnitude and ``want``'s RMS, in
    at most ``share`` of the elements (an f32 sum rounds to the other
    neighbour only near a rounding tie)."""
    assert got.dtype == torch.bfloat16
    w = want.to(torch.bfloat16).double()
    g = got.double()
    rms = w.pow(2).mean().sqrt()
    _, e = torch.frexp(torch.maximum(torch.maximum(g.abs(), w.abs()), rms))
    steps = (g - w).abs() / torch.ldexp(torch.ones_like(w), e - 8)
    return float(steps.max()) <= 1 and float((g != w).double().mean()) <= \
        share


def head_want_bf16(h, w, t, lse):
    """The head backward in float64 on bf16 ``h``, ``w`` as the kernels
    compute it: ``dz`` rounded to bf16 before both products."""
    z = h.double() @ w.double().T
    n, v = z.shape
    tl = t.long()
    valid = (tl >= 0) & (tl < v)
    p = (z - lse.double()[:, None]).exp()
    rows = valid.nonzero()[:, 0]
    p[rows, tl[rows]] -= 1.0
    dz = (p / n).to(torch.bfloat16).double()
    return dz @ w.double(), dz.T @ h.double()


HEAD_BF16_SHAPES = HEAD_SHAPES + HEAD_BWD_RAGGED


def head_case_bf16(shape):
    h, w, t = head_case(shape)
    return h.bfloat16(), w.bfloat16(), t


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HEAD_BF16_SHAPES)
def test_head_stats_bf16_storage_matches_plain(card, shape):
    """The statistics of bf16 h and w: f32 lse and tz within 1e-4 of the
    plain version and of float64 on the same values (the logits are f32
    products of the exact values); targets -1 and V give tz 0; two calls
    bit-equal, counted as ``head_xent_stats[bf16]``."""
    h, w, t = head_case_bf16(shape)
    t[0], t[1] = -1, shape[2]
    counts = _build.launch_counts()
    got = p_fx.head_xent_stats(h, w, t)
    again = p_fx.head_xent_stats(h, w, t)
    after = _build.launch_counts()
    name = p_fx.STATS_COUNT
    assert after[name + "[bf16]"] == counts.get(name + "[bf16]", 0) + 2
    assert after.get(name, 0) == counts.get(name, 0)
    assert all(g.dtype == torch.float32 for g in got)
    assert float(got[1][0]) == 0.0 and float(got[1][1]) == 0.0
    agree(got, again, p_fx.head_xent_stats_ref(h, w, t), False)
    for g, w64 in zip(got, p_fx.head_xent_stats_ref(h.double(), w.double(),
                                                    t)):
        err = float((g.double() - w64).abs().max())
        assert err <= 1e-4 * float(w64.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HEAD_BF16_SHAPES)
def test_head_bwd_bf16_storage_matches_plain(card, shape):
    """The backward on bf16 storage (one vocab chunk, and three past the
    8192-column chunk, whose dh sums across the chunks in f32 and rounds
    once): bf16 dh and dw within one bf16 step of the plain version and
    of float64 with dz rounded to bf16, in at most 5% of them; two calls
    bit-equal, counted as ``head_xent_bwd[bf16]``."""
    h, w, t = head_case_bf16(shape)
    lse, _ = p_fx.head_xent_stats_ref(h, w, t)
    dy = torch.tensor(1.0, device="cuda")
    counts = _build.launch_counts()
    got = p_fx.head_xent_bwd(dy, h, w, t, lse)
    again = p_fx.head_xent_bwd(dy, h, w, t, lse)
    after = _build.launch_counts()
    name = p_fx.BWD_COUNT
    assert after[name + "[bf16]"] == counts.get(name + "[bf16]", 0) + 2
    assert after.get(name, 0) == counts.get(name, 0)
    for g, a, p, w64 in zip(got, again, p_fx.head_xent_bwd_ref(
            dy, h, w, t, lse), head_want_bf16(h, w, t, lse)):
        assert bf16_bits(g, a)
        assert bf16_near(g, p.double()) and bf16_near(g, w64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VOCAB_SHARDS[1:])
def test_head_bf16_on_a_vocab_shard(card, shape):
    """Each rank's bf16 rows of w with the targets shifted by its first
    row (some in the pad range of an unaligned shard): its f32 lse and tz
    within 1e-4 of the plain version's, and its bf16 dh and dw given the
    merged lse within one bf16 step of the plain version's."""
    n, d, v, ranks = shape
    vl = v // ranks
    rng = np.random.default_rng(v)
    h = normal(rng, n, d).bfloat16()
    w = normal(rng, v, d, scale=0.02).bfloat16()
    t = rng.integers(0, v, size=n)
    j = np.arange(n // 2)
    t[:n // 2] = ((j // 3) % (ranks - 1) + 1) * vl + j % 3
    t = torch.from_numpy(t).cuda()
    dy = torch.tensor(1.0, device="cuda")
    lse_g = p_fx.head_xent_stats_ref(h, w, t)[0]
    for r in range(ranks):
        wr, tr = w[r * vl:(r + 1) * vl], t - r * vl
        got = p_fx.head_xent_stats(h, wr, tr)
        agree(got, got, p_fx.head_xent_stats_ref(h, wr, tr), False)
        for g, p in zip(p_fx.head_xent_bwd(dy, h, wr, tr, lse_g),
                        p_fx.head_xent_bwd_ref(dy, h, wr, tr, lse_g)):
            assert bf16_near(g, p.double())


@pytest.mark.cuda
def test_head_f32_bits_unchanged_beside_bf16(card):
    """The f32 head backward's digest (``chip_smoke.py``'s stored one)
    holds after bf16 calls of both head kernels."""
    h, w, t = head_case_bf16((300, 45, 16411))
    lse, _ = p_fx.head_xent_stats(h, w, t)
    p_fx.head_xent_bwd(torch.tensor(1.0, device="cuda"), h, w, t, lse)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    assert chip_smoke.head_bits_digest(torch, np, p_fx) == \
        chip_smoke.HEAD_BITS_SHA256


# the hop's and the all-to-all's bf16 blocks at n ranks: an even element
# count a chunk (the kernel on the words), an odd one (105 for the hop, 5
# a chunk for the all-to-all: through the padded copies), and the main
# path's (the hop's block; EP's dispatch operand at n = 4)
BF16_MOVE_SHAPES = {"hop": {"even": lambda n: (3, 16),
                            "odd": lambda n: (3, 5, 7),
                            "main": lambda n: (768, 3072)},
                    "a2a": {"even": lambda n: (2 * n, 6, 16),
                            "odd": lambda n: (n, 5),
                            "main": lambda n: (2 * n, 512, 768)}}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["even", "odd", "main"])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("op", ["hop", "a2a"])
def test_hop_and_a2a_bf16_bits_in_loopback(card, op, n, shape):
    """The hop and the all-to-all of bf16 blocks move the bits: bit for
    bit the plain version's (also an odd element count a chunk), two
    calls bit-equal, bf16 out, counted as ``<op>[bf16]``."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    name = {"hop": ring.HOP, "a2a": ring.ALL_TO_ALL}[op]
    rng = np.random.default_rng(n)
    xs = [normal(rng, *BF16_MOVE_SHAPES[op][shape](n)).bfloat16()
          for _ in range(n)]
    assert ring._odd(name, xs[0], n) == (shape == "odd")
    ws = ring.PeerWorkspace(ring.workspace_bytes(name, xs[0], n), "cuda",
                            n=n)
    try:
        counts = _build.launch_counts()
        got = ring.loopback(name, xs, ws)
        again = ring.loopback(name, xs, ws)
        after = _build.launch_counts()
        assert after[name + "[bf16]"] == counts.get(name + "[bf16]", 0) + 2
        assert after.get(name, 0) == counts.get(name, 0)
        ws.check()
        for g, a, w in zip(got, again, ring.loopback_ref(name, xs)):
            assert g.shape == w.shape
            assert bf16_bits(g, w) and bf16_bits(a, w)
    finally:
        ws.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ring_bf16_moves_in_sequence_with_other_calls(card, n):
    """bf16 hops and all-to-alls (even and odd element counts) mixed into
    a sequence of f32 and bf16 calls of every ring op on one workspace
    (the landing regions in turn): every output bit-identical to its
    plain version."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rng = np.random.default_rng(80 + n)
    bf, f32 = torch.bfloat16, torch.float32
    seq = ((ring.HOP, (5, 7), bf), (ring.ALL_TO_ALL, (n * 8, 64), bf),
           (ring.ALL_GATHER, (6, 34), bf), (ring.HOP, (768, 3072), bf),
           (ring.ALL_REDUCE, (n * 4, 34), bf),
           (ring.ALL_TO_ALL, (n * 3, 5), bf),
           (ring.REDUCE_SCATTER, (n * 5, 8), f32),
           (ring.ALL_TO_ALL, (n * 3, 101), f32), (ring.HOP, (3, 5), bf),
           (ring.ALL_TO_ALL, (2 * n, 512, 768), bf),
           (ring.ALL_REDUCE, (3072, 768), bf))
    ws = ring.PeerWorkspace(4 * 3072 * 768, "cuda", n=n)
    try:
        for i, (op, shape, dtype) in enumerate(seq + seq):
            xs = [normal(rng, *shape).to(dtype) for _ in range(n)]
            got = ring.loopback(op, xs, ws)
            for g, w in zip(got, ring.loopback_ref(op, xs)):
                assert g.dtype == dtype and torch.equal(
                    g.view(torch.int16), w.view(torch.int16)), (i, op)
        ws.check()
    finally:
        ws.close()


# -- the flash kernels as the ring attention of sequence parallelism calls them

@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", [None, "flash"])
def test_ring_attention_flash_pair_under_global_lse(card, attn_impl):
    """The causal ring of 4 loopback ranks (``parallel/sequence.py``) at 2
    sequences x 3 heads of 4 x 48 positions (blocks no tile divides), the
    flash kernels on each hop's block with the backward handed the ring's
    global ``y`` and ``lse``: ``y``, ``lse``, ``dq``, ``dk``, ``dv``
    within 1e-4 of float64 attention over the whole sequence, as the
    plain ring's (``attn_impl=None``); the kernels launched on the 10 of
    16 hops the mask leaves, forward and backward. Handing each hop's
    backward its own ``lse`` instead misses by far more."""
    from distributed_llm_code_samples_tpu_torch.parallel import (
        SEQ_AXIS, launch, make_mesh)
    from distributed_llm_code_samples_tpu_torch.parallel import sequence
    rng = np.random.default_rng(90)
    q, k, v = (normal(rng, 2, 3, 192, 40) for _ in range(3))
    dy = normal(rng, 2, 3, 192, 40, scale=0.1)

    def ring(mesh, _):
        r = mesh.axis_index(SEQ_AXIS)
        qb, kb, vb, dyb = (t.chunk(4, -2)[r].contiguous()
                           for t in (q, k, v, dy))
        y, lse = sequence.ring_attention_fwd(qb, kb, vb, mesh,
                                             attn_impl=attn_impl)
        return (y, lse, *sequence.ring_attention_bwd(
            qb, kb, vb, y, lse, dyb, mesh, attn_impl=attn_impl))

    def run():
        outs = launch(ring, make_mesh({SEQ_AXIS: 4}, loopback=True),
                      timeout=120)
        torch.cuda.synchronize()
        return [torch.cat([o[i] for o in outs], -1 if i == 1 else -2)
                for i in range(5)]

    before = _build.launch_counts()
    got = run()
    after = _build.launch_counts()
    hops = 10 if attn_impl == "flash" else 0
    for name in ("flash_attn_fwd", "flash_attn_dkv", "flash_attn_dq"):
        assert after.get(name, 0) == before.get(name, 0) + hops
    q64, k64, v64, dy64 = (t.double() for t in (q, k, v, dy))
    y64, lse64 = flash_attention_fwd_ref(q64, k64, v64)
    want = [y64, lse64, *flash_attention_bwd_ref(dy64, q64, k64, v64, y64,
                                                 lse64)]

    def err(g, w):
        return float((g.double() - w).abs().max() / w.abs().max())

    for g, w in zip(got, want):
        assert err(g, w) <= 1e-4
    if attn_impl == "flash":
        bwd = p_fa.flash_attention_bwd

        def own_lse(dy_, q_, k_, v_, y_, lse_, **kw):
            return bwd(dy_, q_, k_, v_, y_,
                       flash_attention_fwd(q_, k_, v_, causal=kw["causal"])[1],
                       **kw)

        p_fa.flash_attention_bwd = own_lse
        try:
            control = run()
        finally:
            p_fa.flash_attention_bwd = bwd
        assert min(err(g, w) for g, w in zip(control[2:], want[2:])) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_guarded_step_skips_a_poisoned_seed_on_the_card(card, dtype):
    """The skip-step guard through the FFN kernels (``train_single``,
    ``use_pallas``): a clean guarded step equals the unguarded one bit for
    bit, a poisoned seed (a NaN upstream gradient) leaves the params bit
    for bit unchanged and counts one skip, and no step reads anything
    back to the host (``torch.cuda.set_sync_debug_mode("error")`` raises
    on any synchronising call)."""
    from distributed_llm_code_samples_tpu_torch.data import POISON_NAN_BIT
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.parallel import train_single
    from distributed_llm_code_samples_tpu_torch.runtime.guardrails import (
        GuardrailConfig, summarize)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    params = init_ffn_stack(gen, 128, 2, dtype=dtype)
    kw = dict(lr=0.1, use_pallas=True)
    clean = train_single(params, [11], 256, 128, **kw)
    torch.cuda.synchronize()
    before = _build.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, g = train_single(params, [11, 11 | POISON_NAN_BIT], 256, 128,
                              guard=GuardrailConfig(), return_guard=True,
                              **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = _build.launch_counts()
    tag = "[bf16]" if dtype == torch.bfloat16 else ""
    assert after.get("ffn_fwd" + tag, 0) - before.get("ffn_fwd" + tag, 0) \
        == 4
    assert summarize(g) == {"skipped": 1, "overflows": 0, "loss_scale": 1.0,
                            "good_steps": 0}
    assert all(torch.equal(a, b) for a, b in zip(out, clean))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("shape", [(8192, 768, 3072), (1000, 200, 520),
                                   (1001, 13, 9)])
def test_ffn_fwd_tc_a_equals_the_weight_gradients(card, shape, mode):
    """The forward's pass 1 stores a = relu(x w1^T) as bf16 with the
    near-zero re-sums of the backward kernels' pass 1: its a is bit for
    bit the a that ffn_bwd_dw's pass 1 stores for the same inputs."""
    (dy, w1, w2, x), _ = tc_args(shape, mode)
    t, d = x.shape
    f = w1.shape[0]
    sms = p_ff._sms(x)

    def a_of(name, tensors, scratch_fn, plan_fn):
        buf, pieces = p_ff._launch_tc(name, tensors, scratch_fn,
                                      plan_fn(t, d, f, sms), t, d, f, mode,
                                      sms)
        torch.cuda.synchronize()
        (rows, cols), off = pieces["a"]
        return buf[off:off + 2 * rows * cols].view(torch.bfloat16).view(
            rows, cols)[:, :f]

    a_fwd = a_of(p_ff.FWD, [x, w1, w2, torch.empty_like(x)],
                 p_ff.tc_fwd_scratch, p_ff.tc_fwd_plan)
    a_dw = a_of(p_ff.BWD_DW, [x, dy, w1, w2, torch.empty_like(w1),
                              torch.empty_like(w2)],
                p_ff.tc_dw_scratch, p_ff.tc_dw_plan)
    assert bf16_bits(a_fwd, a_dw)
    want = torch.relu(x.bfloat16().double() @ w1.bfloat16().double().T)
    assert bf16_near(a_fwd, want, BF16_SHARE)


# -- the tensor-core passes of the head backward (modes 1 and 2) ----------
#
# head_xent_bwd with bf16 operands (mxu_bf16 on f32 storage, mode 1; bf16
# storage, mode 2) runs its z pass and both products as wgmma fed by TMA,
# the vocabulary in the chunks of head_tc_plan. (N, d, V, target shift):
# the LM's shape, one TP rank's 12576 rows of it with the targets shifted
# by the rank's first row (three in four outside the shard), a ragged one
# with no dim a multiple of 8 (the staged copies), a prime V past one
# chunk with d 45, and a vocabulary under one tile.

HEAD_TC_SHAPES = ((8192, 768, 50304, 0), (8192, 768, 12576, 12576),
                  (1001, 203, 1013, 0), (300, 45, 16411, 0),
                  (37, 20, 201, 0))


def head_tc_case(shape, mode):
    n, d, v, shift = shape
    rng = np.random.default_rng(n + v)
    h, w = normal(rng, n, d), normal(rng, v, d, scale=0.02)
    t = torch.from_numpy(rng.integers(0, v + shift + 3, size=n)).cuda()
    t = t - shift
    t[0], t[1], t[2], t[-1] = -1, v, 0, v - 1
    if mode == 2:
        h, w = h.bfloat16(), w.bfloat16()
    kw = {} if mode == 2 else dict(mxu_bf16=True)
    lse, _ = p_fx.head_xent_stats_ref(h, w, t, **kw)
    return h, w, t, lse, kw


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("shape", HEAD_TC_SHAPES,
                         ids=["main", "tp_shard", "ragged", "prime", "tiny"])
def test_head_tc_passes_against_float64(card, shape, mode):
    """Both modes: two calls bit-equal, counted once each (as
    ``head_xent_bwd[bf16]`` on bf16 storage); against float64 on the
    bf16 operands with dz rounded to bf16 (``head_want_bf16``), mode 2
    within one bf16 step in at most BF16_SHARE of the elements and mode 1
    within TOL[True] of the largest output; and against the plain
    version."""
    h, w, t, lse, kw = head_tc_case(shape, mode)
    dy = torch.tensor(1.0, device="cuda")
    count = p_fx.BWD_COUNT + ("[bf16]" if mode == 2 else "")
    before = _build.launch_counts().get(count, 0)
    got = p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)
    again = p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[count] == before + 2
    want64 = head_want_bf16(h.bfloat16(), w.bfloat16(), t, lse)
    plain = p_fx.head_xent_bwd_ref(dy, h, w, t, lse, **kw)
    for g, a, w64, p in zip(got, again, want64, plain):
        assert g.dtype == h.dtype and torch.equal(g, a)
        if mode == 2:
            assert bf16_near(g, w64, BF16_SHARE)
            assert bf16_near(g, p.double(), BF16_SHARE)
        else:
            for ref in (w64, p.double()):
                err = float((g.double() - ref).abs().max())
                assert err <= TOL[True] * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2])
def test_head_tc_operands_not_16_byte_aligned(card, mode):
    """h and w one element into their storage (mode 2: staged into bf16
    copies; mode 1 copies them anyway) give the bits of aligned ones."""
    h, w, t, lse, kw = head_tc_case((300, 64, 1000, 0), mode)
    dy = torch.tensor(1.0, device="cuda")
    hs, ws = (torch.empty(v.numel() + 1, device="cuda",
                          dtype=v.dtype)[1:].view_as(v) for v in (h, w))
    hs.copy_(h)
    ws.copy_(w)
    assert hs.data_ptr() % 16 and ws.data_ptr() % 16
    for g, a in zip(p_fx.head_xent_bwd(dy, hs, ws, t, lse, **kw),
                    p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)):
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [256, 1024, 4096])
def test_head_tc_chunks_agree(card, monkeypatch, chunk):
    """Other vocabulary chunks (dh summed over more of them in f32) stay
    within one bf16 step of float64 and repeat bit for bit."""
    h, w, t, lse, _ = head_tc_case((300, 45, 16411, 0), 2)
    monkeypatch.setattr(p_fx, "HEAD_TC_CHUNK", chunk)
    assert p_fx.head_tc_plan(16411)[0] == -(-16411 // chunk)
    dy = torch.tensor(1.0, device="cuda")
    got = p_fx.head_xent_bwd(dy, h, w, t, lse)
    again = p_fx.head_xent_bwd(dy, h, w, t, lse)
    for g, a, w64 in zip(got, again, head_want_bf16(h, w, t, lse)):
        assert bf16_bits(g, a) and bf16_near(g, w64, BF16_SHARE)


@pytest.mark.cuda
def test_head_tc_from_autograd(card):
    """The fused head's backward runs on autograd's device thread, which
    holds no current context until the tensor-core call binds the
    operand's device: its gradients equal the direct call's bits."""
    h, w, t, _, _ = head_tc_case((256, 64, 1000, 0), 2)
    lse, _ = p_fx.head_xent_stats(h, w, t)
    want = p_fx.head_xent_bwd(torch.tensor(1.0, device="cuda"), h, w, t,
                              lse)
    hg, wg = (v.clone().requires_grad_() for v in (h, w))
    p_fx.head_xent(hg, wg, t).backward()
    for g, x in zip((hg.grad, wg.grad), want):
        assert bf16_bits(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 768, 50304), (8192, 768, 12576),
                                   (1001, 203, 1013), (37, 20, 201)])
def test_head_bwd_scratch_mirror_equals_the_library(card, shape):
    """``fused_xent.bwd_scratch_floats`` (mode 0's layout in Python)
    equals the library's own ``head_xent_bwd_scratch_floats``; the
    library refuses the tensor-core modes, whose pieces come from
    ``head_tc_scratch``."""
    assert p_fx._bwd_scratch_floats(*shape) == \
        p_fx.bwd_scratch_floats(*shape)
    fn = _build.load_library(p_fx.BWD).head_xent_bwd_scratch_floats
    assert fn(*shape, 1) == -1 and fn(*shape, 2) == -1


# -- the statistics and the flash forward on the tensor cores ----------------
#
# Modes 1 and 2 of head_xent_stats (csrc/head_xent_fwd.cu,
# head_stats_tc_kernel) and the flash forward on bf16 storage
# (csrc/flash_attn_fwd.cu, flash_fwd_tc_kernel) run wgmma fed by TMA. The
# statistics stay f32: within 1e-4 of float64 on the bf16 values (the
# tensor cores sum a k16 step in another order than an FMA chain). The
# flash forward's y rounds to bf16 once: within two bf16 steps of float64
# row by row (chip_smoke.py's BF16_BLOCK_TOL), and its plain version
# within TOL[True] plus one step.

# (N, d, V, target shift): the LM's TP shard scaled down, a vocabulary
# past many slices with its last tile ragged, d not a multiple of 8
# (mode 2 stages it), one under a tile
STATS_TC_SHAPES = ((300, 64, 1000, 0), (1000, 200, 50257, 0),
                   (256, 96, 12576, 12576), (131, 45, 8209, 0),
                   (37, 20, 201, 0))


def stats_want64(h, w, t):
    """lse and tz in float64 on the operands as given (bf16 values, or
    f32 rounded to bf16 for mode 1)."""
    return p_fx.head_xent_stats_ref(h.double(), w.double(), t)


def rel_close(got, want, tol=1e-4):
    err = float((got.double() - want).abs().max())
    return err <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("shape", STATS_TC_SHAPES)
def test_head_stats_tc_matches_float64_and_plain(card, shape, mode):
    """lse and tz f32 within 1e-4 of float64 on the bf16 operands and of
    the plain version, two calls bit-equal, counted as
    ``head_xent_stats[bf16]`` (mode 2) or ``head_xent_stats`` (mode 1);
    targets -1, V and the shifted ones outside the shard give tz 0. The
    statistics without the last vocabulary tile fail the check."""
    h, w, t, _, kw = head_tc_case(shape, mode)
    name = p_fx.STATS_COUNT + ("[bf16]" if mode == 2 else "")
    before = _build.launch_counts().get(name, 0)
    got = p_fx.head_xent_stats(h, w, t, **kw)
    again = p_fx.head_xent_stats(h, w, t, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 2
    hb, wb = h.bfloat16(), w.bfloat16()
    want64 = stats_want64(hb, wb, t)
    plain = p_fx.head_xent_stats_ref(h, w, t, **kw)
    for g, a, w64, p in zip(got, again, want64, plain):
        assert g.dtype == torch.float32 and torch.equal(g, a)
        assert rel_close(g, w64) and rel_close(g, p.double())
    outside = (t < 0) | (t >= w.shape[0])
    assert bool(outside.any()) and bool((got[1][outside] == 0).all())
    v = w.shape[0]
    if v > 256:
        cut = (v - 1) // 256 * 256
        control = stats_want64(hb, wb[:cut], t)
        assert not all(rel_close(g, c) for g, c in zip(got, control))


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 7])
def test_head_stats_tc_other_slices_agree(card, monkeypatch, slices):
    """Other vocabulary slicings (the merge over more or fewer slices)
    stay within 1e-4 of float64 and repeat bit for bit."""
    h, w, t, _, _ = head_tc_case((300, 64, 16411, 0), 2)
    vt = -(-16411 // 256)
    per = -(-vt // slices)
    plan = (-(-vt // per), per * 256)
    monkeypatch.setattr(p_fx, "stats_tc_plan", lambda *_: plan)
    got = p_fx.head_xent_stats(h, w, t)
    again = p_fx.head_xent_stats(h, w, t)
    for g, a, w64 in zip(got, again, stats_want64(h, w, t)):
        assert torch.equal(g, a) and rel_close(g, w64)


@pytest.mark.cuda
def test_head_stats_tc_operands_not_16_byte_aligned(card):
    """bf16 h and w one element into their storage are staged into bf16
    copies and give the bits of aligned ones."""
    h, w, t, _, _ = head_tc_case((300, 64, 1000, 0), 2)
    hs, ws = (torch.empty(v.numel() + 1, device="cuda",
                          dtype=v.dtype)[1:].view_as(v) for v in (h, w))
    hs.copy_(h)
    ws.copy_(w)
    assert hs.data_ptr() % 16 and ws.data_ptr() % 16
    for g, a in zip(p_fx.head_xent_stats(hs, ws, t),
                    p_fx.head_xent_stats(h, w, t)):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_head_stats_tc_from_a_thread_and_from_autograd(card):
    """The statistics encode their TMA maps with a libcuda call, which
    needs a current context: from a thread of its own and from autograd's
    device thread they give the main thread's bits."""
    import threading
    h, w, t, _, _ = head_tc_case((256, 64, 1000, 0), 2)
    want = p_fx.head_xent_stats(h, w, t)
    got = []
    th = threading.Thread(target=lambda: got.append(
        p_fx.head_xent_stats(h, w, t)))
    th.start()
    th.join()
    assert len(got) == 1
    x = torch.zeros(1, device="cuda", requires_grad=True)
    _CallInBackward.apply(x, lambda: got.append(
        p_fx.head_xent_stats(h, w, t))).sum().backward()
    assert len(got) == 2
    for call in got:
        for g, a in zip(call, want):
            assert torch.equal(g, a)


class _CallInBackward(torch.autograd.Function):
    """Runs ``fn`` from the backward, on autograd's device thread."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.fn()
        return g, None


@pytest.mark.cuda
def test_head_stats_bits_unchanged_by_the_tensor_cores(card):
    """Mode 0 (f32, the GEMM core) keeps its bits: chip_smoke.py's digest
    of one small f32 call, stored from the build before modes 1 and 2
    moved to the tensor cores."""
    import chip_smoke
    assert chip_smoke.stats_bits_digest(torch, np, p_fx) == \
        chip_smoke.STATS_BITS_SHA256


def flash_f64_err(got, q, k, v, causal):
    """The worst row of y against float64 on the bf16 values (p rounded
    to bf16, as the kernel rounds it), |row - row64| / |row64|, and lse's
    largest error over its largest magnitude."""
    y64, lse64 = flash_attention_fwd_ref(q.double(), k.double(), v.double(),
                                         causal=causal, mxu_bf16=True)
    y, lse = (g.double() for g in got)
    rows = ((y - y64).norm(dim=-1) / y64.norm(dim=-1).clamp_min(1e-30))
    return max(float(rows.max()), float((lse - lse64).abs().max())
               / float(lse64.abs().max()))


# (BH, Tq, Tk, dh): the LM's heads, one TP rank's 3 heads, a sequence
# hop, the ragged shapes of chip_smoke.py, Tq != Tk, dh 16
FLASH_TC_SHAPES = ((192, 512, 512, 64), (48, 512, 512, 64),
                   (24, 1024, 1024, 64), (24, 200, 200, 40),
                   (2, 80, 130, 64), (3, 64, 64, 16), (4, 257, 257, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_TC_SHAPES)
def test_flash_fwd_tc_matches_float64(card, shape, causal):
    """y within two bf16 steps of float64 row by row, lse within 1e-4,
    two calls bit-equal; causal flipped fails the check."""
    q, k, v, _ = bf16_flash_case(shape)
    got = flash_attention_fwd(q, k, v, causal=causal)
    again = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert flash_f64_err(got, q, k, v, causal) <= 2 ** -7
    flipped = flash_attention_fwd(q, k, v, causal=not causal)
    assert flash_f64_err(flipped, q, k, v, causal) > 2 ** -7


@pytest.mark.cuda
def test_flash_fwd_tc_staged_operands(card):
    """dh 36 (rows not a multiple of 8 elements) and operands one element
    into their storage go through zero-padded copies: within the limits
    of the plain version, and an unaligned call gives the aligned one's
    bits."""
    q, k, v, _ = bf16_flash_case((4, 100, 100, 36))
    got = flash_attention_fwd(q, k, v)
    agree_bf16(got, flash_attention_fwd(q, k, v),
               flash_attention_fwd_ref(q, k, v))
    q, k, v, _ = bf16_flash_case((4, 100, 100, 64))
    off = [torch.empty(x.numel() + 1, device="cuda",
                       dtype=x.dtype)[1:].view_as(x) for x in (q, k, v)]
    for o, x in zip(off, (q, k, v)):
        o.copy_(x)
    assert all(o.data_ptr() % 16 for o in off)
    for g, a in zip(flash_attention_fwd(*off), flash_attention_fwd(q, k, v)):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_flash_fwd_tc_from_autograd(card):
    """The forward called on autograd's device thread (as FSDP's backward
    recomputes a block) gives the main thread's bits."""
    q, k, v, _ = bf16_flash_case((24, 200, 200, 40))
    want = flash_attention_fwd(q, k, v)
    got = []
    x = torch.zeros(1, device="cuda", requires_grad=True)
    _CallInBackward.apply(x, lambda: got.append(
        flash_attention_fwd(q, k, v))).sum().backward()
    assert len(got) == 1
    assert all(torch.equal(g, a) for g, a in zip(got[0], want))


@pytest.mark.cuda
def test_flash_fwd_bits_unchanged_by_the_tensor_cores(card):
    """Mode 0 (f32, the CUDA cores) keeps its bits: chip_smoke.py's digest
    of two small f32 calls, stored from the build before bf16 storage
    moved to the tensor cores."""
    import chip_smoke
    assert chip_smoke.flash_fwd_bits_digest(torch, np, p_fa) == \
        chip_smoke.FLASH_FWD_BITS_SHA256


# -- the flash backward on the tensor cores (bf16 storage) -----------------

def flash_bwd_f64_err(got, dy, q, k, v, y, lse, causal):
    """The worst of dq, dk and dv against float64 on the bf16 values (p
    and ds rounded to bf16, as the kernels round them), by chip_smoke.py's
    measure: the 99th percentile over rows of |row - row64| / |row64|,
    over the rows that are not zero in exact arithmetic (each head's
    first dq row when causal: ds_00 = p_00 (dp_00 - D_0) = 0), which here
    are under 1e-3 of the largest row."""
    want = flash_attention_bwd_ref(*(a.double() for a in (dy, q, k, v, y)),
                                   lse.double(), causal=causal, mxu_bf16=True)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = (x.double().reshape(-1, x.shape[-1]) for x in (g, w))
        norm = w.norm(dim=1)
        rows = norm > 1e-3 * norm.max()
        err = (g - w).norm(dim=1)[rows] / norm[rows]
        worst = max(worst, float(torch.quantile(err, 0.99)))
    return worst


def flash_bwd_tc_case(shape, causal):
    q, k, v, dy = bf16_flash_case(shape)
    y, lse = flash_attention_fwd(q, k, v, causal=causal)
    return dy, q, k, v, y, lse


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_TC_SHAPES)
def test_flash_bwd_tc_matches_float64(card, shape, causal):
    """dq, dk and dv within two bf16 steps of float64 row by row (the
    limit chip_smoke.py's BF16_BLOCK_TOL holds), two calls bit-equal, one
    launch of each of the two tensor-core kernels a call and none of the
    f32 ones; causal flipped fails the check."""
    args = flash_bwd_tc_case(shape, causal)
    counts = _build.launch_counts()
    got = flash_attention_bwd(*args, causal=causal)
    again = flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("flash_attn_dkv[bf16]", "flash_attn_dq[bf16]"):
        assert after[name] == counts.get(name, 0) + 2
    for name in (p_fa.DKV, p_fa.DQ):
        assert after.get(name, 0) == counts.get(name, 0)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert all(torch.equal(g.view(torch.int16), a.view(torch.int16))
               for g, a in zip(got, again))
    assert flash_bwd_f64_err(got, *args, causal) <= 2 ** -7
    flipped = flash_attention_bwd(*args, causal=not causal)
    assert flash_bwd_f64_err(flipped, *args, causal) > 2 ** -7


@pytest.mark.cuda
def test_flash_bwd_tc_staged_operands(card):
    """dh 36 (rows not a multiple of 8 elements) and operands one element
    into their storage go through zero-padded copies: within the limits
    of the plain version, and an unaligned call gives the aligned one's
    bits."""
    for causal in (True, False):
        dy, q, k, v, y, lse = flash_bwd_tc_case((4, 100, 100, 36), causal)
        got = flash_attention_bwd(dy, q, k, v, y, lse, causal=causal)
        agree_bf16(got, flash_attention_bwd(dy, q, k, v, y, lse,
                                            causal=causal),
                   flash_attention_bwd_ref(dy, q, k, v, y, lse,
                                           causal=causal))
    args = flash_bwd_tc_case((4, 100, 100, 64), True)
    off = [torch.empty(x.numel() + 1, device="cuda",
                       dtype=x.dtype)[1:].view_as(x) for x in args[:4]]
    for o, x in zip(off, args):
        o.copy_(x)
    assert all(o.data_ptr() % 16 for o in off)
    for g, a in zip(flash_attention_bwd(*off, *args[4:]),
                    flash_attention_bwd(*args)):
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))


@pytest.mark.cuda
def test_flash_bwd_tc_from_autograd(card):
    """The backward called on autograd's device thread, inside a backward
    and through ``torch.autograd.grad`` of ``flash_attention`` on bf16
    leaves, gives a direct call's bits."""
    dy, q, k, v, y, lse = flash_bwd_tc_case((24, 200, 200, 40), True)
    want = flash_attention_bwd(dy, q, k, v, y, lse)
    got = []
    x = torch.zeros(1, device="cuda", requires_grad=True)
    _CallInBackward.apply(x, lambda: got.append(
        flash_attention_bwd(dy, q, k, v, y, lse))).sum().backward()
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    got.append(torch.autograd.grad(p_fa.flash_attention(*leaves), leaves,
                                   dy))
    torch.cuda.synchronize()
    assert len(got) == 2
    for call in got:
        for g, a in zip(call, want):
            assert torch.equal(g.view(torch.int16), a.view(torch.int16))


@pytest.mark.cuda
def test_flash_mha_bf16_backward_with_four_heads_on_two_kv_heads(card):
    """flash_mha's bf16 gradients through the tensor-core kernels: each
    KV head's the sum of its query group's, against the plain backward on
    the fanned-out heads, within the bf16 limit plus one step (the fan-out
    sums the group's bf16 gradients in bf16); two runs bit-equal."""
    rng = np.random.default_rng(8)
    b, hq, hkv, t, dh = 2, 4, 2, 96, 32
    q = normal(rng, b, hq, t, dh).bfloat16()
    k, v = (normal(rng, b, hkv, t, dh).bfloat16() for _ in range(2))
    dy = normal(rng, b, hq, t, dh, scale=0.1).bfloat16()

    def grads():
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(flash_mha(*leaves, causal=True), leaves,
                                   dy)
    got, again = grads(), grads()
    kr, vr = (x.repeat_interleave(hq // hkv, dim=-3) for x in (k, v))
    y, lse = flash_attention_fwd_ref(q, kr, vr, causal=True)
    dq, dk, dv = flash_attention_bwd_ref(dy, q, kr, vr, y, lse, causal=True)
    want = (dq.float(), dk.float().view(b, hkv, hq // hkv, t, dh).sum(2),
            dv.float().view(b, hkv, hq // hkv, t, dh).sum(2))
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a)
        err = float((g.float() - w).abs().max())
        assert err <= (TOL[True] + 2 ** -8) * float(w.abs().max()), err


@pytest.mark.cuda
def test_flash_bwd_bits_unchanged_by_the_tensor_cores(card):
    """Modes 0 and 1 (f32, the CUDA cores) keep their bits: chip_smoke.py's
    digest of four small f32 calls, stored from the build before bf16
    storage moved to the tensor cores."""
    import chip_smoke
    assert chip_smoke.flash_bwd_bits_digest(torch, np, p_fa) == \
        chip_smoke.FLASH_BWD_BITS_SHA256
