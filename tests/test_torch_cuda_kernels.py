"""The CUDA kernels of the LM trainer's path (flash attention forward and
backward; the fused head's statistics and backward), the three FFN
kernels, the ring kernels and the all-to-all against
their plain versions, on the card. Every
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
from distributed_llm_code_samples_tpu_torch.ops import fused_xent as p_fx
from distributed_llm_code_samples_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_fwd_ref)

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
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain(card, shape, causal, mxu_bf16):
    q, k, v, dy = flash_case(shape)
    kw = dict(causal=causal, mxu_bf16=mxu_bf16)
    y, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    got = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
    again = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
    agree(got, again, flash_attention_bwd_ref(dy, q, k, v, y, lse, **kw),
          mxu_bf16)


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
    """The head backward's bits equal those its build gave before its
    GEMM core moved into csrc/gemm_core.cuh: chip_smoke.py's stored
    digest of one small call in each operand mode."""
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
    """The weight-gradient kernel's bits equal those its build gave
    before its passes moved into csrc/ffn_gemm.cuh: chip_smoke.py's
    stored digest of calls in each operand mode, through the partials."""
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
# 105 floats, the scalar path) and one whose odd chunk of 25025 floats
# the reduce-scatter splits into several ranges (the scalar path).

RING_OPS = ("ppermute_dma", "ring_all_reduce", "ring_reduce_scatter",
            "ring_all_gather")
RING_SHAPES = {"slice": (256, 768), "ragged": (7, 5, 3),
               "ranged": (25, 1001)}


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
    """A rank whose neighbour never enters the call waits to its deadline,
    leaves its error word, and the check raises instead of the card
    hanging."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    monkeypatch.setattr(ring, "WAIT_TIMEOUT_S", 0.2)
    ws = ring.PeerWorkspace(1024, "cuda", n=2)
    try:
        x = torch.ones(4, device="cuda")
        ring._launch(ring.HOP, [x], [torch.empty_like(x)], ws, 0)
        with pytest.raises(RuntimeError, match="rank 0 block 0 gave up "
                                               "waiting at the entry"):
            ws.check()
    finally:
        ws.close()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ring_ops_in_sequence_on_one_workspace(card, n):
    """One workspace through all-gather, reduce-scatter, reduce-scatter,
    all-reduce, all-to-all, reduce-scatter, all-gather (the landing
    regions in turn, the entry barrier after each ring call, chunks of
    changing size), twice: every output bit-identical to its plain
    version."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rng = np.random.default_rng(40 + n)
    seq = ((ring.ALL_GATHER, (6, 33)), (ring.REDUCE_SCATTER, (n * 64, 48)),
           (ring.REDUCE_SCATTER, (n * 5, 7)), (ring.ALL_REDUCE, (n * 4, 33)),
           (ring.ALL_TO_ALL, (n * 3, 101)),
           (ring.REDUCE_SCATTER, (n * 256, 768)),
           (ring.ALL_GATHER, (256, 768)))
    ws = ring.PeerWorkspace(4 * n * 256 * 768, "cuda", n=n)
    try:
        for i, (op, shape) in enumerate(seq + seq):
            xs = [normal(rng, *shape) for _ in range(n)]
            got = ring.loopback(op, xs, ws)
            for g, w in zip(got, ring.loopback_ref(op, xs)):
                assert torch.equal(g, w), (i, op)
        assert ws.region_calls == 8
        ws.check()
    finally:
        ws.close()


@pytest.mark.cuda
def test_rs_wait_gives_up_and_raises(card, monkeypatch):
    """A rank whose peer never enters the reduce-scatter waits to its
    deadline, leaves its error word, and the check raises: for the
    peer's chunk (on a fresh workspace), at the entry barrier (after a
    ring call), and for the peer's release of the region of the call
    before last."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    monkeypatch.setattr(ring, "WAIT_TIMEOUT_S", 0.2)
    x = torch.ones(8, device="cuda")
    y = torch.empty(4, device="cuda")
    # every block of the rank waits for rank 1's chunk (each sums a part of
    # it), and every block waits at the barrier: any may leave its code
    for where, setup in (("rank 1's chunk", {}),
                         ("the entry barrier", {"last_op": ring.ALL_REDUCE})):
        ws = ring.PeerWorkspace(1024, "cuda", n=2)
        try:
            for key, value in setup.items():
                setattr(ws, key, value)
            ring._launch(ring.REDUCE_SCATTER, [x], [y], ws, 0)
            with pytest.raises(RuntimeError, match="ring_reduce_scatter rank "
                                                   r"0 block \d gave up "
                                                   f"waiting at {where}"):
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
    peer's chunk (no entry barrier after another all-to-all or on a fresh
    workspace), at the entry barrier (after another collective), and for
    the peer's release of the landing slot of the call before last."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    monkeypatch.setattr(ring, "WAIT_TIMEOUT_S", 0.2)
    x = torch.ones(4, device="cuda")
    for where, setup in (("rank 1's chunk", {}),
                         ("the entry barrier", {"last_op": ring.ALL_REDUCE})):
        ws = ring.PeerWorkspace(1024, "cuda", n=2)
        try:
            for key, value in setup.items():
                setattr(ws, key, value)
            ring._launch(ring.ALL_TO_ALL, [x], [torch.empty_like(x)], ws, 0)
            # the barrier holds every block of the rank; any may leave
            # its code first
            with pytest.raises(RuntimeError, match="all_to_all_dma rank 0 "
                                                   r"block \d gave up "
                                                   f"waiting at {where}"):
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
