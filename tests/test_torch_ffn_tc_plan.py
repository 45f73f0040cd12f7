"""The tensor-core passes of the FFN kernels on the CPU
(``ops/fused_ffn.py``): modes 1 (``mxu_bf16`` on f32) and 2 (bf16
storage) of ``csrc/ffn_fwd.cu``, ``csrc/ffn_bwd_dx.cu`` and
``csrc/ffn_bwd_dw.cu`` run on ``csrc/ffn_wgmma.cuh``, and the wrapper
hands them plans, scratch and a staging decision that these tests hold.

The kernels cannot run here. These hold the plain Python functions: the
tensor-core slice plans cover the depth in order, each slice a whole
number of 64-deep ring stages but the last, the whole tiles filling
whole rounds of the SMs; the scratch pieces are
aligned for TMA and as large as the kernels read and write; an operand
is staged into a bf16 copy exactly where TMA cannot read it in place
(and always in mode 1); mode 0's plans and scratch are as they were.
Then a torch model of the tensor-core arithmetic (bf16 operands, f32
sums, ``a`` and ``dh`` rounded to bf16, split tiles summed slice by
slice in order and each output rounded once) is held against JAX's
Pallas kernels in interpret mode at a shape of several tiles, under the
main path's rule and a plan of one whole tile and the rest in three
slices, with the same tolerances as the plain versions' tests: the
forward's ``y = a w2^T`` over ffn, the input gradient's and the weight
gradients'.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.ops import pallas_ffn as j_pf
from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
    tensor_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff

# (T, d, ffn): the main path's shape (chip_smoke.py's FFN_SHAPES), its
# ragged and small ones, one with no dim a multiple of 8, a T that
# leaves one partial slice and ones whose last slice is partial
SHAPES = {"main": (8192, 768, 3072), "ragged": (1000, 200, 520),
          "small": (24, 40, 72), "no_eight": (1001, 13, 9),
          "one_slice": (100, 64, 256), "ragged_tokens": (5000, 200, 520),
          "ragged_ffn": (256, 72, 3000)}
PLANS = {"dw": (ff.tc_dw_plan, 0), "dx": (ff.tc_dx_plan, 2),
         "fwd": (ff.tc_fwd_plan, 2)}


def _up(v, m):
    return -(-v // m) * m


def _tiles(kernel, t, d, ffn):
    if kernel == "dw":
        return ff.tc_dw_tiles(d, ffn)
    return -(-t // ff.TC_BM) * -(-d // ff.TC_BN)


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tc_slices_cover_the_depth_in_order(name, kernel):
    """dw's slices cover the tokens, dx's and fwd's the ffn axis: no gap, no
    overlap, each whole ring stages of TC_BK but the last, at least
    TC_MIN_SLICE long when split; the kernels' own check S = ceil(K /
    L). The whole tiles fill whole rounds of the SMs and the split ones
    fit in one more; a one-slice plan keeps every tile whole."""
    plan_fn, axis = PLANS[kernel]
    shape = SHAPES[name]
    depth, tiles = shape[axis], _tiles(kernel, *shape)
    s, length, whole = plan_fn(*shape)
    assert s >= 1 and length % ff.TC_BK == 0
    assert s == 1 or length >= ff.TC_MIN_SLICE
    bounds = ff.plan_slices(depth, (s, length))
    assert bounds[0][0] == 0 and bounds[-1][1] == depth
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2 and (hi - lo) % ff.TC_BK == 0
    assert all(lo < hi for lo, hi in bounds)
    assert (s - 1) * length < depth <= s * length
    slots = ff.H100_SMS * ff.TC_BLOCKS_PER_SM
    if s == 1:
        assert whole == tiles
    else:
        assert whole % slots == 0 and 0 <= whole < tiles
        assert ff.TC_MIN_SPLIT <= s and s * (tiles - whole) <= slots


def test_tc_plans_at_the_main_shape():
    """dw's 72 + 72 tiles of 128 x 256: 132 fill one round of the SMs
    over all 8192 tokens, and the last 12 run in 11 slices of 768 (the
    last 512), 132 work items of a twelfth of the depth in one more
    round. dx's 192 tiles run whole, and so do the forward's (the same
    64 x 3 tiles of a [T, d] output over ffn): the last 60 would take
    only two slices, fewer than TC_MIN_SPLIT."""
    t, d, ffn = SHAPES["main"]
    assert ff.tc_dw_tiles(d, ffn) == 144
    assert ff.tc_dw_plan(t, d, ffn) == (11, 768, 132)
    assert ff.tc_dx_plan(t, d, ffn) == (1, 3072, 192)
    assert ff.tc_fwd_plan(t, d, ffn) == (1, 3072, 192)
    assert (t // ff.TC_BM) * (d // ff.TC_BN) == 192
    # a card with 144 SMs would run every tile whole in one round
    assert ff.tc_dw_plan(t, d, ffn, sms=144) == (1, t, 144)


def test_tc_plans_split_a_ragged_depth():
    """Fewer tiles than SMs split every tile, the last slice partial; a
    depth under two slices keeps one."""
    t, d, ffn = SHAPES["ragged_tokens"]
    s, length, whole = ff.tc_dw_plan(t, d, ffn)
    assert s > 1 and whole == 0 and t % length
    t, d, ffn = SHAPES["ragged_ffn"]
    s, length, whole = ff.tc_dx_plan(t, d, ffn)
    assert s > 1 and whole == 0 and ffn % length
    assert ff.tc_fwd_plan(t, d, ffn) == (s, length, whole)
    assert ff.tc_dw_plan(*SHAPES["one_slice"]) == (1, 128, 3)


ALIGNED = {"xs": (1 << 20, 768), "dys": (2 << 20, 768),
           "w1s": (3 << 20, 768), "w2s": (4 << 20, 3072)}


def test_tc_staging_decision():
    """Mode 2 reads an operand in place only when its base is 16-byte
    aligned and its rows a multiple of 8 elements; mode 1 rounds all
    four into bf16 copies."""
    assert ff.tc_staged(2, ALIGNED) == ()
    assert ff.tc_staged(1, ALIGNED) == ("xs", "dys", "w1s", "w2s")
    for name in ALIGNED:
        for off in (2, 8, 14):
            ops = dict(ALIGNED, **{name: (ALIGNED[name][0] + off,
                                          ALIGNED[name][1])})
            assert ff.tc_staged(2, ops) == (name,)
    # d not a multiple of 8: x, dy and w1 have rows of d; ffn: w2
    odd_d = {k: (p, 13 if k != "w2s" else 3072)
             for k, (p, _) in ALIGNED.items()}
    assert ff.tc_staged(2, odd_d) == ("xs", "dys", "w1s")
    odd_f = dict(ALIGNED, w2s=(ALIGNED["w2s"][0], 9))
    assert ff.tc_staged(2, odd_f) == ("w2s",)


def test_tc_staging_decision_of_the_forward():
    """The forward takes no dy: mode 1 rounds x, w1 and w2 into bf16
    copies, mode 2 stages only an operand TMA cannot read in place."""
    fwd = {k: v for k, v in ALIGNED.items() if k != "dys"}
    assert ff.tc_staged(2, fwd) == ()
    assert ff.tc_staged(1, fwd) == ("xs", "w1s", "w2s")
    assert ff.tc_staged(2, dict(fwd, xs=(fwd["xs"][0] + 2, 768))) == ("xs",)
    assert ff.tc_staged(2, dict(fwd, w2s=(fwd["w2s"][0], 9))) == ("w2s",)


def test_tc_staging_of_a_view_into_storage():
    """A bf16 weight one element into its storage (2 bytes off) is
    staged; the same values in their own allocation are not."""
    w = torch.zeros(64, 256, dtype=torch.bfloat16)
    shifted = torch.empty(w.numel() + 1, dtype=torch.bfloat16)[1:].view_as(w)
    if w.data_ptr() % ff.TC_ALIGN:
        pytest.skip("the allocator gave an unaligned base")
    ops = {"xs": (w.data_ptr(), 256), "dys": (w.data_ptr(), 256),
           "w1s": (shifted.data_ptr(), 256), "w2s": (w.data_ptr(), 64)}
    assert ff.tc_staged(2, ops) == ("w1s",)


def _check_tc_layout(pieces, want):
    """Pieces in the kernel's pointer order, each TC_PIECE-aligned (so
    16-byte aligned for TMA), of the bytes the kernel touches (``want``),
    no overlap."""
    total = pieces.pop("total")
    assert list(pieces) == list(want)
    end = 0
    for name, (shape, off) in pieces.items():
        numel = 1
        for v in shape:
            numel *= v
        elem = 4 if name.startswith("part") else 2
        assert numel * elem == want[name], name
        assert off % ff.TC_PIECE == 0 and off % ff.TC_ALIGN == 0
        assert off >= end
        end = off + want[name]
    assert end <= total < end + ff.TC_PIECE


@pytest.mark.parametrize("staged", [(), ("xs", "dys", "w1s", "w2s"),
                                    ("w2s",)])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tc_dw_scratch_holds_what_the_kernel_reads(name, staged):
    t, d, ffn = SHAPES[name]
    plan = ff.tc_dw_plan(t, d, ffn)
    d8, f8 = _up(d, 8), _up(ffn, 8)
    copies = {"xs": 2 * t * d8, "dys": 2 * t * d8, "w1s": 2 * ffn * d8,
              "w2s": 2 * d * f8}
    want = {k: v for k, v in copies.items() if k in staged}
    want.update(a=2 * t * f8, dh=2 * t * f8)
    if plan[0] > 1:
        want["part"] = 4 * plan[0] * (ff.tc_dw_tiles(d, ffn) - plan[2]) * \
            ff.TC_BM * ff.TC_BN
    _check_tc_layout(ff.tc_dw_scratch(t, d, ffn, plan, staged), want)


@pytest.mark.parametrize("staged", [(), ("xs", "w1s", "w2s"), ("w1s",)])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tc_fwd_scratch_holds_what_the_kernel_reads(name, staged):
    """The forward's staged copies, a bf16 [T, ffn8] (pass 1 writes it,
    pass 2 reads it) and the split tiles' partials of y [T, d]."""
    t, d, ffn = SHAPES[name]
    plan = ff.tc_fwd_plan(t, d, ffn)
    d8, f8 = _up(d, 8), _up(ffn, 8)
    copies = {"xs": 2 * t * d8, "w1s": 2 * ffn * d8, "w2s": 2 * d * f8}
    want = {k: v for k, v in copies.items() if k in staged}
    want["a"] = 2 * t * f8
    if plan[0] > 1:
        want["part"] = 4 * plan[0] * (_tiles("fwd", t, d, ffn) - plan[2]) * \
            ff.TC_BM * ff.TC_BN
    _check_tc_layout(ff.tc_fwd_scratch(t, d, ffn, plan, staged), want)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tc_dx_scratch_holds_what_the_kernel_reads(name):
    t, d, ffn = SHAPES[name]
    plan = ff.tc_dx_plan(t, d, ffn)
    want = {"dh": 2 * t * _up(ffn, 8)}
    if plan[0] > 1:
        want["part"] = 4 * plan[0] * (_tiles("dx", t, d, ffn) - plan[2]) * \
            ff.TC_BM * ff.TC_BN
    _check_tc_layout(ff.tc_dx_scratch(t, d, ffn, plan), want)


def test_tc_scratch_at_the_main_shape_has_no_f32_copies():
    """Aligned bf16 operands at the main shape: no copy of any operand;
    a and dh bf16, 50.3 MB each (the f32 passes' were 100.7 MB each);
    the partials of dw's 12 split tiles in 11 slices, 17.3 MB; none for
    dx."""
    t, d, ffn = SHAPES["main"]
    dw = ff.tc_dw_scratch(t, d, ffn, ff.tc_dw_plan(t, d, ffn))
    assert [k for k in dw if k != "total"] == ["a", "dh", "part"]
    assert dw["a"][0] == (t, ffn) and 2 * t * ffn == 50331648
    assert dw["part"][0] == (11, 12, 128, 256)
    assert 4 * 11 * 12 * 128 * 256 == 17301504
    dx = ff.tc_dx_scratch(t, d, ffn, ff.tc_dx_plan(t, d, ffn))
    assert [k for k in dx if k != "total"] == ["dh"]
    # the forward: a alone, 50.3 MB, where its CUDA-core passes copied x,
    # w1 and w2 into 44.0 MB of f32 and a^T into 100.7 MB
    fwd = ff.tc_fwd_scratch(t, d, ffn, ff.tc_fwd_plan(t, d, ffn))
    assert [k for k in fwd if k != "total"] == ["a"]
    assert fwd["a"][0] == (t, ffn) and fwd["total"] == 2 * t * ffn
    f32 = ff.fwd_scratch(t, d, ffn, ff.out_plan(t, d, ffn))
    assert 4 * (f32["total"] - t * ffn) == 44040192


def test_mode0_plans_and_scratch_unchanged():
    """The CUDA-core passes' plans and scratch are as before the
    tensor-core passes: slice_plan's defaults, dw_plan, out_plan and the
    f32 scratch at the main shape."""
    t, d, ffn = SHAPES["main"]
    assert ff.dw_plan(t, d, ffn) == (4, 2048)
    assert ff.out_plan(t, d, ffn) == (1, 3072)
    assert ff.dw_plan(1000, 200, 520) == (3, 336)
    assert ff.out_plan(1000, 200, 520) == (2, 272)
    assert ff.dw_scratch(t, d, ffn, (4, 2048))["total"] == 99090432
    assert ff.dx_scratch(t, d, ffn, (1, 3072))["total"] == 44826624
    assert ff.fwd_scratch(t, d, ffn, (1, 3072))["total"] == 36175872


# -- the tensor-core arithmetic against JAX's Pallas kernels ---------------

def tc_model(dy, w1, w2, x, plan, kernel):
    """What the tensor-core passes compute, in torch: bf16 operands
    widened to f32, h and da summed in f32, a and dh rounded to bf16;
    pass 2's tiles [0, U) (dw1's, then dw2's; 128 x 256, row-major)
    summed over the whole depth (tokens for dw, ffn for dx and the
    forward's y = a w2^T), the others one slice of ``plan`` at a time
    with the slices' f32 partials added in order; each output rounded
    once to the storage type. The forward takes no dy (pass None)."""
    out_dtype = x.dtype
    x, w1, w2 = (v.to(torch.bfloat16).float() for v in (x, w1, w2))
    h = x @ w1.T
    keep = ~(h <= 0)
    if dy is not None:
        dy = dy.to(torch.bfloat16).float()
        dh = torch.where(keep, dy @ w2, 0.0).to(torch.bfloat16).float()
    a = torch.where(keep, h, 0.0).to(torch.bfloat16).float()
    s, length, whole = plan
    if kernel == "dw":
        depth, pairs = x.shape[0], ((dh.T, x), (dy.T, a))
    elif kernel == "fwd":
        depth, pairs = w1.shape[0], ((a, w2.T),)
    else:
        depth, pairs = w1.shape[0], ((dh, w1),)
    outs, tile = [], 0
    for lhs, rhs in pairs:
        full = lhs @ rhs
        parts = [lhs[:, lo:hi] @ rhs[lo:hi]
                 for lo, hi in ff.plan_slices(depth, (s, length))]
        split = parts[0]
        for p in parts[1:]:
            split = split + p
        out = full.clone()
        rows, cols = full.shape
        for m0 in range(0, rows, ff.TC_BM):
            for n0 in range(0, cols, ff.TC_BN):
                if tile >= whole:
                    out[m0:m0 + ff.TC_BM, n0:n0 + ff.TC_BN] = \
                        split[m0:m0 + ff.TC_BM, n0:n0 + ff.TC_BN]
                tile += 1
        outs.append(out.to(out_dtype))
    return tuple(outs)


def bf16_steps(got, want):
    """``(max steps, share that differ)``, a step at the larger of an
    element's magnitude and the output's RMS (chip_smoke.py's measure: an
    element near zero does not count a tiny difference as many steps)."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, dtype=np.float32).astype(np.float64)
    rms = np.sqrt((w ** 2).mean())
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), rms))
    return (float((np.abs(g - w) / np.ldexp(1.0, e - 8)).max()),
            float((g != w).mean()))


def _jax_case(t, d, ffn, bf16):
    rng = np.random.default_rng(t + ffn)
    arrays = (0.1 * rng.normal(size=(t, d)), 0.02 * rng.normal(size=(ffn, d)),
              0.02 * rng.normal(size=(d, ffn)), rng.normal(size=(t, d)))
    if bf16:
        return [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return [jnp.asarray(a, jnp.float32) for a in arrays]


# T 320 (3 row tiles of 128), d 64, ffn 512 (2 column tiles of 256; dw
# has 4 + 2 tiles, dx 3): divisible by the Pallas kernels' blocks
TC_JAX_SHAPE = (320, 64, 512)


@pytest.mark.parametrize("slices", ["plan", 3])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("kernel", ["dw", "dx", "fwd"])
def test_tc_model_matches_jax_pallas_interpret(kernel, bf16, slices):
    """bf16 storage (mode 2): each output within one bf16 step of JAX's,
    in at most 1% of the elements. f32 storage under ``mxu_bf16`` (mode
    1): within 2e-3 of JAX's largest output, the card tests' limit for
    bf16 operands: an f32-level difference in da can round an element of
    dh to the other bf16 neighbour, which moves its products by a bf16
    step."""
    t, d, ffn = TC_JAX_SHAPE
    jdy, jw1, jw2, jx = _jax_case(t, d, ffn, bf16)
    depth = t if kernel == "dw" else ffn
    # "plan": the main path's rule (one slice at this depth); 3: the
    # first tile whole and the others in three slices
    plan = (PLANS[kernel][0](t, d, ffn) if slices == "plan"
            else (3, _up(-(-depth // 3), ff.TC_BK), 1))
    assert slices == "plan" or ff.plan_slices(depth, plan[:2])[-1][0] > 0
    kw = dict(interpret=True, block_t=32, block_f=128,
              **({} if bf16 else {"mxu_bf16": True}))
    if kernel == "fwd":
        want = j_pf.ffn_fwd_pallas(jw1, jw2, jx, **kw)
    else:
        fn = (j_pf.ffn_bwd_dw_pallas if kernel == "dw"
              else j_pf.ffn_bwd_dx_pallas)
        want = fn(jdy, jw1, jw2, jx, **kw)
    want = want if isinstance(want, tuple) else (want,)
    args = [tensor_from_numpy(np.asarray(a)) for a in (jdy, jw1, jw2, jx)]
    if kernel == "fwd":
        args[0] = None
    got = tc_model(*args, plan, kernel)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        if bf16:
            assert g.dtype == torch.bfloat16
            most, share = bf16_steps(g, w)
            assert most <= 1 and share <= 0.01, (most, share)
        else:
            w = np.asarray(w)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 2e-3 * float(np.abs(w).max()), err
