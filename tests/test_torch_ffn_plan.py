"""The forward's and the input gradient's plans on the CPU
(``ops/fused_ffn.py``): how pass 2 of ``csrc/ffn_fwd.cu`` and
``csrc/ffn_bwd_dx.cu`` splits the ffn axis into slices, and the scratch
each wrapper allocates.

The kernels cannot run here; these hold the plain Python functions the
wrappers hand them: the slices cover ``[0, ffn)`` in order with no gap
or overlap (so every hidden column enters every sum once, in order),
each slice is a whole number of k-steps but the last, the main shape
fills its one planned wave unsplit (the fastest on an H100), a card with
more SMs splits it into the fewest slices that fill its slots, a small
ffn keeps one slice, the plans come from the same rule as the weight
gradients' (``slice_plan``), and every scratch piece has the floats the
kernel indexes (``ffn_fwd_launch``'s and ``ffn_bwd_dx_launch``'s
comments list them), each 16-byte aligned, with no overlap.
"""

import pytest

from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff

# (T, d, ffn): the main path's shape (chip_smoke.py's FFN_SHAPES), its
# ragged and small ones, the CPU tests' and shapes that no k-step divides
SHAPES = {"main": (8192, 768, 3072), "ragged": (1000, 200, 520),
          "small": (24, 40, 72), "odd": (37, 20, 52),
          "long_ffn": (13, 9, 8191), "no_four": (1001, 13, 9)}


def _up4(v):
    return -(-v // 4) * 4


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_slices_cover_the_ffn_axis_in_order(name):
    t, d, ffn = SHAPES[name]
    plan = ff.out_plan(t, d, ffn)
    s, length = plan
    assert s >= 1 and length % ff.BK == 0
    assert s == 1 or length >= ff.MIN_SLICE
    bounds = ff.plan_slices(ffn, plan)
    assert len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == ffn
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2
        assert (hi - lo) % ff.BK == 0          # whole k-steps
    assert all(lo < hi for lo, hi in bounds)
    # the kernels' own check: S = ceil(ffn / L)
    assert (s - 1) * length < ffn <= s * length


def test_main_shape_runs_unsplit():
    """At the main shape the 64 x 6 output tiles of pass 2 fill OUT_WAVES
    (one) wave of 264 block slots unsplit, so the ffn axis is one slice
    with no partials (unsplit was the fastest of 1-12 slices on an H100,
    chip_smoke.py's ffn-fwd-slices and ffn-dx-slices). A card with three
    times the SMs would split it into the fewest slices that fill its
    slots."""
    t, d, ffn = SHAPES["main"]
    tiles = (t // ff.TILE) * (d // ff.TILE)
    slots = ff.H100_SMS * ff.BLOCKS_PER_SM
    assert tiles == 384 and tiles >= ff.OUT_WAVES * slots
    assert ff.out_plan(t, d, ffn) == (1, ffn)
    s, length = ff.out_plan(t, d, ffn, sms=3 * ff.H100_SMS)
    assert (s, length) == (3, 1024)
    assert s * tiles >= ff.OUT_WAVES * 3 * slots > (s - 1) * tiles


def test_small_ffn_keeps_one_slice():
    """Slices never drop under MIN_SLICE ffn columns: a short ffn axis
    runs unsplit, with no partials."""
    for name in ("small", "odd", "no_four"):
        t, d, ffn = SHAPES[name]
        assert ff.out_plan(t, d, ffn) == (1, -(-ffn // ff.BK) * ff.BK)
        assert "part" not in ff.fwd_scratch(t, d, ffn, (1, ffn))
        assert "part" not in ff.dx_scratch(t, d, ffn, (1, ffn))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_the_three_plans_share_one_rule(name):
    """The forward's and the input gradient's plan is slice_plan over the
    ffn axis with the output's tiles; the weight gradients' is the same
    rule over the tokens with dw1's and dw2's tiles."""
    t, d, ffn = SHAPES[name]
    tiles = lambda v: -(-v // ff.TILE)          # noqa: E731
    assert ff.out_plan(t, d, ffn) == ff.slice_plan(
        ffn, tiles(t) * tiles(d), ff.OUT_WAVES)
    assert ff.dw_plan(t, d, ffn) == ff.slice_plan(
        t, 2 * tiles(ffn) * tiles(d), ff.DW_WAVES)


def _check_layout(pieces, want):
    total = pieces.pop("total")
    # the order the launch function takes its pointers in
    assert list(pieces) == list(want)
    end = 0
    for name, (shape, off) in pieces.items():
        numel = 1
        for v in shape:
            numel *= v
        assert numel == want[name], name
        assert off % 4 == 0 and off >= end
        end = off + numel
    assert end <= total < end + 4
    assert total == sum(_up4(v) for v in want.values())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fwd_scratch_holds_what_the_kernel_writes(name):
    t, d, ffn = SHAPES[name]
    plan = ff.out_plan(t, d, ffn)
    t4, d4, f4 = _up4(t), _up4(d), _up4(ffn)
    want = {"xT": d * t4, "w1T": d * f4, "w2T": ffn * d4, "aT": ffn * t4}
    if plan[0] > 1:
        want["part"] = plan[0] * t * d
    _check_layout(ff.fwd_scratch(t, d, ffn, plan), want)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_dx_scratch_holds_what_the_kernel_writes(name):
    t, d, ffn = SHAPES[name]
    plan = ff.out_plan(t, d, ffn)
    t4, d4, f4 = _up4(t), _up4(d), _up4(ffn)
    want = {"xT": d * t4, "dyT": d * t4, "w1T": d * f4, "w2c": d * f4,
            "w1c": ffn * d4, "dhT": ffn * t4}
    if plan[0] > 1:
        want["part"] = plan[0] * t * d
    _check_layout(ff.dx_scratch(t, d, ffn, plan), want)


def test_hidden_scratch_at_the_main_shape():
    """a^T and dh^T, [ffn, T] f32 each: 100.7 MB at the main shape,
    written once by pass 1 and read once by pass 2; no partials."""
    t, d, ffn = SHAPES["main"]
    plan = ff.out_plan(t, d, ffn)
    for pieces, hidden in ((ff.fwd_scratch(t, d, ffn, plan), "aT"),
                           (ff.dx_scratch(t, d, ffn, plan), "dhT")):
        assert pieces[hidden][0] == (ffn, t)
        assert "part" not in pieces
    assert 4 * t * ffn == 100663296
