"""The weight-gradient kernel's plan on the CPU (``ops/fused_ffn.py``):
how pass 2 of ``csrc/ffn_bwd_dw.cu`` splits the token axis into slices,
and the scratch the wrapper allocates for it.

The kernel cannot run here; these hold the plain Python functions the
wrapper hands it: the slices cover ``[0, T)`` in order with no gap or
overlap (so every token enters every sum once, in token order), the
grid fills whole waves at the main shape, and every scratch piece has
the floats the kernel indexes (``ffn_bwd_dw_launch``'s comment lists
them), each 16-byte aligned, with no overlap.
"""

import pytest

from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff

# (T, d, ffn): the main path's shape (chip_smoke.py's FFN_SHAPES), its
# ragged and small ones, the CPU tests' and a T that no k-step divides
SHAPES = {"main": (8192, 768, 3072), "ragged": (1000, 200, 520),
          "small": (24, 40, 72), "odd": (37, 20, 52),
          "long_ragged": (8191, 13, 9)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_slices_cover_the_tokens_in_order(name):
    t, d, ffn = SHAPES[name]
    plan = ff.dw_plan(t, d, ffn)
    s, length = plan
    assert s >= 1 and length % ff.DW_BK == 0
    assert s == 1 or length >= ff.DW_MIN_SLICE
    bounds = ff.dw_slices(t, plan)
    assert len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == t
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2
    assert all(lo < hi for lo, hi in bounds)
    # the kernel's own check: S = ceil(T / L)
    assert (s - 1) * length < t <= s * length


def test_main_shape_fills_several_waves():
    """At the main shape the 288 tiles of pass 2 would take 1.09 waves
    of 264 block slots; split, its blocks fill at least DW_WAVES waves
    with the fewest slices that do, so the partial last wave is a small
    share of the pass."""
    t, d, ffn = SHAPES["main"]
    s, length = ff.dw_plan(t, d, ffn)
    tiles = 2 * (ffn // ff.DW_TILE) * (d // ff.DW_TILE)
    slots = ff.H100_SMS * ff.DW_BLOCKS_PER_SM
    assert tiles == 288 and (s, length) == (4, 2048)
    assert s * tiles >= ff.DW_WAVES * slots > (s - 1) * tiles
    # a card with fewer SMs needs fewer slices for as many waves
    assert ff.dw_plan(t, d, ffn, sms=66)[0] == 2


def test_few_tokens_keep_one_slice():
    """Slices never drop under DW_MIN_SLICE tokens: short inputs run
    unsplit, with no partials."""
    for name in ("small", "odd"):
        assert ff.dw_plan(*SHAPES[name]) == (1, _up16(SHAPES[name][0]))


def _up16(v):
    return -(-v // 16) * 16


def _up4(v):
    return -(-v // 4) * 4


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_scratch_holds_what_the_kernel_writes(name):
    t, d, ffn = SHAPES[name]
    plan = ff.dw_plan(t, d, ffn)
    pieces = ff.dw_scratch(t, d, ffn, plan)
    total = pieces.pop("total")
    t4, d4, f4 = _up4(t), _up4(d), _up4(ffn)
    want = {"xT": d * t4, "dyT": d * t4, "xc": t * d4, "dyc": t * d4,
            "w1T": d * f4, "w2c": d * f4, "a": t * f4, "dh": t * f4}
    if plan[0] > 1:
        want.update(part1=plan[0] * ffn * d, part2=plan[0] * d * ffn)
    # the order ffn_bwd_dw_launch takes its pointers in
    assert list(pieces) == list(want)
    end = 0
    for name_, (shape, off) in pieces.items():
        numel = 1
        for v in shape:
            numel *= v
        assert numel == want[name_], name_
        assert off % 4 == 0 and off >= end
        end = off + numel
    assert end <= total < end + 4
    assert total == sum(_up4(v) for v in want.values())


def test_scratch_without_slices_has_no_partials():
    t, d, ffn = SHAPES["main"]
    pieces = ff.dw_scratch(t, d, ffn, (1, t))
    assert "part1" not in pieces and "part2" not in pieces
    # a and dh, [T, ffn] f32 each: 201 MB at the main shape
    assert 4 * 2 * t * ffn == 201326592
