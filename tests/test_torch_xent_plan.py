"""The plans of the LM head's statistics kernel and of the flash
attention kernels on the CPU (``ops/fused_xent.py``,
``ops/flash_attention.py``): how ``csrc/head_xent_fwd.cu`` cuts the
vocabulary into slices, the scratch each wrapper allocates, and the
forward's tiles and their shared memory.

The kernels cannot run here; these hold the plain Python functions the
wrappers hand them: the vocab slices cover ``[0, V)`` in order with no
gap or overlap (so every column enters one slice's statistics, and the
merge takes the slices in order), each a whole number of 128-column
tiles but the last; the main shape fills its planned wave of block
slots; a small V keeps one slice; and every scratch piece has the floats
the kernels index (``head_xent_stats_launch``'s and
``flash_attn_dkv_launch``'s comments list them), each 16-byte aligned,
with no overlap.
"""

import pytest

from distributed_llm_code_samples_tpu_torch.ops import fused_xent as fx
from distributed_llm_code_samples_tpu_torch.ops import flash_attention as fa

# (N, d, V): the main path's shape (chip_smoke.py's HEAD_SHAPES), its
# ragged one, the card tests', V and d not multiples of 4 and V below one
# tile
SHAPES = {"main": (8192, 768, 50304), "ragged": (1000, 200, 50257),
          "card": (64, 32, 384), "odd": (37, 20, 201),
          "no_four": (1001, 13, 8209), "tiny_v": (300, 45, 100),
          "one_row": (1, 7, 3)}
# (BH, Tq, Tk): chip_smoke.py's FLASH_SHAPES, the card tests' and
# lengths that no tile divides
FLASH = {"main": (192, 512, 512), "ragged": (24, 200, 200),
         "card": (3, 64, 64), "odd": (2, 37, 37), "rect": (2, 80, 130),
         "one": (1, 1, 1)}


def _up(v, m):
    return -(-v // m) * m


def _slices(v, plan):
    s, length = plan
    return [(i * length, min(v, (i + 1) * length)) for i in range(s)]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_slices_cover_the_vocabulary_in_order(name):
    n, _, v = SHAPES[name]
    plan = fx.stats_plan(n, v)
    s, length = plan
    assert s >= 1 and length % fx.TILE == 0
    bounds = _slices(v, plan)
    assert bounds[0][0] == 0 and bounds[-1][1] == v
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2
        assert (hi - lo) % fx.TILE == 0          # whole tiles
    assert all(lo < hi for lo, hi in bounds)     # no slice is empty
    # the kernel's own check: S = ceil(V / L)
    assert (s - 1) * length < v <= s * length


def test_main_shape_fills_its_wave():
    """64 row tiles x 4 slices: 256 blocks of the H100's 264 slots (132
    SMs x 2); 5 slices would need a second wave. A card with twice the
    SMs cuts 8."""
    n, _, v = SHAPES["main"]
    rows = n // fx.TILE
    slots = fx.H100_SMS * fx.BLOCKS_PER_SM
    s, length = fx.stats_plan(n, v)
    assert (rows, s, length) == (64, 4, 99 * fx.TILE)
    assert rows * s <= slots < rows * (s + 1)
    assert fx.stats_plan(n, v, sms=2 * fx.H100_SMS)[0] == 8


def test_small_vocab_keeps_one_slice():
    """A vocabulary of one tile cannot be cut; nor can one that a grid
    of row tiles already fills."""
    for name in ("tiny_v", "one_row"):
        n, _, v = SHAPES[name]
        assert fx.stats_plan(n, v) == (1, fx.TILE)
    assert fx.stats_plan(300 * fx.TILE, 50304)[0] == 1


def test_slices_are_at_least_one_tile():
    """More slots than vocab tiles: one tile a slice, never an empty one
    (the card tests' shape, 3 tiles for one row tile)."""
    n, _, v = SHAPES["card"]
    assert fx.stats_plan(n, v) == (3, fx.TILE)


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
    assert total == sum(_up(v, 4) for v in want.values())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_stats_scratch_holds_what_the_kernel_writes(name):
    n, d, v = SHAPES[name]
    plan = fx.stats_plan(n, v)
    _check_layout(fx.stats_scratch(n, d, v, plan),
                  {"hT": d * _up(n, 4), "wT": d * _up(v, 4),
                   "part": 3 * plan[0] * n})


def test_stats_scratch_at_the_main_shape():
    """h^T and w^T, the GEMM core's operands: 25.2 and 154.5 MB at the
    main shape; the partials 0.4 MB."""
    n, d, v = SHAPES["main"]
    pieces = fx.stats_scratch(n, d, v, fx.stats_plan(n, v))
    assert pieces["hT"][0] == (768, 8192)
    assert pieces["wT"][0] == (768, 50304)
    assert pieces["part"][0] == (3, 4, 8192)
    assert 4 * pieces["total"] == 180092928


@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_bwd_scratch_holds_what_the_kernels_index(name):
    """D as [BH][Tq]; ds^T as [BH][Tk rounded up to 128][Tq rounded up to
    64]: the dkv launch writes whole [key tile x 64] blocks (the largest
    key tile is 128), the dq launch reads query tiles of 64."""
    bh, tq, tk = FLASH[name]
    pieces = fa.bwd_scratch(bh, tq, tk)
    assert pieces["dsT"][0][1] % fa.BWD_PLAN[0] == 0
    _check_layout(pieces, {"D": bh * tq,
                           "dsT": bh * _up(tk, 128) * _up(tq, 64)})


def test_flash_bwd_plan():
    """The key tile divides the scratch's key padding and is a multiple
    of the query tile (so each key tile's causal walk starts at a whole
    query tile), and the ring has one or two stages."""
    key_tile, stages = fa.BWD_PLAN
    assert key_tile in (64, 128) and stages in (1, 2)
    assert fa.SCRATCH_KEYS % key_tile == 0
    assert key_tile % fa.QUERY_TILE == 0


@pytest.mark.parametrize("plan", fa.FWD_PLANS)
def test_flash_fwd_plans_fit_the_card(plan):
    """Each forward plan the kernel takes: a block of 2 x query tile
    threads (16 a row group of 8 rows) with 8 rows x key tile / 16 >= 4
    scores a thread, a ring of at least two stages, and shared memory
    within the 227 KB a block may use: q, the ring's k and v, and p."""
    query_tile, key_tile, stages = plan
    assert query_tile % 8 == 0 and key_tile % 64 == 0 and stages >= 2
    assert 8 * key_tile // 16 >= 32
    assert fa.fwd_smem_bytes(plan) == 4 * (
        query_tile * 68 + stages * 2 * key_tile * 68
        + query_tile * (key_tile + 4))
    assert fa.fwd_smem_bytes(plan) <= fa.SMEM_PER_BLOCK
    assert fa.fwd_blocks_per_sm(plan) >= 1


def test_flash_fwd_plan():
    """The wrapper's plan is one the kernel takes: 102 KB a block, two
    blocks an SM (264 block slots on 132 SMs); the others hold one."""
    assert fa.FWD_PLAN in fa.FWD_PLANS
    assert fa.fwd_smem_bytes((64, 64, 2)) == 104448
    assert {p: fa.fwd_blocks_per_sm(p) for p in fa.FWD_PLANS} == {
        (64, 64, 2): 2, (128, 64, 2): 1, (64, 128, 2): 1, (64, 64, 3): 1}


def test_flash_bwd_scratch_at_the_main_shape():
    """ds^T: 201 MB at the main shape, of which the causal mask leaves 20
    of each head's 32 blocks of 128 keys x 64 queries, 126 MB written and
    read; D 0.4 MB."""
    bh, tq, tk = FLASH["main"]
    pieces = fa.bwd_scratch(bh, tq, tk)
    assert pieces["D"][0] == (192, 512)
    shape = pieces["dsT"][0]
    assert shape == (192, 512, 512)
    assert 4 * shape[0] * shape[1] * shape[2] == 201326592
    nq, nk = tq // 64, tk // 128
    visible = sum(nq - 2 * j for j in range(nk))
    assert visible == 20
    assert 4 * bh * visible * 128 * 64 == 125829120
