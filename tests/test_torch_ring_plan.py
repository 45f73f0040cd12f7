"""The plans of the reduce-scatter and all-reduce kernels on the CPU
(``ops/ring.py``): the order their receivers sum in, the landing regions
they share with the all-to-all and the all-gather, and the workspace and
ranges they need.

The kernels (``csrc/ring_collectives.cu``, ``ring_reduce_scatter_kernel``
and ``ring_all_reduce_kernel``) cannot run here, so ``_receiver_model``
and ``_all_reduce_model`` write out what they do: every peer j pushes
range b of its chunk r into rank r's landing slot ``(j - r) % n - 1``,
and each of rank r's n summing blocks of range b adds, over its n-th of
the range, slot 0, slot 1, ... left to right, with its own chunk last
(the reduce-scatter) or first (the all-reduce, which then stores each
sum into its own output and into slot r of every peer's gather region,
whose n blocks of range b copy their n-th out). Each must give the plain
ring's bits (``loopback_ref``) and, at n = 4, those of the JAX package's
Pallas ring in interpret mode on the conftest ``mesh4``. No tolerance:
the same f32 pairs are added in the same order.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llm_code_samples_tpu.ops import pallas_ring as jr
from distributed_llm_code_samples_tpu.parallel import DATA_AXIS
from distributed_llm_code_samples_tpu_torch.ops import ring

OPS = (ring.HOP, ring.ALL_REDUCE, ring.REDUCE_SCATTER, ring.ALL_GATHER,
       ring.ALL_TO_ALL)
# per-rank input shapes: rows of 768 floats (the kernel's 16-byte path,
# several ranges a chunk) and chunks of 105 floats (the scalar path)
SHAPES = {"vectorised": (8, 768), "ragged": (7, 5, 3)}


def _ranges(length: int, parts: int, start: int = 0):
    """The kernel's split of ``[start, start + length)`` into ``parts``
    (a chunk into ranges, ``set_range``; a range into the n parts its
    blocks sum): a multiple of 4 floats a part, the last ones shorter or
    empty."""
    per = -(-(-(-length // parts)) // 4) * 4
    end = start + length
    return [(min(end, start + b * per), min(end, start + b * per + per))
            for b in range(parts)]


def _receiver_model(xs, loopback: bool):
    """Each rank's output as the kernel forms it, range by range, from
    the slots its peers pushed."""
    n = len(xs)
    parts = [x.contiguous().reshape(n, -1) for x in xs]
    chunk = parts[0].shape[1]
    outs = []
    for r in range(n):
        # slot k - 1 of rank r's region: the chunk of the k-th rank after r
        slots = [None] * (n - 1)
        for j in range(n):
            if j != r:
                slots[(j - r) % n - 1] = parts[j][r]
        y = torch.empty(chunk)
        for lo, hi in _ranges(chunk, ring._rs_ranges(chunk, n, loopback)):
            # n blocks sum a range, each its n-th, each element in order
            for a, z in _ranges(hi - lo, n, lo):
                acc = slots[0][a:z].clone()
                for k in range(1, n - 1):
                    acc = slots[k][a:z] + acc
                y[a:z] = parts[r][r][a:z] + acc
        outs.append(y.reshape((xs[0].shape[0] // n,) + xs[0].shape[1:]))
    return outs


def _all_reduce_model(xs, loopback: bool):
    """Each rank's output as the all-reduce kernel forms it: the pushes,
    the sums of each range's n parts, and the gather's copy-out."""
    n = len(xs)
    parts = [x.contiguous().reshape(n, -1) for x in xs]
    chunk = parts[0].shape[1]
    ranges = _ranges(chunk, ring._ar_ranges(chunk, n, loopback))
    # rank r's push region: slot k - 1 holds chunk r of the k-th rank after
    # r; its gather region: slot s holds rank s's summed chunk s
    slots = [[parts[(r + k) % n][r] for k in range(1, n)] for r in range(n)]
    gather = [[None] * n for _ in range(n)]
    outs = [torch.empty(n, chunk) for _ in range(n)]
    for r in range(n):
        summed = torch.full((chunk,), float("nan"))
        for lo, hi in ranges:
            # n blocks sum a range, each its n-th, own copy first
            for a, z in _ranges(hi - lo, n, lo):
                acc = parts[r][r][a:z].clone()
                for k in range(n - 1):
                    acc = slots[r][k][a:z] + acc
                summed[a:z] = acc
        outs[r][r] = summed
        for k in range(1, n):
            gather[(r + k) % n][r] = summed
    for j in range(n):
        for s in (s for s in range(n) if s != j):
            for lo, hi in ranges:
                for a, z in _ranges(hi - lo, n, lo):
                    outs[j][s][a:z] = gather[j][s][a:z]
    return [o.reshape(xs[0].shape) for o in outs]


def _inputs(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(n * shape[0],) + shape[1:])
                             .astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("loopback", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_receiver_order_equals_the_plain_ring(n, shape, loopback):
    xs = _inputs(n, SHAPES[shape], 10 * n)
    if shape == "vectorised":
        chunk = xs[0].numel() // n
        assert ring._rs_ranges(chunk, n, loopback) > 1
    for got, want in zip(_receiver_model(xs, loopback),
                         ring.loopback_ref(ring.REDUCE_SCATTER, xs)):
        assert got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_receiver_order_equals_the_pallas_ring(mesh4, shape):
    n = 4
    xs = _inputs(n, SHAPES[shape], 7)
    fn = functools.partial(jr.ring_reduce_scatter, axis_name=DATA_AXIS,
                           interpret=True)
    f = jax.shard_map(fn, mesh=mesh4, in_specs=P(DATA_AXIS),
                      out_specs=P(DATA_AXIS), check_vma=False)
    want = np.asarray(f(np.concatenate([x.numpy() for x in xs])))
    want = want.reshape((n, -1) + want.shape[1:])
    for r, got in enumerate(_receiver_model(xs, loopback=False)):
        np.testing.assert_array_equal(got.numpy(), want[r])


@pytest.mark.parametrize("loopback", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_all_reduce_order_equals_the_plain_ring(n, shape, loopback):
    xs = _inputs(n, SHAPES[shape], 20 * n)
    if shape == "vectorised":
        chunk = xs[0].numel() // n
        assert ring._ar_ranges(chunk, n, loopback) > 1
    for got, want in zip(_all_reduce_model(xs, loopback),
                         ring.loopback_ref(ring.ALL_REDUCE, xs)):
        assert got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_all_reduce_order_equals_the_pallas_ring(mesh4, shape):
    n = 4
    xs = _inputs(n, SHAPES[shape], 9)
    fn = functools.partial(jr.ring_all_reduce, axis_name=DATA_AXIS,
                           interpret=True)
    f = jax.shard_map(fn, mesh=mesh4, in_specs=P(DATA_AXIS),
                      out_specs=P(DATA_AXIS), check_vma=False)
    want = np.asarray(f(np.concatenate([x.numpy() for x in xs])))
    want = want.reshape((n, -1) + want.shape[1:])
    for r, got in enumerate(_all_reduce_model(xs, loopback=False)):
        np.testing.assert_array_equal(got.numpy(), want[r])


def _fold(ops):
    """``region_plan`` over a call sequence, with ``region_record``'s
    bookkeeping as ``ops/ring.py``'s launch keeps it: each call's
    ``(region, prev, barrier)``."""
    last_op, calls, last, plans = None, 0, [(0, 0), (0, 0)], []
    for epoch, op in enumerate(ops, start=1):
        plans.append(ring.region_plan(op, last_op, calls, last))
        calls, last = ring.region_record(op, calls, last, epoch, 10 + epoch)
        last_op = op
    return plans


# the push designs: every op but the hop, the one ring
PUSH_OPS = (ring.ALL_TO_ALL, ring.REDUCE_SCATTER, ring.ALL_GATHER,
            ring.ALL_REDUCE)


def _expected(ops):
    """The rule written out: the hop plans nothing; every other op lands
    in the other region than the last one used (an all-reduce lands its
    pushes there and its sums in the other one, which is then the last
    one used), waits for the releases of the last call whose slots there
    peers release (an all-reduce's pushes are never such: they are read
    before the call ends on every rank), and opens with the barrier right
    after the hop."""
    out, used = [], []      # (epoch, region, released) in order of use
    for i, op in enumerate(ops):
        if op not in PUSH_OPS:
            out.append((0, (0, 0), 0))
            continue
        region = 0 if not used else 1 - used[-1][1]
        last = next(((e, rel) for e, reg, rel in reversed(used)
                     if reg == region), (0, False))
        prev = (last[0], 10 + last[0]) if last[1] else (0, 0)
        hop_before = i > 0 and ops[i - 1] not in PUSH_OPS
        out.append((region, prev, int(hop_before)))
        if op == ring.ALL_REDUCE:
            used += [(i + 1, region, False), (i + 1, 1 - region, True)]
        else:
            used.append((i + 1, region, True))
    return out


# FSDP's step (two gathers, two scatters a layer), DDP's (the hop, then
# two all-reduces a layer of its 24), the card test's mixed sequence, and
# runs of one op
SEQUENCES = {
    "fsdp": [ring.HOP] + [ring.ALL_GATHER] * 4 + [
        ring.ALL_GATHER, ring.ALL_GATHER, ring.REDUCE_SCATTER,
        ring.REDUCE_SCATTER] * 3,
    "ddp": [ring.HOP] + [ring.ALL_REDUCE] * 48,
    "mixed": [ring.HOP, ring.ALL_GATHER, ring.REDUCE_SCATTER,
              ring.REDUCE_SCATTER, ring.ALL_REDUCE, ring.ALL_TO_ALL,
              ring.ALL_REDUCE, ring.ALL_GATHER, ring.REDUCE_SCATTER,
              ring.ALL_GATHER],
    "scatters": [ring.REDUCE_SCATTER] * 5,
    "exchanges": [ring.ALL_TO_ALL, ring.REDUCE_SCATTER] * 3,
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_region_plan_of_named_sequences(name):
    ops = SEQUENCES[name]
    assert _fold(ops) == _expected(ops)


def test_fsdp_stream_opens_with_the_only_barrier():
    """FSDP's calls on its workspace: the opening hop (a ring call), then
    per layer two gathers and, in the backward, two reduce-scatters. The
    first gather after the hop opens with the all-peer barrier; no later
    call has one, and each lands in the other region than the call
    before it, waiting for the releases of the call before that."""
    ops = [ring.HOP] + ([ring.ALL_GATHER] * 2 * 3
                        + [ring.ALL_GATHER, ring.ALL_GATHER,
                           ring.REDUCE_SCATTER, ring.REDUCE_SCATTER] * 3)
    plans = _fold(ops)
    assert [barrier for _, _, barrier in plans] == [0, 1] + [0] * (
        len(ops) - 2)
    assert [region for region, _, _ in plans[1:]] == [
        k % 2 for k in range(len(ops) - 1)]
    assert [prev for _, prev, _ in plans[1:3]] == [(0, 0), (0, 0)]
    assert [prev[0] for _, prev, _ in plans[3:]] == list(
        range(2, len(ops) - 1))


def test_ddp_stream_opens_with_the_only_barrier():
    """DDP's calls on its workspace: the opening hop, then two
    all-reduces a layer. The first all-reduce opens with the all-peer
    barrier and no later one has it; every one pushes into region 0 and
    sums into region 1, and none waits for a release: the one before it
    has ended on the sender, so every peer has read its pushes, and its
    gather region the next one does not push into."""
    ops = SEQUENCES["ddp"]
    plans = _fold(ops)
    assert plans == [(0, (0, 0), 0), (0, (0, 0), 1)] + [(0, (0, 0), 0)] * 47
    calls, last = 0, [(0, 0), (0, 0)]
    for epoch, op in enumerate(ops, start=1):
        calls, last = ring.region_record(op, calls, last, epoch, 32)
    assert calls == 2 * 48 and last == [(0, 0), (49, 32)]


def _uses(op, plan):
    """The regions a call stores into: its own, and the all-reduce's
    gather region too."""
    if op not in ring.REGION_OPS:
        return set()
    return {plan[0], 1 - plan[0]} if op == ring.ALL_REDUCE else {plan[0]}


@pytest.mark.parametrize("seed", range(6))
def test_region_plan_of_random_sequences(seed):
    rng = np.random.default_rng(seed)
    ops = [OPS[i] for i in rng.integers(0, len(OPS), size=40)]
    plans = _fold(ops)
    assert plans == _expected(ops)
    # no region op stores into a region whose last user it has not
    # waited for: prev is the last call that stored there, one whose
    # slots there the peers release (not an all-reduce's pushes)
    for i, (op, (region, prev, _)) in enumerate(zip(ops, plans)):
        if op in ring.REGION_OPS and prev != (0, 0):
            e = prev[0]
            assert region in _uses(ops[e - 1], plans[e - 1])
            assert not (ops[e - 1] == ring.ALL_REDUCE
                        and plans[e - 1][0] == region)
            assert not any(region in _uses(ops[k], plans[k])
                           for k in range(e, i))


def test_region_plan_of_a_fresh_workspace():
    for op in ring.REGION_OPS:
        assert ring.region_plan(op, None, 0, [(0, 0), (0, 0)]) == \
            (0, (0, 0), 0)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_workspace_bytes(n):
    x = torch.empty(n * 6, 5)
    nbytes = 4 * x.numel()
    assert ring.workspace_bytes(ring.HOP, x, n) == nbytes
    assert ring.workspace_bytes(ring.ALL_REDUCE, x, n) == nbytes
    assert ring.workspace_bytes(ring.ALL_GATHER, x, n) == n * nbytes
    assert ring.workspace_bytes(ring.ALL_TO_ALL, x, n) == nbytes
    # the reduce-scatter's n - 1 chunk slots, in either region
    chunk = x.numel() // n
    assert ring.workspace_bytes(ring.REDUCE_SCATTER, x, n) == \
        4 * (n - 1) * chunk


def test_fsdp_workspace_is_sized_once():
    """FSDP opens its ring with room for one gathered layer weight
    (``train_fsdp``: ``mesh.ring(4 * w1[0].numel())``); every call of its
    step fits that, so no step reopens it."""
    n, d, ffn = 4, 768, 3072
    room = 4 * ffn * d
    for op, shape in ((ring.ALL_GATHER, (ffn // n, d)),
                      (ring.ALL_GATHER, (d // n, ffn)),
                      (ring.REDUCE_SCATTER, (ffn, d)),
                      (ring.REDUCE_SCATTER, (d, ffn)),
                      (ring.HOP, (1,))):
        assert ring.workspace_bytes(op, torch.empty(shape), n) <= room


@pytest.mark.parametrize("n,loopback,want", [(4, False, 32), (4, True, 8),
                                             (2, True, 32), (3, True, 14),
                                             (8, False, 32)])
def test_reduce_scatter_ranges(n, loopback, want):
    # the main path's chunk (dw1 [3072, 768] over 4 ranks) and the cap
    # that keeps a loopback launch resident
    chunk = 3072 * 768 // 4
    got = ring._rs_ranges(chunk, n, loopback)
    assert got == want and got <= ring._MAX_BLOCKS
    if loopback:
        assert n * n * got <= ring._LOOPBACK_BLOCKS
    assert ring._rs_ranges(105, n, loopback) == 1


@pytest.mark.parametrize("n,loopback,want", [(4, False, 32), (4, True, 8),
                                             (2, True, 32), (3, True, 14),
                                             (8, False, 16)])
def test_all_reduce_ranges(n, loopback, want):
    """The reduce-scatter's ranges at the main path's chunk, but a rank's
    n * ranges blocks, which wait for each other's sums, stay resident
    across the cards too (at most 128)."""
    chunk = 3072 * 768 // 4
    got = ring._ar_ranges(chunk, n, loopback)
    assert got == want and n * got <= ring._LOOPBACK_BLOCKS
    if loopback:
        assert n * n * got <= ring._LOOPBACK_BLOCKS
    assert ring._ar_ranges(105, n, loopback) == 1


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_all_reduce_parts_cover_each_range(n):
    """The all-reduce's ranges and the n parts its blocks sum and copy
    out of each (the same parts in both phases) cover the chunk once, in
    order, at the main path's chunk, a ragged one and one under a
    range."""
    for chunk in (3072 * 768 // 4, 25025, 105, 3):
        for loopback in (False, True):
            cover = []
            for lo, hi in _ranges(chunk, ring._ar_ranges(chunk, n,
                                                         loopback)):
                for a, z in _ranges(hi - lo, n, lo):
                    assert a <= z and (a == z or a % 4 == 0)
                    cover += range(a, z)
            assert cover == list(range(chunk))


def test_error_word_decodes_the_reduce_scatter_waits():
    op = 1 + ring._OPS[ring.REDUCE_SCATTER]

    def code(step, block, rank):
        return (op << 48) | ((step + 1) << 32) | ((block + 1) << 16) | (
            rank + 1)

    assert ring.describe_error(code(3, 5, 2)) == (
        "ring_reduce_scatter rank 2 block 5 gave up waiting at rank 3's "
        "chunk")
    assert ring.describe_error(code(ring._MAX_RANKS + 1, 0, 0)) == (
        "ring_reduce_scatter rank 0 block 0 gave up waiting at rank 1's "
        "release of its landing slot")
    assert ring.describe_error(code(-1, 7, 1)).endswith("the entry barrier")


def test_error_word_decodes_the_all_reduce_waits():
    op = 1 + ring._OPS[ring.ALL_REDUCE]

    def code(step, block, rank):
        return (op << 48) | ((step + 1) << 32) | ((block + 1) << 16) | (
            rank + 1)

    assert ring.describe_error(code(2, 3, 1)) == (
        "ring_all_reduce rank 1 block 3 gave up waiting at rank 2's chunk")
    assert ring.describe_error(code(ring._MAX_RANKS + 3, 0, 2)) == (
        "ring_all_reduce rank 2 block 0 gave up waiting at rank 3's "
        "release of its landing slot")
    assert ring.describe_error(code(2 * ring._MAX_RANKS + 1, 9, 0)) == (
        "ring_all_reduce rank 0 block 9 gave up waiting at rank 1's "
        "summed chunk")
    assert ring.describe_error(code(-1, 2, 3)).endswith("the entry barrier")
    hop = 1 + ring._OPS[ring.HOP]
    assert ring.describe_error((hop << 48) | (1 << 32) | (1 << 16) | 1) == (
        "ppermute_dma rank 0 block 0 gave up waiting at step 0")
