"""The plans of the ring kernels on the CPU (``ops/ring.py``): the order
the reduce-scatter's and the all-reduce's receivers sum in, the landing
regions every kernel (the hop, the all-to-all, the all-gather too) uses
in turn, and the workspace, ranges and error words.

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

``_run`` runs n ranks through a sequence of calls on their workspaces
as the kernels' flags let their blocks go, in random orders with one
rank late, and reports any store over a slot its receiver has not read.
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
        y = torch.empty(chunk, dtype=parts[0].dtype)
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
    outs = [torch.empty(n, chunk, dtype=parts[0].dtype) for _ in range(n)]
    for r in range(n):
        summed = torch.full((chunk,), float("nan"), dtype=parts[0].dtype)
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
    ``(region, prev)``."""
    calls, last, plans = 0, [(0, 0), (0, 0)], []
    for epoch, op in enumerate(ops, start=1):
        plans.append(ring.region_plan(calls, last))
        calls, last = ring.region_record(op, calls, last, epoch, 10 + epoch)
    return plans


def _expected(ops):
    """The rule written out: every op, the hop too, lands in the other
    region than the last one used (an all-reduce lands its pushes there
    and its sums in the other one, which is then the last one used) and
    waits for the releases of the last call whose slots there peers
    release (an all-reduce's pushes are never such: they are read before
    the call ends on every rank). No call waits at a barrier."""
    out, used = [], []      # (epoch, region, released) in order of use
    for i, op in enumerate(ops):
        region = 0 if not used else 1 - used[-1][1]
        last = next(((e, rel) for e, reg, rel in reversed(used)
                     if reg == region), (0, False))
        prev = (last[0], 10 + last[0]) if last[1] else (0, 0)
        out.append((region, prev))
        if op == ring.ALL_REDUCE:
            used += [(i + 1, region, False), (i + 1, 1 - region, True)]
        else:
            used.append((i + 1, region, True))
    return out


# FSDP's step (two gathers, two scatters a layer), DDP's (the hop, then
# two all-reduces a layer of its 24), the card test's mixed sequence,
# hops between other calls, and runs of one op
SEQUENCES = {
    "fsdp": [ring.HOP] + [ring.ALL_GATHER] * 4 + [
        ring.ALL_GATHER, ring.ALL_GATHER, ring.REDUCE_SCATTER,
        ring.REDUCE_SCATTER] * 3,
    "ddp": [ring.HOP] + [ring.ALL_REDUCE] * 48,
    "mixed": [ring.HOP, ring.ALL_GATHER, ring.REDUCE_SCATTER,
              ring.REDUCE_SCATTER, ring.ALL_REDUCE, ring.HOP,
              ring.ALL_TO_ALL, ring.ALL_REDUCE, ring.ALL_GATHER, ring.HOP,
              ring.REDUCE_SCATTER, ring.ALL_GATHER],
    "hops": [ring.ALL_REDUCE, ring.HOP, ring.ALL_REDUCE, ring.ALL_GATHER,
             ring.HOP, ring.REDUCE_SCATTER, ring.ALL_GATHER],
    "scatters": [ring.REDUCE_SCATTER] * 5,
    "exchanges": [ring.ALL_TO_ALL, ring.REDUCE_SCATTER] * 3,
    "hop_runs": [ring.HOP] * 5,
    # FSDP under mixed: each layer's two bf16 gathers are the float32
    # gathers of their words (``ring._words``), the same launches, between
    # the f32 reduce-scatters of the gradients
    "fsdp_bf16": [ring.HOP] + [ring.ALL_GATHER] * 6 + [
        ring.ALL_GATHER, ring.ALL_GATHER, ring.REDUCE_SCATTER,
        ring.REDUCE_SCATTER] * 3,
    # --dtype bfloat16: bf16 all-reduces and reduce-scatters are the
    # launches of their words too, mixed here with f32 calls of every op
    # as the card test's sequence mixes them
    # (test_ring_bf16_sums_in_sequence_with_f32_calls)
    "dtype_bf16": [ring.ALL_REDUCE, ring.ALL_GATHER, ring.REDUCE_SCATTER,
                   ring.HOP, ring.ALL_REDUCE, ring.ALL_REDUCE,
                   ring.REDUCE_SCATTER, ring.ALL_TO_ALL,
                   ring.REDUCE_SCATTER, ring.ALL_REDUCE, ring.ALL_REDUCE] * 2,
    # --dtype bfloat16 of the MoE and LM methods: bf16 hops and
    # all-to-alls are the launches of their words as well (an odd chunk
    # the launch of its padded copy's words,
    # test_bf16_hops_and_all_to_alls_are_the_launches_of_their_words):
    # EP's two exchanges a layer each way after the opening hop, then
    # hops and exchanges between bf16 sums and gathers
    "ep_bf16": [ring.HOP] + [ring.ALL_TO_ALL] * 8 + [
        ring.HOP, ring.ALL_GATHER, ring.ALL_TO_ALL, ring.HOP,
        ring.ALL_REDUCE, ring.ALL_TO_ALL, ring.REDUCE_SCATTER, ring.HOP,
        ring.ALL_TO_ALL, ring.ALL_REDUCE],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_region_plan_of_named_sequences(name):
    ops = SEQUENCES[name]
    assert _fold(ops) == _expected(ops)


def test_hop_between_other_calls():
    """A hop between two all-reduces and between a gather and a
    reduce-scatter, written out: the hop lands in the region after the
    last one used and waits for its last released user (the first
    all-reduce's pushes need no release, its gather's region does); the
    call after the hop in the hop's region waits for the hop's release
    (the hop's epoch and ranges)."""
    assert _fold(SEQUENCES["hops"]) == [
        (0, (0, 0)),      # 1 all-reduce: pushes in 0, sums in 1
        (0, (0, 0)),      # 2 hop: region 0, the pushes' region
        (1, (1, 11)),     # 3 all-reduce: pushes in 1 after 1's gather
        (1, (0, 0)),      # 4 all-gather: 3's pushes' region
        (0, (3, 13)),     # 5 hop: after 3's gather (its sums)
        (1, (4, 14)),     # 6 reduce-scatter: after the gather
        (0, (5, 15)),     # 7 all-gather: after the hop
    ]


def test_fsdp_stream_lands_in_turn_with_no_barrier():
    """FSDP's calls on its workspace: the opening hop (the ring's check),
    then per layer two gathers and, in the backward, two
    reduce-scatters. Every call, the hop first, lands in the other
    region than the call before it and waits for the releases of the
    call before that: the first gather for nothing, the second for the
    hop's."""
    ops = [ring.HOP] + ([ring.ALL_GATHER] * 2 * 3
                        + [ring.ALL_GATHER, ring.ALL_GATHER,
                           ring.REDUCE_SCATTER, ring.REDUCE_SCATTER] * 3)
    plans = _fold(ops)
    assert [region for region, _ in plans] == [
        k % 2 for k in range(len(ops))]
    assert [prev for _, prev in plans[:3]] == [(0, 0), (0, 0), (1, 11)]
    assert [prev[0] for _, prev in plans[2:]] == list(
        range(1, len(ops) - 1))


def test_ddp_stream_lands_with_no_barrier():
    """DDP's calls on its workspace: the opening hop, then two
    all-reduces a layer. The hop lands in region 0; every all-reduce
    pushes into region 1 and sums into region 0, and none waits for a
    release: the one before it has ended on the sender, so every peer
    has read its pushes, and a peer's push of this call lands only after
    the peer has ended the hop and read its region 0."""
    ops = SEQUENCES["ddp"]
    plans = _fold(ops)
    assert plans == [(0, (0, 0))] + [(1, (0, 0))] * 48
    calls, last = 0, [(0, 0), (0, 0)]
    for epoch, op in enumerate(ops, start=1):
        calls, last = ring.region_record(op, calls, last, epoch, 32)
    assert calls == 1 + 2 * 48 and last == [(49, 32), (0, 0)]


def _uses(op, plan):
    """The regions a call stores into: its own, and the all-reduce's
    gather region too."""
    return {plan[0], 1 - plan[0]} if op == ring.ALL_REDUCE else {plan[0]}


def _tasks(op, r, n):
    """Rank r's blocks in a call of ``op``, with a chunk's ranges taken as
    one: ("push", j) stores into rank j's region of the call and flags it;
    ("copy", s) reads the slot rank s pushed here once its flag lands;
    ("sum", None) reads every slot once all have landed (the
    all-reduce's then stores on into every peer's other region and flags
    it there, where ("gather", s) reads rank s's)."""
    peers = [(r + k) % n for k in range(1, n)]
    if op == ring.HOP:
        return [("push", (r + 1) % n), ("copy", (r - 1) % n)]
    pushes = [("push", j) for j in peers]
    if op in (ring.ALL_GATHER, ring.ALL_TO_ALL):
        return pushes + [("copy", s) for s in peers]
    if op == ring.REDUCE_SCATTER:
        return pushes + [("sum", None)]
    return pushes + [("sum", None)] + [("gather", s) for s in peers]


def _run(ops, n, rng, late, per_source=()):
    """n ranks through ``ops``, each on its workspace, as the kernels'
    flags let their blocks go: a block waits for what its kernel waits
    for (a push for the receiver's release of the region's last user,
    ``region_plan``'s prev; a read for its flag), and a rank's next call
    starts once its blocks of this one are done (stream order). Blocks
    go one at a time, drawn by ``rng``; rank ``late``'s only when no
    other rank's can. A receiver releases the call to every peer once it
    has read every slot it holds (the kernels), but under an op of
    ``per_source`` each slot to its source alone as it reads it. Returns
    the first store over a slot that its receiver has not read yet, or a
    read of a slot that is not there, in words; None if there is none.
    Raises if the ranks deadlock."""
    plans = _fold(ops)
    landed = [[0] * n for _ in range(n)]     # [j][s]: in rank j's workspace
    freed = [[0] * n for _ in range(n)]      # [r][j]: j's release, in r's
    gathered = [[0] * n for _ in range(n)]
    unread = [[set(), set()] for _ in range(n)]   # (epoch, source) a region
    pos, todo, summed = [0] * n, [[] for _ in range(n)], [False] * n
    for r in range(n):
        todo[r] = _tasks(ops[0], r, n)

    def ready(r, task):
        e, prev = pos[r] + 1, plans[pos[r]][1][0]
        kind, k = task
        if kind == "push":
            return freed[r][k] >= prev
        if kind == "copy":
            return landed[r][k] >= e
        if kind == "sum":
            return all(landed[r][s] >= e for s in range(n) if s != r)
        return summed[r] and gathered[r][k] >= e

    def store(j, region, e, src):
        stale = sorted(u for u in unread[j][region] if u[0] < e)
        unread[j][region].add((e, src))
        if stale:
            return (f"call {e}: rank {src} stores into rank {j}'s region "
                    f"{region} before rank {j} has read {stale}")
        return None

    def read(r, region, e, src):
        if (e, src) not in unread[r][region]:
            return (f"call {e}: rank {r} reads rank {src}'s slot of region "
                    f"{region}, which is not there")
        unread[r][region].discard((e, src))
        return None

    while any(todo):
        go = [(r, t) for r in range(n) for t in todo[r] if ready(r, t)]
        assert go, f"the ranks deadlock at calls {[p + 1 for p in pos]}"
        go = [g for g in go if g[0] != late] or go
        r, task = go[rng.integers(len(go))]
        todo[r].remove(task)
        op, e, region = ops[pos[r]], pos[r] + 1, plans[pos[r]][0]
        kind, k = task
        fault = None
        if kind == "push":
            fault = store(k, region, e, r)
            landed[k][r] = e
        elif kind == "copy":
            fault = read(r, region, e, k)
            if op in per_source:
                freed[k][r] = e
        elif kind == "sum":
            for s in (s for s in range(n) if s != r):
                fault = fault or read(r, region, e, s)
            summed[r] = True
            if op == ring.ALL_REDUCE:
                for j in (j for j in range(n) if j != r):
                    fault = fault or store(j, 1 - region, e, r)
                    gathered[j][r] = e
        else:
            fault = read(r, 1 - region, e, k)
        if fault:
            return fault
        if not any(t[0] != "push" for t in todo[r]) and (
                op not in per_source):
            # every slot read: the release, once, to every peer
            for j in (j for j in range(n) if j != r):
                freed[j][r] = e
        if not todo[r]:
            pos[r] += 1
            summed[r] = False
            if pos[r] < len(ops):
                todo[r] = _tasks(ops[pos[r]], r, n)
    return None


@pytest.mark.parametrize("seed", range(6))
def test_region_plan_of_random_sequences(seed):
    """The plan of 40 random calls, as written out; no call stores into a
    region whose last user it has not waited for; and four ranks run
    through the calls in random orders, one of them late, never store
    over a slot that its receiver has not read."""
    rng = np.random.default_rng(seed)
    ops = [OPS[i] for i in rng.integers(0, len(OPS), size=40)]
    plans = _fold(ops)
    assert plans == _expected(ops)
    for k in range(8):
        assert _run(ops, 4, rng, late=k % 4) is None
    # no call stores into a region whose last user it has not waited
    # for: prev is the last call that stored there, one whose slots
    # there the peers release (not an all-reduce's pushes)
    for i, (op, (region, prev)) in enumerate(zip(ops, plans)):
        if prev != (0, 0):
            e = prev[0]
            assert region in _uses(ops[e - 1], plans[e - 1])
            assert not (ops[e - 1] == ring.ALL_REDUCE
                        and plans[e - 1][0] == region)
            assert not any(region in _uses(ops[k], plans[k])
                           for k in range(e, i))


@pytest.mark.parametrize("late", range(4))
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ranks_ahead_of_a_late_peer_store_over_nothing_unread(name, late):
    """Four ranks through each named sequence (three for a second run),
    in 20 random orders with one rank late: no store lands on a slot its
    receiver has yet to read, and every read finds its slot."""
    rng = np.random.default_rng(7 + late)
    for k in range(20):
        assert _run(SEQUENCES[name], 4, rng, late) is None
        assert _run(SEQUENCES[name], 3, rng, late % 3) is None


def test_a_release_to_the_source_alone_lets_a_rank_run_ahead():
    """A gather, a hop, a reduce-scatter: if the gather's receivers
    released each slot to its source alone, a rank past the hop (which
    reads only from its left neighbour) could push its reduce-scatter
    over a slot of the gather that a late peer has not read yet; with
    every range released to every peer after its last read, no order
    lets it."""
    ops = [ring.ALL_GATHER, ring.HOP, ring.REDUCE_SCATTER]
    faults = [_run(ops, 4, np.random.default_rng(seed), late=2,
                   per_source=(ring.ALL_GATHER, ring.ALL_TO_ALL))
              for seed in range(40)]
    assert any(f and "stores into rank 2's region 0 before rank 2 has read"
               in f for f in faults)
    assert all(_run(ops, 4, np.random.default_rng(seed), late=2) is None
               for seed in range(40))


@pytest.mark.parametrize("op", OPS)
def test_region_plan_of_a_fresh_workspace(op):
    """The first call of any op lands in region 0 with nothing to wait
    for, and counts one region use (the all-reduce two)."""
    fresh = [(0, 0), (0, 0)]
    assert ring.region_plan(0, fresh) == (0, (0, 0))
    calls, last = ring.region_record(op, 0, fresh, 1, 7)
    if op == ring.ALL_REDUCE:
        assert (calls, last) == (2, [(0, 0), (1, 7)])
    else:
        assert (calls, last) == (1, [(1, 7), (0, 0)])


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


@pytest.mark.parametrize("n,loopback,want", [(4, False, 64), (4, True, 32),
                                             (2, True, 64), (3, True, 42),
                                             (8, False, 64)])
def test_hop_ranges(n, loopback, want):
    """The hop's ranges at the main path's block ([768, 3072]): a push
    and a copy-out block each, 2 * ranges blocks a rank, all resident in
    one loopback launch at two blocks a streaming multiprocessor; the
    ring's one-float check and the ragged case are one range."""
    got = ring._hop_ranges(768 * 3072, n, loopback)
    assert got == want and got <= ring._MAX_BLOCKS
    if loopback:
        assert n * 2 * got <= 2 * ring._LOOPBACK_BLOCKS
    assert ring._hop_ranges(1, n, loopback) == 1
    assert ring._hop_ranges(105, n, loopback) == 1


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


def _code(op, step, block, rank):
    """An error word as ``error_code`` (ring_common.cuh) writes it."""
    return ((1 + ring._OPS[op]) << 48) | ((step + 1) << 32) | (
        (block + 1) << 16) | (rank + 1)


def test_error_word_decodes_the_reduce_scatter_waits():
    code = functools.partial(_code, ring.REDUCE_SCATTER)
    assert ring.describe_error(code(3, 5, 2)) == (
        "ring_reduce_scatter rank 2 block 5 gave up waiting at rank 3's "
        "chunk")
    assert ring.describe_error(code(ring._MAX_RANKS + 1, 0, 0)) == (
        "ring_reduce_scatter rank 0 block 0 gave up waiting at rank 1's "
        "release of its landing slot")


def test_error_word_decodes_the_all_reduce_waits():
    code = functools.partial(_code, ring.ALL_REDUCE)
    assert ring.describe_error(code(2, 3, 1)) == (
        "ring_all_reduce rank 1 block 3 gave up waiting at rank 2's chunk")
    assert ring.describe_error(code(ring._MAX_RANKS + 3, 0, 2)) == (
        "ring_all_reduce rank 2 block 0 gave up waiting at rank 3's "
        "release of its landing slot")
    assert ring.describe_error(code(2 * ring._MAX_RANKS + 1, 9, 0)) == (
        "ring_all_reduce rank 0 block 9 gave up waiting at rank 1's "
        "summed chunk")


def test_error_word_decodes_the_hop_waits():
    """The hop's copy-out block waits for its left neighbour's chunk, its
    push block for the right neighbour's release of its landing slot."""
    code = functools.partial(_code, ring.HOP)
    assert ring.describe_error(code(3, 33, 0)) == (
        "ppermute_dma rank 0 block 33 gave up waiting at rank 3's chunk")
    assert ring.describe_error(code(ring._MAX_RANKS + 2, 4, 1)) == (
        "ppermute_dma rank 1 block 4 gave up waiting at rank 2's release "
        "of its landing slot")


def test_bf16_gather_is_the_float32_gather_of_its_words():
    """A bf16 all-gather hands the kernel the float32 words of its bytes
    (an even element count): the same storage, the same workspace bytes,
    and the plain gather keeps the bits; an odd count is refused."""
    import torch
    x = torch.randn(192, 3072).bfloat16()
    w = ring._words([x])[0]
    assert w.dtype == torch.float32 and w.numel() == x.numel() // 2
    assert w.data_ptr() == x.data_ptr()
    assert torch.equal(w.view(torch.bfloat16).reshape(x.shape), x)
    assert ring.workspace_bytes(ring.ALL_GATHER, x, 4) == \
        ring.workspace_bytes(ring.ALL_GATHER, w, 4)
    with pytest.raises(ValueError, match="odd"):
        ring._words([torch.zeros(3, dtype=torch.bfloat16)])
    xs = [torch.randn(6, 4).bfloat16() for _ in range(4)]
    for out in ring.loopback_ref(ring.ALL_GATHER, xs):
        assert out.dtype == torch.bfloat16
        assert torch.equal(out.view(torch.int16),
                           torch.cat(xs).view(torch.int16))


@pytest.mark.parametrize("n", [2, 4])
def test_bf16_hops_and_all_to_alls_are_the_launches_of_their_words(n):
    """A bf16 hop or all-to-all hands the kernel the float32 words of its
    bytes; one whose chunks hold an odd element count hands it the words
    of a copy padded by one zero a chunk (``ring._launch``), and the
    workspace has room for that copy. Moving the padded copies and
    dropping the pads gives the plain exchange's bits."""
    import torch
    for op, parts in ((ring.HOP, 1), (ring.ALL_TO_ALL, n)):
        even = torch.randn(n * 6, 4).bfloat16()
        assert not ring._odd(op, even, n)
        assert ring.workspace_bytes(op, even, n) == even.numel() * 2
        w = ring._words([even], op, n)[0]
        assert w.data_ptr() == even.data_ptr() and w.numel() * 2 == \
            even.numel()
        odd = torch.randn(parts, 3, 5).bfloat16()       # chunks of 15
        assert ring._odd(op, odd, n)
        assert not ring._odd(op, odd.float(), n)        # f32 moves as is
        padded = ring._padded(odd, parts)
        assert padded.shape == (parts, odd.numel() // parts + 1)
        assert torch.equal(padded[:, :-1].reshape(odd.shape), odd)
        assert (padded[:, -1] == 0).all()
        assert ring.workspace_bytes(op, odd, n) == \
            ring.workspace_bytes(op, ring._words([padded], op)[0], n)
        xs = [torch.randn(parts, 3, 5).bfloat16() for _ in range(n)]
        staged = ring.loopback_ref(op, [ring._words([ring._padded(x, parts)],
                                                    op)[0] for x in xs])
        for got, want in zip(staged, ring.loopback_ref(op, xs)):
            got = got.view(torch.bfloat16).reshape(parts, -1)[:, :-1]
            assert torch.equal(got.reshape(want.shape).view(torch.int16),
                               want.view(torch.int16))


@pytest.mark.parametrize("n", [2, 4])
def test_bf16_sums_are_the_launches_of_their_words(mesh4, n):
    """A bf16 all-reduce or reduce-scatter hands the kernel the float32
    words of its bytes (each chunk an even element count, or it is
    refused), as the gather does: the same workspace bytes and region
    bookkeeping. The receivers' order written out on bf16 (every add
    rounded) gives the plain ring's bits and, at n = 4, those of the
    Pallas rings in interpret mode on bf16."""
    import jax.numpy as jnp
    x = torch.randn(n * 768, 768).bfloat16()
    for op in (ring.ALL_REDUCE, ring.REDUCE_SCATTER):
        w = ring._words([x], op, n)[0]
        assert w.dtype == torch.float32 and w.data_ptr() == x.data_ptr()
        assert w.numel() % n == 0
        assert ring.workspace_bytes(op, x, n) == \
            ring.workspace_bytes(op, w, n)
        with pytest.raises(ValueError, match="odd"):
            ring._words([torch.zeros(n, 3, dtype=torch.bfloat16)], op, n)
    xs = [t.bfloat16() for t in _inputs(n, SHAPES["vectorised"], 13)]
    models = {ring.REDUCE_SCATTER: _receiver_model,
              ring.ALL_REDUCE: _all_reduce_model}
    for op, model in models.items():
        got = model(xs, loopback=False)
        for g, w in zip(got, ring.loopback_ref(op, xs)):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g.view(torch.int16), w.view(torch.int16))
        if n == 4:
            fn = functools.partial(getattr(jr, op), axis_name=DATA_AXIS,
                                   interpret=True)
            f = jax.shard_map(fn, mesh=mesh4, in_specs=P(DATA_AXIS),
                              out_specs=P(DATA_AXIS), check_vma=False)
            want = np.asarray(f(jnp.asarray(
                torch.cat(xs).float().numpy(), jnp.bfloat16)))
            want = want.view(np.int16).reshape((n, -1) + want.shape[1:])
            for r, g in enumerate(got):
                np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                              want[r])
