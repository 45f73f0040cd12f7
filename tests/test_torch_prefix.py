"""The port's radix prefix cache (``decode/prefix.py``), its pool edits
(``decode/paged.py`` ``copy_block``, ``copy_block_rows``,
``corrupt_block``) and the engine paths that share blocks, against the
JAX package's.

- ``PrefixCache`` against JAX's, driven through the same operation
  sequences and compared node for node (blocks, refs, LRU clocks, poison,
  parent links) and result for result.
- The engine with the prefix cache on against JAX's engine with it on,
  greedy and sampled under JAX's Gumbel draws, at f32, bf16 and int8:
  tokens and counters equal; on against off in the port, token for
  token. The same for ``prefix_partial`` (at int8 the borrowed rows keep
  the donor's frozen scale, so only JAX's tokens are the reference).
- Copy-on-write by hand, LRU reclaim under pool pressure, int8 scales
  frozen while shared, preemption releasing shared blocks, and a
  poisoned sharer or a corrupted shared block: survivors bit-identical,
  the tree healed.

Tiny width (2 layers, d 64, 4 heads, vocab 256, block 4, chunk 4); the
port runs on the CPU, where the fused path runs the kernel's plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.decode import paged as jpaged
from distributed_llm_code_samples_tpu.decode.prefix import (
    PrefixCache as JPrefixCache)
from distributed_llm_code_samples_tpu_torch.decode import paged as tpaged
from distributed_llm_code_samples_tpu_torch.decode.prefix import (
    PrefixCache)
from torch_serve_refs import (CASE_IDS, CASES, KV_DTYPES, Engines,
                              counters, drained_invariants, one_thread,
                              shared_prompts,
                              staggered)  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def engines():
    return Engines()


# ---------------------------------------------------------------------------
# the radix tree, node for node against JAX's


def _blocks(nodes):
    return [n.block for n in nodes]


def _attempt(log, tag, fn):
    try:
        log.append((tag, fn()))
    except (RuntimeError, ValueError) as e:
        log.append((tag, type(e).__name__))


def script_refs_and_dedup(pc, log):
    """Match cap, inserts, late dedup, locks and releases, the refs-0 and
    shared counts, and the refusals."""
    log.append(("cap", [pc.match_cap(n) for n in (1, 4, 5, 8, 9, 12, 13)]))
    p = list(range(16))
    q = list(range(8)) + [99] * 8             # shares two blocks with p
    for i, b in enumerate((5, 6, 7)):
        log.append(("insert", pc.insert(p, i, b, step=i + 1).block))
    log.append(("dedup", pc.insert(q, 0, 9, step=4).block))
    log.append(("dedup", pc.insert(q, 1, 9, step=4).block))
    log.append(("new", pc.insert(q, 2, 10, step=5).block))
    _attempt(log, "not full",
             lambda: pc.insert(p[:10], 2, 11, step=5).block)
    log.append(("match", _blocks(pc.match(p))))          # capped at 3
    log.append(("match", _blocks(pc.match(p[:9]))))
    log.append(("match", _blocks(pc.match(q + [1]))))
    log.append(("miss", _blocks(pc.match(list(range(1, 13))))))
    log.append(("warm", pc.warm_blocks(p[:13])))
    hits = pc.match(p + [0])
    pc.lock(hits, step=6)
    pc.lock(pc.match(q + [0]), step=7)
    log.append(("counts", pc.evictable_blocks(), pc.shared_blocks(),
                len(pc)))
    log.append(("evict", pc.evict_lru(3, step=8)))      # leaf 10 only
    _attempt(log, "detach live", lambda: pc.detach_subtree(hits[0]))
    for n in reversed(hits):
        pc.release(n, step=9)
    log.append(("counts", pc.evictable_blocks(), pc.shared_blocks(),
                len(pc)))
    _attempt(log, "release", lambda: pc.release(hits[-1], 9))
    log.append(("nodes", [(n.block, n.refs, n.last_use)
                          for n in pc.nodes()]))


def script_lru_and_poison(pc, log):
    """LRU order on leaves only (a parent goes once its children are
    gone), poisoned nodes out of ``match``, ``insert`` and
    ``partial_match``, and the detach of a poisoned path."""
    p1, p2, p3 = [0, 1, 2, 3, 4, 5], [0, 1, 9, 9, 4, 4], [7, 7, 1, 1]
    log.append(("a", pc.insert(p1, 0, 5, step=1).block))
    log.append(("b", pc.insert(p1, 1, 6, step=2).block))
    log.append(("c", pc.insert(p2, 1, 7, step=9).block))
    log.append(("d", pc.insert(p3, 0, 8, step=3).block))
    log.append(("d2", pc.insert(p3, 1, 4, step=4).block))
    log.append(("evict", pc.evict_lru(1, step=10)))     # oldest leaf: 6
    part = pc.partial_match([0, 1, 9, 2, 2], pc.match([0, 1, 9]))
    log.append(("partial", None if part is None else (part[0].block,
                                                      part[1])))
    part = pc.partial_match([7, 7, 1, 3, 3, 3], [])
    log.append(("partial", (part[0].block, part[1])))
    part = pc.partial_match([7, 2, 2], [])
    log.append(("partial", (part[0].block, part[1])))
    log.append(("partial", pc.partial_match([3, 3, 3], [])))
    node = pc.node_for_block(8)
    node.poisoned = True
    log.append(("match poisoned", _blocks(pc.match(p3 + [1]))))
    log.append(("insert under poisoned", pc.insert(p3, 1, 11, step=11)))
    log.append(("dedup onto poisoned", pc.insert(p3, 0, 12, step=11)))
    log.append(("partial poisoned", pc.partial_match([7, 7, 5], [])))
    log.append(("detach", sorted(pc.detach_subtree(node))))
    log.append(("evict", pc.evict_lru(10, step=12)))     # 7, then 5
    log.append(("empty", len(pc), _blocks(pc.match(p1))))
    n = pc.insert(p1, 0, 5, step=13)
    pc.lock([n], step=13)
    log.append(("evict live", pc.evict_lru(1, step=14)))
    log.append(("orphan", node.parent is None))


def script_versions_and_snapshot(pc, log):
    """Versioned roots (a match never crosses them) and the snapshot's
    pre-order with parent links."""
    a = pc.insert([0, 1, 2, 3], 0, 5, step=1)
    pc.lock([a], step=1)
    pc.insert([0, 1, 2, 3], 1, 6, step=2)
    pc.insert([0, 1, 4, 4], 1, 3, step=2)
    pc.insert([0, 1, 2, 3, 9], 0, 8, step=3, version=1)
    log.append(("v0", _blocks(pc.match([0, 1, 2, 3, 9]))))
    log.append(("v1", _blocks(pc.match([0, 1, 2, 3, 9], version=1))))
    log.append(("v2", _blocks(pc.match([0, 1, 2, 3, 9], version=2))))
    pc.node_for_block(3).poisoned = True
    log.append(("paths", [n.path_tokens() for n in pc.nodes()]))


# (script, block size)
TREE_SCRIPTS = ((script_refs_and_dedup, 4), (script_lru_and_poison, 2),
                (script_versions_and_snapshot, 2))


@pytest.mark.parametrize("script,block_size", TREE_SCRIPTS,
                         ids=[s.__name__ for s, _ in TREE_SCRIPTS])
def test_prefix_cache_equals_jax_node_for_node(script, block_size):
    logs, snaps = [], []
    for cls in (PrefixCache, JPrefixCache):
        pc, log = cls(block_size), []
        script(pc, log)
        logs.append(log)
        snaps.append(pc.snapshot())
    assert logs[0] == logs[1]
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# the pool edits, bit for bit against JAX's


def _filled_pools(kv_dtype, seed=3):
    rng = np.random.default_rng(seed)
    shape = (2, 6, 2, 4, 8)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    jp = jpaged.init_pool(2, 6, 2, 4, 8, kv_dtype)
    if kv_dtype == "int8":
        ks = rng.uniform(0.01, 0.1, size=shape[:3]).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, size=shape[:3]).astype(np.float32)
        kq = rng.integers(-127, 128, size=shape).astype(np.int8)
        vq = rng.integers(-127, 128, size=shape).astype(np.int8)
        jp = jp._replace(k=jnp.asarray(kq), v=jnp.asarray(vq),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    else:
        dt = jp.k.dtype
        jp = jp._replace(k=jnp.asarray(k).astype(dt),
                         v=jnp.asarray(v).astype(dt))
    tp = tpaged.PagedKV(*(None if a is None else _to_torch(a) for a in jp))
    return jp, tp


def _fields(pool):
    return (pool.k, pool.v, pool.k_scale, pool.v_scale)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int32)).to(
            torch.int16).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same(jp, tp):
    for a, b in zip(jp, _fields(tp)):
        if a is None:
            assert b is None
            continue
        assert torch.equal(_to_torch(a), b)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_pool_edits_bitwise(kv_dtype):
    """``copy_block`` (the copy-on-write copy), ``copy_block_rows`` (the
    donor's first rows, the rest zeroed, the int8 scale copied whole and
    frozen) and ``corrupt_block`` leave the same bytes as JAX's."""
    jp, tp = _filled_pools(kv_dtype)
    jp = jpaged.copy_block(jp, 2, 4)
    tpaged.copy_block(tp, 2, 4)
    _same(jp, tp)
    for src, dst, m in ((1, 3, 1), (5, 2, 3), (4, 1, 0)):
        jp = jpaged.copy_block_rows(jp, src, dst, m)
        tpaged.copy_block_rows(tp, src, dst, m)
        _same(jp, tp)
    jp = jpaged.corrupt_block(jp, 3)
    tpaged.corrupt_block(tp, 3)
    for a, b in zip(jp, _fields(tp)):
        if a is not None:
            np.testing.assert_array_equal(np.isnan(np.asarray(
                a, np.float32)), torch.isnan(b.float()).numpy())
    with pytest.raises(ValueError, match="outside pool"):
        tpaged.corrupt_block(tp, 6)


# ---------------------------------------------------------------------------
# the engine with the cache on, against JAX's


def _prefix_drive(eng, prompts):
    """Staggered sharers, a second wave that hits the refs-0 cache, and a
    wave admitted together (the late-dedup remap)."""
    out = staggered(eng, prompts)
    out.update(staggered(eng, prompts, uid0=10))
    more = shared_prompts(tails=(4, 5, 6), seed=8)
    out.update(staggered(eng, more, steps_between=0, uid0=20))
    return out


@pytest.mark.parametrize("kv_dtype,sampled", CASES, ids=CASE_IDS)
def test_prefix_cache_equals_jax_engine(engines, kv_dtype, sampled):
    prompts = shared_prompts()
    jeng = engines.jax(kv_dtype, sampled)
    want = _prefix_drive(jeng, prompts)
    on = engines.port(kv_dtype, sampled)
    got = _prefix_drive(on, prompts)
    assert got == want
    assert counters(on) == counters(jeng)
    # wave 1: two of three hit 3 blocks; wave 2: all three do
    assert on.prefix_hit_blocks >= 3 + 3 + 9 and on.cow_copies == 0
    assert on.prefill_tokens_saved == 4 * on.prefix_hit_blocks
    off = engines.port(kv_dtype, sampled, prefix_cache=False)
    assert _prefix_drive(off, prompts) == got
    assert off.prefix is None and off.prefix_hit_blocks == 0
    # one prefill pass over the shared prefix a wave, not one a request
    assert on.prefill_dispatches < off.prefill_dispatches
    assert all(n.refs == 0 for n in on.prefix.nodes())


def _partial_prompts():
    """A donor, then prompts sharing one full block and two tokens of the
    next, three tokens of the first block, and the donor's whole head."""
    donor = shared_prompts()[0]
    rng = np.random.default_rng(9)
    tail = rng.integers(0, 256, size=8).tolist()
    return [donor, donor[:6] + tail[:6], donor[:3] + tail[:8],
            donor[:13] + [77]]


@pytest.mark.parametrize("kv_dtype,sampled", CASES, ids=CASE_IDS)
def test_prefix_partial_equals_jax_engine(engines, kv_dtype, sampled):
    prompts = _partial_prompts()
    jeng = engines.jax(kv_dtype, sampled, prefix_partial=True)
    want = staggered(jeng, prompts, steps_between=4)
    eng = engines.port(kv_dtype, sampled, prefix_partial=True)
    got = staggered(eng, prompts, steps_between=4)
    assert got == want
    assert counters(eng) == counters(jeng)
    assert eng.partial_hits >= 2 and eng.cow_copies == 0
    if kv_dtype != "int8":
        # f32 and bf16 rows are per-row pure: sharing part of a block
        # changes no token (int8's frozen donor scale may)
        assert staggered(engines.port(kv_dtype, sampled),
                         prompts, steps_between=4) == got


# ---------------------------------------------------------------------------
# copy-on-write, reclaim, frozen scales, preemption, poison


def arrive(eng, prompts, max_new, gaps=(4, 1, 1)):
    """Submit prompt i, then step ``gaps[i]`` times: the first sharer's
    prompt (four chunks) is cached before the others arrive, and all are
    resident together."""
    for i, (p, gap) in enumerate(zip(prompts, gaps)):
        eng.submit(p, max_new, uid=i)
        for _ in range(gap):
            eng.step()


def test_cow_privatizes_without_touching_the_sharer(engines):
    """The barrier forced by hand (no scheduler write aims at a shared
    block): a bit-identical private copy, one table remapped, one ref
    dropped, and the other sharer's bytes and tokens untouched."""
    prompts = shared_prompts()[:2]
    eng = engines.port()
    arrive(eng, prompts, 10)
    slot1 = next(i for i, s in enumerate(eng.slots)
                 if s is not None and s.uid == 1)
    seq1 = eng.slots[slot1]
    node = seq1.nodes[0]
    src = node.block
    before = eng.pool.k[:, src].clone()
    assert node.refs == 2
    eng._cow_private(slot1, 0, 0)
    assert eng.cow_copies == 1 and seq1.nodes[0] is None
    dst = seq1.blocks[0]
    assert dst != src and eng.tables[slot1][0] == dst and node.refs == 1
    assert torch.equal(eng.pool.k[:, dst], before)
    assert torch.equal(eng.pool.k[:, src], before)
    assert eng.run() == staggered(engines.port(), prompts, max_new=10)


def test_lru_reclaim_under_pool_pressure(engines):
    """refs-0 cached blocks return to the free list on demand (LRU), so
    retention never starves admission: a request that needs more than
    the free list admits by reclaiming them."""
    eng = engines.port()
    eng.submit(shared_prompts()[0], 5, uid=0)          # 5 blocks, 3 cached
    eng.run()
    assert len(eng.prefix) == 3 and eng.prefix.evictable_blocks() == 3
    assert len(eng.free_blocks) == 7
    rng = np.random.default_rng(11)
    big = rng.integers(0, 256, size=25).tolist()        # 8 blocks
    small = rng.integers(0, 256, size=9).tolist()
    eng.submit(big, 8, uid=1)
    eng.step()
    # the least recently used leaf went: the cached path lost its tip
    assert eng.prefix.warm_blocks(shared_prompts()[0]) == 2
    eng.submit(small, 4, uid=2)
    done = eng.run()
    assert sorted(done) == [0, 1, 2]
    assert len(eng.prefix.nodes()) == len(eng.prefix)    # coherent
    fresh = engines.port(prefix_cache=False)
    fresh.submit(big, 8, uid=1)
    fresh.submit(small, 4, uid=2)
    assert fresh.run() == {u: done[u] for u in (1, 2)}


def test_int8_scales_frozen_while_shared(engines):
    """No write window covers a fully prefilled prompt block, so sharers
    decoding to the end never move a shared block's values or scales."""
    eng = engines.port("int8")
    arrive(eng, shared_prompts(), 6)
    blocks = [n.block for n in eng.prefix.nodes()]
    assert len(blocks) == eng.prefix.shared_blocks() == 3
    saved = [t[:, blocks].clone() for t in _fields(eng.pool)]
    eng.run()
    for t, s in zip(_fields(eng.pool), saved):
        assert torch.equal(t[:, blocks], s)


def test_preemption_decrefs_shared_blocks(engines):
    """Preempting a sharer releases its refs (never a scrub), the replay
    walks the tree again, and the tokens equal the unshared engine's and
    JAX's under the same policy."""
    prompts = shared_prompts()
    policy = dict(preempt_after_steps=2)

    def drive(eng):
        # 6 blocks each: two sharers hold 9 of the 10, the third waits
        arrive(eng, prompts, 10)
        return eng.run()

    jeng = engines.jax(policy=policy)
    want = drive(jeng)
    eng = engines.port(policy=policy)
    assert drive(eng) == want
    assert eng.preempted == jeng.preempted >= 1
    assert eng.block_scrubs == 0 and eng.cow_copies == 0
    assert all(n.refs == 0 for n in eng.prefix.nodes())
    assert drive(engines.port(prefix_cache=False)) == want


def test_shared_block_quarantine_survivor_bit_identical(engines):
    """A sharer's logits poisoned mid-decode: its quarantine releases the
    shared prefix (the survivors' bytes) instead of scrubbing it, and the
    survivors finish bit-identical to a run that never admitted it; with
    a retry the poisoned sharer replays onto the cached prefix and lands
    the clean tokens. Both as JAX's engine does."""
    prompts = shared_prompts()

    def drive(eng):
        for i, p in enumerate(prompts):
            eng.submit(p, 6, uid=i)
        while not (eng.slots[1] is not None and eng.slots[1].out):
            eng.step()
        eng.arm_poison(1)
        return eng.run()

    clean = staggered(engines.port(), prompts, steps_between=0)
    for retries in (0, 1):
        policy = dict(max_retries=retries)
        eng = engines.port(policy=policy)
        got = drive(eng)
        jeng = engines.jax(policy=policy)
        assert got == drive(jeng)
        assert counters(eng) == counters(jeng)
        assert eng.quarantined == 1
        if retries:
            assert eng.failed == {} and got == clean
        else:
            assert set(eng.failed) == {1}
            assert got == {u: clean[u] for u in (0, 2)}
        assert len(eng.prefix) >= 3
        assert eng.prefix.evictable_blocks() == len(eng.prefix)


def test_corrupt_shared_block_poisons_tree_then_heals(engines):
    """A block the tree holds is corrupted: the node is poisoned at once
    (no new sharer matches it), the sharers quarantine as their
    dispatches read the NaN, the last release scrubs and detaches the
    path, and the retries recover the clean tokens. The retries' prefill
    chunks are scheduled otherwise than in JAX: the port under JAX's rule
    gives JAX's counters, the port JAX's tokens and its own
    invariants."""
    prompts = shared_prompts()

    def drive(eng):
        for i, p in enumerate(prompts):
            eng.submit(p, 6, uid=i)
        while eng.prefix.shared_blocks() < 3:
            eng.step()
        block = eng.slots[0].blocks[0]
        eng.corrupt_block(block)
        assert eng.prefix.node_for_block(block).poisoned
        assert eng.prefix.match(prompts[0]) == []
        return eng.run()

    policy = dict(max_retries=1)
    eng = engines.port(policy=policy)
    got = drive(eng)
    jeng = engines.jax(policy=policy)
    assert got == drive(jeng)
    twin = engines.port(policy=policy, jax_rule=True)
    assert drive(twin) == got
    assert counters(twin) == counters(jeng)
    drained_invariants(eng)
    assert eng.failed == {} and eng.quarantined >= 2
    assert got == staggered(engines.port(), prompts, steps_between=0)
    assert not eng._corrupted
    assert all(not n.poisoned for n in eng.prefix.nodes())
    assert not torch.isnan(eng.pool.k).any()
