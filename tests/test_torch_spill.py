"""The port's host spill tier behind the prefix cache
(``decode/spill.py``, ``runtime/wire.py``, ``paged.extract_blocks`` /
``implant_block`` and the engine's demotion and restore) against the JAX
package's.

- ``SpillTier`` units: a round trip, overflow dropping the oldest entry,
  corruption detected at ``take``, zero capacity refused; the counters
  equal JAX's tier's on the same operations.
- The wire: blocks the port extracts and serializes are read by JAX's
  ``deserialize_doc`` bit for bit, and JAX's documents by the port's, at
  f32, bf16 (2-byte words tagged ``bfloat16``) and int8; an implanted
  block equals JAX's.
- Session churn (four 9-token sessions returning three times through a
  pool too small to keep them cached) against JAX's engine with the tier
  and against a big-pool oracle, at every ``kv_dtype``: tokens, counters,
  restores; fewer prefill dispatches than the same churn without the
  tier.
- The per-step restore budget, a poisoned block never spilling, and
  ``corrupt_spill`` quarantining only the restoring request (as JAX's
  engine does).
- Sessions whose prompts fill whole blocks: the final block is cached but
  never matched, so its spilled twin meets the returning session's own
  copy. The port makes that copy the twin's device block and keeps the
  oracle's tokens; JAX's engine remaps the table onto the spilled twin's
  block id, -1, and does not (this test fails once JAX's side is
  repaired).

Tiny width (2 layers, d 64, 4 heads, vocab 256, block 4, chunk 4) on the
CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.decode import paged as jpaged
from distributed_llm_code_samples_tpu.decode.spill import (
    SpillTier as JSpillTier)
from distributed_llm_code_samples_tpu.runtime import wire as jwire
from distributed_llm_code_samples_tpu_torch.decode import paged as tpaged
from distributed_llm_code_samples_tpu_torch.decode import SpillTier
from distributed_llm_code_samples_tpu_torch.runtime import wire
from torch_serve_refs import (BASE, KV_DTYPES, V, Engines, counters,
                              drained_invariants,
                              one_thread)  # noqa: F401 (a fixture)

BLOCK = BASE["block_size"]
SPILL = dict(spill_blocks=32)
BIG = dict(n_blocks=64)
TIER_COUNTERS = ("spilled_blocks", "restores", "restore_tokens_saved")


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def engines():
    return Engines()


@pytest.fixture(scope="module")
def sessions():
    """Four distinct 9-token sessions (2 full blocks and a tail each):
    keeping all four cached outgrows the pool, so churn demotes."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, V, size=9).tolist() for _ in range(4)]


def churn(eng, prompts, returns=3, max_new=6):
    """Each session returns ``returns`` times, a round drained before the
    next; uid ``r * len(prompts) + i``."""
    for r in range(returns):
        for i, p in enumerate(prompts):
            eng.submit(p, max_new, uid=r * len(prompts) + i)
        eng.run()
    return eng


def same_as_oracle(eng, oracle, n):
    for uid, toks in eng.finished.items():
        assert toks == oracle.finished[uid % n], uid


def tier_state(eng):
    return dict(counters(eng), **{k: getattr(eng, k) for k in TIER_COUNTERS})


# ---------------------------------------------------------------------------
# the tier


def _doc(n=12):
    return {"k": np.arange(n, dtype=np.float32).reshape(2, -1),
            "v": np.ones((2, n // 2), np.float32), "k_scale": None,
            "v_scale": None}


def _tier_script(tier, log):
    nodes = ["a", "b", "c"]
    sids = [tier.put(n, _doc())[0] for n in nodes]
    log.append(("len", len(tier), tier.drops))     # capacity 2: one drop
    try:
        tier.take(sids[0])
    except KeyError:
        log.append(("take dropped", "KeyError"))
    log.append(("corrupt", tier.corrupt(sids[1])))
    try:
        tier.take(sids[1])
    except Exception as e:  # noqa: BLE001 - each package's WireError
        log.append(("take corrupt", type(e).__name__))
    back = tier.take(sids[2])
    log.append(("back", np.asarray(back["k"]).tolist(), back["v_scale"]))
    log.append(("drop gone", tier.drop(sids[2]), tier.corrupt(sids[2])))
    log.append(("counters", tier.spills, tier.drops, tier.restores,
                len(tier), tier.bytes_resident))


def test_spill_tier_units_equal_jax():
    logs = []
    for cls in (SpillTier, JSpillTier):
        log = []
        _tier_script(cls(2), log)
        logs.append(log)
    assert logs[0] == logs[1]
    assert ("take corrupt", "WireError") in logs[0]
    tier = SpillTier(4)
    sid, dropped = tier.put("n", _doc())
    assert dropped == [] and tier.utilization() == 0.25
    back = tier.take(sid)
    np.testing.assert_array_equal(back["k"].numpy(), _doc()["k"])
    assert back["k_scale"] is None and len(tier) == 0
    with pytest.raises(KeyError):
        tier.take(sid)
    with pytest.raises(ValueError, match=">= 1 block"):
        SpillTier(0)


# ---------------------------------------------------------------------------
# the wire, across the two packages


def _pools(kv_dtype, seed=5):
    """A JAX pool and the port's with the same random bytes: ``[L 2,
    blocks 6, H_kv 2, block 4, dh 8]``."""
    rng = np.random.default_rng(seed)
    shape = (2, 6, 2, 4, 8)
    jp = jpaged.init_pool(2, 6, 2, 4, 8, kv_dtype)
    if kv_dtype == "int8":
        jp = jp._replace(
            k=jnp.asarray(rng.integers(-127, 128, size=shape), jnp.int8),
            v=jnp.asarray(rng.integers(-127, 128, size=shape), jnp.int8),
            k_scale=jnp.asarray(rng.uniform(0.01, 0.1, shape[:3]),
                                jnp.float32),
            v_scale=jnp.asarray(rng.uniform(0.01, 0.1, shape[:3]),
                                jnp.float32))
    else:
        dt = jp.k.dtype
        jp = jp._replace(k=jnp.asarray(rng.normal(size=shape), dt),
                         v=jnp.asarray(rng.normal(size=shape), dt))
    tp = tpaged.PagedKV(*(None if a is None else _torch(a) for a in jp))
    return jp, tp


def _torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int32)).to(
            torch.int16).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """Comparable raw bits of a torch tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    if t.dtype == jnp.bfloat16:
        return t.view(np.int16)
    return t


def _block_doc(got):
    return {k: (None if a is None else a[:, 0]) for k, a in got.items()}


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_wire_crosses_between_packages(kv_dtype):
    jp, tp = _pools(kv_dtype)
    jdoc = _block_doc(jpaged.extract_blocks(jp, [3]))
    tdoc = _block_doc(tpaged.extract_blocks(tp, [3]))
    for name in ("k", "v", "k_scale", "v_scale"):
        if jdoc[name] is None:
            assert tdoc[name] is None
            continue
        np.testing.assert_array_equal(_bits(tdoc[name]), _bits(jdoc[name]))
    # the port's bytes read by JAX, JAX's bytes read by the port
    from_port = jwire.deserialize_doc(wire.serialize_doc(tdoc))
    from_jax = wire.deserialize_doc(jwire.serialize_doc(jdoc))
    for name in ("k", "v", "k_scale", "v_scale"):
        if jdoc[name] is None:
            assert from_port[name] is None and from_jax[name] is None
            continue
        assert str(from_port[name].dtype) == str(jdoc[name].dtype)
        np.testing.assert_array_equal(_bits(from_port[name]),
                                      _bits(jdoc[name]))
        assert from_jax[name].dtype == tdoc[name].dtype
        assert torch.equal(from_jax[name], tdoc[name])
    # implanting what JAX serialized equals JAX's implant
    jp = jpaged.implant_block(jp, 1, jdoc["k"], jdoc["v"], jdoc["k_scale"],
                              jdoc["v_scale"])
    tpaged.implant_block(tp, 1, from_jax["k"], from_jax["v"],
                         from_jax["k_scale"], from_jax["v_scale"])
    for a, b in zip(jp, (tp.k, tp.v, tp.k_scale, tp.v_scale)):
        if a is not None:
            np.testing.assert_array_equal(_bits(b), _bits(np.asarray(a)))
    # one flipped byte inside k's payload fails its CRC
    data = bytearray(wire.serialize_doc(tdoc))
    at = bytes(data).find(tdoc["k"].reshape(-1).view(torch.uint8)
                          .numpy().tobytes())
    data[at] ^= 0xFF
    with pytest.raises(wire.WireError, match="'k'"):
        wire.deserialize_doc(bytes(data))
    with pytest.raises(wire.WireError, match="torn"):
        wire.deserialize_doc(b"not a wire doc")


# ---------------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_session_churn_equals_jax_and_oracle(engines, sessions, kv_dtype):
    oracle = churn(engines.port(kv_dtype, **BIG), sessions, returns=1)
    jeng = churn(engines.jax(kv_dtype, **SPILL), sessions)
    eng = churn(engines.port(kv_dtype, **SPILL), sessions)
    assert eng.finished == jeng.finished
    assert len(eng.finished) == 3 * len(sessions)
    same_as_oracle(eng, oracle, len(sessions))
    assert tier_state(eng) == tier_state(jeng)
    assert eng.spilled_blocks > 0 and eng.restores > 0
    assert eng.restore_tokens_saved == eng.restores * BLOCK
    assert eng.spill_bytes == eng.spill.bytes_spilled > 0
    assert eng.restore_stall_s > 0.0
    base = churn(engines.port(kv_dtype), sessions)
    assert base.finished == eng.finished
    assert eng.prefill_dispatches < base.prefill_dispatches
    drained_invariants(eng)
    spilled = [n for n in eng.prefix.nodes() if n.spilled]
    assert len(spilled) == len(eng.spill)
    assert sum(n["spilled"] for n in eng.prefix.snapshot()) == len(spilled)


def test_low_water_demotes_ahead_equals_jax(engines, sessions):
    """``spill_low_water``: each step starts by demoting until that many
    blocks are free; the same counters as JAX's engine, more blocks
    spilled than on demand alone, the oracle's tokens."""
    oracle = churn(engines.port(**BIG), sessions, returns=1)
    kw = dict(SPILL, spill_low_water=6)
    jeng = churn(engines.jax(**kw), sessions)
    eng = churn(engines.port(**kw), sessions)
    assert eng.finished == jeng.finished
    same_as_oracle(eng, oracle, len(sessions))
    assert tier_state(eng) == tier_state(jeng)
    lazy = churn(engines.port(**SPILL), sessions)
    assert eng.spilled_blocks > lazy.spilled_blocks
    assert len(eng.free_blocks) >= 6


def test_restore_budget_per_step(engines, sessions):
    """``spill_restore_per_step=1``: a returning session whose prefix
    spilled two blocks is admitted over two steps, each restoring one;
    the engine never stalls and every return gets the oracle's tokens."""
    oracle = churn(engines.port(**BIG), sessions, returns=1)
    eng = churn(engines.port(spill_restore_per_step=1, **SPILL), sessions,
                returns=1)
    for i, p in enumerate(sessions):
        eng.submit(p, 6, uid=10 + i)
    per_step, last = [], 0
    while eng.waiting or eng.active:
        assert eng.step()
        per_step.append(eng.restores - last)
        last = eng.restores
    assert eng.restores > 0 and max(per_step) == 1
    assert len(eng.finished) == 2 * len(sessions)
    for i in range(len(sessions)):
        assert eng.finished[10 + i] == oracle.finished[i]


def test_poisoned_block_never_spills(engines, sessions):
    eng = churn(engines.port(**SPILL), sessions, returns=1)
    cached = sorted(eng.prefix._by_block)
    victim = cached[0]
    eng.corrupt_block(victim)
    before = eng.spilled_blocks
    eng._reclaim_cached(len(cached))
    assert victim in eng.free_blocks and victim not in eng._corrupted
    assert eng.spilled_blocks > before
    assert all(n.block == -1 for n in eng.spill._nodes.values())
    for sid in list(eng.spill._store):
        eng.spill.take(sid)                 # every entry passes its CRC


@pytest.mark.parametrize("retries", [1, 0])
def test_corrupt_spill_quarantines_restoring_request(engines, sessions,
                                                     retries):
    """One flipped byte in a spilled entry: the request that restores it
    is quarantined (``corrupt_spill``) before it takes a slot and, with a
    retry, prefills the detached edge again to its clean tokens; every
    other session keeps its tokens. As in JAX's engine."""
    oracle = churn(engines.port(**BIG), sessions, returns=1)
    policy = dict(max_retries=retries)

    def drive(eng):
        churn(eng, sessions, returns=1)
        assert eng.corrupt_spill(min(eng.spill._store))
        for i, p in enumerate(sessions):
            eng.submit(p, 6, uid=10 + i)
        eng.run()
        return eng

    jeng = drive(engines.jax(policy=policy, **SPILL))
    eng = drive(engines.port(policy=policy, **SPILL))
    assert eng.finished == jeng.finished and eng.failed == jeng.failed
    assert tier_state(eng) == tier_state(jeng)
    assert eng.quarantined == 1 and eng.retried == retries
    bad = [e for e in eng.request_events if e["event"] == "quarantined"]
    assert [e["reason"] for e in bad] == ["corrupt_spill"]
    assert len(eng.finished) == 2 * len(sessions) - (1 - retries)
    for uid, toks in eng.finished.items():
        assert toks == oracle.finished[uid % 10], uid
    if not retries:
        assert list(eng.failed.values()) == [
            {"reason": "corrupt_spill", "retries": 0, "n_out": 0}]


def test_whole_block_sessions_keep_oracle_tokens(engines):
    """Five 8-token sessions (two full blocks, the second holding the
    final token, cached but never matched) through the tier: the port
    gives the oracle's tokens; JAX's engine does not."""
    rng = np.random.default_rng(3)
    whole = [rng.integers(0, V, size=2 * BLOCK).tolist() for _ in range(5)]
    oracle = churn(engines.port(**BIG), whole, returns=1)
    eng = churn(engines.port(**SPILL), whole)
    same_as_oracle(eng, oracle, len(whole))
    assert eng.restores > 0 and eng.spill.drops > 0
    drained_invariants(eng)
    jeng = churn(engines.jax(**SPILL), whole)
    assert any(toks != oracle.finished[uid % len(whole)]
               for uid, toks in jeng.finished.items())


def test_generate_cli_spill_flags(capsys):
    """``--spill_blocks`` restores a returning prompt's demoted blocks
    with the tier-less run's tokens and JAX's summary keys; a bad value
    exits 2."""
    import json

    from distributed_llm_code_samples_tpu_torch.decode.generate_cli import (
        generate_main)
    cli = ["--device", "cpu", "-d", "32", "-l", "2", "--heads", "4",
           "--vocab", "64", "--max_seq_len", "64", "--block_size", "4",
           "--prefill_chunk", "4", "--max_new", "6", "--max_slots", "1",
           "--n_blocks", "7", "--prompts",
           "1,2,3,4,5,6,7,8,9;11,12,13,14,15,16,17,18,19;"
           "21,22,23,24,25,26,27,28,29;1,2,3,4,5,6,7,8,9"]

    def run(argv):
        rc = generate_main(cli + argv)
        out, err = capsys.readouterr()
        return rc, (json.loads(out.strip().splitlines()[-1]) if rc == 0
                    else None), err

    rc, off, _ = run([])
    assert rc == 0 and off["spill_blocks"] == 0 and off["restores"] == 0
    rc, on, err = run(["--spill_blocks", "8", "--spill_restore_per_step",
                       "1"])
    assert rc == 0 and on["spill_blocks"] == 8
    assert on["spilled_blocks"] == 4 and on["restores"] == 2
    assert on["restore_tokens_saved"] == 8 and on["spill_bytes"] > 0
    assert [q["tokens"] for q in on["sequences"]] == \
        [q["tokens"] for q in off["sequences"]]
    assert on["prefill_dispatches"] < off["prefill_dispatches"]
    assert "spill tier: 4 block(s) spilled" in err
    for argv, msg in ((["--spill_blocks", "-1"], "spill_blocks"),
                      (["--spill_blocks", "4", "--spill_restore_per_step",
                        "0"], "spill_restore_per_step"),
                      (["--spill_blocks", "4", "--no-prefix_cache"],
                       "prefix_cache")):
        rc, _, err = run(argv)
        assert rc == 2 and msg in err
