"""The port's ``ServePolicy`` paths in the decode engine against the JAX
package's: pool-pressure preemption with replay-resume, quarantine
retries, deadlines, the bounded queue, and the generate CLI's flags.

- Preempt-resume and a quarantine retry (``arm_poison``) give JAX's
  engine's tokens, counters and request records under the same policy,
  greedy and sampled under JAX's Gumbel draws, at f32, bf16 and int8, and
  the uninterrupted run's tokens.
- The last resident is never evicted; the head's streak resets when the
  head changes; ``queue_limit`` raises ``AdmissionError`` with its
  record; deadlines expire and preemption does not extend them; policy
  validation; duplicate uids refused; a corrupted block evicted by
  preemption is scrubbed before reuse; ``generate`` sheds to None.
- The generate CLI's new flags on the CPU, and their rc 2 refusals.

Tiny width (2 layers, d 64, 4 heads, vocab 256, block 4, chunk 4) on the
CPU.
"""

import json

import pytest
import torch

from distributed_llm_code_samples_tpu_torch.decode import (AdmissionError,
                                                           EngineConfig,
                                                           ServePolicy)
from distributed_llm_code_samples_tpu_torch.decode.generate_cli import (
    generate_main)
from torch_serve_refs import (CASE_IDS, CASES, MAX_NEW, Engines, counters,
                              drained_invariants, one_thread,
                              plain_prompts)  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

# JAX's request records carry keys whose slices are not ported yet
UNPORTED_KEYS = {"weights_version", "trace_id", "tenant"}
# the second victim has two tokens to replay
PREEMPT = dict(preempt_after_steps=4)


@pytest.fixture(scope="module")
def engines():
    return Engines()


@pytest.fixture(scope="module")
def prompts():
    return plain_prompts()


def drain(eng, prompts, max_new=MAX_NEW):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, uid=i)
    return eng.run()


def records(eng):
    """The request records without their wall-clock values."""
    return [{k: v for k, v in e.items()
             if k not in UNPORTED_KEYS | {"latency_s", "ttft_s"}}
            for e in eng.request_events]


def assert_like_jax(eng, jeng):
    assert counters(eng) == counters(jeng)
    assert records(eng) == records(jeng)
    for e, je in zip(eng.request_events, jeng.request_events):
        assert set(e) == set(je) - UNPORTED_KEYS


@pytest.mark.parametrize("kv_dtype,sampled", CASES, ids=CASE_IDS)
def test_preempt_resume_equals_jax_and_uninterrupted(engines, prompts,
                                                     kv_dtype, sampled):
    """Three requests needing 12 blocks on a pool of 10: the youngest is
    preempted and later replayed, re-prefilled with its recorded tokens
    teacher-forced, and every request's tokens equal the uninterrupted
    run's (the write history, int8 requant included, is the same). The
    port's oldest-first prefill chunk schedules this case otherwise than
    JAX's lowest slot: the port under JAX's rule gives JAX's counters and
    records, and the port itself JAX's tokens and its own invariants."""
    jeng = engines.jax(kv_dtype, sampled, policy=PREEMPT)
    want = drain(jeng, prompts)
    twin = engines.port(kv_dtype, sampled, policy=PREEMPT, jax_rule=True)
    assert drain(twin, prompts) == want
    assert_like_jax(twin, jeng)
    eng = engines.port(kv_dtype, sampled, policy=PREEMPT)
    assert drain(eng, prompts) == want
    assert eng.preempted >= 1 and not eng.failed
    drained_invariants(eng)
    assert any(e["event"] == "admitted" and e["replay"] > 0
               for e in eng.request_events)
    assert drain(engines.port(kv_dtype, sampled), prompts) == want


@pytest.mark.parametrize("kv_dtype,sampled", CASES, ids=CASE_IDS)
def test_quarantine_retry_equals_jax(engines, prompts, kv_dtype, sampled):
    """``arm_poison`` of a running uid: it is quarantined, replayed once
    (``max_retries=1``) and ends with the clean run's tokens, as in JAX's
    engine with ``arm_poison``; without budget it fails. The replay's
    prefill chunks are scheduled otherwise than in JAX: the port under
    JAX's rule gives JAX's counters and records, the port JAX's tokens
    and its own invariants."""
    def drive(eng):
        for i, p in enumerate(prompts):
            eng.submit(p, MAX_NEW, uid=i)
        while not (eng.slots[1] is not None and len(eng.slots[1].out) > 2):
            eng.step()
        eng.arm_poison(1)
        return eng.run()

    clean = drain(engines.port(kv_dtype, sampled), prompts)
    policy = dict(max_retries=1)
    jeng = engines.jax(kv_dtype, sampled, policy=policy)
    want = drive(jeng)
    twin = engines.port(kv_dtype, sampled, policy=policy, jax_rule=True)
    assert drive(twin) == want
    assert_like_jax(twin, jeng)
    eng = engines.port(kv_dtype, sampled, policy=policy)
    assert drive(eng) == want == clean
    drained_invariants(eng)
    assert eng.quarantined == eng.retried == 1 and eng.failed == {}
    eng = engines.port(kv_dtype, sampled)
    assert drive(eng) == {u: clean[u] for u in (0, 2)}
    assert eng.quarantined == 1 and eng.retried == 0
    assert eng.failed == {1: {"reason": "nonfinite_logits", "retries": 0,
                              "n_out": 3}}


def _small(**kw):
    return EngineConfig(**dict(dict(block_size=8, n_blocks=7, max_slots=3,
                                    max_blocks_per_seq=3, prefill_chunk=8),
                               **kw))


def test_head_streak_resets_when_head_changes(engines, prompts):
    """The preemption streak belongs to one head: when the starved head
    leaves, its successor earns its own ``preempt_after_steps``."""
    eng = engines.port(policy=dict(preempt_after_steps=3))   # 10 blocks
    eng.submit(prompts[0], MAX_NEW, uid=0)     # 3 blocks
    eng.submit(prompts[1], MAX_NEW, uid=1)     # 4 blocks -> 3 free
    eng.submit(prompts[2], MAX_NEW, uid=2)     # needs 5: starved head
    eng.step()
    eng.step()
    assert eng._head_blocked == 2 and eng._head_blocked_uid == 2
    eng.waiting.popleft()                      # the starved head leaves
    eng.submit(prompts[2], MAX_NEW, uid=3)     # a new starved head
    eng.step()
    assert eng._head_blocked == 1 and eng._head_blocked_uid == 3
    assert eng.preempted == 0


def test_preemption_never_evicts_last_resident(engines, prompts):
    """With one running sequence the head waits instead of evicting it,
    and the run still completes."""
    from distributed_llm_code_samples_tpu_torch.decode import DecodeEngine
    cfg = EngineConfig(block_size=8, n_blocks=4, max_slots=2,
                       max_blocks_per_seq=3, prefill_chunk=8)
    eng = DecodeEngine(engines.tp, 4, cfg,
                       policy=ServePolicy(preempt_after_steps=1))
    eng.submit(prompts[1], 8, uid=0)           # 2 of the 3 usable blocks
    eng.submit(prompts[1], 8, uid=1)           # waits, never evicts uid 0
    done = eng.run()
    assert eng.preempted == 0 and sorted(done) == [0, 1]
    assert done[0] == done[1]                  # greedy, the same prompt


def test_queue_limit_rejects_with_event(engines, prompts):
    eng = engines.port(policy=dict(queue_limit=2))
    eng.submit(prompts[0], 4)
    eng.submit(prompts[1], 4)
    with pytest.raises(AdmissionError, match="queue full") as exc:
        eng.submit(prompts[2], 4)
    assert exc.value.reason == "queue_full" and eng.rejected == 1
    rej = [e for e in eng.request_events if e["event"] == "rejected"]
    # an auto uid is not consumed, so the record carries -1
    assert rej == [{"step": 0, "uid": -1, "event": "rejected",
                    "reason": "queue_full", "queue_len": 2}]
    assert sorted(eng.run()) == [0, 1]
    assert eng.submit(prompts[2], 4) == 2


def test_generate_sheds_to_none_not_exception(engines, prompts):
    eng = engines.port(policy=dict(queue_limit=2))
    outs = eng.generate(prompts, 4)
    assert outs[2] is None and eng.rejected == 1
    ref = drain(engines.port(), prompts[:2], max_new=4)
    assert outs[:2] == [ref[0], ref[1]]


def test_deadline_expires_overdue_requests(engines, prompts):
    """With one slot and a 4-step deadline, the queued request and the
    too-slow running one fail with reason ``deadline``."""
    from distributed_llm_code_samples_tpu_torch.decode import DecodeEngine
    eng = DecodeEngine(engines.tp, 4, EngineConfig(**dict(
        engines.config("f32", False), max_slots=1)),
        policy=ServePolicy(deadline_steps=4))
    u0 = eng.submit(prompts[0], 16)
    u1 = eng.submit(prompts[1], 16)
    assert eng.run() == {}
    assert eng.failed[u0]["reason"] == eng.failed[u1]["reason"] == "deadline"
    assert eng.expired == 2
    assert {e["uid"] for e in eng.request_events
            if e["event"] == "expired"} == {u0, u1}
    assert sorted(eng.free_blocks + [n.block for n in eng.prefix.nodes()]) \
        == list(range(1, eng.cfg.n_blocks))


def test_deadline_not_extended_by_preemption(engines, prompts):
    """The time to live counts from the original submission: a request
    both preempted and past its deadline expires."""
    from distributed_llm_code_samples_tpu_torch.decode import DecodeEngine
    policy = ServePolicy(preempt_after_steps=1, deadline_steps=6)
    eng = DecodeEngine(engines.tp, 4, _small(), policy=policy)
    for i, p in enumerate(prompts):
        eng.submit(p, 8, uid=i)
    eng.run()
    assert eng.preempted >= 1 and eng.expired >= 1
    preempted = {e["uid"] for e in eng.request_events
                 if e["event"] == "preempted"}
    assert preempted & set(eng.failed)
    assert all(info["reason"] == "deadline"
               for info in eng.failed.values())
    outs = DecodeEngine(engines.tp, 4, _small(),
                        policy=policy).generate(prompts, 8)
    assert len(outs) == 3 and any(o is None for o in outs)


def test_policy_validation_and_duplicate_uids(engines, prompts):
    for name in ("queue_limit", "deadline_steps", "max_retries",
                 "preempt_after_steps"):
        with pytest.raises(ValueError, match=name):
            ServePolicy(**{name: -1})
    eng = engines.port()
    with pytest.raises(ValueError, match="uid must be >= 0"):
        eng.submit(prompts[0], 8, uid=-1)
    eng.submit(prompts[0], 8, uid=5)
    with pytest.raises(ValueError, match="already in use"):
        eng.submit(prompts[1], 8, uid=5)       # waiting
    eng.step()
    assert eng.active == 1
    with pytest.raises(ValueError, match="already in use"):
        eng.submit(prompts[1], 8, uid=5)       # in a slot
    eng.arm_poison(5)
    eng.step()                                 # quarantined -> failed
    assert 5 in eng.failed
    with pytest.raises(ValueError, match="already in use"):
        eng.submit(prompts[1], 8, uid=5)       # failed stays reserved


def test_quarantine_waiting_retries_or_fails(engines, prompts):
    """A request that faults before it takes a slot leaves the queue
    with the same verdict as a running one: replayed with budget left,
    failed without."""
    for retries, failed in ((1, set()), (0, {0})):
        eng = engines.port(policy=dict(max_retries=retries))
        eng.submit(prompts[0], 4, uid=0)
        eng.submit(prompts[1], 4, uid=1)
        eng._quarantine_waiting(0, "nonfinite_logits")
        assert [s.uid for s in eng.waiting] == ([1, 0] if retries else [1])
        done = eng.run()
        assert set(eng.failed) == failed and eng.quarantined == 1
        assert sorted(done) == ([0, 1] if retries else [1])


def test_evicted_corrupted_block_scrubbed_before_reuse(engines, prompts):
    """A corrupted block whose owner is preempted before its next
    dispatch is scrubbed on release, so no innocent request inherits the
    NaN; every request ends with the clean run's tokens."""
    from distributed_llm_code_samples_tpu_torch.decode import DecodeEngine
    clean = drain(engines.port(), prompts)
    eng = DecodeEngine(engines.tp, 4, _small(),
                       policy=ServePolicy(preempt_after_steps=1))
    eng.submit(prompts[0], 8, uid=0)           # blocks 1, 2
    eng.submit(prompts[1], 8, uid=1)           # blocks 3, 4 (youngest)
    eng.step()
    eng.corrupt_block(4)                       # uid 1's private block
    eng.submit(prompts[2], 8, uid=2)           # starves: uid 1 preempted
    done = eng.run()
    assert eng.preempted >= 1 and eng.failed == {}
    assert done == clean
    assert eng._corrupted == set() and eng.block_scrubs >= 1
    assert not torch.isnan(eng.pool.k).any()


CLI = ["--device", "cpu", "-d", "32", "-l", "2", "--heads", "4", "--vocab",
       "64", "--max_seq_len", "64", "--block_size", "4", "--prefill_chunk",
       "4", "--max_new", "4"]
SHARED = "3,1,4,1,5,9,2,6,5,3;3,1,4,1,5,9,2,6,5,3"


def _cli(capsys, argv):
    rc = generate_main(CLI + argv)
    out, err = capsys.readouterr()
    return rc, (json.loads(out.strip().splitlines()[-1]) if rc == 0
                else None), err


def test_generate_cli_prefix_and_policy_flags(capsys):
    """Default on with its accounting and JAX's summary line;
    ``--no-prefix_cache`` gives the same tokens; ``--prefix_partial``;
    ``--queue_limit`` sheds (counted, rc 0)."""
    rc, on, err = _cli(capsys, ["--prompts", SHARED, "--max_slots", "1"])
    assert rc == 0 and on["prefix_cache"] is True
    # one slot serializes the two identical prompts: the second hits
    assert on["prefix_hit_blocks"] == 2 and on["cow_copies"] == 0
    assert on["prefill_tokens_saved"] == 8
    assert ("prefix cache hit 2 block(s) (rate 0.5), saved 8 prefill "
            "token(s), peak 0 shared block(s), 0 CoW cop(ies)") in err
    assert "0 shed, 0 preempted, 0 expired" in err
    rc, off, _ = _cli(capsys, ["--prompts", SHARED, "--max_slots", "1",
                               "--no-prefix_cache"])
    assert rc == 0 and off["prefix_cache"] is False
    assert off["prefix_hit_blocks"] == 0
    assert [s["tokens"] for s in on["sequences"]] == \
        [s["tokens"] for s in off["sequences"]]
    assert on["prefill_dispatches"] < off["prefill_dispatches"]
    # room for the donor's cached block to outlive it
    rc, part, _ = _cli(capsys, ["--prompts", "3,1,4,1,5,9;3,1,4,2,2,2",
                                "--max_slots", "1", "--n_blocks", "9",
                                "--prefix_partial"])
    assert rc == 0 and part["partial_hits"] == 1
    rc, shed, err = _cli(capsys, ["--prompt_lens", "3,4,5",
                                  "--queue_limit", "2"])
    assert rc == 0 and shed["shed"] == shed["rejected"] == 1
    assert len(shed["sequences"]) == 2 and "1 shed" in err
    rc, pre, _ = _cli(capsys, ["--prompt_lens", "5,9,13", "--max_new", "8",
                               "--n_blocks", "11", "--max_blocks_per_seq",
                               "6", "--max_slots", "3", "--preempt_after",
                               "1", "--max_retries", "1",
                               "--deadline_steps", "100"])
    assert rc == 0 and pre["preempted"] >= 1 and pre["failed"] == {}


@pytest.mark.parametrize("argv,msg", [
    (["--max_retries", "-1"], "max_retries"),
    (["--queue_limit", "-3"], "queue_limit"),
    (["--deadline_steps", "-2"], "deadline_steps"),
    (["--preempt_after", "-1"], "preempt_after_steps"),
    (["--no-prefix_cache", "--prefix_partial"], "prefix_partial"),
])
def test_generate_cli_rejects_bad_policy_flags(capsys, argv, msg):
    rc, _, err = _cli(capsys, ["--prompt_lens", "3"] + argv)
    assert rc == 2 and msg in err


def test_generate_cli_flag_takes_no_value():
    with pytest.raises(SystemExit) as exc:
        generate_main(CLI + ["--prompt_lens", "3", "--prefix_cache=maybe"])
    assert exc.value.code == 2
