"""The port's speculative decoding (``decode/draft.py``,
``EngineConfig.speculate``, the verify dispatch) against the JAX
package's.

- ``draft_tokens`` against JAX's on seeded histories; the validation.
- The speculative engine at ``speculate`` 1 and 4 against JAX's, at f32,
  bf16 and int8: tokens, ``drafted_tokens``, ``accepted_tokens``,
  ``steps``, the counters and the request records equal; against the
  port's non-speculative engine, token for token.
- The exact-fit edge: a request that fills its reservation exactly, where
  a dead verify row's position passes the block table (clamped, thrown
  away), a one-token request and a short one.
- A poisoned uid under speculation rolls back its whole drafted step and
  retries to the clean tokens, as in JAX's engine.
- Preemption under speculation: replays are teacher-forced as drafts and
  kept out of ``drafted_tokens``/``accepted_tokens``; tokens equal the
  unpressured run's.

Tiny width (2 layers, d 64, 4 heads, vocab 256, block 4, chunk 4) on the
CPU, where the fused path runs the paged kernel's plain version.
"""

import numpy as np
import pytest

from distributed_llm_code_samples_tpu.decode import (
    draft_tokens as j_draft_tokens)
from distributed_llm_code_samples_tpu_torch.decode import (DecodeEngine,
                                                           EngineConfig,
                                                           draft_tokens)
from torch_serve_refs import (BASE, H, KV_DTYPES, MAX_NEW, V, Engines,
                              counters, drained_invariants, one_thread,
                              plain_prompts)  # noqa: F401 (a fixture)

SPEC_COUNTERS = ("drafted_tokens", "accepted_tokens", "tokens_generated")


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def engines():
    return Engines()


@pytest.fixture(scope="module")
def prompts():
    return plain_prompts()


def staggered(eng, prompts, max_new=MAX_NEW):
    """Two prompts at once, three steps, then the third; drained."""
    eng.submit(prompts[0], max_new, uid=0)
    eng.submit(prompts[1], max_new, uid=1)
    for _ in range(3):
        eng.step()
    eng.submit(prompts[2], max_new, uid=2)
    return eng.run()


def records(eng):
    """The request records without wall-clock values or keys of slices
    not ported."""
    drop = {"latency_s", "ttft_s", "weights_version", "trace_id", "tenant"}
    return [{k: v for k, v in e.items() if k not in drop}
            for e in eng.request_events]


def spec_state(eng):
    return dict(counters(eng), **{k: getattr(eng, k)
                                  for k in SPEC_COUNTERS})


def test_draft_tokens_equal_jax():
    rng = np.random.default_rng(0)
    for n in range(60):
        hist = rng.integers(0, 1 + n % 7, size=n % 23).tolist()
        for k in (0, 1, 3, 5):
            for max_n in (1, 3):
                assert draft_tokens(hist, k, max_n) == j_draft_tokens(
                    hist, k, max_n)
    assert draft_tokens([1, 2, 3, 1, 2], 3) == [3, 1, 2]
    assert draft_tokens([7, 9, 9, 9], 4) == [9]
    assert draft_tokens([1, 2, 3, 4], 3) == []


def test_speculate_validation(engines):
    with pytest.raises(ValueError, match="greedily"):
        DecodeEngine(engines.tp, H, EngineConfig(**BASE, speculate=2,
                                                 temperature=0.9))
    with pytest.raises(ValueError, match="speculate"):
        DecodeEngine(engines.tp, H, EngineConfig(**BASE, speculate=-1))
    eng = DecodeEngine(engines.tp, H, EngineConfig(**BASE, speculate=3))
    assert eng.drafted_tokens == eng.accepted_tokens == 0


@pytest.mark.parametrize("speculate", [1, 4])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_spec_equals_jax_engine(engines, prompts, kv_dtype, speculate):
    """Three staggered requests on a pool of 10 usable blocks (the third
    waits for blocks): the same tokens, draft counts, steps, counters and
    request records as JAX's speculative engine, and the tokens of the
    port's plain engine."""
    jeng = engines.jax(kv_dtype, speculate=speculate)
    want = staggered(jeng, prompts)
    eng = engines.port(kv_dtype, speculate=speculate)
    assert staggered(eng, prompts) == want
    assert spec_state(eng) == spec_state(jeng)
    assert records(eng) == records(jeng)
    assert eng.drafted_tokens > 0 and eng.accepted_tokens > 0
    # more than one token a verify dispatch
    assert eng.tokens_generated - 3 > eng.decode_dispatches
    assert staggered(engines.port(kv_dtype), prompts) == want
    drained_invariants(eng)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_spec_exact_fit_and_short_requests(engines, kv_dtype):
    """The draft cap at the end of a reservation: a request that fills
    its 32 positions exactly (its last verify dispatches have dead rows
    whose positions pass the table), a one-token request (no draft) and
    a short one: speculative == plain == JAX's speculative engine."""
    rng = np.random.default_rng(4)
    cases = ((rng.integers(0, V, size=25).tolist(), 8), ([2, 3], 1),
             ([4] * 6, 3), ([5] * 30, 3))
    for prompt, max_new in cases:
        want = engines.port(kv_dtype).generate([prompt], max_new)
        eng = engines.port(kv_dtype, speculate=4)
        got = eng.generate([prompt], max_new)
        assert got == want
        assert len(got[0]) == len(prompt) + max_new
        assert eng.lengths.max() <= eng.cfg.capacity
    jeng = engines.jax(kv_dtype, speculate=4)
    assert jeng.generate([cases[0][0]], 8) == engines.port(
        kv_dtype).generate([cases[0][0]], 8)


def test_spec_poison_rolls_back_and_retries(engines, prompts):
    """``arm_poison`` of a running uid under speculation: its whole verify
    step is rolled back (nothing emitted), it retries once to the clean
    tokens, the others are untouched; JAX's engine does the same. Without
    budget it fails with the tokens it had before the step."""
    def drive(eng):
        for i, p in enumerate(prompts):
            eng.submit(p, MAX_NEW, uid=i)
        while not (eng.slots[1] is not None and len(eng.slots[1].out) > 1):
            eng.step()
        eng.arm_poison(1)
        n_out = len(eng.slots[1].out)
        return eng.run(), n_out

    clean = staggered(engines.port(speculate=4), prompts)
    jeng = engines.jax(speculate=4, policy=dict(max_retries=1))
    want, _ = drive(jeng)
    eng = engines.port(speculate=4, policy=dict(max_retries=1))
    got, _ = drive(eng)
    assert got == want == clean
    assert spec_state(eng) == spec_state(jeng)
    assert eng.quarantined == eng.retried == 1 and not eng.failed
    eng = engines.port(speculate=4)
    got, n_out = drive(eng)
    assert got == {u: clean[u] for u in (0, 2)}
    assert eng.failed == {1: {"reason": "nonfinite_logits", "retries": 0,
                              "n_out": n_out}}
    drained_invariants(eng)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_spec_preemption_replays_as_drafts(engines, prompts, kv_dtype):
    """Two requests decoding when a third arrives needing more blocks
    than are free, under ``preempt_after_steps`` 2: the youngest is
    preempted with tokens out, replays them as drafts (accepted, kept out
    of the draft counters) and every request ends with the unpressured
    tokens. The port under JAX's prefill-chunk rule gives JAX's counters
    and records; the port's draft counters count only the drafter's own
    tokens."""
    policy = dict(preempt_after_steps=2)

    def late(eng):
        eng.submit(prompts[2], MAX_NEW, uid=2)
        eng.submit(prompts[0], MAX_NEW, uid=0)
        for _ in range(5):
            eng.step()
        eng.submit(prompts[1], MAX_NEW, uid=1)
        return eng.run()

    want = late(engines.port(kv_dtype, speculate=4))
    jeng = engines.jax(kv_dtype, speculate=4, policy=policy)
    assert late(jeng) == want
    twin = engines.port(kv_dtype, speculate=4, policy=policy,
                        jax_rule=True)
    assert late(twin) == want
    assert spec_state(twin) == spec_state(jeng)
    assert records(twin) == records(jeng)

    eng = engines.port(kv_dtype, speculate=4, policy=policy)
    log = []
    draft_for = eng._draft_for

    def logged(seq, budget):
        d, n_rec = draft_for(seq, budget)
        log.append((len(d), n_rec))
        return d, n_rec

    eng._draft_for = logged
    assert late(eng) == want
    assert eng.preempted >= 1 and not eng.failed
    assert any(e["event"] == "admitted" and e["replay"] > 1
               for e in eng.request_events)
    replayed = sum(n for _, n in log)
    assert replayed > 0
    assert eng.drafted_tokens == sum(d - n for d, n in log)
    assert eng.accepted_tokens <= eng.drafted_tokens
    drained_invariants(eng)


CLI = ["--device", "cpu", "-d", "32", "-l", "2", "--heads", "4", "--vocab",
       "64", "--max_seq_len", "64", "--block_size", "4", "--prefill_chunk",
       "4", "--prompt_lens", "5,9,13", "--max_new", "8"]


def test_generate_cli_speculate(capsys):
    """``--speculate`` gives the plain run's tokens with JAX's summary
    keys; with sampling it exits 2."""
    import json

    from distributed_llm_code_samples_tpu_torch.decode.generate_cli import (
        generate_main)

    def run(argv):
        rc = generate_main(CLI + argv)
        out, err = capsys.readouterr()
        return rc, (json.loads(out.strip().splitlines()[-1]) if rc == 0
                    else None), err

    rc, plain, _ = run([])
    assert rc == 0 and plain["speculate"] == 0
    assert plain["drafted_tokens"] == 0 and plain["accept_rate"] is None
    rc, spec, err = run(["--speculate", "4"])
    assert rc == 0 and spec["speculate"] == 4
    assert [q["tokens"] for q in spec["sequences"]] == \
        [q["tokens"] for q in plain["sequences"]]
    assert spec["drafted_tokens"] >= spec["accepted_tokens"]
    assert spec["accept_rate"] == round(
        spec["accepted_tokens"] / spec["drafted_tokens"], 4)
    assert "speculation: " in err
    for argv, msg in ((["--speculate", "2", "--temperature", "0.7"],
                       "greedily"), (["--speculate", "-1"], "speculate")):
        rc, _, err = run(argv)
        assert rc == 2 and msg in err
