"""Shared set-up of the serving tests that hold the port's engine against
the JAX engine (``test_torch_prefix.py``, ``test_torch_serve_policy.py``):
a tiny LM made by JAX's ``init_lm`` and crossed over with
``lm_params_from_numpy``, one engine shape for every scenario, JAX's
Gumbel draws for the sampled cases, and matched engine pairs.

One ``Engines`` object per test module keeps one set of the JAX engine's
compiled programs for each (kv_dtype, sampled, speculate) case: the
programs depend on the shapes, the storage type, the sampling settings
and the draft length alone, never on the host-side options
(``prefix_cache``, ``prefix_partial``, the spill tier, the
``ServePolicy``), so every JAX engine of that case reuses them.

The port gives each step's prefill chunk to the oldest resident with an
unfinished prompt; JAX's engine to the lowest slot index, which can
livelock under preemption. Where the two rules schedule a case
differently, ``LowestSlotChunk`` (the port's engine under JAX's rule)
holds the port's machinery against JAX's counters and records, and the
port itself is held to the same tokens and to ``drained_invariants``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.decode import (
    DecodeEngine as JEngine, EngineConfig as JConfig,
    ServePolicy as JPolicy)
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu_torch.decode import (
    DecodeEngine, EngineConfig, ServePolicy)
from distributed_llm_code_samples_tpu_torch.models.lm import (
    lm_params_from_numpy)

V, D, L, H = 256, 64, 2, 4
# block 4, chunk 4; 10 usable blocks: three 5-block sharers of a 3-block
# prefix fit (9 blocks), the same three unshared (15) do not, nor do the
# three plain requests of PLAIN_LENS at MAX_NEW (12)
BASE = dict(block_size=4, n_blocks=11, max_slots=3, max_blocks_per_seq=8,
            prefill_chunk=4)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9, seed=5)
KV_DTYPES = ("f32", "bf16", "int8")
CASES = [(kv, s) for kv in KV_DTYPES for s in (False, True)]
CASE_IDS = [f"{kv}-{'sampled' if s else 'greedy'}" for kv, s in CASES]
PLAIN_LENS = (5, 9, 13)
MAX_NEW = 8


@pytest.fixture(scope="module")
def one_thread():
    """Run a module's tiny torch ops on one thread (restored after it):
    under the suite's parallel workers, every process taking every core
    for ops of a few thousand elements mostly waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models():
    jp = j_init_lm(jax.random.PRNGKey(0), V, D, L, max_seq_len=64)
    return jp, lm_params_from_numpy(jp)


def shared_prompts(n_head=13, tails=(1, 2, 3), seed=7):
    """Prompts behind one shared head: 13 tokens are 3 full blocks and one
    token, and each prompt ends on its own token."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, V, size=n_head).tolist()
    return [head + [t] for t in tails]


def plain_prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=n).tolist() for n in PLAIN_LENS]


def jax_noise(seed):
    """``noise_fn`` with the JAX engine's Gumbel draws (key
    ``fold_in(fold_in(fold_in(PRNGKey(0x5A3D), seed), uid), position)``)."""
    base = jax.random.fold_in(jax.random.PRNGKey(0x5A3D), seed)
    # one row a call: one compiled shape for every batch size
    draw = jax.jit(lambda u, p: jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(base, u), p), (V,),
        jnp.float32))
    return lambda uids, positions, vocab: np.stack([
        np.asarray(draw(jnp.int32(u), jnp.int32(p)))
        for u, p in zip(uids, positions)])


class LowestSlotChunk(DecodeEngine):
    """The port's engine with JAX's prefill-chunk rule: the lowest slot
    index with an unfinished prompt."""

    def _prefill_slot(self):
        return next((i for i, s in enumerate(self.slots)
                     if s is not None and not s.prompt_done), None)


class Engines:
    """Matched JAX and port engines on one model."""

    def __init__(self):
        self.jp, self.tp = models()
        self._programs = {}
        self._noise = {}

    @staticmethod
    def config(kv_dtype, sampled, **kw):
        return dict(BASE, kv_dtype=kv_dtype, **(SAMPLED if sampled else {}),
                    **kw)

    def jax(self, kv_dtype="f32", sampled=False, policy=None, **kw):
        eng = JEngine(self.jp, H, JConfig(**self.config(kv_dtype, sampled,
                                                        **kw)),
                      policy=JPolicy(**(policy or {})))
        eng._programs = self._programs.setdefault(
            (kv_dtype, sampled, kw.get("speculate", 0)), {})
        return eng

    def port(self, kv_dtype="f32", sampled=False, policy=None,
             jax_rule=False, **kw):
        noise = None
        if sampled:
            noise = self._noise.setdefault(SAMPLED["seed"],
                                           jax_noise(SAMPLED["seed"]))
        cls = LowestSlotChunk if jax_rule else DecodeEngine
        return cls(self.tp, H,
                   EngineConfig(**self.config(kv_dtype, sampled, **kw)),
                   policy=ServePolicy(**(policy or {})), noise_fn=noise)


def staggered(eng, prompts, max_new=6, steps_between=3, uid0=0):
    """Submit each prompt ``steps_between`` engine steps after the one
    before (enough for an earlier sharer's full blocks to be cached, so
    later admissions hit; 0 admits them together, which exercises the
    late dedup), then drain."""
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, uid=uid0 + i)
        for _ in range(steps_between):
            eng.step()
    return eng.run()


def counters(eng):
    """The prefix cache's and the scheduler's counters both engines
    keep."""
    return {k: getattr(eng, k) for k in (
        "prefill_dispatches", "prefix_hit_blocks", "prefix_lookup_blocks",
        "prefill_tokens_saved", "partial_hits", "cow_copies",
        "block_allocs", "block_frees", "block_scrubs", "quarantined",
        "retried", "preempted", "rejected", "expired", "steps")}


def drained_invariants(eng):
    """What a drained port engine holds whatever its schedule: every uid
    completed or failed exactly once; a preempted or retried uid was
    admitted again replaying the tokens it had; every block is free or
    cached at refs 0, with no corrupted block left; allocations equal
    frees; the live tokens are the finished requests' new tokens and the
    failed ones' kept tokens."""
    ev = list(eng.request_events)
    done = [e["uid"] for e in ev if e["event"] == "completed"]
    assert sorted(done) == sorted(eng.finished)
    assert not set(done) & set(eng.failed)
    assert [e["step"] for e in ev] == sorted(e["step"] for e in ev)
    for i, e in enumerate(ev):
        if e["event"] in ("preempted", "retried"):
            back = next(a for a in ev[i + 1:] if a["uid"] == e["uid"]
                        and a["event"] in ("admitted", "expired"))
            if back["event"] == "admitted" and e["event"] == "preempted":
                assert back["replay"] == e["n_out"]
    cached = ([] if eng.prefix is None else
              [n.block for n in eng.prefix.nodes() if not n.spilled])
    assert eng.prefix is None or all(n.refs == 0
                                     for n in eng.prefix.nodes())
    assert sorted(eng.free_blocks + cached) == list(
        range(1, eng.cfg.n_blocks))
    assert not eng._corrupted and not eng.active and not eng.waiting
    assert eng.block_allocs == eng.block_frees
    assert eng.tokens_generated == sum(
        len(t) - eng.prompt_lens[u] for u, t in eng.finished.items()) + sum(
        info["n_out"] for info in eng.failed.values())
