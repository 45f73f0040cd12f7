"""Shared set-up of the serving tests that hold the port's engine against
the JAX engine (``test_torch_prefix.py``, ``test_torch_serve_policy.py``):
a tiny LM made by JAX's ``init_lm`` and crossed over with
``lm_params_from_numpy``, one engine shape for every scenario, JAX's
Gumbel draws for the sampled cases, and matched engine pairs.

One ``Engines`` object per test module keeps one set of the JAX engine's
compiled programs for each (kv_dtype, sampled) pair: the programs depend
on the shapes, the storage type and the sampling settings alone, never on
the host-side options (``prefix_cache``, ``prefix_partial``, the
``ServePolicy``), so every JAX engine of that pair reuses them.
"""

import jax
import jax.numpy as jnp
import numpy as np

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
        eng._programs = self._programs.setdefault((kv_dtype, sampled), {})
        return eng

    def port(self, kv_dtype="f32", sampled=False, policy=None, **kw):
        noise = None
        if sampled:
            noise = self._noise.setdefault(SAMPLED["seed"],
                                           jax_noise(SAMPLED["seed"]))
        return DecodeEngine(self.tp, H,
                            EngineConfig(**self.config(kv_dtype, sampled,
                                                       **kw)),
                            policy=ServePolicy(**(policy or {})),
                            noise_fn=noise)


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
