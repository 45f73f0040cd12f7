"""The port's decode engine against the JAX engine: the serving slice as
a whole.

Weights come from the JAX ``init_lm`` and cross through
``lm_params_from_numpy``; the same prompts (made from a seed with numpy)
go through both engines with staggered admission. Greedy tokens must be
equal at f32, bf16 and int8, with MHA and with GQA + rope, through the
port's ``kernel="gather"`` and ``kernel="fused"`` paths; sampled tokens
must be equal when the port is handed the JAX engine's Gumbel draws. The
port's engine must also equal the port's own lockstep ``generate``, and
continuous batching must equal decoding each request alone. Everything
runs on the CPU, where the fused path runs the kernel's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.decode import (
    DecodeEngine as JEngine, EngineConfig as JConfig)
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu_torch.decode import (DecodeEngine,
                                                           EngineConfig)
from distributed_llm_code_samples_tpu_torch.models.lm import (
    generate, lm_params_from_numpy)

V, D, L, H = 64, 32, 2, 4
BASE = dict(block_size=8, n_blocks=33, max_slots=3, max_blocks_per_seq=6,
            prefill_chunk=8)
LENS = (5, 9, 13, 20, 3)
MAX_NEW = 8


@pytest.fixture(scope="module")
def models():
    mha = j_init_lm(jax.random.PRNGKey(0), V, D, L, max_seq_len=64)
    gqa = j_init_lm(jax.random.PRNGKey(3), V, D, L, max_seq_len=64,
                    n_heads=H, n_kv_heads=2)
    return {"mha": (mha, lm_params_from_numpy(mha), False),
            "gqa_rope": (gqa, lm_params_from_numpy(gqa), True)}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, V, size=n).tolist() for n in LENS]


def drive(engine, prompts, max_new=MAX_NEW):
    """Submit two, step twice, submit the rest, drain: admission happens
    between steps and the queue outgrows the slots."""
    uids = [engine.submit(p, max_new) for p in prompts[:2]]
    engine.step()
    engine.step()
    uids += [engine.submit(p, max_new) for p in prompts[2:]]
    done = engine.run()
    return [done[u] for u in uids]


def jax_noise(seed):
    """``noise_fn`` with the JAX engine's Gumbel draws (key
    ``fold_in(fold_in(fold_in(PRNGKey(0x5A3D), seed), uid), position)``)."""
    base = jax.random.fold_in(jax.random.PRNGKey(0x5A3D), seed)
    draw = jax.jit(jax.vmap(lambda u, p: jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(base, u), p), (V,),
        jnp.float32)))
    return lambda uids, positions, vocab: np.array(draw(
        jnp.asarray(uids, jnp.int32), jnp.asarray(positions, jnp.int32)))


@pytest.mark.parametrize("model", ["mha", "gqa_rope"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_greedy_tokens_equal_jax_engine(models, prompts, model, kv_dtype):
    jp, tp, use_rope = models[model]
    cfg = dict(BASE, kv_dtype=kv_dtype, use_rope=use_rope)
    want = drive(JEngine(jp, H, JConfig(**cfg, prefix_cache=False)),
                 prompts)
    for kernel in ("gather", "fused"):
        got = drive(DecodeEngine(tp, H, EngineConfig(**cfg, kernel=kernel)),
                    prompts)
        assert got == want, kernel


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_sampled_tokens_equal_jax_engine_under_shared_noise(models, prompts,
                                                            kv_dtype):
    jp, tp, _ = models["mha"]
    cfg = dict(BASE, kv_dtype=kv_dtype, temperature=0.8, top_k=20,
               top_p=0.9, seed=5)
    want = drive(JEngine(jp, H, JConfig(**cfg, prefix_cache=False)),
                 prompts)
    got = drive(DecodeEngine(tp, H, EngineConfig(**cfg),
                             noise_fn=jax_noise(5)), prompts)
    assert got == want


@pytest.mark.parametrize("model", ["mha", "gqa_rope"])
def test_engine_equals_port_generate(models, prompts, model):
    """The paged, batched engine against the contiguous lockstep decode
    (which shares no paged code), one prompt at a time."""
    _, tp, use_rope = models[model]
    got = drive(DecodeEngine(tp, H, EngineConfig(**BASE, use_rope=use_rope)),
                prompts)
    for p, toks in zip(prompts, got):
        want = generate(tp, torch.tensor([p]), MAX_NEW, H,
                        use_rope=use_rope)[0].tolist()
        assert toks == want


def test_continuous_batching_equals_decoding_alone(models, prompts):
    """Sampled with the port's own noise: a request's tokens do not
    depend on the requests around it."""
    _, tp, _ = models["mha"]
    cfg = EngineConfig(**BASE, kv_dtype="int8", temperature=1.0, seed=2)
    batch = drive(DecodeEngine(tp, H, cfg), prompts)
    for i, p in enumerate(prompts):
        alone = DecodeEngine(tp, H, cfg)
        uid = alone.submit(p, MAX_NEW, uid=i)
        assert alone.run()[uid] == batch[i]


def test_nonfinite_row_fails_that_request_only(models, prompts):
    """A request whose logits go non-finite (NaN written into one of its
    cache blocks, as a flipped memory page would) fails with reason
    ``nonfinite_logits`` and no retry; its blocks are scrubbed before
    reuse and every other request's tokens are untouched."""
    _, tp, _ = models["mha"]
    for kernel in ("gather", "fused"):
        cfg = EngineConfig(**BASE, kernel=kernel)
        clean = drive(DecodeEngine(tp, H, cfg), prompts)
        eng = DecodeEngine(tp, H, cfg)
        uids = [eng.submit(p, MAX_NEW) for p in prompts]
        victim = uids[1]
        while not any(s is not None and s.uid == victim and s.out
                      for s in eng.slots):
            eng.step()
        seq = next(s for s in eng.slots if s is not None and s.uid == victim)
        eng.pool.k[:, seq.blocks[0]] = float("nan")
        done = eng.run()
        assert list(eng.failed) == [victim]
        assert eng.failed[victim]["reason"] == "nonfinite_logits"
        assert eng.failed[victim]["retries"] == 0
        for u, want in zip(uids, clean):
            if u != victim:
                assert done[u] == want
        assert not torch.isnan(eng.pool.k).any()
        assert sorted(eng.free_blocks) == list(range(1, BASE["n_blocks"]))


def test_config_surface(models):
    _, tp, _ = models["mha"]
    assert EngineConfig().kernel == "fused"
    assert [f.name for f in dataclasses.fields(EngineConfig)] == [
        f.name for f in dataclasses.fields(JConfig)]
    for name, value in (("speculate", 2), ("prefix_cache", True),
                        ("spill_blocks", 4), ("prefix_partial", True),
                        ("spill_low_water", 1),
                        ("spill_restore_per_step", 3)):
        with pytest.raises(NotImplementedError, match=name):
            DecodeEngine(tp, H, EngineConfig(**BASE, **{name: value}))
    with pytest.raises(ValueError, match="kernel"):
        DecodeEngine(tp, H, EngineConfig(**BASE, kernel="flash"))
    with pytest.raises(ValueError, match="power of two"):
        DecodeEngine(tp, H, EngineConfig(**dict(BASE, prefill_chunk=6)))
    eng = DecodeEngine(tp, H, EngineConfig(**BASE))
    with pytest.raises(ValueError, match="capacity"):
        eng.submit([1] * 40, 10)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit([V], 2)
    uid = eng.submit([1, 2], 2)
    with pytest.raises(ValueError, match="in use"):
        eng.submit([3], 2, uid=uid)
