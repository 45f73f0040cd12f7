"""The engine's preemption livelock and its repair.

With ``preempt_after_steps`` set, a tight pool and prompts several chunks
long, giving each step's one prefill chunk to the lowest slot index (the
JAX engine's rule) lets a refilled slot below the oldest resident take
every chunk, while the head's streak evicts it again before it finishes:
the engine preempts and re-admits forever. The port gives the chunk to
the oldest resident with an unfinished prompt instead.

- The reproduction (vocab 64, d 32, 2 layers, 4 heads; block 8, 9 blocks,
  4 slots, 5 blocks a sequence, chunk 2; six requests of prompt lengths
  29, 13, 12, 13, 19, 10 and ``max_new`` 7, 6, 9, 6, 5, 3 arriving at
  steps 7, 2, 10, 5, 11, 6) ends within 400 steps at
  ``preempt_after_steps`` 1, 2 and 3 and every ``kv_dtype``, with the
  tokens the same requests get on an unpressured pool; the port's engine
  under the lowest-slot rule does not end (at f32: the schedule does not
  depend on the storage type).
- JAX's engine still does not end in 400 steps (this test fails once
  JAX's side is repaired).
"""

import jax
import numpy as np
import pytest

from distributed_llm_code_samples_tpu.decode import (
    DecodeEngine as JEngine, EngineConfig as JConfig,
    ServePolicy as JPolicy)
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu_torch.decode import (DecodeEngine,
                                                           EngineConfig,
                                                           ServePolicy)
from distributed_llm_code_samples_tpu_torch.models.lm import (
    lm_params_from_numpy)
from torch_serve_refs import (LowestSlotChunk, drained_invariants,
                              one_thread)  # noqa: F401 (a fixture)

V, D, L, H = 64, 32, 2, 4
CFG = dict(block_size=8, n_blocks=9, max_slots=4, max_blocks_per_seq=5,
           prefill_chunk=2, prefix_cache=False)
FREE = dict(CFG, n_blocks=1 + 4 * 5)
LENS = (29, 13, 12, 13, 19, 10)
MAX_NEW = (7, 6, 9, 6, 5, 3)
ARRIVE = (7, 2, 10, 5, 11, 6)
LIMIT = 400


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def models():
    jp = j_init_lm(jax.random.PRNGKey(0), V, D, L, max_seq_len=64)
    return jp, lm_params_from_numpy(jp)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, V, size=n).tolist() for n in LENS]


def drive(eng, prompts, limit=LIMIT):
    """Submit by ``ARRIVE`` and step until drained or ``limit`` steps;
    returns the steps taken."""
    step = 0
    while step < limit and (step <= max(ARRIVE) or eng.waiting
                            or eng.active):
        for i, at in enumerate(ARRIVE):
            if at == step:
                eng.submit(prompts[i], MAX_NEW[i], uid=i)
        eng.step()
        step += 1
    return step


@pytest.fixture(scope="module")
def unpressured(models, prompts):
    """The reproduction's tokens on a pool that fits every request, by
    ``kv_dtype``."""
    _, tp = models
    out = {}
    for kv_dtype in ("f32", "bf16", "int8"):
        free = DecodeEngine(tp, H, EngineConfig(**FREE, kv_dtype=kv_dtype))
        drive(free, prompts)
        assert sorted(free.finished) == list(range(len(LENS)))
        out[kv_dtype] = free.finished
    return out


@pytest.mark.parametrize("preempt_after", [1, 2, 3])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_oldest_first_chunk_ends_with_unpressured_tokens(
        models, prompts, unpressured, kv_dtype, preempt_after):
    _, tp = models
    policy = ServePolicy(preempt_after_steps=preempt_after)
    eng = DecodeEngine(tp, H, EngineConfig(**CFG, kv_dtype=kv_dtype),
                       policy=policy)
    assert drive(eng, prompts) < LIMIT
    assert eng.finished == unpressured[kv_dtype]
    assert eng.preempted >= 1 and not eng.failed
    drained_invariants(eng)


@pytest.mark.parametrize("preempt_after", [1, 2, 3])
def test_lowest_slot_chunk_livelocks(models, prompts, preempt_after):
    """The same engine under the lowest-slot rule does not end in 400
    steps (the schedule does not depend on ``kv_dtype``)."""
    _, tp = models
    twin = LowestSlotChunk(tp, H, EngineConfig(**CFG), policy=ServePolicy(
        preempt_after_steps=preempt_after))
    drive(twin, prompts)
    assert twin.waiting or twin.active
    assert twin.preempted > LIMIT // (2 * preempt_after)


def test_jax_engine_still_livelocks(models, prompts):
    """JAX's engine on the reproduction at ``preempt_after_steps`` 1: after
    400 steps it has not finished, preempting nearly every step. Fails
    once JAX's engine gets the repair."""
    jp, _ = models
    eng = JEngine(jp, H, JConfig(**CFG), policy=JPolicy(
        preempt_after_steps=1))
    drive(eng, prompts)
    assert eng.waiting or eng.active
    assert len(eng.finished) < len(LENS)
    assert eng.preempted > LIMIT // 2
