"""Resume of the port's 2-rank DDP through ``run_with_checkpointing``, on
gloo ranks on the CPU.

``train_ddp`` given the whole 2-rank mesh launches its ranks a segment
(d 16, 2 layers, 32 tokens a rank a step, lr 0.1, 8 seeds in segments of
4, so each rank takes 2 steps a segment; ``seeds_divisor=2``), on JAX's
batches (``BatchTable``) from JAX's init. A run stopped right after the
publish of step 4 and resumed equals the uninterrupted run bit for bit,
every published step records ``data_shards`` 2, and both equal JAX's
``run_with_checkpointing`` over ``train_ddp`` on a 2-device mesh within
rtol 1e-5, atol 1e-6 (``test_torch_train_dist.py``'s tolerance).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu import checkpoint as jck
from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack
from distributed_llm_code_samples_tpu.parallel import make_mesh as j_mesh
from distributed_llm_code_samples_tpu.parallel import train_ddp as j_ddp
from distributed_llm_code_samples_tpu_torch import checkpoint as ck
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, make_mesh, train_ddp)
from torch_serve_refs import one_thread  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("one_thread")

N, D, L, TOKENS, LR = 2, 16, 2, 32, 0.1


def test_ddp_resume_is_exact_and_matches_jax(tmp_path):
    jp = init_ffn_stack(jax.random.PRNGKey(0), D, L)
    seeds = np.asarray(make_seed_schedule(8, random_seed=3))
    table = BatchTable({int(s): tuple(np.array(a) for a in j_batch(
        jnp.int32(s), TOKENS, D)) for s in seeds})
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    kw = dict(every=4, seeds_divisor=N, mesh=mesh, lr=LR, batch_fn=table)
    want = ck.run_with_checkpointing(train_ddp, ffn_params_from_numpy(jp),
                                     seeds, TOKENS, D,
                                     ckpt_dir=str(tmp_path / "ref"), **kw)
    d = str(tmp_path / "run")
    calls = {"n": 0}

    def stopped(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("stopped after the publish of step 4")
        return train_ddp(*a, **k)
    with pytest.raises(RuntimeError, match="stopped"):
        ck.run_with_checkpointing(stopped, ffn_params_from_numpy(jp), seeds,
                                  TOKENS, D, ckpt_dir=d, **kw)
    assert ck.latest_verified_step(d) == 4
    got = ck.run_with_checkpointing(train_ddp, ffn_params_from_numpy(jp),
                                    seeds, TOKENS, D, ckpt_dir=d, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for step in (0, 4, 8):
        with open(os.path.join(d, f"step_{step}", "meta.json")) as f:
            assert json.load(f)["meta"] == {"data_shards": N,
                                            "n_devices": 1}
    jax_out = jck.run_with_checkpointing(
        j_ddp, jp, jnp.asarray(seeds), TOKENS, D,
        ckpt_dir=str(tmp_path / "jax"), every=4, seeds_divisor=N,
        mesh=j_mesh({"data": N}), lr=LR)
    for g, w in zip(got, (jax_out.w1, jax_out.w2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
