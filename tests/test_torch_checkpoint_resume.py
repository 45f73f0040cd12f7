"""Resume through the port's ``run_with_checkpointing``, on the CPU.

``train_single`` (d 16, 2 layers, 32 tokens a step, lr 0.1, 8 seeds in
segments of 2) on JAX's batches (``BatchTable``) and ``train_lm_single``
with AdamW threaded (vocab 64, d 16, 2 layers, 2 heads, 8-token
sequences, 2 a step, lr 1e-2, 6 seeds in segments of 2) on JAX's batches
(``TokenTable``), both from JAX's init: a run stopped right after a
publish and resumed by the same call equals the uninterrupted run bit for
bit (params, and the AdamW state of the newest step), and both equal
JAX's ``run_with_checkpointing`` on the same batches within the
tolerance of the trainer's own differential test (``train_single``:
rtol 1e-5, atol 1e-6, ``test_torch_train_single.py``; the LM under
AdamW: rtol 2e-4, atol 1e-4, 1% of one step's LR, as
``test_torch_train_lm_dp.py`` and ``test_torch_train_lm_tp.py`` hold it:
Adam divides each gradient by its own running scale, so an f32-level
difference of a gradient near zero moves its update by a few percent).
A checkpoint JAX's run published resumes in the port, and the port's in
JAX. Also: the saved schedule is authoritative, a longer one extends
it, a stateful run without thread state refuses to resume, the every /
divisor and publish-fault checks, and elastic scale-down names the item
it waits for.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu import checkpoint as jck
from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import (
    lm_batch_from_seed as j_lm_batch)
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu.optim import adamw as j_adamw
from distributed_llm_code_samples_tpu.parallel import (
    train_lm_single as j_train_lm)
from distributed_llm_code_samples_tpu.parallel import train_single as j_train
from distributed_llm_code_samples_tpu_torch import checkpoint as ck
from distributed_llm_code_samples_tpu_torch.data import BatchTable, TokenTable
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy, lm_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.optim import adamw, leaves
from distributed_llm_code_samples_tpu_torch.parallel import (
    train_ddp, train_lm_single, train_single)
from distributed_llm_code_samples_tpu_torch.runtime.chaos import FaultPlan
from torch_serve_refs import one_thread  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("one_thread")

D, L, TOKENS, LR = 16, 2, 32, 0.1
V, LD, LL, H, SEQ, LM_TOKENS, LM_LR = 64, 16, 2, 2, 8, 16, 1e-2


def _batches(seeds):
    return BatchTable({int(s): tuple(np.array(a) for a in j_batch(
        jnp.int32(s), TOKENS, D)) for s in seeds})


def _lm_batches(seeds):
    return TokenTable({int(s): tuple(np.array(a) for a in j_lm_batch(
        jnp.int32(s), LM_TOKENS // SEQ, SEQ, V)) for s in seeds})


class Crash(RuntimeError):
    pass


def _crash_after(fn, calls: int):
    """``fn`` that raises on its call ``calls + 1``: the run dies right
    after the publish of its ``calls``-th segment."""
    n = {"calls": 0}

    def train(*a, **kw):
        n["calls"] += 1
        if n["calls"] > calls:
            raise Crash("stopped after a publish")
        return fn(*a, **kw)
    return train


def _assert_bits(got, want):
    for g, w in zip(leaves(got), leaves(want)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def ffn():
    jp = init_ffn_stack(jax.random.PRNGKey(0), D, L)
    seeds = np.asarray(make_seed_schedule(8, random_seed=3))
    return jp, seeds, _batches(seeds)


def test_single_resume_is_exact_and_matches_jax(tmp_path, ffn):
    jp, seeds, table = ffn
    kw = dict(every=2, lr=LR, batch_fn=table)
    want = ck.run_with_checkpointing(
        train_single, ffn_params_from_numpy(jp), seeds, TOKENS, D,
        ckpt_dir=str(tmp_path / "ref"), **kw)
    d = str(tmp_path / "run")
    with pytest.raises(Crash):
        ck.run_with_checkpointing(_crash_after(train_single, 2),
                                  ffn_params_from_numpy(jp), seeds, TOKENS,
                                  D, ckpt_dir=d, **kw)
    assert ck.latest_verified_step(d) == 4
    got = ck.run_with_checkpointing(train_single, ffn_params_from_numpy(jp),
                                    seeds, TOKENS, D, ckpt_dir=d, **kw)
    _assert_bits(got, want)
    jax_out = jck.run_with_checkpointing(
        j_train, jp, jnp.asarray(seeds), TOKENS, D,
        ckpt_dir=str(tmp_path / "jax"), every=2, lr=LR)
    for g, w in zip(leaves(got), (jax_out.w1, jax_out.w2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # JAX resumes from the port's step_4 and the port from JAX's: the same
    # final params as each package's own uninterrupted run
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port4")
    for step in (6, 8):
        os.rename(os.path.join(jdir, f"step_{step}"),
                  os.path.join(jdir, f"gone_{step}"))
    ck.run_with_checkpointing(train_single, ffn_params_from_numpy(jp),
                              seeds[:4], TOKENS, D, ckpt_dir=pdir, **kw)
    from_jax = ck.run_with_checkpointing(
        train_single, ffn_params_from_numpy(jp), seeds, TOKENS, D,
        ckpt_dir=jdir, **kw)
    from_port = jck.run_with_checkpointing(
        j_train, jp, jnp.asarray(seeds), TOKENS, D, ckpt_dir=pdir, every=2,
        lr=LR)
    for g, w in zip(leaves(from_jax), (from_port.w1, from_port.w2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_lm_adamw_resume_is_exact_and_matches_jax(tmp_path):
    jp = j_init_lm(jax.random.PRNGKey(0), V, LD, LL, SEQ, n_heads=H)
    seeds = np.asarray(make_seed_schedule(6, random_seed=5))
    kw = dict(every=2, lr=LM_LR, seq_len=SEQ, n_heads=H,
              batch_fn=_lm_batches(seeds), optimizer=adamw(),
              thread_state=True)
    want = ck.run_with_checkpointing(
        train_lm_single, lm_params_from_numpy(jp), seeds, LM_TOKENS, LD,
        ckpt_dir=str(tmp_path / "ref"), **kw)
    d = str(tmp_path / "run")
    with pytest.raises(Crash):
        ck.run_with_checkpointing(_crash_after(train_lm_single, 1),
                                  lm_params_from_numpy(jp), seeds,
                                  LM_TOKENS, LD, ckpt_dir=d, **kw)
    assert ck.latest_verified_step(d) == 2
    got = ck.run_with_checkpointing(train_lm_single, lm_params_from_numpy(jp),
                                    seeds, LM_TOKENS, LD, ckpt_dir=d, **kw)
    _assert_bits(got, want)
    start = lm_params_from_numpy(jp)
    target = (start, adamw().init(start))
    (p1, s1), _, _ = ck.restore_checkpoint(d, target)
    (p2, s2), _, _ = ck.restore_checkpoint(str(tmp_path / "ref"), target)
    _assert_bits(p1, p2)
    for a, b in zip(ck._named(s1), ck._named(s2)):
        assert torch.equal(a[1], b[1]), a[0]
    assert int(s1.count) == 6
    jax_out = jck.run_with_checkpointing(
        j_train_lm, jp, jnp.asarray(seeds), LM_TOKENS, LD,
        ckpt_dir=str(tmp_path / "jax"), every=2, lr=LM_LR, seq_len=SEQ,
        n_heads=H, optimizer=j_adamw(), thread_state=True)
    for (name, g), w in zip(got.named_leaves(),
                            jax.tree_util.tree_leaves(jax_out)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-4, err_msg=name)
    # JAX's (params, AdamW state) of step 6 restores in the port within the
    # same tolerance of the port's own
    (jp6, js6), step, _ = ck.restore_checkpoint(str(tmp_path / "jax"),
                                                target)
    assert step == 6 and int(js6.count) == 6
    for (n, a), (_, b) in zip(ck._named((jp6, js6)), ck._named((p1, s1))):
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=2e-4, atol=1e-4, err_msg=n)


def test_saved_schedule_is_authoritative_and_extends(tmp_path, ffn):
    """A resume trains the saved schedule, whatever the caller passes; a
    longer schedule keeps the saved prefix and adds its own tail."""
    jp, seeds, table = ffn
    kw = dict(every=2, lr=LR, batch_fn=table)
    d = str(tmp_path / "a")
    ck.run_with_checkpointing(train_single, ffn_params_from_numpy(jp),
                              seeds[:4], TOKENS, D, ckpt_dir=d, **kw)
    other = np.array(seeds[::-1][:4])
    same = ck.run_with_checkpointing(train_single, ffn_params_from_numpy(jp),
                                     other, TOKENS, D, ckpt_dir=d, **kw)
    longer = np.concatenate([other, seeds[4:]])
    ext = ck.run_with_checkpointing(train_single, ffn_params_from_numpy(jp),
                                    longer, TOKENS, D, ckpt_dir=d, **kw)
    want4 = train_single(ffn_params_from_numpy(jp), seeds[:4], TOKENS, D,
                         lr=LR, batch_fn=table)
    want8 = train_single(ffn_params_from_numpy(jp), seeds, TOKENS, D, lr=LR,
                         batch_fn=table)
    _assert_bits(same, want4)
    _assert_bits(ext, want8)
    _, _, saved = ck.restore_checkpoint(d, ffn_params_from_numpy(jp))
    assert saved.tolist() == seeds.tolist()


def test_refusals_match_jax(tmp_path, ffn):
    jp, seeds, table = ffn
    p = ffn_params_from_numpy(jp)
    with pytest.raises(ValueError, match="multiple of the data-shard"):
        ck.run_with_checkpointing(train_single, p, seeds, TOKENS, D,
                                  ckpt_dir=str(tmp_path / "a"), every=3,
                                  seeds_divisor=2)
    with pytest.raises(ValueError, match="do not divide across"):
        ck.run_with_checkpointing(train_single, p, seeds[:7], TOKENS, D,
                                  ckpt_dir=str(tmp_path / "b"),
                                  seeds_divisor=2)
    for spec in ("kill@3", "corrupt_ckpt@9"):
        with pytest.raises(ValueError, match="can never fire") as perr:
            ck.run_with_checkpointing(train_single, p, seeds, TOKENS, D,
                                      ckpt_dir=str(tmp_path / "c"), every=2,
                                      chaos=FaultPlan.parse(spec))
        from distributed_llm_code_samples_tpu.runtime.chaos import (
            FaultPlan as JPlan)
        with pytest.raises(ValueError) as jerr:
            jck.run_with_checkpointing(j_train, jp, jnp.asarray(seeds),
                                       TOKENS, D, every=2,
                                       ckpt_dir=str(tmp_path / "j"),
                                       chaos=JPlan.parse(spec))
        assert str(perr.value) == str(jerr.value)
    # a stateful rule the trainer keeps to itself cannot resume past 0
    d = str(tmp_path / "s")
    fake = {"calls": 0}

    def stateful_train(params, s, *a, optimizer=None, **kw):
        fake["calls"] += 1
        return params
    ck.run_with_checkpointing(stateful_train, p, seeds[:2], TOKENS, D,
                              ckpt_dir=d, optimizer=adamw())
    with pytest.raises(ValueError, match="cannot resume a stateful"):
        ck.run_with_checkpointing(stateful_train, p, seeds, TOKENS, D,
                                  ckpt_dir=d, optimizer=adamw())


def test_elastic_resume(tmp_path, ffn):
    """A step saved under 2 data shards: resuming on 4 continues on the
    new global batch (scale-up, an ``elastic_resume`` event); on 1, the
    trainer would need ``seed_accum=2`` (ROADMAP.md Queue 1 item 3.4):
    ``train_single`` has no such surface (JAX's ``ValueError``), and
    ``train_ddp`` refuses it as not ported yet."""
    jp, seeds, table = ffn
    p = ffn_params_from_numpy(jp)
    d = str(tmp_path / "e")
    ck.save_checkpoint(d, p, 4, seeds, meta={"data_shards": 2})
    events = []
    ck.run_with_checkpointing(lambda q, s, *a, **kw: q, p, seeds, TOKENS, D,
                              ckpt_dir=d, every=4, seeds_divisor=4,
                              on_event=events.append)
    assert events[0] == {"event": "elastic_resume", "step": 4,
                         "saved_shards": 2, "current_shards": 4,
                         "seed_accum": 1, "n_devices": 1}
    assert ck.read_meta(d, 8)["data_shards"] == 4
    d2 = str(tmp_path / "f")
    ck.save_checkpoint(d2, p, 4, seeds, meta={"data_shards": 2})
    with pytest.raises(ValueError, match="no seed_accum surface"):
        ck.run_with_checkpointing(train_single, p, seeds, TOKENS, D,
                                  ckpt_dir=d2, every=2)
    with pytest.raises(NotImplementedError, match="seed_accum=2"):
        ck.run_with_checkpointing(train_ddp, p, seeds, TOKENS, D,
                                  ckpt_dir=d2, every=2, mesh=None)
