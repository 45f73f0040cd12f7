"""The port's fault injection (``runtime/chaos.py``) and failure supervisor
(``runtime/failure.py``) against the JAX package's, on the CPU.

- Every spec of JAX's ``test_fault_plan_parse_*`` parses to the same
  faults, or is refused with JAX's message, in both packages.
- Five fault scenarios of JAX's ``test_chaos.py`` on the FFN
  ``train_single`` (d 16, 2 layers, 32 tokens a step, lr 0.1, 8 seeds in
  segments of 2; the port from JAX's init on JAX's batches): a NaN
  gradient rolled back, an Inf gradient skipped, a loss spike rolled
  back, a persistent spike that spends the rollback budget and then the
  restarts, and a torn step 4 behind a crash. The sequence of ``(event,
  rung, step)`` records in the port's ``supervise.jsonl`` equals JAX's;
  the final params equal the port's uninterrupted run bit for bit (for
  the skip, the run without the skipped segment).
- ``backoff_delay`` equals JAX's over a grid; the native watchdog latches
  on a hang and stays clean without one; ``device_healthcheck``.
- Every refusal of the checkpoint and chaos flags exits 2 with JAX's
  message, and ``--checkpoint_backend orbax`` exits 2 naming ROADMAP.md.
"""

import json
import os
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu import cli as j_cli
from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack
from distributed_llm_code_samples_tpu.parallel import train_single as j_train
from distributed_llm_code_samples_tpu.runtime import chaos as j_chaos
from distributed_llm_code_samples_tpu.runtime import failure as j_failure
from distributed_llm_code_samples_tpu_torch import checkpoint as ck
from distributed_llm_code_samples_tpu_torch import cli
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import train_single
from distributed_llm_code_samples_tpu_torch.runtime import chaos, failure
from distributed_llm_code_samples_tpu_torch.runtime.native import Watchdog
from torch_serve_refs import one_thread  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("one_thread")

D, L, TOKENS, LR = 16, 2, 32, 0.1

# JAX's test_fault_plan_parse_grammar, _selfheal_kinds and _rejects
SPECS = ["nan_grad@3,hang@5:0.5,corrupt_ckpt@4:0.25,kill@7,seed=11",
         "loss_spike@5:100,slow_step@3:0.5,slow_step@7",
         "bogus@1", "nan_grad@0", "nan_grad", "seed=3", "nan_grad@x",
         "loss_spike@0:100", "loss_spike", "slow_step@x",
         "loss_spike@2:abc", "corrupt_block@3:2,kill_worker@2:1"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_matches_jax(spec):
    def parse(mod):
        try:
            plan = mod.FaultPlan.parse(spec)
        except ValueError as e:
            return "refused", str(e)
        return [(f.kind, f.step, f.arg) for f in plan.faults], plan.seed
    assert parse(chaos) == parse(j_chaos)
    assert chaos.KINDS == j_chaos.KINDS
    assert (chaos.IN_SEGMENT_KINDS, chaos.PUBLISH_KINDS) == (
        j_chaos.IN_SEGMENT_KINDS, j_chaos.PUBLISH_KINDS)


@pytest.fixture(scope="module")
def setup():
    jp = init_ffn_stack(jax.random.PRNGKey(0), D, L)
    seeds = np.asarray(make_seed_schedule(8, random_seed=3))
    table = BatchTable({int(s): tuple(np.array(a) for a in j_batch(
        jnp.int32(s), TOKENS, D)) for s in seeds})
    return jp, seeds, table


def _story(ckpt_dir):
    """``(event, rung, step)`` of each record of ``supervise.jsonl``; the
    step is the record's ``step``, a rollback's ``resume_step``, or its
    ``steps`` span."""
    with open(os.path.join(ckpt_dir, "supervise.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    return [(r["event"], r.get("rung"),
             r.get("step", r.get("resume_step", tuple(r.get("steps", ())))))
            for r in recs]


def _spiky(train, target):
    """``train`` whose segment starting at seed ``target`` scales its
    update 1000 times, on every retry (a persistent spike)."""
    def fn(p, s, *a, **kw):
        out = train(p, s, *a, **kw)
        if int(np.asarray(s)[0]) != target:
            return out
        if isinstance(out, tuple) and isinstance(out[0], torch.Tensor):
            return type(out)(*(o + 1000.0 * (n - o) for o, n in zip(p, out)))
        leaves, tree = jax.tree_util.tree_flatten(out)
        return jax.tree_util.tree_unflatten(tree, [
            o + 1000.0 * (n - o)
            for o, n in zip(jax.tree_util.tree_leaves(p), leaves)])
    return fn


def _crashing(train):
    """``train`` that raises on its third call (after step 4 published)."""
    calls = {"n": 0}

    def fn(p, s, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected crash")
        return train(p, s, *a, **kw)
    return fn


SCENARIOS = {
    "nan_grad-rollback": dict(spec="nan_grad@3", nonfinite="raise",
                              max_restarts=2),
    "inf_grad-skip": dict(spec="inf_grad@3"),
    "loss_spike-rollback": dict(spec="loss_spike@5:100", spike_factor=4.0,
                                max_restarts=0),
    "rollback-exhaustion": dict(spiky=True, spike_factor=4.0,
                                max_restarts=1, max_rollbacks=2),
    "corrupt_ckpt-fallback": dict(spec="corrupt_ckpt@4", crash=True,
                                  max_restarts=2),
}


def _supervise(mod, train, params, seeds, ckpt_dir, case):
    kw = {k: v for k, v in case.items()
          if k not in ("spec", "spiky", "crash")}
    if "spec" in case:
        kw["chaos"] = (chaos if mod is failure else j_chaos).FaultPlan.parse(
            case["spec"])
    if case.get("spiky"):
        seeds = seeds[:4]
        train = _spiky(train, int(seeds[2]))
    if case.get("crash"):
        train = _crashing(train)
    try:
        return mod.supervise(train, params, seeds, TOKENS, D,
                             ckpt_dir=ckpt_dir, every=2, backoff_base_s=0.0,
                             **kw)
    except RuntimeError as e:
        return e


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_supervisor_story_matches_jax(tmp_path, setup, name):
    jp, seeds, table = setup
    case = SCENARIOS[name]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jout = _supervise(j_failure, lambda p, s, *a, **kw: j_train(
        p, jnp.asarray(s), *a, lr=LR, **kw), jp, seeds, jdir, case)
    pout = _supervise(failure, lambda p, s, *a, **kw: train_single(
        p, s, *a, lr=LR, batch_fn=table, **kw), ffn_params_from_numpy(jp),
        seeds, pdir, case)
    story = _story(pdir)
    assert story == _story(jdir)
    events = [e for e, _, _ in story]
    if name == "rollback-exhaustion":
        assert isinstance(pout, RuntimeError) and isinstance(
            jout, RuntimeError)
        assert str(pout).split("LossSpikeError")[0] == str(jout).split(
            "LossSpikeError")[0]
        assert events.count("rollback") == 2
        assert events.count("attempt_failed") == 2
        return
    kept = seeds
    if name == "inf_grad-skip":
        kept = np.delete(seeds, [2, 3])
        assert sorted(os.listdir(pdir)) == ["step_0", "step_2", "step_6",
                                            "step_8", "supervise.jsonl"]
    want = ck.run_with_checkpointing(
        train_single, ffn_params_from_numpy(jp), kept, TOKENS, D,
        ckpt_dir=str(tmp_path / "ref"), every=2, lr=LR, batch_fn=table)
    for g, w in zip(pout, want):
        assert torch.equal(g, w)
    for g, w in zip(pout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert events[-1] == "completed"


def test_backoff_delay_matches_jax():
    for seed in (0, 3):
        rp, rj = random.Random(seed), random.Random(seed)
        for attempt in range(7):
            for base, cap, jitter in ((0.5, 30.0, 0.5), (1.0, 2.0, 0.0),
                                      (0.25, 4.0, 0.9)):
                assert failure.backoff_delay(attempt, base, cap, jitter,
                                             rp) == j_failure.backoff_delay(
                    attempt, base, cap, jitter, rj)


def test_watchdog_latches_on_a_hang_and_stays_clean_without(tmp_path, setup):
    jp, seeds, table = setup
    with Watchdog(100) as dog:
        time.sleep(0.3)
        assert dog.expired
        dog.kick()
        assert not dog.expired
    plan = chaos.FaultPlan.parse("hang@3:0.8")
    kw = dict(every=2, lr=LR, batch_fn=table, backoff_base_s=0.0)
    failure.supervise(train_single, ffn_params_from_numpy(jp), seeds, TOKENS,
                      D, ckpt_dir=str(tmp_path / "hang"), chaos=plan,
                      watchdog_ms=300, **kw)
    assert plan.events[0]["kind"] == "hang"
    log = _story(str(tmp_path / "hang"))
    assert log[-1][0] == "completed"
    with open(os.path.join(tmp_path, "hang", "supervise.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert recs[-1]["watchdog_expired"] is True
    assert any(r.get("watchdog_expired") for r in recs[:-1]
               if r["event"] == "published")
    failure.supervise(train_single, ffn_params_from_numpy(jp), seeds[:4],
                      TOKENS, D, ckpt_dir=str(tmp_path / "clean"),
                      watchdog_ms=60_000, **kw)
    with open(os.path.join(tmp_path, "clean", "supervise.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert recs[-1]["event"] == "completed"
    assert recs[-1]["watchdog_expired"] is False


def test_device_healthcheck():
    assert failure.device_healthcheck() == [torch.device("cpu")]
    with pytest.raises(failure.HealthCheckError, match="liveness probe"):
        failure.device_healthcheck([torch.device("meta")])
    assert failure.device_healthcheck(
        [torch.device("meta"), torch.device("cpu")],
        allow_degraded=True) == [torch.device("cpu")]


REFUSALS = [
    ["--chaos", "kill@4"],
    ["-m", "0", "--chaos", "kill@4", "--checkpoint_dir", "{d}"],
    ["--chaos", "bogus@1", "--checkpoint_dir", "{d}"],
    ["--chaos", "nan_logits@3", "--checkpoint_dir", "{d}"],
    ["--spike_factor", "-1"],
    ["--spike_factor", "2"],
    ["--spike_factor", "2", "--checkpoint_dir", "{d}"],
    ["--max_rollbacks", "-1"],
    ["-m", "2", "--zero1", "--optimizer", "adam", "--checkpoint_dir", "{d}",
     "--checkpoint_every", "2"],
]


@pytest.mark.parametrize("argv", REFUSALS,
                         ids=[" ".join(a) for a in REFUSALS])
def test_cli_refusals_match_jax(tmp_path, capsys, argv):
    argv = [a.format(d=tmp_path) for a in argv]
    if "-m" not in argv:
        argv = ["-m", "1"] + argv
    assert j_cli.main(list(argv)) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert cli.main(list(argv)) == 2
    assert capsys.readouterr().err.strip() == want


def test_cli_refuses_orbax(tmp_path, capsys):
    assert cli.main(["-m", "1", "--device", "cpu", "--checkpoint_dir",
                     str(tmp_path), "--checkpoint_backend", "orbax"]) == 2
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
