"""The skip-step guardrail in the port's trainers (``train_single``,
``train_ddp``, ``train_fsdp``, ``train_lm_tp``, ``train_lm_ddp``) and
the CLI's ``--guardrails`` and ``--loss_scale``, against the JAX
package's on the CPU.

The FFN trainers take JAX's ``init_ffn_stack(PRNGKey(0), 16, 2)`` params
and JAX's batches (``BatchTable``, poisoned seeds too: a NaN or Inf
upstream gradient), 32 tokens a rank a step, lr 0.1, as JAX's
``test_guardrails.py``. Every guarded run's counters and loss scale
equal JAX's exactly. Params: ``train_single`` and the f32 DDP and FSDP
runs (gloo's sums, four ranks in one spawn, JAX's on the conftest
``mesh4``) within rtol 1e-5, atol 1e-6, as ``test_torch_train_dist.py``
holds the unguarded ones (the Adam run within ``test_torch_optim.py``'s
``ADAM_TOL``, ``_close_adam``); the bf16 DDP run (its ring sums in JAX's ring
order) within 2 bf16 steps of the weights in at most 2% of them. The
port also equals itself without the skipped step bit for bit: a skip
leaves params and optimizer state as they were, on every rank.

The LM guard (JAX's ``train_lm_tp`` is red, ROADMAP Queue 3) is held to
its invariants on two loopback CPU threads: a clean guarded run is the
unguarded run bit for bit with nothing skipped; a run whose params hold
one inf skips every step and returns the params unchanged.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack, init_lm
from distributed_llm_code_samples_tpu.optim import adam as j_adam
from distributed_llm_code_samples_tpu.optim import momentum as j_momentum
from distributed_llm_code_samples_tpu.parallel import train_ddp as j_ddp
from distributed_llm_code_samples_tpu.parallel import train_fsdp as j_fsdp
from distributed_llm_code_samples_tpu.parallel import train_single as j_single
from distributed_llm_code_samples_tpu.runtime import guardrails as jg
from distributed_llm_code_samples_tpu_torch import cli
from distributed_llm_code_samples_tpu_torch.data import (
    POISON_INF_BIT, POISON_NAN_BIT, BatchTable)
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy, lm_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.optim import (adam, adamw, leaves,
                                                      momentum)
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, Mesh, launch, make_mesh, train_ddp, train_fsdp,
    train_lm_ddp, train_lm_tp, train_single, unshard_params)
from distributed_llm_code_samples_tpu_torch.parallel.fsdp import (
    unshard_state)
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)
from distributed_llm_code_samples_tpu_torch.runtime.guardrails import (
    GuardrailConfig, summarize)

from torch_serve_refs import one_thread  # noqa: F401

D, L, TOKENS, LR, N = 16, 2, 32, 0.1, 4
TOL = dict(rtol=1e-5, atol=1e-6)
BF = jnp.bfloat16


def _close_adam(got, want):
    """Adam divides by the root of the second moment, so a gradient
    element that cancels to ~1e-9 in one framework's summation order and
    ~1e-10 in the other's moves by a different fraction of the LR (the
    ``ADAM_TOL`` of ``test_torch_optim.py``): within rtol 1e-5, atol 1e-5
    on all but 0.5% of the elements and within the LR on every one."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(g - w) > 1e-5 + 1e-5 * np.abs(w)
    assert off.mean() <= 5e-3 and np.abs(g - w).max() <= LR


def _poison(seeds, idx, bit=POISON_NAN_BIT):
    s = np.array(seeds)
    s[idx] |= bit
    return s


@pytest.fixture(scope="module")
def setup():
    seeds = np.asarray(make_seed_schedule(3 * N, 3))
    every = set(int(s) for s in seeds)
    every |= {int(s) | bit for s in seeds
              for bit in (POISON_NAN_BIT, POISON_INF_BIT)}
    table = BatchTable({s: tuple(np.asarray(a) for a in
                                 j_batch(jnp.int32(s), TOKENS, D))
                        for s in every})
    params = init_ffn_stack(jax.random.PRNGKey(0), D, L)
    params_bf = init_ffn_stack(jax.random.PRNGKey(0), D, L, dtype=BF)
    return params, params_bf, seeds, table


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a).astype(jnp.float32)))


def _steps(got, want):
    """``(most bf16 steps apart, share of weights that differ)``, a step
    at the larger magnitude of the two or the weights' RMS."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    rms = np.sqrt(np.mean(w ** 2))
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), rms))
    return (float((np.abs(g - w) / np.ldexp(1.0, e - 8)).max()),
            float((g != w).mean()))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# -- train_single ------------------------------------------------------------

SINGLE = [("clean", None, None), ("nan", 2, POISON_NAN_BIT),
          ("inf", 5, POISON_INF_BIT)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,idx,bit", SINGLE, ids=[c[0] for c in SINGLE])
def test_single_guard_matches_jax(one_thread, setup, case, idx, bit, dtype):
    params, params_bf, seeds, table = setup
    start_j = params_bf if dtype == "bf16" else params
    bad = seeds if idx is None else _poison(seeds, idx, bit)
    want, gj = j_single(start_j, jnp.asarray(bad), TOKENS, D, lr=LR,
                        guard=jg.GuardrailConfig(), return_guard=True)
    start = ffn_params_from_numpy(start_j)
    got, gp = train_single(start, bad, TOKENS, D, lr=LR,
                           guard=GuardrailConfig(), return_guard=True,
                           batch_fn=table)
    assert summarize(gp) == jg.summarize(gj)
    assert summarize(gp)["skipped"] == (0 if idx is None else 1)
    for g, w in zip(got, want):
        if dtype == "bf16":
            most, share = _steps(g, w)
            assert g.dtype == torch.bfloat16 and most <= 2 and share <= 0.02
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the port's own exactness: the skip is the run without that seed, and
    # a clean guarded run is the unguarded run, bit for bit
    oracle = train_single(start, seeds if idx is None
                          else np.delete(seeds, idx), TOKENS, D, lr=LR,
                          batch_fn=table)
    assert _equal(got, oracle)


def test_single_guard_threads_its_state_across_calls(one_thread, setup):
    """Chunked calls carry the counters: two poisoned chunks count both
    skips, and the params equal the whole run's bit for bit."""
    params, _, seeds, table = setup
    bad = _poison(_poison(seeds, 1), 6)
    start = ffn_params_from_numpy(params)
    cfg = GuardrailConfig()
    out1, g1 = train_single(start, bad[:4], TOKENS, D, lr=LR, guard=cfg,
                            return_guard=True, batch_fn=table)
    out2, g2 = train_single(out1, bad[4:], TOKENS, D, lr=LR, guard=cfg,
                            guard_state=g1, return_guard=True,
                            batch_fn=table)
    whole, gw = train_single(start, bad, TOKENS, D, lr=LR, guard=cfg,
                             return_guard=True, batch_fn=table)
    assert summarize(g1)["skipped"] == 1
    assert summarize(g2) == summarize(gw) and summarize(gw)["skipped"] == 2
    assert _equal(out2, whole)


def test_single_guard_refusals(setup):
    params, _, seeds, _ = setup
    start = ffn_params_from_numpy(params)
    with pytest.raises(ValueError, match="loss-scale hook"):
        train_single(start, seeds, TOKENS, D,
                     guard=GuardrailConfig(loss_scale=128.0))
    with pytest.raises(ValueError, match="guard config"):
        train_single(start, seeds, TOKENS, D, return_guard=True)


# -- DDP and FSDP on four gloo ranks -----------------------------------------

def _runs(seeds):
    """``{label: (port trainer, seeds, kwargs, JAX trainer or None, JAX
    kwargs)}``. The ``-oracle`` runs are the port's own without the
    skipped steps."""
    cfg = GuardrailConfig()
    grow = dict(loss_scale=1024.0, growth_interval=1)
    over = dict(loss_scale=1024.0, scale_backoff=0.5)
    inf2 = _poison(_poison(seeds, 1, POISON_INF_BIT), 9, POISON_INF_BIT)
    return {
        "ddp-nan": (train_ddp, _poison(seeds, 5), dict(guard=cfg), j_ddp,
                    dict(guard=jg.GuardrailConfig())),
        "ddp-nan-oracle": (train_ddp, np.delete(seeds, slice(4, 8)), {},
                           None, None),
        "fsdp-adam-nan": (train_fsdp, _poison(seeds, 2), dict(
            guard=cfg, optimizer=adam(), return_state=True), j_fsdp,
            dict(guard=jg.GuardrailConfig(), optimizer=j_adam(),
                 return_state=True)),
        "fsdp-adam-nan-oracle": (train_fsdp, np.delete(seeds, slice(0, 4)),
                                 dict(optimizer=adam(), return_state=True),
                                 None, None),
        "ddp-mixed-grow": (train_ddp, seeds, dict(
            mixed=True, guard=GuardrailConfig(**grow)), j_ddp, dict(
            mixed=True, guard=jg.GuardrailConfig(**grow))),
        "ddp-mixed-overflow": (train_ddp, inf2, dict(
            mixed=True, guard=GuardrailConfig(**over)), j_ddp, dict(
            mixed=True, guard=jg.GuardrailConfig(**over))),
        "ddp-mixed-overflow-oracle": (train_ddp, seeds[4:8], dict(
            mixed=True), None, None),
        "fsdp-mixed-overflow": (train_fsdp, inf2, dict(
            mixed=True, guard=GuardrailConfig(**over)), j_fsdp, dict(
            mixed=True, guard=jg.GuardrailConfig(**over))),
        "ddp-clip": (train_ddp, seeds, dict(guard=GuardrailConfig(
            clip_norm=0.05)), j_ddp, dict(guard=jg.GuardrailConfig(
                clip_norm=0.05))),
        "fsdp-clip": (train_fsdp, seeds, dict(guard=GuardrailConfig(
            clip_norm=0.05)), j_fsdp, dict(guard=jg.GuardrailConfig(
                clip_norm=0.05))),
    }


@pytest.fixture(scope="module")
def dp_runs(setup):
    params, params_bf, seeds, table = setup
    runs = _runs(seeds)
    start, start_bf = (ffn_params_from_numpy(params),
                       ffn_params_from_numpy(params_bf))
    calls = [(fn, (start, s, TOKENS, D, MESH),
              dict(kw, lr=LR, batch_fn=table, return_guard="guard" in kw))
             for fn, s, kw, _, _ in runs.values()]
    calls.append((train_ddp, (start_bf, _poison(seeds, 6), TOKENS, D, MESH),
                  dict(lr=LR, batch_fn=table, optimizer=momentum(),
                       comm="pallas_ring", guard=GuardrailConfig(),
                       return_guard=True)))
    outs = launch(call_each, make_mesh({DATA_AXIS: N}, device="cpu"), calls,
                  timeout=300)
    got = {}
    for i, (label, (fn, *_)) in enumerate(list(runs.items())
                                          + [("ddp-bf16-nan", (train_ddp,))]):
        per_rank = [o[i] for o in outs]
        got[label] = per_rank
    return got


def _result(fn, per_rank, state=False):
    """The full result of a run from its ranks' returns: ``(params,
    state or None, guard or None)``."""
    first = per_rank[0]
    guard = None
    if isinstance(first, tuple) and len(first) == 2 and hasattr(
            first[1], "skipped"):
        guard = first[1]
        per_rank = [o[0] for o in per_rank]
    if fn is train_fsdp:
        if state:
            return (unshard_params([o[0] for o in per_rank]),
                    unshard_state([o[1] for o in per_rank]), guard)
        return unshard_params(per_rank), None, guard
    out = per_rank[0]
    return (out[0], out[1], guard) if state else (out, None, guard)


@pytest.mark.parametrize("label", ["ddp-nan", "fsdp-adam-nan",
                                   "ddp-mixed-grow", "ddp-mixed-overflow",
                                   "fsdp-mixed-overflow", "ddp-clip",
                                   "fsdp-clip"])
def test_dp_guard_matches_jax(mesh4, setup, dp_runs, label):
    params, _, seeds, _ = setup
    fn, s, kw, j_fn, j_kw = _runs(seeds)[label]
    state = kw.get("return_state", False)
    got, got_state, gp = _result(fn, dp_runs[label], state)
    want = j_fn(params, jnp.asarray(s), TOKENS, D, mesh4, lr=LR,
                return_guard=True, **j_kw)
    want, gj = want
    if state:
        want, want_state = want
        np.testing.assert_allclose(got_state.mu.w1.numpy(),
                                   np.asarray(want_state.mu.w1), **TOL)
        assert int(got_state.count) == int(want_state.count)
    assert summarize(gp) == jg.summarize(gj)
    for g, w in zip(got, want):
        if "adam" in label:
            _close_adam(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_dp_guard_counts(dp_runs):
    """The counters of each run: one skip for one poisoned step, the
    scale doubled at each clean step with growth every step, halved at
    each of two overflows (1024 -> 256), nothing skipped by clipping."""
    want = {"ddp-nan": (1, 0, 1.0), "fsdp-adam-nan": (1, 0, 1.0),
            "ddp-mixed-grow": (0, 0, 8192.0),
            "ddp-mixed-overflow": (2, 2, 256.0),
            "fsdp-mixed-overflow": (2, 2, 256.0),
            "ddp-clip": (0, 0, 1.0), "fsdp-clip": (0, 0, 1.0),
            "ddp-bf16-nan": (1, 0, 1.0)}
    for label, (skipped, overflows, scale) in want.items():
        g = summarize(dp_runs[label][0][1])
        assert (g["skipped"], g["overflows"], g["loss_scale"]) == (
            skipped, overflows, scale), label


def test_dp_skip_is_the_run_without_that_step(dp_runs):
    """Bit for bit on every rank: the skipped step left params and Adam's
    state as they were (its count did not advance); after two overflows
    the one surviving step equals the clean step at the halved scale
    (power-of-two scales are exact)."""
    g, _, _ = _result(train_ddp, dp_runs["ddp-nan"])
    o, _, _ = _result(train_ddp, dp_runs["ddp-nan-oracle"])
    assert _equal(g, o)
    g, gs, _ = _result(train_fsdp, dp_runs["fsdp-adam-nan"], state=True)
    o, os_, _ = _result(train_fsdp, dp_runs["fsdp-adam-nan-oracle"],
                        state=True)
    assert _equal(g, o) and _equal(gs.mu, os_.mu) and _equal(gs.nu, os_.nu)
    assert int(gs.count) == int(os_.count) == 2
    g, _, _ = _result(train_ddp, dp_runs["ddp-mixed-overflow"])
    o, _, _ = _result(train_ddp, dp_runs["ddp-mixed-overflow-oracle"])
    assert _equal(g, o)


def test_dp_guard_on_bf16_matches_jax(mesh4, setup, dp_runs):
    """bf16 params under momentum, the ring transport: JAX's Pallas rings
    in interpret mode add the same bf16 gradients in the same order."""
    _, params_bf, seeds, _ = setup
    got, _, gp = _result(train_ddp, dp_runs["ddp-bf16-nan"])
    want, gj = j_ddp(params_bf, jnp.asarray(_poison(seeds, 6)), TOKENS, D,
                     mesh4, lr=LR, optimizer=j_momentum(),
                     comm="pallas_ring", guard=jg.GuardrailConfig(),
                     return_guard=True)
    assert summarize(gp) == jg.summarize(gj)
    for g, w in zip(got, want):
        most, share = _steps(g, w)
        assert g.dtype == torch.bfloat16 and most <= 2 and share <= 0.02


def test_dp_guard_refusals(setup):
    params, _, seeds, _ = setup
    start = ffn_params_from_numpy(params)
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    scale = GuardrailConfig(loss_scale=128.0)
    for train in (train_ddp, train_fsdp):
        with pytest.raises(ValueError, match="mixed"):
            train(start, seeds, TOKENS, D, mesh, guard=scale)
        with pytest.raises(ValueError, match="guard config"):
            train(start, seeds, TOKENS, D, mesh, guard_state=(0, 0, 1.0, 0))
        with pytest.raises(NotImplementedError, match="not ported"):
            train(start, seeds, TOKENS, D, mesh, guard=GuardrailConfig(),
                  seed_accum=2)


# -- the LM: train_lm_tp and train_lm_ddp on loopback CPU threads -------------

V, SEQ, H = 64, 8, 4


@pytest.fixture(scope="module")
def lm_setup():
    params = lm_params_from_numpy(init_lm(jax.random.PRNGKey(1), V, D, 1,
                                          max_seq_len=SEQ, n_heads=H))
    return params, np.asarray(make_seed_schedule(4, 3))


def _lm_run(train, axis, params, seeds, **kw):
    def body(me, _):
        return train(params, seeds, 2 * SEQ, D, me, 0.05, seq_len=SEQ,
                     n_heads=H, **kw)
    return launch(body, Mesh({axis: 2}, "cpu", loopback=True), timeout=120)


@pytest.mark.parametrize("opt", [None, "adamw"])
@pytest.mark.parametrize("trainer", ["tp", "ddp"])
def test_lm_guard_invariants(one_thread, lm_setup, trainer, opt):
    params, seeds = lm_setup
    train, axis = ((train_lm_tp, MODEL_AXIS) if trainer == "tp"
                   else (train_lm_ddp, DATA_AXIS))
    kw = {} if opt is None else dict(optimizer=adamw(), return_state=True)
    cfg = GuardrailConfig()
    ref = _lm_run(train, axis, params, seeds, **kw)
    clean = _lm_run(train, axis, params, seeds, guard=cfg,
                    return_guard=True, **kw)
    for r, (c, g) in zip(ref, clean):
        assert summarize(g)["skipped"] == 0
        r, c = (r[0], c[0]) if opt else (r, c)
        assert _equal(leaves(r), leaves(c))
    # one inf in a block weight: every step skipped, the params unchanged
    bad = params.with_leaves([t.clone() for t in leaves(params)])
    bad.blocks.w1[0, 0, 0] = float("inf")
    poisoned = _lm_run(train, axis, bad, seeds, guard=cfg,
                       return_guard=True, **kw)
    steps = len(seeds) // (2 if trainer == "ddp" else 1)
    for out, g in poisoned:
        assert summarize(g)["skipped"] == steps
        out = out[0] if opt else out
        if trainer == "ddp":
            assert _equal(leaves(out), leaves(bad))
    if trainer == "tp":
        from distributed_llm_code_samples_tpu_torch.parallel.lm import (
            lm_tp_unshard)
        full = lm_tp_unshard([o[0][0] if opt else o[0] for o in poisoned])
        assert _equal(leaves(full), leaves(bad))


def test_lm_guard_refusals(lm_setup):
    params, seeds = lm_setup
    kw = dict(seq_len=SEQ, n_heads=H)
    scale = GuardrailConfig(loss_scale=128.0)
    with pytest.raises(ValueError, match="loss-scale hook"):
        train_lm_tp(params, seeds, 2 * SEQ, D,
                    make_mesh({MODEL_AXIS: 2}, device="cpu"), guard=scale,
                    **kw)
    with pytest.raises(ValueError, match="loss-scale hook"):
        train_lm_ddp(params, seeds, 2 * SEQ, D,
                     make_mesh({DATA_AXIS: 2}, device="cpu"), guard=scale,
                     **kw)


# -- the CLI ------------------------------------------------------------------

SMALL = ["--device", "cpu", "-s", "4", "-bs", "2", "-n", "8", "-l", "2",
         "-d", "16", "-r", "7", "--lr", "0.1"]
REFUSALS = [
    (["-m", "4", "--guardrails"],
     "--guardrails applies to --method 1, 2, 3, or 11"),
    (["-m", "7", "--guardrails"],
     "--guardrails applies to --method 1, 2, 3, or 11"),
    (["-m", "2", "--guardrails", "--zero1"],
     "--guardrails does not support --zero1"),
    (["-m", "2", "--loss_scale", "-1"], "--loss_scale must be >= 0"),
    (["-m", "2", "--mixed", "--loss_scale", "8"],
     "--loss_scale applies with --guardrails --mixed on --method 2 or 3"),
    (["-m", "2", "--guardrails", "--loss_scale", "8"],
     "--loss_scale applies with --guardrails --mixed on --method 2 or 3"),
    (["-m", "1", "--guardrails", "--mixed", "--loss_scale", "8"],
     "--loss_scale applies with --guardrails --mixed on --method 2 or 3"),
    (["-m", "11", "--guardrails", "--loss_scale", "8"],
     "--loss_scale applies with --guardrails --mixed on --method 2 or 3"),
    (["-m", "1", "--mixed", "--dtype", "bfloat16"], "ROADMAP.md Queue 3"),
    (["-m", "0", "--mixed", "--dtype", "bfloat16"], "ROADMAP.md Queue 3"),
]


@pytest.mark.parametrize("flags,message", REFUSALS,
                         ids=[" ".join(f) for f, _ in REFUSALS])
def test_cli_guard_refusals(capsys, flags, message):
    """The JAX CLI's exit-2 rules and messages (its ``cli.py:325-350``);
    ``--mixed --dtype bfloat16`` on method 1 (and so 0) is the port's,
    where JAX's step crashes."""
    assert cli.main(SMALL + flags) == 2
    out = capsys.readouterr()
    assert out.out == "" and message in out.err


def _payload(capsys):
    return json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.mark.parametrize("method,extra", [
    ("1", []), ("2", ["--fake_devices", "2", "--mixed"]),
    ("3", ["--fake_devices", "2"]),
    ("11", ["--fake_devices", "2", "--heads", "4", "--vocab", "64"])])
def test_cli_guardrails_drive(capsys, method, extra):
    """``--guardrails`` on a clean run: the payload's ``guard`` (nothing
    skipped; under ``--mixed`` methods 2 and 3 scale from 2^15) and the
    checksums of the unguarded run, bit for bit."""
    argv = SMALL + ["-m", method] + extra
    assert cli.main(argv) == 0
    plain = _payload(capsys)
    assert cli.main(argv + ["--guardrails"]) == 0
    run = _payload(capsys)
    assert plain["guard"] is None
    assert run["guard"]["skipped"] == 0 and run["guard"]["overflows"] == 0
    assert run["guard"]["loss_scale"] == (2.0 ** 15 if "--mixed" in extra
                                          else 1.0)
    assert run["layer_checksums"] == plain["layer_checksums"]


def test_cli_mixed_on_lm_and_transformer_changes_nothing(capsys):
    """``--mixed`` on ``-m 8`` and ``-m 11`` with bf16 params trains as
    without it, as in the JAX CLI (which passes ``mixed`` to methods 1-5
    only): the same checksums bit for bit, ``mixed`` false in the
    payload."""
    for method in ("8", "11"):
        argv = SMALL + ["-m", method, "--fake_devices", "2", "--heads", "4",
                        "--vocab", "64", "--dtype", "bfloat16"]
        if method == "8":
            argv = [a for a in argv if a not in ("--vocab", "64")]
        assert cli.main(argv) == 0
        plain = _payload(capsys)
        assert cli.main(argv + ["--mixed"]) == 0
        run = _payload(capsys)
        assert run["mixed"] is False and run["dtype"] == "bfloat16"
        assert run["layer_checksums"] == plain["layer_checksums"]
