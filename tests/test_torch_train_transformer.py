"""The port's transformer trainers (``train_transformer_single``,
``train_transformer_tp`` plain and sequence-parallel) and ``cli.py -m
8`` against the JAX package on the CPU.

d 32, 2 layers, 4 heads, 64-token sequences, 2 a step (128 tokens), 3
seeds of ``make_seed_schedule(3, 7)``, lr 0.1. Both sides start from the
JAX ``init_transformer`` parameters (``transformer_params_from_numpy``)
and the port trains on the JAX batches (a ``BatchTable``). The port's TP
ranks are 4 gloo processes, every run in one launch (``call_each``). JAX's
own TP trainer fails on this JAX version (ROADMAP Queue 3), so TP is held
against JAX's single-device trainer, as the JAX CLI's method-9 check
holds it, and against the port's.

Tolerances: rtol 2e-4, atol 1e-6 for trained params
(``test_torch_train_lm.py``'s; TP splits the heads' and features' sums
over the ranks, the flash plain version sums in tiles); each leaf's
first-step gradient within rtol 1e-4, atol 1e-7 of JAX's ``jax.vjp``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import (
    init_transformer as j_init)
from distributed_llm_code_samples_tpu.models.transformer import (
    transformer_fwd as j_fwd)
from distributed_llm_code_samples_tpu.parallel import (
    train_transformer_single as j_single)
from distributed_llm_code_samples_tpu_torch import cli
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    TransformerParams, transformer_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import (
    MODEL_AXIS, Mesh, launch, make_mesh, train_transformer_single,
    train_transformer_tp)
from distributed_llm_code_samples_tpu_torch.parallel import transformer
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)

D, L, H, SEQ, LR, N = 32, 2, 4, 64, 0.1, 4
TOKENS = 2 * SEQ
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=1e-6)
ATTNS = (None, "flash", "rope")
RUNS = [(sp, a) for sp in (False, True) for a in ATTNS]
RUN_IDS = [f"{'sp' if sp else 'tp'}-{a or 'oracle'}" for sp, a in RUNS]


@pytest.fixture(scope="module")
def setup():
    params = j_init(jax.random.PRNGKey(0), D, L)
    seeds = np.asarray(make_seed_schedule(3, 7))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), TOKENS, D))
                        for s in seeds})
    return params, seeds, table, transformer_params_from_numpy(params)


def _leaves(p):
    if isinstance(p, TransformerParams):
        return [t for _, t in p.named_leaves()]
    return list(p)


def _close(got, want, **tol):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


def _j_single(setup, attn):
    params, seeds = setup[:2]
    return j_single(params, jnp.asarray(seeds), TOKENS, D, lr=LR,
                    seq_len=SEQ, n_heads=H, attn_impl=attn)


@pytest.fixture(scope="module")
def tp_runs(setup):
    """Every (plain or sequence-parallel, attention) run on 4 gloo ranks,
    in one launch, unsharded."""
    _, seeds, table, start = setup
    calls = [(train_transformer_tp, (start, seeds, TOKENS, D, MESH),
              dict(lr=LR, seq_len=SEQ, n_heads=H, attn_impl=a,
                   sequence_parallel=sp, batch_fn=table)) for sp, a in RUNS]
    outs = launch(call_each, make_mesh({MODEL_AXIS: N}, device="cpu"),
                  calls, timeout=240)
    return [transformer.tp_unshard([o[i] for o in outs])
            for i in range(len(calls))]


@pytest.mark.parametrize("attn", ATTNS, ids=["oracle", "flash", "rope"])
def test_single_matches_jax(setup, attn):
    """``train_transformer_single`` against JAX's, 3 steps (rtol 2e-4,
    atol 1e-6); the caller's params are kept."""
    _, seeds, table, start = setup
    before = [t.clone() for t in _leaves(start)]
    got = train_transformer_single(start, seeds, TOKENS, D, lr=LR,
                                   seq_len=SEQ, n_heads=H, attn_impl=attn,
                                   batch_fn=table)
    _close(got, _j_single(setup, attn))
    for a, b in zip(_leaves(start), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sp,attn", RUNS, ids=RUN_IDS)
def test_tp_matches_single(setup, tp_runs, sp, attn):
    """TP and TP-SP on 4 ranks against JAX's and the port's single-device
    trainer (rtol 2e-4, atol 1e-6), having moved every leaf."""
    _, seeds, table, start = setup
    got = tp_runs[RUNS.index((sp, attn))]
    _close(got, _j_single(setup, attn))
    _close(got, train_transformer_single(start, seeds, TOKENS, D, lr=LR,
                                         seq_len=SEQ, n_heads=H,
                                         attn_impl=attn, batch_fn=table))
    for g, b in zip(_leaves(got), _leaves(start)):
        assert float((g - b).abs().max()) > 1e-5


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_first_step_grads_match_single_leaf_by_leaf(setup, sp):
    """Each leaf's gradient of one step on 4 loopback thread ranks (the
    threads a card's loopback runs) against JAX's ``jax.vjp`` at the
    batch's ``dloss_dx`` (rtol 1e-4, atol 1e-7): a leaf reduced once too
    often or too seldom (in SP the LN gains take one all-reduce) is off by
    a factor of 4."""
    params, seeds, table, start = setup
    x, dy = (t.reshape(TOKENS // SEQ, SEQ, D) for t in table(seeds[0],
                                                                 TOKENS, D))
    outs = launch(torch_tp_ranks.transformer_tp_first_grads,
                  Mesh({MODEL_AXIS: N}, "cpu", loopback=True),
                  (start, x, dy, H, "flash", sp), timeout=60)
    got = transformer.tp_unshard([TransformerParams(*g) for g in outs])
    _, vjp = jax.vjp(lambda p: j_fwd(p, jnp.asarray(x.numpy()), H, True),
                     params)
    _close(got, vjp(jnp.asarray(dy.numpy()))[0], rtol=1e-4, atol=1e-7)


def test_loopback_threads_equal_gloo_ranks(setup, tp_runs):
    """TP-SP with flash on 4 loopback CPU threads, within its timeout,
    equals the gloo ranks' run (rtol 1e-6, atol 1e-8)."""
    _, seeds, table, start = setup
    got = train_transformer_tp(start, seeds, TOKENS, D,
                               Mesh({MODEL_AXIS: N}, "cpu", loopback=True),
                               lr=LR, seq_len=SEQ, n_heads=H,
                               attn_impl="flash", sequence_parallel=True,
                               batch_fn=table, timeout=60)
    _close(got, tp_runs[RUNS.index((True, "flash"))], rtol=1e-6, atol=1e-8)


def test_refusals_before_anything_is_spawned(setup):
    _, seeds, _, start = setup
    kw = dict(seq_len=SEQ, n_heads=H)
    with pytest.raises(ValueError, match="n_heads=4 not divisible"):
        train_transformer_tp(start, seeds, TOKENS, D,
                             make_mesh({MODEL_AXIS: 3}, device="cpu"), **kw)
    with pytest.raises(ValueError, match="seq_len=62 not divisible"):
        train_transformer_tp(start, seeds, 124, D,
                             make_mesh({MODEL_AXIS: N}, device="cpu"),
                             seq_len=62, n_heads=H, sequence_parallel=True)
    with pytest.raises(ValueError, match="attn_impl"):
        train_transformer_tp(start, seeds, TOKENS, D,
                             make_mesh({MODEL_AXIS: N}, device="cpu"),
                             attn_impl="nope", **kw)
    with pytest.raises(ValueError, match="tokens 100 not divisible"):
        train_transformer_single(start, seeds, 100, D, **kw)
    with pytest.raises(ValueError, match="tokens 100 not divisible"):
        train_transformer_single(start, seeds, 100, D, mixed=True, **kw)


CLI = [sys.executable, "-m", "distributed_llm_code_samples_tpu_torch.cli",
       "--device", "cpu", "-s", "3", "-bs", "2", "-n", "16", "-l", "2", "-d",
       "32", "-r", "7", "--lr", "0.1", "-m", "8"]


@pytest.mark.parametrize("flags,tp", [
    (["--fake_devices", "4", "--tp", "4", "--tp_sp", "--attn", "flash"], 4),
    (["--fake_devices", "4", "--attn", "rope"], 2)],
    ids=["sp-flash-tp4", "rope-tp2"])
def test_cli_method_8_trains_as_single(flags, tp):
    """``-m 8`` on gloo ranks: the payload, and the final layers'
    checksums against the port's ``train_transformer_single`` from the
    CLI's own init and batches (relative 1e-5)."""
    out = subprocess.run(CLI + flags, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert " train_transformer_tp takes " in out.stdout.replace(
        "\n", " ")
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["mesh"] == {"model": tp} and payload["ranks"] == tp
    assert payload["sequence_parallel"] == ("--tp_sp" in flags)
    assert payload["kernel_launches_per_rank"] == [{}] * tp
    assert payload["tokens_per_s"] == pytest.approx(
        32 / (payload["median_step_ms"] / 1e3))
    args = cli.build_parser().parse_args(CLI[3:] + flags)
    gen = torch.Generator()
    gen.manual_seed(7)
    params = cli._init(args, gen)
    assert f"PARAMS: {params.num_params():_}" in out.stdout
    want = train_transformer_single(params, make_seed_schedule(3, 7), 32, 32,
                                    lr=0.1, seq_len=16, n_heads=4,
                                    attn_impl=args.attn)
    np.testing.assert_allclose(payload["layer_checksums"],
                               cli._checksums(want), rtol=1e-5, atol=1e-6)
