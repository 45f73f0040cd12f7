"""The port's tensor parallelism (``train_tp``, ``train_tp_sp``) and its
DDP x TP hybrid (``train_hybrid``) against the JAX package's on the
conftest meshes, their degenerate cases within the port, the 2-D mesh's
rank order, and the CLI's methods 0, 4 and 5.

d 32, 2 layers, 32 tokens a step, 16 global seeds of
``make_seed_schedule(16, 7)``, lr 0.1. Both sides start from the JAX
``init_ffn_stack`` parameters (``ffn_params_from_numpy``) and the port
trains on the JAX batches, handed to the spawned gloo ranks in a
``BatchTable``. Each launch runs every call it can (``call_each``).
Tolerance: rtol 1e-5, atol 1e-6, as ``test_torch_train_dist.py`` (the
frameworks' CPU matmuls sum in other orders, and TP splits the ffn sum
over the ranks).

The degenerate cases (model 1 == DDP, data 1 == TP) run on loopback
meshes of CPU threads, whose collectives are the plain torch ones a
loopback mesh runs on the card.
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

from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack
from distributed_llm_code_samples_tpu.parallel import make_mesh as j_mesh
from distributed_llm_code_samples_tpu.parallel import train_hybrid as j_hybrid
from distributed_llm_code_samples_tpu.parallel import train_tp as j_tp
from distributed_llm_code_samples_tpu.parallel import train_tp_sp as j_tp_sp
from distributed_llm_code_samples_tpu_torch import cli
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
    FFNStackParams)
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, launch, make_mesh,
    train_ddp, train_hybrid, train_single, train_tp, train_tp_sp,
    unshard_tp_params)
from distributed_llm_code_samples_tpu_torch.parallel import hybrid, tp
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)

D, L, TOKENS, LR, N = 32, 2, 32, 0.1, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    params = init_ffn_stack(jax.random.PRNGKey(0), D, L)
    seeds = np.asarray(make_seed_schedule(16, 7))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), TOKENS, D))
                        for s in seeds})
    return params, seeds, table, ffn_params_from_numpy(params)


def _launch(setup, axes, *trainers):
    """One launch of ``trainers`` on the gloo mesh ``axes``; returns, for
    each, every rank's result in rank order."""
    _, seeds, table, start = setup
    calls = [(t, (start, seeds, TOKENS, D, MESH),
              dict(lr=LR, batch_fn=table)) for t in trainers]
    outs = launch(call_each, make_mesh(axes, device="cpu"), calls,
                  timeout=240)
    return [[o[i] for o in outs] for i in range(len(trainers))]


@pytest.fixture(scope="module")
def tp_runs(setup):
    """``train_tp`` and ``train_tp_sp`` on 4 gloo ranks, unsharded."""
    return [unshard_tp_params(r) for r in
            _launch(setup, {MODEL_AXIS: N}, train_tp, train_tp_sp)]


@pytest.fixture(scope="module")
def single(setup):
    _, seeds, table, start = setup
    return train_single(start, seeds, TOKENS, D, lr=LR, batch_fn=table)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


def _moved(got, start):
    # the run moved the weights by 100x the tolerance
    assert float((got.w1 - start.w1).abs().max()) > 1e-4


@pytest.mark.parametrize("which", ["tp", "tp_sp"])
def test_tp_matches_jax(mesh_model4, setup, tp_runs, which):
    params, seeds, _, start = setup
    j_train = {"tp": j_tp, "tp_sp": j_tp_sp}[which]
    got = tp_runs[["tp", "tp_sp"].index(which)]
    _close(got, j_train(params, jnp.asarray(seeds), TOKENS, D, mesh_model4,
                        lr=LR))
    _moved(got, start)


def test_tp_equals_single_and_sp_equals_tp(tp_runs, single):
    plain, sp = tp_runs
    _close(plain, single)
    _close(sp, plain)


@pytest.mark.parametrize("axes,fixture", [
    ({DATA_AXIS: 2, MODEL_AXIS: 2}, None), ({DATA_AXIS: 4, MODEL_AXIS: 2},
                                            "mesh4x2")])
def test_hybrid_matches_jax(request, setup, axes, fixture):
    params, seeds, _, start = setup
    jm = request.getfixturevalue(fixture) if fixture else j_mesh(axes)
    got = hybrid.unshard_params(_launch(setup, axes, train_hybrid)[0],
                                make_mesh(axes, device="cpu"))
    _close(got, j_hybrid(params, jnp.asarray(seeds), TOKENS, D, jm, lr=LR))
    _moved(got, start)


def _loopback(axes):
    """A loopback mesh of CPU threads (``make_mesh`` keeps loopback to the
    card; the plain collectives it runs there need no card)."""
    return Mesh(dict(axes), "cpu", loopback=True)


def test_hybrid_degenerates_to_ddp_and_tp(setup, tp_runs):
    """Model 1 is DDP, data 1 is TP, and hybrid(4 x 2) is DDP(4): TP is an
    exact decomposition, so only the data axis changes the math."""
    _, seeds, table, start = setup
    kw = dict(lr=LR, batch_fn=table)
    ddp = train_ddp(start, seeds, TOKENS, D,
                    make_mesh({DATA_AXIS: N}, device="cpu"), **kw)
    _close(train_hybrid(start, seeds, TOKENS, D,
                        _loopback({DATA_AXIS: N, MODEL_AXIS: 1}), **kw), ddp)
    _close(train_hybrid(start, seeds, TOKENS, D,
                        _loopback({DATA_AXIS: 1, MODEL_AXIS: N}), **kw),
           tp_runs[0])
    _close(train_hybrid(start, seeds, TOKENS, D,
                        _loopback({DATA_AXIS: N, MODEL_AXIS: 2}), **kw), ddp)
    # TP on loopback threads: the same collectives as gloo's, summed in
    # rank order within each group
    for fn, want in zip((train_tp, train_tp_sp), tp_runs):
        _close(fn(start, seeds, TOKENS, D, _loopback({MODEL_AXIS: N}),
                  **kw), want)


def test_tp_sp_saves_token_shards(setup):
    """Sequence-parallel TP saves the block inputs as token shards,
    ``[L, T/n, d]`` (JAX ``test_tp_sp_comms_and_sharded_activations``)."""
    _, seeds, table, start = setup

    def body(me, _):
        saved = []
        step = tp.make_sp_step(TOKENS, D, N, LR, mesh=me, batch_fn=table,
                               saved=saved)
        step(tp.shard_params(start, me), seeds[0])
        return tuple(saved[0].shape)

    assert launch(body, _loopback({MODEL_AXIS: N}), timeout=60) == \
        [(L, TOKENS // N, D)] * N


@pytest.mark.parametrize("axes", [{MODEL_AXIS: 4}, {DATA_AXIS: 2,
                                                    MODEL_AXIS: 2},
                                  {DATA_AXIS: 4, MODEL_AXIS: 2},
                                  {DATA_AXIS: 2, SEQ_AXIS: 4}])
def test_rank_coordinates_are_jax_device_positions(axes):
    """Rank r sits where device r sits in the JAX mesh's device array, and
    each axis group is a line of that array."""
    jm = j_mesh(axes)
    pm = make_mesh(axes, device="cpu")
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    for r in range(pm.size):
        pos = tuple(int(i) for i in np.argwhere(ids == jax.devices()[r].id)[0])
        assert tuple(pm.coords(r).values()) == pos
    for k, axis in enumerate(axes):
        lines = np.moveaxis(ids, k, -1).reshape(-1, ids.shape[k])
        assert sorted(map(list, lines.tolist())) == pm.axis_groups(axis)


def test_refusals_before_anything_is_spawned(setup):
    _, seeds, _, start = setup
    model4 = make_mesh({MODEL_AXIS: N}, device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3 model shards"):
        train_tp(start, seeds, TOKENS, D, make_mesh({MODEL_AXIS: 3},
                                                    device="cpu"))
    with pytest.raises(ValueError, match="tokens 30 not divisible"):
        train_tp_sp(start, seeds, 30, D, model4)
    with pytest.raises(ValueError, match=r"needs \['model'\]"):
        train_tp(start, seeds, TOKENS, D, make_mesh({DATA_AXIS: N},
                                                    device="cpu"))
    with pytest.raises(ValueError, match=r"needs \['data'\]"):
        train_hybrid(start, seeds, TOKENS, D, model4)
    with pytest.raises(ValueError, match="not divisible"):
        train_hybrid(start, seeds[:6], TOKENS, D,
                     make_mesh({DATA_AXIS: 4, MODEL_AXIS: 2}, device="cpu"))
    # mixed is ported: each trainer runs it (on loopback CPU threads) and
    # ends where single-device mixed training ends (TP) or moved (the
    # hybrid); test_torch_mixed.py holds each against JAX's
    single = train_single(start, seeds, TOKENS, D, lr=LR, mixed=True,
                          batch_fn=setup[2])
    for fn, axes in ((train_tp, {MODEL_AXIS: N}), (train_tp_sp,
                                                   {MODEL_AXIS: N}),
                     (train_hybrid, {DATA_AXIS: 2, MODEL_AXIS: 2})):
        got = fn(start, seeds, TOKENS, D, _loopback(axes), lr=LR,
                 mixed=True, batch_fn=setup[2])
        assert got.w1.dtype == torch.float32
        if fn is train_hybrid:
            _moved(got, start)
        else:
            # the mixed tolerance (test_torch_mixed.py): TP's bf16 operands
            # are single's, its f32 sums split over the shards
            for g, w in zip(got, single):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-2,
                                           atol=1e-4)
    with pytest.raises(NotImplementedError, match="data x expert"):
        make_mesh({DATA_AXIS: 2, EXPERT_AXIS: 2}, device="cpu")


CLI = [sys.executable, "-m", "distributed_llm_code_samples_tpu_torch.cli",
       "--device", "cpu", "-s", "8", "-bs", "2", "-n", "16", "-l", "2", "-d",
       "32", "-r", "7"]


def _cli(flags):
    return subprocess.run(CLI + flags, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_cli_method_0_runs_and_verifies():
    """The reference's default invocation: methods 1-4 in turn, then
    DDP against FSDP and single-device against TP."""
    out = _cli(["--fake_devices", "4", "--strict"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    takes = [l.split()[0] for l in lines if " takes " in l]
    assert takes == ["train_single", "train_ddp", "train_fsdp", "train_tp"]
    payloads = [json.loads(l) for l in lines if l.startswith("{")]
    assert [p["method"] for p in payloads] == [1, 2, 3, 4]
    verify = [json.loads(l.split(" ", 1)[1]) for l in lines
              if l.startswith("verify ")]
    assert [(v["a"], v["b"]) for v in verify] == [("ddp", "fsdp"),
                                                  ("1dev", "tp")]
    assert "SoftAssertionError" not in out.stdout
    assert sum(l.startswith("final train_") for l in lines) == 4


@pytest.mark.parametrize("flags,mesh,steps_per_rank", [
    (["-m", "4"], {"model": 4}, 8),
    (["-m", "4", "--tp_sp"], {"model": 4}, 8),
    (["-m", "5", "--tp", "2"], {"data": 2, "model": 2}, 4)])
def test_cli_tp_and_hybrid_print_the_payload(flags, mesh, steps_per_rank):
    out = _cli(["--fake_devices", "4", "--lr", "0.1"] + flags)
    assert out.returncode == 0, out.stderr
    assert "PARAMS: 16_384" in out.stdout
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["mesh"] == mesh and payload["ranks"] == 4
    assert payload["steps_per_rank"] == steps_per_rank
    assert payload["kernel_launches_per_rank"] == [{}] * 4
    assert payload["comm"] == "psum" and payload["device"] == "cpu"
    # TP's ranks share one batch a step, the hybrid takes one a data rank
    batches = mesh.get("data", 1)
    assert payload["tokens_per_s"] == pytest.approx(
        batches * 32 / (payload["median_step_ms"] / 1e3))
    assert payload.get("sequence_parallel", False) == ("--tp_sp" in flags)


@pytest.mark.parametrize("flags", [["-m", "1", "--tp_sp"],
                                   ["-m", "2", "--tp", "2"],
                                   ["-m", "4", "--dp", "2"],
                                   ["-m", "3", "--strict"],
                                   ["-m", "4", "--pallas"],
                                   ["-m", "0", "--optimizer", "adam"],
                                   ["-m", "5", "--comm", "psum"]])
def test_cli_refuses_flags_that_do_not_apply(capsys, flags):
    assert cli.main(CLI[3:] + flags) == 2
    out = capsys.readouterr()
    assert out.out == "" and "error:" in out.err


def test_method_0_check_reports_each_leaf(capsys):
    """A leaf that disagrees prints its ``SoftAssertionError:`` line and
    fails the check; equal leaves pass."""
    a = FFNStackParams(torch.zeros(1, 4, 2), torch.zeros(1, 2, 4))
    b = FFNStackParams(a.w1.clone(), a.w2 + 1e-3)
    assert not cli._check({1: a, 2: a, 3: a, 4: a}, *cli.CHECK_TOL)
    assert cli._check({1: a, 2: a, 3: a, 4: b}, *cli.CHECK_TOL)
    out = capsys.readouterr().out
    assert out.count("SoftAssertionError:") == 1
    assert "SoftAssertionError: 1dev.w2 vs tp.w2" in out
