"""The port's ``train_ddp`` and ``train_fsdp`` on four gloo ranks against
the JAX package's on the conftest ``mesh4``, under both transports.

d 32, 2 layers, 32 tokens a rank a step, 16 global seeds of
``make_seed_schedule(16, 7)`` (4 steps a rank), lr 0.1. Both sides start
from the JAX ``init_ffn_stack`` parameters (``ffn_params_from_numpy``)
and the port trains on the JAX batches, handed to the spawned ranks in a
``BatchTable``. JAX runs ``comm="pallas_ring"`` through its Pallas ring
kernels in interpret mode. The four port runs share one spawn of four
ranks. Tolerance: rtol 1e-5, atol 1e-6, as ``test_torch_train_single.py``
(the frameworks' CPU matmuls sum in other orders); port DDP against port
FSDP is the reference's own differential, at the same tolerance.
"""

import json
import multiprocessing
import operator
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack
from distributed_llm_code_samples_tpu.parallel import train_ddp as j_ddp
from distributed_llm_code_samples_tpu.parallel import train_fsdp as j_fsdp
from distributed_llm_code_samples_tpu_torch.data import (BatchTable,
                                                         shard_seeds_strided)
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, launch, make_mesh, train_ddp, train_fsdp, unshard_params)
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, PerRank, call_each)

D, L, TOKENS, LR, N = 32, 2, 32, 0.1, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = [("ddp", "psum"), ("ddp", "pallas_ring"), ("fsdp", "psum"),
        ("fsdp", "pallas_ring")]


@pytest.fixture(scope="module")
def setup():
    params = init_ffn_stack(__import__("jax").random.PRNGKey(0), D, L)
    seeds = np.asarray(make_seed_schedule(16, 7))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), TOKENS, D))
                        for s in seeds})
    return params, seeds, table


@pytest.fixture(scope="module")
def port_runs(setup):
    """The four port runs in one launch: ``{(strategy, comm): [per-rank
    result]}`` (DDP: each rank's replica; FSDP: each rank's shards)."""
    params, seeds, table = setup
    start = ffn_params_from_numpy(params)
    train = {"ddp": train_ddp, "fsdp": train_fsdp}
    calls = [(train[s], (start, seeds, TOKENS, D, MESH),
              dict(lr=LR, comm=c, batch_fn=table)) for s, c in RUNS]
    outs = launch(call_each, make_mesh({DATA_AXIS: N}, device="cpu"), calls,
                  timeout=240)
    return start, {run: [outs[r][i] for r in range(N)]
                   for i, run in enumerate(RUNS)}


def _full(strategy, per_rank):
    if strategy == "fsdp":
        return unshard_params(per_rank)
    for replica in per_rank[1:]:           # replicated bit for bit
        for a, b in zip(replica, per_rank[0]):
            assert torch.equal(a, b)
    return per_rank[0]


@pytest.mark.parametrize("strategy,comm", RUNS)
def test_port_matches_jax(mesh4, setup, port_runs, strategy, comm):
    params, seeds, _ = setup
    start, runs = port_runs
    j_train = {"ddp": j_ddp, "fsdp": j_fsdp}[strategy]
    want = j_train(params, jnp.asarray(seeds), TOKENS, D, mesh4, lr=LR,
                   comm=comm)
    got = _full(strategy, runs[strategy, comm])
    for g, w in ((got.w1, want.w1), (got.w2, want.w2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # the run moved the weights by 100x the tolerance
    assert float((got.w1 - start.w1).abs().max()) > 1e-4


@pytest.mark.parametrize("comm", ["psum", "pallas_ring"])
def test_ddp_equals_fsdp(port_runs, comm):
    _, runs = port_runs
    ddp = _full("ddp", runs["ddp", comm])
    fsdp = _full("fsdp", runs["fsdp", comm])
    for a, b in zip(ddp, fsdp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # FSDP's ranks hold a quarter of each layer
    assert runs["fsdp", comm][0].w1.shape == (L, 4 * D // N, D)
    assert runs["fsdp", comm][0].w2.shape == (L, D // N, 4 * D)


def test_launched_trainers_return_the_full_params(setup, port_runs):
    """``train_ddp`` / ``train_fsdp`` given the whole mesh spawn the ranks
    themselves and hand back the full params; the caller's are kept."""
    params, seeds, table = setup
    start, runs = port_runs
    before = start.w1.clone()
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    got = train_fsdp(start, seeds[:8], TOKENS, D, mesh, lr=LR, comm="psum",
                     batch_fn=table, timeout=120)
    assert torch.equal(start.w1, before)
    assert got.w1.shape == start.w1.shape
    ddp = train_ddp(start, seeds[:8], TOKENS, D, mesh, lr=LR, comm="psum",
                    batch_fn=table, timeout=120)
    for a, b in zip(ddp, got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_strided_seeds_and_refusals(setup):
    params, seeds, _ = setup
    cols = shard_seeds_strided(seeds, N)
    assert cols.shape == (4, N) and cols[2, 1] == seeds[2 * N + 1]
    with pytest.raises(ValueError, match="not divisible"):
        shard_seeds_strided(seeds[:6], N)
    start = ffn_params_from_numpy(params)
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    # all of these raise before anything is spawned
    with pytest.raises(ValueError, match="not divisible"):
        train_ddp(start, seeds[:6], TOKENS, D, mesh)
    with pytest.raises(ValueError, match="unknown comm"):
        train_fsdp(start, seeds, TOKENS, D, mesh, comm="nccl")
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        train_fsdp(start, seeds[:6], TOKENS, D,
                   make_mesh({DATA_AXIS: 3}, device="cpu"))
    # a guard that is not a GuardrailConfig raises JAX's TypeError
    # (check_guard_args); the elastic seed_accum is still refused
    for kw, err, match in (({"guard": object()}, TypeError,
                            "GuardrailConfig"),
                           ({"seed_accum": 2}, NotImplementedError,
                            "not ported")):
        with pytest.raises(err, match=match):
            train_fsdp(start, seeds, TOKENS, D, mesh, **kw)
        with pytest.raises(err, match=match):
            train_ddp(start, seeds, TOKENS, D, mesh, **kw)
    # the optimizers, mixed and accumulation run (one launch of all three;
    # test_torch_optim.py and test_torch_mixed.py hold them against JAX)
    from distributed_llm_code_samples_tpu_torch.optim import adam
    outs = launch(call_each, mesh, [
        (train_fsdp, (start, seeds[:N], TOKENS, D, MESH),
         dict(lr=LR, optimizer=adam(), return_state=True)),
        (train_fsdp, (start, seeds[:N], TOKENS, D, MESH),
         dict(lr=LR, mixed=True)),
        (train_ddp, (start, seeds[:N], TOKENS, D, MESH),
         dict(lr=LR, accum=2))], timeout=120)
    shards, state = outs[0][0]
    assert state.mu.w1.shape == shards.w1.shape == (L, 4 * D // N, D)
    assert int(state.count) == 1
    for got in (unshard_params([o[1] for o in outs]), outs[0][2]):
        assert got.w1.shape == start.w1.shape
        assert bool(torch.isfinite(got.w1).all())
        assert not torch.equal(got.w1, start.w1)
    # the meshes still refused: data x expert, and an axis not ported
    with pytest.raises(NotImplementedError, match="data x expert"):
        make_mesh({DATA_AXIS: 2, "expert": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="the ported meshes"):
        make_mesh({"pipe": 2}, device="cpu")


def test_a_failing_or_hanging_rank_fails_the_launch(setup):
    """A rank that raises fails the launch with its traceback; a rank that
    hangs fails it at the timeout; either way no rank is left behind."""
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        launch(call_each, mesh,
               [(operator.truediv, (1.0, PerRank([1, 0, 1, 1])), {})],
               timeout=120)
    assert multiprocessing.active_children() == []
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[2\] did not finish"):
        launch(call_each, mesh,
               [(time.sleep, (PerRank([0, 0, 600, 0]),), {})], timeout=15)
    assert time.monotonic() - t0 < 60
    assert multiprocessing.active_children() == []


CLI = [sys.executable, "-m", "distributed_llm_code_samples_tpu_torch.cli",
       "--device", "cpu", "--fake_devices", "4", "-s", "8", "-bs", "2",
       "-n", "16", "-l", "2", "-d", "32", "-r", "7"]


@pytest.mark.parametrize("method", ["2", "3"])
def test_cli_multi_rank_on_cpu_prints_the_payload(method):
    runs = {}
    for comm in ("psum", "pallas_ring"):
        out = subprocess.run(CLI + ["-m", method, "--comm", comm, "--lr",
                                    "0.1"], cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith("ARGS:") and "PARAMS: 16_384" in out.stdout
        payload = json.loads(out.stdout.strip().splitlines()[-1])
        assert payload["kernel_launches"] == {}       # CPU: the plain rings
        assert payload["kernel_launches_per_rank"] == [{}] * 4
        assert payload["ranks"] == 4 and payload["comm"] == comm
        assert payload["steps"] == 8 and payload["steps_per_rank"] == 2
        assert payload["device"] == "cpu" and payload["method"] == int(method)
        for key in ("wall_s", "median_step_ms", "tokens_per_s",
                    "model_tflops_per_s"):
            assert payload[key] > 0
        runs[comm] = np.array(payload["layer_checksums"])
    np.testing.assert_allclose(runs["psum"], runs["pallas_ring"], rtol=1e-5)


@pytest.mark.parametrize("flags", [["-m", "1", "--comm", "psum"],
                                   ["-m", "2", "-s", "6"],
                                   ["-m", "3", "--zero1"],
                                   ["-m", "2", "--zero1", "--comm",
                                    "pallas_ring"],
                                   ["-m", "4", "--optimizer", "adam"],
                                   ["-m", "1", "--fake_devices", "4"]])
def test_cli_refuses_what_does_not_apply(flags):
    base = [a for a in CLI if a not in ("-s", "8")]
    out = subprocess.run(base + flags, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2, out.stderr
    assert out.stdout == "" and "error:" in out.stderr
