"""The port's expert parallelism (``parallel/expert.py``) against the JAX
package's, on four gloo ranks against the conftest ``mesh4_expert``.

JAX's test sizes: d 32, 2 layers, 8 experts (2 a rank), 64 tokens a step
over the EP group (16 a rank), ``make_seed_schedule(32, 7)`` (8 steps a
rank), lr 0.1. Both sides start from the JAX ``init_moe_stack``
parameters (``moe_params_from_numpy``) and the port trains on the JAX
batches, handed to the spawned ranks in a ``BatchTable``. JAX runs its
``comm="psum"`` path (``test_pallas_ring.py:324-343`` pins its
``pallas_a2a`` path to it); the port runs both of its transports, all
ten runs in one spawn of four ranks.

Tolerance: rtol 1e-5, atol 1e-6, as the other trainers' (the
frameworks' CPU matmuls sum in other orders); the port's two transports
move the same bytes and add nothing, so they agree bit for bit. Where
routing differs between the frameworks the assertion names the token
and its top-2 logit gap.
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
from distributed_llm_code_samples_tpu.models import init_moe_stack
from distributed_llm_code_samples_tpu.parallel import (
    EXPERT_AXIS as J_EXPERT_AXIS)
from distributed_llm_code_samples_tpu.parallel import make_mesh as j_mesh
from distributed_llm_code_samples_tpu.parallel import (
    train_moe_dense as j_dense)
from distributed_llm_code_samples_tpu.parallel import train_moe_ep as j_ep
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    MoEStackParams, moe_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import moe as pm
from distributed_llm_code_samples_tpu_torch.parallel import (
    EXPERT_AXIS, launch, make_mesh, train_moe_dense, train_moe_ep)
from distributed_llm_code_samples_tpu_torch.parallel import expert
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)

D, L, E, TOKENS, LR, N = 32, 2, 8, 64, 0.1, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (dispatch, k, aux_coef, capacity_factor)
CASES = [("dense", 1, 0.0, 2.0), ("dense", 2, 0.01, 2.0),
         ("dense", 2, 0.01, 0.5), ("scatter", 2, 0.01, 2.0),
         ("gather", 2, 0.01, 2.0)]
COMMS = ("psum", "pallas_a2a")


@pytest.fixture(scope="module")
def setup():
    params = init_moe_stack(jax.random.PRNGKey(0), D, L, E)
    seeds = np.asarray(make_seed_schedule(32, 7))
    tables = {t: BatchTable({int(s): tuple(np.asarray(a) for a in
                                           j_batch(jnp.int32(s), t, D))
                             for s in seeds})
              for t in (TOKENS, TOKENS // N)}
    return params, seeds, tables


@pytest.fixture(scope="module")
def port_runs(setup):
    """The ten port runs in one launch: ``{(case, comm): [each rank's
    part]}``."""
    params, seeds, tables = setup
    start = moe_params_from_numpy(params)
    runs = [(case, comm) for case in CASES for comm in COMMS]
    calls = [(train_moe_ep, (start, seeds, TOKENS, D, MESH),
              dict(lr=LR, k=k, aux_coef=aux, capacity_factor=cf,
                   dispatch=disp, comm=comm, batch_fn=tables[TOKENS // N]))
             for (disp, k, aux, cf), comm in runs]
    outs = launch(call_each, make_mesh({EXPERT_AXIS: N}, device="cpu"),
                  calls, timeout=240)
    return start, {run: expert.unshard_params([outs[r][i] for r in range(N)])
                   for i, run in enumerate(runs)}


def _routing_note(params, x, layer=0):
    """Where two trainers could route apart: the token of smallest top-2
    logit gap on the first layer's input."""
    logits = x @ params.wg[layer].T
    top = torch.topk(logits, 2).values
    gap = top[:, 0] - top[:, 1]
    t = int(torch.argmin(gap))
    return f"closest top-2 call: token {t}, logit gap {float(gap[t]):.3e}"


def _close(got, want, note=""):
    for name, g, w in zip(("wg", "w1", "w2"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{name}; {note}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_port_ep_matches_jax_ep_under_both_transports(mesh4_expert, setup,
                                                      port_runs, case):
    params, seeds, tables = setup
    start, runs = port_runs
    disp, k, aux, cf = case
    want = j_ep(params, jnp.asarray(seeds), TOKENS, D, mesh4_expert, lr=LR,
                capacity_factor=cf, k=k, aux_coef=aux, dispatch=disp)
    x0 = torch.from_numpy(np.array(
        tables[TOKENS // N].batches[int(seeds[0])][0]))
    note = _routing_note(start, x0)
    for comm in COMMS:
        _close(runs[case, comm], want, f"{comm}; {note}")
    for a, b in zip(runs[case, "psum"], runs[case, "pallas_a2a"]):
        assert torch.equal(a, b)
    # the run moved the weights by 100x the tolerance
    assert float((runs[case, "psum"].w1 - start.w1).abs().max()) > 1e-4


@pytest.mark.parametrize("n_groups", [1, 4])
def test_dense_oracle_matches_jax(setup, n_groups):
    params, seeds, tables = setup
    start = moe_params_from_numpy(params)
    kw = dict(lr=LR, k=2, aux_coef=0.01, capacity_factor=2.0,
              n_groups=n_groups)
    got = train_moe_dense(start, seeds, TOKENS, D,
                          batch_fn=tables[TOKENS // n_groups], **kw)
    want = j_dense(params, jnp.asarray(seeds), TOKENS, D, **kw)
    _close(got, want)
    for a, b in zip(start, moe_params_from_numpy(params)):
        assert torch.equal(a, b)            # the caller's are untouched


def test_ep_equals_its_dense_oracle(setup, port_runs):
    """The user-facing differential of ``-m 7``: EP on n ranks == the
    grouped dense trainer with ``n_groups=n``, for every case."""
    params, seeds, tables = setup
    start, runs = port_runs
    for disp, k, aux, cf in CASES:
        dense = train_moe_dense(start, seeds, TOKENS, D, lr=LR, k=k,
                                aux_coef=aux, capacity_factor=cf,
                                n_groups=N, dispatch=disp,
                                batch_fn=tables[TOKENS // N])
        for a, b in zip(runs[(disp, k, aux, cf), "pallas_a2a"], dense):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=disp)


# two ranks: gather dispatch, top-1, capacity factor 0.5 (slots overflow)
N2, CASE2 = 2, ("gather", 1, 0.0, 0.5)


@pytest.fixture(scope="module")
def port_runs_2(setup):
    """``CASE2`` on two gloo ranks under both transports, in one launch:
    ``{comm: params}``."""
    params, seeds, _ = setup
    start = moe_params_from_numpy(params)
    tokens = {int(s): tuple(np.asarray(a) for a in
                            j_batch(jnp.int32(s), TOKENS // N2, D))
              for s in seeds}
    disp, k, aux, cf = CASE2
    calls = [(train_moe_ep, (start, seeds, TOKENS, D, MESH),
              dict(lr=LR, k=k, aux_coef=aux, capacity_factor=cf,
                   dispatch=disp, comm=comm, batch_fn=BatchTable(tokens)))
             for comm in COMMS]
    outs = launch(call_each, make_mesh({EXPERT_AXIS: N2}, device="cpu"),
                  calls, timeout=240)
    return {comm: expert.unshard_params([outs[r][i] for r in range(N2)])
            for i, comm in enumerate(COMMS)}


@pytest.mark.parametrize("comm", COMMS)
def test_port_ep_on_two_ranks_matches_jax_ep(setup, port_runs_2, comm):
    params, seeds, _ = setup
    disp, k, aux, cf = CASE2
    want = j_ep(params, jnp.asarray(seeds), TOKENS, D,
                j_mesh({J_EXPERT_AXIS: N2}), lr=LR, capacity_factor=cf, k=k,
                aux_coef=aux, dispatch=disp)
    _close(port_runs_2[comm], want, comm)
    for a, b in zip(port_runs_2["psum"], port_runs_2["pallas_a2a"]):
        assert torch.equal(a, b)
    start = moe_params_from_numpy(params)
    assert float((port_runs_2[comm].w1 - start.w1).abs().max()) > 1e-4


def test_dense_capacity_groups_zero_fails_as_in_jax(setup):
    """``capacity_groups=0`` is taken as given, not as "unset": both
    packages split the capacity over zero groups and raise."""
    params, seeds, tables = setup
    kw = dict(lr=LR, k=1, capacity_factor=2.0, n_groups=N,
              capacity_groups=0)
    with pytest.raises(ZeroDivisionError):
        j_dense(params, jnp.asarray(seeds), TOKENS, D, **kw)
    with pytest.raises(ZeroDivisionError):
        train_moe_dense(moe_params_from_numpy(params), seeds, TOKENS, D,
                        batch_fn=tables[TOKENS // N], **kw)


def test_shards_and_capacity(setup):
    params, _, _ = setup
    start = moe_params_from_numpy(params)
    mesh = make_mesh({EXPERT_AXIS: N}, device="cpu")
    parts = [expert.shard_params(start, mesh.for_rank(r)) for r in range(N)]
    assert parts[1].w1.shape == (L, E // N, 4 * D, D)
    assert torch.equal(parts[1].w2, start.w2[:, 2:4])
    assert all(torch.equal(p.wg, start.wg) for p in parts)
    for a, b in zip(expert.unshard_params(parts), start):
        assert torch.equal(a, b)
    # C_local = ceil(C_global / n): 8192 tokens, 8 experts, factor 2
    assert expert._local_capacity(2048, 4, 8, 2.0) == 512
    assert expert._local_capacity(16, 4, 8, 0.5) == 1
    assert pm.expert_capacity(64, 8, 0.5) == 4


def test_unported_options_and_bad_inputs_raise(setup):
    params, seeds, _ = setup
    start = moe_params_from_numpy(params)
    mesh = make_mesh({EXPERT_AXIS: N}, device="cpu")
    with pytest.raises(NotImplementedError, match="data_axis"):
        expert.make_step(16, D, data_axis="data", mesh=mesh.for_rank(0))
    with pytest.raises(NotImplementedError, match="1-D mesh"):
        make_mesh({"data": 2, EXPERT_AXIS: 2}, device="cpu")
    # all of these raise before anything is spawned
    with pytest.raises(ValueError, match="unknown comm"):
        train_moe_ep(start, seeds, TOKENS, D, mesh, comm="nccl")
    with pytest.raises(ValueError, match="unknown dispatch"):
        train_moe_ep(start, seeds, TOKENS, D, mesh, dispatch="sparse")
    with pytest.raises(ValueError, match="n_experts=6 not divisible"):
        train_moe_ep(MoEStackParams(start.wg[:, :6], start.w1[:, :6],
                                    start.w2[:, :6]), seeds, TOKENS, D, mesh)
    with pytest.raises(ValueError, match="batch_size=66 not divisible"):
        train_moe_ep(start, seeds, TOKENS + 2, D, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        train_moe_ep(start, seeds[:6], TOKENS, D, mesh)
    with pytest.raises(ValueError, match="needs"):
        train_moe_ep(start, seeds, TOKENS, D,
                     make_mesh({"data": N}, device="cpu"))


CLI = [sys.executable, "-m", "distributed_llm_code_samples_tpu_torch.cli",
       "--device", "cpu", "--fake_devices", "4", "-m", "7", "-s", "8",
       "-bs", "4", "-n", "16", "-l", "2", "-d", "32", "-r", "7"]


def test_cli_method_7_on_cpu_prints_the_payload():
    out = subprocess.run(CLI + ["--lr", "0.1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # 2 layers x (8 routers of 32 + 8 experts x 2 x 32 x 128)
    assert out.stdout.startswith("ARGS:") and "PARAMS: 131_584" in out.stdout
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["kernel_launches"] == {}       # CPU: the plain exchange
    assert payload["kernel_launches_per_rank"] == [{}] * 4
    assert payload["ranks"] == 4 and payload["comm"] == "psum"
    assert payload["steps"] == 8 and payload["steps_per_rank"] == 2
    assert payload["tokens_per_step"] == 64 and payload["experts"] == 8
    assert payload["device"] == "cpu" and payload["method"] == 7
    for key in ("wall_s", "median_step_ms", "tokens_per_s",
                "model_tflops_per_s"):
        assert payload[key] > 0
    assert len(payload["layer_checksums"]) == 2
    # --comm stays refused for -m 7, as in the JAX CLI
    out = subprocess.run(CLI + ["--comm", "pallas_ring"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and "--comm applies" in out.stderr
    assert out.stdout == ""
