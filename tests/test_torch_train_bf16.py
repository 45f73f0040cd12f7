"""The port's multi-rank FFN trainers with ``--dtype bfloat16`` params
against the JAX package's on the conftest meshes: DDP and FSDP on four
gloo ranks under both transports (JAX's rings in Pallas interpret mode),
TP and TP-SP on four, and the hybrid on 2 x 2.

d 32, 2 layers, 32 tokens a rank a step, lr 0.1, from JAX's bf16
``init_ffn_stack`` parameters (``ffn_params_from_numpy`` keeps their
bits) on JAX's f32 batches, which both sides round to bf16. DDP and FSDP
take 8 global seeds (2 steps a rank), TP and the hybrid 4. Each mesh's
port runs share one spawn.

Tolerance is in bf16 steps of the weights: an element's step is the
spacing of bf16 numbers at its magnitude, or at the weights' RMS
magnitude where it is smaller (about 0.02 here, a step of 2^-13: a
weight near zero does not count a tiny step), with the share of weights
that differ at all. Under the ring transport both
sides add the same bf16 gradients in the same ring order with a
rounding after every add, so the port's weights differ from JAX's only
where a CPU matmul of the two frameworks rounded a gradient element to
the other neighbour: at most one step, in at most 0.5% of the weights
(none differed on this box). The control, the same DDP run with its
ring sums in f32 and rounded once, differs in 4% of them. The psum
transport (gloo adds bf16 with a rounding every add, in its own order;
XLA's CPU all-reduce sums bf16 in f32) is held within two steps in at
most 10% of the weights (4.6% measured), and TP's reductions, which
sum bf16 partial products over the ranks (XLA's CPU sums them in f32),
within two steps in at most 25% (15% measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack
from distributed_llm_code_samples_tpu.parallel import make_mesh as j_mesh
from distributed_llm_code_samples_tpu.parallel import train_ddp as j_ddp
from distributed_llm_code_samples_tpu.parallel import train_fsdp as j_fsdp
from distributed_llm_code_samples_tpu.parallel import train_hybrid as j_hybrid
from distributed_llm_code_samples_tpu.parallel import train_tp as j_tp
from distributed_llm_code_samples_tpu.parallel import train_tp_sp as j_tp_sp
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, hybrid, launch, make_mesh, train_ddp, train_fsdp,
    train_hybrid, train_tp, train_tp_sp, unshard_params, unshard_tp_params)
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)

from torch_bf16_ranks import ddp_f32_ring_sums

BF = jnp.bfloat16
D, L, TOKENS, LR, N = 32, 2, 32, 0.1, 4
DP_RUNS = [("ddp", "psum"), ("ddp", "pallas_ring"), ("fsdp", "psum"),
           ("fsdp", "pallas_ring"), ("control", "pallas_ring")]


@pytest.fixture(scope="module")
def setup():
    import jax
    params = init_ffn_stack(jax.random.PRNGKey(0), D, L, dtype=BF)
    seeds = np.asarray(make_seed_schedule(8, 7))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), TOKENS, D))
                        for s in seeds})
    return params, seeds, table, ffn_params_from_numpy(params)


def _launch(setup, axes, calls):
    _, _, table, start = setup
    calls = [(fn, (start, seeds, TOKENS, D, MESH),
              dict(kw, lr=LR, batch_fn=table)) for fn, seeds, kw in calls]
    outs = launch(call_each, make_mesh(axes, device="cpu"), calls,
                  timeout=240)
    return [[o[i] for o in outs] for i in range(len(calls))]


@pytest.fixture(scope="module")
def dp_runs(setup):
    """The DDP and FSDP runs and the control, one spawn: ``{(strategy,
    comm): full params}``."""
    seeds = setup[1]
    fns = {"ddp": train_ddp, "fsdp": train_fsdp,
           "control": ddp_f32_ring_sums}
    outs = _launch(setup, {DATA_AXIS: N}, [
        (fns[s], seeds, {} if s == "control" else dict(comm=c))
        for s, c in DP_RUNS])
    return {run: (unshard_params(o) if run[0] == "fsdp" else o[0])
            for run, o in zip(DP_RUNS, outs)}


@pytest.fixture(scope="module")
def jax_dp(mesh4, setup):
    params, seeds = setup[:2]
    train = {"ddp": j_ddp, "fsdp": j_fsdp}
    return {(s, c): train[s](params, jnp.asarray(seeds), TOKENS, D, mesh4,
                             lr=LR, comm=c)
            for s, c in DP_RUNS if s != "control"}


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a).astype(np.float32))


def weight_steps(got, want):
    """``(max |got - want| in bf16 steps, share of weights that
    differ)``: an element's step at the larger of its two magnitudes and
    ``want``'s RMS."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    rms = np.sqrt(np.mean(w ** 2))
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), rms))
    return (float((np.abs(g - w) / np.ldexp(1.0, e - 8)).max()),
            float((g != w).mean()))


def _within(got, want, most, share):
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        m, s = weight_steps(g, w)
        assert m <= most and s <= share, (m, s)


def _moved(got, start):
    assert weight_steps(got.w1, start.w1)[1] > 0.5


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_ring_transport_matches_jax(setup, dp_runs, jax_dp, strategy):
    """Under ``pallas_ring`` the same bf16 ring sums on both sides: at
    most one step from JAX's, in at most 0.5% of the weights."""
    got = dp_runs[strategy, "pallas_ring"]
    _within(got, jax_dp[strategy, "pallas_ring"], 1, 0.005)
    _moved(got, setup[3])


def test_f32_ring_sums_are_told_apart(dp_runs, jax_dp):
    """The control: DDP with f32 ring sums differs from JAX's DDP in more
    than four times the share of weights the port's bf16 ring does."""
    want = jax_dp["ddp", "pallas_ring"]
    port = max(weight_steps(g, w)[1]
               for g, w in zip(dp_runs["ddp", "pallas_ring"], want))
    control = max(weight_steps(g, w)[1]
                  for g, w in zip(dp_runs["control", "pallas_ring"], want))
    assert control > 4 * port + 0.005, (control, port)


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_psum_transport_matches_jax(setup, dp_runs, jax_dp, strategy):
    got = dp_runs[strategy, "psum"]
    _within(got, jax_dp[strategy, "psum"], 2, 0.1)
    _moved(got, setup[3])


def test_ddp_against_fsdp_as_jax_method_0_checks_them(dp_runs, jax_dp):
    """JAX's ``-m 0`` check (rtol 1e-5, atol 1e-7) on both sides' DDP and
    FSDP: under psum both pass (the port's gloo reduce-scatter is its
    all-reduce and a slice: the same bits); under the ring both fail by
    the same small margin, since the all-reduce and the reduce-scatter
    add each chunk in another ring order, rounding every add to bf16."""
    def check(a, b):
        return all(np.allclose(_np(x), _np(y), rtol=1e-5, atol=1e-7)
                   for x, y in zip(a, b))

    for comm, agree in (("psum", True), ("pallas_ring", False)):
        port = dp_runs["ddp", comm], dp_runs["fsdp", comm]
        jx = jax_dp["ddp", comm], jax_dp["fsdp", comm]
        assert check(*port) is agree and check(*jx) is agree, comm
    for a, b in zip(dp_runs["ddp", "pallas_ring"],
                    dp_runs["fsdp", "pallas_ring"]):
        assert weight_steps(a, b)[0] <= 2


@pytest.fixture(scope="module")
def tp_runs(setup):
    seeds = setup[1][:4]
    return [unshard_tp_params(r) for r in _launch(
        setup, {MODEL_AXIS: N}, [(train_tp, seeds, {}),
                                 (train_tp_sp, seeds, {})])]


@pytest.mark.parametrize("which", ["tp", "tp_sp"])
def test_tp_matches_jax(mesh_model4, setup, tp_runs, which):
    params, seeds, _, start = setup
    j_train = {"tp": j_tp, "tp_sp": j_tp_sp}[which]
    got = tp_runs[["tp", "tp_sp"].index(which)]
    _within(got, j_train(params, jnp.asarray(seeds[:4]), TOKENS, D,
                         mesh_model4, lr=LR), 2, 0.25)
    _moved(got, start)


def test_hybrid_matches_jax(setup):
    params, seeds, _, start = setup
    axes = {DATA_AXIS: 2, MODEL_AXIS: 2}
    got = hybrid.unshard_params(
        _launch(setup, axes, [(train_hybrid, seeds[:4], {})])[0],
        make_mesh(axes, device="cpu"))
    _within(got, j_hybrid(params, jnp.asarray(seeds[:4]), TOKENS, D,
                          j_mesh(axes), lr=LR), 2, 0.25)
    _moved(got, start)
