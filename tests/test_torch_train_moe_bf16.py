"""Expert parallelism on ``--dtype bfloat16`` params (``train_moe_ep``
under ``comm="psum"`` and ``comm="pallas_a2a"``, every dispatch) and
``cli.py -m 7`` on bf16, against the JAX package on the CPU.

d 32, 2 layers, 8 experts (2 a rank), top-2, capacity factor 2, aux
0.01, 64 tokens a step over the EP group (16 a rank), lr 0.1, from JAX's
bf16 ``init_moe_stack`` parameters; the port trains on the JAX batches.
The seven port runs share one spawn of 4 gloo ranks; JAX's run on the
conftest ``mesh4_expert`` under ``comm="psum"`` for every dispatch and
``"pallas_a2a"`` for the dense one (its kernel in interpret mode), under
``test_torch_lm_bf16.py``'s ``STRICT`` (each bf16 op rounded as written).

The single-device dense trainer, whose every op rounds as JAX's does
(the router's softmax and gate renormalisation included, ``ops/moe.py``),
equals JAX's bit for bit over four steps. EP, one step a rank (4
seeds): every weight within one bf16 step of JAX's (at the leaf's RMS),
in at most 10% of each leaf (measured 6.1-7.2% of ``wg``, 2.5% of
``w1``, 1.2% of ``w2``): the port sums bf16 partial gradients over the
ranks in bf16 (gloo's sums, as the card's), where XLA's CPU collectives
carry them in f32, as in TP (``test_torch_train_lm_tp_bf16.py``). The
run from the f32 widening of the params differs in more than half of
every leaf (the control). Over 8 steps a rank the EP gap grows to 7-12%
of the update, so the steps are held one at a time. The port's two
transports move the same bf16 bytes and add nothing: bit for bit.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_moe_stack
from distributed_llm_code_samples_tpu.parallel import (
    train_moe_dense as j_dense)
from distributed_llm_code_samples_tpu.parallel import train_moe_ep as j_ep
from distributed_llm_code_samples_tpu_torch import cli
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    moe_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import (
    EXPERT_AXIS, expert, launch, make_mesh, train_moe_dense, train_moe_ep)
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)

from torch_bf16_ranks import bf16_steps

BF = jnp.bfloat16
D, L, E, TOKENS, LR, N = 32, 2, 8, 64, 0.1, 4
STRICT = {"xla_allow_excess_precision": False}
DISPATCHES = ("dense", "scatter", "gather")
COMMS = ("psum", "pallas_a2a")
KW = dict(lr=LR, k=2, aux_coef=0.01, capacity_factor=2.0)
MOST, SHARE = 1.0, 0.1


@pytest.fixture(scope="module")
def setup():
    params = init_moe_stack(jax.random.PRNGKey(0), D, L, E, dtype=BF)
    seeds = np.asarray(make_seed_schedule(32, 7))[:N]
    table = BatchTable({int(s): tuple(np.array(a) for a in
                                      j_batch(jnp.int32(s), TOKENS // N, D))
                        for s in seeds})
    return params, seeds, table, moe_params_from_numpy(params)


@pytest.fixture(scope="module")
def port_runs(setup):
    """Every (dispatch, comm) run, and the f32 control, in one launch:
    ``{run: params}``."""
    params, seeds, table, start = setup
    f32 = moe_params_from_numpy(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), params))
    runs = [(d, c) for d in DISPATCHES for c in COMMS] + [("f32", "psum")]
    calls = [(train_moe_ep, (f32 if d == "f32" else start, seeds, TOKENS, D,
                             MESH),
              dict(KW, dispatch="dense" if d == "f32" else d, comm=c,
                   batch_fn=table)) for d, c in runs]
    outs = launch(call_each, make_mesh({EXPERT_AXIS: N}, device="cpu"),
                  calls, timeout=240)
    return {run: expert.unshard_params([outs[r][i] for r in range(N)])
            for i, run in enumerate(runs)}


@functools.lru_cache(maxsize=None)
def _j_ep(mesh, dispatch, comm):
    params = init_moe_stack(jax.random.PRNGKey(0), D, L, E, dtype=BF)
    seeds = jnp.asarray(make_seed_schedule(32, 7)[:N])
    return jax.jit(lambda p, s: j_ep(p, s, TOKENS, D, mesh, dispatch=dispatch,
                                     comm=comm, **KW),
                   compiler_options=STRICT)(params, seeds)


def _held(got, want):
    for name, g, w in zip(("wg", "w1", "w2"), got, want):
        assert g.dtype == torch.bfloat16
        most, share = bf16_steps(g, w)
        assert most <= MOST and share <= SHARE, (name, most, share)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_port_ep_bf16_matches_jax_ep(mesh4_expert, setup, port_runs,
                                     dispatch):
    """One bf16 step a rank under ``comm="psum"`` against JAX's: within
    ``MOST`` bf16 steps in at most ``SHARE`` of each leaf; the port's
    ``pallas_a2a`` run bit for bit the same."""
    got = port_runs[dispatch, "psum"]
    _held(got, _j_ep(mesh4_expert, dispatch, "psum"))
    for a, b in zip(got, port_runs[dispatch, "pallas_a2a"]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert bf16_steps(got.w1, setup[3].w1)[1] > 0.5         # moved


def test_port_a2a_bf16_matches_jax_a2a(mesh4_expert, port_runs):
    """Under ``comm="pallas_a2a"`` against JAX's Pallas all-to-all in
    interpret mode (the dense dispatch; the other dispatches' exchanges
    equal their psum runs above), within ``MOST`` and ``SHARE``."""
    _held(port_runs["dense", "pallas_a2a"],
          _j_ep(mesh4_expert, "dense", "pallas_a2a"))


def test_dense_trainer_bf16_equals_jax_bit_for_bit(setup):
    """``train_moe_dense`` on bf16 params, one group of all 64 tokens, 4
    steps: every weight bit for bit JAX's under ``STRICT``."""
    params, seeds, _, start = setup
    table = BatchTable({int(s): tuple(np.array(a) for a in
                                      j_batch(jnp.int32(s), TOKENS, D))
                        for s in seeds})
    got = train_moe_dense(start, seeds, TOKENS, D, batch_fn=table, **KW)
    want = jax.jit(lambda p, s: j_dense(p, s, TOKENS, D, **KW),
                   compiler_options=STRICT)(params, jnp.asarray(seeds))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
    assert bf16_steps(got.w1, start.w1)[1] > 0.5            # moved


def test_f32_run_is_told_apart(mesh4_expert, port_runs):
    """The control: the f32 run differs from JAX's bf16 one in more than
    half of every leaf."""
    for g, w in zip(port_runs["f32", "psum"],
                    _j_ep(mesh4_expert, "dense", "psum")):
        assert bf16_steps(g, w)[1] > 0.5


def test_cli_method_7_trains_bf16_on_gloo_ranks(capsys):
    """``cli.py -m 7 --dtype bfloat16`` on 4 gloo ranks: exit 0, bf16 in
    the payload, finite checksums."""
    rc = cli.main(["--device", "cpu", "--fake_devices", "4", "-m", "7",
                   "-s", "8", "-bs", "4", "-n", "16", "-l", "2", "-d", "32",
                   "-r", "7", "--experts", "8", "--lr", "0.1", "--dtype",
                   "bfloat16"])
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    payload = json.loads(out.strip().splitlines()[-1])
    assert payload["dtype"] == "bfloat16" and payload["ranks"] == 4
    assert payload["kernel_launches"] == {}
    assert np.isfinite(payload["layer_checksums"]).all()
