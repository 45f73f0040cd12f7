"""The port's data-parallel transformer trainers
(``train_transformer_ddp``, ``train_transformer_fsdp``,
``train_transformer_hybrid``) against a summed-gradient oracle built
from green JAX pieces, and ``train_transformer_single(mixed=True)``
against JAX's, on the CPU.

d 32, 2 layers, 4 heads, sequences of 8, 2 a rank a step (16 tokens),
the 8 seeds of ``make_seed_schedule(8, 7)``, lr 0.1: 4 steps on 2 data
ranks, 2 on 4. Both sides start from the JAX ``init_transformer``
parameters (``transformer_params_from_numpy``) and the port trains on
the JAX batches (a ``BatchTable``). The oracle is JAX's
``test_ddp_matches_summed_grad_oracle`` (``tests/test_transformer.py``)
written out: at step ``t`` rank ``r`` takes ``seeds[t * n + r]``, the
``transformer_fwd`` VJP at the batch's ``dloss_dx`` (flash attention in
interpret mode), the sum, then SGD in numpy. JAX's own DDP, FSDP and
hybrid transformer trainers fail on this JAX version (ROADMAP Queue 3),
so they are not run. The port's ranks are gloo processes, many calls a
launch (``call_each``).

Tolerances, stated at each test: trained params within rtol 2e-4, atol
1e-6 of the oracle (the TP trainers' tolerance); first-step gradients
within rtol 1e-4, atol 1e-7; DDP == FSDP and DDP on one rank ==
``train_transformer_single`` within rtol 1e-6, atol 1e-8 (the same
gradients, summed in the same order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks
from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import (
    init_transformer as j_init)
from distributed_llm_code_samples_tpu.models.transformer import (
    transformer_fwd as j_fwd)
from distributed_llm_code_samples_tpu.parallel import (
    train_transformer_single as j_single)
from distributed_llm_code_samples_tpu.parallel.transformer import (
    resolve_attn as j_resolve_attn)
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    TransformerParams, transformer_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, Mesh, launch, make_mesh, train_transformer_ddp,
    train_transformer_fsdp, train_transformer_hybrid,
    train_transformer_single)
from distributed_llm_code_samples_tpu_torch.parallel import transformer
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)

D, L, H, SEQ, LR = 32, 2, 4, 8, 0.1
TOKENS = 2 * SEQ
N_SEEDS = 8
TOL = dict(rtol=2e-4, atol=1e-6)
EXACT = dict(rtol=1e-6, atol=1e-8)
ATTNS = (None, "flash")
ATTN_IDS = ["oracle", "flash"]


@pytest.fixture(scope="module")
def setup():
    seeds = np.asarray(make_seed_schedule(N_SEEDS, 7))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), TOKENS, D))
                        for s in seeds})
    return dict(seeds=seeds, table=table,
                params=j_init(jax.random.PRNGKey(0), D, L),
                gqa=j_init(jax.random.PRNGKey(3), D, L, kv_dim=D // 2))


def _leaves(p):
    if isinstance(p, TransformerParams):
        return [t for _, t in p.named_leaves()]
    return list(p)


def _close(got, want, **tol):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


@functools.lru_cache(maxsize=None)
def _j_vjp(attn):
    ja = j_resolve_attn(attn)

    def grads(p, x, dy):
        return jax.vjp(lambda q: j_fwd(q, x, H, True, ja), p)[1](dy)[0]

    return jax.jit(grads)


def _batch(table, seed):
    return (jnp.asarray(t.numpy()).reshape(TOKENS // SEQ, SEQ, D)
            for t in table(seed, TOKENS, D))


def _oracle_grads(params, table, seeds, attn=None):
    """The sum over ``seeds`` of each batch's VJP at its ``dloss_dx``."""
    total = None
    for s in seeds:
        g = [np.asarray(a) for a in _j_vjp(attn)(params, *_batch(table, s))]
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return total


def _oracle(params, table, seeds, n, attn=None):
    """JAX's DDP written out: each step the summed gradients of the ``n``
    ranks' strided seeds, then SGD in numpy."""
    p = params
    for t in range(len(seeds) // n):
        g = _oracle_grads(p, table, seeds[t * n:(t + 1) * n], attn)
        p = type(params)(*(np.asarray(a) - np.float32(LR) * b
                           for a, b in zip(p, g)))
    return p


def _unshard_rows(outs, mesh, i):
    return transformer.tp_unshard([o[i] for r, o in enumerate(outs)
                                   if mesh.coords(r)[DATA_AXIS] == 0])


@pytest.fixture(scope="module")
def runs(setup):
    """One launch on 2 gloo ranks: DDP and FSDP under each attention, with
    GQA (4 heads on 2 KV heads), one step of each at lr 1 (the first
    step's summed gradient), and a traced FSDP and DDP step; one launch
    on 4 ranks: DDP and FSDP; one on {data 2, model 2}: the hybrid under
    each attention, one step at lr 1, and a traced step."""
    seeds, table = setup["seeds"], setup["table"]
    start = transformer_params_from_numpy(setup["params"])
    gqa = transformer_params_from_numpy(setup["gqa"])
    kw = dict(lr=LR, seq_len=SEQ, n_heads=H, batch_fn=table)
    trainers = dict(ddp=train_transformer_ddp, fsdp=train_transformer_fsdp,
                    hybrid=train_transformer_hybrid)
    keys2 = ([(k, a) for k in ("ddp", "fsdp") for a in ATTNS]
             + [(k, "gqa") for k in ("ddp", "fsdp")]
             + [(k, "step") for k in ("ddp", "fsdp")])

    def call(kind, case):
        p = gqa if case == "gqa" else start
        k = dict(kw, attn_impl="flash" if case in ("gqa", "step") else case)
        s = seeds
        if case == "step":
            k["lr"], s = 1.0, seeds[:2]
        return (trainers[kind], (p, s, TOKENS, D, MESH), k)

    calls = [call(*k) for k in keys2]
    calls += [(torch_dp_ranks.traced, (trainers[k], start, seeds[:2], TOKENS,
                                       D, MESH), dict(kw, attn_impl="flash"))
              for k in ("fsdp", "ddp")]
    outs = launch(call_each, make_mesh({DATA_AXIS: 2}, device="cpu"), calls,
                  timeout=300)
    got = {}
    for i, (kind, case) in enumerate(keys2):
        got[kind, case, 2] = (outs[0][i] if kind == "ddp" else
                              transformer.fsdp_unshard([o[i] for o in outs]))
    got["traces"] = {k: [o[len(keys2) + j][1] for o in outs]
                     for j, k in enumerate(("fsdp", "ddp"))}

    calls = [(trainers[k], (start, seeds, TOKENS, D, MESH), kw)
             for k in ("ddp", "fsdp")]
    outs = launch(call_each, make_mesh({DATA_AXIS: 4}, device="cpu"), calls,
                  timeout=300)
    got["ddp", None, 4] = outs[0][0]
    got["fsdp", None, 4] = transformer.fsdp_unshard([o[1] for o in outs])

    mesh = make_mesh({DATA_AXIS: 2, MODEL_AXIS: 2}, device="cpu")
    calls = [call("hybrid", a) for a in ATTNS + ("step",)]
    calls.append((torch_dp_ranks.traced, (train_transformer_hybrid, start,
                                          seeds[:2], TOKENS, D, MESH),
                  dict(kw, attn_impl="flash")))
    outs = launch(call_each, mesh, calls, timeout=300)
    for i, case in enumerate(ATTNS + ("step",)):
        got["hybrid", case, 2] = _unshard_rows(outs, mesh, i)
    got["traces"]["hybrid"] = [o[-1][1] for o in outs]
    return got


@pytest.mark.parametrize("kind", ["ddp", "fsdp", "hybrid"])
@pytest.mark.parametrize("attn", ATTNS, ids=ATTN_IDS)
def test_matches_summed_grad_oracle(setup, runs, kind, attn):
    """DDP, FSDP and the hybrid (on {data 2, model 2}) over 2 data ranks,
    4 steps, against the oracle (rtol 2e-4, atol 1e-6), every leaf
    moved."""
    got = runs[kind, attn, 2]
    _close(got, _oracle(setup["params"], setup["table"], setup["seeds"], 2,
                        attn))
    for g, b in zip(_leaves(got), setup["params"]):
        assert float(np.abs(np.asarray(g) - np.asarray(b)).max()) > 1e-5


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_four_ranks_match_summed_grad_oracle(setup, runs, kind):
    """DDP and FSDP on 4 ranks (each leaf's dim 1 in 4 shards under FSDP),
    2 steps, against the oracle (rtol 2e-4, atol 1e-6)."""
    _close(runs[kind, None, 4], _oracle(setup["params"], setup["table"],
                                        setup["seeds"], 4))


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_gqa_matches_summed_grad_oracle(setup, runs, kind):
    """4 query heads on 2 KV heads (``wk``, ``wv`` of 16 rows, 8 a FSDP
    shard) under flash against the oracle (rtol 2e-4, atol 1e-6)."""
    _close(runs[kind, "gqa", 2], _oracle(setup["gqa"], setup["table"],
                                         setup["seeds"], 2, "flash"))


@pytest.mark.parametrize("kind", ["ddp", "fsdp", "hybrid"])
def test_first_step_grads_match_oracle_leaf_by_leaf(setup, runs, kind):
    """One step at lr 1 from the start is minus the summed gradient of
    the 2 data ranks' batches, each leaf within rtol 1e-4, atol 1e-7 of
    the oracle's: a leaf reduced once too often is off by a factor of 2."""
    start = setup["params"]
    want = _oracle_grads(start, setup["table"], setup["seeds"][:2], "flash")
    for g, p, w in zip(_leaves(runs[kind, "step", 2]), start, want):
        np.testing.assert_allclose(np.asarray(p) - g.numpy(), w, rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("attn", ATTNS, ids=ATTN_IDS)
def test_ddp_equals_fsdp_and_hybrid_equals_ddp(runs, attn):
    """DDP and FSDP apply the same summed gradients (rtol 1e-6, atol
    1e-8); the hybrid takes DDP's seeds on its data axis and splits the
    heads' and features' sums over its model axis (rtol 2e-4, atol
    1e-6)."""
    _close(runs["ddp", attn, 2], runs["fsdp", attn, 2], **EXACT)
    _close(runs["hybrid", attn, 2], runs["ddp", attn, 2])


@pytest.mark.parametrize("attn", ATTNS, ids=ATTN_IDS)
def test_ddp_on_one_rank_is_single(setup, attn):
    """DDP on one rank (a loopback CPU thread) is
    ``train_transformer_single`` (rtol 1e-6, atol 1e-8)."""
    start = transformer_params_from_numpy(setup["params"])
    kw = dict(lr=LR, seq_len=SEQ, n_heads=H, batch_fn=setup["table"],
              attn_impl=attn)
    got = train_transformer_ddp(start, setup["seeds"], TOKENS, D,
                                Mesh({DATA_AXIS: 1}, "cpu", loopback=True),
                                **kw)
    _close(got, train_transformer_single(start, setup["seeds"], TOKENS, D,
                                         **kw), **EXACT)


def test_collectives_run_from_the_rank_thread(runs):
    """The traced steps: FSDP gathers each layer's 8 shards in the forward
    and, layer by layer from the top, again in the backward, each time
    reduce-scattering that layer's 8 gradients; DDP all-reduces each of
    the 8 stacked gradients once; the hybrid runs TP's all-reduce a
    sublayer a direction (4 a layer on the model axis) and then the 8
    data-axis sums. All f32, and none inside an autograd backward
    node."""
    traces = runs["traces"]
    for trace in traces["fsdp"]:
        assert [op for op, *_ in trace] == (
            ["all_gather"] * (L * 8)
            + (["all_gather"] * 8 + ["reduce_scatter"] * 8) * L)
    for trace in traces["ddp"]:
        assert [op for op, *_ in trace] == ["all_reduce"] * 8
    for trace in traces["hybrid"]:
        assert [op for op, *_ in trace] == ["all_reduce"] * (4 * L + 8)
    for trace in sum(traces.values(), []):
        assert {d for _, d, _, _ in trace} == {"float32"}
        assert not any(b for *_, b in trace)


def test_single_mixed_matches_jax(setup):
    """``train_transformer_single(mixed=True)``, 2 steps, against JAX's
    run op by op (``jax.disable_jit``; rtol 2e-4, atol 1e-6, the LM mixed
    trainer's pin in ``test_torch_mixed``): the blocks in bf16 over f32
    master params. It differs from the f32 run, and its params stay
    f32."""
    start = transformer_params_from_numpy(setup["params"])
    seeds = setup["seeds"][:2]
    kw = dict(lr=LR, seq_len=SEQ, n_heads=H)
    with jax.disable_jit():
        want = j_single(setup["params"], jnp.asarray(seeds), TOKENS, D,
                        mixed=True, **kw)
    got = train_transformer_single(start, seeds, TOKENS, D, mixed=True,
                                   batch_fn=setup["table"], **kw)
    assert all(t.dtype == torch.float32 for t in _leaves(got))
    _close(got, want)
    f32 = train_transformer_single(start, seeds, TOKENS, D,
                                   batch_fn=setup["table"], **kw)
    assert not np.allclose(got.w1.numpy(), f32.w1.numpy(), rtol=1e-4,
                           atol=1e-6)


def test_refusals_before_anything_is_spawned(setup):
    start = transformer_params_from_numpy(setup["params"])
    seeds = setup["seeds"]
    kw = dict(seq_len=SEQ, n_heads=H)
    with pytest.raises(ValueError, match="ln1 dim 32 not divisible by 3 "
                                         "shards"):
        train_transformer_fsdp(start, seeds[:6], TOKENS, D,
                               make_mesh({DATA_AXIS: 3}, device="cpu"), **kw)
    gqa = transformer_params_from_numpy(j_init(jax.random.PRNGKey(3), D, L,
                                               kv_dim=8))
    with pytest.raises(ValueError, match="wk dim 8 not divisible by 16 "
                                         "shards"):
        train_transformer_fsdp(gqa, np.arange(16), TOKENS, D,
                               Mesh({DATA_AXIS: 16}, "cpu"), **kw)
    with pytest.raises(ValueError, match="n_heads=4 not divisible"):
        train_transformer_hybrid(start, seeds, TOKENS, D,
                                 make_mesh({DATA_AXIS: 1, MODEL_AXIS: 3},
                                           device="cpu"), **kw)
    with pytest.raises(ValueError, match=r"needs \['model'\]"):
        train_transformer_hybrid(start, seeds, TOKENS, D,
                                 make_mesh({DATA_AXIS: 2}, device="cpu"),
                                 **kw)
    with pytest.raises(ValueError, match=r"needs \['data'\]"):
        train_transformer_ddp(start, seeds, TOKENS, D,
                              make_mesh({MODEL_AXIS: 2}, device="cpu"), **kw)
    with pytest.raises(ValueError, match="tokens 100 not divisible"):
        train_transformer_fsdp(start, seeds, 100, D,
                               make_mesh({DATA_AXIS: 2}, device="cpu"), **kw)
