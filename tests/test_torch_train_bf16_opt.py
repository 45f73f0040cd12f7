"""The port's trainers on ``--dtype bfloat16`` params under the optimizer
options (momentum, clipping, ``mixed``, ZeRO-1) against the JAX
package's, on the CPU.

The FFN stack: JAX's bf16 ``init_ffn_stack(PRNGKey(0), 32, 2)`` on JAX's
f32 batches (both sides round them to bf16), 32 tokens a rank a step,
8 global seeds on four gloo ranks (one spawn for every DDP and FSDP
run, JAX's on the conftest ``mesh4``; ZeRO-1 on two, whole layers a
rank), lr 0.1.
Tolerance is in bf16 steps of the weights, as ``test_torch_train_bf16.py``
sets it out: under the ring transport both sides add the same bf16
gradients in the same ring order, within 2 steps in at most 2% of the
weights; gloo's and ZeRO-1's sums round every add in their own order
where XLA's CPU all-reduce sums bf16 in f32, within 2 steps in at most
10%; TP and the hybrid under ``mixed`` (bf16 partial products summed
over the ranks) within 2 steps in at most 25%. Every run moved most
weights.

The LM and the transformer trunk on one device under ``mixed`` with
bf16 params: against JAX's ``train_lm_single`` and
``train_transformer_single`` run op by op (``jax.disable_jit``), within
2 steps in at most 2% of each leaf. JAX's multi-rank LM trainers cannot
run here (ROADMAP Queue 3, the vma fault), so the port's LM DDP under
``mixed`` is held against its own single-device gradients: two loopback
CPU ranks equal ``lm_grads`` of each rank's batch, summed in rank order
and applied by ``sgd``, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu import optim as j_optim
from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import lm_batch_from_seed
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import (init_ffn_stack, init_lm,
                                                     init_transformer)
from distributed_llm_code_samples_tpu.parallel import make_mesh as j_mesh
from distributed_llm_code_samples_tpu.parallel import train_ddp as j_ddp
from distributed_llm_code_samples_tpu.parallel import train_fsdp as j_fsdp
from distributed_llm_code_samples_tpu.parallel import train_hybrid as j_hybrid
from distributed_llm_code_samples_tpu.parallel import train_tp as j_tp
from distributed_llm_code_samples_tpu.parallel import (
    train_ddp_zero1 as j_zero1)
from distributed_llm_code_samples_tpu.parallel import (
    train_lm_single as j_lm_single)
from distributed_llm_code_samples_tpu.parallel import (
    train_transformer_single as j_tf_single)
from distributed_llm_code_samples_tpu_torch import optim
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy, lm_params_from_numpy,
    transformer_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, Mesh, hybrid, launch, make_mesh, train_ddp,
    train_fsdp, train_hybrid, train_lm_ddp, train_lm_single, train_tp,
    train_transformer_single, unshard_params, unshard_tp_params)
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)
from distributed_llm_code_samples_tpu_torch.parallel.lm import (
    lm_grads, resolve_head)
from distributed_llm_code_samples_tpu_torch.parallel.transformer import (
    resolve_attn)
from distributed_llm_code_samples_tpu_torch.parallel.zero1 import (
    train_ddp_zero1)

from torch_serve_refs import one_thread  # noqa: F401

BF = jnp.bfloat16
D, L, TOKENS, LR, N = 32, 2, 32, 0.1, 4


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a).astype(jnp.float32)))


def weight_steps(got, want):
    """``(max |got - want| in bf16 steps, share of weights that
    differ)``: an element's step at the larger of its two magnitudes and
    ``want``'s RMS (``test_torch_train_bf16.py``)."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    rms = np.sqrt(np.mean(w ** 2))
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), rms))
    return (float((np.abs(g - w) / np.ldexp(1.0, e - 8)).max()),
            float((g != w).mean()))


def _within(got, want, most, share, start=None):
    for g, w in zip(optim.leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.bfloat16
        steps, differ = weight_steps(g, w)
        assert steps <= most and differ <= share, (steps, differ)
    if start is not None:
        for g, s in zip(optim.leaves(got), optim.leaves(start)):
            assert (g != s).float().mean() > 0.5     # the run moved them


@pytest.fixture(scope="module")
def setup():
    params = init_ffn_stack(jax.random.PRNGKey(0), D, L, dtype=BF)
    seeds = np.asarray(make_seed_schedule(2 * N, 7))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), TOKENS, D))
                        for s in seeds})
    return params, seeds, table, ffn_params_from_numpy(params)


# (label, port trainer, port kwargs, JAX trainer, JAX kwargs, lr, most,
# share): the data-parallel runs on four ranks
DP = [
    ("ddp-momentum-ring", train_ddp, dict(optimizer=optim.momentum(),
                                          comm="pallas_ring"),
     j_ddp, dict(optimizer=j_optim.momentum(), comm="pallas_ring"), LR,
     2, 0.02),
    ("ddp-clipped-momentum", train_ddp, dict(
        optimizer=optim.clipped(optim.momentum(), 1.0)), j_ddp, dict(
        optimizer=j_optim.clipped(j_optim.momentum(), 1.0)), LR, 2, 0.1),
    ("fsdp-clipped-momentum-ring", train_fsdp, dict(
        optimizer=optim.clipped(optim.momentum(), 0.5, axis=DATA_AXIS),
        comm="pallas_ring"), j_fsdp, dict(
        optimizer=j_optim.clipped(j_optim.momentum(), 0.5, axis="data"),
        comm="pallas_ring"), LR, 2, 0.02),
    ("ddp-mixed-ring", train_ddp, dict(mixed=True, comm="pallas_ring"),
     j_ddp, dict(mixed=True, comm="pallas_ring"), LR, 2, 0.02),
    ("fsdp-mixed-clipped-momentum", train_fsdp, dict(
        mixed=True, optimizer=optim.clipped(optim.momentum(), 1.0,
                                            axis=DATA_AXIS)), j_fsdp, dict(
        mixed=True, optimizer=j_optim.clipped(j_optim.momentum(), 1.0,
                                              axis="data")), LR, 2, 0.1),
    ("zero1-momentum", train_ddp_zero1, dict(optimizer=optim.momentum()),
     j_zero1, dict(optimizer=j_optim.momentum()), LR, 2, 0.1),
    ("zero1-clipped-sgd-mixed", train_ddp_zero1, dict(
        mixed=True, optimizer=optim.clipped(optim.sgd_optimizer(), 1.0,
                                            axis=DATA_AXIS)), j_zero1, dict(
        mixed=True, optimizer=j_optim.clipped(j_optim.sgd_optimizer(), 1.0,
                                              axis="data")), LR, 2, 0.1),
]


def _ranks(fn):
    return 2 if fn is train_ddp_zero1 else N


@pytest.fixture(scope="module")
def dp_runs(setup):
    _, seeds, table, start = setup
    got = {}
    for n in (N, 2):
        runs = [d for d in DP if _ranks(d[1]) == n]
        calls = [(fn, (start, seeds, TOKENS, D, MESH),
                  dict(kw, lr=lr, batch_fn=table))
                 for _, fn, kw, _, _, lr, _, _ in runs]
        outs = launch(call_each, make_mesh({DATA_AXIS: n}, device="cpu"),
                      calls, timeout=300)
        for i, (label, fn, *_) in enumerate(runs):
            per_rank = [o[i] for o in outs]
            got[label] = (unshard_params(per_rank) if fn is train_fsdp
                          else per_rank[0])
    return got


@pytest.mark.parametrize("label,fn,kw,j_fn,j_kw,lr,most,share", DP,
                         ids=[d[0] for d in DP])
def test_dp_on_bf16_matches_jax(mesh4, setup, dp_runs, label, fn, kw, j_fn,
                                j_kw, lr, most, share):
    params, seeds, _, start = setup
    mesh = mesh4 if _ranks(fn) == N else j_mesh({"data": 2})
    want = j_fn(params, jnp.asarray(seeds), TOKENS, D, mesh, lr=lr, **j_kw)
    _within(dp_runs[label], want, most, share, start)


@pytest.fixture(scope="module")
def tp_runs(setup):
    _, seeds, table, start = setup
    kw = dict(lr=LR, batch_fn=table, mixed=True)
    tp = launch(call_each, make_mesh({MODEL_AXIS: N}, device="cpu"),
                [(train_tp, (start, seeds[:4], TOKENS, D, MESH), kw)],
                timeout=240)
    axes = {DATA_AXIS: 2, MODEL_AXIS: 2}
    hy = launch(call_each, make_mesh(axes, device="cpu"),
                [(train_hybrid, (start, seeds[:4], TOKENS, D, MESH), kw)],
                timeout=240)
    return (unshard_tp_params([o[0] for o in tp]),
            hybrid.unshard_params([o[0] for o in hy],
                                  make_mesh(axes, device="cpu")))


def test_tp_mixed_on_bf16_matches_jax(mesh_model4, setup, tp_runs):
    params, seeds, _, start = setup
    want = j_tp(params, jnp.asarray(seeds[:4]), TOKENS, D, mesh_model4,
                lr=LR, mixed=True)
    _within(tp_runs[0], want, 2, 0.25, start)


def test_hybrid_mixed_on_bf16_matches_jax(setup, tp_runs):
    params, seeds, _, start = setup
    want = j_hybrid(params, jnp.asarray(seeds[:4]), TOKENS, D,
                    j_mesh({"data": 2, "model": 2}), lr=LR, mixed=True)
    _within(tp_runs[1], want, 2, 0.25, start)


# -- the LM and the transformer trunk under mixed, bf16 params --------------

V, LD, LL, H, SEQ = 64, 32, 2, 4, 8
LM_TOKENS = 2 * SEQ


def _lm_batch(seed):
    toks, tgts = lm_batch_from_seed(jnp.int32(seed), LM_TOKENS // SEQ, SEQ,
                                    V)
    return (torch.from_numpy(np.array(toks)).long(),
            torch.from_numpy(np.array(tgts)).long())


@pytest.fixture(scope="module")
def lm_setup():
    return (init_lm(jax.random.PRNGKey(0), V, LD, LL, SEQ, n_heads=H,
                    dtype=BF),
            np.asarray(make_seed_schedule(4, random_seed=9)))


@pytest.mark.parametrize("attn_impl", [None, "flash"],
                         ids=["oracle", "flash"])
def test_lm_single_mixed_on_bf16_matches_jax(one_thread, lm_setup,
                                             attn_impl):
    """Two steps under ``mixed`` on bf16 params, the oracle head, the
    oracle attention or the flash kernels (their plain versions; JAX's
    Pallas kernels in interpret mode); then the fused head's plain
    version against the oracle head on the port's own flash run (JAX's
    fused head cannot take the bf16 ``wte``, ROADMAP Queue 3)."""
    params, seeds = lm_setup
    kw = dict(lr=LR, seq_len=SEQ, n_heads=H, mixed=True)
    with jax.disable_jit():
        want = j_lm_single(params, jnp.asarray(seeds[:2]), LM_TOKENS, LD,
                           attn_impl=attn_impl, **kw)
    start = lm_params_from_numpy(params)
    got = train_lm_single(start, seeds[:2], LM_TOKENS, LD,
                          attn_impl=attn_impl, batch_fn=_lm_batch, **kw)
    _within(got, want, 2, 0.02)
    if attn_impl == "flash":
        fused = train_lm_single(start, seeds[:2], LM_TOKENS, LD,
                                attn_impl=attn_impl, head_impl="fused",
                                batch_fn=_lm_batch, **kw)
        _within(fused, [t.numpy() if t.dtype != torch.bfloat16 else
                        jnp.asarray(t.float().numpy()).astype(BF)
                        for t in optim.leaves(got)], 2, 0.02)


def test_transformer_single_mixed_on_bf16_matches_jax(one_thread):
    params = init_transformer(jax.random.PRNGKey(2), LD, LL, dtype=BF)
    seeds = np.asarray(make_seed_schedule(2, 5))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), LM_TOKENS, LD))
                        for s in seeds})
    kw = dict(lr=LR, seq_len=SEQ, n_heads=H, mixed=True)
    with jax.disable_jit():
        want = j_tf_single(params, jnp.asarray(seeds), LM_TOKENS, LD, **kw)
    got = train_transformer_single(transformer_params_from_numpy(params),
                                   seeds, LM_TOKENS, LD, batch_fn=table,
                                   **kw)
    _within(got, want, 2, 0.02)


def test_lm_ddp_mixed_on_bf16_is_its_single_device_sum(one_thread,
                                                       lm_setup):
    params, seeds = lm_setup
    start = lm_params_from_numpy(params)
    kw = dict(seq_len=SEQ, n_heads=H, mixed=True, batch_fn=_lm_batch)

    def body(me, _):
        return train_lm_ddp(start, seeds, LM_TOKENS, LD, me, LR, **kw)

    got = launch(body, Mesh({DATA_AXIS: 2}, "cpu", loopback=True),
                 timeout=120)[0]
    cur = lm_params_from_numpy(params)
    for t in range(len(seeds) // 2):
        per_rank = [lm_grads(cur, *_lm_batch(int(seeds[2 * t + r])), H,
                             resolve_attn(None), resolve_head(None),
                             mixed=True)[1] for r in range(2)]
        total = [a.clone().add_(b) for a, b in zip(*per_rank)]
        optim.sgd(optim.leaves(cur), total, LR)
    for g, w in zip(optim.leaves(got), optim.leaves(cur)):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
