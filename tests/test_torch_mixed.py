"""The bf16 ``mixed`` policy of the port against the JAX package's, on the
CPU: the FFN strategies (single, DDP and FSDP under both transports,
ZeRO-1, TP, TP-SP and the hybrid), FSDP's bf16 gathers, the flash
kernels' plain versions on bf16 storage, and the LM's bf16 trunk.

The FFN strategies, as ``test_mixed.py`` sets them up: d 64, 3 layers (4
for ZeRO-1, whose layers split over the ranks), 32 tokens a rank a step,
the 8 seeds of ``make_seed_schedule(8, 7)``, on four gloo ranks (the
hybrid on 2 x 2), the port on the JAX batches (``BatchTable``). The LRs
move the weights by at least 10 times the atol below (at
``test_mixed.py``'s 0.1 SGD moves them by 2e-4): 10 for SGD and momentum
over the 2 steps a data-parallel rank takes, 1 for the 8 steps of the
single-device and TP runs (from 3 on, the bf16 runs of both frameworks
drift apart as the weights grow), and 1e-2 for AdamW. Each run is held
against JAX's run of the same strategy with ``mixed=True`` within rtol
2e-2, atol 1e-4: the blocks round the same operands to bf16 in both, but the
frameworks' f32 sums run in other orders, and a sum that moves across a
bf16 rounding boundary changes that operand by one bf16 step (0.4%) in
the next product.

The LM (vocab 128, d 32, 2 layers, 4 heads, 2 sequences of 16 a step,
LR 0.1): the gradients of ``lm_loss(mixed=True)``, and two steps of
``train_lm_single(mixed=True)``, match JAX's run op by op
(``jax.disable_jit``) within rtol 2e-4, atol 1e-6 (the f32 LM's
tolerance, ``test_torch_train_lm``) under every attention x head policy:
the port's bf16 trunk rounds where JAX's rounds. (Compiled, XLA keeps
some bf16 intermediates of a fusion in f32, which moves a few values by
a bf16 step.) With AdamW all but 0.5% of the elements are held so, and
every element within two LRs: Adam divides by the root of the second
moment, so a gradient that cancels to near zero moves by a different
fraction of the LR. Over four steps a param drift of one f32 ulp can
cross a bf16 boundary in the next step's cast, so those runs are held to
JAX's bracket against f32 (rtol 0.1, atol 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu import optim as j_optim
from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import (
    lm_batch_from_seed as j_lm_batch)
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack, init_lm
from distributed_llm_code_samples_tpu.ops import pallas_attention as j_fa
from distributed_llm_code_samples_tpu.parallel import make_mesh as j_mesh
from distributed_llm_code_samples_tpu.parallel import (
    train_ddp as j_ddp, train_ddp_zero1 as j_zero1, train_fsdp as j_fsdp,
    train_hybrid as j_hybrid, train_lm_single as j_train_lm,
    train_single as j_single, train_tp as j_tp, train_tp_sp as j_tp_sp)
from distributed_llm_code_samples_tpu_torch import optim
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy, lm_leaves, lm_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import flash_attention as fa
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, launch, lm_grads, make_mesh, resolve_attn,
    resolve_head, train_ddp, train_fsdp, train_hybrid, train_lm_single,
    train_single, train_tp, train_tp_sp, unshard_params, unshard_tp_params)
from distributed_llm_code_samples_tpu_torch.parallel import fsdp, hybrid
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)
from distributed_llm_code_samples_tpu_torch.parallel.zero1 import (
    train_ddp_zero1)

D, L, B, S, N = 64, 3, 32, 8, 4
# 2 steps a rank: DDP, FSDP, ZeRO-1; 8 steps: single, TP (4: the hybrid)
LR, LONG_LR, ADAMW_LR = 10.0, 1.0, 1e-2
TOL = dict(rtol=2e-2, atol=1e-4)


def _table(seeds):
    return BatchTable({int(s): tuple(np.asarray(a) for a in
                                     j_batch(jnp.int32(s), B, D))
                       for s in seeds})


@pytest.fixture(scope="module")
def setup():
    seeds = np.asarray(make_seed_schedule(S, random_seed=7))
    params = {L: init_ffn_stack(jax.random.PRNGKey(42), D, L),
              4: init_ffn_stack(jax.random.PRNGKey(43), D, 4)}
    return params, seeds, _table(seeds)


def _gathered_dtypes(mesh, params, seeds, batch_fn, comm):
    """One FSDP ``mixed`` step in a rank, recording the dtype of every
    gathered weight and every reduce-scattered gradient."""
    seen = {"gather": set(), "scatter": set()}
    gather, scatter = fsdp.all_gather, fsdp.reduce_scatter
    ring_gather, ring_scatter = fsdp.ring_all_gather, fsdp.ring_reduce_scatter

    def rec(kind, fn):
        def wrapped(t, *a, **kw):
            out = fn(t, *a, **kw)
            seen[kind].add(str(out.dtype))
            return out
        return wrapped

    fsdp.all_gather, fsdp.reduce_scatter = (rec("gather", gather),
                                            rec("scatter", scatter))
    fsdp.ring_all_gather, fsdp.ring_reduce_scatter = (
        rec("gather", ring_gather), rec("scatter", ring_scatter))
    try:
        train_fsdp(params, seeds[:N], B, D, mesh, lr=LR, mixed=True,
                   comm=comm, batch_fn=batch_fn)
    finally:
        fsdp.all_gather, fsdp.reduce_scatter = gather, scatter
        fsdp.ring_all_gather, fsdp.ring_reduce_scatter = (ring_gather,
                                                          ring_scatter)
    return {k: sorted(v) for k, v in seen.items()}


# (run id, port trainer, params' layers, port kwargs): the data-parallel
# runs, one launch of four ranks
DATA_RUNS = [
    ("ddp", train_ddp, L, {}),
    ("ddp-ring", train_ddp, L, {"comm": "pallas_ring"}),
    ("ddp-accum", train_ddp, L, {"accum": 2}),
    ("fsdp", train_fsdp, L, {}),
    ("fsdp-ring", train_fsdp, L, {"comm": "pallas_ring"}),
    ("fsdp-adamw-clip", train_fsdp, L, {"comm": "pallas_ring", "optimizer":
                                        "adamw-clip"}),
    ("ddp-adamw-clip", train_ddp, L, {"optimizer": "adamw-clip"}),
    ("zero1-momentum", train_ddp_zero1, 4, {"optimizer": "momentum"}),
    ("ddp-momentum", train_ddp, 4, {"optimizer": "momentum"}),
]


def _lr(run_id):
    return ADAMW_LR if "adamw" in run_id else LR


def _port_opt(name, axis=None):
    if name == "momentum":
        return optim.momentum()
    return optim.clipped(optim.adamw(), 1.0, axis=axis)


def _jax_opt(name):
    if name == "momentum":
        return j_optim.momentum()
    return j_optim.clipped(j_optim.adamw(), 1.0)


@pytest.fixture(scope="module")
def data_runs(setup):
    params, seeds, table = setup
    calls = []
    for run_id, train, layers, kw in DATA_RUNS:
        kw = dict(kw)
        if "optimizer" in kw:
            sharded = train is not train_ddp
            kw["optimizer"] = _port_opt(kw["optimizer"],
                                        DATA_AXIS if sharded else None)
        calls.append((train, (ffn_params_from_numpy(params[layers]), seeds,
                              B, D, MESH),
                      dict(lr=_lr(run_id), mixed=True, batch_fn=table,
                           **kw)))
    for comm in ("psum", "pallas_ring"):
        calls.append((_gathered_dtypes, (MESH, ffn_params_from_numpy(
            params[L]), seeds, table, comm), {}))
    outs = launch(call_each, make_mesh({DATA_AXIS: N}, device="cpu"), calls,
                  timeout=300)
    runs = {}
    for k, (run_id, train, _, _) in enumerate(DATA_RUNS):
        per_rank = [o[k] for o in outs]
        runs[run_id] = (unshard_params(per_rank) if train is train_fsdp
                        else per_rank[0])
    runs["dtypes"] = {c: outs[0][len(DATA_RUNS) + i]
                      for i, c in enumerate(("psum", "pallas_ring"))}
    return runs


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


def _moved(got, start):
    moved = float(np.abs(np.asarray(got.w1) - np.asarray(start.w1)).max())
    assert moved > 10 * TOL["atol"], moved


@pytest.mark.parametrize("run_id,train,layers,kw", DATA_RUNS,
                         ids=[r[0] for r in DATA_RUNS])
def test_data_parallel_mixed_matches_jax(mesh4, setup, data_runs, run_id,
                                         train, layers, kw):
    params, seeds, _ = setup
    jkw = dict(kw)
    if "optimizer" in jkw:
        jkw["optimizer"] = _jax_opt(jkw["optimizer"])
    if run_id.startswith("fsdp") and "comm" in jkw:
        jkw.pop("comm")          # JAX's FSDP ring is held by the psum run
    j_train = {train_ddp: j_ddp, train_fsdp: j_fsdp,
               train_ddp_zero1: j_zero1}[train]
    if "clip" in run_id:
        # the clip over the whole gradient: JAX's DDP (the port's FSDP sums
        # its shards' norms over the data axis to the same norm)
        j_train = j_ddp
        jkw.pop("comm", None)
    want = j_train(params[layers], jnp.asarray(seeds), B, D, mesh4,
                   lr=_lr(run_id), mixed=True, **jkw)
    got = data_runs[run_id]
    _close(got, want)
    _moved(got, params[layers])


@pytest.mark.parametrize("a,b,atol", [
    ("ddp", "fsdp", 1e-7), ("ddp-ring", "fsdp-ring", 1e-7),
    ("ddp-momentum", "zero1-momentum", 1e-7),
    ("ddp-adamw-clip", "fsdp-adamw-clip", 1e-5)])
def test_ddp_mixed_equals_fsdp_mixed(data_runs, a, b, atol):
    """The reference's differential under ``mixed``: the ranks' f32
    gradients are equal, DDP all-reduces them where FSDP reduce-scatters
    (JAX ``test_mixed.py``: rtol 1e-5, atol 1e-7). The clipped AdamW
    pair sums the norm over the shards in another order than over the
    whole gradient, and Adam divides by the root of the second moment:
    it is held within atol 1e-5 (1e-3 of its LR)."""
    _close(data_runs[a], data_runs[b], dict(rtol=1e-5, atol=atol))


@pytest.mark.parametrize("comm", ["psum", "pallas_ring"])
def test_fsdp_gathers_bf16_and_scatters_f32(data_runs, comm):
    """The gathered weights are bf16 (half the bytes of the f32 gathers);
    the gradient reduce-scatter stays f32."""
    assert data_runs["dtypes"][comm] == {"gather": ["torch.bfloat16"],
                                         "scatter": ["torch.float32"]}


def test_single_mixed_matches_jax(setup):
    params, seeds, table = setup
    for kw in ({}, {"accum": 2}, {"remat": False}):
        want = j_single(params[L], jnp.asarray(seeds), B, D, lr=LONG_LR,
                        mixed=True, **kw)
        got = train_single(ffn_params_from_numpy(params[L]), seeds, B, D,
                           lr=LONG_LR, mixed=True, batch_fn=table, **kw)
        _close(got, want)
        _moved(got, params[L])


@pytest.fixture(scope="module")
def tp_runs(setup):
    params, seeds, table = setup
    calls = [(t, (ffn_params_from_numpy(params[L]), seeds, B, D, MESH),
              dict(lr=LONG_LR, mixed=True, batch_fn=table))
             for t in (train_tp, train_tp_sp)]
    outs = launch(call_each, make_mesh({MODEL_AXIS: N}, device="cpu"),
                  calls, timeout=300)
    return {name: unshard_tp_params([o[i] for o in outs])
            for i, name in enumerate(("tp", "tp_sp"))}


@pytest.mark.parametrize("which", ["tp", "tp_sp"])
def test_tp_mixed_matches_jax(mesh_model4, setup, tp_runs, which):
    params, seeds, table = setup
    j_train = {"tp": j_tp, "tp_sp": j_tp_sp}[which]
    _close(tp_runs[which], j_train(params[L], jnp.asarray(seeds), B, D,
                                   mesh_model4, lr=LONG_LR, mixed=True))
    _moved(tp_runs[which], params[L])
    # and the port's single-device mixed run: JAX holds the pair to rtol
    # 1e-4 at LR 0.1; at this LR a sum split over the shards crosses bf16
    # boundaries the one contraction does not, so to the tolerance above
    single = train_single(ffn_params_from_numpy(params[L]), seeds, B, D,
                          lr=LONG_LR, mixed=True, batch_fn=table)
    _close(tp_runs[which], single)


def test_hybrid_mixed_matches_jax(setup):
    params, seeds, table = setup
    axes = {DATA_AXIS: 2, MODEL_AXIS: 2}
    mesh = make_mesh(axes, device="cpu")
    outs = launch(call_each, mesh, [(train_hybrid, (ffn_params_from_numpy(
        params[L]), seeds, B, D, MESH), dict(lr=LONG_LR, mixed=True,
                                             batch_fn=table))], timeout=300)
    got = hybrid.unshard_params([o[0] for o in outs], mesh)
    _close(got, j_hybrid(params[L], jnp.asarray(seeds), B, D, j_mesh(axes),
                         lr=LONG_LR, mixed=True))
    _moved(got, params[L])
    # the hybrid on data 2 is DDP on 2 ranks (JAX test_mixed.py: 1e-4)
    _close(got, j_ddp(params[L], jnp.asarray(seeds), B, D,
                      j_mesh({DATA_AXIS: 2}), lr=LONG_LR, mixed=True),
           dict(rtol=1e-4, atol=1e-6))


# -- flash attention on bf16 storage ------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 40])
def test_flash_bf16_plain_matches_pallas(causal, t):
    """The plain versions on bf16 q, k, v (and dy, y) against JAX's Pallas
    kernels given the same bf16 arrays in interpret mode: y, dq, dk, dv
    come out bf16 and lse f32, as the kernels' ``out_shape``s say, within
    one bf16 step of the outputs' scale (2**-8 relative to the max)."""
    rng = np.random.default_rng(t + causal)
    q, k, v, dy = (rng.standard_normal((t, 32)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, dy))
    jy, jlse = j_fa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                        interpret=True)
    jgrads = j_fa.flash_attention_bwd(jdy, jq, jk, jv, jy, jlse,
                                      causal=causal, interpret=True)
    pq, pk, pv, pdy = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                       .to(torch.bfloat16) for a in (jq, jk, jv, jdy))
    y, lse = fa.flash_attention_fwd(pq, pk, pv, causal=causal)
    assert y.dtype == torch.bfloat16 and lse.dtype == torch.float32
    py = torch.from_numpy(np.asarray(jy.astype(jnp.float32))).bfloat16()
    grads = fa.flash_attention_bwd(pdy, pq, pk, pv, py,
                                   torch.from_numpy(np.asarray(jlse)),
                                   causal=causal)
    for got, want in [(y, jy), (lse, jlse)] + list(zip(grads, jgrads)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        w = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                   atol=2 ** -8 * float(np.abs(w).max()))


def test_flash_refuses_mixed_storage():
    q = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="one storage type"):
        fa.flash_attention_fwd(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="storage type"):
        fa.flash_attention_bwd(q.bfloat16(), q, q, q, q, torch.zeros(8))


# -- the LM's bf16 trunk ------------------------------------------------------

V, LD, LL, H, SEQ, LM_LR = 128, 32, 2, 4, 16, 0.1
LM_TOKENS = 2 * SEQ
POLICIES = [(a, h) for a in (None, "flash") for h in (None, "fused")]


def _lm_batch(seed):
    toks, tgts = j_lm_batch(jnp.int32(seed), LM_TOKENS // SEQ, SEQ, V)
    return (torch.from_numpy(np.array(toks)).long(),
            torch.from_numpy(np.array(tgts)).long())


@pytest.fixture(scope="module")
def lm_setup():
    return (init_lm(jax.random.PRNGKey(0), V, LD, LL, SEQ, n_heads=H),
            np.asarray(make_seed_schedule(4, random_seed=9)))


def _train_port(params, seeds, **kw):
    return train_lm_single(lm_params_from_numpy(params), seeds, LM_TOKENS,
                           LD, seq_len=SEQ, n_heads=H, batch_fn=_lm_batch,
                           **kw)


@pytest.mark.parametrize("attn_impl,head_impl", POLICIES,
                         ids=[f"{a or 'oracle'}-{h or 'oracle'}"
                              for a, h in POLICIES])
def test_lm_mixed_grads_match_jax(lm_setup, attn_impl, head_impl):
    from distributed_llm_code_samples_tpu.models.lm import lm_loss as j_loss
    from distributed_llm_code_samples_tpu.parallel.lm import (
        resolve_head as j_head)
    from distributed_llm_code_samples_tpu.parallel.transformer import (
        resolve_attn as j_attn)
    params, seeds = lm_setup
    toks, tgts = j_lm_batch(jnp.int32(int(seeds[0])), LM_TOKENS // SEQ, SEQ,
                            V)
    j_l, j_g = jax.value_and_grad(j_loss)(params, toks, tgts, H,
                                          j_attn(attn_impl),
                                          j_head(head_impl), True)
    loss, grads = lm_grads(lm_params_from_numpy(params), *_lm_batch(
        int(seeds[0])), H, resolve_attn(attn_impl), resolve_head(head_impl),
        mixed=True)
    np.testing.assert_allclose(float(loss), float(j_l), rtol=1e-6)
    for g, w in zip(grads, jax.tree_util.tree_leaves(j_g)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("attn_impl,head_impl", [(None, None),
                                                 ("flash", "fused")],
                         ids=["oracle-oracle", "flash-fused"])
def test_lm_mixed_trainer_step_matches_jax(lm_setup, attn_impl, head_impl,
                                           opt):
    params, seeds = lm_setup
    lr = LM_LR if opt == "sgd" else 1e-2
    pick = {"sgd": (None, None), "adamw": (optim.adamw(), j_optim.adamw())}
    p_opt, j_opt = pick[opt]
    with jax.disable_jit():
        want = j_train_lm(params, jnp.asarray(seeds[:2]), LM_TOKENS, LD,
                          lr=lr, seq_len=SEQ, n_heads=H, attn_impl=attn_impl,
                          head_impl=head_impl, mixed=True, optimizer=j_opt)
    got = _train_port(params, seeds[:2], lr=lr, attn_impl=attn_impl,
                      head_impl=head_impl, mixed=True, optimizer=p_opt)
    for (name, g), w in zip(got.named_leaves(),
                            jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.float32
        g, w = g.numpy(), np.asarray(w)
        if opt == "sgd":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-6,
                                       err_msg=name)
            continue
        off = ~np.isclose(g, w, rtol=2e-4, atol=1e-6)
        assert off.mean() <= 5e-3, (name, int(off.sum()))
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr, err_msg=name)


@pytest.mark.parametrize("attn_impl,head_impl", [(None, None),
                                                 ("flash", "fused")],
                         ids=["oracle-oracle", "flash-fused"])
def test_lm_mixed_tracks_f32_but_differs(lm_setup, attn_impl, head_impl):
    """JAX ``test_lm_mixed_close_to_f32_but_distinct`` on the port: four
    steps of the bf16 trunk stay within rtol 0.1, atol 2e-3 of the f32
    run and of JAX's mixed run, differ from f32 beyond f32 tolerance, and
    keep f32 params."""
    params, seeds = lm_setup
    kw = dict(lr=LM_LR, attn_impl=attn_impl, head_impl=head_impl)
    mixed = _train_port(params, seeds, mixed=True, **kw)
    f32 = _train_port(params, seeds, **kw)
    want = j_train_lm(params, jnp.asarray(seeds), LM_TOKENS, LD, lr=LM_LR,
                      seq_len=SEQ, n_heads=H, attn_impl=attn_impl,
                      head_impl=head_impl, mixed=True)
    assert mixed.wte.dtype == torch.float32
    for a, b, w in zip(lm_leaves(mixed), lm_leaves(f32),
                       jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.1, atol=2e-3)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0.1,
                                   atol=2e-3)
    assert not np.allclose(mixed.blocks.w1.numpy(), f32.blocks.w1.numpy(),
                           rtol=1e-6, atol=1e-8)


def test_lm_mixed_resumes_with_its_state(lm_setup):
    """Two segments of AdamW under ``mixed``, the second from the first's
    params and state, end where one run ends (bit for bit: the same
    steps)."""
    params, seeds = lm_setup
    kw = dict(lr=1e-2, attn_impl="flash", head_impl="fused", mixed=True,
              optimizer=optim.adamw())
    one, state = _train_port(params, seeds, return_state=True, **kw)
    first, mid = _train_port(params, seeds[:2], return_state=True, **kw)
    two, end = train_lm_single(first, seeds[2:], LM_TOKENS, LD,
                               seq_len=SEQ, n_heads=H, batch_fn=_lm_batch,
                               opt_state=mid, return_state=True, **kw)
    assert int(mid.count) == 2 and int(end.count) == int(state.count) == 4
    for a, b in zip(lm_leaves(one), lm_leaves(two)):
        assert torch.equal(a, b)
