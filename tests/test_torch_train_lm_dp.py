"""The port's data-parallel LM trainers (``train_lm_ddp``,
``train_lm_fsdp``, ``train_lm_hybrid``) against a summed-gradient oracle
built from green JAX pieces, on the CPU.

vocab 64, d 32, 2 layers, 4 heads, sequences of 8, 2 a rank a step (16
tokens), the 8 seeds of ``make_seed_schedule(8, 11)``, lr 0.1: 4 steps
on 2 data ranks, 2 on 4. Both sides start from the JAX ``init_lm``
parameters (``lm_params_from_numpy``) and the port trains on the JAX
batches (a ``TokenTable``). The oracle is JAX's own DDP semantics
written out (JAX's ``test_ddp_matches_summed_grad_oracle``): at step
``t`` rank ``r`` takes ``seeds[t * n + r]``, ``jax.grad`` of the
single-device ``models.lm.lm_loss`` on each rank's batch (flash and the
fused head in interpret mode, as JAX's green
``test_train_lm_single_fused_head_matches_oracle`` runs them), the sum,
then SGD in numpy (or JAX's ``optim`` update). JAX's own DDP, FSDP and
hybrid LM trainers fail on this JAX version (ROADMAP Queue 3), so they
are not run. The port's ranks are gloo processes, many calls a launch
(``call_each``); the port's wrappers run their plain versions.

Tolerances, stated at each test: trained params within rtol 2e-4, atol
1e-6 of the oracle (the TP trainers' tolerance, ``test_torch_train_lm_tp``);
first-step gradients within rtol 1e-4, atol 1e-7; DDP == FSDP and DDP
on one rank == ``train_lm_single`` within rtol 1e-6, atol 1e-8 (the
same gradients, summed in the same order); under AdamW see its test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks
from distributed_llm_code_samples_tpu import optim as j_optim
from distributed_llm_code_samples_tpu.data import (
    lm_batch_from_seed as j_lm_batch)
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu.models.lm import lm_loss as j_lm_loss
from distributed_llm_code_samples_tpu.parallel.lm import (
    resolve_head as j_resolve_head)
from distributed_llm_code_samples_tpu.parallel.transformer import (
    resolve_attn as j_resolve_attn)
from distributed_llm_code_samples_tpu_torch import optim
from distributed_llm_code_samples_tpu_torch.data import TokenTable
from distributed_llm_code_samples_tpu_torch.models import (
    lm_from_leaves, lm_leaves, lm_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.models.lm import lm_hidden
from distributed_llm_code_samples_tpu_torch.ops.xent import xent_loss
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, Mesh, launch, lm_grads, make_mesh, resolve_attn,
    resolve_head, train_lm_ddp, train_lm_fsdp, train_lm_hybrid,
    train_lm_single)
from distributed_llm_code_samples_tpu_torch.parallel import lm as lm_mod
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)

V, D, L, H, SEQ, LR = 64, 32, 2, 4, 8, 0.1
V_ODD = 66                       # 33 vocab rows a rank on 2: not a multiple of 4
TOKENS = 2 * SEQ
N_SEEDS = 8
TOL = dict(rtol=2e-4, atol=1e-6)
EXACT = dict(rtol=1e-6, atol=1e-8)
POLICIES = [(a, h) for h in (None, "fused") for a in (None, "flash")]
IDS = [f"{a or 'oracle'}-{h or 'oracle'}" for a, h in POLICIES]
ADAM_LR = 1e-2


def _table(seeds, vocab=V, skew=False):
    """The JAX batches of ``seeds`` as a ``TokenTable``; ``skew`` folds
    every token and target into the first 4 vocab rows (the wte rows
    both sides of the tied table update)."""
    out = {}
    for s in seeds:
        t, g = (np.asarray(a) for a in j_lm_batch(jnp.int32(s),
                                                  TOKENS // SEQ, SEQ, vocab))
        out[int(s)] = (t % 4, g % 4) if skew else (t, g)
    return TokenTable(out)


@pytest.fixture(scope="module")
def setup():
    seeds = np.asarray(make_seed_schedule(N_SEEDS, random_seed=11))
    params = j_init_lm(jax.random.PRNGKey(2), V, D, L, SEQ, n_heads=H)
    gqa = j_init_lm(jax.random.PRNGKey(5), V, D, L, SEQ, n_heads=H,
                    n_kv_heads=2)
    odd = j_init_lm(jax.random.PRNGKey(7), V_ODD, D, L, SEQ, n_heads=H)
    return dict(seeds=seeds, params=params, gqa=gqa, odd=odd,
                table=_table(seeds), odd_table=_table(seeds, V_ODD),
                skew_table=_table(seeds, skew=True))


@functools.lru_cache(maxsize=None)
def _j_grad(attn, head, mixed=False):
    """``jax.grad`` of the single-device ``lm_loss`` under a policy; jitted
    in f32, op by op under ``mixed`` (the frameworks' bf16 trunks round
    alike op by op, ``test_torch_mixed``)."""
    ja, jh = j_resolve_attn(attn), j_resolve_head(head)
    grad = jax.grad(lambda p, t, g: j_lm_loss(p, t, g, H, ja, jh, mixed))
    return grad if mixed else jax.jit(grad)


def _oracle_grads(params, table, seeds, attn=None, head=None, mixed=False):
    """The sum over ``seeds`` of each batch's ``jax.grad``, in numpy."""
    total = None
    for s in seeds:
        t, g = (jnp.asarray(a.numpy()) for a in table(s))
        if mixed:
            with jax.disable_jit():
                grads = _j_grad(attn, head, True)(params, t, g)
        else:
            grads = _j_grad(attn, head)(params, t, g)
        grads = [np.asarray(x) for x in jax.tree_util.tree_leaves(grads)]
        total = grads if total is None else [a + b for a, b in
                                             zip(total, grads)]
    return total


def _oracle(params, table, seeds, n, lr=LR, optimizer=None, **policy):
    """JAX's DDP written out: each step the summed gradients of the ``n``
    ranks' strided seeds, then SGD in numpy or ``optimizer``'s update."""
    p = params
    state = optimizer.init(p) if optimizer is not None else None
    treedef = jax.tree_util.tree_structure(p)
    for t in range(len(seeds) // n):
        g = _oracle_grads(p, table, seeds[t * n:(t + 1) * n], **policy)
        if optimizer is None:
            leaves = [np.asarray(a) - np.float32(lr) * b for a, b in
                      zip(jax.tree_util.tree_leaves(p), g)]
            p = jax.tree_util.tree_unflatten(treedef, leaves)
        else:
            p, state = optimizer.update(
                jax.tree_util.tree_unflatten(
                    treedef, [jnp.asarray(x) for x in g]), state, p, lr)
    return p


def _close(got, want, **tol):
    want = (lm_leaves(want) if isinstance(want, torch.nn.Module)
            else jax.tree_util.tree_leaves(want))
    for g, w in zip(lm_leaves(got), want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


def _moved(got, start):
    for g, b in zip(lm_leaves(got), lm_leaves(start)):
        assert float((g - b).abs().max()) > 1e-5


# the runs of one launch on 2 gloo ranks: (key, trainer, params key,
# table key, keywords)
CALLS2 = ([(("ddp",) + p, train_lm_ddp, "params", "table",
            dict(attn_impl=p[0], head_impl=p[1])) for p in POLICIES]
          + [(("fsdp",) + p, train_lm_fsdp, "params", "table",
              dict(attn_impl=p[0], head_impl=p[1])) for p in POLICIES]
          + [(("ddp", "gqa"), train_lm_ddp, "gqa", "table",
              dict(attn_impl="flash", head_impl="fused")),
             (("fsdp", "gqa"), train_lm_fsdp, "gqa", "table",
              dict(attn_impl="flash", head_impl="fused")),
             (("ddp", "odd"), train_lm_ddp, "odd", "odd_table",
              dict(attn_impl="flash", head_impl="fused")),
             (("fsdp", "odd"), train_lm_fsdp, "odd", "odd_table",
              dict(attn_impl="flash", head_impl="fused")),
             (("ddp", "adamw"), train_lm_ddp, "params", "table",
              dict(optimizer=optim.clipped(optim.adamw(), 1.0), lr=ADAM_LR)),
             (("fsdp", "adamw"), train_lm_fsdp, "params", "table",
              dict(optimizer=optim.clipped(optim.adamw(), 1.0,
                                           axis=DATA_AXIS), lr=ADAM_LR,
                   return_state=True)),
             (("ddp", "mixed"), train_lm_ddp, "params", "table",
              dict(attn_impl="flash", head_impl="fused", mixed=True)),
             (("fsdp", "mixed"), train_lm_fsdp, "params", "table",
              dict(attn_impl="flash", head_impl="fused", mixed=True))])


@pytest.fixture(scope="module")
def runs2(setup):
    """Every ``CALLS2`` run on 2 gloo ranks in one launch, and two traced
    runs (``torch_dp_ranks.traced``): FSDP under mixed and DDP, flash and
    the fused head, one step each. DDP's result is rank 0's replica,
    FSDP's the params joined from the shards."""
    seeds = setup["seeds"]
    starts = {k: lm_params_from_numpy(setup[k])
              for k in ("params", "gqa", "odd")}
    calls = [(fn, (starts[pk], seeds, TOKENS, D, MESH),
              dict(dict(lr=LR, seq_len=SEQ, n_heads=H, batch_fn=setup[tk]),
                   **kw)) for _, fn, pk, tk, kw in CALLS2]
    one = dict(lr=LR, seq_len=SEQ, n_heads=H, batch_fn=setup["table"],
               attn_impl="flash", head_impl="fused")
    calls += [(torch_dp_ranks.traced, (fn, starts["params"], seeds[:2],
                                       TOKENS, D, MESH), dict(one, **kw))
              for fn, kw in ((train_lm_fsdp, dict(mixed=True)),
                             (train_lm_ddp, {}))]
    outs = launch(call_each, make_mesh({DATA_AXIS: 2}, device="cpu"), calls,
                  timeout=300)
    runs = {}
    for i, (key, *_rest) in enumerate(CALLS2):
        if key[0] == "ddp":
            runs[key] = outs[0][i]
        elif key[1] == "adamw":
            runs[key] = lm_mod.lm_fsdp_unshard([o[i][0] for o in outs])
            runs["fsdp-state"] = [o[i][1] for o in outs]
        else:
            runs[key] = lm_mod.lm_fsdp_unshard([o[i] for o in outs])
    runs["traces"] = [[o[len(CALLS2) + j][1] for o in outs]
                      for j in range(2)]
    return runs


@pytest.fixture(scope="module")
def runs4(setup):
    """DDP and FSDP on 4 gloo ranks (2 steps), oracle and kernel
    policies, in one launch."""
    start = lm_params_from_numpy(setup["params"])
    policies = [(None, None), ("flash", "fused")]
    calls = [(fn, (start, setup["seeds"], TOKENS, D, MESH),
              dict(lr=LR, seq_len=SEQ, n_heads=H, batch_fn=setup["table"],
                   attn_impl=a, head_impl=h))
             for fn in (train_lm_ddp, train_lm_fsdp) for a, h in policies]
    outs = launch(call_each, make_mesh({DATA_AXIS: 4}, device="cpu"), calls,
                  timeout=300)
    runs = {}
    for i, (fn, _, kw) in enumerate(calls):
        key = ("ddp" if fn is train_lm_ddp else "fsdp", kw["attn_impl"],
               kw["head_impl"])
        runs[key] = (outs[0][i] if key[0] == "ddp" else
                     lm_mod.lm_fsdp_unshard([o[i] for o in outs]))
    return runs


@pytest.fixture(scope="module")
def hybrid_runs(setup):
    """``train_lm_hybrid`` on a {data 2, model 2} gloo mesh, oracle and
    flash attention, in one launch; the whole params from the model
    ranks of data index 0."""
    start = lm_params_from_numpy(setup["params"])
    calls = [(train_lm_hybrid, (start, setup["seeds"], TOKENS, D, MESH),
              dict(lr=LR, seq_len=SEQ, n_heads=H, batch_fn=setup["table"],
                   attn_impl=a)) for a in (None, "flash")]
    mesh = make_mesh({DATA_AXIS: 2, MODEL_AXIS: 2}, device="cpu")
    outs = launch(call_each, mesh, calls, timeout=300)
    rows = [o for r, o in enumerate(outs) if mesh.coords(r)[DATA_AXIS] == 0]
    return {a: lm_mod.lm_tp_unshard([o[i] for o in rows])
            for i, a in enumerate((None, "flash"))}


# -- against the summed-gradient oracle -------------------------------------------

@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
@pytest.mark.parametrize("attn_impl,head_impl", POLICIES, ids=IDS)
def test_matches_summed_grad_oracle(setup, runs2, kind, attn_impl,
                                    head_impl):
    """DDP and FSDP on 2 ranks, 4 steps, under each attention x head
    policy, against the oracle (rtol 2e-4, atol 1e-6), every leaf moved."""
    want = _oracle(setup["params"], setup["table"], setup["seeds"], 2,
                   attn=attn_impl, head=head_impl)
    got = runs2[kind, attn_impl, head_impl]
    _close(got, want)
    _moved(got, lm_params_from_numpy(setup["params"]))


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
@pytest.mark.parametrize("attn_impl,head_impl", [(None, None),
                                                 ("flash", "fused")],
                         ids=["oracle", "kernels"])
def test_four_ranks_match_summed_grad_oracle(setup, runs4, kind, attn_impl,
                                             head_impl):
    """DDP and FSDP on 4 ranks (each ``wte`` shard 16 rows), 2 steps,
    against the oracle (rtol 2e-4, atol 1e-6)."""
    want = _oracle(setup["params"], setup["table"], setup["seeds"], 4,
                   attn=attn_impl, head=head_impl)
    _close(runs4[kind, attn_impl, head_impl], want)


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
@pytest.mark.parametrize("case", ["gqa", "odd"])
def test_gqa_and_unaligned_vocab_match_oracle(setup, runs2, kind, case):
    """Flash and the fused head with 4 heads on 2 KV heads, and at vocab
    66 (33 ``wte`` rows a FSDP shard), against the oracle (rtol 2e-4,
    atol 1e-6)."""
    table = setup["odd_table" if case == "odd" else "table"]
    want = _oracle(setup[case], table, setup["seeds"], 2, attn="flash",
                   head="fused")
    _close(runs2[kind, case], want)


@pytest.mark.parametrize("attn_impl,head_impl", POLICIES, ids=IDS)
def test_ddp_equals_fsdp(runs2, attn_impl, head_impl):
    """The same gradients, summed in the same order on 2 ranks, applied
    whole or to shards (rtol 1e-6, atol 1e-8)."""
    _close(runs2["ddp", attn_impl, head_impl],
           runs2["fsdp", attn_impl, head_impl], **EXACT)


@pytest.mark.parametrize("attn_impl", [None, "flash"],
                         ids=["oracle", "flash"])
def test_hybrid_matches_ddp_and_oracle(setup, runs2, hybrid_runs,
                                       attn_impl):
    """The hybrid on {data 2, model 2} takes DDP's seeds on its data axis:
    it matches DDP on 2 ranks and the oracle (rtol 2e-4, atol 1e-6; TP
    splits the heads' and the vocab's sums)."""
    got = hybrid_runs[attn_impl]
    _close(got, runs2["ddp", attn_impl, None])
    _close(got, _oracle(setup["params"], setup["table"], setup["seeds"], 2,
                        attn=attn_impl))


@pytest.mark.parametrize("attn_impl,head_impl", [(None, None),
                                                 ("flash", "fused")],
                         ids=["oracle", "kernels"])
def test_ddp_on_one_rank_is_single(setup, attn_impl, head_impl):
    """DDP on one rank (a loopback CPU thread) takes every seed in turn,
    as ``train_lm_single`` does (rtol 1e-6, atol 1e-8)."""
    start = lm_params_from_numpy(setup["params"])
    kw = dict(lr=LR, seq_len=SEQ, n_heads=H, batch_fn=setup["table"],
              attn_impl=attn_impl, head_impl=head_impl)
    got = train_lm_ddp(start, setup["seeds"], TOKENS, D,
                       Mesh({DATA_AXIS: 1}, "cpu", loopback=True), **kw)
    _close(got, train_lm_single(start, setup["seeds"], TOKENS, D, **kw),
           **EXACT)


def test_wte_embedding_side_is_reduced_once(setup):
    """One DDP step at lr 1 on 2 ranks, every token and target in the
    first 4 vocab rows (both sides of the tied ``wte`` large there): the
    step is minus the summed gradient, within rtol 1e-4, atol 1e-7 of the
    oracle's first-step gradient. A second reduction of the embedding
    side would add it once more, and the control shows that this test
    sees that."""
    table = setup["skew_table"]
    start = lm_params_from_numpy(setup["params"])
    got = train_lm_ddp(start, setup["seeds"][:2], TOKENS, D,
                       Mesh({DATA_AXIS: 2}, "cpu", loopback=True), lr=1.0,
                       seq_len=SEQ, n_heads=H, batch_fn=table,
                       attn_impl="flash", head_impl="fused")
    step = [a - b for a, b in zip(lm_leaves(start), lm_leaves(got))]
    want = _oracle_grads(setup["params"], table, setup["seeds"][:2],
                         attn="flash", head="fused")
    for g, w in zip(step, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-7)
    # the embedding side alone: the gradient of the lookup's table, the
    # head's held fixed (the oracle ops)
    emb = torch.zeros_like(start.wte)
    for s in setup["seeds"][:2]:
        tokens, targets = table(s)
        wte_e = start.wte.detach().clone().requires_grad_()
        h = lm_hidden(lm_from_leaves([wte_e] + lm_leaves(start)[1:]),
                      tokens, H)
        loss = xent_loss(h.reshape(-1, D) @ start.wte.T, targets.reshape(-1))
        emb += torch.autograd.grad(loss, wte_e)[0]
    assert float(emb[:4].abs().max()) > 1e3 * 1e-7
    assert not np.allclose(step[0].numpy() + emb.numpy(), want[0], rtol=1e-4,
                           atol=1e-7)


# -- the stateful optimizer --------------------------------------------------------

@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_clipped_adamw_matches_oracle(setup, runs2, kind):
    """DDP and FSDP (its clip summed over the data axis) under AdamW
    clipped at 1.0, 4 steps at lr 1e-2, against the summed gradients fed
    to JAX's ``optim.clipped(adamw(), 1.0)``. Adam divides each gradient
    by its own running scale, so an f32-level difference of a gradient
    sum near zero moves its update by a few percent of the LR: the
    params are held within rtol 2e-4, atol 1e-4 (1% of one step's LR),
    as ``test_torch_train_lm_tp`` holds TP's AdamW."""
    want = _oracle(setup["params"], setup["table"], setup["seeds"], 2,
                   lr=ADAM_LR, optimizer=j_optim.clipped(j_optim.adamw(),
                                                         1.0))
    _close(runs2[kind, "adamw"], want, rtol=2e-4, atol=1e-4)


def test_fsdp_state_lives_on_the_shards(runs2):
    """Each rank's AdamW moments are its shards: ``wte``, ``wpe`` half
    their rows, the blocks half of dim 1, ``ln_f`` half its features."""
    for state in runs2["fsdp-state"]:
        for s in (state.mu, state.nu):
            assert s.wte.shape == (V // 2, D)
            assert s.wpe.shape == (SEQ // 2, D)
            assert s.blocks.w1.shape == (L, 4 * D // 2, D)
            assert s.blocks.ln1.shape == (L, D // 2)
            assert s.ln_f.shape == (D // 2,)
        assert int(state.count) == N_SEEDS // 2


@pytest.mark.parametrize("trainer", [train_lm_ddp, train_lm_fsdp],
                         ids=["ddp", "fsdp"])
def test_segments_resume_as_one_run(setup, trainer):
    """The whole-mesh trainer (2 loopback CPU threads) under clipped
    AdamW in two segments, the state carried whole from one to the next
    (and sharded again by FSDP), ends where one run of 4 steps ends
    (rtol 1e-6, atol 1e-8)."""
    start = lm_params_from_numpy(setup["params"])
    axis = DATA_AXIS if trainer is train_lm_fsdp else None
    kw = dict(lr=ADAM_LR, seq_len=SEQ, n_heads=H, batch_fn=setup["table"],
              optimizer=optim.clipped(optim.adamw(), 1.0, axis=axis))
    mesh = Mesh({DATA_AXIS: 2}, "cpu", loopback=True)
    seeds = setup["seeds"]
    p1, s1 = trainer(start, seeds[:4], TOKENS, D, mesh, return_state=True,
                     **kw)
    assert s1.mu.wte.shape == (V, D)
    p2, s2 = trainer(p1, seeds[4:], TOKENS, D, mesh, opt_state=s1,
                     return_state=True, **kw)
    whole, state = trainer(start, seeds, TOKENS, D, mesh, return_state=True,
                           **kw)
    _close(p2, whole, **EXACT)
    _close(s2.mu, state.mu, **EXACT)
    assert int(s2.count) == int(state.count) == N_SEEDS // 2


# -- mixed ----------------------------------------------------------------------------

def test_ddp_mixed_equals_fsdp_mixed(runs2):
    """Under ``mixed`` the block gradients come back from the bf16 trunk
    in f32 and are summed in f32 by both (rtol 1e-6, atol 1e-8)."""
    _close(runs2["ddp", "mixed"], runs2["fsdp", "mixed"], **EXACT)


def test_mixed_matches_single_mixed_summed(setup, runs2):
    """DDP under ``mixed`` against the port's single-device
    ``lm_grads(mixed=True)`` summed over the ranks' batches and applied
    in SGD (rtol 1e-6, atol 1e-8: the same ops), and its first step's
    summed gradient against JAX's ``lm_loss(mixed=True)`` run op by op
    (rtol 2e-4, atol 1e-6, ``test_torch_mixed``'s pin of the same
    gradients). It also differs from the f32 run."""
    p = lm_params_from_numpy(setup["params"])
    seeds, table = setup["seeds"], setup["table"]
    attn, head = resolve_attn("flash"), resolve_head("fused")
    for t in range(N_SEEDS // 2):
        total = None
        for s in seeds[2 * t:2 * t + 2]:
            g = lm_grads(p, *table(s), H, attn, head, mixed=True)[1]
            total = g if total is None else [a + b for a, b in
                                             zip(total, g)]
        if t == 0:
            want = _oracle_grads(setup["params"], table, seeds[:2],
                                 attn="flash", head="fused", mixed=True)
            for a, w in zip(total, want):
                np.testing.assert_allclose(a.numpy(), w, rtol=2e-4,
                                           atol=1e-6)
        p = lm_from_leaves([a - LR * b for a, b in
                            zip(lm_leaves(p), total)])
    _close(runs2["ddp", "mixed"], p, **EXACT)
    assert not np.allclose(runs2["ddp", "mixed"].wte.numpy(),
                           runs2["ddp", "flash", "fused"].wte.numpy(),
                           rtol=1e-4, atol=1e-6)


def test_fsdp_gathers_and_no_collective_in_a_backward(runs2):
    """The traced FSDP step under ``mixed``: ``wte``, ``wpe`` and ``ln_f``
    gathered once in f32; each layer's 8 block shards gathered in bf16
    in the forward and again in the backward; every gradient
    reduce-scattered once in f32. The traced DDP step: one f32
    all-reduce a leaf. No collective of either ran inside an autograd
    backward node."""
    fsdp, ddp = runs2["traces"]
    for trace in fsdp:
        gathers = [(d, s) for op, d, s, _ in trace if op == "all_gather"]
        assert gathers[:3] == [("float32", (V // 2, D)),
                               ("float32", (SEQ // 2, D)),
                               ("float32", (D // 2,))]
        assert len(gathers) == 3 + 2 * L * 8
        assert {d for d, _ in gathers[3:]} == {"bfloat16"}
        scatters = [d for op, d, _, _ in trace if op == "reduce_scatter"]
        assert scatters == ["float32"] * (3 + L * 8)
        assert {op for op, *_ in trace} == {"all_gather", "reduce_scatter"}
        assert not any(b for *_, b in trace)
    for trace in ddp:
        assert [(op, d) for op, d, _, _ in trace] == \
            [("all_reduce", "float32")] * (3 + 8)
        assert not any(b for *_, b in trace)


def test_fsdp_forward_keeps_block_inputs_only(setup):
    """``fsdp_blocks_forward`` runs each gathered layer outside autograd
    and keeps only the blocks' inputs: nothing it returns holds a graph
    (and with it a gathered layer) for the backward."""
    from distributed_llm_code_samples_tpu_torch.parallel import transformer
    start = lm_params_from_numpy(setup["params"])
    mesh = Mesh({DATA_AXIS: 1}, "cpu", loopback=True)

    def body(me, _):
        shards = transformer.fsdp_shard(start.blocks, me)
        x = torch.randn(2, SEQ, D, generator=torch.Generator().manual_seed(0))
        with torch.enable_grad():
            return transformer.fsdp_blocks_forward(shards, x, H, me)

    y, inputs = launch(body, mesh, timeout=60)[0]
    assert y.grad_fn is None and not y.requires_grad
    assert len(inputs) == L
    assert all(t.grad_fn is None and t.shape == (2, SEQ, D) for t in inputs)


# -- refusals ----------------------------------------------------------------------------

def test_refusals_before_anything_is_spawned(setup):
    start = lm_params_from_numpy(setup["params"])
    seeds = setup["seeds"]
    kw = dict(seq_len=SEQ, n_heads=H)
    data2 = make_mesh({DATA_AXIS: 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="guard"):
        train_lm_ddp(start, seeds, TOKENS, D, data2, guard=object(), **kw)
    odd = lm_params_from_numpy(setup["odd"])
    with pytest.raises(ValueError, match="wte dim 66 not divisible by 4 "
                                         "shards"):
        train_lm_fsdp(odd, seeds, TOKENS, D,
                      make_mesh({DATA_AXIS: 4}, device="cpu"), **kw)
    with pytest.raises(ValueError, match="wpe dim 8 not divisible by 16 "
                                         "shards"):
        train_lm_fsdp(start, np.arange(16), TOKENS, D,
                      Mesh({DATA_AXIS: 16}, "cpu"), **kw)
    gqa1 = lm_params_from_numpy(j_init_lm(jax.random.PRNGKey(5), V, D, L,
                                          2 * SEQ, n_heads=H, n_kv_heads=1))
    with pytest.raises(ValueError, match="blocks.wk dim 8 not divisible by "
                                         "16 shards"):
        train_lm_fsdp(gqa1, np.arange(16), TOKENS, D,
                      Mesh({DATA_AXIS: 16}, "cpu"), **kw)
    with pytest.raises(ValueError, match="vocab=66 not divisible by "
                                         "model-axis size 4"):
        train_lm_hybrid(odd, seeds, TOKENS, D,
                        make_mesh({DATA_AXIS: 1, MODEL_AXIS: 4},
                                  device="cpu"), **kw)
    with pytest.raises(ValueError, match=r"needs \['model'\]"):
        train_lm_hybrid(start, seeds, TOKENS, D, data2, **kw)
    with pytest.raises(ValueError, match="need an optimizer"):
        train_lm_fsdp(start, seeds, TOKENS, D, data2, return_state=True,
                      **kw)
    with pytest.raises(ValueError, match="head_impl"):
        train_lm_ddp(start, seeds, TOKENS, D, data2, head_impl="nope", **kw)
    with pytest.raises(ValueError, match="not divisible"):
        train_lm_ddp(start, seeds[:7], TOKENS, D, data2, **kw)


@pytest.mark.parametrize("rows", [1, 16, 24, 32, 48])
def test_bf16_layernorm_rounds_as_jax_at_any_row_count(rows):
    """The mixed trunk's LayerNorm on bf16 rows of 32 features, forward
    and VJP, bit for bit against JAX's: its ``rsqrt`` runs in f32 and
    rounds once, as XLA's does (torch's CPU bf16 ``rsqrt`` rounded twice
    on the rows past its last full vector, which moved the mixed LM's
    gradients at 16 rows by up to 40%)."""
    from distributed_llm_code_samples_tpu.ops.norm import layernorm as j_ln
    from distributed_llm_code_samples_tpu_torch.ops.norm import layernorm
    rng = np.random.default_rng(rows)
    g, x, dy = (rng.normal(size=s).astype(np.float32)
                for s in ((32,), (rows, 32), (rows, 32)))
    bf = jnp.bfloat16
    want, vjp = jax.vjp(j_ln, *(jnp.asarray(a).astype(bf) for a in (g, x)))
    wants = (want,) + vjp(jnp.asarray(dy).astype(bf))
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in (g, x)]
    got = layernorm(*ts)
    gots = (got,) + torch.autograd.grad(got, ts,
                                        torch.from_numpy(dy).to(torch.bfloat16))
    for a, w in zip(gots, wants):
        np.testing.assert_array_equal(a.detach().float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))
