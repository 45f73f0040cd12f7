"""Megatron TP of the port's LM (``train_lm_tp``), its vocab-parallel
pieces (``vp_embed``, ``vp_xent``, ``vp_head_xent``), ``rope_mha`` and
``cli.py -m 11``, against the JAX package on the CPU.

vocab 384, d 32, 2 layers, 4 heads, 64-token sequences, 2 a step (128
tokens), 3 seeds, lr 0.1; the pad-range cases at vocab 200 (50 rows a
rank on 4 ranks). Both sides start from the JAX ``init_lm`` parameters
(``lm_params_from_numpy``) and the port trains on the JAX batches (a
``TokenTable``). The port's ranks are 4 gloo processes, one launch for
many calls (``call_each``); JAX's are the 4-device ``mesh_model4``. The
JAX kernels run in interpret mode, the port's wrappers their plain
versions.

Tolerances, stated at each test: the vocab-parallel ops within rtol
1e-5 (atol 1e-7 on gradients) of JAX's under ``shard_map``; the fused TP
trainer within JAX's own pin of its fused TP head against the single
device (rtol 2e-3, atol 2e-5, ``test_vp_fused_head_matches_single_device``);
every TP trainer within rtol 2e-4, atol 1e-6 of JAX's and the port's
single-device trainer (``test_torch_train_lm.py``'s tolerance: TP splits
the head's and the blocks' sums over the ranks; under AdamW see its
test); each leaf's first-step gradient within rtol 1e-4, atol 1e-7 of
JAX's ``jax.grad``.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_tp_ranks
from distributed_llm_code_samples_tpu.data import (
    lm_batch_from_seed as j_lm_batch)
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu.models.attention import (
    rope_mha as j_rope_mha)
from distributed_llm_code_samples_tpu.models.lm import lm_loss as j_lm_loss
from distributed_llm_code_samples_tpu.parallel import MODEL_AXIS as J_MODEL
from distributed_llm_code_samples_tpu.parallel import (
    train_lm_single as j_train_lm)
from distributed_llm_code_samples_tpu.parallel.lm import (
    train_lm_tp as j_train_lm_tp)
from distributed_llm_code_samples_tpu.parallel.lm import vp_embed as j_embed
from distributed_llm_code_samples_tpu.parallel.lm import (
    vp_head_xent as j_head_xent)
from distributed_llm_code_samples_tpu.parallel.lm import vp_xent as j_xent
from distributed_llm_code_samples_tpu_torch import cli
from distributed_llm_code_samples_tpu_torch.data import TokenTable
from distributed_llm_code_samples_tpu_torch.models import (
    lm_leaves, lm_params_from_numpy, rope_mha)
from distributed_llm_code_samples_tpu_torch.optim import adamw
from distributed_llm_code_samples_tpu_torch.parallel import (
    MODEL_AXIS, Mesh, launch, make_mesh, train_lm_single, train_lm_tp)
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, call_each)

V, D, L, H, SEQ, LR, N = 384, 32, 2, 4, 64, 0.1, 4
TOKENS = 2 * SEQ
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=1e-6)
POLICIES = [(a, h) for h in (None, "fused") for a in (None, "flash", "rope")]
IDS = [f"{a or 'oracle'}-{h or 'oracle'}" for a, h in POLICIES]


def _table(seeds, vocab=V):
    return TokenTable({int(s): tuple(np.asarray(a) for a in j_lm_batch(
        jnp.int32(s), TOKENS // SEQ, SEQ, vocab)) for s in seeds})


@pytest.fixture(scope="module")
def setup():
    params = j_init_lm(jax.random.PRNGKey(2), V, D, L, SEQ, n_heads=H)
    seeds = np.asarray(make_seed_schedule(3, random_seed=11))
    return params, seeds, _table(seeds)


@pytest.fixture(scope="module")
def gqa_setup():
    """8 heads on 4 KV heads: one KV head of two query heads a rank."""
    params = j_init_lm(jax.random.PRNGKey(5), V, D, L, SEQ, n_heads=8,
                       n_kv_heads=4)
    return params, lm_params_from_numpy(params)


def _close(got, want, **tol):
    for g, w in zip(lm_leaves(got), jax.tree_util.tree_leaves(want)
                    if not isinstance(want, torch.nn.Module)
                    else lm_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


@pytest.fixture(scope="module")
def tp_runs(setup, gqa_setup):
    """One launch on 4 gloo ranks: ``train_lm_tp`` under every attention x
    head policy, under AdamW, with GQA, and AdamW in two resumed
    segments; each rank's shards (and states)."""
    params, seeds, table = setup
    start = lm_params_from_numpy(params)
    kw = dict(lr=LR, seq_len=SEQ, batch_fn=table)
    calls = [(train_lm_tp, (start, seeds, TOKENS, D, MESH),
              dict(kw, n_heads=H, attn_impl=a, head_impl=h))
             for a, h in POLICIES]
    calls.append((train_lm_tp, (start, seeds, TOKENS, D, MESH),
                  dict(kw, n_heads=H, optimizer=adamw(), lr=1e-2)))
    calls.append((train_lm_tp, (gqa_setup[1], seeds, TOKENS, D, MESH),
                  dict(kw, n_heads=8, attn_impl="flash",
                       head_impl="fused")))
    calls.append((train_lm_tp, (start, seeds[:2], TOKENS, D, MESH),
                  dict(kw, n_heads=H, optimizer=adamw(), lr=1e-2,
                       return_state=True)))
    outs = launch(call_each, make_mesh({MODEL_AXIS: N}, device="cpu"),
                  calls, timeout=300)
    from distributed_llm_code_samples_tpu_torch.parallel import lm
    runs = [lm.lm_tp_unshard([o[i] for o in outs])
            for i in range(len(calls) - 1)]
    seg = ([o[-1][0] for o in outs], [o[-1][1] for o in outs])
    return runs, seg


@functools.lru_cache(maxsize=None)
def _j_single(attn, head, opt=False):
    params = j_init_lm(jax.random.PRNGKey(2), V, D, L, SEQ, n_heads=H)
    seeds = make_seed_schedule(3, random_seed=11)
    from distributed_llm_code_samples_tpu.optim import adamw as j_adamw
    extra = dict(optimizer=j_adamw(), lr=1e-2) if opt else dict(lr=LR)
    return j_train_lm(params, jnp.asarray(seeds), TOKENS, D, seq_len=SEQ,
                      n_heads=H, attn_impl=attn, head_impl=head, **extra)


# -- rope -----------------------------------------------------------------------

@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_rope_mha_matches_jax(hkv):
    """Forward and ``jax.vjp`` of ``rope_mha`` over 2 sequences of 4 query
    heads, 16 positions, dh 8 (rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 4, 16, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, hkv, 16, 8)).astype(np.float32)
            for _ in range(2))
    dy = rng.normal(size=q.shape).astype(np.float32)
    jf = jax.vmap(lambda a, b, c: j_rope_mha(a, b, c, True))
    want, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    wants = (want,) + vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = rope_mha(*ts, True)
    gots = (got,) + torch.autograd.grad(got, ts, torch.from_numpy(dy))
    assert rope_mha.supports_gqa
    for g, w in zip(gots, wants):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("head_impl", [None, "fused"])
def test_train_lm_single_rope_matches_jax(setup, head_impl):
    """``train_lm_single(attn_impl="rope")`` against JAX's, 3 steps (rtol
    2e-4, atol 1e-6)."""
    params, seeds, table = setup
    got = train_lm_single(lm_params_from_numpy(params), seeds, TOKENS, D,
                          lr=LR, seq_len=SEQ, n_heads=H, attn_impl="rope",
                          head_impl=head_impl, batch_fn=table)
    _close(got, _j_single("rope", head_impl))


# -- the vocab-parallel pieces --------------------------------------------------

def _vp_inputs(vocab, seed):
    """Inputs of each vocab-parallel op at ``vocab`` rows: the targets
    cover every slice boundary (``r V/n - 1``, ``r V/n``) and, at vocab
    200, the shifted targets that fall in a rank's 4-rounded pad range."""
    rng = np.random.default_rng(seed)
    n_rows, d = 64, 16
    v_local = vocab // N
    edges = np.array([r * v_local + o for r in range(N) for o in (-1, 0)
                      if 0 <= r * v_local + o < vocab])
    targets = np.concatenate([edges, np.arange(n_rows - len(edges)) % vocab
                              + v_local - 2]).astype(np.int32) % vocab
    wte = (0.02 * rng.normal(size=(vocab, d))).astype(np.float32)
    tokens = rng.integers(0, vocab, size=(4, 8)).astype(np.int32)
    dy = rng.normal(size=(4, 8, d)).astype(np.float32)
    logits = rng.normal(size=(n_rows, vocab)).astype(np.float32)
    h = rng.normal(size=(n_rows, d)).astype(np.float32)
    return dict(embed=(wte, tokens, dy), xent=(logits, targets),
                head=(h, wte, targets))


VOCABS = (384, 200)


@pytest.fixture(scope="module")
def vp_runs():
    """The port's ops on 4 gloo ranks, every case in one launch."""
    inputs = [_vp_inputs(v, i) for i, v in enumerate(VOCABS)]
    cases = [(k, case[k]) for case in inputs
             for k in ("embed", "xent", "head")]
    outs = launch(torch_tp_ranks.vp_cases,
                  make_mesh({MODEL_AXIS: N}, device="cpu"), cases,
                  timeout=240)
    return inputs, outs


def _j_vp(mesh, kind, arrays):
    """JAX's op under ``shard_map`` on ``mesh``, forward and backward."""
    sm = functools.partial(jax.shard_map, mesh=mesh)
    if kind == "embed":
        def run(w, t, dy):
            y, vjp = jax.vjp(lambda w: j_embed(w, t, J_MODEL), w)
            return y, vjp(dy)[0]
        return jax.jit(sm(run, in_specs=(P(J_MODEL), P(), P()),
                          out_specs=(P(), P(J_MODEL))))(*arrays)
    if kind == "xent":
        def run(z, t):
            return jax.value_and_grad(lambda z: j_xent(z, t, J_MODEL))(z)
        return jax.jit(sm(run, in_specs=(P(None, J_MODEL), P()),
                          out_specs=(P(), P(None, J_MODEL))))(*arrays)

    # as JAX's own green test runs it: vma off, the kernels interpreted
    def run(h, w, t):
        loss, (dh, dw) = jax.value_and_grad(
            lambda h, w: j_head_xent(h, w, t, J_MODEL, True),
            argnums=(0, 1))(h, w)
        return loss, dh[None], dw
    return jax.jit(sm(run, in_specs=(P(), P(J_MODEL), P()),
                      out_specs=(P(), P(J_MODEL), P(J_MODEL)),
                      check_vma=False))(*arrays)


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("kind", ["embed", "xent", "head"])
def test_vp_op_matches_jax_shard_map(mesh_model4, vp_runs, kind, vocab):
    """Each rank's output and gradients against JAX's under ``shard_map``
    (rtol 1e-5; gradients atol 1e-7); at vocab 200 targets land in the
    pad range of a rank's 50 rows."""
    inputs, outs = vp_runs
    i = VOCABS.index(vocab) * 3 + ("embed", "xent", "head").index(kind)
    arrays = [jnp.asarray(a) for a in inputs[VOCABS.index(vocab)][kind]]
    want = _j_vp(mesh_model4, kind, arrays)
    for r, out in enumerate(o[i] for o in outs):
        got = list(out)
        if kind == "embed":
            np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                       rtol=1e-5)
            wl = np.split(np.asarray(want[1]), N)[r]
            np.testing.assert_allclose(got[1], wl, rtol=1e-5, atol=1e-7)
            continue
        np.testing.assert_allclose(got[0], float(want[0]), rtol=1e-5)
        if kind == "xent":
            wl = np.split(np.asarray(want[1]), N, axis=1)[r]
            np.testing.assert_allclose(got[1], wl, rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_allclose(got[1], np.asarray(want[1])[r],
                                       rtol=1e-5, atol=1e-7)
            wl = np.split(np.asarray(want[2]), N)[r]
            np.testing.assert_allclose(got[2], wl, rtol=1e-5, atol=1e-7)


# -- the trainer ------------------------------------------------------------------

def test_fused_tp_matches_jax_fused_tp(mesh_model4, setup, tp_runs):
    """Port ``train_lm_tp(head_impl="fused")`` against JAX's on
    ``mesh_model4``, 3 steps, at JAX's pin of the same trainer (rtol 2e-3,
    atol 2e-5)."""
    params, seeds, _ = setup
    want = j_train_lm_tp(params, jnp.asarray(seeds), TOKENS, D, mesh_model4,
                         lr=LR, seq_len=SEQ, n_heads=H, head_impl="fused")
    _close(tp_runs[0][POLICIES.index((None, "fused"))], want, rtol=2e-3,
           atol=2e-5)


@pytest.mark.parametrize("attn_impl,head_impl", POLICIES, ids=IDS)
def test_tp_matches_single(setup, tp_runs, attn_impl, head_impl):
    """Each attention x head policy on 4 ranks against JAX's and the
    port's ``train_lm_single`` (rtol 2e-4, atol 1e-6), having moved every
    leaf."""
    params, seeds, table = setup
    got = tp_runs[0][POLICIES.index((attn_impl, head_impl))]
    _close(got, _j_single(attn_impl, head_impl))
    mine = train_lm_single(lm_params_from_numpy(params), seeds, TOKENS, D,
                           lr=LR, seq_len=SEQ, n_heads=H,
                           attn_impl=attn_impl, head_impl=head_impl,
                           batch_fn=table)
    _close(got, mine)
    for g, b in zip(lm_leaves(got), lm_leaves(lm_params_from_numpy(params))):
        assert float((g - b).abs().max()) > 1e-5


def test_tp_adamw_matches_single_and_resumes(setup, tp_runs):
    """AdamW with its state sharded like the params, against JAX's and the
    port's single-device AdamW, 3 steps at lr 1e-2. Adam divides each
    gradient by its own running scale, so an element whose gradient is
    some 1e-7 (4 orders under the median) turns an f32-level difference
    of the gradient sums into a few percent of its update: the port's and
    JAX's single-device runs already differ by 3.4e-5 on such an element
    of ``w2``. So the params are held within rtol 2e-4, atol 1e-4 (1% of
    one step's lr), and the moments, which carry the gradients
    unnormalized, within rtol 2e-4, atol 1e-9 of the single-device run's
    after 2 steps. The state a rank holds is its shard, and two segments
    of the whole-mesh trainer, the state carried, end where the
    uninterrupted run ends (rtol 1e-6)."""
    params, seeds, table = setup
    runs, (_, seg_states) = tp_runs
    got = runs[len(POLICIES)]
    adam_tol = dict(rtol=2e-4, atol=1e-4)
    _close(got, _j_single(None, None, opt=True), **adam_tol)
    start = lm_params_from_numpy(params)
    single_kw = dict(lr=1e-2, seq_len=SEQ, n_heads=H, optimizer=adamw(),
                     batch_fn=table)
    _close(got, train_lm_single(start, seeds, TOKENS, D, **single_kw),
           **adam_tol)
    from distributed_llm_code_samples_tpu_torch.parallel import lm
    _, state2 = train_lm_single(start, seeds[:2], TOKENS, D,
                                return_state=True, **single_kw)
    tp_state2 = lm.lm_tp_unshard_state(seg_states)
    _close(tp_state2.mu, state2.mu, rtol=2e-4, atol=1e-9)
    _close(tp_state2.nu, state2.nu, rtol=2e-4, atol=1e-12)
    assert seg_states[0].mu.wte.shape == (V // N, D)
    assert seg_states[0].mu.blocks.w1.shape == (L, 4 * D // N, D)
    assert int(seg_states[0].count) == 2
    # resumed on loopback threads (sums in rank order) against the
    # uninterrupted run there
    loop = Mesh({MODEL_AXIS: N}, "cpu", loopback=True)
    run = functools.partial(train_lm_tp, mesh=loop, batch_size=TOKENS,
                            model_size=D, **single_kw)
    p1, s1 = run(start, seeds[:2], return_state=True)
    _close(run(p1, seeds[2:], opt_state=s1), run(start, seeds), rtol=1e-6,
           atol=1e-8)


def test_gqa_tp_matches_single(gqa_setup, setup, tp_runs):
    """8 query heads on 4 KV heads, 2 and 1 a rank, flash and the fused
    head, against JAX's ``train_lm_single`` (rtol 2e-4, atol 1e-6)."""
    params = gqa_setup[0]
    seeds = setup[1]
    want = j_train_lm(params, jnp.asarray(seeds), TOKENS, D, lr=LR,
                      seq_len=SEQ, n_heads=8, attn_impl="flash",
                      head_impl="fused")
    _close(tp_runs[0][len(POLICIES) + 1], want)


@pytest.mark.parametrize("attn_impl,head_impl", [(None, None),
                                                 ("flash", "fused")],
                         ids=["oracle", "kernels"])
def test_first_step_grads_match_single_leaf_by_leaf(setup, attn_impl,
                                                    head_impl):
    """Each leaf's first-step gradient on 4 loopback thread ranks (the
    threads a card's loopback runs) against JAX's ``jax.grad`` of the
    single-device loss (rtol 1e-4, atol 1e-7): a leaf reduced once too
    often or too seldom is off by a factor of 4."""
    params, seeds, table = setup
    tokens, targets = table(seeds[0])
    start = lm_params_from_numpy(params)
    outs = launch(torch_tp_ranks.lm_tp_first_grads,
                  Mesh({MODEL_AXIS: N}, "cpu", loopback=True),
                  (start, tokens, targets, H, attn_impl, head_impl),
                  timeout=60)
    from distributed_llm_code_samples_tpu_torch.parallel import lm
    got = lm.lm_tp_unshard([lm.lm_from_leaves(g) for _, g in outs])
    want = jax.grad(j_lm_loss)(params, jnp.asarray(tokens.numpy()),
                               jnp.asarray(targets.numpy()), H)
    _close(got, want, rtol=1e-4, atol=1e-7)
    loss = float(j_lm_loss(params, jnp.asarray(tokens.numpy()),
                           jnp.asarray(targets.numpy()), H))
    for l, _ in outs:
        assert l == pytest.approx(loss, rel=1e-5)


def test_loopback_threads_equal_gloo_ranks(setup, tp_runs):
    """The fused, flash run on 4 loopback CPU threads within its timeout
    equals the gloo ranks' (rtol 1e-6, atol 1e-8)."""
    params, seeds, table = setup
    got = train_lm_tp(lm_params_from_numpy(params), seeds, TOKENS, D,
                      Mesh({MODEL_AXIS: N}, "cpu", loopback=True), lr=LR,
                      seq_len=SEQ, n_heads=H, attn_impl="flash",
                      head_impl="fused", batch_fn=table, timeout=60)
    _close(got, tp_runs[0][POLICIES.index(("flash", "fused"))], rtol=1e-6,
           atol=1e-8)


def test_refusals_before_anything_is_spawned(setup, gqa_setup):
    params, seeds, _ = setup
    start = lm_params_from_numpy(params)
    model4 = make_mesh({MODEL_AXIS: N}, device="cpu")
    kw = dict(seq_len=SEQ, n_heads=H)
    v200 = lm_params_from_numpy(j_init_lm(jax.random.PRNGKey(5), 202, D, L,
                                          SEQ, n_heads=H))
    with pytest.raises(ValueError, match="vocab=202 not divisible"):
        train_lm_tp(v200, seeds, TOKENS, D, model4, **kw)
    gqa2 = lm_params_from_numpy(j_init_lm(jax.random.PRNGKey(5), V, D, L,
                                          SEQ, n_heads=H, n_kv_heads=2))
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        train_lm_tp(gqa2, seeds, TOKENS, D, model4, **kw)
    with pytest.raises(ValueError, match="n_heads=4 not divisible"):
        train_lm_tp(start, seeds, TOKENS, D,
                    make_mesh({MODEL_AXIS: 3}, device="cpu"), **kw)
    with pytest.raises(ValueError, match="need an optimizer"):
        train_lm_tp(start, seeds, TOKENS, D, model4, return_state=True, **kw)
    with pytest.raises(NotImplementedError, match="guard"):
        train_lm_tp(start, seeds, TOKENS, D, model4, guard=object(), **kw)
    with pytest.raises(ValueError, match="head_impl"):
        train_lm_tp(start, seeds, TOKENS, D, model4, head_impl="nope", **kw)
    with pytest.raises(ValueError, match=r"needs \['model'\]"):
        train_lm_tp(start, seeds, TOKENS, D,
                    make_mesh({"data": N}, device="cpu"), **kw)


def test_launch_counts_are_exact_under_threads():
    """The loopback ranks are threads that launch kernels at once: 8
    threads counting 2000 launches each, switching every microsecond,
    lose none (the count is a read-modify-write under a lock)."""
    import threading
    from distributed_llm_code_samples_tpu_torch.ops import _build
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = _build.launch_counts().get("stress", 0)
        threads = [threading.Thread(target=lambda: [
            _build.count_launch("stress") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert _build.launch_counts()["stress"] == before + 16000
    finally:
        sys.setswitchinterval(interval)
        _build._launches.pop("stress", None)


# -- the CLI -----------------------------------------------------------------------

CLI = [sys.executable, "-m", "distributed_llm_code_samples_tpu_torch.cli",
       "--device", "cpu", "-s", "3", "-bs", "2", "-n", "16", "-l", "2", "-d",
       "32", "-r", "7", "--lr", "0.1"]


@pytest.mark.parametrize("flags,tp", [
    (["--fake_devices", "4", "--tp", "4", "--head", "fused", "--attn",
      "flash"], 4),
    (["--fake_devices", "4", "--kv_heads", "2", "--attn", "rope"], 2)],
    ids=["fused-flash-tp4", "gqa-rope-tp2"])
def test_cli_method_11_trains_as_single(flags, tp):
    """``-m 11`` on gloo ranks: the payload, and the final layers'
    checksums against the port's ``train_lm_single`` from the CLI's own
    init (relative 1e-5)."""
    out = subprocess.run(CLI + ["-m", "11", "--vocab", "256"] + flags,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["mesh"] == {"model": tp} and payload["ranks"] == tp
    assert payload["kernel_launches_per_rank"] == [{}] * tp
    assert payload["steps_per_rank"] == 3 and payload["vocab"] == 256
    args = cli.build_parser().parse_args(CLI[3:] + ["-m", "11", "--vocab",
                                                    "256"] + flags)
    gen = torch.Generator()
    gen.manual_seed(7)
    params = cli._init(args, gen)
    assert f"PARAMS: {params.num_params():_}" in out.stdout
    want = train_lm_single(params, make_seed_schedule(3, 7), 32, 32, lr=0.1,
                           seq_len=16, n_heads=4, attn_impl=args.attn,
                           head_impl=args.head)
    np.testing.assert_allclose(payload["layer_checksums"],
                               cli._checksums(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flags,message", [
    (["-m", "4", "--attn", "flash"], "--attn applies to --method 8, 11"),
    (["-m", "8", "--kv_heads", "2"], "--kv_heads applies to the LM family"),
    (["-m", "11", "--kv_heads", "3"], "--heads 4 not divisible by "
                                      "--kv_heads 3"),
    (["-m", "11", "--kv_heads", "-1"], "--kv_heads must be >= 0"),
    (["-m", "11", "--fake_devices", "4", "--tp", "4", "--kv_heads", "2"],
     "--kv_heads 2 not divisible by the model-axis size 4"),
    (["-m", "8", "--head", "fused"], "--head fused applies to --method 11"),
    (["-m", "11", "--tp_sp"], "--tp_sp applies to --method 4 or 8 only"),
    (["-m", "11", "--fake_devices", "4", "--tp", "4", "--vocab", "250"],
     "vocab=250 not divisible"),
    (["-m", "2", "--tp", "2"], "--tp applies to --method 5, 8 or 11")],
    ids=["attn", "kv-m8", "kv-heads", "kv-neg", "kv-axis", "head-m8",
         "tp_sp-m11", "vocab", "tp-m2"])
def test_cli_refuses_with_jax_messages(capsys, flags, message):
    assert cli.main(CLI[3:] + flags) == 2
    out = capsys.readouterr()
    assert out.out == "" and message in out.err
