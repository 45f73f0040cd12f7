"""The LM's ``--dtype bfloat16`` on one device against the JAX package
on the CPU: the weights carried across in their own type, the fused
head's plain versions on bf16 against JAX's Pallas kernels in interpret
mode (also on each rank's vocab shard under ``vp_head_xent``),
``lm_loss`` and ``train_lm_single`` on bf16 params, and the JAX
fused-head fault this slice is held around.

vocab 384 (200 for the pad range), d 32, 2 layers, 4 heads, 64-token
sequences, 2 a step, 3 seeds, lr 0.1, from JAX's bf16 ``init_lm``
parameters; the port trains on the JAX batches.

JAX runs under ``STRICT``: XLA's CPU compiler by default lets a chain of
bf16 elementwise ops run in f32 and round once at its end
(``xla_allow_excess_precision``), where PyTorch rounds every op to bf16;
with that off, each of JAX's ops rounds as it is written, and the port's
oracle-head trainer equals JAX's bit for bit over three steps. The
flash attention's and the fused head's plain versions sum in another
order than JAX's oracle ops, so those runs are held within a share of
the update: each leaf's ``|port - JAX| <= 0.2 |JAX - start|`` (measured
at most 0.16 with flash, 0.18 with the fused head, on wq and wk, the
leaves that move least); a leaf JAX's run leaves as it was stays so.
The same run from the f32 widening of the params misses up to 3 times
the update (the control). The head's plain versions equal the JAX
kernels' bf16 gradients bit for bit (limit: one bf16 step) and their
f32 statistics within 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import (
    lm_batch_from_seed as j_lm_batch)
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu.models import init_moe_stack
from distributed_llm_code_samples_tpu.models import (
    init_transformer as j_init_transformer)
from distributed_llm_code_samples_tpu.models.lm import lm_loss as j_lm_loss
from distributed_llm_code_samples_tpu.ops import pallas_xent as jx
from distributed_llm_code_samples_tpu.parallel import (
    train_lm_single as j_train_lm)
from distributed_llm_code_samples_tpu.parallel.transformer import (
    resolve_attn as j_resolve_attn)
from distributed_llm_code_samples_tpu_torch.models import (
    lm_leaves, lm_params_from_numpy, moe_params_from_numpy,
    transformer_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
    tensor_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.ops import fused_xent as fx
from distributed_llm_code_samples_tpu_torch.parallel import (
    MODEL_AXIS, Mesh, launch, resolve_attn, resolve_head, train_lm_single)
from distributed_llm_code_samples_tpu_torch.parallel.lm import lm_grads

from torch_bf16_ranks import bf16_steps, update_gap, vp_head_bf16

BF = jnp.bfloat16
V, D, L, H, SEQ, LR, N = 384, 32, 2, 4, 64, 0.1, 4
TOKENS = 2 * SEQ
# XLA's CPU compiler rounds every bf16 op as written (module docstring)
STRICT = {"xla_allow_excess_precision": False}
GAP = 0.2


def strict(fn, *args):
    """``fn(*args)`` compiled with ``STRICT``."""
    return jax.jit(fn, compiler_options=STRICT)(*args)


@pytest.fixture(scope="module")
def setup():
    params = j_init_lm(jax.random.PRNGKey(2), V, D, L, SEQ, n_heads=H,
                       dtype=BF)
    seeds = np.asarray(make_seed_schedule(3, random_seed=11))
    table = {int(s): tuple(torch.from_numpy(np.array(a)).long() for a in
                           j_lm_batch(jnp.int32(s), TOKENS // SEQ, SEQ, V))
             for s in seeds}
    return params, seeds, table, lm_params_from_numpy(params)


def _bits(a) -> np.ndarray:
    """A bf16 array's or tensor's bits as int16."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


# -- the weights carried across -----------------------------------------------

FAMILIES = {
    "lm": (lambda: j_init_lm(jax.random.PRNGKey(1), 200, D, L, SEQ,
                             n_heads=H, dtype=BF),
           lm_params_from_numpy, lm_leaves),
    "transformer": (lambda: j_init_transformer(jax.random.PRNGKey(1), D, L,
                                               dtype=BF),
                    transformer_params_from_numpy,
                    lambda p: [t for _, t in p.named_leaves()]),
    "moe": (lambda: init_moe_stack(jax.random.PRNGKey(1), D, L, 4, dtype=BF),
            moe_params_from_numpy, list),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_trees_keep_every_bit_both_ways(family):
    """A bf16 JAX tree goes across as bf16 with every bit kept and comes
    back out through the port's leaves with the same bits; an f32 tree
    stays f32."""
    init, from_numpy, leaves = FAMILIES[family]
    tree = init()
    port = from_numpy(tree)
    want = jax.tree_util.tree_leaves(tree)
    got = leaves(port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
    f32 = from_numpy(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), tree))
    for g, w in zip(leaves(f32), got):
        assert g.dtype == torch.float32
        assert torch.equal(g, w.float())


# -- the fused head on bf16 -------------------------------------------------

def _head_case(n, v, seed):
    """bf16 ``h [n, d]``, ``w [v, d]`` and targets with some outside
    ``[0, v)`` (-1, v and beyond: a shard's shifted targets)."""
    rng = np.random.default_rng(seed)
    h = jnp.asarray(rng.normal(size=(n, D)), BF)
    w = jnp.asarray(0.5 * rng.normal(size=(v, D)), BF)
    t = rng.integers(0, v, size=n)
    t[:3] = (-1, v, v + 7)
    return h, w, jnp.asarray(t, jnp.int32)


@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("n,v", [(37, 200), (100, 384)])
def test_head_plain_versions_match_jax_kernels_on_bf16(n, v, mxu_bf16):
    """``head_xent_stats_ref`` and ``head_xent_bwd_ref`` on bf16 against
    JAX's Pallas kernels in interpret mode, at a row count that is not a
    multiple of 32 and a vocab that is not one of the 128-column tile:
    ``lse`` and ``tz`` f32 within 1e-6 (JAX sums a tile's exponentials in
    another order), ``dh`` and ``dw`` bf16 within one bf16 step (measured:
    equal) of JAX's, which JAX's wrapper widens to f32 (``dy = 1``)."""
    h, w, t = _head_case(n, v, n + v)
    lse, tz = jx.head_xent_stats(h, w, t, interpret=True, mxu_bf16=mxu_bf16)
    dh, dw = jx.head_xent_bwd(jnp.float32(1.0), h, w, t, lse, interpret=True,
                              mxu_bf16=mxu_bf16)
    ph, pw = tensor_from_numpy(h), tensor_from_numpy(w)
    pt = torch.from_numpy(np.array(t))
    plse, ptz = fx.head_xent_stats(ph, pw, pt, mxu_bf16=mxu_bf16)
    assert plse.dtype == ptz.dtype == torch.float32
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ptz.numpy(), np.asarray(tz), rtol=1e-6,
                               atol=1e-6)
    assert float(ptz[0]) == float(ptz[1]) == float(ptz[2]) == 0.0
    pdh, pdw = fx.head_xent_bwd(torch.tensor(1.0), ph, pw, pt,
                                torch.from_numpy(np.array(lse)),
                                mxu_bf16=mxu_bf16)
    assert pdh.dtype == pdw.dtype == torch.bfloat16
    for g, want in ((pdh, dh), (pdw, dw)):
        assert np.asarray(want).dtype == np.float32   # JAX's promotion
        assert bf16_steps(g, want, floor=0.0)[0] <= 1.0


def test_head_refuses_mixed_storage():
    h, w, t = _head_case(8, 40, 0)
    with pytest.raises(ValueError, match="one storage type"):
        fx.head_xent_stats(tensor_from_numpy(h).float(), tensor_from_numpy(w),
                           torch.from_numpy(np.array(t)))


@pytest.fixture(scope="module")
def vp_runs():
    """``vp_head_xent`` on bf16 on 4 loopback CPU threads of a model mesh,
    vocab 384 and 200 (50 rows a rank: targets land in a rank's pad
    range), one launch."""
    cases = [_head_case(37, v, v) for v in (V, 200)]
    port = [tuple(tensor_from_numpy(a) for a in c[:2])
            + (torch.from_numpy(np.array(c[2])),) for c in cases]
    outs = launch(vp_head_bf16, Mesh({MODEL_AXIS: N}, "cpu", loopback=True),
                  port, timeout=120)
    return cases, outs


@pytest.mark.parametrize("case", [0, 1], ids=["v384", "v200"])
def test_vp_head_xent_bf16_shards_match_jax_kernels(vp_runs, case):
    """Each rank's shard through JAX's kernels, targets shifted by its
    first row, the statistics merged as JAX's ``vp_head_xent`` merges them
    (max, sum of exponentials, target pick, f32), the backward on the
    merged ``lse``: the loss within rtol 1e-6, each rank's partial ``dh``
    and its ``dw`` rows bf16 within one bf16 step at the gradient's RMS
    (measured: 0.03 in 0.25% of ``dh``; ``dz`` near 0 on a target column
    cancels, so a value far below the RMS may differ in more of its own
    steps)."""
    cases, outs = vp_runs
    h, w, t = cases[case]
    vl = w.shape[0] // N
    stats = [jx.head_xent_stats(h, w[r * vl:(r + 1) * vl], t - r * vl,
                                interpret=True) for r in range(N)]
    lses = jnp.stack([s[0] for s in stats])
    m = jnp.max(lses, axis=0)
    lse = m + jnp.log(jnp.sum(jnp.exp(lses - m), axis=0))
    loss = jnp.mean(lse - sum(s[1] for s in stats))
    for r in range(N):
        got_loss, dh, dw = outs[r][case]
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6)
        want_dh, want_dw = jx.head_xent_bwd(
            jnp.float32(1.0), h, w[r * vl:(r + 1) * vl], t - r * vl, lse,
            interpret=True)
        assert dh.dtype == dw.dtype == torch.bfloat16
        assert bf16_steps(dh, want_dh)[0] <= 1.0
        assert bf16_steps(dw, want_dw)[0] <= 1.0


def test_jax_fused_head_promotes_bf16_gradients_to_f32():
    """The JAX fault the port is held around (ROADMAP Queue 3): the Pallas
    kernels store ``dh``, ``dw`` in bf16, but ``head_xent_bwd`` scales
    them by the f32 cotangent (``pallas_xent.py:299``), so ``jax.grad``
    hands a bf16 operand an f32 gradient, and a bf16 op before the head
    (the LM's trunk) fails to differentiate. If this starts to pass, JAX
    was fixed: hold the port's fused-head trainer against JAX's fused
    head then. The port's gradients keep bf16."""
    h, w, t = _head_case(37, 200, 3)
    assert jax.grad(lambda x: jx.head_xent(x, w, t, True))(h).dtype == \
        jnp.float32
    with pytest.raises(TypeError, match="same dtypes"):
        jax.grad(lambda x: jx.head_xent(x + x * x, w, t, True))(h)
    ph = tensor_from_numpy(h).requires_grad_()
    loss = fx.head_xent(ph + ph * ph, tensor_from_numpy(w),
                        torch.from_numpy(np.array(t)))
    assert torch.autograd.grad(loss, ph)[0].dtype == torch.bfloat16


# -- lm_loss and train_lm_single on bf16 params -------------------------------

@pytest.mark.parametrize("attn_impl", [None, "flash"],
                         ids=["oracle", "flash"])
def test_lm_loss_bf16_matches_jax(setup, attn_impl):
    """The loss and every leaf's gradient of one bf16 batch against JAX's
    ``value_and_grad(lm_loss)`` (oracle head) under ``STRICT``: with the
    oracle attention equal bit for bit; with flash (JAX's kernels in
    interpret mode, the port's plain versions, which sum their tiles in
    another order) within four bf16 steps at the leaf's RMS (measured 4,
    on wte, in 4% of it; 2.6 at most elsewhere). The fused head's
    gradients are bf16, its loss f32, within 0.01 of the oracle head's."""
    params, seeds, table, start = setup
    toks, tgts = table[int(seeds[0])]
    jt, jg = jnp.asarray(toks.numpy()), jnp.asarray(tgts.numpy())
    loss, grads = strict(jax.value_and_grad(
        lambda p: j_lm_loss(p, jt, jg, H, attn=j_resolve_attn(attn_impl))),
        params)
    attn = resolve_attn(attn_impl)
    got_loss, got = lm_grads(start, toks, tgts, H, attn)
    assert got_loss.dtype == torch.bfloat16
    for g, w in zip(got + [got_loss], jax.tree_util.tree_leaves(grads)
                    + [loss]):
        assert g.dtype == torch.bfloat16
        if attn_impl is None:
            np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            assert bf16_steps(g, w)[0] <= 4.0
    fused_loss, fused = lm_grads(start, toks, tgts, H, attn,
                                 resolve_head("fused"))
    assert fused_loss.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in fused)
    assert abs(float(fused_loss) - float(loss)) < 0.01


def _train(start, seeds, table, **kw):
    launches = _build.launch_counts()
    got = train_lm_single(start, seeds, TOKENS, D, lr=LR, seq_len=SEQ,
                          n_heads=H, batch_fn=lambda s: table[int(s)], **kw)
    assert _build.launch_counts() == launches       # CPU: no kernel
    return got


@functools.lru_cache(maxsize=None)
def _j_train(attn_impl):
    params = j_init_lm(jax.random.PRNGKey(2), V, D, L, SEQ, n_heads=H,
                       dtype=BF)
    seeds = jnp.asarray(make_seed_schedule(3, random_seed=11))
    out = strict(lambda p, s: j_train_lm(p, s, TOKENS, D, lr=LR, seq_len=SEQ,
                                         n_heads=H, attn_impl=attn_impl),
                 params, seeds)
    return jax.tree_util.tree_leaves(out)


def _held(got, want, start, gap):
    for g, w, s in zip(lm_leaves(got), want, lm_leaves(start)):
        assert g.dtype == torch.bfloat16
        assert update_gap(g, w, s) <= gap, update_gap(g, w, s)
    assert bf16_steps(got.blocks.w1, start.blocks.w1)[1] > 0.5   # moved


@pytest.mark.parametrize("attn_impl", [None, "flash"],
                         ids=["oracle", "flash"])
def test_train_lm_single_bf16_matches_jax(setup, attn_impl):
    """Three bf16 SGD steps with the oracle head against JAX's under
    ``STRICT``: bit for bit with the oracle attention; with flash within
    ``GAP`` of the update (the plain flash version's sums)."""
    params, seeds, table, start = setup
    got = _train(start, seeds, table, attn_impl=attn_impl)
    want = _j_train(attn_impl)
    if attn_impl is None:
        for g, w in zip(lm_leaves(got), want):
            np.testing.assert_array_equal(_bits(g), _bits(w))
    _held(got, want, start, GAP)


@pytest.mark.parametrize("attn_impl", [None, "flash"],
                         ids=["oracle", "flash"])
def test_train_lm_single_bf16_fused_head_against_jax_oracle_head(
        setup, attn_impl):
    """The fused head on bf16 params trains (JAX's crashes: see
    ``test_jax_fused_head_promotes_bf16_gradients_to_f32``); held against
    JAX's oracle-head run under ``STRICT`` within ``GAP`` of the update."""
    params, seeds, table, start = setup
    got = _train(start, seeds, table, attn_impl=attn_impl,
                 head_impl="fused")
    _held(got, _j_train(attn_impl), start, GAP)


def test_f32_run_is_told_apart(setup):
    """The control: the same steps from the f32 widening of the bf16
    params miss more than ``GAP`` of JAX's bf16 update."""
    params, seeds, table, start = setup
    f32 = lm_params_from_numpy(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), params))
    got = _train(f32, seeds, table)
    gaps = [update_gap(g, w, s) for g, w, s in
            zip(lm_leaves(got), _j_train(None), lm_leaves(start))]
    assert max(gaps) > 5 * GAP
