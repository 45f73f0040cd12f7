"""The LM family's ops in the port against the JAX package, on the CPU:
LayerNorm, the cross-entropy, attention (single, multi-head, grouped),
the transformer block and the LM loss with both heads, forward values
and VJPs (``jax.vjp`` / ``jax.grad`` of the JAX function) on the same
numpy inputs. Tolerance: rtol 1e-5, atol 1e-6 on values; rtol 1e-4,
atol 1e-5 on gradients (the frameworks sum in other orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu.models import lm as j_lm
from distributed_llm_code_samples_tpu.models import transformer as j_tf
from distributed_llm_code_samples_tpu.ops import norm as j_norm
from distributed_llm_code_samples_tpu.ops import xent as j_xent
from distributed_llm_code_samples_tpu.parallel.lm import (
    resolve_head as j_resolve_head)
from distributed_llm_code_samples_tpu_torch.models import lm as p_lm
from distributed_llm_code_samples_tpu_torch.models import transformer as p_tf
from distributed_llm_code_samples_tpu_torch.ops import norm as p_norm
from distributed_llm_code_samples_tpu_torch.ops import xent as p_xent
from distributed_llm_code_samples_tpu_torch.parallel import (
    lm_grads, resolve_attn, resolve_head)

# both packages export the function ``attention`` beside the module
j_attn = importlib.import_module(
    "distributed_llm_code_samples_tpu.models.attention")
p_attn = importlib.import_module(
    "distributed_llm_code_samples_tpu_torch.models.attention")


def value_close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def grad_close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def check_vjp(jfn, pfn, arrays, dy):
    """Forward value and the VJP w.r.t. every array, port against JAX."""
    y_j, vjp = jax.vjp(jfn, *arrays)
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    y_p = pfn(*leaves)
    value_close(y_p, y_j)
    got = torch.autograd.grad(y_p, leaves, torch.from_numpy(dy))
    for g, w in zip(got, vjp(jnp.asarray(dy))):
        grad_close(g, w)


def rng_normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def test_layernorm_and_vjp_match_jax():
    rng = np.random.default_rng(0)
    g = rng_normal(rng, 24, scale=0.5) + 1.0
    x = rng_normal(rng, 3, 5, 24, scale=2.0) + 0.5
    check_vjp(j_norm.layernorm, p_norm.layernorm, [g, x],
              rng_normal(rng, 3, 5, 24))
    y, (xhat, rstd) = p_norm.ln_fwd(torch.from_numpy(g), torch.from_numpy(x))
    y_j, (xhat_j, rstd_j) = j_norm.ln_fwd(g, x)
    for a, b in ((y, y_j), (xhat, xhat_j), (rstd, rstd_j)):
        value_close(a, b)


def test_xent_loss_and_vjp_match_jax():
    rng = np.random.default_rng(1)
    logits = rng_normal(rng, 16, 37, scale=3.0)
    t = rng.integers(0, 37, size=16).astype(np.int32)
    t[0] = 36
    loss_j, g_j = jax.value_and_grad(j_xent.xent_loss)(logits, t)
    lt = torch.from_numpy(logits).requires_grad_()
    loss = p_xent.xent_loss(lt, torch.from_numpy(t).long())
    value_close(loss, loss_j)
    (g,) = torch.autograd.grad(3.0 * loss, [lt])
    grad_close(g, 3.0 * np.asarray(g_j))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("op", ["attention", "mha", "gqa"])
def test_attention_ops_and_vjps_match_jax(op, causal):
    rng = np.random.default_rng(2)
    hq, hkv = {"attention": (None, None), "mha": (3, 3), "gqa": (4, 2)}[op]
    lead_q = () if hq is None else (hq,)
    lead_k = () if hkv is None else (hkv,)
    q = rng_normal(rng, *lead_q, 12, 8)
    k = rng_normal(rng, *lead_k, 12, 8)
    v = rng_normal(rng, *lead_k, 12, 8)
    check_vjp(lambda a, b, c: getattr(j_attn, op)(a, b, c, causal),
              lambda a, b, c: getattr(p_attn, op)(a, b, c, causal),
              [q, k, v], rng_normal(rng, *lead_q, 12, 8))


@pytest.mark.parametrize("attn_impl", [None, "flash"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_transformer_block_and_vjp_match_jax(attn_impl, kv_heads):
    rng = np.random.default_rng(3)
    d, ffn, heads, b, t = 32, 64, 4, 2, 16
    kv = d // heads * kv_heads
    ws = [rng_normal(rng, d) + 1.0, rng_normal(rng, d, d, scale=0.1),
          rng_normal(rng, kv, d, scale=0.1), rng_normal(rng, kv, d, scale=0.1),
          rng_normal(rng, d, d, scale=0.1), rng_normal(rng, d) + 1.0,
          rng_normal(rng, ffn, d, scale=0.1),
          rng_normal(rng, d, ffn, scale=0.1)]
    x = rng_normal(rng, b, t, d)
    if attn_impl is None:
        j_op = None
    else:
        from distributed_llm_code_samples_tpu.parallel.transformer import (
            resolve_attn as j_resolve_attn)
        j_op = j_resolve_attn(attn_impl)
    p_op = resolve_attn(attn_impl)
    check_vjp(lambda *a: j_tf.transformer_block(*a, heads, True, j_op),
              lambda *a: p_tf.transformer_block(*a, heads, True, p_op),
              ws + [x], rng_normal(rng, b, t, d))


V, D, L, H, T, B = 96, 32, 2, 4, 16, 2


@pytest.fixture(scope="module")
def lm_case():
    params = j_init_lm(jax.random.PRNGKey(1), V, D, L, T, n_heads=H)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, V, size=(B, T + 1)).astype(np.int32)
    return params, toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("head_impl", [None, "fused"])
@pytest.mark.parametrize("attn_impl", [None, "flash"])
def test_lm_loss_and_grads_match_jax(lm_case, attn_impl, head_impl):
    params, toks, tgts = lm_case
    from distributed_llm_code_samples_tpu.parallel.transformer import (
        resolve_attn as j_resolve_attn)
    loss_j, g_j = jax.value_and_grad(j_lm.lm_loss)(
        params, toks, tgts, H, j_resolve_attn(attn_impl),
        j_resolve_head(head_impl))
    loss, grads = lm_grads(p_lm.lm_params_from_numpy(params),
                           torch.from_numpy(toks).long(),
                           torch.from_numpy(tgts).long(), H,
                           resolve_attn(attn_impl), resolve_head(head_impl))
    value_close(loss, loss_j)
    for g, w in zip(grads, jax.tree_util.tree_leaves(g_j)):
        grad_close(g, w)


def test_wte_gradient_is_the_sum_of_its_two_sides(lm_case):
    """The tied ``wte`` gets gradient from the embedding gather and from
    the head; the port's total equals JAX's, and each side alone does
    not."""
    params, toks, tgts = lm_case
    g_j = jax.grad(j_lm.lm_loss)(params, toks, tgts, H).wte
    p = p_lm.lm_params_from_numpy(params)
    tk, tg = torch.from_numpy(toks).long(), torch.from_numpy(tgts).long()
    _, grads = lm_grads(p, tk, tg, H)
    grad_close(grads[0], g_j)

    def side(head_side):
        wte = p.wte.clone().requires_grad_()
        wte_emb = wte.detach() if head_side else wte
        wte_head = wte if head_side else wte.detach()
        x = wte_emb[tk] + p.wpe[:T]
        x = p_tf.transformer_fwd(p.blocks, x, H)
        h = p_norm.layernorm(p.ln_f, x)
        loss = p_xent.xent_loss((h @ wte_head.T).reshape(-1, V),
                                tg.reshape(-1))
        return torch.autograd.grad(loss, [wte])[0]

    emb, head = side(False), side(True)
    grad_close(emb + head, g_j)
    for one in (emb, head):
        assert float((one - grads[0]).abs().max()) > 1e-4


def test_leaves_follow_jax_tree_order(lm_case):
    params, _, _ = lm_case
    p = p_lm.lm_params_from_numpy(params)
    leaves = p_lm.lm_leaves(p)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(params)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    clone = p_lm.clone_lm(p)
    assert all(a is not b and torch.equal(a, b)
               for a, b in zip(p_lm.lm_leaves(clone), leaves))
    assert p_lm.lm_from_leaves(leaves).blocks.wq is leaves[3]
