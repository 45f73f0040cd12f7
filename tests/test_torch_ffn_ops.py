"""The port's training core against the JAX package: linear and ReLU with
their hand VJPs, the FFN block family, the stack walker, gradient
accumulation, SGD, parameters and the seed schedule.

Inputs are made with numpy from a seed and go through both packages on
the CPU. Tolerance in f32: |port - jax| <= 1e-5 * |jax| + 1e-6 * max|jax|
(the two frameworks' CPU matmuls sum in other orders). The mixed (bf16
operand) blocks are held to 1e-2 of the max: an f32-level difference in
the pre-activation can flip one bf16 rounding of the hidden activation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu import optim as j_optim
from distributed_llm_code_samples_tpu.data import (
    batch_from_seed as j_batch, make_seed_schedule as j_schedule)
from distributed_llm_code_samples_tpu.models import ffn_stack as j_stack_m
from distributed_llm_code_samples_tpu.ops import activations as j_act
from distributed_llm_code_samples_tpu.ops import ffn as j_ffn
from distributed_llm_code_samples_tpu.ops import linear as j_lin
from distributed_llm_code_samples_tpu.ops import stack as j_stack
from distributed_llm_code_samples_tpu_torch import DLOSS_DX_COEF, LR
from distributed_llm_code_samples_tpu_torch import data as p_data
from distributed_llm_code_samples_tpu_torch.models import ffn_stack as p_model
from distributed_llm_code_samples_tpu_torch.ops import activations as p_act
from distributed_llm_code_samples_tpu_torch.ops import ffn as p_ffn
from distributed_llm_code_samples_tpu_torch.ops import linear as p_lin
from distributed_llm_code_samples_tpu_torch.ops import stack as p_stack
from distributed_llm_code_samples_tpu_torch.optim import sgd as p_sgd

T, D, F, L = 24, 16, 64, 3


def close(got, want, rtol=1e-5, atol_of_max=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * float(np.abs(want).max()))


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def block_inputs(seed=0):
    return (rnd(F, D, seed=seed, scale=0.2), rnd(D, F, seed=seed + 1,
                                                 scale=0.2),
            rnd(T, D, seed=seed + 2), rnd(T, D, seed=seed + 3, scale=0.1))


def test_constants_match():
    from distributed_llm_code_samples_tpu import DLOSS_DX_COEF as jc, LR as jl
    assert (LR, DLOSS_DX_COEF) == (jl, jc)


def test_linear_matches_jax():
    w, x, dy = rnd(F, D), rnd(T, D, seed=1), rnd(T, F, seed=2)
    close(p_lin.linear_fwd(t(w), t(x)), j_lin.linear_fwd(w, x))
    for got, want in zip(p_lin.linear_bwd(t(dy), t(w), t(x)),
                         j_lin.linear_bwd(dy, w, x)):
        close(got, want)
    gen = torch.Generator().manual_seed(0)
    w0 = p_lin.init_linear(gen, D, F, scale=0.5)
    assert tuple(w0.shape) == (F, D) and w0.dtype == torch.float32
    assert 0.3 < float(w0.std()) < 0.7


def test_relu_matches_jax_on_zero_and_nan():
    x = rnd(T, D)
    x[0, :4] = [0.0, -0.0, np.nan, 1.0]
    dy = rnd(T, D, seed=1)
    np.testing.assert_array_equal(p_act.relu_fwd(t(x)).numpy(),
                                  np.asarray(j_act.relu_fwd(x)))
    np.testing.assert_array_equal(p_act.relu_bwd(t(dy), t(x)).numpy(),
                                  np.asarray(j_act.relu_bwd(dy, x)))
    assert float(p_act.relu_bwd(t(dy), t(x))[0, 0]) == 0.0   # 0 is masked


def test_ffn_fwd_bwd_match_jax():
    w1, w2, x, dy = block_inputs()
    close(p_ffn.ffn_fwd(t(w1), t(w2), t(x)), j_ffn.ffn_fwd(w1, w2, x))
    a = np.asarray(j_act.relu_fwd(j_lin.linear_fwd(w1, x)))
    for port, jx in ((p_ffn.ffn_bwd(t(dy), t(w1), t(w2), t(x)),
                      j_ffn.ffn_bwd(dy, w1, w2, x)),
                     (p_ffn.ffn_bwd_saved(t(dy), t(w1), t(w2), t(x), t(a)),
                      j_ffn.ffn_bwd_saved(dy, w1, w2, x, a))):
        close(port[0], jx[0])
        close(port[1][0], jx[1][0])
        close(port[1][1], jx[1][1])


def test_hand_vjp_matches_torch_autograd():
    """The hand VJP against autograd of the plain forward (an oracle that
    shares no backward code with it)."""
    w1, w2, x, dy = (t(a) for a in block_inputs(seed=5))
    leaves = [a.clone().requires_grad_() for a in (w1, w2, x)]
    y = torch.relu(leaves[2] @ leaves[0].T) @ leaves[1].T
    gw1, gw2, gx = torch.autograd.grad(y, leaves, dy)
    dx, (dw1, dw2) = p_ffn.ffn_bwd(dy, w1, w2, x)
    for got, want in ((dx, gx), (dw1, gw1), (dw2, gw2)):
        close(got, want.numpy())


BLOCKS = [("ffn_block", 1e-5, 1e-6), ("ffn_block_saved", 1e-5, 1e-6),
          ("ffn_block_mixed", 0.0, 1e-2),
          ("ffn_block_mixed_remat", 0.0, 1e-2)]


@pytest.mark.parametrize("name,rtol,atol", BLOCKS)
def test_block_function_gradients_match_jax_vjp(name, rtol, atol):
    w1, w2, x, dy = block_inputs(seed=11)
    y_j, vjp = jax.vjp(getattr(j_ffn, name), w1, w2, x)
    leaves = [t(a).requires_grad_() for a in (w1, w2, x)]
    y_p = getattr(p_ffn, name)(*leaves)
    grads = torch.autograd.grad(y_p, leaves, t(dy))
    close(y_p, y_j, rtol, atol)
    for got, want in zip(grads, vjp(jnp.asarray(dy))):
        assert got.dtype == torch.float32
        close(got, want, rtol, atol)


def test_mixed_pair_form_matches_jax():
    w1, w2, x, dy = block_inputs(seed=13)
    close(p_ffn.ffn_fwd_mixed(t(w1), t(w2), t(x)),
          j_ffn.ffn_fwd_mixed(w1, w2, x), 0.0, 1e-2)
    dx, (dw1, dw2) = p_ffn.ffn_bwd_mixed(t(dy), t(w1), t(w2), t(x))
    jdx, (jdw1, jdw2) = j_ffn.ffn_bwd_mixed(dy, w1, w2, x)
    for got, want in ((dx, jdx), (dw1, jdw1), (dw2, jdw2)):
        close(got, want, 0.0, 1e-2)


def stack_inputs(seed=0):
    return (rnd(L, F, D, seed=seed, scale=0.2),
            rnd(L, D, F, seed=seed + 1, scale=0.2),
            rnd(T, D, seed=seed + 2), rnd(T, D, seed=seed + 3, scale=0.1))


def test_stack_fwd_bwd_with_grad_hook_match_jax():
    w1s, w2s, x, dy = stack_inputs()
    y_p, acts_p = p_stack.stack_fwd(t(w1s), t(w2s), t(x))
    y_j, acts_j = j_stack.stack_fwd(w1s, w2s, x)
    close(y_p, y_j)
    close(acts_p, acts_j)
    seen = []

    def hook_p(dw1, dw2):
        seen.append(tuple(dw1.shape))
        return 2 * dw1, 3 * dw2

    dx_p, (g1_p, g2_p) = p_stack.stack_bwd(t(dy), t(w1s), t(w2s), acts_p,
                                           grad_hook=hook_p)
    dx_j, (g1_j, g2_j) = j_stack.stack_bwd(
        dy, w1s, w2s, acts_j, grad_hook=lambda a, b: (2 * a, 3 * b))
    assert seen == [(F, D)] * L
    for got, want in ((dx_p, dx_j), (g1_p, g1_j), (g2_p, g2_j)):
        close(got, want)


@pytest.mark.parametrize("name", ["ffn_block", "ffn_block_saved"])
def test_stack_grads_matches_jax(name):
    w1s, w2s, x, dy = stack_inputs(seed=3)
    y_p, (g1_p, g2_p) = p_stack.stack_grads(
        t(w1s), t(w2s), t(x), t(dy), block=getattr(p_ffn, name))
    y_j, (g1_j, g2_j) = j_stack.stack_grads(
        w1s, w2s, x, dy, block=getattr(j_ffn, name))
    for got, want in ((y_p, y_j), (g1_p, g1_j), (g2_p, g2_j)):
        close(got, want)
    assert not y_p.requires_grad


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_accumulated_grads_matches_jax(accum):
    w1s, w2s, x, dy = stack_inputs(seed=7)

    def port_fn(xc, dc):
        return p_model.FFNStackParams(*p_stack.stack_grads(
            t(w1s), t(w2s), xc, dc)[1])

    def jax_fn(xc, dc):
        return j_stack_m.FFNStackParams(*j_stack.stack_grads(
            w1s, w2s, xc, dc)[1])

    got = p_stack.accumulated_grads(port_fn, t(x), t(dy), accum)
    want = j_stack.accumulated_grads(jax_fn, jnp.asarray(x),
                                     jnp.asarray(dy), accum)
    close(got.w1, want.w1)
    close(got.w2, want.w2)
    with pytest.raises(ValueError, match="divisible"):
        p_stack.accumulated_grads(port_fn, t(x), t(dy), 5)


def test_sgd_matches_jax_and_updates_in_place():
    w1s, w2s, _, _ = stack_inputs(seed=9)
    g1, g2 = rnd(*w1s.shape, seed=20), rnd(*w2s.shape, seed=21)
    params = p_model.FFNStackParams(t(w1s), t(w2s))
    before = params.w1
    out = p_sgd(params, p_model.FFNStackParams(t(g1), t(g2)), 0.1)
    want = j_optim.sgd(j_stack_m.FFNStackParams(w1s, w2s),
                       j_stack_m.FFNStackParams(g1, g2), 0.1)
    assert out.w1 is before
    np.testing.assert_array_equal(out.w1.numpy(), np.asarray(want.w1))
    np.testing.assert_array_equal(out.w2.numpy(), np.asarray(want.w2))


def test_ffn_params_init_clone_and_from_numpy():
    gen = torch.Generator().manual_seed(1)
    p = p_model.init_ffn_stack(gen, D, L)
    assert tuple(p.w1.shape) == (L, 4 * D, D)
    assert tuple(p.w2.shape) == (L, D, 4 * D)
    assert (p.n_layers, p.d_model, p.ffn_dim) == (L, D, 4 * D)
    jp = j_stack_m.init_ffn_stack(jax.random.PRNGKey(1), D, L)
    assert p.num_params() == jp.num_params()
    assert p_model.params_size_gb(p) == j_stack_m.params_size_gb(jp)
    q = p_model.ffn_params_from_numpy(jp)
    np.testing.assert_array_equal(q.w1.numpy(), np.asarray(jp.w1))
    np.testing.assert_array_equal(q.w2.numpy(), np.asarray(jp.w2))
    c = p_model.clone_params(q)
    c.w1.add_(1.0)
    np.testing.assert_array_equal(q.w1.numpy(), np.asarray(jp.w1))
    assert 0.015 < float(p.w1.std()) < 0.025


@pytest.mark.parametrize("random_seed", [1, 7, 12345])
def test_seed_schedule_bit_equal_to_jax(random_seed):
    got = p_data.make_seed_schedule(50, random_seed)
    want = np.asarray(j_schedule(50, random_seed))
    assert got.dtype == np.int32 == want.dtype
    np.testing.assert_array_equal(got, want)


def test_batch_from_seed_is_pure_and_poisons_like_jax():
    x, dl = p_data.batch_from_seed(42, T, D)
    x2, dl2 = p_data.batch_from_seed(42, T, D)
    assert torch.equal(x, x2) and torch.equal(dl, dl2)
    assert tuple(x.shape) == tuple(dl.shape) == (T, D)
    assert 0.05 < float(dl.std()) < 0.15      # 0.1 * normal
    for bit, check in ((p_data.POISON_NAN_BIT, np.isnan),
                       (p_data.POISON_INF_BIT, np.isinf)):
        xp, dp = p_data.batch_from_seed(42 | bit, T, D)
        assert torch.equal(xp, x) and check(dp.numpy()).all()
        assert check(np.asarray(j_batch(jnp.int32(42 | bit), T, D)[1])).all()
    assert p_data.strip_poison(42 | p_data.POISON_NAN_BIT) == 42
    batches = list(p_data.mock_data(np.array([3, 4]), T, D))
    assert torch.equal(batches[0][0], p_data.batch_from_seed(3, T, D)[0])
