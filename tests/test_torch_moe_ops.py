"""The port's MoE ops (``ops/moe.py``) and model (``models/moe.py``)
against the JAX package's, on the same numpy inputs.

Integer outputs (expert indices, slot positions, destinations, slot
maps, keep masks) and the one-hot dispatch tensors must be equal;
forwards agree within rtol 1e-5, atol 1e-6, and so do gradients against
``jax.vjp`` (the gather form's custom VJPs included): the frameworks'
CPU matmuls sum in other orders. Cases: k 1 and 2, capacity factor 2.0
and an overflowing 0.5, a router with two equal rows (every token ties
between those experts), and the stack with its aux term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.models import moe as j_models
from distributed_llm_code_samples_tpu.ops import moe as jm
from distributed_llm_code_samples_tpu_torch.models import (
    MoEStackParams, init_moe_stack, moe_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import moe as pm

T, D, E, F_DIM, L = 24, 16, 4, 32, 2
RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, tied=False):
    rng = np.random.default_rng(seed)
    wg = (0.5 * rng.normal(size=(E, D))).astype(np.float32)
    if tied:
        wg[3] = wg[1]            # experts 1 and 3 tie for every token
    w1 = (0.2 * rng.normal(size=(E, F_DIM, D))).astype(np.float32)
    w2 = (0.2 * rng.normal(size=(E, D, F_DIM))).astype(np.float32)
    x = rng.normal(size=(T, D)).astype(np.float32)
    dy = (0.1 * rng.normal(size=(T, D))).astype(np.float32)
    return wg, w1, w2, x, dy


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _equal(got, want, msg=""):
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(want).astype(
                                      got.detach().numpy().dtype),
                                  err_msg=msg)


def test_expert_capacity():
    for args in ((24, 4, 2.0), (24, 4, 0.5), (7, 3, 1.0), (1, 8, 0.1)):
        assert pm.expert_capacity(*args) == jm.expert_capacity(*args)


@pytest.mark.parametrize("tied", [False, True])
def test_routers_match(tied):
    wg, _, _, x, _ = _inputs(1, tied)
    idx, gate = pm.route_top1(_t(wg), _t(x))
    j_idx, j_gate = jm.route_top1(jnp.asarray(wg), jnp.asarray(x))
    _equal(idx, j_idx)
    _close(gate, j_gate)
    for k, renorm in ((1, False), (2, True), (3, True)):
        idx, gates = pm.route_topk(_t(wg), _t(x), k, renorm)
        j_idx, j_gates = jm.route_topk(jnp.asarray(wg), jnp.asarray(x), k,
                                       renorm)
        _equal(idx, j_idx, f"k={k}")
        _close(gates, j_gates, f"k={k}")
    if tied:
        # the tie goes to the lower index, as lax.top_k puts it
        idx = pm.route_topk(_t(wg), _t(x), 2)[0]
        pairs = idx[(idx == 1).any(1) & (idx == 3).any(1)]
        assert len(pairs) and (pairs.tolist() == [[1, 3]] * len(pairs))
    for k in (1, 2):
        flat, gates = pm.route_flat(_t(wg), _t(x), k)
        j_flat, j_gates = jm.route_flat(jnp.asarray(wg), jnp.asarray(x), k)
        _equal(flat, j_flat)
        _close(gates, j_gates)


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_and_slot_bookkeeping_are_equal(k, cf):
    wg, _, _, x, _ = _inputs(2)
    cap = pm.expert_capacity(T, E, cf)
    flat, _ = pm.route_flat(_t(wg), _t(x), k)
    j_flat = jnp.asarray(flat.numpy())
    pos, keep = pm._slot_positions(flat, E, cap)
    j_pos, j_keep = jm._slot_positions(j_flat, E, cap)
    _equal(pos, j_pos)
    _equal(keep, j_keep)
    if cf == 0.5:
        assert not keep.all()            # the overflow case drops
    if k == 1:
        _equal(pm.dispatch_tensor(flat, E, cap),
               jm.dispatch_tensor(j_flat, E, cap))
    else:
        idx = flat.reshape(k, T).T
        _equal(pm.dispatch_tensor_topk(idx, E, cap),
               jm.dispatch_tensor_topk(jnp.asarray(idx.numpy()), E, cap))
    for got, want in zip(pm.gather_metadata(flat, T, E, cap),
                         jm.gather_metadata(j_flat, T, E, cap)):
        _equal(got, want)
    xe, dest, keep = pm.scatter_dispatch(flat, _t(x), E, cap)
    j_xe, j_dest, j_keep = jm.scatter_dispatch(j_flat, jnp.asarray(x), E,
                                               cap)
    _equal(xe, j_xe)            # each kept slot is a copy of one row
    _equal(dest, j_dest)
    _equal(keep, j_keep)


@pytest.mark.parametrize("k", [1, 2])
def test_scatter_combine_and_slot_gathers_with_gradients(k):
    wg, _, _, x, dy = _inputs(3)
    cap = pm.expert_capacity(T, E, 0.5)
    flat, gates = pm.route_flat(_t(wg), _t(x), k)
    j_flat = jnp.asarray(flat.numpy())
    gates_np = gates.detach().numpy()
    rng = np.random.default_rng(4)
    ye = rng.normal(size=(E, cap, D)).astype(np.float32)
    dest, slot_tok, slot_choice, keep = pm.gather_metadata(flat, T, E, cap)
    j_meta = jm.gather_metadata(j_flat, T, E, cap)

    y = pm.scatter_combine(_t(ye), dest, keep, _t(gates_np), T)
    _close(y, jm.scatter_combine(jnp.asarray(ye), j_meta[0], j_meta[3],
                                 jnp.asarray(gates_np), T))

    # permute_to_slots: forward and its gather VJP
    xt = _t(x, True)
    xe = pm.permute_to_slots(xt, dest, slot_tok)
    j_xe, j_vjp = jax.vjp(lambda v: jm.permute_to_slots(v, j_meta[0],
                                                        j_meta[1]),
                          jnp.asarray(x))
    _equal(xe, j_xe)
    dxe = rng.normal(size=xe.shape).astype(np.float32)
    _close(torch.autograd.grad(xe, xt, _t(dxe))[0],
           j_vjp(jnp.asarray(dxe))[0])

    # combine_from_slots: forward and its gather VJP (ye and gates)
    ye_t, g_t = _t(ye, True), _t(gates_np, True)
    y = pm.combine_from_slots(ye_t, g_t, dest, slot_tok, slot_choice, keep)
    j_y, j_vjp = jax.vjp(lambda a, b: jm.combine_from_slots(
        a, b, *j_meta), jnp.asarray(ye), jnp.asarray(gates_np))
    _close(y, j_y)
    got = torch.autograd.grad(y, (ye_t, g_t), _t(dy))
    for g, w in zip(got, j_vjp(jnp.asarray(dy))):
        _close(g, w)


def _layer_grads_match(port_fn, jax_fn, wg, w1, w2, x, dy, msg):
    leaves = [_t(a, True) for a in (wg, w1, w2, x)]
    y = port_fn(*leaves)
    j_y, j_vjp = jax.vjp(jax_fn, *map(jnp.asarray, (wg, w1, w2, x)))
    _close(y, j_y, msg)
    got = torch.autograd.grad(y, leaves, _t(dy))
    for name, g, w in zip(("wg", "w1", "w2", "x"), got,
                          j_vjp(jnp.asarray(dy))):
        _close(g, w, f"{msg} d{name}")


@pytest.mark.parametrize("dispatch", ["dense", "scatter", "gather"])
@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layers_forward_and_vjp(dispatch, k, cf):
    wg, w1, w2, x, dy = _inputs(5)
    _layer_grads_match(
        lambda *a: pm.LAYERS[dispatch](*a, cf, k),
        lambda *a: {"dense": jm.moe_layer, "scatter": jm.moe_layer_scatter,
                    "gather": jm.moe_layer_gather}[dispatch](*a, cf, k),
        wg, w1, w2, x, dy, f"{dispatch} k={k} cf={cf}")


@pytest.mark.parametrize("dispatch", ["dense", "gather"])
def test_tied_router_layer(dispatch):
    wg, w1, w2, x, dy = _inputs(6, tied=True)
    _layer_grads_match(
        lambda *a: pm.LAYERS[dispatch](*a, 2.0, 2),
        lambda *a: {"dense": jm.moe_layer,
                    "gather": jm.moe_layer_gather}[dispatch](*a, 2.0, 2),
        wg, w1, w2, x, dy, f"tied {dispatch}")


def test_router_aux_loss_and_its_gradient():
    wg, _, _, x, _ = _inputs(7)
    wt, xt = _t(wg, True), _t(x, True)
    aux = pm.router_aux_loss(wt, xt)
    j_aux, j_vjp = jax.vjp(jm.router_aux_loss, jnp.asarray(wg),
                           jnp.asarray(x))
    _close(aux, j_aux)
    got = torch.autograd.grad(aux, (wt, xt))
    for g, w in zip(got, j_vjp(jnp.float32(1.0))):
        _close(g, w)


@pytest.fixture(scope="module")
def stack():
    params = j_models.init_moe_stack(jax.random.PRNGKey(0), D, L, E,
                                     ffn_dim=F_DIM)
    return params, moe_params_from_numpy(params)


@pytest.mark.parametrize("dispatch", ["dense", "scatter", "gather"])
@pytest.mark.parametrize("k,cf", [(1, 2.0), (2, 2.0), (2, 0.5)])
def test_stack_with_aux_matches_jax_vjp(stack, dispatch, k, cf):
    j_params, params = stack
    _, _, _, x, dy = _inputs(8)
    coef = 0.01
    leaves = [t.clone().requires_grad_() for t in params]
    xt = _t(x, True)
    y, aux = pm.moe_stack_fwd_aux(MoEStackParams(*leaves), xt, cf, k,
                                  dispatch=dispatch)
    (j_y, j_aux), j_vjp = jax.vjp(
        lambda p, v: jm.moe_stack_fwd_aux(p, v, cf, k, dispatch=dispatch),
        j_params, jnp.asarray(x))
    _close(y, j_y)
    _close(aux, j_aux)
    got = torch.autograd.grad((y, aux), leaves + [xt],
                              (_t(dy), torch.tensor(coef)))
    j_grads, j_dx = j_vjp((jnp.asarray(dy), jnp.float32(coef)))
    for name, g, w in zip(("wg", "w1", "w2", "x"), got,
                          list(j_grads) + [j_dx]):
        _close(g, w, f"d{name}")
    _close(pm.moe_stack_fwd(params, _t(x), cf, k, dispatch=dispatch), j_y)
    if dispatch == "dense":
        _close(pm.moe_stack_aux(params, _t(x), cf, k), j_aux)


def test_params_carry_across_and_init_has_the_jax_layout(stack):
    j_params, params = stack
    for a, b in zip(params, j_params):
        _equal(a, b)
    assert params.num_params() == j_params.num_params()
    mine = init_moe_stack(torch.Generator().manual_seed(0), D, L, E,
                          ffn_dim=F_DIM)
    assert [tuple(t.shape) for t in mine] == [a.shape for a in j_params]
    assert (mine.n_layers, mine.n_experts, mine.d_model, mine.ffn_dim) == (
        L, E, D, F_DIM)
    # the draws: scale 0.02 normal, every tensor its own
    assert 0.015 < float(mine.w1.std()) < 0.025
    with pytest.raises(ValueError, match="unknown dispatch"):
        pm.moe_stack_fwd_aux(params, _t(np.zeros((T, D), np.float32)),
                             dispatch="sparse")
