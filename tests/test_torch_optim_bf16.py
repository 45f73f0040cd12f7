"""The port's optimizer rules on bf16 params (``optim.py``) against the
JAX package's, and the JAX promotion the port repairs.

Each rule takes three updates of JAX's bf16 ``init_ffn_stack(PRNGKey(3),
32, 4)`` params with the same numpy gradients on both sides (f32
gradients, and the same rounded to bf16). JAX's ``update`` runs op by op
(eagerly: every op rounds its bf16 result, as the port's do) and its
result is rounded to bf16 after each step, where its rule promotes (Adam
and AdamW, and every rule under a schedule's f32 LR). The port equals it
bit for bit: every Python constant rounded to the leaf's dtype before it
multiplies, and f32 wherever JAX promotes. On f32 params the rules keep
their bits (they equal JAX's op-by-op update bit for bit too).

JAX's Adam step returns f32 params from bf16 ones
(``test_jax_adam_promotes_bf16_params_to_f32`` pins it; it fails once
JAX is repaired), so JAX's scan cannot carry them; the port rounds once
a step. JAX's single-device mixed step crashes on bf16 params
(``test_jax_mixed_single_step_crashes_on_bf16``), which is why the
port's CLI refuses ``-m 1 --mixed --dtype bfloat16``.

The Adam and AdamW trainers on bf16 are held against a step-by-step
oracle: each rank's gradients from the port's ``ddp.local_grads`` (held
to JAX's by ``test_torch_train_bf16.py``), summed as the trainer's
transport sums them (``ops.ring.loopback_ref``'s ring, held to JAX's
Pallas rings by ``test_torch_ring.py``; ZeRO-1's plain rank-order sum),
then JAX's ``update`` and one rounding to bf16. Both trainers run on a
loopback mesh of four CPU threads and equal the oracle bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu import optim as j_optim
from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack, init_lm
from distributed_llm_code_samples_tpu_torch import optim
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    FFNStackParams, ffn_params_from_numpy, lm_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops.ring import loopback_ref
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, Mesh, launch, train_ddp)
from distributed_llm_code_samples_tpu_torch.parallel.ddp import local_grads
from distributed_llm_code_samples_tpu_torch.parallel.zero1 import (
    train_ddp_zero1)

from torch_serve_refs import one_thread  # noqa: F401

BF = jnp.bfloat16
D, L = 32, 4


def _uniform(p):
    """A decay mask that decays every leaf (module level: it pickles)."""
    return True


# (id, port optimizer, JAX optimizer, lr, grad scale): the clip cases'
# gradients are scaled up so the clip engages (by a power of two: see
# ``_grads``)
RULES = [
    ("momentum", optim.momentum(), j_optim.momentum(), 1e-2, 1.0),
    ("momentum-0.5", optim.momentum(0.5), j_optim.momentum(0.5), 1e-1, 1.0),
    ("adam", optim.adam(), j_optim.adam(), 1e-3, 1.0),
    ("adam-b2", optim.adam(0.8, 0.99, 1e-6), j_optim.adam(0.8, 0.99, 1e-6),
     1e-2, 1.0),
    ("adamw", optim.adamw(), j_optim.adamw(), 1e-3, 1.0),
    ("adamw-wd", optim.adamw(weight_decay=0.3), j_optim.adamw(
        weight_decay=0.3), 1e-1, 1.0),
    ("adamw-uniform", optim.adamw(decay_mask=_uniform),
     j_optim.adamw(decay_mask=lambda p: True), 1e-2, 1.0),
    ("clipped-sgd", optim.clipped(optim.sgd_optimizer(), 1.0),
     j_optim.clipped(j_optim.sgd_optimizer(), 1.0), 1e-1, 8.0),
    ("clipped-momentum", optim.clipped(optim.momentum(), 1.0),
     j_optim.clipped(j_optim.momentum(), 1.0), 1e-1, 8.0),
    ("clipped-adamw", optim.clipped(optim.adamw(), 1e-3),
     j_optim.clipped(j_optim.adamw(), 1e-3), 1e-2, 1.0),
    ("scheduled-sgd", optim.scheduled(optim.sgd_optimizer(),
                                      optim.warmup_cosine(0.1, 2, 6)),
     j_optim.scheduled(j_optim.sgd_optimizer(),
                       j_optim.warmup_cosine(0.1, 2, 6)), 999.0, 1.0),
    ("scheduled-momentum", optim.scheduled(
        optim.momentum(), optim.constant_with_warmup(0.05, 2)),
     j_optim.scheduled(j_optim.momentum(),
                       j_optim.constant_with_warmup(0.05, 2)), 999.0, 1.0),
    ("scheduled-adamw", optim.scheduled(optim.adamw(),
                                        optim.warmup_cosine(0.01, 1, 4)),
     j_optim.scheduled(j_optim.adamw(), j_optim.warmup_cosine(0.01, 1, 4)),
     999.0, 1.0),
]


def _grads(shapes, n, scale, seed=7, grid=False):
    """``n`` steps of numpy gradients. ``grid``: multiples of 1/4 up to 2
    (times a power of two), whose squares sum exactly in f32 in any
    order, so a clipped rule's norm is the same number in both
    frameworks and the test holds the rule, not the two reduction
    orders (which round the norm's last bit differently)."""
    rng = np.random.default_rng(seed)
    if grid:
        return [[(scale * 0.25 * rng.integers(-8, 9, s)).astype(np.float32)
                 for s in shapes] for _ in range(n)]
    return [[(scale * rng.standard_normal(s)).astype(np.float32)
             for s in shapes] for _ in range(n)]


def _jax_steps(opt, params, grads, lr, dtype):
    """JAX's ``update`` op by op, its params rounded back to ``dtype``
    after each step (a no-op where it keeps them)."""
    state = opt.init(params)
    with jax.disable_jit():
        for g in grads:
            params, state = opt.update(g, state, params, lr)
            params = jax.tree_util.tree_map(lambda p: p.astype(dtype),
                                            params)
    return params, state


def _port_steps(opt, params, grads, lr):
    state = opt.init(params)
    for g in grads:
        params, state = opt.update(g, state, params, lr)
    return params, state


def _bits_equal(got, want):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return np.array_equal(g, w), float((g != w).mean())


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,opt,j_opt,lr,scale", RULES,
                         ids=[r[0] for r in RULES])
def test_rule_on_bf16_params_matches_jax_bit_for_bit(
        one_thread, name, opt, j_opt, lr, scale, grad_dtype):
    params = init_ffn_stack(jax.random.PRNGKey(3), D, L, dtype=BF)
    grads = _grads([params.w1.shape, params.w2.shape], 3, scale,
                   grid=name.startswith("clipped"))
    gt = torch.bfloat16 if grad_dtype == "bf16" else torch.float32
    gj = BF if grad_dtype == "bf16" else jnp.float32
    want, _ = _jax_steps(j_opt, params, [type(params)(*(
        jnp.asarray(a).astype(gj) for a in g)) for g in grads], lr, BF)
    got, state = _port_steps(opt, ffn_params_from_numpy(params), [
        FFNStackParams(*(torch.from_numpy(a).to(gt) for a in g))
        for g in grads], lr)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        same, share = _bits_equal(g, w)
        assert same, f"{share:.4%} of the weights differ"
    # the state stays in the params' dtype (JAX's zeros_like)
    assert all(t.dtype in (torch.bfloat16, torch.int32)
               for t in optim.tree_tensors(state))
    assert not np.array_equal(got.w1.float().numpy(),
                              np.asarray(params.w1.astype(jnp.float32)))


@pytest.mark.parametrize("name,opt,j_opt,lr,scale", RULES[:7] + RULES[10:],
                         ids=[r[0] for r in RULES[:7] + RULES[10:]])
def test_rule_on_f32_params_keeps_its_bits(one_thread, name, opt, j_opt, lr,
                                           scale):
    """The repair changes no f32 bit: on f32 params every rule equals the
    rules as they were written before it (``_f32_rule``, torch's own
    arithmetic with Python floats) bit for bit (``test_torch_optim.py``
    holds them to JAX within rtol 1e-6)."""
    params = init_ffn_stack(jax.random.PRNGKey(3), D, L)
    grads = _grads([params.w1.shape, params.w2.shape], 3, scale)
    got, _ = _port_steps(opt, ffn_params_from_numpy(params), [
        FFNStackParams(*map(torch.from_numpy, g)) for g in grads], lr)
    want = _f32_rule(opt, ffn_params_from_numpy(params), [
        FFNStackParams(*map(torch.from_numpy, g)) for g in grads], lr)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def _f32_rule(opt, params, grads, lr):
    """The f32 arithmetic of the rules before the bf16 repair, written
    out: Python-float constants, no promotion."""
    if isinstance(opt, optim.Scheduled):
        inner, sched = opt.opt, opt.schedule
    else:
        inner, sched = opt, None
    ps = [t.clone() for t in params]
    vel = [torch.zeros_like(t) for t in ps]
    nu = [torch.zeros_like(t) for t in ps]
    decays = (inner.decays(params) if isinstance(inner, optim.AdamW)
              else [False] * len(ps))
    for step, g in enumerate(grads, 1):
        rate = lr if sched is None else sched(torch.tensor(step - 1))
        if isinstance(inner, optim.SGD):
            ps = [p - g_i * float(rate) for p, g_i in zip(ps, g)]
            continue
        if isinstance(inner, optim.Momentum):
            vel = [inner.beta * v + gi for v, gi in zip(vel, g)]
            ps = [p - rate * v for p, v in zip(ps, vel)]
            continue
        b1, b2, eps = inner.b1, inner.b2, inner.eps
        if isinstance(inner, optim.AdamW):
            ps = [p * (1.0 - rate * inner.weight_decay) if d else p
                  for p, d in zip(ps, decays)]
        t = torch.tensor(step, dtype=torch.float32)
        c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        vel = [b1 * m + (1.0 - b1) * gi for m, gi in zip(vel, g)]
        nu = [b2 * n + (1.0 - b2) * torch.square(gi) for n, gi in zip(nu, g)]
        ps = [p - rate * (m / c1) / (torch.sqrt(n / c2) + eps)
              for p, m, n in zip(ps, vel, nu)]
    return ps


@pytest.mark.parametrize("make", ["adamw", "momentum", "clipped-adamw"])
def test_rule_on_bf16_lm_params_matches_jax(one_thread, make):
    """The rules walk bf16 ``LMParams`` in ``lm_leaves`` order; AdamW
    decays only the leaves its path-aware mask picks."""
    pick = {"adamw": (optim.adamw(weight_decay=0.5),
                      j_optim.adamw(weight_decay=0.5)),
            "momentum": (optim.momentum(), j_optim.momentum()),
            "clipped-adamw": (optim.clipped(optim.adamw(), 1e-2),
                              j_optim.clipped(j_optim.adamw(), 1e-2))}
    opt, j_opt = pick[make]
    params = init_lm(jax.random.PRNGKey(4), 64, 16, 2, max_seq_len=8,
                     n_heads=2, dtype=BF)
    flat, tree = jax.tree_util.tree_flatten(params)
    grads = _grads([a.shape for a in flat], 3, 1.0, seed=9,
                   grid=make.startswith("clipped"))
    want, _ = _jax_steps(j_opt, params, [jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(a) for a in g]) for g in grads], 1e-2, BF)
    start = lm_params_from_numpy(params)
    got, _ = _port_steps(opt, start, [start.with_leaves(
        [torch.from_numpy(a) for a in g]) for g in grads], 1e-2)
    for g, w in zip(optim.leaves(got), jax.tree_util.tree_leaves(want)):
        same, share = _bits_equal(g, w)
        assert same, f"{share:.4%} of a leaf differ"


def test_constants_round_to_the_leaf_dtype_first():
    """The two causes of the fault the repair fixes: a weak-typed
    constant is rounded to bf16 before it multiplies (``weak``), and an
    f32 tensor promotes a bf16 leaf (``scale_by``), where torch keeps
    the 0-d tensor's product in bf16."""
    x = torch.tensor([3.0], dtype=torch.bfloat16)
    assert optim.weak(0.9, x) == 0.8984375
    assert optim.weak(0.999, x) == 1.0
    assert optim.weak(0.9, x.float()) == float(np.float32(0.9))
    c = torch.tensor(0.1, dtype=torch.float32)
    assert (x / c).dtype == torch.bfloat16          # torch's rule
    assert optim.scale_by(c, x).dtype == torch.float32
    assert optim.scale_by(0.9, x).item() == float(
        (jnp.asarray([3.0], BF) * 0.9)[0])


def test_jax_adam_promotes_bf16_params_to_f32():
    """Pins the fault of the reference the port repairs: JAX's Adam and
    AdamW step turns bf16 params into f32 (its f32 bias corrections
    promote ``m / c1`` and the step), so its scan's carry changes type
    and ``-m 2 --optimizer adam --dtype bfloat16`` crashes. This test
    fails once JAX keeps the params' dtype; the port's rounding then
    needs a second look."""
    params = init_ffn_stack(jax.random.PRNGKey(3), D, L, dtype=BF)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    for opt in (j_optim.adam(), j_optim.adamw()):
        new, state = opt.update(grads, opt.init(params), params, 1e-3)
        assert new.w1.dtype == jnp.float32 and new.w2.dtype == jnp.float32
        assert state.mu.w1.dtype == BF
    # momentum and SGD keep bf16 under a float LR
    new, _ = j_optim.momentum().update(grads, j_optim.momentum().init(
        params), params, 1e-3)
    assert new.w1.dtype == BF


def test_jax_mixed_single_step_crashes_on_bf16():
    """Pins the other fault: JAX's single-device mixed step on bf16
    params fails in a VJP that gets bf16 cotangents where it expects
    f32, so ``-m 1`` (and ``-m 0``) ``--mixed --dtype bfloat16`` has no
    JAX step, and the port's CLI refuses it (exit 2)."""
    from distributed_llm_code_samples_tpu.parallel import train_single
    params = init_ffn_stack(jax.random.PRNGKey(3), 8, 1, dtype=BF)
    with pytest.raises(Exception, match="float32|bfloat16"):
        train_single(params, np.asarray([1, 2], np.int32), 16, 8, lr=0.1,
                     mixed=True)


# -- the trainers under Adam and AdamW, against the step-by-step oracle ------

N, TOKENS, LR = 4, 32, 1e-2


def _oracle(params, seeds, table, j_opt, sum_layer, zero1=False):
    """The Adam family's DDP on bf16 params, step by step: the port's
    per-rank gradients, summed layer by layer by ``sum_layer`` (the
    transport's order), JAX's update op by op, rounded to bf16."""
    state = j_opt.init(params)
    cur = params
    for t in range(len(seeds) // N):
        port = ffn_params_from_numpy(cur)
        per_rank = [local_grads(port, int(seeds[t * N + r]), TOKENS, D,
                                batch_fn=table) for r in range(N)]
        summed = [torch.stack([sum_layer([g[i][layer] for g in per_rank])
                               for layer in range(L)]) for i in range(2)]
        grads = type(params)(*(jnp.asarray(s.float().numpy()).astype(BF)
                               for s in summed))
        with jax.disable_jit():
            if zero1:
                # ZeRO-1: each rank's update on its own L/n layers
                news, states = [], []
                k = L // N
                for r in range(N):
                    sl = lambda tr: jax.tree_util.tree_map(  # noqa: E731
                        lambda a: a[r * k:(r + 1) * k] if a.ndim == 3
                        else a, tr)
                    p, s = j_opt.update(sl(grads), sl(state), sl(cur), LR)
                    news.append(p)
                    states.append(s)
                cur = type(params)(*(jnp.concatenate(
                    [getattr(p, f) for p in news]).astype(BF)
                    for f in params._fields))
                state = jax.tree_util.tree_map(
                    lambda *xs: jnp.concatenate(xs) if xs[0].ndim == 3
                    else xs[0], *states)
            else:
                cur, state = j_opt.update(grads, state, cur, LR)
                cur = jax.tree_util.tree_map(lambda p: p.astype(BF), cur)
    return cur


def _ring_sum(xs):
    return loopback_ref("ring_all_reduce", [x.contiguous() for x in xs])[0]


def _plain_sum(xs):
    total = xs[0].clone()
    for x in xs[1:]:
        total += x
    return total


@pytest.fixture(scope="module")
def dp_setup():
    params = init_ffn_stack(jax.random.PRNGKey(0), D, L, dtype=BF)
    seeds = np.asarray(make_seed_schedule(2 * N, 7))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), TOKENS, D))
                        for s in seeds})
    return params, seeds, table


@pytest.mark.parametrize("trainer", ["ddp-ring", "zero1"])
@pytest.mark.parametrize("rule", ["adam", "adamw"])
def test_adam_trainers_on_bf16_match_the_oracle(one_thread, dp_setup,
                                                trainer, rule):
    params, seeds, table = dp_setup
    opt, j_opt = {"adam": (optim.adam(), j_optim.adam()),
                  "adamw": (optim.adamw(decay_mask=_uniform),
                            j_optim.adamw(decay_mask=lambda p: True))}[rule]
    mesh = Mesh({DATA_AXIS: N}, "cpu", loopback=True)
    start = ffn_params_from_numpy(params)
    if trainer == "ddp-ring":
        def body(me, _):
            return train_ddp(start, seeds, TOKENS, D, me, LR, optimizer=opt,
                             comm="pallas_ring", batch_fn=table)
        want = _oracle(params, seeds, table, j_opt, _ring_sum)
    else:
        def body(me, _):
            return train_ddp_zero1(start, seeds, TOKENS, D, me, LR,
                                   optimizer=opt, batch_fn=table)
        want = _oracle(params, seeds, table, j_opt, _plain_sum, zero1=True)
    got = launch(body, mesh, timeout=120)[0]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        same, share = _bits_equal(g, w)
        assert same, f"{share:.4%} of the weights differ"
