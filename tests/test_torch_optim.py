"""The port's optimizers (``optim.py``), ZeRO-1 (``parallel/zero1.py``) and
the stateful DDP and FSDP against the JAX package's, on the CPU.

The optimizers: each rule, clipping and schedule takes three updates of
the JAX ``init_ffn_stack(PRNGKey(3), 32, 4)`` params (and of an LM's)
with the same numpy gradients on both sides; every leaf within rtol
1e-6, atol 1e-7 (the JAX package holds its rules to optax at that
tolerance, ``test_optim.py``).

The strategies, as ``test_optim.py`` sets them up: d 32, 4 layers, 32
tokens a rank a step, the 8 seeds of ``make_seed_schedule(8, 11)`` on
four gloo ranks (2 steps a rank), LR 0.1 (the package's 1e-5 for the
accumulation and schedule cases, as there). The port trains on the JAX
batches (``BatchTable``); all its runs share one spawn of four ranks,
the resumed segments a second. Each is held against JAX's DDP with the
same optimizer on the conftest ``mesh4`` (JAX's Pallas rings in
interpret mode under ``"pallas_ring"``) within rtol 1e-5, atol 1e-6, as
``test_torch_train_dist.py`` holds the SGD strategies.
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
from distributed_llm_code_samples_tpu.parallel import train_ddp as j_ddp
from distributed_llm_code_samples_tpu_torch import optim
from distributed_llm_code_samples_tpu_torch.data import BatchTable
from distributed_llm_code_samples_tpu_torch.models import (
    FFNStackParams, ffn_params_from_numpy, lm_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, launch, make_mesh, train_ddp, train_fsdp, unshard_params)
from distributed_llm_code_samples_tpu_torch.parallel.fsdp import (
    shard_state, unshard_state)
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, PerRank, call_each)
from distributed_llm_code_samples_tpu_torch.parallel import zero1
from distributed_llm_code_samples_tpu_torch.parallel.zero1 import (
    train_ddp_zero1)

D, L, B, S, N, LR = 32, 4, 32, 8, 4, 0.1
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
DIST_TOL = dict(rtol=1e-5, atol=1e-6)
# The Adam family divides by the root of the second moment, so a gradient
# element that cancels to ~1e-9 in one framework's summation order and
# ~1e-10 in the other's moves by a different fraction of the LR (up to
# the whole LR a step): such a run is held within rtol 1e-5, atol 1e-5 on
# all but 0.5% of the elements and within the LR (0.1) on every element.
ADAM_TOL = dict(rtol=1e-5, atol=1e-5, outliers=5e-3, bound=LR)


def _uniform(p):
    """A decay mask that decays every leaf (module level: it pickles)."""
    return True


# -- the optimizers -----------------------------------------------------------

# (id, port optimizer, JAX optimizer, lr, grad scale): the clip cases'
# gradients are scaled up so the clip engages
RULES = [
    ("sgd", optim.sgd_optimizer(), j_optim.sgd_optimizer(), 1e-2, 1.0),
    ("momentum", optim.momentum(), j_optim.momentum(), 1e-2, 1.0),
    ("momentum-0.5", optim.momentum(0.5), j_optim.momentum(0.5), 1e-2, 1.0),
    ("adam", optim.adam(), j_optim.adam(), 1e-2, 1.0),
    ("adam-b2", optim.adam(0.8, 0.99, 1e-6), j_optim.adam(0.8, 0.99, 1e-6),
     1e-2, 1.0),
    ("adamw", optim.adamw(), j_optim.adamw(), 1e-2, 1.0),
    ("adamw-wd", optim.adamw(weight_decay=0.3), j_optim.adamw(
        weight_decay=0.3), 1e-1, 1.0),
    ("adamw-uniform", optim.adamw(decay_mask=_uniform),
     j_optim.adamw(decay_mask=lambda p: True), 1e-2, 1.0),
    ("clipped-sgd", optim.clipped(optim.sgd_optimizer(), 1.0),
     j_optim.clipped(j_optim.sgd_optimizer(), 1.0), 1e-2, 10.0),
    ("clipped-adam", optim.clipped(optim.adam(), 1e-3),
     j_optim.clipped(j_optim.adam(), 1e-3), 1e-2, 1.0),
    ("clipped-identity", optim.clipped(optim.sgd_optimizer(), 1e4),
     j_optim.clipped(j_optim.sgd_optimizer(), 1e4), 1e-2, 1.0),
    ("scheduled-sgd", optim.scheduled(optim.sgd_optimizer(),
                                      optim.warmup_cosine(0.1, 2, 6)),
     j_optim.scheduled(j_optim.sgd_optimizer(),
                       j_optim.warmup_cosine(0.1, 2, 6)), 999.0, 1.0),
    ("scheduled-adam", optim.scheduled(optim.adam(),
                                       optim.constant_with_warmup(0.5, 2)),
     j_optim.scheduled(j_optim.adam(), j_optim.constant_with_warmup(0.5, 2)),
     999.0, 1.0),
]


def _grads(shapes, n, scale, seed=7):
    rng = np.random.default_rng(seed)
    return [[(scale * rng.standard_normal(s)).astype(np.float32)
             for s in shapes] for _ in range(n)]


def _run_port(opt, params, grads, lr):
    state = opt.init(params)
    for g in grads:
        params, state = opt.update(g, state, params, lr)
    return params, state


def _run_jax(opt, params, grads, lr):
    state = opt.init(params)
    for g in grads:
        params, state = opt.update(g, state, params, lr)
    return params


@pytest.mark.parametrize("name,opt,j_opt,lr,scale", RULES,
                         ids=[r[0] for r in RULES])
def test_optimizer_matches_jax(name, opt, j_opt, lr, scale):
    params = init_ffn_stack(jax.random.PRNGKey(3), D, L)
    grads = _grads([params.w1.shape, params.w2.shape], 3, scale)
    want = _run_jax(j_opt, params, [type(params)(*map(jnp.asarray, g))
                                    for g in grads], lr)
    got, _ = _run_port(opt, ffn_params_from_numpy(params),
                       [FFNStackParams(*map(torch.from_numpy, g))
                        for g in grads], lr)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPT_TOL)
    # three updates moved the weights
    assert not np.allclose(got.w1.numpy(), np.asarray(params.w1), rtol=1e-3)


@pytest.mark.parametrize("make", ["adamw", "momentum", "clipped-adamw"])
def test_optimizer_on_lm_params_matches_jax(make):
    """The rules walk ``LMParams`` in ``lm_leaves`` order with the grads
    in that order; AdamW decays only the leaves its path-aware mask
    picks."""
    pick = {"adamw": (optim.adamw(weight_decay=0.5),
                      j_optim.adamw(weight_decay=0.5)),
            "momentum": (optim.momentum(), j_optim.momentum()),
            "clipped-adamw": (optim.clipped(optim.adamw(), 1e-2),
                              j_optim.clipped(j_optim.adamw(), 1e-2))}
    opt, j_opt = pick[make]
    jp = init_lm(jax.random.PRNGKey(1), 64, 16, 2, 8, n_heads=2)
    leaves, tree = jax.tree_util.tree_flatten(jp)
    grads = _grads([l.shape for l in leaves], 3, 1.0)
    want = _run_jax(j_opt, jp, [jax.tree_util.tree_unflatten(
        tree, list(map(jnp.asarray, g))) for g in grads], 0.1)
    got, _ = _run_port(opt, lm_params_from_numpy(jp),
                       [list(map(torch.from_numpy, g)) for g in grads], 0.1)
    for (name, g), w in zip(got.named_leaves(),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPT_TOL,
                                   err_msg=name)


def test_adamw_default_mask_pins_the_lm_leaves():
    """The path-aware default (JAX ``optim.py:138-142``): matmul weights
    and embedding tables decay; the stacked LN gains ``[L, d]`` (2-D, but
    named ``ln*``) and the final ``ln_f`` do not."""
    jp = init_lm(jax.random.PRNGKey(1), 64, 16, 2, 8, n_heads=2)
    port = lm_params_from_numpy(jp)
    decays = dict(zip([n for n, _ in port.named_leaves()],
                      optim.adamw().decays(port)))
    assert decays == {"wte": True, "wpe": True, "ln1": False, "wq": True,
                      "wk": True, "wv": True, "wo": True, "ln2": False,
                      "w1": True, "w2": True, "ln_f": False}
    assert optim.adamw(decay_mask=_uniform).decays(port) == [True] * 11
    ffn = ffn_params_from_numpy(init_ffn_stack(jax.random.PRNGKey(3), D, L))
    assert optim.adamw().decays(ffn) == [True, True]


def test_global_norm_and_schedules_match_jax():
    params = init_ffn_stack(jax.random.PRNGKey(3), D, L)
    g = _grads([params.w1.shape, params.w2.shape], 1, 3.0)[0]
    np.testing.assert_allclose(
        float(optim.global_norm(FFNStackParams(*map(torch.from_numpy, g)))),
        float(j_optim.global_norm(type(params)(*map(jnp.asarray, g)))),
        rtol=1e-6)
    for port, jx in ((optim.warmup_cosine(1.0, 10, 100, 0.1),
                      j_optim.warmup_cosine(1.0, 10, 100, 0.1)),
                     (optim.constant_with_warmup(0.5, 4),
                      j_optim.constant_with_warmup(0.5, 4))):
        got = [float(port(torch.tensor(t, dtype=torch.int32)))
               for t in range(110)]
        want = [float(jx(jnp.int32(t))) for t in range(110)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_state_contract_and_refusals():
    params = ffn_params_from_numpy(init_ffn_stack(jax.random.PRNGKey(3), D,
                                                  L))
    with pytest.raises(ValueError, match="need an optimizer"):
        optim.check_state_args(None, object(), False)
    with pytest.raises(ValueError, match="max_norm"):
        optim.clipped(optim.adam(), 0.0)
    state = optim.adam().init(params)
    assert state.count.dtype == torch.int32 and int(state.count) == 0
    assert state.mu.w1.shape == params.w1.shape
    assert optim.sgd_optimizer().init(params) == ()
    assert optim.sgd_optimizer().stateless
    assert not optim.adam().stateless
    assert set(optim.OPTIMIZERS) == set(j_optim.OPTIMIZERS)
    # the sharded clip needs the rank's mesh to sum its norm over
    with pytest.raises(ValueError, match="mesh"):
        optim.clipped(optim.adam(), 1.0, axis=DATA_AXIS).update(
            params, state, params, 0.1)
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    with pytest.raises(ValueError, match="need an optimizer"):
        train_ddp(params, np.arange(8), B, D, mesh, return_state=True)
    with pytest.raises(ValueError, match="whole-layer"):
        train_ddp_zero1(FFNStackParams(params.w1[:3], params.w2[:3]),
                        np.arange(8), B, D, mesh)


@pytest.mark.parametrize("strategy", ["fsdp", "zero1"])
def test_state_shards_and_reassembles(strategy):
    """``shard_state`` splits the param-shaped leaves as the strategy
    splits them (FSDP: each layer's dim 0; ZeRO-1: whole layers) and
    copies the count; ``unshard_state`` joins them back."""
    shard, unshard = {"fsdp": (shard_state, unshard_state),
                      "zero1": (zero1.shard_state,
                                zero1.unshard_state)}[strategy]
    params = ffn_params_from_numpy(init_ffn_stack(jax.random.PRNGKey(3), D,
                                                  L))
    state = optim.adam().init(params)
    state = state._replace(mu=FFNStackParams(params.w1 + 1, params.w2 - 1),
                           count=state.count + 5)
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    shards = [shard(state, mesh.for_rank(r)) for r in range(N)]
    want = {"fsdp": ((L, 4 * D // N, D), (L, D // N, 4 * D)),
            "zero1": ((L // N, 4 * D, D), (L // N, D, 4 * D))}[strategy]
    assert (shards[1].mu.w1.shape, shards[1].nu.w2.shape) == want
    assert int(shards[3].count) == 5
    back = unshard(shards)
    for a, b in zip(optim.tree_tensors(back), optim.tree_tensors(state)):
        assert torch.equal(a, b)


# -- the strategies -----------------------------------------------------------

def _opts():
    """(id, port, JAX) optimizer pairs of the strategy runs."""
    return {"momentum": (optim.momentum(), j_optim.momentum()),
            "adam": (optim.adam(), j_optim.adam()),
            "adamw": (optim.adamw(), j_optim.adamw()),
            "sgd": (optim.sgd_optimizer(), j_optim.sgd_optimizer())}


# (run id, port strategy, optimizer id, LR, port kwargs, JAX DDP kwargs):
# each is held against JAX's train_ddp with the same optimizer. SGD and
# momentum move the weights linearly in the LR: at 100 they move ~1e-3,
# far past the tolerance; the Adam family moves them ~LR a step.
RUNS = [
    ("ddp-momentum", "ddp", "momentum", 100.0, {}, {}),
    ("ddp-adam", "ddp", "adam", LR, {}, {}),
    ("ddp-adamw", "ddp", "adamw", LR, {}, {}),
    ("ddp-adam-ring", "ddp", "adam", LR, {"comm": "pallas_ring"},
     {"comm": "pallas_ring"}),
    ("ddp-adam-accum", "ddp", "adam", LR, {"accum": 2}, {"accum": 2}),
    ("ddp-adam-accum-ring", "ddp", "adam", LR,
     {"accum": 2, "comm": "pallas_ring"}, {"accum": 2}),
    ("zero1-momentum", "zero1", "momentum", 100.0, {}, {}),
    ("zero1-adam", "zero1", "adam", LR, {}, {}),
    ("zero1-adamw", "zero1", "adamw", LR, {}, {}),
    ("zero1-sgd", "zero1", "sgd", 100.0, {}, {}),
    ("fsdp-momentum", "fsdp", "momentum", 100.0, {}, {}),
    ("fsdp-adam", "fsdp", "adam", LR, {}, {}),
    ("fsdp-adamw", "fsdp", "adamw", LR, {}, {}),
    ("fsdp-adam-ring", "fsdp", "adam", LR, {"comm": "pallas_ring"}, {}),
]
# clipping: the sharded updates sum their norm over the data axis and
# must clip as DDP's update over the whole gradient does
CLIP = 1e-3
CLIP_RUNS = [("ddp-clip", "ddp", None), ("zero1-clip", "zero1", DATA_AXIS),
             ("fsdp-clip", "fsdp", DATA_AXIS),
             ("fsdp-clip-ring", "fsdp", DATA_AXIS)]
# at the package's LR, as test_optim.py's accumulation and schedule cases
SMALL_LR_RUNS = [("zero1-adam-lr", "zero1", {}),
                 ("zero1-adam-accum", "zero1", {"accum": 4}),
                 ("zero1-scheduled", "zero1", {"scheduled": True}),
                 ("ddp-scheduled", "ddp", {"scheduled": True})]
TRAIN = {"ddp": train_ddp, "zero1": train_ddp_zero1, "fsdp": train_fsdp}


@pytest.fixture(scope="module")
def setup():
    params = init_ffn_stack(jax.random.PRNGKey(3), D, L)
    seeds = np.asarray(make_seed_schedule(S, random_seed=11))
    table = BatchTable({int(s): tuple(np.asarray(a) for a in
                                      j_batch(jnp.int32(s), B, D))
                        for s in seeds})
    return params, seeds, table


def _scheduled(port: bool):
    if port:
        return optim.scheduled(optim.adam(), optim.warmup_cosine(0.1, 2, S))
    return j_optim.scheduled(j_optim.adam(),
                             j_optim.warmup_cosine(0.1, 2, S))


@pytest.fixture(scope="module")
def port_runs(setup):
    """Every port run in one launch of four ranks: ``{run id: [per-rank
    result]}``; then the resumed second segments in a second launch."""
    params, seeds, table = setup
    start = ffn_params_from_numpy(params)
    calls, ids = [], []

    def add(run_id, strategy, kw):
        calls.append((TRAIN[strategy], (start, seeds, B, D, MESH),
                      dict(batch_fn=table, **kw)))
        ids.append(run_id)

    for run_id, strategy, opt_id, lr, kw, _ in RUNS:
        add(run_id, strategy, dict(lr=lr, optimizer=_opts()[opt_id][0], **kw))
    for run_id, strategy, axis in CLIP_RUNS:
        kw = {"comm": "pallas_ring"} if run_id.endswith("ring") else {}
        add(run_id, strategy, dict(lr=LR, optimizer=optim.clipped(
            optim.adam(), CLIP, axis=axis), **kw))
    for run_id, strategy, kw in SMALL_LR_RUNS:
        kw = dict(kw)
        opt = _scheduled(True) if kw.pop("scheduled", False) else optim.adam()
        add(run_id, strategy, dict(optimizer=opt, **kw))
    # the plain DDP (ZeRO-1 with SGD must equal it) and the first segments
    # of the resumed runs, with their states
    add("ddp-plain", "ddp", dict(lr=100.0))
    for strategy in TRAIN:
        calls.append((TRAIN[strategy], (start, seeds[:4], B, D, MESH),
                      dict(lr=LR, optimizer=optim.adam(), batch_fn=table,
                           return_state=True)))
        ids.append(f"{strategy}-first")
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    outs = launch(call_each, mesh, calls, timeout=300)
    runs = {i: [outs[r][k] for r in range(N)] for k, i in enumerate(ids)}

    # the second segments, from the first's params and states
    ddp_p, ddp_s = runs["ddp-first"][0]
    z1_p = runs["zero1-first"][0][0]
    fsdp_p = unshard_params([o[0] for o in runs["fsdp-first"]])
    second = [
        (train_ddp, (ddp_p, seeds[4:], B, D, MESH), dict(opt_state=ddp_s)),
        (train_ddp_zero1, (z1_p, seeds[4:], B, D, MESH),
         dict(opt_state=PerRank(o[1] for o in runs["zero1-first"]))),
        (train_fsdp, (fsdp_p, seeds[4:], B, D, MESH),
         dict(opt_state=PerRank(o[1] for o in runs["fsdp-first"])))]
    for _, _, kw in second:
        kw.update(lr=LR, optimizer=optim.adam(), batch_fn=table)
    outs = launch(call_each, mesh, second, timeout=300)
    for k, strategy in enumerate(TRAIN):
        runs[f"{strategy}-resumed"] = [outs[r][k] for r in range(N)]
    return start, runs


def _full(strategy, per_rank):
    """The full params of a run from its per-rank results (FSDP: the
    shards joined; DDP and ZeRO-1: the replicas, equal bit for bit)."""
    per_rank = [o[0] if isinstance(o, tuple) and not hasattr(o, "_fields")
                else o for o in per_rank]
    if strategy == "fsdp":
        return unshard_params(per_rank)
    for replica in per_rank[1:]:
        for a, b in zip(replica, per_rank[0]):
            assert torch.equal(a, b)
    return per_rank[0]


def _close(got, want, tol=DIST_TOL):
    tol = dict(tol)
    outliers, bound = tol.pop("outliers", 0.0), tol.pop("bound", None)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if not outliers:
            np.testing.assert_allclose(g, w, **tol)
            continue
        off = ~np.isclose(g, w, **tol)
        assert off.mean() <= outliers, (off.sum(), off.size)
        np.testing.assert_allclose(g, w, rtol=0, atol=bound)


@pytest.mark.parametrize("run_id,strategy,opt_id,lr,kw,jkw", RUNS,
                         ids=[r[0] for r in RUNS])
def test_strategy_matches_jax_ddp(mesh4, setup, port_runs, run_id, strategy,
                                  opt_id, lr, kw, jkw):
    params, seeds, _ = setup
    start, runs = port_runs
    want = j_ddp(params, jnp.asarray(seeds), B, D, mesh4, lr=lr,
                 optimizer=_opts()[opt_id][1], **jkw)
    got = _full(strategy, runs[run_id])
    _close(got, want, DIST_TOL if opt_id in ("sgd", "momentum")
           else ADAM_TOL)
    # the run moved the weights by 100x the tolerance
    assert float((got.w1 - start.w1).abs().max()) > 1e-4


@pytest.mark.parametrize("run_id,strategy,axis", CLIP_RUNS,
                         ids=[r[0] for r in CLIP_RUNS])
def test_clipped_strategy_matches_jax_ddp(mesh4, setup, port_runs, run_id,
                                          strategy, axis):
    params, seeds, _ = setup
    _, runs = port_runs
    want = j_ddp(params, jnp.asarray(seeds), B, D, mesh4, lr=LR,
                 optimizer=j_optim.clipped(j_optim.adam(), CLIP))
    _close(_full(strategy, runs[run_id]), want, ADAM_TOL)


@pytest.mark.parametrize("run_id,strategy,kw", SMALL_LR_RUNS,
                         ids=[r[0] for r in SMALL_LR_RUNS])
def test_package_lr_runs_match_jax(mesh4, setup, port_runs, run_id,
                                   strategy, kw):
    """ZeRO-1 with accumulation equals the full batch, and the schedule
    composes with the state sharding: each against JAX's DDP."""
    params, seeds, _ = setup
    _, runs = port_runs
    opt = _scheduled(False) if kw.get("scheduled") else j_optim.adam()
    want = j_ddp(params, jnp.asarray(seeds), B, D, mesh4, optimizer=opt)
    _close(_full(strategy, runs[run_id]), want, ADAM_TOL)


def test_zero1_sgd_equals_plain_ddp(port_runs):
    _, runs = port_runs
    _close(_full("zero1", runs["zero1-sgd"]),
           _full("ddp", runs["ddp-plain"]), dict(rtol=1e-6, atol=1e-7))


def test_zero1_accum_equals_full_batch(port_runs):
    _, runs = port_runs
    _close(_full("zero1", runs["zero1-adam-accum"]),
           _full("zero1", runs["zero1-adam-lr"]))


@pytest.mark.parametrize("strategy", ["ddp", "zero1", "fsdp"])
def test_state_shapes_a_rank(port_runs, strategy):
    """DDP's Adam state is a replica, ZeRO-1's the rank's ``L/n`` layers,
    FSDP's the rank's shards of every layer."""
    _, runs = port_runs
    want = {"ddp": ((L, 4 * D, D), (L, D, 4 * D)),
            "zero1": ((L // N, 4 * D, D), (L // N, D, 4 * D)),
            "fsdp": ((L, 4 * D // N, D), (L, D // N, 4 * D))}[strategy]
    for r, (_, state) in enumerate(runs[f"{strategy}-first"]):
        assert isinstance(state, optim.AdamState)
        assert (tuple(state.mu.w1.shape), tuple(state.nu.w2.shape)) == want
        assert state.mu.w1.dtype == torch.float32
        assert int(state.count) == 1, r      # 4 seeds: one step a rank


@pytest.mark.parametrize("strategy", ["ddp", "zero1", "fsdp"])
def test_two_segments_equal_one_run(mesh4, setup, port_runs, strategy):
    """A run resumed from the first segment's params and Adam state ends
    where one run over both segments ends (and where JAX's does)."""
    params, seeds, _ = setup
    _, runs = port_runs
    want = j_ddp(params, jnp.asarray(seeds), B, D, mesh4, lr=LR,
                 optimizer=j_optim.adam())
    got = _full(strategy, runs[f"{strategy}-resumed"])
    one = _full(strategy, runs[f"{strategy}-adam"])
    _close(got, one, dict(rtol=1e-6, atol=1e-7))
    _close(got, want, ADAM_TOL)


def test_launched_trainers_carry_the_state(setup):
    """Given the whole mesh, DDP returns rank 0's replicated state, FSDP
    and ZeRO-1 the state re-assembled from the ranks' shards; each
    resumes from it."""
    params, seeds, table = setup
    start = ffn_params_from_numpy(params)
    mesh = make_mesh({DATA_AXIS: N}, device="cpu")
    kw = dict(lr=LR, optimizer=optim.adam(), batch_fn=table, timeout=120)
    p, s = train_ddp(start, seeds[:4], B, D, mesh, return_state=True, **kw)
    ddp = train_ddp(p, seeds[4:], B, D, mesh, opt_state=s, **kw)
    for train in (train_fsdp, train_ddp_zero1):
        p, s = train(start, seeds[:4], B, D, mesh, return_state=True, **kw)
        assert s.mu.w1.shape == start.w1.shape and int(s.count) == 1
        _close(train(p, seeds[4:], B, D, mesh, opt_state=s, **kw), ddp,
               ADAM_TOL)
