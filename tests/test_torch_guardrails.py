"""The port's guardrail functions (``runtime/guardrails.py``) against the
JAX package's, unit by unit, on the CPU.

``advance`` over the same flag sequences gives the same counters and
scale, bit for bit; ``finite_flag``, ``unscale_grads``,
``clip_by_global_norm`` (also over a shard axis of four loopback CPU
threads against JAX's on the whole gradients), ``finalize_grads``,
``anomaly_delta``, ``check_guard_args``, ``require_mixed_for_scaling``,
``mesh_world``, ``host_state``, ``init_state``/``summarize`` and
``delta_norm`` as JAX's. The clipping cases take gradients on a grid of
quarters whose squares sum exactly in f32 in any order, so both norms
are one number and the results are bit for bit; the float64
``delta_norm`` is held within 1e-12 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.runtime import guardrails as jg
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, Mesh, launch)
from distributed_llm_code_samples_tpu_torch.runtime import guardrails as pg

from torch_serve_refs import one_thread  # noqa: F401

FLAGS = [
    [1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1],
]
CONFIGS = [
    dict(),
    dict(loss_scale=1024.0, growth_interval=2),
    dict(loss_scale=2.0 ** 15, growth_interval=3, scale_backoff=0.25,
         min_scale=64.0),
    dict(loss_scale=8.0, growth_interval=1, scale_growth=4.0, min_scale=1.0),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["off", "grow2", "quarter",
                                              "grow4"])
@pytest.mark.parametrize("flags", FLAGS, ids=[f"seq{i}" for i in
                                              range(len(FLAGS))])
def test_advance_matches_jax(one_thread, cfg, flags):
    jcfg, pcfg = jg.GuardrailConfig(**cfg), pg.GuardrailConfig(**cfg)
    js, ps = jg.init_state(jcfg), pg.init_state(pcfg)
    assert jg.summarize(js) == pg.summarize(ps)
    for f in flags:
        js = jg.advance(jcfg, js, jnp.asarray(bool(f)))
        ps = pg.advance(pcfg, ps, torch.tensor(bool(f)))
        assert jg.summarize(js) == pg.summarize(ps)
    assert [t.dtype for t in ps] == [torch.int32, torch.int32,
                                     torch.float32, torch.int32]
    assert all(t.dim() == 0 for t in ps)


def test_finite_flag_over_trees():
    assert bool(pg.finite_flag({"a": torch.ones(3), "n": torch.arange(3)}))
    assert not bool(pg.finite_flag((torch.ones(3),
                                    torch.tensor([1.0, float("nan")]))))
    assert not bool(pg.finite_flag([torch.tensor([float("inf")],
                                                 dtype=torch.bfloat16)]))
    # integer leaves never poison the flag (Adam's count)
    assert bool(pg.finite_flag({"count": torch.tensor(7, dtype=torch.int32)}))
    assert pg.finite_flag(torch.ones(2)).dim() == 0


def _grid(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(0.25 * rng.integers(-8, 9, s)).astype(np.float32)
            for s in shapes]


SHAPES = [(4, 16, 8), (4, 8, 16)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm_matches_jax(dtype, max_norm):
    gs = _grid(1, SHAPES)
    jt = [jnp.asarray(g).astype(jnp.bfloat16 if dtype == "bf16"
                                else jnp.float32) for g in gs]
    pt = [torch.from_numpy(g).to(torch.bfloat16 if dtype == "bf16"
                                 else torch.float32) for g in gs]
    want = jg.clip_by_global_norm(jt, max_norm)
    got = pg.clip_by_global_norm(pt, max_norm)
    for g, w in zip(got, want):
        assert g.dtype == pt[0].dtype
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w.astype(jnp.float32)))


def _clip_shard(mesh, payload):
    shards, max_norm = payload
    mine = [s[mesh.rank] for s in shards]
    return pg.clip_by_global_norm(mine, max_norm, mesh, axis=DATA_AXIS)


def test_clip_over_a_shard_axis_matches_jax_on_the_whole():
    """Four loopback CPU threads each clip their shard with the squared
    norm summed over the data axis: the shards are JAX's clip of the
    whole gradients."""
    gs = _grid(2, SHAPES)
    want = jg.clip_by_global_norm([jnp.asarray(g) for g in gs], 0.5)
    shards = [torch.from_numpy(g).chunk(4, 1) for g in gs]
    outs = launch(_clip_shard, Mesh({DATA_AXIS: 4}, "cpu", loopback=True),
                  (shards, 0.5), timeout=60)
    for i, w in enumerate(want):
        got = torch.cat([o[i] for o in outs], 1)
        assert np.array_equal(got.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="mesh"):
        pg.clip_by_global_norm([torch.ones(2)], 1.0, axis=DATA_AXIS)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unscale_and_finalize_match_jax(dtype):
    gs = _grid(3, SHAPES)
    jdt, pdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jt = [jnp.asarray(g).astype(jdt) * 1024 for g in gs]
    pt = [torch.from_numpy(g).to(pdt) * 1024 for g in gs]
    scale_j, scale_p = jnp.asarray(1024.0), torch.tensor(1024.0)
    for w, g in zip(jg.unscale_grads(jt, scale_j),
                    pg.unscale_grads(pt, scale_p)):
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w.astype(jnp.float32)))
    cfg_j = jg.GuardrailConfig(clip_norm=0.5, loss_scale=1024.0)
    cfg_p = pg.GuardrailConfig(clip_norm=0.5, loss_scale=1024.0)
    for w, g in zip(jg.finalize_grads(jt, scale_j, cfg_j),
                    pg.finalize_grads(pt, scale_p, cfg_p)):
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w.astype(jnp.float32)))
    # no scale and no guard: the gradients as they are
    assert pg.finalize_grads(pt, None, None) is pt


def test_anomaly_delta_matches_jax():
    prev = {"skipped": 1, "overflows": 1, "loss_scale": 512.0,
            "good_steps": 0}
    cur = {"skipped": 3, "overflows": 1, "loss_scale": 512.0,
           "good_steps": 4}
    assert pg.anomaly_delta(prev, cur, 8, [5, 8]) == jg.anomaly_delta(
        prev, cur, 8, [5, 8]) == {
        "step": 8, "steps": [5, 8], "skipped": 2, "total_skipped": 3,
        "overflows": 0, "total_overflows": 1, "loss_scale": 512.0}
    assert pg.anomaly_delta(cur, cur, 12, [9, 12]) is None
    assert jg.anomaly_delta(cur, cur, 12, [9, 12]) is None


@pytest.mark.parametrize("args,err", [
    ((None, None, True), ValueError),
    ((None, "state", False), ValueError),
    (({"clip_norm": 1.0}, None, False), TypeError),
    ((object(), None, True), TypeError),
])
def test_check_guard_args_matches_jax(args, err):
    for mod in (jg, pg):
        with pytest.raises(err) as e:
            mod.check_guard_args(*args)
        msg = str(e.value)
        assert ("guard config" in msg if err is ValueError
                else "GuardrailConfig" in msg)
    pg.check_guard_args(pg.GuardrailConfig(), None, True)
    pg.check_guard_args(None, None, False)


def test_scaling_preconditions_match_jax():
    for mod in (jg, pg):
        with pytest.raises(ValueError, match="mixed"):
            mod.require_mixed_for_scaling(
                mod.GuardrailConfig(loss_scale=128.0), False)
        mod.require_mixed_for_scaling(mod.GuardrailConfig(loss_scale=128.0),
                                      True)
        mod.require_mixed_for_scaling(mod.GuardrailConfig(), False)
        mod.require_mixed_for_scaling(None, False)
    with pytest.raises(ValueError, match="loss-scale hook"):
        pg.require_scale_hook(pg.GuardrailConfig(loss_scale=2.0), False)
    pg.require_scale_hook(pg.GuardrailConfig(loss_scale=2.0), True)
    pg.require_scale_hook(pg.GuardrailConfig(), False)


def test_mesh_world_and_host_state():
    assert pg.mesh_world(None) == jg.mesh_world(None) == ((), 1)
    assert pg.mesh_world(Mesh({DATA_AXIS: 2, MODEL_AXIS: 2}, "cpu")) == (
        (DATA_AXIS, MODEL_AXIS), 4)
    cfg = pg.GuardrailConfig(loss_scale=64.0)
    fresh = pg.host_state(None, cfg)
    assert pg.summarize(fresh) == jg.summarize(jg.host_state(
        None, jg.GuardrailConfig(loss_scale=64.0)))
    # a plain tuple (e.g. round-tripped through numpy) is taken back
    back = pg.host_state(tuple(np.asarray(t) for t in fresh), cfg)
    assert pg.summarize(back) == pg.summarize(fresh)
    assert [t.dtype for t in back] == [t.dtype for t in fresh]
    assert pg.init_state(pg.GuardrailConfig()).loss_scale.item() == 1.0


def test_delta_norm_matches_jax():
    rng = np.random.default_rng(4)
    old = [rng.standard_normal((3, 5)).astype(np.float32),
           np.arange(4, dtype=np.int32)]
    new = [old[0] + 0.1 * rng.standard_normal((3, 5)).astype(np.float32),
           old[1] + 1]
    want = jg.delta_norm([jnp.asarray(a) for a in old],
                         [jnp.asarray(a) for a in new])
    got = pg.delta_norm([torch.from_numpy(a) for a in old],
                        [torch.from_numpy(a) for a in new])
    assert got == pytest.approx(want, rel=1e-12)
    bad = [torch.from_numpy(new[0]).clone(), torch.from_numpy(new[1])]
    bad[0][0, 0] = float("inf")
    assert pg.delta_norm([torch.from_numpy(a) for a in old], bad) == float(
        "inf")


def test_guarded_step_selects_without_a_host_read():
    """``guarded_step`` on a toy step: a finite candidate is kept, a bad
    one leaves the carry as it was (the same values), and the counters
    advance; the old carry is never written."""
    cfg = pg.GuardrailConfig()

    def step(carry, seed):
        carry[0].add_(float(seed))        # in place, as SGD does
        return carry

    gstep = pg.guarded_step(step, cfg)
    carry = ([torch.zeros(3)], pg.init_state(cfg))
    carry = gstep(carry, 1.0)
    kept = carry[0][0].clone()
    carry = gstep(carry, float("nan"))
    assert torch.equal(carry[0][0], kept) and torch.equal(kept,
                                                          torch.ones(3))
    assert pg.summarize(carry[1])["skipped"] == 1
