"""The port's ``train_lm_single`` against the JAX package's, on the CPU.

vocab 384, d 32, 2 layers, 2 heads, 64-token sequences, 2 of them a step
(128 tokens), 3 seeds of ``make_seed_schedule(3, 7)``, lr 0.1. Both start
from the JAX ``init_lm`` parameters (``lm_params_from_numpy``) and the
port trains on the JAX batches (``batch_fn``), under every attention x
head policy. The JAX kernels run in interpret mode (its trainer picks
that off the TPU); the port's wrappers run their plain versions on the
CPU. Every leaf within rtol 2e-4, atol 1e-6, as the JAX package holds
its fused head against its oracle head (``test_pallas_xent.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import (
    lm_batch_from_seed as j_lm_batch)
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_lm as j_init_lm
from distributed_llm_code_samples_tpu.parallel import (
    train_lm_single as j_train_lm)
from distributed_llm_code_samples_tpu_torch.data import lm_batch_from_seed
from distributed_llm_code_samples_tpu_torch.models import (
    lm_leaves, lm_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.parallel import (
    resolve_attn, resolve_head, train_lm_single)

V, D, L, H, SEQ, LR = 384, 32, 2, 2, 64, 0.1
TOKENS = 2 * SEQ


def jax_batch(seed):
    toks, tgts = j_lm_batch(jnp.int32(seed), TOKENS // SEQ, SEQ, V)
    return (torch.from_numpy(np.array(toks)).long(),
            torch.from_numpy(np.array(tgts)).long())


@pytest.fixture(scope="module")
def setup():
    params = j_init_lm(jax.random.PRNGKey(0), V, D, L, SEQ, n_heads=H)
    return params, np.asarray(make_seed_schedule(3, random_seed=7))


def train_port(params, seeds, **kw):
    return train_lm_single(lm_params_from_numpy(params), seeds, TOKENS, D,
                           lr=LR, seq_len=SEQ, n_heads=H,
                           batch_fn=jax_batch, **kw)


POLICIES = [(a, h) for a in (None, "flash") for h in (None, "fused")]


@pytest.mark.parametrize("attn_impl,head_impl", POLICIES,
                         ids=[f"{a or 'oracle'}-{h or 'oracle'}"
                              for a, h in POLICIES])
def test_train_lm_single_matches_jax(setup, attn_impl, head_impl):
    params, seeds = setup
    want = j_train_lm(params, jnp.asarray(seeds), TOKENS, D, lr=LR,
                      seq_len=SEQ, n_heads=H, attn_impl=attn_impl,
                      head_impl=head_impl)
    start = lm_params_from_numpy(params)
    before = [t.clone() for t in lm_leaves(start)]
    launches = _build.launch_counts()
    got = train_lm_single(start, seeds, TOKENS, D, lr=LR, seq_len=SEQ,
                          n_heads=H, attn_impl=attn_impl,
                          head_impl=head_impl, batch_fn=jax_batch)
    assert _build.launch_counts() == launches       # CPU: no kernel
    for a, b in zip(lm_leaves(start), before):      # caller's copy kept
        assert torch.equal(a, b)
    for g, w in zip(lm_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-6)
    # the run moved every leaf by more than 10x the absolute tolerance
    for g, b in zip(lm_leaves(got), before):
        assert float((g - b).abs().max()) > 1e-5


def test_default_batches_are_seeded_and_shifted():
    toks, tgts = lm_batch_from_seed(5, 3, 16, V)
    again, _ = lm_batch_from_seed(5, 3, 16, V)
    assert toks.shape == tgts.shape == (3, 16)
    assert torch.equal(toks, again)
    assert torch.equal(toks[:, 1:], tgts[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < V


def test_default_batches_train_on_the_cpu(setup):
    params, seeds = setup
    start = lm_params_from_numpy(params)
    got = train_lm_single(start, seeds[:2], TOKENS, D, lr=LR, seq_len=SEQ,
                          n_heads=H, attn_impl="flash", head_impl="fused")
    for g, b in zip(lm_leaves(got), lm_leaves(start)):
        assert bool(torch.isfinite(g).all()) and g.shape == b.shape
    assert not torch.equal(got.wte, start.wte)


def test_shape_errors_match_jax(setup):
    params, seeds = setup
    for kw in ({"batch_size": TOKENS + 1}, {"n_heads": 3},
               {"seq_len": 2 * SEQ, "batch_size": 2 * SEQ}):
        args = dict(batch_size=TOKENS, seq_len=SEQ, n_heads=H) | kw
        with pytest.raises(ValueError):
            j_train_lm(params, seeds, args["batch_size"], D,
                       seq_len=args["seq_len"], n_heads=args["n_heads"])
        with pytest.raises(ValueError):
            train_lm_single(lm_params_from_numpy(params), seeds,
                            args["batch_size"], D, seq_len=args["seq_len"],
                            n_heads=args["n_heads"])
    with pytest.raises(ValueError, match="attn_impl"):
        resolve_attn("nope")
    with pytest.raises(ValueError, match="head_impl"):
        resolve_head("nope")


@pytest.mark.parametrize("kw", [{"optimizer": object()},
                                {"opt_state": object()},
                                {"return_state": True}, {"mixed": True},
                                {"attn_impl": "rope"}],
                         ids=["optimizer", "opt_state", "return_state",
                              "mixed", "rope"])
def test_unported_options_raise(setup, kw):
    params, seeds = setup
    with pytest.raises(NotImplementedError):
        train_port(params, seeds, **kw)


def test_on_step_sees_every_step(setup):
    params, seeds = setup
    seen = []
    train_port(params, seeds, on_step=seen.append)
    assert seen == [0, 1, 2]
