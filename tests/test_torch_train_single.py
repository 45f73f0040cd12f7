"""The port's ``train_single`` against the JAX package's, on the CPU.

d 64, 3 layers, 64 tokens a step, 8 seeds of ``make_seed_schedule(8,
7)``, lr 0.1 (large enough that the updates are far above rounding).
Both start from the JAX ``init_ffn_stack`` parameters
(``ffn_params_from_numpy``) and the port trains on the JAX batches
(``batch_fn``), so the two compute the same thing. Tolerance after 8
steps: rtol 1e-5, atol 1e-6 in f32 (the frameworks' CPU matmuls sum in
other orders). The mixed path is held to 2e-3 of the max parameter: an
f32-level difference in a pre-activation can flip one bf16 rounding of
the hidden activation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.data import batch_from_seed as j_batch
from distributed_llm_code_samples_tpu.data import make_seed_schedule
from distributed_llm_code_samples_tpu.models import init_ffn_stack
from distributed_llm_code_samples_tpu.parallel import train_single as j_train
from distributed_llm_code_samples_tpu_torch.data import POISON_NAN_BIT
from distributed_llm_code_samples_tpu_torch.models import (
    ffn_params_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.parallel import (
    make_step, train_single)

D, L, TOKENS, LR = 64, 3, 64, 0.1


def jax_batch(seed, batch_size, model_size, *, dtype, device):
    x, dl = j_batch(jnp.int32(seed), batch_size, model_size)
    return (torch.from_numpy(np.array(x)).to(device, dtype),
            torch.from_numpy(np.array(dl)).to(device, dtype))


@pytest.fixture(scope="module")
def setup():
    params = init_ffn_stack(jax.random.PRNGKey(0), D, L)
    seeds = np.asarray(make_seed_schedule(8, 7))
    return params, seeds


VARIANTS = [
    ("default", {}, {}),
    ("pallas", {"use_pallas": True}, {"use_pallas": True,
                                      "interpret": True}),
    ("manual_loop", {"manual_loop": True}, {"manual_loop": True}),
    ("manual_loop_pallas", {"manual_loop": True, "use_pallas": True},
     {"manual_loop": True, "use_pallas": True, "interpret": True}),
    ("saved", {"remat": False}, {"remat": False}),
    ("accum2", {"accum": 2}, {"accum": 2}),
]


@pytest.mark.parametrize("name,port_kw,jax_kw", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_train_single_matches_jax(setup, name, port_kw, jax_kw):
    params, seeds = setup
    want = j_train(params, jnp.asarray(seeds), TOKENS, D, lr=LR, **jax_kw)
    start = ffn_params_from_numpy(params)
    w1_before = start.w1.clone()
    launches = _build.launch_counts()
    got = train_single(start, seeds, TOKENS, D, lr=LR, batch_fn=jax_batch,
                       **port_kw)
    assert _build.launch_counts() == launches       # CPU: no kernel
    assert torch.equal(start.w1, w1_before)           # caller's copy kept
    for g, w in ((got.w1, want.w1), (got.w2, want.w2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # the run moved the weights by 100x the tolerance
    assert float((got.w1 - w1_before).abs().max()) > 1e-4


@pytest.mark.parametrize("remat", [None, False])
def test_mixed_train_single_matches_jax(setup, remat):
    params, seeds = setup
    want = j_train(params, jnp.asarray(seeds), TOKENS, D, lr=LR, mixed=True,
                   remat=remat)
    got = train_single(ffn_params_from_numpy(params), seeds, TOKENS, D,
                       lr=LR, mixed=True, remat=remat, batch_fn=jax_batch)
    for g, w in ((got.w1, want.w1), (got.w2, want.w2)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 2e-3 * np.abs(w).max()


def test_invalid_combinations_raise_like_jax():
    for kw in ({"mixed": True, "use_pallas": True},
               {"mixed": True, "manual_loop": True},
               {"use_pallas": True, "remat": False}):
        with pytest.raises(ValueError):
            make_step(TOKENS, D, **kw)


def test_guard_is_not_ported(setup):
    """The guard is ported (``test_torch_train_guard.py``); a guard that
    is not a ``GuardrailConfig`` raises JAX's ``TypeError`` from
    ``check_guard_args``."""
    params, seeds = setup
    with pytest.raises(TypeError, match="GuardrailConfig"):
        train_single(ffn_params_from_numpy(params), seeds, TOKENS, D,
                     guard=object())


def test_poisoned_seed_gives_a_nan_update(setup):
    params, seeds = setup
    start = ffn_params_from_numpy(params)
    clean = train_single(start, seeds[:2], TOKENS, D, lr=LR)
    assert bool(torch.isfinite(clean.w1).all())
    poisoned = seeds[:2].copy()
    poisoned[1] |= POISON_NAN_BIT
    out = train_single(start, poisoned, TOKENS, D, lr=LR)
    assert bool(torch.isnan(out.w2).all()) and bool(torch.isnan(out.w1).any())
    # on the JAX batches the NaNs land where JAX's do (a unit whose
    # pre-activation is <= 0 for every token gets a zero dw1 row)
    got = train_single(start, poisoned, TOKENS, D, lr=LR, batch_fn=jax_batch)
    want = j_train(params, jnp.asarray(poisoned), TOKENS, D, lr=LR)
    for g, w in ((got.w1, want.w1), (got.w2, want.w2)):
        np.testing.assert_array_equal(np.isnan(g.numpy()),
                                      np.isnan(np.asarray(w)))


def test_on_step_sees_every_step(setup):
    params, seeds = setup
    seen = []
    train_single(ffn_params_from_numpy(params), seeds[:3], TOKENS, D,
                 on_step=seen.append)
    assert seen == [0, 1, 2]
