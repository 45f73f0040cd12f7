"""The port's sampling (``decode/sampling.py``) against the JAX package's.

Greedy is argmax with the first maximum on ties, as ``jnp.argmax``. The
two packages draw different noise, so the sampled picks are compared
with JAX's own Gumbel draws handed to the port through ``noise_fn``; the
logits are made from a seed with numpy. The port's own noise is keyed on
``(seed, uid, position)`` alone: a row's pick does not depend on the
batch around it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.decode.sampling import (
    make_pick as j_make_pick)
from distributed_llm_code_samples_tpu_torch.decode.sampling import (
    check_sampling, gumbel_noise, make_pick, row_key)

V = 64


def jax_noise(seed):
    """``noise_fn`` giving the JAX engine's Gumbel draws: key
    ``fold_in(fold_in(fold_in(PRNGKey(0x5A3D), seed), uid), position)``."""
    base = jax.random.fold_in(jax.random.PRNGKey(0x5A3D), seed)

    @jax.jit
    def draw(uids, positions):
        return jax.vmap(lambda u, p: jax.random.gumbel(
            jax.random.fold_in(jax.random.fold_in(base, u), p), (V,),
            jnp.float32))(uids, positions)

    def fn(uids, positions, vocab):
        assert vocab == V
        return np.array(draw(jnp.asarray(uids, jnp.int32),
                             jnp.asarray(positions, jnp.int32)))

    return fn


def _logits(seed, s=6):
    return np.random.default_rng(seed).normal(size=(s, V)).astype(
        np.float32) * 3


def test_greedy_matches_jnp_argmax_with_ties():
    z = _logits(0)
    z[1, [5, 9, 40]] = z[1].max() + 1.0          # a three-way tie
    z[2, :] = 0.0                                 # all tied
    got = make_pick(0.0, 0, 0.0, V, 0)(torch.from_numpy(z), [0] * 6,
                                       [0] * 6)
    want = np.asarray(jnp.argmax(jnp.asarray(z), axis=-1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist()[1] == 5 and got.tolist()[2] == 0


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.8),
                          (0.9, 12, 0.6)])
def test_sampled_picks_match_jax_under_shared_noise(temperature, top_k,
                                                    top_p):
    seed = 7
    uids = [0, 3, 3, 11, 2, 5]
    positions = [4, 9, 10, 1, 30, 7]
    for draw in range(4):
        z = _logits(100 + draw)
        want = j_make_pick(temperature, top_k, top_p, V, seed)(
            jnp.asarray(z), jnp.asarray(uids, jnp.int32),
            jnp.asarray(positions, jnp.int32))
        got = make_pick(temperature, top_k, top_p, V, seed,
                        noise_fn=jax_noise(seed))(torch.from_numpy(z), uids,
                                                  positions)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pick_is_a_function_of_seed_uid_position_only():
    """The same (seed, uid, position) row gives the same pick alone and
    inside any batch; another uid or position gives other noise."""
    pick = make_pick(1.0, 0, 0.9, V, seed=3)
    z = torch.from_numpy(_logits(5))
    uids, pos = [4, 1, 9, 2, 8, 6], [12, 5, 7, 3, 3, 40]
    batch = pick(z, uids, pos).tolist()
    for i in range(6):
        assert pick(z[i:i + 1], uids[i:i + 1], pos[i:i + 1]).tolist() == [
            batch[i]]
    rev = pick(z.flip(0), uids[::-1], pos[::-1]).tolist()
    assert rev[::-1] == batch
    a = gumbel_noise(3, [4], [12], V, "cpu")
    assert torch.equal(a, gumbel_noise(3, [4], [12], V, "cpu"))
    assert not torch.equal(a, gumbel_noise(3, [5], [12], V, "cpu"))
    assert not torch.equal(a, gumbel_noise(3, [4], [13], V, "cpu"))
    assert not torch.equal(a, gumbel_noise(4, [4], [12], V, "cpu"))
    assert 0 <= row_key(2**40, 7, 1023) < 2**63


def test_check_sampling_matches_jax_rules():
    for bad in ((-1.0, 0, 0.0), (0.0, 3, 0.0), (1.0, V + 1, 0.0),
                (1.0, 0, 1.5)):
        with pytest.raises(ValueError):
            check_sampling(*bad, V)
    check_sampling(0.0, 0, 0.0, V)
    check_sampling(0.5, V, 1.0, V)
