"""The port's serving-path ops against the JAX package: LayerNorm, rope,
the causal mask, chunk attention, decode attention and the paged gather.

Inputs are made from a seed with numpy and fed to both; the port runs on
the CPU. Tolerance: atol 1e-6 at f32 (the two frameworks sum in other
orders; the values here are O(1)).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.models.lm import decode_attn as j_decode
from distributed_llm_code_samples_tpu.ops.norm import layernorm as j_ln
from distributed_llm_code_samples_tpu_torch.models.lm import (
    decode_attn as t_decode)
from distributed_llm_code_samples_tpu_torch.ops.norm import (
    layernorm as t_ln)

# the modules (the JAX package's models/__init__ exports a function named
# ``attention`` that shadows its submodule)
jattn = importlib.import_module(
    "distributed_llm_code_samples_tpu.models.attention")
tattn = importlib.import_module(
    "distributed_llm_code_samples_tpu_torch.models.attention")
ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("shape", [(5, 32), (2, 3, 16)])
def test_layernorm_matches_jax(shape):
    rng = _rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 1
    g = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(t_ln(torch.from_numpy(g), torch.from_numpy(x)),
           j_ln(jnp.asarray(g), jnp.asarray(x)))


def test_rope_matches_jax():
    rng = _rng(1)
    x = rng.normal(size=(4, 7, 8)).astype(np.float32)
    pos = np.arange(3, 10)
    _close(tattn.rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jattn.rope(jnp.asarray(x), jnp.asarray(pos)))
    # the engine's per-row form: one position per row
    xr = rng.normal(size=(5, 4, 1, 8)).astype(np.float32)
    pr = np.array([0, 3, 17, 100, 1023])
    want = jax.vmap(lambda a, p: jattn.rope(a, p[None]))(jnp.asarray(xr),
                                                          jnp.asarray(pr))
    got = tattn.rope(torch.from_numpy(xr), torch.from_numpy(pr)[:, None, None])
    _close(got, want, atol=2e-6)     # angles up to 1e3 rad: cos/sin ulps


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(
        tattn.causal_mask(5, 9, q_offset=3).numpy(),
        np.asarray(jattn.causal_mask(5, 9, q_offset=3)))


@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_chunk_attn_matches_jax(h, hkv):
    rng = _rng(2)
    q = rng.normal(size=(h, 5, 8)).astype(np.float32)
    ck = rng.normal(size=(hkv, 24, 8)).astype(np.float32)
    cv = rng.normal(size=(hkv, 24, 8)).astype(np.float32)
    _close(tattn.chunk_attn(torch.from_numpy(q), torch.from_numpy(ck),
                            torch.from_numpy(cv), 3),
           jattn.chunk_attn(jnp.asarray(q), jnp.asarray(ck),
                            jnp.asarray(cv), 3))


@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4), (4, 1)])
def test_decode_attn_matches_jax(h, hkv):
    rng = _rng(3)
    q = rng.normal(size=(3, h, 8)).astype(np.float32)
    ck = rng.normal(size=(3, hkv, 16, 8)).astype(np.float32)
    cv = rng.normal(size=(3, hkv, 16, 8)).astype(np.float32)
    lengths = np.array([1, 7, 16], np.int32)
    _close(t_decode(torch.from_numpy(q), torch.from_numpy(ck),
                    torch.from_numpy(cv), torch.from_numpy(lengths)),
           j_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                    jnp.asarray(lengths)))
    # the lockstep form: one scalar length
    _close(t_decode(torch.from_numpy(q), torch.from_numpy(ck),
                    torch.from_numpy(cv), 9),
           j_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 9))


def test_gather_paged_kv_matches_jax():
    rng = _rng(4)
    pk = rng.normal(size=(7, 2, 4, 8)).astype(np.float32)
    pv = rng.normal(size=(7, 2, 4, 8)).astype(np.float32)
    table = np.array([3, 1, 6, 0], np.int32)
    got = tattn.gather_paged_kv(torch.from_numpy(pk), torch.from_numpy(pv),
                                torch.from_numpy(table))
    want = jattn.gather_paged_kv(jnp.asarray(pk), jnp.asarray(pv),
                                 jnp.asarray(table))
    for g, w in zip(got, want):             # a gather moves bytes only
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
