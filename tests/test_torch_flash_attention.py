"""The port's flash attention (``ops/flash_attention.py``) against the JAX
package's Pallas kernels run with ``interpret=True``.

On the CPU each wrapper runs its plain version. The JAX side runs on a
grid of several tiles (T 64, ``block_q = block_k = 16``), causal and not;
the port takes every head in one call, where JAX ``vmap``s its
single-head kernel. Tolerances as ``test_pallas_attention.py``: y and lse
rtol/atol 1e-5; gradients rtol 1e-4, atol 1e-5.

The forward and backward are held in both operand modes, ``mxu_bf16``
passed explicitly to both sides. With bf16 operands the Pallas forward
rounds each tile of p to bf16 against the running row max, the plain
version against the row's final max: the two roundings differ by up to
bf16's half-ulp per element, so y is held to the bf16-operand limit of
the card's ``lm-kernel-case`` lines, max |port - jax| <= 2e-3 max |jax|.
lse and the backward (whose p comes from the final lse on both sides)
round at the same points and keep the f32 tolerances.

The CUDA kernels themselves are held against these plain versions in
``test_torch_cuda_kernels.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.ops import pallas_attention as j_fa
from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.ops import flash_attention as p_fa

T, DH, H = 64, 16, 3
GRID = dict(block_q=16, block_k=16, interpret=True)


def inputs(h, t, dh, seed=0, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = h if hkv is None else hkv
    return (rng.normal(size=(h, t, dh)).astype(np.float32),
            rng.normal(size=(hkv, t, dh)).astype(np.float32),
            rng.normal(size=(hkv, t, dh)).astype(np.float32),
            (0.1 * rng.normal(size=(h, t, dh))).astype(np.float32))


def tt(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol)


def jax_fwd(q, k, v, causal, mxu_bf16=False):
    """The Pallas forward per head: ``(y [H, T, dh], lse [H, T])``."""
    return jax.vmap(lambda a, b, c: j_fa.flash_attention_fwd(
        a, b, c, causal=causal, mxu_bf16=mxu_bf16, **GRID))(q, k, v)


@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_matches_jax_pallas_interpret(causal, mxu_bf16):
    q, k, v, _ = inputs(H, T, DH)
    y_j, lse_j = jax_fwd(q, k, v, causal, mxu_bf16)
    y_tol = (0.0, 2e-3 * float(np.abs(y_j).max())) if mxu_bf16 \
        else (1e-5, 1e-5)
    tq, tk, tv = tt(q, k, v)
    for fn in (p_fa.flash_attention_fwd_ref, p_fa.flash_attention_fwd):
        y, lse = fn(tq, tk, tv, causal=causal, mxu_bf16=mxu_bf16)
        close(y, y_j, *y_tol)
        close(lse, lse_j, 1e-5, 1e-5)


@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_matches_jax_pallas_interpret(causal, mxu_bf16):
    q, k, v, dy = inputs(H, T, DH, seed=1)
    y_j, lse_j = jax_fwd(q, k, v, causal, mxu_bf16)
    want = jax.vmap(lambda *a: j_fa.flash_attention_bwd(
        *a, causal=causal, mxu_bf16=mxu_bf16, **GRID))(dy, q, k, v, y_j,
                                                       lse_j)
    tq, tk, tv, tdy = tt(q, k, v, dy)
    ty, tlse = (torch.from_numpy(np.array(a)) for a in (y_j, lse_j))
    for fn in (p_fa.flash_attention_bwd_ref, p_fa.flash_attention_bwd):
        for name, g, w in zip("qkv", fn(tdy, tq, tk, tv, ty, tlse,
                                        causal=causal, mxu_bf16=mxu_bf16),
                              want):
            close(g, w, 1e-4, 1e-5)


def test_batched_leading_dims_match_per_head():
    """[B, H, T, dh] in one call equals the JAX kernel head by head."""
    q, k, v, _ = inputs(2 * H, T, DH, seed=2)
    y_j, lse_j = jax_fwd(q, k, v, True)
    tq, tk, tv = (a.reshape(2, H, T, DH) for a in tt(q, k, v))
    y, lse = p_fa.flash_attention_fwd(tq, tk, tv)
    assert y.shape == (2, H, T, DH) and lse.shape == (2, H, T)
    close(y.reshape(2 * H, T, DH), y_j, 1e-5, 1e-5)
    close(lse.reshape(2 * H, T), lse_j, 1e-5, 1e-5)


@pytest.mark.parametrize("hkv", [H, 1], ids=["mha", "gqa"])
def test_flash_mha_grads_match_jax(hkv):
    """``flash_mha`` forward and VJP, full MHA and grouped-query (the
    repeat-KV fan-out sums each KV head's gradient over its group)."""
    hq = 4 if hkv == 1 else H
    hkv = 2 if hkv == 1 else hkv
    q, k, v, dy = inputs(hq, T, DH, seed=3, hkv=hkv)
    y_j, vjp = jax.vjp(lambda a, b, c: j_fa.flash_mha(a, b, c, True, True),
                       q, k, v)
    leaves = [a.requires_grad_() for a in tt(q, k, v)]
    y = p_fa.flash_mha(*leaves)
    close(y, y_j, 1e-5, 1e-5)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for g, w in zip(got, vjp(jnp.asarray(dy))):
        close(g, w, 1e-4, 1e-5)
    assert p_fa.flash_mha.supports_gqa


def test_flash_mha_refuses_ungrouped_heads():
    q, k, v, _ = tt(*inputs(3, 8, 4, hkv=2))
    with pytest.raises(ValueError, match="not divisible"):
        p_fa.flash_mha(q, k, v)


def test_wrappers_count_no_launch_on_the_cpu():
    q, k, v, dy = tt(*inputs(2, 16, 8, seed=4))
    before = _build.launch_counts()
    y, lse = p_fa.flash_attention_fwd(q, k, v)
    p_fa.flash_attention_bwd(dy, q, k, v, y, lse)
    p_fa.flash_attention(q.requires_grad_(), k, v).backward(dy)
    assert _build.launch_counts() == before


def test_wrappers_reject_bad_operands():
    q, k, v, dy = tt(*inputs(2, 16, 8, seed=5))
    with pytest.raises(ValueError, match="expected"):
        p_fa.flash_attention_fwd(q, k[:, :, :4], v)
    with pytest.raises(ValueError, match="differ"):
        p_fa.flash_attention_fwd(q, k[:1], v[:1])
    y, lse = p_fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="must"):
        p_fa.flash_attention_bwd(dy[:, :3], q, k, v, y, lse)
    with pytest.raises(ValueError, match="cpu or cuda"):
        p_fa.flash_attention_fwd(*(a.to("meta") for a in (q, k, v)))

