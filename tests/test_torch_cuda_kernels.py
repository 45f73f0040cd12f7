"""The CUDA kernels of the LM trainer's path (flash attention forward and
backward; the fused head's statistics and backward) against their plain
versions, on the card. Every test here needs a CUDA device with nvcc and
skips without one. The file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Shapes: a multi-tile one and ragged ones (T and dh, or N, d and V, that
no tile divides; a rectangular Tq != Tk; a target in the last column),
causal and not, both operand modes. Limits: max |kernel - plain| <=
1e-4 * max |plain| in f32 (the sums run in other orders) and 2e-3 with
bf16 operands (an f32-level difference can flip one bf16 rounding); a
repeat on the same inputs is bit-identical.
"""

import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.ops import fused_xent as p_fx
from distributed_llm_code_samples_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_fwd_ref)

TOL = {False: 1e-4, True: 2e-3}
FLASH_SHAPES = ((3, 64, 64, 16), (2, 37, 37, 40), (2, 80, 130, 64))
HEAD_SHAPES = ((64, 32, 384), (37, 20, 201))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def normal(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(
        np.float32)).cuda()


def agree(got, again, want, mxu_bf16):
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        err = float((g - w).abs().max())
        assert err <= TOL[mxu_bf16] * float(w.abs().max()), err


def flash_case(shape):
    h, tq, tk, dh = shape
    rng = np.random.default_rng(tq)
    return (normal(rng, h, tq, dh), normal(rng, h, tk, dh),
            normal(rng, h, tk, dh), normal(rng, h, tq, dh, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_fwd_kernel_matches_plain(card, shape, causal, mxu_bf16):
    q, k, v, _ = flash_case(shape)
    kw = dict(causal=causal, mxu_bf16=mxu_bf16)
    before = _build.launch_counts().get("flash_attn_fwd", 0)
    got = flash_attention_fwd(q, k, v, **kw)
    again = flash_attention_fwd(q, k, v, **kw)
    assert _build.launch_counts()["flash_attn_fwd"] == before + 2
    agree(got, again, flash_attention_fwd_ref(q, k, v, **kw), mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain(card, shape, causal, mxu_bf16):
    q, k, v, dy = flash_case(shape)
    kw = dict(causal=causal, mxu_bf16=mxu_bf16)
    y, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    got = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
    again = flash_attention_bwd(dy, q, k, v, y, lse, **kw)
    agree(got, again, flash_attention_bwd_ref(dy, q, k, v, y, lse, **kw),
          mxu_bf16)


def head_case(shape):
    n, d, v = shape
    rng = np.random.default_rng(n)
    t = torch.from_numpy(rng.integers(0, v, size=n)).cuda()
    t[-1] = v - 1
    return normal(rng, n, d), normal(rng, v, d, scale=0.02), t


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_stats_kernel_matches_plain(card, shape, mxu_bf16):
    h, w, t = head_case(shape)
    got = p_fx.head_xent_stats(h, w, t, mxu_bf16=mxu_bf16)
    again = p_fx.head_xent_stats(h, w, t, mxu_bf16=mxu_bf16)
    agree(got, again, p_fx.head_xent_stats_ref(h, w, t, mxu_bf16=mxu_bf16),
          mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_bwd_kernels_match_plain(card, shape, mxu_bf16):
    h, w, t = head_case(shape)
    lse, _ = p_fx.head_xent_stats_ref(h, w, t)
    dy = torch.tensor(2.0, device="cuda")
    kw = dict(mxu_bf16=mxu_bf16)
    got = p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)
    again = p_fx.head_xent_bwd(dy, h, w, t, lse, **kw)
    agree(got, again, p_fx.head_xent_bwd_ref(dy, h, w, t, lse, **kw),
          mxu_bf16)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, k, v, _ = flash_case((2, 16, 16, 80))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="float32"):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    h, w, t = head_case((16, 8, 40))
    with pytest.raises(ValueError, match="on"):
        p_fx.head_xent_stats(h, w.cpu(), t)
