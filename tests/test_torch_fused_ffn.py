"""The port's FFN kernels (``ops/fused_ffn.py``) against the JAX package.

On the CPU each wrapper runs its plain version; both are held against
the JAX Pallas kernels run with ``interpret=True`` at a grid of several
tiles on both axes (T 64, d 64, ffn 256, ``block_t=32, block_f=128``),
with ``mxu_bf16`` off and on, and at a ragged shape against the JAX
package's plain ``ops/ffn.py`` (the Pallas kernels take only divisible
shapes). Tolerance: |port - jax| <= 1e-5 * |jax| + 1e-6 * max|jax| in
both modes (the sums run in other orders; the bf16 rounding points are
the same).

``test_cuda_kernels_match_plain`` runs the CUDA kernels themselves; it
needs the card and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.ops import ffn as j_ffn
from distributed_llm_code_samples_tpu.ops import pallas_ffn as j_pl
from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as p_ff

GRID = dict(block_t=32, block_f=128)


def close(got, want):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def inputs(t_, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.2, (f, d)).astype(np.float32),
            rng.normal(0, 0.2, (d, f)).astype(np.float32),
            rng.normal(0, 1.0, (t_, d)).astype(np.float32),
            rng.normal(0, 0.1, (t_, d)).astype(np.float32))


def tt(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("mxu_bf16", [False, True])
def test_fwd_matches_jax_pallas_interpret(mxu_bf16):
    w1, w2, x, _ = inputs(64, 64, 256)
    want = j_pl.ffn_fwd_pallas(w1, w2, x, interpret=True, mxu_bf16=mxu_bf16,
                               **GRID)
    tw1, tw2, tx = tt(w1, w2, x)
    close(p_ff.ffn_fwd_ref(tw1, tw2, tx, mxu_bf16=mxu_bf16), want)
    close(p_ff.ffn_fwd_fused(tw1, tw2, tx, mxu_bf16=mxu_bf16), want)


@pytest.mark.parametrize("mxu_bf16", [False, True])
def test_bwd_dx_matches_jax_pallas_interpret(mxu_bf16):
    w1, w2, x, dy = inputs(64, 64, 256, seed=1)
    want = j_pl.ffn_bwd_dx_pallas(dy, w1, w2, x, interpret=True,
                                  mxu_bf16=mxu_bf16, **GRID)
    tw1, tw2, tx, tdy = tt(w1, w2, x, dy)
    close(p_ff.ffn_bwd_dx_ref(tdy, tw1, tw2, tx, mxu_bf16=mxu_bf16), want)
    close(p_ff.ffn_bwd_dx_fused(tdy, tw1, tw2, tx, mxu_bf16=mxu_bf16), want)


@pytest.mark.parametrize("mxu_bf16", [False, True])
def test_bwd_dw_matches_jax_pallas_interpret(mxu_bf16):
    w1, w2, x, dy = inputs(64, 64, 256, seed=2)
    want = j_pl.ffn_bwd_dw_pallas(dy, w1, w2, x, interpret=True,
                                  mxu_bf16=mxu_bf16, **GRID)
    tw1, tw2, tx, tdy = tt(w1, w2, x, dy)
    for fn in (p_ff.ffn_bwd_dw_ref, p_ff.ffn_bwd_dw_fused):
        dw1, dw2 = fn(tdy, tw1, tw2, tx, mxu_bf16=mxu_bf16)
        close(dw1, want[0])
        close(dw2, want[1])


def test_ragged_shape_matches_jax_plain_ffn():
    w1, w2, x, dy = inputs(37, 20, 52, seed=3)
    tw1, tw2, tx, tdy = tt(w1, w2, x, dy)
    close(p_ff.ffn_fwd_fused(tw1, tw2, tx), j_ffn.ffn_fwd(w1, w2, x))
    dx, (dw1, dw2) = p_ff.ffn_bwd_fused(tdy, tw1, tw2, tx)
    jdx, (jdw1, jdw2) = j_ffn.ffn_bwd(dy, w1, w2, x)
    close(dx, jdx)
    close(dw1, jdw1)
    close(dw2, jdw2)


def test_fused_block_gradients_match_jax_pallas_block():
    w1, w2, x, dy = inputs(64, 64, 256, seed=4)
    y_j, vjp = jax.vjp(lambda a, b, c: j_pl.pallas_ffn_block(a, b, c, True),
                       w1, w2, x)
    leaves = [a.requires_grad_() for a in tt(w1, w2, x)]
    y_p = p_ff.fused_ffn_block(*leaves)
    close(y_p.detach(), y_j)
    for got, want in zip(torch.autograd.grad(y_p, leaves,
                                             torch.from_numpy(dy)),
                         vjp(jnp.asarray(dy))):
        close(got, want)


def test_wrappers_count_no_launch_on_the_cpu():
    w1, w2, x, dy = tt(*inputs(16, 8, 32, seed=5))
    before = _build.launch_counts()
    p_ff.ffn_fwd_fused(w1, w2, x)
    p_ff.ffn_bwd_dx_fused(dy, w1, w2, x)
    p_ff.ffn_bwd_dw_fused(dy, w1, w2, x)
    y = p_ff.fused_ffn_block(w1.requires_grad_(), w2, x)
    y.backward(dy)
    assert _build.launch_counts() == before


def test_wrappers_reject_bad_operands():
    w1, w2, x, dy = tt(*inputs(16, 8, 32, seed=6))
    with pytest.raises(ValueError, match="do not fit"):
        p_ff.ffn_fwd_fused(w1, w1, x)
    with pytest.raises(ValueError, match="must match"):
        p_ff.ffn_bwd_dx_fused(dy[:3], w1, w2, x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        p_ff.ffn_bwd_dw_fused(*(a.to("meta") for a in (dy, w1, w2, x)))


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """The three CUDA kernels against their plain versions on the card,
    both operand modes, a ragged shape (needs nvcc and a Hopper card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in ((64, 64, 256), (37, 20, 52)):
        for mxu_bf16 in (False, True):
            w1, w2, x, dy = (a.cuda() for a in tt(*inputs(*shape)))
            pairs = [(p_ff.ffn_fwd_fused(w1, w2, x, mxu_bf16=mxu_bf16),
                      p_ff.ffn_fwd_ref(w1, w2, x, mxu_bf16=mxu_bf16)),
                     (p_ff.ffn_bwd_dx_fused(dy, w1, w2, x, mxu_bf16=mxu_bf16),
                      p_ff.ffn_bwd_dx_ref(dy, w1, w2, x, mxu_bf16=mxu_bf16))]
            pairs += zip(p_ff.ffn_bwd_dw_fused(dy, w1, w2, x,
                                               mxu_bf16=mxu_bf16),
                         p_ff.ffn_bwd_dw_ref(dy, w1, w2, x,
                                             mxu_bf16=mxu_bf16))
            torch.cuda.synchronize()
            for got, want in pairs:
                err = float((got - want).abs().max())
                assert err <= 2e-3 * float(want.abs().max())
