"""The port's fused LM head (``ops/fused_xent.py``) against the JAX
package's Pallas kernels run with ``interpret=True``.

On the CPU each wrapper runs its plain version. N 64, d 32, V 384 on
single- and multi-tile JAX grids; V 61 and 200 for the vocab edge (JAX
pads ``w`` there, the port never does); a target in the last column;
``dy = 3`` scaling. Tolerances as ``test_pallas_xent.py``: loss rtol
1e-6; lse and gradients rtol 1e-5, atol 1e-6. The kernels' cases run in
both operand modes, ``mxu_bf16`` passed explicitly to both sides: with
bf16 operands both round h, w and dz at the same points, and the
products of bf16 values are exact in f32, so the tolerances stay.

The CUDA kernels themselves are held against these plain versions in
``test_torch_cuda_kernels.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.ops import pallas_xent as j_px
from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.ops import fused_xent as p_fx


def case(n=64, d=32, v=384, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (0.02 * rng.normal(size=(v, d))).astype(np.float32)
    t = rng.integers(0, v, size=n).astype(np.int32)
    return h, w, t


def tt(h, w, t):
    return (torch.from_numpy(h.copy()), torch.from_numpy(w.copy()),
            torch.from_numpy(t.astype(np.int64)))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("block", [None, (16, 128), (64, 128), (16, 384)],
                         ids=["default", "16x128", "64x128", "16x384"])
def test_fwd_and_bwd_match_jax_pallas_interpret(block, mxu_bf16):
    h, w, t = case()
    kw = {} if block is None else dict(block_n=block[0], block_v=block[1])
    kw.update(interpret=True, mxu_bf16=mxu_bf16)
    loss_j, lse_j = j_px.head_xent_fwd(h, w, t, **kw)
    dh_j, dw_j = j_px.head_xent_bwd(jnp.float32(1.0), h, w, t, lse_j, **kw)
    th, tw, tt_ = tt(h, w, t)
    loss, lse = p_fx.head_xent_fwd(th, tw, tt_, mxu_bf16=mxu_bf16)
    close(loss, loss_j, rtol=1e-6, atol=0)
    close(lse, lse_j)
    for fn in (p_fx.head_xent_bwd_ref, p_fx.head_xent_bwd):
        dh, dw = fn(torch.tensor(1.0), th, tw, tt_, lse, mxu_bf16=mxu_bf16)
        close(dh, dh_j)
        close(dw, dw_j)


@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("v", [61, 200])
def test_vocab_edge_matches_jax(v, mxu_bf16):
    """A vocabulary no tile divides, with a target in the last column:
    JAX zero-pads w to its tile and masks; the port masks alone."""
    h, w, t = case(v=v, seed=9)
    t[5] = v - 1
    kw = dict(block_v=128, interpret=True, mxu_bf16=mxu_bf16)
    loss_j, lse_j = j_px.head_xent_fwd(h, w, t, **kw)
    dh_j, dw_j = j_px.head_xent_bwd(jnp.float32(1.0), h, w, t, lse_j, **kw)
    th, tw, tt_ = tt(h, w, t)
    lse, tz = p_fx.head_xent_stats(th, tw, tt_, mxu_bf16=mxu_bf16)
    lse_j2, tz_j = j_px.head_xent_stats(h, w, t, **kw)
    close(lse, lse_j2)
    close(tz, tz_j)
    close((lse - tz).mean(), loss_j, rtol=1e-6, atol=0)
    dh, dw = p_fx.head_xent_bwd(torch.tensor(1.0), th, tw, tt_, lse,
                                mxu_bf16=mxu_bf16)
    assert dw.shape == (v, w.shape[1])
    close(dh, dh_j)
    close(dw, dw_j)


def test_out_of_range_targets_match_no_column():
    h, w, t = case(v=200, seed=4)
    t[:4] = [-1, 200, 255, 1000]
    lse_j, tz_j = j_px.head_xent_stats(h, w, t, block_v=128, interpret=True)
    lse, tz = p_fx.head_xent_stats(*tt(h, w, t))
    close(lse, lse_j)
    close(tz, tz_j)
    assert float(tz[:4].abs().max()) == 0.0


def test_custom_vjp_grads_and_dy_scaling_match_jax():
    h, w, t = case(seed=5)
    for scale in (1.0, 3.0):
        loss_j, g_j = jax.value_and_grad(
            lambda a, b: scale * j_px.head_xent(a, b, t, True),
            argnums=(0, 1))(h, w)
        th, tw, tt_ = tt(h, w, t)
        th.requires_grad_()
        tw.requires_grad_()
        loss = scale * p_fx.head_xent(th, tw, tt_)
        close(loss, loss_j, rtol=1e-6, atol=0)
        for got, want in zip(torch.autograd.grad(loss, (th, tw)), g_j):
            close(got, want)


def test_wrappers_count_no_launch_on_the_cpu():
    th, tw, tt_ = tt(*case(n=16, d=8, v=40, seed=6))
    before = _build.launch_counts()
    lse, _ = p_fx.head_xent_stats(th, tw, tt_)
    p_fx.head_xent_bwd(torch.tensor(1.0), th, tw, tt_, lse)
    p_fx.head_xent(th.requires_grad_(), tw, tt_).backward()
    assert _build.launch_counts() == before


def test_wrappers_reject_bad_operands():
    th, tw, tt_ = tt(*case(n=16, d=8, v=40, seed=7))
    with pytest.raises(ValueError, match="expected"):
        p_fx.head_xent_stats(th, tw[:, :4], tt_)
    with pytest.raises(ValueError, match="targets"):
        p_fx.head_xent_stats(th, tw, tt_[:3])
    with pytest.raises(ValueError, match="lse"):
        p_fx.head_xent_bwd(torch.tensor(1.0), th, tw, tt_, tt_[:3].float())
    with pytest.raises(ValueError, match="cpu or cuda"):
        p_fx.head_xent_stats(th.to("meta"), tw.to("meta"), tt_.to("meta"))

