"""The FFN block in three hand-written kernels: forward, input gradient
and weight gradients, the training path's ``use_pallas=True`` blocks.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_ffn.py``
(``ffn_fwd_pallas``, ``ffn_bwd_dx_pallas``, ``ffn_bwd_dw_pallas``,
``ffn_bwd_pallas``, ``pallas_ffn_block``). On a CUDA tensor each wrapper
launches its CUDA kernel (``csrc/ffn_fwd.cu``, ``csrc/ffn_bwd_dx.cu``,
``csrc/ffn_bwd_dw.cu``; built at first use by ``ops/_build.py``, bound
with ctypes) or raises; on a CPU tensor it runs its plain PyTorch version
``*_ref``. There is no fallback from a kernel to its plain version.

``mxu_bf16`` is the Pallas kernels' operand mode: x, w1, w2 and dy are
rounded to bf16, and so is the hidden activation before the second
product; products and sums stay f32. The port defaults it off (all f32,
the differential mode); the JAX compiled path defaults it on. The
kernels sum in another order than the plain versions, so the two agree
to rounding, not bit for bit; each kernel is bit-for-bit deterministic
from run to run.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import relu_fwd

FWD, BWD_DX, BWD_DW = "ffn_fwd", "ffn_bwd_dx", "ffn_bwd_dw"


def _op(t: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if mxu_bf16 else t


def _mask(h, da):
    return torch.where(h <= 0, torch.zeros((), dtype=da.dtype,
                                           device=da.device), da)


# -- plain versions --------------------------------------------------------

def ffn_fwd_ref(w1, w2, x, *, mxu_bf16: bool = False):
    """``relu(x w1^T) w2^T``; ``w1 [ffn, d]``, ``w2 [d, ffn]``,
    ``x [T, d]`` -> ``[T, d]``."""
    h = _op(x, mxu_bf16) @ _op(w1, mxu_bf16).T
    return _op(relu_fwd(h), mxu_bf16) @ _op(w2, mxu_bf16).T


def ffn_bwd_dx_ref(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """``dx = where(h <= 0, 0, dy w2) w1`` with ``h = x w1^T``."""
    w1m = _op(w1, mxu_bf16)
    h = _op(x, mxu_bf16) @ w1m.T
    da = _op(dy, mxu_bf16) @ _op(w2, mxu_bf16)
    return _op(_mask(h, da), mxu_bf16) @ w1m


def ffn_bwd_dw_ref(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """``(dw1, dw2) = (dh^T x, dy^T relu(h))`` with ``h = x w1^T`` and
    ``dh = where(h <= 0, 0, dy w2)``."""
    xm, dym = _op(x, mxu_bf16), _op(dy, mxu_bf16)
    h = xm @ _op(w1, mxu_bf16).T
    a = _op(relu_fwd(h), mxu_bf16)
    dh = _op(_mask(h, dym @ _op(w2, mxu_bf16)), mxu_bf16)
    return dh.T @ xm, dym.T @ a


# -- the kernels -----------------------------------------------------------

def _check(x, w1, w2, dy=None):
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("x must be [T, d], w1 [ffn, d] and w2 [d, ffn]")
    t, d = x.shape
    ffn = w1.shape[0]
    if tuple(w1.shape) != (ffn, d) or tuple(w2.shape) != (d, ffn):
        raise ValueError(f"w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do "
                         f"not fit x {tuple(x.shape)}: need w1 [ffn, {d}], "
                         f"w2 [{d}, ffn]")
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match x "
                         f"{tuple(x.shape)}")
    if min(t, d, ffn) < 1:
        raise ValueError("T, d and ffn must be at least 1")
    return t, d, ffn


def _launch(name, ptrs, t, d, ffn, mxu_bf16, device):
    _build.launch(name, f"{name}_launch", ptrs,
                  (t, d, ffn, int(bool(mxu_bf16))), device, name)


def ffn_fwd_fused(w1, w2, x, *, mxu_bf16: bool = False):
    """Fused linear -> ReLU -> linear forward, ``[T, d]``; the hidden
    tiles never leave the chip. CPU tensors run ``ffn_fwd_ref``."""
    t, d, ffn = _check(x, w1, w2)
    if not _build.on_card(FWD, x, w1, w2):
        return ffn_fwd_ref(w1, w2, x, mxu_bf16=mxu_bf16)
    y = torch.empty_like(x)
    _launch(FWD, [x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr()],
            t, d, ffn, mxu_bf16, x.device)
    return y


def ffn_bwd_dx_fused(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """Input gradient ``dx [T, d]`` with the pre-activation recomputed.
    CPU tensors run ``ffn_bwd_dx_ref``."""
    t, d, ffn = _check(x, w1, w2, dy)
    if not _build.on_card(BWD_DX, x, dy, w1, w2):
        return ffn_bwd_dx_ref(dy, w1, w2, x, mxu_bf16=mxu_bf16)
    dx = torch.empty_like(x)
    _launch(BWD_DX, [x.data_ptr(), dy.data_ptr(), w1.data_ptr(),
                     w2.data_ptr(), dx.data_ptr()],
            t, d, ffn, mxu_bf16, x.device)
    return dx


def ffn_bwd_dw_fused(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """Both weight gradients ``(dw1 [ffn, d], dw2 [d, ffn])``, reduced
    over tokens. The kernel takes two ``[T, ffn]`` f32 scratch arrays
    (``csrc/ffn_bwd_dw.cu`` says why). CPU tensors run
    ``ffn_bwd_dw_ref``."""
    t, d, ffn = _check(x, w1, w2, dy)
    if not _build.on_card(BWD_DW, x, dy, w1, w2):
        return ffn_bwd_dw_ref(dy, w1, w2, x, mxu_bf16=mxu_bf16)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    scratch = torch.empty(2, t, ffn, dtype=torch.float32, device=x.device)
    _launch(BWD_DW, [x.data_ptr(), dy.data_ptr(), w1.data_ptr(),
                     w2.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
                     scratch[0].data_ptr(), scratch[1].data_ptr()],
            t, d, ffn, mxu_bf16, x.device)
    return dw1, dw2


def ffn_bwd_fused(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """The block VJP from the two backward kernels, ``ops.ffn.ffn_bwd``'s
    signature: ``(dx, (dw1, dw2))``."""
    dx = ffn_bwd_dx_fused(dy, w1, w2, x, mxu_bf16=mxu_bf16)
    return dx, ffn_bwd_dw_fused(dy, w1, w2, x, mxu_bf16=mxu_bf16)


class _FusedBlock(torch.autograd.Function):
    """Forward and backward are the kernels; residuals are the params
    and the block input."""

    @staticmethod
    def forward(ctx, w1, w2, x, mxu_bf16):
        ctx.save_for_backward(w1, w2, x)
        ctx.mxu_bf16 = mxu_bf16
        return ffn_fwd_fused(w1, w2, x, mxu_bf16=mxu_bf16)

    @staticmethod
    def backward(ctx, dy):
        w1, w2, x = ctx.saved_tensors
        dx, (dw1, dw2) = ffn_bwd_fused(dy.contiguous(), w1, w2, x,
                                       mxu_bf16=ctx.mxu_bf16)
        return dw1, dw2, dx, None


def fused_ffn_block(w1, w2, x, mxu_bf16: bool = False):
    """FFN block computed by the kernels and differentiated by them."""
    return _FusedBlock.apply(w1, w2, x, mxu_bf16)
