"""Transformer FFN sublayer: linear -> ReLU -> linear, hand-differentiated,
as in the JAX package's ``ops/ffn.py`` (reference ``train_ffns.py:54-70``).

- Only block inputs are checkpointed: ``ffn_bwd`` recomputes the ffn1
  pre-activation instead of saving it (``train_ffns.py:63``).
- The backward is written out by hand. The ``ffn_block*`` functions are
  ``torch.autograd.Function``s whose ``backward`` is that hand VJP, so
  autograd over a stack of them composes the chain but never
  differentiates a block itself.

The mixed family (``*_mixed``) rounds the matmul operands to bf16 and
keeps products, sums, params and grads in f32: ``a.bfloat16().float() @
b.bfloat16().float()`` with TF32 off is JAX's ``dot_general`` with bf16
inputs and ``preferred_element_type=f32``.
"""

from __future__ import annotations

import torch

from .activations import relu_bwd, relu_fwd
from .linear import linear_bwd, linear_fwd


def ffn_fwd(w1: torch.Tensor, w2: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """``w1 [ffn, d]``, ``w2 [d, ffn]``, ``x [tokens, d]`` ->
    ``[tokens, d]``."""
    return linear_fwd(w2, relu_fwd(linear_fwd(w1, x)))


def ffn_bwd(dy, w1, w2, x):
    """Block VJP recomputing the pre-activation from the block input
    ``x``; returns ``(dx, (dw1, dw2))``."""
    h = linear_fwd(w1, x)
    dw2, da = linear_bwd(dy, w2, relu_fwd(h))
    dw1, dx = linear_bwd(relu_bwd(da, h), w1, x)
    return dx, (dw1, dw2)


def ffn_bwd_saved(dy, w1, w2, x, a):
    """Block VJP from the saved post-ReLU ``a`` (no recompute); the mask
    ``a > 0`` equals ``h > 0``. Returns ``(dx, (dw1, dw2))``."""
    dw2, da = linear_bwd(dy, w2, a)
    dw1, dx = linear_bwd(relu_bwd(da, a), w1, x)
    return dx, (dw1, dw2)


class _Block(torch.autograd.Function):
    """Residuals: params and the block input only."""

    @staticmethod
    def forward(ctx, w1, w2, x):
        ctx.save_for_backward(w1, w2, x)
        return ffn_fwd(w1, w2, x)

    @staticmethod
    def backward(ctx, dy):
        w1, w2, x = ctx.saved_tensors
        dx, (dw1, dw2) = ffn_bwd(dy, w1, w2, x)
        return dw1, dw2, dx


class _BlockSaved(torch.autograd.Function):
    """Residuals: params, the block input and the post-ReLU activation."""

    @staticmethod
    def forward(ctx, w1, w2, x):
        a = relu_fwd(linear_fwd(w1, x))
        ctx.save_for_backward(w1, w2, x, a)
        return linear_fwd(w2, a)

    @staticmethod
    def backward(ctx, dy):
        dx, (dw1, dw2) = ffn_bwd_saved(dy, *ctx.saved_tensors)
        return dw1, dw2, dx


def ffn_block(w1, w2, x):
    """FFN block differentiated by ``ffn_bwd`` (recompute)."""
    return _Block.apply(w1, w2, x)


def ffn_block_saved(w1, w2, x):
    """FFN block differentiated by ``ffn_bwd_saved``: same forward, same
    gradients, one matmul fewer in the backward."""
    return _BlockSaved.apply(w1, w2, x)


# -- mixed precision: bf16 operands, f32 products, sums, params, grads --

def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16-valued operands, f32 products and sums."""
    return a.float() @ b.float()


def _mixed_bwd_core(dy, w1b, w2b, xb, ab):
    """The mixed backward, shared by both mixed blocks; all inputs but
    ``dy`` are bf16. Returns f32 ``(dx, dw1, dw2)``."""
    dyb = _bf(dy)
    dw2 = _mm(dyb.T, ab)
    da = _mm(dyb, w2b)
    dhb = _bf(torch.where(ab > 0, da, torch.zeros((), device=da.device)))
    return _mm(dhb, w1b), _mm(dhb.T, xb), dw2


def _mixed_hidden(w1, x):
    xb, w1b = _bf(x), _bf(w1)
    return xb, w1b, _bf(torch.clamp_min(_mm(xb, w1b.T), 0.0))


def ffn_fwd_mixed(w1, w2, x) -> torch.Tensor:
    """linear -> ReLU -> linear with bf16 operands; f32 output."""
    _, _, ab = _mixed_hidden(w1, x)
    return _mm(ab, _bf(w2).T)


def ffn_bwd_mixed(dy, w1, w2, x):
    """Mixed block VJP recomputing the pre-activation from the block
    input; returns f32 ``(dx, (dw1, dw2))``."""
    xb, w1b, ab = _mixed_hidden(w1, x)
    dx, dw1, dw2 = _mixed_bwd_core(dy, w1b, _bf(w2), xb, ab)
    return dx, (dw1, dw2)


class _BlockMixed(torch.autograd.Function):
    """Residuals: the bf16 params, input and post-ReLU activation."""

    @staticmethod
    def forward(ctx, w1, w2, x):
        xb, w1b, ab = _mixed_hidden(w1, x)
        w2b = _bf(w2)
        ctx.save_for_backward(w1b, w2b, xb, ab)
        return _mm(ab, w2b.T)

    @staticmethod
    def backward(ctx, dy):
        dx, dw1, dw2 = _mixed_bwd_core(dy, *ctx.saved_tensors)
        return dw1, dw2, dx


class _BlockMixedRemat(torch.autograd.Function):
    """Residuals: the f32 params and the block input stashed in bf16."""

    @staticmethod
    def forward(ctx, w1, w2, x):
        ctx.save_for_backward(w1, w2, _bf(x))
        return ffn_fwd_mixed(w1, w2, x)

    @staticmethod
    def backward(ctx, dy):
        dx, (dw1, dw2) = ffn_bwd_mixed(dy, *ctx.saved_tensors)
        return dw1, dw2, dx


def ffn_block_mixed(w1, w2, x):
    """Mixed FFN block saving its bf16 post-ReLU activation."""
    return _BlockMixed.apply(w1, w2, x)


def ffn_block_mixed_remat(w1, w2, x):
    """Mixed FFN block recomputing the pre-activation from a bf16 stash
    of its input."""
    return _BlockMixedRemat.apply(w1, w2, x)
