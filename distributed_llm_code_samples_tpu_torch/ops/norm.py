"""Gain-only LayerNorm (no bias), hand-differentiated, as in the JAX
package's ``ops/norm.py``: ``ln_fwd`` returns the residuals the hand
backward ``ln_bwd`` needs, and ``layernorm`` is a
``torch.autograd.Function`` whose backward is that VJP. Serving calls it
under ``no_grad`` and gets the forward alone."""

from __future__ import annotations

import torch

EPS = 1e-5


def ln_fwd(g: torch.Tensor, x: torch.Tensor, eps: float = EPS):
    """Row-wise LayerNorm over the last dim: ``g * (x - mu) *
    rsqrt(var + eps)``. ``g [d]``, ``x [..., d]``. Returns ``(y, (xhat,
    rstd))``."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    return g * xhat, (xhat, rstd)


def ln_bwd(dy, g, xhat, rstd):
    """Hand VJP: ``dg = sum_rows(dy * xhat)``; ``dx = rstd * (dxh -
    mean(dxh) - xhat * mean(dxh * xhat))`` with ``dxh = dy * g``."""
    dg = (dy * xhat).reshape(-1, g.shape[-1]).sum(dim=0)
    dxh = dy * g
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    return dg, rstd * (dxh - m1 - xhat * m2)


class _LayerNorm(torch.autograd.Function):
    """Residuals: the gain, ``xhat`` and ``rstd``."""

    @staticmethod
    def forward(ctx, g, x):
        y, (xhat, rstd) = ln_fwd(g, x)
        ctx.save_for_backward(g, xhat, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        return ln_bwd(dy, *ctx.saved_tensors)


def layernorm(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm whose differentiation rule is ``ln_bwd``."""
    return _LayerNorm.apply(g, x)
