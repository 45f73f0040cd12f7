"""Softmax cross-entropy, hand-differentiated, as in the JAX package's
``ops/xent.py``: the LM family's objective, the oracle head, and the
plain reference the fused head (``ops/fused_xent.py``) is held against.

Mean over rows: ``loss = mean_i(lse_i - z_i[t_i])`` with ``lse_i =
logsumexp(z_i)``; the VJP is ``dz_i = (softmax(z_i) - onehot(t_i)) *
dy / N``, the one-hot subtracted as a scatter on the target column.
"""

from __future__ import annotations

import torch


def xent_fwd(logits: torch.Tensor, targets: torch.Tensor):
    """Row-mean cross-entropy. ``logits [N, V]`` float, ``targets [N]``
    int. Returns ``(loss, (probs, targets))``: the softmax is the one
    residual the hand backward needs."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    sumexp = e.sum(dim=-1, keepdim=True)
    lse = torch.log(sumexp) + m
    target_z = torch.gather(logits, -1, targets.long()[:, None])
    loss = (lse - target_z).mean()
    return loss, (e / sumexp, targets)


def xent_bwd(dy: torch.Tensor, probs: torch.Tensor, targets: torch.Tensor):
    """Hand VJP: ``dlogits = dy / N * (softmax - onehot(targets))``."""
    n = probs.shape[0]
    dz = probs * (dy / n)
    rows = torch.arange(n, device=probs.device)
    dz[rows, targets.long()] -= dy / n
    return dz


class _XentLoss(torch.autograd.Function):
    """Residuals: the softmax and the targets."""

    @staticmethod
    def forward(ctx, logits, targets):
        loss, (probs, targets) = xent_fwd(logits, targets)
        ctx.save_for_backward(probs, targets)
        return loss

    @staticmethod
    def backward(ctx, dy):
        return xent_bwd(dy, *ctx.saved_tensors), None


def xent_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross-entropy whose differentiation rule is ``xent_bwd``;
    ``targets`` takes no gradient."""
    return _XentLoss.apply(logits, targets)
