"""Gain-only LayerNorm forward (no bias), as in the JAX package's
``ops/norm.py``. The port serves only, so the hand-written backward of
the JAX module waits for the training slice."""

from __future__ import annotations

import torch

EPS = 1e-5


def layernorm(g: torch.Tensor, x: torch.Tensor,
              eps: float = EPS) -> torch.Tensor:
    """Row-wise LayerNorm over the last dim: ``g * (x - mu) *
    rsqrt(var + eps)``. ``g [d]``, ``x [..., d]``."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return g * (xc * torch.rsqrt(var + eps))
