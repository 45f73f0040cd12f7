"""Bias-free linear layer with hand-written forward and backward, as in
the JAX package's ``ops/linear.py`` (reference ``train_ffns.py:35-45``):
weights stored transposed ``[out, in]``, no bias, and the backward is the
hand-derived VJP, not autograd."""

from __future__ import annotations

import torch


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                scale: float = 2e-2, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """``scale * normal([out_dim, in_dim])`` drawn from ``generator``
    (``train_ffns.py:35-36``), made on ``device`` (default: the
    generator's)."""
    device = generator.device if device is None else device
    w = torch.randn(out_dim, in_dim, generator=generator, device=device)
    return (scale * w).to(dtype)


def linear_fwd(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ w.T`` on ``[tokens, in_dim]`` inputs."""
    return x @ w.T


def linear_bwd(dy: torch.Tensor, w: torch.Tensor, x: torch.Tensor):
    """Hand linear VJP: ``(dw, dx)`` with ``dw = dy^T x``, ``dx = dy w``."""
    return dy.T @ x, dy @ w
