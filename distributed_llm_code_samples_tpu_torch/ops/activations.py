"""Hand-written ReLU forward and backward (reference
``train_ffns.py:47-52``), as in the JAX package's ``ops/activations.py``.
Both mask ``x <= 0``, so an exact 0 is masked and a NaN passes."""

from __future__ import annotations

import torch


def relu_fwd(x: torch.Tensor) -> torch.Tensor:
    """``where(x <= 0, 0, x)``."""
    return torch.where(x <= 0, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)


def relu_bwd(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Upstream gradient masked where the pre-activation was ``<= 0``."""
    return torch.where(x <= 0, torch.zeros((), dtype=dy.dtype,
                                           device=dy.device), dy)
