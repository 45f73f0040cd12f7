"""Serving guardrail: the per-row finite flag of the JAX package's
``runtime/guardrails.py`` (``rows_finite``)."""

from __future__ import annotations

import torch


def rows_finite(logits: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite flag over a logits block ``[..., V] -> [...]``.
    The decode engine fails a request whose row is not finite."""
    return torch.isfinite(logits).all(dim=-1)
