"""The transformer block stack's parameters, as in the JAX package's
``models/transformer.py`` (``TransformerParams``): stacked per-layer
weights, all ``[out, in]``, no biases. Here an ``nn.Module`` holding them
as buffers (the port serves; no gradient flows)."""

from __future__ import annotations

import torch
from torch import nn

FIELDS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")


class TransformerParams(nn.Module):
    """``ln1, ln2 [L, d]`` gains; ``wq, wo [L, d, d]``; ``wk, wv
    [L, kv_dim, d]`` (``kv_dim < d`` under grouped-query attention);
    ``w1 [L, ffn, d]``, ``w2 [L, d, ffn]``."""

    def __init__(self, ln1, wq, wk, wv, wo, ln2, w1, w2):
        super().__init__()
        for name, t in zip(FIELDS, (ln1, wq, wk, wv, wo, ln2, w1, w2)):
            self.register_buffer(name, t)

    @property
    def n_layers(self) -> int:
        return self.w1.shape[0]


def init_transformer(generator: torch.Generator, d_model: int,
                     n_layers: int, ffn_dim: int | None = None,
                     scale: float = 2e-2, dtype=torch.float32,
                     kv_dim: int | None = None,
                     device=None) -> TransformerParams:
    """``scale * normal`` weights drawn from ``generator``, LN gains at 1;
    ``ffn_dim`` defaults to ``4 * d_model``, ``kv_dim`` to ``d_model``.
    The same family as the JAX ``init_transformer``; the draws differ
    (another generator)."""
    ffn_dim = 4 * d_model if ffn_dim is None else ffn_dim
    kv_dim = d_model if kv_dim is None else kv_dim
    device = generator.device if device is None else device

    def normal(*shape):
        return scale * torch.randn(*shape, generator=generator,
                                   dtype=dtype, device=device)

    ones = torch.ones(n_layers, d_model, dtype=dtype, device=device)
    return TransformerParams(
        ln1=ones, wq=normal(n_layers, d_model, d_model),
        wk=normal(n_layers, kv_dim, d_model),
        wv=normal(n_layers, kv_dim, d_model),
        wo=normal(n_layers, d_model, d_model), ln2=ones.clone(),
        w1=normal(n_layers, ffn_dim, d_model),
        w2=normal(n_layers, d_model, ffn_dim))
