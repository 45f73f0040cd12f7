"""The mixture-of-experts FFN stack, as in the JAX package's
``models/moe.py``: raw stacked tensors in a NamedTuple. Each layer has
``n_experts`` independent expert FFNs (the dense stack's ``[ffn, d]`` /
``[d, ffn]`` transposed, bias-free weights) and a router."""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import torch

from ..ops.linear import init_linear
from .ffn_stack import tensor_from_numpy


class MoEStackParams(NamedTuple):
    """``wg [L, E, d]`` router, ``w1 [L, E, ffn, d]``, ``w2 [L, E, d, ffn]``;
    ``w1[l, e]`` and ``w2[l, e]`` are expert ``e``'s FFN weights."""
    wg: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor

    @property
    def n_layers(self) -> int:
        return self.w1.shape[0]

    @property
    def n_experts(self) -> int:
        return self.w1.shape[1]

    @property
    def d_model(self) -> int:
        return self.w1.shape[3]

    @property
    def ffn_dim(self) -> int:
        return self.w1.shape[2]

    def num_params(self) -> int:
        return self.wg.numel() + self.w1.numel() + self.w2.numel()


def init_moe_stack(generator: torch.Generator, d_model: int, n_layers: int,
                   n_experts: int, ffn_dim: int | None = None,
                   scale: float = 2e-2, dtype=torch.float32,
                   device=None) -> MoEStackParams:
    """``scale * normal`` weights from ``generator``: the router, then
    every expert's ``w1``, then every expert's ``w2`` (layer-major), as
    the JAX ``init_moe_stack`` orders them; its draws differ (another
    generator). ``ffn_dim`` defaults to ``4 * d_model``; the tensors are
    made on ``device`` (default: the generator's)."""
    ffn_dim = 4 * d_model if ffn_dim is None else ffn_dim
    device = generator.device if device is None else device
    wg = scale * torch.randn(n_layers, n_experts, d_model,
                             generator=generator, device=device)

    def grid(m, n):
        return torch.stack([init_linear(generator, m, n, scale,
                                        device=device)
                            for _ in range(n_layers * n_experts)]
                           ).reshape(n_layers, n_experts, n, m)

    w1 = grid(d_model, ffn_dim)
    return MoEStackParams(wg.to(dtype), w1.to(dtype),
                          grid(ffn_dim, d_model).to(dtype))


def clone_moe(params: MoEStackParams) -> MoEStackParams:
    """Fresh copies a trainer may update in place."""
    return MoEStackParams(*(t.clone() for t in params))


def moe_params_from_numpy(tree, device="cpu") -> MoEStackParams:
    """The port's parameters from the JAX ``MoEStackParams`` as numpy
    arrays, each in its own type (f32, or bf16 bit for bit): ``tree`` is
    an object or mapping with ``wg``, ``w1``, ``w2``."""
    def t(name):
        a = tree[name] if isinstance(tree, Mapping) else getattr(tree, name)
        return tensor_from_numpy(a, device)

    return MoEStackParams(t("wg"), t("w1"), t("w2"))
