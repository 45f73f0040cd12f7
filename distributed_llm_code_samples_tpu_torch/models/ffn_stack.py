"""The FFN-stack model, as in the JAX package's ``models/ffn_stack.py``:
per-layer ``[W1, W2]`` pairs (``train_ffns.py:38-39, :361``) stacked on
a leading layer axis, weights ``[out, in]``, no biases."""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch


class FFNStackParams(NamedTuple):
    """``w1 [L, ffn, d]``, ``w2 [L, d, ffn]``."""
    w1: torch.Tensor
    w2: torch.Tensor

    @property
    def n_layers(self) -> int:
        return self.w1.shape[0]

    @property
    def d_model(self) -> int:
        return self.w1.shape[2]

    @property
    def ffn_dim(self) -> int:
        return self.w1.shape[1]

    def num_params(self) -> int:
        return self.w1.numel() + self.w2.numel()


def init_ffn_stack(generator: torch.Generator, d_model: int, n_layers: int,
                   ffn_dim: int | None = None, scale: float = 2e-2,
                   dtype=torch.float32, device=None) -> FFNStackParams:
    """``scale * normal`` weights from ``generator``, layer by layer (w1
    then w2); ``ffn_dim`` defaults to ``4 * d_model``. The same family as
    the JAX ``init_ffn_stack``; the draws differ (another generator).
    The tensors are made on ``device`` (default: the generator's)."""
    ffn_dim = 4 * d_model if ffn_dim is None else ffn_dim
    device = generator.device if device is None else device
    w1 = torch.empty(n_layers, ffn_dim, d_model, device=device)
    w2 = torch.empty(n_layers, d_model, ffn_dim, device=device)
    for l in range(n_layers):
        w1[l].normal_(generator=generator)
        w2[l].normal_(generator=generator)
    return FFNStackParams(w1.mul_(scale).to(dtype), w2.mul_(scale).to(dtype))


def clone_params(params: FFNStackParams) -> FFNStackParams:
    """Fresh copies a trainer may update in place without touching the
    caller's (the reference's ``clone_layers_params``,
    ``train_ffns.py:177-181``)."""
    return FFNStackParams(params.w1.clone(), params.w2.clone())


def params_size_gb(params) -> float:
    """fp32 GB of any params container with ``num_params()``
    (``train_ffns.py:363-366``)."""
    return 4 * params.num_params() / (1024 ** 3)


def ffn_params_from_numpy(tree, device="cpu") -> FFNStackParams:
    """The port's parameters from the JAX ``FFNStackParams`` as numpy
    arrays: ``tree`` is an object or mapping with ``w1`` and ``w2``."""
    def t(name):
        a = tree[name] if isinstance(tree, Mapping) else getattr(tree, name)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return FFNStackParams(t("w1"), t("w2"))
