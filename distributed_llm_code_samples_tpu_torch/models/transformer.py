"""The pre-LN transformer block stack, as in the JAX package's
``models/transformer.py``: stacked per-layer weights, all ``[out, in]``,
no biases (``TransformerParams``, an ``nn.Module`` holding them as
buffers), and the forward, whose nonlinear ops carry hand VJPs
(LayerNorm: ``ops/norm.py``; attention: ``models/attention.py`` or the
flash kernels; FFN: ``ops/ffn.py``) while autograd transposes the linear
projections. A trainer takes the weights as leaves that require grad
(``parallel/lm.py``); serving runs the same buffers under ``no_grad``.

Block: ``x += W_o attn(split_heads(W_q a, W_k a, W_v a))`` with ``a =
LN1(x)``, then ``x += FFN(LN2(x))``; activations ``[B, T, d]``.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from ..ops.ffn import ffn_block
from ..ops.norm import layernorm
from .attention import gqa, mha
from .ffn_stack import tensor_from_numpy

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

    def num_params(self) -> int:
        return sum(t.numel() for _, t in self.named_leaves())

    def named_leaves(self) -> list[tuple[str, torch.Tensor]]:
        """``(field name, tensor)`` in ``FIELDS`` order, the JAX
        ``TransformerParams``' leaf order (the optimizers' tree walk,
        ``optim.py``)."""
        return [(f, getattr(self, f)) for f in FIELDS]

    def with_leaves(self, leaves) -> "TransformerParams":
        """``TransformerParams`` over ``leaves`` in ``FIELDS`` order."""
        return TransformerParams(*leaves)


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


def transformer_params_from_numpy(tree, device="cpu") -> TransformerParams:
    """The port's parameters from the JAX ``TransformerParams`` as numpy
    arrays, each in its own type (f32, or bf16 bit for bit): ``tree`` is
    an object or mapping with the ``FIELDS``."""
    def t(name):
        a = tree[name] if isinstance(tree, Mapping) else getattr(tree, name)
        return tensor_from_numpy(a, device)

    return TransformerParams(*(t(f) for f in FIELDS))


def split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``[B, T, d] -> [B, H, T, d/H]`` (a view)."""
    b, s, d = t.shape
    return t.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, dh] -> [B, T, H*dh]``."""
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


def attn_sublayer(wq, wk, wv, wo, a: torch.Tensor, n_heads: int,
                  causal: bool = True, attn=None) -> torch.Tensor:
    """Projections and multi-head attention. ``a [B, T, d]``; the KV head
    count is ``wk``'s output dim over the head dim, so a smaller
    ``kv_dim`` runs grouped-query attention with no flag. ``attn`` swaps
    the attention op (``(q, k, v, causal) -> y`` on ``[B, H, T, dh]``):
    None is the hand-VJP ``mha``/``gqa`` oracle; an op without a true
    ``supports_gqa`` attribute refuses GQA shapes."""
    dh = wq.shape[0] // n_heads
    n_kv = wk.shape[0] // dh
    q = split_heads(a @ wq.T, n_heads)
    k = split_heads(a @ wk.T, n_kv)
    v = split_heads(a @ wv.T, n_kv)
    if attn is None:
        op = mha if n_kv == n_heads else gqa
    elif n_kv != n_heads and not getattr(attn, "supports_gqa", False):
        raise ValueError("this attn impl expects full-MHA shapes; "
                         f"got {n_heads} query vs {n_kv} kv heads")
    else:
        op = attn
    return merge_heads(op(q, k, v, causal)) @ wo.T


def transformer_block(ln1, wq, wk, wv, wo, ln2, w1, w2, x: torch.Tensor,
                      n_heads: int, causal: bool = True,
                      attn=None) -> torch.Tensor:
    """One pre-LN block. ``x [B, T, d]`` -> ``[B, T, d]``."""
    b, s, d = x.shape
    x = x + attn_sublayer(wq, wk, wv, wo, layernorm(ln1, x), n_heads,
                          causal, attn)
    f = layernorm(ln2, x).reshape(b * s, d)
    return x + ffn_block(w1, w2, f).reshape(b, s, d)


def transformer_fwd(params: TransformerParams, x: torch.Tensor,
                    n_heads: int, causal: bool = True,
                    attn=None) -> torch.Tensor:
    """Stack forward, ``x [B, T, d]``. The per-layer weights are taken
    with ``unbind``, whose backward is one ``stack`` per field (indexing
    would build a zero ``[L, ...]`` gradient per layer)."""
    for layer in zip(*(getattr(params, f).unbind(0) for f in FIELDS)):
        x = transformer_block(*layer, x, n_heads, causal, attn)
    return x
