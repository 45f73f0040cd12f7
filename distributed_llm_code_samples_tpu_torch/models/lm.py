"""Language model: token/position embeddings, pre-LN transformer stack,
final LayerNorm and a head tied to the token embedding (GPT-2 shape
conventions, no biases), as in the JAX package's ``models/lm.py``.

Besides the parameters it holds ``decode_attn`` (the single-query
attention the decode engine's gather path and the kernel's plain version
share), a greedy lockstep ``generate`` over a contiguous cache (an oracle
for the engine that shares no paged code with it), and
``lm_params_from_numpy``, which carries the JAX package's weights across
so that both packages compute the same thing in the tests.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..ops.norm import layernorm
from .attention import rope
from .transformer import FIELDS, TransformerParams, init_transformer


class LMParams(nn.Module):
    """``wte [V, d]`` token embedding (tied head); ``wpe [T_max, d]``
    learned positions; ``blocks`` the transformer stack; ``ln_f [d]``."""

    def __init__(self, wte, wpe, blocks: TransformerParams, ln_f):
        super().__init__()
        self.register_buffer("wte", wte)
        self.register_buffer("wpe", wpe)
        self.blocks = blocks
        self.register_buffer("ln_f", ln_f)

    @property
    def vocab(self) -> int:
        return self.wte.shape[0]

    @property
    def d_model(self) -> int:
        return self.wte.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.wpe.shape[0]

    @property
    def n_layers(self) -> int:
        return self.blocks.n_layers

    @property
    def device(self) -> torch.device:
        return self.wte.device


def init_lm(generator: torch.Generator, vocab: int, d_model: int,
            n_layers: int, max_seq_len: int, ffn_dim: int | None = None,
            scale: float = 2e-2, dtype=torch.float32,
            n_heads: int | None = None, n_kv_heads: int | None = None,
            device=None) -> LMParams:
    """Random weights from ``generator`` in the JAX ``init_lm`` family:
    ``scale * normal``, LN gains at 1; ``n_kv_heads`` (with ``n_heads``)
    shrinks wk/wv to ``n_kv_heads * head_dim`` outputs (GQA). The tensors
    are made on ``device`` (default: the generator's)."""
    kv_dim = None
    if n_heads is not None and d_model % n_heads:
        raise ValueError(f"d_model={d_model} not divisible by "
                         f"n_heads={n_heads}")
    if n_kv_heads is not None:
        if n_heads is None:
            raise ValueError("n_kv_heads needs n_heads (head_dim = "
                             "d_model / n_heads)")
        if n_kv_heads < 1 or n_heads % n_kv_heads:
            raise ValueError(f"n_heads={n_heads} not divisible by "
                             f"n_kv_heads={n_kv_heads}")
        kv_dim = (d_model // n_heads) * n_kv_heads
    device = generator.device if device is None else device

    def normal(*shape):
        return scale * torch.randn(*shape, generator=generator,
                                   dtype=dtype, device=device)

    wte = normal(vocab, d_model)
    wpe = normal(max_seq_len, d_model)
    blocks = init_transformer(generator, d_model, n_layers, ffn_dim, scale,
                              dtype, kv_dim=kv_dim, device=device)
    return LMParams(wte, wpe, blocks,
                    torch.ones(d_model, dtype=dtype, device=device))


def _field(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def lm_params_from_numpy(tree, device="cpu") -> LMParams:
    """The port's parameters from the JAX ``LMParams`` as numpy arrays:
    ``tree`` is an object or mapping with ``wte, wpe, ln_f`` and
    ``blocks.{ln1, wq, wk, wv, wo, ln2, w1, w2}``."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    blocks = _field(tree, "blocks")
    return LMParams(t(_field(tree, "wte")), t(_field(tree, "wpe")),
                    TransformerParams(*(t(_field(blocks, f))
                                        for f in FIELDS)),
                    t(_field(tree, "ln_f")))


def decode_attn(q, ck, cv, lengths):
    """Single-query attention over a contiguous cache. ``q [B, H, dh]``,
    ``ck/cv [B, H_kv, T, dh]`` (``H % H_kv == 0``); positions
    ``>= lengths`` (an int or ``[B]``) are masked to -1e30 after the
    divide by ``sqrt(dh)``."""
    b, h, dh = q.shape
    hkv, t = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bkgd,bktd->bkgt", qg, ck) / torch.sqrt(
        torch.tensor(dh, dtype=q.dtype, device=q.device))
    lengths = torch.as_tensor(lengths, device=q.device)
    mask = torch.arange(t, device=q.device) < lengths[..., None]
    if mask.dim() == 2:
        mask = mask[:, None, None, :]
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                          device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bktd->bkgd", p, cv).reshape(b, h, dh)


def decode_step(params: LMParams, cache_k, cache_v, token, pos: int,
                n_heads: int, use_rope: bool = False):
    """One token per sequence through the stack at position ``pos``,
    writing the contiguous cache ``[L, B, H_kv, T_max, dh]`` in place.
    ``token [B]`` -> logits ``[B, V]``."""
    p = params.blocks
    dh = params.d_model // n_heads
    b = token.shape[0]
    x = params.wte[token] + params.wpe[pos]
    for l in range(p.n_layers):
        a = layernorm(p.ln1[l], x)
        q = (a @ p.wq[l].T).reshape(b, -1, dh)
        k = (a @ p.wk[l].T).reshape(b, -1, dh)
        v = (a @ p.wv[l].T).reshape(b, -1, dh)
        if use_rope:
            pp = torch.full((1,), pos, device=x.device)
            q = rope(q[:, :, None, :], pp)[:, :, 0, :]
            k = rope(k[:, :, None, :], pp)[:, :, 0, :]
        cache_k[l, :, :, pos] = k
        cache_v[l, :, :, pos] = v
        y = decode_attn(q, cache_k[l], cache_v[l], pos + 1)
        x = x + y.reshape(b, -1) @ p.wo[l].T
        h = layernorm(p.ln2[l], x)
        x = x + torch.relu(h @ p.w1[l].T) @ p.w2[l].T
    return layernorm(params.ln_f, x) @ params.wte.T


@torch.no_grad()
def generate(params: LMParams, prompt, n_new: int, n_heads: int, *,
             use_rope: bool = False) -> torch.Tensor:
    """Greedy lockstep decode over a contiguous cache: ``prompt [B, T0]``
    int -> ``[B, T0 + n_new]``. Step ``pos`` feeds the prompt token while
    ``pos < T0`` (filling the cache) and the previous pick after."""
    dev = params.device
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, t0 = prompt.shape
    total = t0 + n_new
    if total > params.max_seq_len:
        raise ValueError(f"prompt {t0} + n_new {n_new} exceeds "
                         f"max_seq_len {params.max_seq_len}")
    dh = params.d_model // n_heads
    kv_heads = params.blocks.wk.shape[1] // dh
    shape = (params.n_layers, b, kv_heads, params.max_seq_len, dh)
    ck = torch.zeros(shape, dtype=params.wte.dtype, device=dev)
    cv = torch.zeros(shape, dtype=params.wte.dtype, device=dev)
    toks = torch.cat([prompt, torch.zeros(b, n_new, dtype=torch.long,
                                          device=dev)], dim=1)
    for pos in range(total - 1):
        logits = decode_step(params, ck, cv, toks[:, pos], pos, n_heads,
                             use_rope)
        if pos + 1 >= t0:
            toks[:, pos + 1] = torch.argmax(logits, dim=-1)
    return toks
