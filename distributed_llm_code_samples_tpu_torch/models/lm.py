"""Language model: token/position embeddings, pre-LN transformer stack,
final LayerNorm and a head tied to the token embedding (GPT-2 shape
conventions, no biases), as in the JAX package's ``models/lm.py``.

Training: ``lm_hidden`` / ``lm_logits`` / ``lm_loss`` (the mean
next-token cross-entropy, with a ``head`` hook for the fused head), and
the parameters as a list of leaves in ``jax.tree_util.tree_leaves``
order (``lm_leaves``, ``lm_from_leaves``, ``clone_lm``) for the trainer.
Serving: ``decode_attn`` (the single-query attention the decode engine's
gather path and the kernel's plain version share), a greedy lockstep
``generate`` over a contiguous cache (an oracle for the engine that
shares no paged code with it) and its sampled form ``sample``.
``lm_params_from_numpy`` carries the JAX package's weights across so
that both packages compute the same thing in the tests.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..ops.norm import layernorm
from ..ops.xent import xent_loss
from .attention import rope
from .ffn_stack import tensor_from_numpy
from .transformer import (FIELDS, TransformerParams, init_transformer,
                          transformer_fwd, transformer_params_from_numpy)


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

    def num_params(self) -> int:
        return sum(t.numel() for t in lm_leaves(self))

    def named_leaves(self) -> list[tuple[str, torch.Tensor]]:
        """``(field name, tensor)`` in ``lm_leaves`` order (the optimizers'
        tree walk, ``optim.py``)."""
        return list(zip(LEAF_NAMES, lm_leaves(self)))

    def with_leaves(self, leaves) -> "LMParams":
        """``LMParams`` over ``leaves`` in ``lm_leaves`` order."""
        return lm_from_leaves(leaves)


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
    """The port's parameters from the JAX ``LMParams`` as numpy arrays,
    each in its own type (f32, or bf16 bit for bit): ``tree`` is an
    object or mapping with ``wte, wpe, ln_f`` and ``blocks.{ln1, wq, wk,
    wv, wo, ln2, w1, w2}``."""
    def t(a):
        return tensor_from_numpy(a, device)

    blocks = _field(tree, "blocks")
    return LMParams(t(_field(tree, "wte")), t(_field(tree, "wpe")),
                    transformer_params_from_numpy(blocks, device),
                    t(_field(tree, "ln_f")))


# the field name of each leaf of ``lm_leaves``
LEAF_NAMES = ("wte", "wpe") + FIELDS + ("ln_f",)


def lm_leaves(params: LMParams) -> list[torch.Tensor]:
    """The parameters in ``jax.tree_util.tree_leaves`` order of the JAX
    ``LMParams``: ``wte, wpe, blocks.{ln1, wq, wk, wv, wo, ln2, w1, w2},
    ln_f``."""
    return ([params.wte, params.wpe]
            + [getattr(params.blocks, f) for f in FIELDS] + [params.ln_f])


def lm_from_leaves(leaves) -> LMParams:
    """``LMParams`` over the tensors of ``lm_leaves`` order (not copied)."""
    leaves = list(leaves)
    return LMParams(leaves[0], leaves[1], TransformerParams(*leaves[2:-1]),
                    leaves[-1])


def clone_lm(params: LMParams) -> LMParams:
    """A copy of every parameter."""
    return lm_from_leaves(t.clone() for t in lm_leaves(params))


def lm_hidden(params: LMParams, tokens: torch.Tensor, n_heads: int,
              attn=None) -> torch.Tensor:
    """Embed, blocks, final LN: ``tokens [B, T]`` int -> ``[B, T, d]``."""
    t = tokens.shape[1]
    x = params.wte[tokens.long()] + params.wpe[:t]
    x = transformer_fwd(params.blocks, x, n_heads, causal=True, attn=attn)
    return layernorm(params.ln_f, x)


def lm_logits(params: LMParams, tokens: torch.Tensor, n_heads: int,
              attn=None) -> torch.Tensor:
    """``tokens [B, T]`` -> logits ``[B, T, V]`` through the tied head."""
    return lm_hidden(params, tokens, n_heads, attn) @ params.wte.T


def lm_loss(params: LMParams, tokens: torch.Tensor, targets: torch.Tensor,
            n_heads: int, attn=None, head=None,
            mixed: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy; ``tokens, targets [B, T]`` int.
    ``head`` swaps the tied head and loss: None builds the ``[N, V]``
    logits and runs the hand-VJP ``xent_loss`` (the oracle); a callable
    ``(h [N, d], wte [V, d], targets [N]) -> loss`` takes the trunk output
    directly (the fused kernels, ``parallel.lm.resolve_head``). ``wte``
    gets gradient from the embedding gather and from the head; autograd
    sums the two.

    ``mixed`` is the LM's bf16 policy (JAX ``models/lm.py:140-160``): the
    trunk (embedding gather, blocks, final LN) runs on a bf16 cast of the
    params with a bf16 residual stream, ``h`` returns to f32, and the head
    and the cross-entropy run in f32 on the f32 master ``wte`` (bf16
    params: on ``wte`` promoted to f32). The embedding's share of
    ``wte``'s gradient comes back through the cast's backward and sums
    with the head's."""
    if mixed:
        trunk = lm_from_leaves(t.to(torch.bfloat16) for t in lm_leaves(params))
        h = lm_hidden(trunk, tokens, n_heads, attn)
        h = h.reshape(-1, h.shape[-1]).to(torch.float32)
        # bf16 params: the f32 head promotes wte, as jnp promotes
        # ``h @ wte.T``; its gradient comes back through the cast
        wte = params.wte.to(torch.float32)
        if head is not None:
            return head(h, wte, targets.reshape(-1))
        return xent_loss(h @ wte.T, targets.reshape(-1))
    if head is not None:
        h = lm_hidden(params, tokens, n_heads, attn)
        return head(h.reshape(-1, h.shape[-1]), params.wte,
                    targets.reshape(-1))
    logits = lm_logits(params, tokens, n_heads, attn)
    return xent_loss(logits.reshape(-1, logits.shape[-1]),
                     targets.reshape(-1))


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
def _decode_loop(params: LMParams, prompt, n_new: int, n_heads: int, pick,
                 use_rope: bool = False) -> torch.Tensor:
    """Lockstep decode over a contiguous cache: ``prompt [B, T0]`` int ->
    ``[B, T0 + n_new]``. Step ``pos`` feeds the prompt token while ``pos <
    T0`` (filling the cache) and the previous pick after; ``pick(logits,
    pos)`` chooses the token at ``pos + 1``."""
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
            toks[:, pos + 1] = pick(logits, pos)
    return toks


def generate(params: LMParams, prompt, n_new: int, n_heads: int, *,
             use_rope: bool = False) -> torch.Tensor:
    """Greedy lockstep decode: ``prompt [B, T0]`` int -> ``[B, T0 +
    n_new]`` (``_decode_loop`` with the argmax pick)."""
    return _decode_loop(params, prompt, n_new, n_heads,
                        lambda z, pos: torch.argmax(z, dim=-1), use_rope)


def sample_pick(temperature: float, top_k: int, vocab: int, seed: int,
                noise_fn=None):
    """The stochastic ``pick(logits, pos)`` of ``_decode_loop`` (JAX
    ``models/lm.py:333``): temperature-scaled, optionally top-k-truncated
    categorical draws, as ``argmax(z + gumbel)`` (JAX's ``categorical``).
    ``noise_fn(pos, shape)`` gives the Gumbel noise of position ``pos``
    (the tests hand JAX's draws in); by default row ``i`` draws from the
    serving sampler's generator keyed on ``(seed, i, pos)``
    (``decode.sampling.gumbel_noise``), so a continuation is reproducible
    with no carried state; its numbers are not ``jax.random``'s. Raises
    JAX's ``ValueError``s."""
    if temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature} "
                         "(use the greedy decoder — generate/"
                         "moe_generate — for the argmax limit)")
    if top_k < 0 or top_k > vocab:
        raise ValueError(f"top_k={top_k} outside [0, vocab={vocab}]")

    def pick(logits, pos):
        z = logits.float() / temperature
        if top_k:
            kth = torch.topk(z, top_k, dim=-1).values[:, -1:]
            z = torch.where(z < kth, torch.full_like(z, float("-inf")), z)
        if noise_fn is None:
            from ..decode.sampling import gumbel_noise
            g = gumbel_noise(seed, range(z.shape[0]), [pos] * z.shape[0],
                             z.shape[1], z.device)
        else:
            g = torch.from_numpy(np.array(noise_fn(pos, tuple(z.shape)),
                                          dtype=np.float32)).to(z.device)
        return torch.argmax(z + g, dim=-1)

    return pick


def sample(params: LMParams, prompt, n_new: int, n_heads: int, *,
           temperature: float = 1.0, top_k: int = 0, seed: int = 0,
           use_rope: bool = False, noise_fn=None) -> torch.Tensor:
    """Stochastic decode (JAX ``models/lm.py:359``; see ``sample_pick``).
    ``top_k=0`` samples the whole distribution; ``top_k=1`` is greedy."""
    return _decode_loop(params, prompt, n_new, n_heads,
                        sample_pick(temperature, top_k, params.vocab, seed,
                                    noise_fn), use_rope)
