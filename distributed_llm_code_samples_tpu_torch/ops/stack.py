"""FFN-stack forward and backward with the hook points the parallel
strategies splice into, as in the JAX package's ``ops/stack.py``
(reference ``tlayers_ffn_fwd`` / ``tlayers_ffn_bkwd``,
``train_ffns.py:72-94``):

- ``block_fwd(w1, w2, x) -> y`` and ``block_bwd(dy, w1, w2, x) ->
  (dx, (dw1, dw2))``: the per-block math (TP adds an all-reduce, FSDP
  gathers shards);
- ``grad_hook(dw1, dw2) -> (dw1, dw2)``: called the moment a layer's
  gradients exist (DDP reduces them there).

Only block inputs are saved as activations. Stacked parameters are
``w1s [L, ffn, d]``, ``w2s [L, d, ffn]``. ``unroll`` is accepted for
parity and changes nothing: both of the JAX package's loop forms (the
unrolled loop and ``lax.scan``) are a Python loop here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ffn import ffn_block, ffn_bwd, ffn_fwd

GradHook = Callable[[torch.Tensor, torch.Tensor], tuple]


def stack_fwd(w1s, w2s, x, *, block_fwd=ffn_fwd, unroll: bool = True):
    """Forward through the stack; returns ``(y, acts)`` with ``acts
    [L, T, d]`` the block inputs."""
    acts = []
    y = x
    for w1, w2 in zip(w1s.unbind(0), w2s.unbind(0)):
        acts.append(y)
        y = block_fwd(w1, w2, y)
    return y, torch.stack(acts)


def stack_bwd(dy, w1s, w2s, acts, *, block_bwd=ffn_bwd,
              grad_hook: Optional[GradHook] = None, unroll: bool = True):
    """Walk the stack backward, last layer first; returns ``(dx, (g1s,
    g2s))`` with the gradients stacked in layer order. ``grad_hook`` sees
    each layer's ``(dw1, dw2)`` as soon as they exist."""
    n = acts.shape[0]
    w1l, w2l = w1s.unbind(0), w2s.unbind(0)
    g1, g2 = [None] * n, [None] * n
    for l in reversed(range(n)):
        dy, (dw1, dw2) = block_bwd(dy, w1l[l], w2l[l], acts[l])
        if grad_hook is not None:
            dw1, dw2 = grad_hook(dw1, dw2)
        g1[l], g2[l] = dw1, dw2
    return dy, (torch.stack(g1), torch.stack(g2))


def accumulated_grads(grad_fn, x, dy, accum: int):
    """Sum ``grad_fn(x_chunk, dy_chunk)`` over ``accum`` equal chunks of
    the token axis, in chunk order (SUM semantics: exactly the full-batch
    gradient up to rounding). ``grad_fn`` returns a tuple of fresh
    tensors (e.g. ``FFNStackParams``); the first chunk's are summed into
    in place and returned."""
    if accum == 1:
        return grad_fn(x, dy)
    tokens = x.shape[0]
    if tokens % accum:
        raise ValueError(f"tokens {tokens} not divisible into {accum} "
                         "accumulation chunks")
    chunks = zip(x.chunk(accum), dy.chunk(accum))
    total = grad_fn(*next(chunks))
    for xc, dc in chunks:
        for a, b in zip(total, grad_fn(xc, dc)):
            a.add_(b)
    return total


def stack_grads(w1s, w2s, x, dy, *, block=ffn_block, unroll: bool = True):
    """Whole-stack gradients: autograd composes the chain over ``block``,
    whose per-block rule is the hand VJP (an ``autograd.Function``).

    The per-layer weights are taken once with ``unbind``, whose backward
    is one ``stack``; indexing ``w1s[l]`` would make autograd build a
    zero ``[L, ffn, d]`` gradient per layer. Returns ``(y, (g1s, g2s))``.
    """
    w1s = w1s.detach().requires_grad_()
    w2s = w2s.detach().requires_grad_()
    with torch.enable_grad():
        y = x
        for w1, w2 in zip(w1s.unbind(0), w2s.unbind(0)):
            y = block(w1, w2, y)
        g1s, g2s = torch.autograd.grad(y, (w1s, w2s), dy)
    return y.detach(), (g1s, g2s)
