"""The single-device LM trainer, as in the JAX package's
``parallel/lm.py`` (``train_lm_single``): per step, a batch of next-token
sequences, the mean cross-entropy of the tied head, its gradients
(autograd composing the hand VJPs of LayerNorm, attention, the FFN
blocks and the loss) and inline SGD. ``attn_impl`` and ``head_impl``
select the oracle ops or the hand-written kernels (flash attention, the
fused head). The JAX trainer runs the schedule as one ``lax.scan``; here
the steps run eagerly. DDP, FSDP and TP are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import lm_batch_from_seed
from ..models.lm import LMParams, clone_lm, lm_from_leaves, lm_leaves, lm_loss
from ..optim import sgd
from .transformer import _validate_shapes, resolve_attn


def _validate_lm(batch_size: int, seq_len: int, model_size: int,
                 n_heads: int, params: LMParams) -> None:
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    if seq_len > params.max_seq_len:
        raise ValueError(f"seq_len={seq_len} exceeds the model's "
                         f"max_seq_len={params.max_seq_len}")


def resolve_head(head_impl: str | None):
    """The head + loss op ``models.lm.lm_loss`` plugs in: None/"oracle"
    builds the ``[N, V]`` logits and runs the hand-VJP xent; "fused" is
    the fused kernels (``ops.fused_xent.head_xent``), no ``[N, V]`` array
    in either direction."""
    if head_impl in (None, "oracle"):
        return None
    if head_impl == "fused":
        from ..ops.fused_xent import head_xent
        return head_xent
    raise ValueError(f"unknown head_impl {head_impl!r} "
                     "(expected 'oracle' or 'fused')")


def lm_grads(params: LMParams, tokens, targets, n_heads: int, attn=None,
             head=None):
    """``(loss, grads)`` of ``lm_loss`` with ``grads`` in ``lm_leaves``
    order. Each leaf is taken with ``detach().requires_grad_()`` (the
    parameters are buffers) and ``torch.autograd.grad`` differentiates
    the loss; ``wte``'s gradient sums its embedding and head sides."""
    leaves = [t.detach().requires_grad_() for t in lm_leaves(params)]
    with torch.enable_grad():
        loss = lm_loss(lm_from_leaves(leaves), tokens, targets, n_heads,
                       attn, head)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def _make_step(batch_size: int, model_size: int, seq_len: int,
               n_heads: int, lr: float, attn=None, batch_fn=None,
               head=None):
    """One update ``(params, seed) -> params``; ``batch_size`` is tokens
    a step. The batch is ``batch_fn(seed) -> (tokens, targets)``, or the
    seeds-as-dataset ``lm_batch_from_seed`` on the params' device. SGD
    updates ``params`` in place."""
    b = batch_size // seq_len

    def step(params: LMParams, seed) -> LMParams:
        tokens, targets = (batch_fn(seed) if batch_fn is not None else
                           lm_batch_from_seed(seed, b, seq_len, params.vocab,
                                              device=params.device))
        _, grads = lm_grads(params, tokens, targets, n_heads, attn, head)
        sgd(lm_leaves(params), grads, lr)
        return params

    return step


def train_lm_single(params: LMParams, seeds, batch_size: int,
                    model_size: int, mesh=None, lr: float = LR, *,
                    seq_len: int, n_heads: int,
                    attn_impl: str | None = None, optimizer=None,
                    opt_state=None, return_state: bool = False,
                    batch_fn: Optional[Callable] = None,
                    head_impl: str | None = None, mixed: bool = False,
                    on_step: Optional[Callable[[int], None]] = None
                    ) -> LMParams:
    """Train a copy of ``params`` over the seed schedule and return it;
    the caller's params are not touched. ``batch_size`` is tokens a step
    (``seq_len`` folded in); ``mesh`` is ignored (the launcher signature
    of every strategy). ``on_step(i)`` is called after step ``i``. The
    stateful optimizers (``optimizer``, ``opt_state``, ``return_state``)
    and ``mixed`` are not ported yet and raise ``NotImplementedError``."""
    _validate_lm(batch_size, seq_len, model_size, n_heads, params)
    if optimizer is not None or opt_state is not None or return_state:
        raise NotImplementedError("stateful optimizers (optimizer, "
                                  "opt_state, return_state) are not ported "
                                  "yet; the trainer runs inline SGD")
    if mixed:
        raise NotImplementedError("mixed=True (the bf16 trunk) is not "
                                  "ported yet")
    step = _make_step(batch_size, model_size, seq_len, n_heads, lr,
                      resolve_attn(attn_impl), batch_fn,
                      resolve_head(head_impl))
    params = clone_lm(params)
    for i, seed in enumerate(seeds):
        params = step(params, int(seed))
        if on_step is not None:
            on_step(i)
    return params
