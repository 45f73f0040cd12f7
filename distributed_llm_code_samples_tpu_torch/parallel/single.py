"""Single-device trainer, as in the JAX package's ``parallel/single.py``
(reference ``train_1gpu``, ``train_ffns.py:101-116``): per step, the
stack forward, the hand-written backward and inline SGD.

The JAX trainer runs the whole schedule as one ``lax.scan`` in one XLA
program; here the steps run eagerly, one Python iteration a seed.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

from .. import LR
from ..data import batch_from_seed
from ..models.ffn_stack import FFNStackParams, clone_params
from ..optim import sgd
from ..ops.ffn import (ffn_block, ffn_block_mixed, ffn_block_mixed_remat,
                       ffn_block_saved, ffn_bwd, ffn_fwd)
from ..ops.fused_ffn import ffn_bwd_fused, ffn_fwd_fused, fused_ffn_block
from ..ops.stack import (accumulated_grads, stack_bwd, stack_fwd,
                         stack_grads)


def make_step(batch_size: int, model_size: int, lr: float = LR,
              unroll: bool = True, use_pallas: bool = False,
              manual_loop: bool = False, remat: bool | None = None,
              mixed: bool = False, accum: int = 1,
              batch_fn: Callable = batch_from_seed):
    """One training step ``(params, seed) -> params``: the batch from
    ``batch_fn(seed, batch_size, model_size, dtype=, device=)``, forward,
    hand backward, SGD (in place on ``params``).

    By default autograd composes the chain over ``ops.ffn.ffn_block``,
    whose backward is the hand VJP (``ops.stack.stack_grads``);
    ``manual_loop=True`` runs the reference-shaped loops
    (``stack_fwd``/``stack_bwd``) instead. ``use_pallas`` (the JAX
    keyword, kept for parity) selects the three CUDA kernels of
    ``ops/fused_ffn.py`` for each block. ``remat=False`` saves the
    post-ReLU activation instead of recomputing the pre-activation
    (``ffn_block_saved``). ``mixed`` selects the bf16-operand blocks
    (``ffn_block_mixed_remat``, or ``ffn_block_mixed`` with
    ``remat=False``). ``accum`` sums the gradients of that many token
    chunks before the one update. ``unroll`` changes nothing (both JAX
    loop forms are a Python loop here)."""
    if mixed and (use_pallas or manual_loop):
        raise ValueError("mixed=True is its own block implementation; it "
                         "cannot combine with use_pallas/manual_loop")
    if use_pallas and remat is False:
        raise ValueError("the Pallas block has its own residual policy; "
                         "remat=False cannot combine with use_pallas")
    if remat is None:
        remat = True    # the reference's recompute policy is the default

    if manual_loop:
        block_fwd, block_bwd = ((ffn_fwd_fused, ffn_bwd_fused) if use_pallas
                                else (ffn_fwd, ffn_bwd))

        def grads(params, x, dy):
            _, acts = stack_fwd(params.w1, params.w2, x, block_fwd=block_fwd)
            return FFNStackParams(*stack_bwd(dy, params.w1, params.w2, acts,
                                             block_bwd=block_bwd)[1])
    else:
        if use_pallas:
            block = fused_ffn_block
        elif mixed:
            block = ffn_block_mixed_remat if remat else ffn_block_mixed
        else:
            block = ffn_block if remat else ffn_block_saved

        def grads(params, x, dy):
            return FFNStackParams(*stack_grads(params.w1, params.w2, x, dy,
                                               block=block)[1])

    def step(params: FFNStackParams, seed) -> FFNStackParams:
        x, dloss_dx = batch_fn(seed, batch_size, model_size,
                               dtype=params.w1.dtype,
                               device=params.w1.device)
        return sgd(params, accumulated_grads(partial(grads, params), x,
                                             dloss_dx, accum), lr)

    return step


def train_single(params: FFNStackParams, seeds, batch_size: int,
                 model_size: int, mesh=None, lr: float = LR,
                 unroll: bool = True, use_pallas: bool = False,
                 manual_loop: bool = False, remat: bool | None = None,
                 mixed: bool = False, accum: int = 1, guard=None,
                 batch_fn: Callable = batch_from_seed,
                 on_step: Optional[Callable[[int], None]] = None
                 ) -> FFNStackParams:
    """Train a copy of ``params`` over the seed schedule and return it;
    the caller's params are not touched. ``mesh`` is ignored (the
    launcher signature of every strategy). ``on_step(i)`` is called after
    step ``i`` (the CLI times steps with it). The skip-step ``guard`` is
    not ported yet and raises ``NotImplementedError``."""
    if guard is not None:
        raise NotImplementedError("guard (the skip-step guardrail) is not "
                                  "ported yet; pass guard=None")
    step = make_step(batch_size, model_size, lr, unroll, use_pallas,
                     manual_loop, remat, mixed, accum, batch_fn)
    params = clone_params(params)
    for i, seed in enumerate(seeds):
        params = step(params, int(seed))
        if on_step is not None:
            on_step(i)
    return params
