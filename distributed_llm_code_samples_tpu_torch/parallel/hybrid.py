"""Hybrid DDP x TP of the FFN stack on the 2-D data x model mesh, as in
the JAX package's ``parallel/hybrid.py`` (the reference never composes
strategies; the ``train_ffns.py`` docstring at the repo root names it).

- the params are TP-sharded over ``MODEL_AXIS`` (``tp.shard_params``)
  and replicated over ``DATA_AXIS``;
- the seeds are strided over the data axis only and replicated over the
  model axis;
- each block ends in TP's all-reduce over the model axis (``y`` forward,
  ``dx`` backward), and ``grad_hook`` all-reduces each layer's
  ``(dw1, dw2)`` shard over the data axis (the DDP hook): two
  independent reductions on orthogonal axes.

With model 1 it is DDP, with data 1 TP. ``mixed`` swaps in the
bf16-operand blocks, as in TP. ``unroll`` changes nothing.
"""

from __future__ import annotations

from typing import Callable, Optional

from .. import LR
from ..data import batch_from_seed
from ..models.ffn_stack import FFNStackParams
from ..optim import sgd
from ..ops.ffn import ffn_blocks
from ..ops.stack import stack_bwd, stack_fwd
from . import tp
from .collectives import all_reduce
from .launcher import DEFAULT_TIMEOUT_S, launch_strided, run_strided
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, require_axes

shard_params = tp.shard_params


def unshard_params(shards, mesh: Mesh) -> FFNStackParams:
    """The full params from every rank's shards, in rank order: the TP
    shards of the ranks of data index 0 (the other replicas are equal)."""
    return tp.unshard_params([s for r, s in enumerate(shards)
                              if mesh.coords(r)[DATA_AXIS] == 0])


def make_step(batch_size: int, model_size: int, lr: float = LR,
              unroll: bool = True, mixed: bool = False, *, mesh: Mesh,
              batch_fn: Callable = batch_from_seed):
    """One hybrid step ``(shards, seed) -> shards`` for the rank of
    ``mesh`` (a rank's view)."""
    require_axes(mesh, DATA_AXIS, MODEL_AXIS)
    fwd, bwd = ffn_blocks(mixed)

    def block_fwd(w1_shard, w2_shard, x):
        return all_reduce(fwd(w1_shard, w2_shard, x), mesh, axis=MODEL_AXIS)

    def block_bwd(dy, w1_shard, w2_shard, x):
        dx, grads = bwd(dy, w1_shard, w2_shard, x)
        return all_reduce(dx, mesh, axis=MODEL_AXIS), grads

    def grad_hook(dw1, dw2):
        # the DDP reduction of the shard's gradients across the replicas
        return (all_reduce(dw1, mesh, axis=DATA_AXIS),
                all_reduce(dw2, mesh, axis=DATA_AXIS))

    def step(params: FFNStackParams, seed) -> FFNStackParams:
        x, dloss_dx = batch_fn(seed, batch_size, model_size,
                               dtype=params.w1.dtype,
                               device=params.w1.device)
        _, acts = stack_fwd(params.w1, params.w2, x, block_fwd=block_fwd)
        _, grads = stack_bwd(dloss_dx, params.w1, params.w2, acts,
                             block_bwd=block_bwd, grad_hook=grad_hook)
        return sgd(params, FFNStackParams(*grads), lr)

    return step


def train_hybrid(params: FFNStackParams, seeds, batch_size: int,
                 model_size: int, mesh: Mesh, lr: float = LR,
                 unroll: bool = True, mixed: bool = False, *,
                 batch_fn: Callable = batch_from_seed,
                 on_step: Optional[Callable[[int], None]] = None,
                 timeout: float = DEFAULT_TIMEOUT_S) -> FFNStackParams:
    """Run the hybrid schedule on a mesh with the data and model axes:
    the rank of data index i takes ``seeds[t * dp + i]`` at its step t.
    Given the whole mesh it launches the ranks and returns the full final
    params on the device of ``params``; given a rank's view it runs that
    rank and returns its final TP shards. Arguments as ``train_tp``'s."""
    require_axes(mesh, DATA_AXIS, MODEL_AXIS)
    tp.check_divisible(params, mesh.axis_size(MODEL_AXIS))
    if not mesh.in_rank:
        outs = launch_strided(_hybrid_rank, params, seeds, mesh, batch_size,
                              model_size, lr, mixed, batch_fn,
                              axis=DATA_AXIS, timeout=timeout)
        out = unshard_params(outs, mesh)
        return FFNStackParams(*(t.to(params.w1.device) for t in out))
    step = make_step(batch_size, model_size, lr, mixed=mixed, mesh=mesh,
                     batch_fn=batch_fn)
    return run_strided(step, shard_params(params, mesh), seeds, mesh,
                       on_step, axis=DATA_AXIS)


def _hybrid_rank(mesh: Mesh, payload):
    params, seeds, batch_size, model_size, lr, mixed, batch_fn = payload
    out = train_hybrid(params, seeds, batch_size, model_size, mesh, lr,
                       mixed=mixed, batch_fn=batch_fn)
    return FFNStackParams(*(t.cpu() for t in out))
