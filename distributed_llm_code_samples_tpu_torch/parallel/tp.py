"""Megatron tensor parallelism of the FFN stack, as in the JAX package's
``parallel/tp.py`` (reference ``train_tp`` / ``train_process_tp``,
``train_ffns.py:289-338``): column-parallel W1, row-parallel W2.

Rank j of the model axis holds block j of each layer's ffn dim: ``w1[:,
block j, :]`` and ``w2[:, :, block j]`` (``chunk_p(p, dim=i)``,
``:316-319``). The chunked dims are conjugate, so no collective crosses
the ReLU: each rank makes a full-width slice of the hidden activation,
and one ``all_reduce`` a layer a direction restores the replicated
activation (forward, ``:303``) and input gradient (backward, ``:309``).
Every rank takes every seed (``:324``); the weight gradients stay on
their shard, whose SGD is the rank's own (``:311-312``).

``make_sp_step`` is the sequence-parallel form (Korthikanti et al.):
between blocks the stream is token-sharded, ``[T/n, d]`` a rank, and
each all-reduce becomes an all-gather in and a reduce-scatter out.

The reductions are ``parallel/collectives.py``'s on the model axis
(NCCL on the card, gloo on the CPU, plain torch in loopback); as in JAX,
TP has no kernel transport. ``mixed`` swaps in the bf16-operand blocks
(``ops.ffn.ffn_fwd_mixed`` / ``ffn_bwd_mixed``); the reductions and the
shards stay f32. ``unroll`` changes nothing (one Python loop).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import batch_from_seed
from ..models.ffn_stack import FFNStackParams
from ..optim import sgd
from ..ops.ffn import ffn_blocks
from ..ops.stack import stack_bwd, stack_fwd
from .collectives import all_gather, all_reduce, axis_index, reduce_scatter
from .launcher import DEFAULT_TIMEOUT_S, launch_replicated, run_replicated
from .mesh import MODEL_AXIS, Mesh, require_axes

# the ffn dim of the stacked layout: w1 [L, ffn, d] column-parallel, w2
# [L, d, ffn] row-parallel (train_ffns.py:316-319)
SHARD_DIMS = FFNStackParams(w1=1, w2=2)


def check_divisible(params: FFNStackParams, n: int) -> None:
    if params.ffn_dim % n:
        raise ValueError(f"ffn_dim {params.ffn_dim} not divisible by {n} "
                         "model shards")


def _check_tokens(batch_size: int, n: int) -> None:
    if batch_size % n:
        raise ValueError(f"tokens {batch_size} not divisible by {n} model "
                         "shards (sequence-parallel TP shards the token dim "
                         "between blocks)")


def shard_params(params: FFNStackParams, mesh: Mesh) -> FFNStackParams:
    """The shards of the rank of ``mesh`` (a rank's view), fresh and
    contiguous on its device: block ``axis_index(MODEL_AXIS)`` of each
    layer's ffn dim."""
    n, j = mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)
    check_divisible(params, n)
    return FFNStackParams(*(
        t.chunk(n, dim)[j].to(mesh.torch_device, copy=True).contiguous()
        for t, dim in zip(params, SHARD_DIMS)))


def unshard_params(shards) -> FFNStackParams:
    """The full params from the shards of the model axis, in its order."""
    return FFNStackParams(*(torch.cat(list(ts), dim)
                            for ts, dim in zip(zip(*shards), SHARD_DIMS)))


def make_step(batch_size: int, model_size: int, lr: float = LR,
              unroll: bool = True, axis: str = MODEL_AXIS,
              mixed: bool = False, *, mesh: Mesh,
              batch_fn: Callable = batch_from_seed):
    """One TP step ``(shards, seed) -> shards`` for the rank of ``mesh``
    (a rank's view): the whole batch, the stack forward whose blocks end
    in the all-reduce of ``y`` over ``axis``, the backward whose blocks
    end in that of ``dx``, SGD on the shards in place."""
    require_axes(mesh, axis)
    fwd, bwd = ffn_blocks(mixed)

    def block_fwd(w1_shard, w2_shard, x):
        # a partial y on each rank, summed (train_ffns.py:302-303)
        return all_reduce(fwd(w1_shard, w2_shard, x), mesh, axis=axis)

    def block_bwd(dy, w1_shard, w2_shard, x):
        # the shard's VJP, then the input gradient summed (:308-309)
        dx, grads = bwd(dy, w1_shard, w2_shard, x)
        return all_reduce(dx, mesh, axis=axis), grads

    def step(params: FFNStackParams, seed) -> FFNStackParams:
        x, dloss_dx = batch_fn(seed, batch_size, model_size,
                               dtype=params.w1.dtype,
                               device=params.w1.device)
        _, acts = stack_fwd(params.w1, params.w2, x, block_fwd=block_fwd)
        _, grads = stack_bwd(dloss_dx, params.w1, params.w2, acts,
                             block_bwd=block_bwd)
        return sgd(params, FFNStackParams(*grads), lr)

    return step


def make_sp_step(batch_size: int, model_size: int, n_shards: int,
                 lr: float = LR, unroll: bool = True,
                 axis: str = MODEL_AXIS, mixed: bool = False, *,
                 mesh: Mesh, batch_fn: Callable = batch_from_seed,
                 saved: Optional[list] = None):
    """One sequence-parallel TP step for the rank of ``mesh``. The rank
    keeps token block ``axis_index(axis)`` of the batch, ``[T/n, d]``;
    each block forward gathers the tokens, runs the block on its shard
    and reduce-scatters the partial ``y`` (the sum and the token split in
    one). The block backward gathers ``x`` again (it is recomputed, not
    saved) and ``dy``, runs the block VJP on every token, and
    reduce-scatters ``dx``. The weight gradients see every token, so
    they are whole on each shard, as in plain TP. ``saved``, if given,
    receives each step's saved activations (``[L, T/n, d]``)."""
    require_axes(mesh, axis)
    fwd, bwd = ffn_blocks(mixed)
    _check_tokens(batch_size, n_shards)
    t_local = batch_size // n_shards

    def block_fwd(w1_shard, w2_shard, x_s):
        full = all_gather(x_s, mesh, dim=0, axis=axis)           # [T, d]
        part = fwd(w1_shard, w2_shard, full)           # partial over ffn
        return reduce_scatter(part, mesh, dim=0, axis=axis)      # [T/n, d]

    def block_bwd(dy_s, w1_shard, w2_shard, x_s):
        full = all_gather(x_s, mesh, dim=0, axis=axis)   # recomputed
        dy_full = all_gather(dy_s, mesh, dim=0, axis=axis)
        dx_full, grads = bwd(dy_full, w1_shard, w2_shard, full)
        return reduce_scatter(dx_full, mesh, dim=0, axis=axis), grads

    def step(params: FFNStackParams, seed) -> FFNStackParams:
        x, dloss_dx = batch_fn(seed, batch_size, model_size,
                               dtype=params.w1.dtype,
                               device=params.w1.device)
        r = axis_index(mesh, axis)
        x_s, dy_s = (t[r * t_local:(r + 1) * t_local] for t in (x, dloss_dx))
        _, acts = stack_fwd(params.w1, params.w2, x_s, block_fwd=block_fwd)
        if saved is not None:
            saved.append(acts)
        _, grads = stack_bwd(dy_s, params.w1, params.w2, acts,
                             block_bwd=block_bwd)
        return sgd(params, FFNStackParams(*grads), lr)

    return step


def _train(sequence_parallel: bool, params: FFNStackParams, seeds,
           batch_size: int, model_size: int, mesh: Mesh, lr: float,
           mixed: bool, batch_fn: Callable, on_step, timeout: float):
    require_axes(mesh, MODEL_AXIS)
    n = mesh.axis_size(MODEL_AXIS)
    check_divisible(params, n)
    if sequence_parallel:
        _check_tokens(batch_size, n)
    if not mesh.in_rank:
        shards = launch_replicated(_tp_rank, params, seeds, mesh,
                                   sequence_parallel, batch_size,
                                   model_size, lr, mixed, batch_fn,
                                   timeout=timeout)
        out = unshard_params(shards)
        return FFNStackParams(*(t.to(params.w1.device) for t in out))
    if sequence_parallel:
        step = make_sp_step(batch_size, model_size, n, lr, mixed=mixed,
                            mesh=mesh, batch_fn=batch_fn)
    else:
        step = make_step(batch_size, model_size, lr, mixed=mixed, mesh=mesh,
                         batch_fn=batch_fn)
    return run_replicated(step, shard_params(params, mesh), seeds, mesh,
                          on_step)


def train_tp(params: FFNStackParams, seeds, batch_size: int,
             model_size: int, mesh: Mesh, lr: float = LR,
             unroll: bool = True, mixed: bool = False, *,
             batch_fn: Callable = batch_from_seed,
             on_step: Optional[Callable[[int], None]] = None,
             timeout: float = DEFAULT_TIMEOUT_S) -> FFNStackParams:
    """Run the TP schedule on a mesh with the model axis. Every rank takes
    every seed (``train_ffns.py:324``), so TP takes the same steps as
    ``train_single`` and must agree with it. Given the whole mesh it
    launches the ranks and returns the full final params on the device
    of ``params``; given a rank's view, inside a process group that
    exists, it runs that rank and returns its final shards
    (``unshard_params`` joins them). The caller's params are not touched.
    ``batch_fn``, ``on_step`` and ``timeout`` as ``train_ddp``'s."""
    return _train(False, params, seeds, batch_size, model_size, mesh, lr,
                  mixed, batch_fn, on_step, timeout)


def train_tp_sp(params: FFNStackParams, seeds, batch_size: int,
                model_size: int, mesh: Mesh, lr: float = LR,
                unroll: bool = True, mixed: bool = False, *,
                batch_fn: Callable = batch_from_seed,
                on_step: Optional[Callable[[int], None]] = None,
                timeout: float = DEFAULT_TIMEOUT_S) -> FFNStackParams:
    """Sequence-parallel TP (``make_sp_step``), otherwise as ``train_tp``:
    each rank makes the step's whole batch and keeps its token block, so
    ``train_tp_sp == train_tp == train_single``; the decomposition
    changes the memory and the collectives, not the math."""
    return _train(True, params, seeds, batch_size, model_size, mesh, lr,
                  mixed, batch_fn, on_step, timeout)


def _tp_rank(mesh: Mesh, payload):
    params, seeds, sequence_parallel, batch_size, model_size, lr, mixed, \
        batch_fn = payload
    train = train_tp_sp if sequence_parallel else train_tp
    out = train(params, seeds, batch_size, model_size, mesh, lr,
                mixed=mixed, batch_fn=batch_fn)
    return FFNStackParams(*(t.cpu() for t in out))
