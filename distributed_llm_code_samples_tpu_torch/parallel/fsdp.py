"""FSDP / ZeRO-3 of the FFN stack: params sharded, gathered per layer,
gradients reduce-scattered, as in the JAX package's ``parallel/fsdp.py``
(reference ``train_fsdp`` / ``train_process_fsdp``,
``train_ffns.py:195-287``).

Each rank keeps dim 0 of every layer's ``w1 [ffn, d]`` and ``w2 [d,
ffn]`` split n ways (``shard_params``, the JAX ``PARAM_SPECS``
``P(None, "data", None)`` on the stacked layout). Per step and layer:

- forward: all-gather the layer's two shards, run the block, drop the
  full layer (``train_ffns.py:200-225``);
- backward: gather again, run the block's VJP (``:245-249``), then
  reduce-scatter ``(dw1, dw2)`` back to shards in the ``grad_hook``
  (``:255-256``);
- SGD on the local shards only (``:258-259``).

The full layer exists only for the duration of its block; what a rank
keeps is 1/n of the model. ``comm`` picks the transport: ``"psum"`` is
``torch.distributed``'s all-gather and reduce-scatter (NCCL on the card;
on gloo the reduce-scatter is an all-reduce and a slice, see
``parallel/collectives.py``), ``"pallas_ring"`` the hand-written ring
kernels ``ring_all_gather`` and ``ring_reduce_scatter``
(``ops/ring.py``; their plain rings on the CPU).

Not ported yet, and refused: the stateful optimizers, ``mixed`` (bf16
gathers), ``guard`` and the elastic ``seed_accum``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import batch_from_seed
from ..models.ffn_stack import FFNStackParams
from ..optim import sgd
from ..ops.ffn import ffn_bwd, ffn_fwd
from ..ops.ring import ring_all_gather, ring_reduce_scatter
from ..ops.stack import stack_bwd, stack_fwd
from .collectives import all_gather, check_comm, reduce_scatter
from .launcher import (DEFAULT_TIMEOUT_S, launch_strided, refuse_unported,
                       run_strided)
from .mesh import DATA_AXIS, Mesh, require_axes

# the sharded dim of the stacked layout: dim 0 of each layer's weights
SHARD_DIM = 1


def _check_divisible(params: FFNStackParams, n: int) -> None:
    if params.w1.shape[SHARD_DIM] % n or params.w2.shape[SHARD_DIM] % n:
        raise ValueError(
            f"param dims {params.w1.shape[SHARD_DIM]}x"
            f"{params.w2.shape[SHARD_DIM]} not divisible by {n} shards (the "
            "reference's chunk() had the same implicit requirement)")


def shard_params(params: FFNStackParams, mesh: Mesh) -> FFNStackParams:
    """The shards of the rank of ``mesh`` (a rank's view), fresh and
    contiguous on its device: ``w1 [L, ffn/n, d]`` and ``w2 [L, d/n,
    ffn]``, block ``rank`` of each layer's dim 0 (the reference's
    ``chunk_p``, ``train_ffns.py:265-272``)."""
    _check_divisible(params, mesh.size)
    return FFNStackParams(*(
        t.chunk(mesh.size, SHARD_DIM)[mesh.rank].to(mesh.torch_device,
                                                     copy=True)
        .contiguous() for t in params))


def unshard_params(shards) -> FFNStackParams:
    """The full params from every rank's shards, in rank order (the
    reference's re-assembly, ``train_ffns.py:284-287``)."""
    return FFNStackParams(*(torch.cat(list(ts), SHARD_DIM)
                            for ts in zip(*shards)))


def make_step(batch_size: int, model_size: int, lr: float = LR,
              unroll: bool = True, axis: str = DATA_AXIS, optimizer=None,
              mixed: bool = False, comm: str = "psum", guard=None,
              seed_accum: int = 1, *, mesh: Mesh,
              batch_fn: Callable = batch_from_seed):
    """One FSDP step ``(shards, seed) -> shards`` for the rank of ``mesh``
    (a rank's view); SGD updates the shards in place. ``unroll`` changes
    nothing (one Python loop)."""
    refuse_unported(optimizer=(optimizer, None), mixed=(mixed, False),
                    guard=(guard, None), seed_accum=(seed_accum, 1))
    require_axes(mesh, axis)
    check_comm(comm, mesh)
    if comm == "pallas_ring":
        gather = lambda t: ring_all_gather(t, mesh)          # noqa: E731
        scatter = lambda t: ring_reduce_scatter(t, mesh)     # noqa: E731
    else:
        gather = lambda t: all_gather(t, mesh, dim=0)        # noqa: E731
        scatter = lambda t: reduce_scatter(t, mesh, dim=0)   # noqa: E731

    def block_fwd(w1_shard, w2_shard, x):
        return ffn_fwd(gather(w1_shard), gather(w2_shard), x)

    def block_bwd(dy, w1_shard, w2_shard, x):
        # the backward gathers the layer again (train_ffns.py:245-249)
        return ffn_bwd(dy, gather(w1_shard), gather(w2_shard), x)

    def grad_hook(dw1, dw2):
        # the VJP of the gather: full grads -> summed shard (:255-256)
        return scatter(dw1), scatter(dw2)

    def step(params: FFNStackParams, seed) -> FFNStackParams:
        x, dloss_dx = batch_fn(seed, batch_size, model_size,
                               dtype=params.w1.dtype,
                               device=params.w1.device)
        _, acts = stack_fwd(params.w1, params.w2, x, block_fwd=block_fwd)
        _, grads = stack_bwd(dloss_dx, params.w1, params.w2, acts,
                             block_bwd=block_bwd, grad_hook=grad_hook)
        return sgd(params, FFNStackParams(*grads), lr)

    return step


def train_fsdp(params: FFNStackParams, seeds, batch_size: int,
               model_size: int, mesh: Mesh, lr: float = LR,
               unroll: bool = True, optimizer=None, opt_state=None,
               return_state: bool = False, mixed: bool = False,
               comm: str = "psum", guard=None, guard_state=None,
               return_guard: bool = False, seed_accum: int = 1, *,
               batch_fn: Callable = batch_from_seed,
               on_step: Optional[Callable[[int], None]] = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> FFNStackParams:
    """Run the FSDP schedule. Given the whole mesh it launches the ranks
    and returns the full final params, re-assembled from the shards, on
    the device of ``params``. Given a rank's view, inside a process group
    that exists, it runs that rank's share and returns the rank's final
    shards (``unshard_params`` joins every rank's). The caller's params
    are not touched. Arguments as ``train_ddp``'s."""
    refuse_unported(opt_state=(opt_state, None),
                    return_state=(return_state, False),
                    guard_state=(guard_state, None),
                    return_guard=(return_guard, False))
    require_axes(mesh, DATA_AXIS)
    check_comm(comm, mesh)
    _check_divisible(params, mesh.size)
    if not mesh.in_rank:
        refuse_unported(optimizer=(optimizer, None), mixed=(mixed, False),
                        guard=(guard, None), seed_accum=(seed_accum, 1))
        shards = launch_strided(_fsdp_rank, params, seeds, mesh,
                                batch_size, model_size, lr, comm, batch_fn,
                                timeout=timeout)
        out = unshard_params(shards)
        return FFNStackParams(*(t.to(params.w1.device) for t in out))
    step = make_step(batch_size, model_size, lr, unroll,
                     optimizer=optimizer, mixed=mixed, comm=comm,
                     guard=guard, seed_accum=seed_accum, mesh=mesh,
                     batch_fn=batch_fn)
    local = shard_params(params, mesh)
    if comm == "pallas_ring":
        # the workspace holds a gathered layer weight
        mesh.ring(4 * params.w1[0].numel())
    return run_strided(step, local, seeds, mesh, on_step)


def _fsdp_rank(mesh: Mesh, payload):
    params, seeds, batch_size, model_size, lr, comm, batch_fn = payload
    out = train_fsdp(params, seeds, batch_size, model_size, mesh, lr,
                     comm=comm, batch_fn=batch_fn)
    return FFNStackParams(*(t.cpu() for t in out))
