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
- SGD on the local shards only (``:258-259``), or the ``optimizer``'s
  update, its state made from the local shards and living there
  (ZeRO-3: params, gradients and optimizer state all 1/n a rank).

The full layer exists only for the duration of its block; what a rank
keeps is 1/n of the model. ``comm`` picks the transport: ``"psum"`` is
``torch.distributed``'s all-gather and reduce-scatter (NCCL on the card;
on gloo the reduce-scatter is an all-reduce and a slice, see
``parallel/collectives.py``), ``"pallas_ring"`` the hand-written ring
kernels ``ring_all_gather`` and ``ring_reduce_scatter``
(``ops/ring.py``; their plain rings on the CPU).

``mixed`` casts each shard to bf16 before the gather, which halves the
bytes of FSDP's largest collective (under ``"pallas_ring"`` the gather
kernel moves the bf16 bits), and runs the bf16-operand blocks; the
master shards and the gradient reduce-scatter stay f32.

Not ported yet, and refused: ``guard`` and the elastic ``seed_accum``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import batch_from_seed
from ..models.ffn_stack import FFNStackParams
from ..optim import check_state_args, sgd, tree_map
from ..ops.ffn import ffn_blocks
from ..ops.ring import ring_all_gather, ring_reduce_scatter
from ..ops.stack import stack_bwd, stack_fwd
from .collectives import all_gather, check_comm, reduce_scatter
from .launcher import (DEFAULT_TIMEOUT_S, launch_strided, refuse_unported,
                       run_strided, to_device)
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


def _sharded(t: torch.Tensor) -> bool:
    """Whether an optimizer-state leaf is param-shaped (stacked ``[L, out,
    in]``, sharded with the params) rather than bookkeeping (a step
    count, replicated): JAX ``fsdp.state_spec``."""
    return t.dim() == 3


def shard_state(state, mesh: Mesh):
    """The rank of ``mesh``'s shard of a full optimizer state, on its
    device: param-shaped leaves split as ``shard_params`` splits the
    params, the others copied."""
    return tree_map(lambda t: (t.chunk(mesh.size, SHARD_DIM)[mesh.rank]
                               if _sharded(t) else t)
                    .to(mesh.torch_device, copy=True).contiguous(), state)


def unshard_state(states):
    """The full optimizer state from every rank's shard, in rank order
    (``unshard_params`` for the param-shaped leaves, rank 0's for the
    others)."""
    return tree_map(lambda *ts: (torch.cat(ts, SHARD_DIM)
                                 if _sharded(ts[0]) else ts[0]), *states)


def make_step(batch_size: int, model_size: int, lr: float = LR,
              unroll: bool = True, axis: str = DATA_AXIS, optimizer=None,
              mixed: bool = False, comm: str = "psum", guard=None,
              seed_accum: int = 1, *, mesh: Mesh,
              batch_fn: Callable = batch_from_seed):
    """One FSDP step for the rank of ``mesh`` (a rank's view): ``(shards,
    seed) -> shards`` with SGD in place on the shards, or with
    ``optimizer`` ``((shards, state), seed) -> (shards, state)``, the
    state the shards'. ``unroll`` changes nothing (one Python loop)."""
    refuse_unported(guard=(guard, None), seed_accum=(seed_accum, 1))
    require_axes(mesh, axis)
    check_comm(comm, mesh)
    if comm == "pallas_ring":
        _gather = lambda t: ring_all_gather(t, mesh)         # noqa: E731
        scatter = lambda t: ring_reduce_scatter(t, mesh)     # noqa: E731
    else:
        _gather = lambda t: all_gather(t, mesh, dim=0)       # noqa: E731
        scatter = lambda t: reduce_scatter(t, mesh, dim=0)   # noqa: E731
    fwd, bwd = ffn_blocks(mixed)

    def gather(shard):
        # under mixed the shard is cast before the gather: half the bytes,
        # the same gathered values
        return _gather(shard.to(torch.bfloat16) if mixed else shard)

    def block_fwd(w1_shard, w2_shard, x):
        return fwd(gather(w1_shard), gather(w2_shard), x)

    def block_bwd(dy, w1_shard, w2_shard, x):
        # the backward gathers the layer again (train_ffns.py:245-249)
        return bwd(dy, gather(w1_shard), gather(w2_shard), x)

    def grad_hook(dw1, dw2):
        # the VJP of the gather: full grads -> summed shard (:255-256)
        return scatter(dw1), scatter(dw2)

    def grads_of(params: FFNStackParams, seed) -> FFNStackParams:
        x, dloss_dx = batch_fn(seed, batch_size, model_size,
                               dtype=params.w1.dtype,
                               device=params.w1.device)
        _, acts = stack_fwd(params.w1, params.w2, x, block_fwd=block_fwd)
        _, grads = stack_bwd(dloss_dx, params.w1, params.w2, acts,
                             block_bwd=block_bwd, grad_hook=grad_hook)
        return FFNStackParams(*grads)

    def step(params: FFNStackParams, seed) -> FFNStackParams:
        return sgd(params, grads_of(params, seed), lr)

    def step_opt(carry, seed):
        # the update is elementwise on the shards: the state needs no
        # collective (a clipped norm sums over the axis itself)
        params, state = carry
        return optimizer.update(grads_of(params, seed), state, params, lr,
                                mesh=mesh)

    return step if optimizer is None else step_opt


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
    are not touched. Arguments as ``train_ddp``'s.

    ``optimizer``'s state is made from the rank's shards and stays there.
    With ``return_state`` the result is ``(params, opt_state)``: given the
    whole mesh, the full state re-assembled as the params are
    (``unshard_state``), which ``opt_state`` takes back and shards again;
    given a rank's view, the rank's shard of it, in and out."""
    refuse_unported(guard_state=(guard_state, None),
                    return_guard=(return_guard, False))
    require_axes(mesh, DATA_AXIS)
    check_comm(comm, mesh)
    check_state_args(optimizer, opt_state, return_state)
    _check_divisible(params, mesh.size)
    if not mesh.in_rank:
        refuse_unported(guard=(guard, None), seed_accum=(seed_accum, 1))
        outs = launch_strided(
            _fsdp_rank, params, seeds, mesh, batch_size, model_size, lr,
            comm, batch_fn, optimizer, to_device(opt_state, "cpu"),
            return_state, mixed, timeout=timeout)
        dev = params.w1.device
        if return_state:
            return (to_device(unshard_params([o[0] for o in outs]), dev),
                    to_device(unshard_state([o[1] for o in outs]), dev))
        return to_device(unshard_params(outs), dev)
    step = make_step(batch_size, model_size, lr, unroll,
                     optimizer=optimizer, mixed=mixed, comm=comm,
                     guard=guard, seed_accum=seed_accum, mesh=mesh,
                     batch_fn=batch_fn)
    local = shard_params(params, mesh)
    if comm == "pallas_ring":
        # the workspace holds a gathered layer weight
        mesh.ring(4 * params.w1[0].numel())
    if optimizer is None:
        return run_strided(step, local, seeds, mesh, on_step)
    state = (optimizer.init(local) if opt_state is None
             else to_device(opt_state, mesh.torch_device))
    local, state = run_strided(step, (local, state), seeds, mesh, on_step)
    return (local, state) if return_state else local


def _fsdp_rank(mesh: Mesh, payload):
    (params, seeds, batch_size, model_size, lr, comm, batch_fn, optimizer,
     opt_state, return_state, mixed) = payload
    if opt_state is not None:
        opt_state = shard_state(opt_state, mesh)
    out = train_fsdp(params, seeds, batch_size, model_size, mesh, lr,
                     optimizer=optimizer, opt_state=opt_state,
                     return_state=return_state, mixed=mixed, comm=comm,
                     batch_fn=batch_fn)
    return to_device(out, "cpu")
