"""ZeRO-1: DDP with the optimizer state sharded across the data axis, as
in the JAX package's ``parallel/zero1.py``.

- params stay replicated (DDP's layout); each rank computes the
  gradients of its own seed column;
- the gradients are reduce-scattered along the layer axis (SUM): rank r
  ends with the summed gradients of its ``L/n`` layers only;
- each rank updates its ``L/n``-layer slice of the params with its own
  shard of the optimizer state, the only place the state exists;
- the updated slices are all-gathered back to the replicated params.

Per step one reduce-scatter and one all-gather a param tensor against
DDP's all-reduce: the same bytes on a ring. The unit of the partition is
the whole layer (the leading axis of the stacked params), so ``L % n ==
0``. The collectives are ``parallel/collectives.py``'s (NCCL on the card,
gloo on the CPU, plain torch in loopback), as JAX's are ``lax``'s: the
JAX CLI refuses ``--comm pallas_ring`` with ``--zero1``, and so does the
port's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import batch_from_seed
from ..models.ffn_stack import FFNStackParams
from ..optim import adam, tree_map
from .collectives import all_gather, axis_index, reduce_scatter
from .ddp import local_grads
from .launcher import (DEFAULT_TIMEOUT_S, launch_strided, run_strided,
                       to_device)
from .mesh import DATA_AXIS, Mesh, require_axes


def _layers(t: torch.Tensor) -> bool:
    """Whether a state leaf is stacked by layers (``[L, out, in]``, split
    with the layers) rather than bookkeeping (a step count)."""
    return t.dim() == 3


def shard_state(state, mesh: Mesh):
    """The rank of ``mesh``'s ``L/n`` layers of a full optimizer state, on
    its device (the step count copied)."""
    n, r = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    return tree_map(lambda t: (t.chunk(n, 0)[r] if _layers(t) else t)
                    .to(mesh.torch_device, copy=True).contiguous(), state)


def unshard_state(states):
    """The full optimizer state from every rank's shard, in rank order."""
    return tree_map(lambda *ts: torch.cat(ts, 0) if _layers(ts[0])
                    else ts[0], *states)


def make_step(batch_size: int, model_size: int, n_shards: int,
              lr: float = LR, unroll: bool = True, axis: str = DATA_AXIS,
              optimizer=None, accum: int = 1, mixed: bool = False, *,
              mesh: Mesh, batch_fn: Callable = batch_from_seed):
    """One ZeRO-1 step for the rank of ``mesh``: ``((params, state), seed)
    -> (params, state)`` with ``state`` covering this rank's layers only.
    ``accum`` sums the local gradients of that many token chunks before
    the one reduce-scatter. Returns ``(step, shard_of, opt)``:
    ``shard_of`` takes this rank's ``L/n``-layer slice of a stacked
    container."""
    opt = adam() if optimizer is None else optimizer

    def shard_of(tree):
        r = axis_index(mesh, axis)
        return tree_map(lambda a: a[r * (a.shape[0] // n_shards):
                                    (r + 1) * (a.shape[0] // n_shards)],
                        tree)

    def step(carry, seed):
        params, state = carry
        grads = local_grads(params, seed, batch_size, model_size,
                            accum=accum, mixed=mixed, batch_fn=batch_fn)
        # the sum and the partition in one collective: rank r receives the
        # summed gradients of its own layers (train_ffns.py:165's SUM)
        gshard = FFNStackParams(*(reduce_scatter(g, mesh, dim=0, axis=axis)
                                  for g in grads))
        pshard, state = opt.update(gshard, state, shard_of(params), lr,
                                   mesh=mesh)
        params = FFNStackParams(*(all_gather(p, mesh, dim=0, axis=axis)
                                  for p in pshard))
        return params, state

    return step, shard_of, opt


def train_ddp_zero1(params: FFNStackParams, seeds, batch_size: int,
                    model_size: int, mesh: Mesh, lr: float = LR,
                    unroll: bool = True, optimizer=None, accum: int = 1,
                    mixed: bool = False, opt_state=None,
                    return_state: bool = False, *,
                    batch_fn: Callable = batch_from_seed,
                    on_step: Optional[Callable[[int], None]] = None,
                    timeout: float = DEFAULT_TIMEOUT_S):
    """Run the ZeRO-1 schedule; returns the (replicated) final params on
    the device of ``params``. ``optimizer`` defaults to ``optim.adam()``,
    the state-heavy case ZeRO-1 exists for. The data split is DDP's
    (strided seed columns), so ``train_ddp_zero1(optimizer=o) ==
    train_ddp(optimizer=o)`` leaf for leaf.

    Given the whole mesh it launches the ranks; ``return_state`` then
    returns ``(params, opt_state)`` with the full state re-assembled from
    the ranks' shards (``unshard_state``), which ``opt_state`` takes back
    and shards again. Given a rank's view it runs that rank and returns
    its params (and with ``return_state`` its own state shard;
    ``opt_state`` is that shard)."""
    require_axes(mesh, DATA_AXIS)
    n = mesh.axis_size(DATA_AXIS)
    n_layers = params.w1.shape[0]
    if n_layers % n:
        raise ValueError(
            f"{n_layers} layers not divisible across {n} ranks: ZeRO-1 "
            "partitions optimizer state in whole-layer units")
    if not mesh.in_rank:
        outs = launch_strided(
            _zero1_rank, params, seeds, mesh, batch_size, model_size, lr,
            batch_fn, optimizer, to_device(opt_state, "cpu"), return_state,
            accum, mixed, timeout=timeout)
        dev = params.w1.device
        if not return_state:
            return to_device(outs[0], dev)
        return (to_device(outs[0][0], dev),
                to_device(unshard_state([o[1] for o in outs]), dev))
    step, shard_of, opt = make_step(batch_size, model_size, n, lr, unroll,
                                    optimizer=optimizer, accum=accum,
                                    mixed=mixed, mesh=mesh,
                                    batch_fn=batch_fn)
    dev = mesh.torch_device
    local = FFNStackParams(*(t.to(dev, copy=True) for t in params))
    state = (opt.init(shard_of(local)) if opt_state is None
             else to_device(opt_state, dev))
    local, state = run_strided(step, (local, state), seeds, mesh, on_step)
    return (local, state) if return_state else local


def _zero1_rank(mesh: Mesh, payload):
    (params, seeds, batch_size, model_size, lr, batch_fn, optimizer,
     opt_state, return_state, accum, mixed) = payload
    out = train_ddp_zero1(
        params, seeds, batch_size, model_size, mesh, lr,
        optimizer=optimizer, accum=accum, mixed=mixed,
        opt_state=None if opt_state is None else shard_state(opt_state,
                                                             mesh),
        return_state=return_state, batch_fn=batch_fn)
    if return_state:
        return (to_device(out[0], "cpu") if mesh.rank == 0 else None,
                to_device(out[1], "cpu"))
    return to_device(out, "cpu") if mesh.rank == 0 else None
