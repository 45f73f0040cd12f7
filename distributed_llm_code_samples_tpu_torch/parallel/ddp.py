"""DDP: replicated params, strided seeds, per-layer gradient all-reduce,
as in the JAX package's ``parallel/ddp.py`` (reference ``train_ddp`` /
``train_process_ddp``, ``train_ffns.py:154-193``).

Every rank holds the whole model, takes its column of the strided seed
schedule, and reduces each layer's ``(dw1, dw2)`` the moment the
backward has made them (the reference's ``ddp_comms_hook``,
``train_ffns.py:164-165``), then runs the inline SGD with the summed
gradients and the unscaled LR. The blocks are the matmul blocks
``ops.ffn.ffn_fwd`` / ``ffn_bwd``, as in JAX.

``comm`` picks the transport of the reduction: ``"psum"`` is
``torch.distributed``'s all-reduce (NCCL on the card, gloo on the CPU),
``"pallas_ring"`` the hand-written ring kernel ``ops/ring.py::
ring_all_reduce`` (its plain ring on the CPU). The reduction runs on the
current stream, synchronously with the backward; overlapping it with
the rest of the backward is left to a later change.

Not ported yet, and refused: the stateful optimizers, token
accumulation, ``mixed``, ``guard`` and the elastic ``seed_accum``.
"""

from __future__ import annotations

from typing import Callable, Optional

from .. import LR
from ..data import batch_from_seed
from ..models.ffn_stack import FFNStackParams
from ..optim import sgd
from ..ops.ffn import ffn_bwd, ffn_fwd
from ..ops.ring import ring_all_reduce
from ..ops.stack import stack_bwd, stack_fwd
from .collectives import all_reduce, check_comm
from .launcher import (DEFAULT_TIMEOUT_S, launch_strided, refuse_unported,
                       run_strided)
from .mesh import DATA_AXIS, Mesh, require_axes


def make_step(batch_size: int, model_size: int, lr: float = LR,
              unroll: bool = True, axis: str = DATA_AXIS, optimizer=None,
              accum: int = 1, mixed: bool = False, comm: str = "psum",
              guard=None, seed_accum: int = 1, *, mesh: Mesh,
              batch_fn: Callable = batch_from_seed):
    """One DDP step ``(params, seed) -> params`` for the rank of ``mesh``
    (a rank's view): the batch from ``batch_fn``, the stack forward, the
    backward with the per-layer reduction as its ``grad_hook``, SGD in
    place. ``unroll`` changes nothing (one Python loop)."""
    refuse_unported(optimizer=(optimizer, None), accum=(accum, 1),
                    mixed=(mixed, False), guard=(guard, None),
                    seed_accum=(seed_accum, 1))
    require_axes(mesh, axis)
    check_comm(comm, mesh)
    if comm == "pallas_ring":
        reduce = lambda g: ring_all_reduce(g, mesh)   # noqa: E731
    else:
        reduce = lambda g: all_reduce(g, mesh)        # noqa: E731

    def grad_hook(dw1, dw2):      # fires per layer, train_ffns.py:164-165
        return reduce(dw1), reduce(dw2)

    def step(params: FFNStackParams, seed) -> FFNStackParams:
        x, dloss_dx = batch_fn(seed, batch_size, model_size,
                               dtype=params.w1.dtype,
                               device=params.w1.device)
        _, acts = stack_fwd(params.w1, params.w2, x, block_fwd=ffn_fwd)
        _, grads = stack_bwd(dloss_dx, params.w1, params.w2, acts,
                             block_bwd=ffn_bwd, grad_hook=grad_hook)
        return sgd(params, FFNStackParams(*grads), lr)

    return step


def train_ddp(params: FFNStackParams, seeds, batch_size: int,
              model_size: int, mesh: Mesh, lr: float = LR,
              unroll: bool = True, optimizer=None, accum: int = 1,
              opt_state=None, return_state: bool = False,
              mixed: bool = False, comm: str = "psum", guard=None,
              guard_state=None, return_guard: bool = False,
              seed_accum: int = 1, *, batch_fn: Callable = batch_from_seed,
              on_step: Optional[Callable[[int], None]] = None,
              timeout: float = DEFAULT_TIMEOUT_S) -> FFNStackParams:
    """Run the DDP schedule and return the final (replicated) params on
    the device of ``params``; the caller's params are not touched.

    ``seeds`` is the global schedule: rank r's step t takes
    ``seeds[t * n + r]``. Given the whole mesh (``make_mesh``) it launches
    the ranks (``parallel/launcher.py``); given a rank's view, inside a
    process group that exists, it runs that rank's share and returns its
    replica (``on_step(t)`` after each of its steps). ``batch_fn`` makes
    a step's batch (default ``batch_from_seed``; it must pickle to reach
    spawned ranks)."""
    refuse_unported(opt_state=(opt_state, None),
                    return_state=(return_state, False),
                    guard_state=(guard_state, None),
                    return_guard=(return_guard, False))
    require_axes(mesh, DATA_AXIS)
    check_comm(comm, mesh)
    if not mesh.in_rank:
        refuse_unported(optimizer=(optimizer, None), accum=(accum, 1),
                        mixed=(mixed, False), guard=(guard, None),
                        seed_accum=(seed_accum, 1))
        outs = launch_strided(_ddp_rank, params, seeds, mesh, batch_size,
                              model_size, lr, comm, batch_fn,
                              timeout=timeout)
        return FFNStackParams(*(t.to(params.w1.device) for t in outs[0]))
    step = make_step(batch_size, model_size, lr, unroll,
                     optimizer=optimizer, accum=accum, mixed=mixed,
                     comm=comm, guard=guard, seed_accum=seed_accum,
                     mesh=mesh, batch_fn=batch_fn)
    dev = mesh.torch_device
    local = FFNStackParams(*(t.to(dev, copy=True) for t in params))
    if comm == "pallas_ring":
        # the workspace holds the largest per-layer gradient
        mesh.ring(4 * local.w1[0].numel())
    return run_strided(step, local, seeds, mesh, on_step)


def _ddp_rank(mesh: Mesh, payload):
    params, seeds, batch_size, model_size, lr, comm, batch_fn = payload
    out = train_ddp(params, seeds, batch_size, model_size, mesh, lr,
                    comm=comm, batch_fn=batch_fn)
    return FFNStackParams(*(t.cpu() for t in out)) if mesh.rank == 0 \
        else None
