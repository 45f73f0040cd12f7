"""DDP: replicated params, strided seeds, per-layer gradient all-reduce,
as in the JAX package's ``parallel/ddp.py`` (reference ``train_ddp`` /
``train_process_ddp``, ``train_ffns.py:154-193``).

Every rank holds the whole model, takes its column of the strided seed
schedule, and reduces each layer's ``(dw1, dw2)`` the moment the
backward has made them (the reference's ``ddp_comms_hook``,
``train_ffns.py:164-165``), then runs the inline SGD with the summed
gradients and the unscaled LR. The blocks are the matmul blocks
``ops.ffn.ffn_fwd`` / ``ffn_bwd``, as in JAX; ``mixed`` swaps in the
bf16-operand blocks ``ffn_fwd_mixed`` / ``ffn_bwd_mixed`` (grads, sums
and params stay f32).

``comm`` picks the transport of the reduction: ``"psum"`` is
``torch.distributed``'s all-reduce (NCCL on the card, gloo on the CPU),
``"pallas_ring"`` the hand-written ring kernel ``ops/ring.py::
ring_all_reduce`` (its plain ring on the CPU). The reduction runs on the
current stream, synchronously with the backward; overlapping it with
the rest of the backward is left to a later change.

``optimizer`` (``optim.py``) replaces the inline SGD by a stateful rule
whose state is replicated like the params (the baseline ZeRO-1 improves
on, ``parallel/zero1.py``); ``opt_state``/``return_state`` carry it in
and out. ``accum`` sums the gradients of that many token chunks
unreduced and reduces the sum once, tree-wide.

Not ported yet, and refused: ``guard`` and the elastic ``seed_accum``.
"""

from __future__ import annotations

from typing import Callable, Optional

from .. import LR
from ..data import batch_from_seed
from ..models.ffn_stack import FFNStackParams
from ..optim import check_state_args, sgd
from ..ops.ffn import ffn_blocks
from ..ops.ring import ring_all_reduce
from ..ops.stack import accumulated_grads, stack_bwd, stack_fwd
from .collectives import all_reduce, check_comm
from .launcher import (DEFAULT_TIMEOUT_S, launch_strided, refuse_unported,
                       run_strided, to_device)
from .mesh import DATA_AXIS, Mesh, require_axes


def grads_for_batch(params: FFNStackParams, x, dy, grad_hook=None,
                    mixed: bool = False) -> FFNStackParams:
    """One forward and backward over given data: the compute DDP, ZeRO-1
    and the accumulation chunks share (JAX ``ddp.grads_for_batch``)."""
    fwd, bwd = ffn_blocks(mixed)
    _, acts = stack_fwd(params.w1, params.w2, x, block_fwd=fwd)
    _, grads = stack_bwd(dy, params.w1, params.w2, acts, block_bwd=bwd,
                         grad_hook=grad_hook)
    return FFNStackParams(*grads)


def local_grads(params: FFNStackParams, seed, batch_size: int,
                model_size: int, grad_hook=None, accum: int = 1,
                mixed: bool = False,
                batch_fn: Callable = batch_from_seed) -> FFNStackParams:
    """A rank's step gradients from its seed. With ``accum > 1`` they are
    summed over the token chunks UNREDUCED (the hook does not run): the
    caller reduces the sum once (DDP's all-reduce, ZeRO-1's
    reduce-scatter)."""
    x, dloss_dx = batch_fn(seed, batch_size, model_size,
                           dtype=params.w1.dtype, device=params.w1.device)
    if accum == 1:
        return grads_for_batch(params, x, dloss_dx, grad_hook, mixed)
    return accumulated_grads(
        lambda xc, dc: grads_for_batch(params, xc, dc, mixed=mixed),
        x, dloss_dx, accum)


def make_step(batch_size: int, model_size: int, lr: float = LR,
              unroll: bool = True, axis: str = DATA_AXIS, optimizer=None,
              accum: int = 1, mixed: bool = False, comm: str = "psum",
              guard=None, seed_accum: int = 1, *, mesh: Mesh,
              batch_fn: Callable = batch_from_seed):
    """One DDP step for the rank of ``mesh`` (a rank's view): the batch
    from ``batch_fn``, the stack forward, the backward with the per-layer
    reduction as its ``grad_hook`` (or, with ``accum > 1``, one reduction
    of the chunks' sum), then the update. Without ``optimizer`` the step
    is ``(params, seed) -> params`` with SGD in place; with one it maps
    ``((params, state), seed) -> (params, state)``. ``unroll`` changes
    nothing (one Python loop)."""
    refuse_unported(guard=(guard, None), seed_accum=(seed_accum, 1))
    require_axes(mesh, axis)
    check_comm(comm, mesh)
    if comm == "pallas_ring":
        reduce = lambda g: ring_all_reduce(g, mesh)   # noqa: E731
    else:
        reduce = lambda g: all_reduce(g, mesh)        # noqa: E731

    def grad_hook(dw1, dw2):      # fires per layer, train_ffns.py:164-165
        return reduce(dw1), reduce(dw2)

    def grads_of(params, seed) -> FFNStackParams:
        if accum == 1:
            return local_grads(params, seed, batch_size, model_size,
                               grad_hook, mixed=mixed, batch_fn=batch_fn)
        total = local_grads(params, seed, batch_size, model_size,
                            accum=accum, mixed=mixed, batch_fn=batch_fn)
        return FFNStackParams(*map(reduce, total))   # one tree-wide sum

    def step(params: FFNStackParams, seed) -> FFNStackParams:
        return sgd(params, grads_of(params, seed), lr)

    def step_opt(carry, seed):
        params, state = carry
        return optimizer.update(grads_of(params, seed), state, params, lr,
                                mesh=mesh)

    return step if optimizer is None else step_opt


def train_ddp(params: FFNStackParams, seeds, batch_size: int,
              model_size: int, mesh: Mesh, lr: float = LR,
              unroll: bool = True, optimizer=None, accum: int = 1,
              opt_state=None, return_state: bool = False,
              mixed: bool = False, comm: str = "psum", guard=None,
              guard_state=None, return_guard: bool = False,
              seed_accum: int = 1, *, batch_fn: Callable = batch_from_seed,
              on_step: Optional[Callable[[int], None]] = None,
              timeout: float = DEFAULT_TIMEOUT_S):
    """Run the DDP schedule and return the final (replicated) params on
    the device of ``params``; the caller's params are not touched. With
    ``return_state`` it returns ``(params, opt_state)``: the optimizer's
    replicated state (rank 0's), which ``opt_state`` takes back to
    resume (``optimizer.init(params)`` when it is None).

    ``seeds`` is the global schedule: rank r's step t takes
    ``seeds[t * n + r]``. Given the whole mesh (``make_mesh``) it launches
    the ranks (``parallel/launcher.py``); given a rank's view, inside a
    process group that exists, it runs that rank's share and returns its
    replica (``on_step(t)`` after each of its steps). ``batch_fn`` makes
    a step's batch (default ``batch_from_seed``; it must pickle to reach
    spawned ranks, as must ``optimizer``)."""
    refuse_unported(guard_state=(guard_state, None),
                    return_guard=(return_guard, False))
    require_axes(mesh, DATA_AXIS)
    check_comm(comm, mesh)
    check_state_args(optimizer, opt_state, return_state)
    if not mesh.in_rank:
        refuse_unported(guard=(guard, None), seed_accum=(seed_accum, 1))
        outs = launch_strided(
            _ddp_rank, params, seeds, mesh, batch_size, model_size, lr,
            comm, batch_fn, optimizer, to_device(opt_state, "cpu"),
            return_state, accum, mixed, timeout=timeout)
        return to_device(outs[0], params.w1.device)
    step = make_step(batch_size, model_size, lr, unroll,
                     optimizer=optimizer, accum=accum, mixed=mixed,
                     comm=comm, guard=guard, seed_accum=seed_accum,
                     mesh=mesh, batch_fn=batch_fn)
    dev = mesh.torch_device
    local = FFNStackParams(*(t.to(dev, copy=True) for t in params))
    if comm == "pallas_ring":
        # the workspace holds the largest gradient reduced at once: a
        # layer's, or with accumulation a whole stacked leaf
        mesh.ring(4 * (local.w1 if accum > 1 else local.w1[0]).numel())
    if optimizer is None:
        return run_strided(step, local, seeds, mesh, on_step)
    state = (optimizer.init(local) if opt_state is None
             else to_device(opt_state, dev))
    local, state = run_strided(step, (local, state), seeds, mesh, on_step)
    return (local, state) if return_state else local


def _ddp_rank(mesh: Mesh, payload):
    (params, seeds, batch_size, model_size, lr, comm, batch_fn, optimizer,
     opt_state, return_state, accum, mixed) = payload
    out = train_ddp(params, seeds, batch_size, model_size, mesh, lr,
                    optimizer=optimizer, accum=accum, opt_state=opt_state,
                    return_state=return_state, mixed=mixed, comm=comm,
                    batch_fn=batch_fn)
    return to_device(out, "cpu") if mesh.rank == 0 else None
