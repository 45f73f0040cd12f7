"""Expert parallelism (EP) of the MoE FFN stack, as in the JAX package's
``parallel/expert.py``.

Layout (GShard, data group == expert group): each rank of the
``EXPERT_AXIS`` mesh routes its own ``T/n`` tokens; the ``E`` experts'
FFN weights are split over the same ranks (rank r holds experts
``[r E/n, (r+1) E/n)``, ``shard_params``); the router is replicated. Per
layer:

- each rank routes locally and builds its ``[E, C, d]`` slot block
  (``dispatch`` ``"dense"``, ``"scatter"`` or ``"gather"``, the forms of
  ``ops/moe.py``);
- an all-to-all (split experts, concat capacity) carries every rank's
  slots for expert e to e's owner;
- the local experts run the FFN on their ``[E/n, n*C, d]`` slots;
- the reverse all-to-all brings the results home, and the gate-scaled
  combine finishes the layer; the step adds the residual.

Capacity comes from the global token count and splits evenly over the
source ranks (``C = ceil(C_global / n)``, ``_local_capacity``), so drops
are grouped: a rank that routes many tokens to one expert drops locally
even if another rank left slots free. ``train_moe_dense(n_groups=n)`` is
the single-device oracle with the same semantics.

Gradients: an expert's are complete on its owner (every token routed to
it arrives there); the router's are per-rank partial sums, summed over
the ranks with SUM semantics (``collectives.all_reduce``, as JAX's
``lax.psum``, under either transport); the Switch aux loss is scored per
rank on its own tokens.

``comm`` picks the exchange: ``"psum"`` is ``torch.distributed``'s
``all_to_all_single`` (``collectives.all_to_all``: NCCL, gloo on the
CPU), ``"pallas_a2a"`` the hand-written all-to-all kernel
(``ops/ring.py::all_to_all_dma``; its plain version on the CPU).

The backward is split at the exchanges and runs them from the rank's
own thread: per layer, backward through the combine, the return
exchange's transpose, the experts' hand VJP (``ffn_bwd``), the dispatch
exchange's transpose, then backward through routing and dispatch.
Autograd runs only inside those two segments, which hold no collective:
PyTorch runs every CUDA backward on one thread per card, so a loopback
rank that blocked there in an exchange would stop the other ranks' (and
with them its own) exchange.

Not ported, and refused: the 2-D data x expert mesh (``data_axis``;
``make_mesh`` refuses the mesh itself).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import batch_from_seed, shard_seeds_strided
from ..models.moe import MoEStackParams, clone_moe
from ..ops import moe as moe_ops
from ..ops.ffn import ffn_bwd, ffn_fwd
from ..ops.ring import tiled_all_to_all
from ..optim import sgd
from .collectives import all_reduce, all_to_all, check_comm
from .launcher import (DEFAULT_TIMEOUT_S, launch_strided, refuse_unported,
                       run_strided)
from .mesh import EXPERT_AXIS, Mesh, require_axes

COMMS = ("psum", "pallas_a2a")
# the expert dim of the stacked w1 [L, E, ffn, d] and w2 [L, E, d, ffn]
SHARD_DIM = 1


def _local_capacity(t_local: int, n_shards: int, n_experts: int,
                    capacity_factor: float) -> int:
    """This rank's share of the global per-expert capacity: from the
    global token count, then ceil-split over the source ranks."""
    cap_global = moe_ops.expert_capacity(t_local * n_shards, n_experts,
                                         capacity_factor)
    return max(1, -(-cap_global // n_shards))


def _exchange(comm: str, mesh: Mesh) -> Callable:
    """``(x, split_dim, concat_dim) -> tiled all-to-all`` on ``comm``."""
    if comm == "pallas_a2a":
        return lambda t, sd, cd: tiled_all_to_all(t, mesh, sd, cd)
    return lambda t, sd, cd: all_to_all(t, mesh, split_dim=sd, concat_dim=cd)


def _dispatch(dispatch: str, wg, x, n_experts: int, cap: int, k: int):
    """Routing and dispatch of one rank's tokens: ``(xe [E, cap, d],
    combine)``, ``combine(ye) -> y [T, d]`` the matching combine."""
    t = x.shape[0]
    if dispatch == "scatter":
        idx_flat, gates = moe_ops.route_flat(wg, x, k)
        xe, dest, keep = moe_ops.scatter_dispatch(idx_flat, x, n_experts,
                                                  cap)
        return xe, lambda ye: moe_ops.scatter_combine(ye, dest, keep, gates,
                                                      t)
    if dispatch == "gather":
        idx_flat, gates = moe_ops.route_flat(wg, x, k)
        dest, slot_tok, slot_choice, keep = moe_ops.gather_metadata(
            idx_flat, t, n_experts, cap)
        xe = moe_ops.permute_to_slots(x, dest, slot_tok).reshape(
            n_experts, cap, -1)
        return xe, lambda ye: moe_ops.combine_from_slots(
            ye, gates, dest, slot_tok, slot_choice, keep)
    if dispatch != "dense":
        raise ValueError(f"unknown dispatch {dispatch!r}")
    disp, comb = moe_ops.dense_dispatch(wg, x, n_experts, cap, k)
    xe = torch.einsum("tec,td->ecd", disp, x)
    return xe, lambda ye: torch.einsum("tec,ecd->td", comb, ye)


class _Layer:
    """One EP layer of one rank, split at its two exchanges (see the
    module docstring): ``forward`` returns the layer's output (no
    residual), ``backward`` its gradients."""

    def __init__(self, exchange: Callable, n: int, capacity_factor: float,
                 k: int, dispatch: str):
        self.exchange, self.n, self.k = exchange, n, k
        self.capacity_factor, self.dispatch = capacity_factor, dispatch
        self.saved = None

    def forward(self, wg, w1, w2, x):
        cap = _local_capacity(x.shape[0], self.n, wg.shape[0],
                              self.capacity_factor)
        wg = wg.detach().requires_grad_()
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            aux = moe_ops.router_aux_loss(wg, x)
            xe, combine = _dispatch(self.dispatch, wg, x, wg.shape[0], cap,
                                    self.k)
        # experts -> their owners; the slots of all ranks stack on capacity
        xr = self.exchange(xe.detach(), 0, 1)              # [E/n, n*C, d]
        yr = torch.stack([ffn_fwd(a, b, v) for a, b, v in
                          zip(w1.unbind(0), w2.unbind(0), xr.unbind(0))])
        # the results return to their tokens' ranks
        ye = self.exchange(yr, 1, 0).requires_grad_()      # [E, C, d]
        with torch.enable_grad():
            y = combine(ye)
        self.saved = (wg, x, aux, xe, xr, ye, y)
        return y.detach()

    def backward(self, dy, coef, w1, w2):
        """``(dwg, dw1, dw2, dx)`` for the cotangent ``dy`` of the output
        and ``coef`` of the aux loss; ``dwg`` is this rank's part."""
        wg, x, aux, xe, xr, ye, y = self.saved
        self.saved = None
        dye, = torch.autograd.grad(y, ye, dy, retain_graph=True)
        dyr = self.exchange(dye, 0, 1)
        dxr, dw1, dw2 = [], [], []
        for a, b, v, g in zip(w1.unbind(0), w2.unbind(0), xr.unbind(0),
                              dyr.unbind(0)):
            dv, (da, db) = ffn_bwd(g, a, b, v)
            dxr.append(dv)
            dw1.append(da)
            dw2.append(db)
        dxe = self.exchange(torch.stack(dxr), 1, 0)
        dwg, dx = torch.autograd.grad((y, xe, aux), (wg, x), (dy, dxe, coef))
        return dwg, torch.stack(dw1), torch.stack(dw2), dx


def moe_layer_ep(wg, w1_local, w2_local, x, capacity_factor: float = 2.0,
                 axis: str = EXPERT_AXIS, k: int = 1, dispatch: str = "dense",
                 comm: str = "psum", *, mesh: Mesh) -> torch.Tensor:
    """One EP layer's forward on the rank of ``mesh`` (a rank's view), no
    residual: ``wg [E, d]`` (replicated), ``w1_local [E/n, ffn, d]``,
    ``w2_local [E/n, d, ffn]``, ``x [T_local, d]``. The trainer takes its
    backward from the same split (``make_grads``)."""
    require_axes(mesh, axis)
    check_comm(comm, mesh, COMMS)
    return _Layer(_exchange(comm, mesh), mesh.size, capacity_factor, k,
                  dispatch).forward(wg, w1_local, w2_local, x)


def make_grads(batch_size: int, model_size: int,
               capacity_factor: float = 2.0, axis: str = EXPERT_AXIS,
               k: int = 1, aux_coef: float = 0.0, data_axis=None,
               dispatch: str = "dense", comm: str = "psum", *, mesh: Mesh,
               batch_fn: Callable = batch_from_seed):
    """``(local params, seed) -> gradients`` of one EP step for the rank of
    ``mesh``: the batch of ``batch_size`` tokens (this rank's), the
    forward with a residual around each layer, the backward with the aux
    term at ``aux_coef``, the router gradients summed over the ranks."""
    refuse_unported(data_axis=(data_axis, None))
    require_axes(mesh, axis)
    check_comm(comm, mesh, COMMS)
    exchange = _exchange(comm, mesh)

    def grads(params: MoEStackParams, seed) -> MoEStackParams:
        x, dloss_dx = batch_fn(seed, batch_size, model_size,
                               dtype=params.w1.dtype, device=params.w1.device)
        layers = []
        for l in range(params.n_layers):
            layers.append(_Layer(exchange, mesh.size, capacity_factor, k,
                                 dispatch))
            x = x + layers[-1].forward(params.wg[l], params.w1[l],
                                       params.w2[l], x)
        coef = torch.tensor(aux_coef, dtype=x.dtype, device=x.device)
        dx, out = dloss_dx, [None] * params.n_layers
        for l in reversed(range(params.n_layers)):
            dwg, dw1, dw2, dxl = layers[l].backward(dx, coef, params.w1[l],
                                                    params.w2[l])
            out[l] = (dwg, dw1, dw2)
            dx = dx + dxl
        dwg, dw1, dw2 = (torch.stack(t) for t in zip(*out))
        return MoEStackParams(all_reduce(dwg, mesh), dw1, dw2)

    return grads


def make_step(batch_size: int, model_size: int, lr: float = LR,
              capacity_factor: float = 2.0, axis: str = EXPERT_AXIS,
              k: int = 1, aux_coef: float = 0.0, data_axis=None,
              dispatch: str = "dense", comm: str = "psum", *, mesh: Mesh,
              batch_fn: Callable = batch_from_seed):
    """One EP step ``(local params, seed) -> local params`` for the rank of
    ``mesh``: ``make_grads``, then SGD in place."""
    grads = make_grads(batch_size, model_size, capacity_factor, axis, k,
                       aux_coef, data_axis, dispatch, comm, mesh=mesh,
                       batch_fn=batch_fn)
    return lambda params, seed: sgd(params, grads(params, seed), lr)


def shard_params(params: MoEStackParams, mesh: Mesh) -> MoEStackParams:
    """The rank's part, fresh and contiguous on its device: the whole
    router, and experts ``[r E/n, (r+1) E/n)`` of every layer."""
    e = params.n_experts // mesh.size
    lo, dev = mesh.rank * e, mesh.torch_device
    return MoEStackParams(
        params.wg.to(dev, copy=True),
        *(t[:, lo:lo + e].to(dev, copy=True).contiguous()
          for t in (params.w1, params.w2)))


def unshard_params(shards) -> MoEStackParams:
    """The full params from every rank's part, in rank order (the router
    is the same on every rank)."""
    shards = list(shards)
    return MoEStackParams(shards[0].wg,
                          *(torch.cat([s[i] for s in shards], SHARD_DIM)
                            for i in (1, 2)))


def a2a_bytes(params: MoEStackParams, batch_size: int, n: int,
              capacity_factor: float) -> int:
    """Bytes of each exchange's operand, ``[E, C, d]`` f32, for the
    workspace of ``comm="pallas_a2a"`` (``batch_size`` a rank's)."""
    cap = _local_capacity(batch_size, n, params.n_experts, capacity_factor)
    return 4 * params.n_experts * cap * params.d_model


def _check(params: MoEStackParams, batch_size: int, n: int,
           dispatch: str) -> None:
    if params.n_experts % n:
        raise ValueError(f"n_experts={params.n_experts} not divisible by "
                         f"expert-axis size {n}")
    if batch_size % n:
        raise ValueError(f"batch_size={batch_size} not divisible by "
                         f"expert-axis size {n}")
    if dispatch not in moe_ops.LAYERS:
        raise ValueError(f"unknown dispatch {dispatch!r}")


def train_moe_ep(params: MoEStackParams, seeds, batch_size: int,
                 model_size: int, mesh: Mesh, lr: float = LR,
                 capacity_factor: float = 2.0, k: int = 1,
                 aux_coef: float = 0.0, dispatch: str = "dense",
                 comm: str = "psum", *, batch_fn: Callable = batch_from_seed,
                 on_step: Optional[Callable[[int], None]] = None,
                 timeout: float = DEFAULT_TIMEOUT_S) -> MoEStackParams:
    """Run the EP schedule. ``batch_size`` is the global token count of
    the EP group a step; each rank routes ``batch_size / n``. Seeds split
    stride-wise (rank r's step t takes ``seeds[t * n + r]``).

    Given the whole mesh it launches the ranks and returns the full final
    params on the device of ``params``; given a rank's view, inside a
    process group that exists, it runs that rank's share and returns its
    part (``unshard_params`` joins every rank's). ``on_step(t)`` runs
    after each of the rank's steps. The caller's params are not
    touched."""
    require_axes(mesh, EXPERT_AXIS)
    check_comm(comm, mesh, COMMS)
    n = mesh.size
    _check(params, batch_size, n, dispatch)
    if not mesh.in_rank:
        shards = launch_strided(_ep_rank, params, seeds, mesh, batch_size,
                                model_size, lr, capacity_factor, k, aux_coef,
                                dispatch, comm, batch_fn, timeout=timeout)
        out = unshard_params(shards)
        return MoEStackParams(*(t.to(params.w1.device) for t in out))
    step = make_step(batch_size // n, model_size, lr, capacity_factor, k=k,
                     aux_coef=aux_coef, dispatch=dispatch, comm=comm,
                     mesh=mesh, batch_fn=batch_fn)
    local = shard_params(params, mesh)
    if comm == "pallas_a2a":
        mesh.ring(a2a_bytes(params, batch_size // n, n, capacity_factor),
                  probe=False)
    return run_strided(step, local, seeds, mesh, on_step)


def _ep_rank(mesh: Mesh, payload):
    (params, seeds, batch_size, model_size, lr, capacity_factor, k, aux_coef,
     dispatch, comm, batch_fn) = payload
    out = train_moe_ep(params, seeds, batch_size, model_size, mesh, lr,
                       capacity_factor, k, aux_coef, dispatch, comm,
                       batch_fn=batch_fn)
    return MoEStackParams(*(t.cpu() for t in out))


def dense_grads(params: MoEStackParams, batches, capacity_factor: float,
                k: int, aux_coef: float, capacity: int,
                dispatch: str = "dense") -> MoEStackParams:
    """One step's gradients of the dense MoE stack over groups of tokens:
    each ``(x, dloss_dx)`` of ``batches`` routed on its own at
    ``capacity``, the aux terms at ``aux_coef``, all summed."""
    leaves = [t.detach().requires_grad_() for t in params]
    p = MoEStackParams(*leaves)
    outs, cots, aux = [], [], 0
    with torch.enable_grad():
        for x, dloss_dx in batches:
            y, a = moe_ops.moe_stack_fwd_aux(p, x, capacity_factor, k,
                                             capacity, dispatch)
            outs.append(y)
            cots.append(dloss_dx)
            aux = aux + a
        coef = torch.tensor(aux_coef, dtype=aux.dtype, device=aux.device)
        return MoEStackParams(*torch.autograd.grad(outs + [aux], leaves,
                                                   cots + [coef]))


def train_moe_dense(params: MoEStackParams, seeds, batch_size: int,
                    model_size: int, lr: float = LR,
                    capacity_factor: float = 2.0, k: int = 1,
                    aux_coef: float = 0.0, n_groups: int = 1,
                    capacity_groups: Optional[int] = None,
                    dispatch: str = "dense", *,
                    batch_fn: Callable = batch_from_seed,
                    on_step: Optional[Callable[[int], None]] = None
                    ) -> MoEStackParams:
    """The single-device dense MoE trainer with EP's semantics, the oracle
    of ``train_moe_ep``, on the device of ``params``. ``n_groups=1`` is
    plain dense MoE training; ``n_groups=n`` is the n-rank EP run
    exactly: the strided seed split, each group's ``batch_size / n``
    tokens routed on their own at the ``ceil(C_global / n)`` share, per
    group aux terms, router gradients summed over the groups.
    ``capacity_groups`` overrides the group count the capacity splits
    over. The caller's params are not touched."""
    if batch_size % n_groups:
        raise ValueError(f"batch_size={batch_size} not divisible by "
                         f"n_groups={n_groups}")
    t_local = batch_size // n_groups
    cap = _local_capacity(t_local,
                          capacity_groups if capacity_groups is not None
                          else n_groups,
                          params.n_experts, capacity_factor)
    p = clone_moe(params)
    for t, row in enumerate(shard_seeds_strided(seeds, n_groups)):
        batches = [batch_fn(int(s), t_local, model_size, dtype=p.w1.dtype,
                            device=p.w1.device) for s in row]
        sgd(p, dense_grads(p, batches, capacity_factor, k, aux_coef, cap,
                           dispatch), lr)
        if on_step is not None:
            on_step(t)
    return p
