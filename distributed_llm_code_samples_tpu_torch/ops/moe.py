"""MoE routing, dispatch and combine, as in the JAX package's
``ops/moe.py``: the single-device oracle of expert parallelism.

The router is top-k (k=1 Switch-style, k=2 GShard-style) with a static
capacity per expert. Tokens that overflow an expert's capacity are
dropped from its computation; the stack's residual carries them on
unchanged (``moe_stack_fwd_aux``), and ``moe_layer`` itself emits zeros
for them. With k=2 every token's first choice claims its slot before any
token's second choice (choice-major priority, the GShard order).

Three forms move the tokens, with the same routing, capacity and
priority:

- ``moe_layer``: dense one-hot dispatch and combine tensors ``[T, E, C]``
  contracted with ``einsum``;
- ``moe_layer_scatter``: rows added into the ``[E*C, d]`` slot buffer
  (``index_add``) and gathered back; dropped choices land in spare rows
  that are cut off. Each kept slot receives exactly one row, and each
  token's gradient row at most k = 2, so the result does not depend on
  the order of the adds;
- ``moe_layer_gather``: gathers both ways (``permute_to_slots``,
  ``combine_from_slots``, ``autograd.Function``s whose backward is a
  gather too, JAX's ``_pts_bwd`` and ``_cfs_bwd``).

Slot positions are counted exactly, in integers, and no op waits for the
card (no boolean-mask indexing: dropped entries go to spare places that
are cut off). Ties in the top-k go to
the lower expert index, as ``lax.top_k`` breaks them (``torch.topk``
makes no promise), and ``argmax`` takes the first maximum in both
frameworks. The router's softmax and the top-k gates' renormalisation
take JAX's steps and the transposes of JAX's differentiation rules
(``softmax``, ``_Renormalize``): on bf16 each op rounds where JAX's does,
where ``torch.softmax`` and autograd's division would round elsewhere.
The expert FFNs run the hand-VJP ``ops.ffn.ffn_block`` once per expert
(JAX vmaps it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ffn import ffn_block


def expert_capacity(tokens: int, n_experts: int,
                    capacity_factor: float = 2.0) -> int:
    """Static per-expert slot count: ``ceil(tokens/E * factor)``."""
    return max(1, int(math.ceil(tokens / n_experts * capacity_factor)))


def _sum_in_order(z: torch.Tensor) -> torch.Tensor:
    """``z``'s sum over its last dim, one add at a time in index order,
    each rounded to ``z``'s dtype: XLA's reduction of a bf16 cotangent on
    the CPU (the transposes of JAX's rules below), where ``torch.sum``
    would add in f32 and round once."""
    acc = z[..., :1]
    for k in range(1, z.shape[-1]):
        acc = acc + z[..., k:k + 1]
    return acc


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` over the last dim: ``e = exp(x - max)`` over its
    sum ``w``, each op in the operand's dtype; the backward is JAX's
    transpose of that division and exp, ``(g / w - sum(g w^-2 e)) e``."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        w = e.sum(dim=-1, keepdim=True)
        ctx.save_for_backward(e, w)
        return e / w

    @staticmethod
    def backward(ctx, g):
        e, w = ctx.saved_tensors
        return (g / w - _sum_in_order(g * (1 / (w * w)) * e)) * e


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """The router's softmax over experts (``_Softmax``)."""
    return _Softmax.apply(logits)


class _Renormalize(torch.autograd.Function):
    """The top-k gates over their sum, JAX's ``g / jnp.sum(g)`` and its
    transpose, ``c / s - sum(c s^-2 g)``."""

    @staticmethod
    def forward(ctx, gates):
        total = gates.sum(dim=-1, keepdim=True)
        ctx.save_for_backward(gates, total)
        return gates / total

    @staticmethod
    def backward(ctx, c):
        gates, total = ctx.saved_tensors
        return c / total - _sum_in_order(c * (1 / (total * total)) * gates)


def route_top1(wg: torch.Tensor, x: torch.Tensor):
    """Top-1 router. ``wg [E, d]``, ``x [T, d]`` -> ``(idx [T], gate [T])``,
    ``gate`` the chosen expert's softmax probability (the differentiable
    path to the router)."""
    logits = x @ wg.T
    probs = softmax(logits)
    idx = torch.argmax(logits, dim=-1)
    return idx, probs.gather(-1, idx[:, None])[:, 0]


def route_topk(wg: torch.Tensor, x: torch.Tensor, k: int = 2,
               renormalize: bool = True):
    """Top-k router: ``(idx [T, k], gates [T, k])``, the k distinct experts
    of largest logit, a tie to the lower index (a stable descending sort,
    ``lax.top_k``'s order); with ``renormalize`` the k gates sum to 1."""
    logits = x @ wg.T
    probs = softmax(logits)
    idx = torch.sort(logits.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    gates = probs.gather(-1, idx)
    if renormalize:
        gates = _Renormalize.apply(gates)
    return idx, gates


def _slot_positions(idx_flat: torch.Tensor, n_experts: int, capacity: int):
    """Each flat choice's position within its expert (first come, first
    served in flat order) and the capacity keep-mask: ``(pos [N] int64,
    keep [N] bool)``. The running count is a scan along the last dim of an
    ``[E, N]`` one-hot (a scan down the first dim of ``[N, E]`` runs on
    few threads of the card)."""
    experts = torch.arange(n_experts, device=idx_flat.device)
    onehot = (idx_flat[None, :] == experts[:, None]).long()
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(0)
    return pos, pos < capacity


def dispatch_tensor(idx: torch.Tensor, n_experts: int, capacity: int,
                    dtype=torch.float32) -> torch.Tensor:
    """One-hot dispatch ``D [T, E, C]``: ``D[t, e, c] = 1`` iff token ``t``
    is the ``c``-th token routed to expert ``e``; rows of dropped tokens
    are zero. (Dropped tokens mark a spare column ``C`` that is cut off:
    no boolean mask, so nothing waits for the card.)"""
    pos, _ = _slot_positions(idx, n_experts, capacity)
    out = torch.zeros(idx.shape[0], n_experts, capacity + 1, dtype=dtype,
                      device=idx.device)
    t = torch.arange(idx.shape[0], device=idx.device)
    out[t, idx, pos.clamp(max=capacity)] = 1
    return out[:, :, :capacity]


def dispatch_tensor_topk(idx: torch.Tensor, n_experts: int, capacity: int,
                         dtype=torch.float32) -> torch.Tensor:
    """Top-k dispatch ``D [k, T, E, C]`` with choice-major priority;
    ``idx [T, k]``. Summed over k it is the ``[T, E, C]`` dispatch (a
    token's k choices are distinct experts)."""
    t, k = idx.shape
    disp = dispatch_tensor(idx.T.reshape(-1), n_experts, capacity, dtype)
    return disp.reshape(k, t, n_experts, capacity)


def route_flat(wg: torch.Tensor, x: torch.Tensor, k: int):
    """Routing in the flat choice-major layout of the scatter and gather
    forms: ``(idx_flat [k*T], gates [T, k])``."""
    if k == 1:
        idx, gates = route_top1(wg, x)
        return idx, gates[:, None]
    idx2, gates = route_topk(wg, x, k)
    return idx2.T.reshape(-1), gates


def _dest(idx_flat, pos, keep, n_experts: int, capacity: int):
    return torch.where(keep, idx_flat * capacity + pos,
                       torch.full_like(idx_flat, n_experts * capacity))


def scatter_dispatch(idx_flat: torch.Tensor, x: torch.Tensor,
                     n_experts: int, capacity: int):
    """Tokens into the ``[E, C, d]`` slot buffer by rows added at their
    slot. Returns ``(xe, dest [N], keep [N])`` for ``scatter_combine``,
    ``dest`` the dummy slot ``E*C`` where a choice was dropped. (Here each
    dropped choice lands in a spare row of its own, cut off, so that no
    row takes many adds.)"""
    t, d = x.shape
    n = idx_flat.shape[0]
    pos, keep = _slot_positions(idx_flat, n_experts, capacity)
    dest = _dest(idx_flat, pos, keep, n_experts, capacity)
    slots = n_experts * capacity
    spare = torch.arange(slots, slots + n, device=x.device)
    tok = torch.arange(t, device=x.device).repeat(n // t)
    xe = torch.zeros(slots + n, d, dtype=x.dtype, device=x.device).index_add(
        0, torch.where(keep, dest, spare), x[tok])
    return xe[:slots].reshape(n_experts, capacity, d), dest, keep


def _combine_gather(ye_flat, dest, keep, gates, t: int):
    """Gather each choice's slot row, scale by its gate, sum over the
    choices: ``(y [t, d], y_choice [N, d])``."""
    d = ye_flat.shape[-1]
    padded = torch.cat([ye_flat, ye_flat.new_zeros(1, d)])
    y_choice = padded[dest] * keep[:, None].to(ye_flat.dtype)
    y = torch.einsum("ktd,tk->td", y_choice.reshape(-1, t, d),
                     gates.to(ye_flat.dtype))
    return y, y_choice


def scatter_combine(ye: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
                    gates: torch.Tensor, t: int) -> torch.Tensor:
    """Expert outputs back to their tokens, gate-scaled: ``ye [E, C, d]``
    -> ``[t, d]`` (dropped choices add zero)."""
    return _combine_gather(ye.reshape(-1, ye.shape[-1]), dest, keep, gates,
                           t)[0]


def gather_metadata(idx_flat: torch.Tensor, t: int, n_experts: int,
                    capacity: int):
    """Routing bookkeeping of the gather form: ``dest [N]`` (each flat
    choice's slot, ``E*C`` when dropped), ``slot_tok [E*C]`` (the token in
    each slot, ``t`` when empty), ``slot_choice [E*C]`` (the flat choice
    in each slot, ``N`` when empty), ``keep [N]``."""
    n = idx_flat.shape[0]
    dev = idx_flat.device
    pos, keep = _slot_positions(idx_flat, n_experts, capacity)
    dest = _dest(idx_flat, pos, keep, n_experts, capacity)
    slots = n_experts * capacity
    # every kept slot is set once; each dropped choice sets a spare entry
    # of its own, cut off
    at = torch.where(keep, dest, torch.arange(slots, slots + n, device=dev))
    slot_tok = torch.full((slots + n,), t, dtype=torch.int64, device=dev)
    slot_choice = torch.full((slots + n,), n, dtype=torch.int64, device=dev)
    slot_tok[at] = torch.arange(t, device=dev).repeat(n // t)
    slot_choice[at] = torch.arange(n, device=dev)
    return dest, slot_tok[:slots], slot_choice[:slots], keep


class _PermuteToSlots(torch.autograd.Function):
    """``xe[s] = x[slot_tok[s]]`` (zero for empty slots); the backward is
    a gather too: ``dx[t] = sum_k dxe[dest[k*T + t]]``."""

    @staticmethod
    def forward(ctx, x, dest, slot_tok):
        ctx.save_for_backward(dest)
        ctx.t = x.shape[0]
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[slot_tok]

    @staticmethod
    def backward(ctx, dxe):
        dest, = ctx.saved_tensors
        dxp = torch.cat([dxe, dxe.new_zeros(1, dxe.shape[1])])
        dx = dxp[dest].reshape(-1, ctx.t, dxe.shape[1]).sum(0)
        return dx, None, None


def permute_to_slots(x, dest, slot_tok):
    """Dispatch as a permutation gather, ``[E*C, d]``."""
    return _PermuteToSlots.apply(x, dest, slot_tok)


class _CombineFromSlots(torch.autograd.Function):
    """``scatter_combine``'s forward; a backward of gathers through the
    slot -> token and slot -> choice maps:
    ``dye[s] = gate[slot_choice[s]] * dy[slot_tok[s]]``."""

    @staticmethod
    def forward(ctx, ye, gates, dest, slot_tok, slot_choice, keep):
        t = gates.shape[0]
        y, y_choice = _combine_gather(ye.reshape(-1, ye.shape[-1]), dest,
                                      keep, gates, t)
        ctx.save_for_backward(y_choice, gates, slot_tok, slot_choice, keep)
        ctx.ye_shape = ye.shape
        return y

    @staticmethod
    def backward(ctx, dy):
        y_choice, gates, slot_tok, slot_choice, keep = ctx.saved_tensors
        t, k = gates.shape
        d = dy.shape[-1]
        gates_flat = gates.T.reshape(-1) * keep.to(gates.dtype)
        gates_pad = torch.cat([gates_flat, gates_flat.new_zeros(1)])
        dy_pad = torch.cat([dy, dy.new_zeros(1, d)])
        dye = (gates_pad[slot_choice][:, None].to(dy.dtype)
               * dy_pad[slot_tok]).reshape(ctx.ye_shape)
        dgates = torch.einsum("td,ktd->tk", dy,
                              y_choice.reshape(k, t, d)).to(gates.dtype)
        return dye, dgates, None, None, None, None


def combine_from_slots(ye, gates, dest, slot_tok, slot_choice, keep):
    """Combine with a gather-only backward; ``ye [E, C, d]`` -> ``[T, d]``."""
    return _CombineFromSlots.apply(ye, gates, dest, slot_tok, slot_choice,
                                   keep)


def experts_fwd(w1: torch.Tensor, w2: torch.Tensor,
                xe: torch.Tensor) -> torch.Tensor:
    """``ffn_block`` of each expert on its slots: ``w1 [E, ffn, d]``,
    ``w2 [E, d, ffn]``, ``xe [E, C, d]`` -> ``[E, C, d]``."""
    return torch.stack([ffn_block(a, b, x) for a, b, x in
                        zip(w1.unbind(0), w2.unbind(0), xe.unbind(0))])


def _capacity(x, n_experts, capacity_factor, capacity):
    return (expert_capacity(x.shape[0], n_experts, capacity_factor)
            if capacity is None else capacity)


def moe_layer_gather(wg, w1, w2, x, capacity_factor: float = 2.0,
                     k: int = 1, capacity: int | None = None):
    """``moe_layer`` with gathers both ways."""
    n_experts, t = w1.shape[0], x.shape[0]
    cap = _capacity(x, n_experts, capacity_factor, capacity)
    idx_flat, gates = route_flat(wg, x, k)
    dest, slot_tok, slot_choice, keep = gather_metadata(idx_flat, t,
                                                        n_experts, cap)
    xe = permute_to_slots(x, dest, slot_tok).reshape(n_experts, cap, -1)
    return combine_from_slots(experts_fwd(w1, w2, xe), gates, dest,
                              slot_tok, slot_choice, keep)


def moe_layer_scatter(wg, w1, w2, x, capacity_factor: float = 2.0,
                      k: int = 1, capacity: int | None = None):
    """``moe_layer`` with the scatter dispatch: O(T*d) movement."""
    n_experts, t = w1.shape[0], x.shape[0]
    cap = _capacity(x, n_experts, capacity_factor, capacity)
    idx_flat, gates = route_flat(wg, x, k)
    xe, dest, keep = scatter_dispatch(idx_flat, x, n_experts, cap)
    return scatter_combine(experts_fwd(w1, w2, xe), dest, keep, gates, t)


def router_aux_loss(wg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Switch load-balancing loss ``E * sum_e f_e * P_e`` on one layer's
    tokens: ``f_e`` from the (non-differentiable) top-1 assignment, the
    gradient through ``P_e``. It is 1 at uniform routing."""
    logits = x @ wg.T
    n_experts = wg.shape[0]
    probs = softmax(logits)
    top1 = F.one_hot(torch.argmax(logits.detach(), dim=-1),
                     n_experts).to(probs.dtype)
    return n_experts * torch.sum(top1.mean(0) * probs.mean(0))


def dense_dispatch(wg, x, n_experts: int, capacity: int, k: int):
    """Routing and the one-hot tensors of the dense form: ``(disp
    [T, E, C], comb [T, E, C])``, ``comb`` the gate-scaled dispatch."""
    if k == 1:
        idx, gate = route_top1(wg, x)
        disp = dispatch_tensor(idx, n_experts, capacity, x.dtype)
        return disp, disp * gate[:, None, None]
    idx, gates = route_topk(wg, x, k)
    disp_k = dispatch_tensor_topk(idx, n_experts, capacity, x.dtype)
    return disp_k.sum(0), torch.einsum("ktec,tk->tec", disp_k, gates)


def moe_layer(wg, w1, w2, x, capacity_factor: float = 2.0, k: int = 1,
              capacity: int | None = None) -> torch.Tensor:
    """One MoE FFN layer, dense form, no residual: ``wg [E, d]``,
    ``w1 [E, ffn, d]``, ``w2 [E, d, ffn]``, ``x [T, d]``. ``capacity``
    overrides the per-expert slot count (the grouped oracle of EP passes
    EP's)."""
    n_experts = w1.shape[0]
    cap = _capacity(x, n_experts, capacity_factor, capacity)
    disp, comb = dense_dispatch(wg, x, n_experts, cap, k)
    xe = torch.einsum("tec,td->ecd", disp, x)
    return torch.einsum("tec,ecd->td", comb, experts_fwd(w1, w2, xe))


LAYERS = {"dense": moe_layer, "scatter": moe_layer_scatter,
          "gather": moe_layer_gather}


def moe_stack_fwd_aux(params, x: torch.Tensor, capacity_factor: float = 2.0,
                      k: int = 1, capacity: int | None = None,
                      dispatch: str = "dense"):
    """The stack of MoE layers (``MoEStackParams``) with a residual around
    each: ``(y, aux)``, ``aux`` the summed ``router_aux_loss`` of every
    layer on its own input. ``dispatch`` is ``"dense"``, ``"scatter"`` or
    ``"gather"``."""
    if dispatch not in LAYERS:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    layer = LAYERS[dispatch]
    aux = x.new_zeros(())
    for l in range(params.w1.shape[0]):
        aux = aux + router_aux_loss(params.wg[l], x)
        x = x + layer(params.wg[l], params.w1[l], params.w2[l], x,
                      capacity_factor, k, capacity)
    return x, aux


def moe_stack_fwd(params, x, capacity_factor: float = 2.0, k: int = 1,
                  capacity: int | None = None, dispatch: str = "dense"):
    """Output half of ``moe_stack_fwd_aux``."""
    return moe_stack_fwd_aux(params, x, capacity_factor, k, capacity,
                             dispatch)[0]


def moe_stack_aux(params, x, capacity_factor: float = 2.0, k: int = 1,
                  capacity: int | None = None):
    """Aux half of ``moe_stack_fwd_aux``."""
    return moe_stack_fwd_aux(params, x, capacity_factor, k, capacity)[1]
