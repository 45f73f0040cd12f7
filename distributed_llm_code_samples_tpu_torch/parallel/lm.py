"""LM trainers, as in the JAX package's ``parallel/lm.py``: the
single-device trainer, DDP, FSDP/ZeRO-3, Megatron TP with the
vocab-parallel embedding, cross-entropy and fused head, the DDP x TP
hybrid, and sequence parallelism (``train_lm_seq``, the long-context
path: ``parallel/sequence.py``'s ring or Ulysses, the head on each
rank's token block).

``train_lm_single``: per step, a batch of next-token sequences, the
mean cross-entropy of the tied head, its gradients (autograd composing
the hand VJPs of LayerNorm, attention, the FFN blocks and the loss) and
inline SGD, or a stateful ``optimizer`` (``optim.py``) whose state
``opt_state``/``return_state`` carry in and out. ``attn_impl`` and
``head_impl`` select the oracle ops or the hand-written kernels (flash
attention, the fused head); ``mixed`` runs the trunk in bf16
(``models.lm.lm_loss``), which hands the flash kernels bf16 q, k and v.
The JAX trainer runs the schedule as one ``lax.scan``; here the steps
run eagerly.

``train_lm_tp`` (Megatron-LM): the blocks shard heads and features as
``parallel/transformer.py``'s TP does, and ``wte`` shards its vocab rows,
serving both the vocab-parallel embedding (``vp_embed``) and the tied
vocab-parallel head: the cross-entropy over the rank's logit columns
(``vp_xent``) or the fused head's kernels on the rank's rows
(``vp_head_xent``), so that no rank holds a whole ``[N, V]`` row. Each
completes with one max and two sums over the model axis, in its forward;
their backwards need no collective. The step's backward is split at the
``f`` all-reduces as the TP blocks' is (``parallel/transformer.py``).

``train_lm_ddp``: replicated params (and optimizer state), strided
seeds, ``lm_grads`` on each rank's batch, then each gradient summed once
over the data axis after autograd has returned. ``wte``'s embedding and
head sides are summed inside ``lm_grads``, before that one reduction
(JAX's ``_vma_check`` docstring tells of the double count that a second
reduction of the embedding side gives).

``train_lm_fsdp``: ``wte`` and ``wpe`` shard their rows and ``ln_f`` its
features over the data axis, the blocks dim 1 of every stacked leaf
(``_lm_fsdp_specs``). ``wte``, ``wpe`` and ``ln_f`` are gathered once a
step (``wte`` serves the embedding and the head), the blocks a layer at
a time, in the forward and again in the backward, through
``parallel/transformer.py``'s FSDP block stack; every gradient is
reduce-scattered onto the rank's shards, ``wte``'s two sides summed
first. The optimizer state is made from the shards and lives there
(ZeRO-3).

``train_lm_hybrid``: ``_make_tp_step`` on the model axis of a data x
model mesh, then each gradient summed over the data axis; the seeds
strided over the data axis only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import lm_batch_from_seed
from ..models.lm import LMParams, clone_lm, lm_from_leaves, lm_leaves, lm_loss
from ..ops.norm import layernorm
from ..ops.xent import xent_loss
from ..optim import check_state_args, sgd
from .collectives import (all_gather, all_reduce, axis_index, pmax,
                          reduce_scatter)
from .launcher import (DEFAULT_TIMEOUT_S, launch_replicated, launch_strided,
                       refuse_unported, run_guarded, run_replicated,
                       run_strided, to_device)
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, require_axes
from .sequence import (SeqAttention, check_mha, resolve_seq_attn,
                       seq_blocks_backward, seq_blocks_forward, sum_grads)
from .transformer import (FIELDS, FSDP_SPECS, TP_SPECS, TPComm, _check_fsdp,
                          _leaf, _validate_shapes, _validate_tp,
                          blocks_backward, blocks_forward,
                          fsdp_blocks_backward, fsdp_blocks_forward,
                          resolve_attn, shard_leaves, unshard_leaves)


def _validate_lm(batch_size: int, seq_len: int, model_size: int,
                 n_heads: int, params: LMParams) -> None:
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    if seq_len > params.max_seq_len:
        raise ValueError(f"seq_len={seq_len} exceeds the model's "
                         f"max_seq_len={params.max_seq_len}")


def resolve_head(head_impl: str | None):
    """The head + loss op ``models.lm.lm_loss`` plugs in: None/"oracle"
    builds the ``[N, V]`` logits and runs the hand-VJP xent; "fused" is
    the fused kernels (``ops.fused_xent.head_xent``), no ``[N, V]`` array
    in either direction."""
    if head_impl in (None, "oracle"):
        return None
    if head_impl == "fused":
        from ..ops.fused_xent import head_xent
        return head_xent
    raise ValueError(f"unknown head_impl {head_impl!r} "
                     "(expected 'oracle' or 'fused')")


def lm_grads(params: LMParams, tokens, targets, n_heads: int, attn=None,
             head=None, mixed: bool = False):
    """``(loss, grads)`` of ``lm_loss`` with ``grads`` in ``lm_leaves``
    order. Each leaf is taken with ``detach().requires_grad_()`` (the
    parameters are buffers) and ``torch.autograd.grad`` differentiates
    the loss; ``wte``'s gradient sums its embedding and head sides."""
    leaves = [t.detach().requires_grad_() for t in lm_leaves(params)]
    with torch.enable_grad():
        loss = lm_loss(lm_from_leaves(leaves), tokens, targets, n_heads,
                       attn, head, mixed)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def _make_step(batch_size: int, model_size: int, seq_len: int,
               n_heads: int, lr: float, attn=None, batch_fn=None,
               head=None, mixed: bool = False, optimizer=None, *,
               mesh: Optional[Mesh] = None, grads_fn=None,
               vocab: Optional[int] = None):
    """One update; ``batch_size`` is tokens a step. The batch is
    ``batch_fn(seed) -> (tokens, targets)``, or the seeds-as-dataset
    ``lm_batch_from_seed`` over ``vocab`` tokens (default the params')
    on the params' device. The gradients are ``lm_grads``', each summed
    over the data axis of a rank's ``mesh`` (DDP) once autograd has
    returned, or ``grads_fn(params, tokens, targets)``'s (FSDP). Without
    ``optimizer`` it is ``(params, seed) -> params`` with SGD in place;
    with one, ``((params, state), seed) -> (params, state)``."""
    b = batch_size // seq_len

    def grads_of(params: LMParams, seed) -> list:
        tokens, targets = (batch_fn(seed) if batch_fn is not None else
                           lm_batch_from_seed(seed, b, seq_len,
                                              vocab or params.vocab,
                                              device=params.device))
        if grads_fn is not None:
            return grads_fn(params, tokens, targets)
        grads = lm_grads(params, tokens.to(params.device),
                         targets.to(params.device), n_heads, attn, head,
                         mixed)[1]
        if mesh is None:
            return grads
        return [all_reduce(g, mesh, axis=DATA_AXIS) for g in grads]

    def step(params: LMParams, seed) -> LMParams:
        sgd(lm_leaves(params), grads_of(params, seed), lr)
        return params

    def step_opt(carry, seed):
        params, state = carry
        return optimizer.update(lm_from_leaves(grads_of(params, seed)),
                                state, params, lr, mesh=mesh)

    return step if optimizer is None else step_opt


def train_lm_single(params: LMParams, seeds, batch_size: int,
                    model_size: int, mesh=None, lr: float = LR, *,
                    seq_len: int, n_heads: int,
                    attn_impl: str | None = None, optimizer=None,
                    opt_state=None, return_state: bool = False,
                    batch_fn: Optional[Callable] = None,
                    head_impl: str | None = None, mixed: bool = False,
                    on_step: Optional[Callable[[int], None]] = None
                    ) -> LMParams:
    """Train a copy of ``params`` over the seed schedule and return it;
    the caller's params are not touched. ``batch_size`` is tokens a step
    (``seq_len`` folded in); ``mesh`` is ignored (the launcher signature
    of every strategy). ``on_step(i)`` is called after step ``i``.
    ``optimizer``/``opt_state``/``return_state`` follow ``train_ddp``'s
    contract: with ``return_state`` it returns ``(params, opt_state)``,
    which a later call resumes from. ``mixed`` runs the bf16 trunk
    (``models.lm.lm_loss(mixed=True)``); params, grads and the update
    stay f32."""
    _validate_lm(batch_size, seq_len, model_size, n_heads, params)
    check_state_args(optimizer, opt_state, return_state)
    step = _make_step(batch_size, model_size, seq_len, n_heads, lr,
                      resolve_attn(attn_impl), batch_fn,
                      resolve_head(head_impl), mixed, optimizer)
    params = clone_lm(params)
    carry = params if optimizer is None else (
        params, optimizer.init(params) if opt_state is None else opt_state)
    for i, seed in enumerate(seeds):
        carry = step(carry, int(seed))
        if on_step is not None:
            on_step(i)
    if optimizer is None or return_state:
        return carry
    return carry[0]


# -- vocab-parallel pieces (Megatron-LM) ---------------------------------------
#
# Each takes the rank's view of the mesh and the model ``axis``; the
# collectives run in the forward, from the calling thread, and the
# backwards hold none.

class _VPEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wte_local, tokens, mesh, axis):
        v_local = wte_local.shape[0]
        local = tokens.long() - axis_index(mesh, axis) * v_local
        in_range = (local >= 0) & (local < v_local)
        idx = local.clamp(0, v_local - 1)
        rows = wte_local[idx] * in_range[..., None].to(wte_local.dtype)
        ctx.save_for_backward(idx, in_range)
        ctx.v_local = v_local
        return all_reduce(rows, mesh, axis=axis)

    @staticmethod
    def backward(ctx, dy):
        idx, in_range = ctx.saved_tensors
        d = dy.shape[-1]
        dw = torch.zeros(ctx.v_local, d, dtype=dy.dtype, device=dy.device)
        dw.index_add_(0, idx.reshape(-1),
                      (dy * in_range[..., None].to(dy.dtype)).reshape(-1, d))
        return dw, None, None, None


def vp_embed(wte_local: torch.Tensor, tokens: torch.Tensor, mesh: Mesh,
             axis: str = MODEL_AXIS) -> torch.Tensor:
    """Vocab-parallel embedding lookup on the rank of ``mesh``: the rank
    resolves only the tokens of its ``[r V/n, (r+1) V/n)`` rows (zeros
    elsewhere) and one all-reduce completes them, a Megatron ``g``. Its
    backward is the identity through that sum, then the scatter-add of
    each token's gradient into the rank's own rows (complete: every rank
    holds the whole ``dy``)."""
    return _VPEmbed.apply(wte_local, tokens, mesh, axis)


class _VPXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits_local, targets, mesh, axis):
        v_local = logits_local.shape[-1]
        m = pmax(logits_local.amax(dim=-1, keepdim=True), mesh, axis=axis)
        e = torch.exp(logits_local - m)
        sumexp = all_reduce(e.sum(dim=-1, keepdim=True), mesh, axis=axis)
        lse = torch.log(sumexp) + m                                # [N, 1]
        local_t = targets.long() - axis_index(mesh, axis) * v_local
        in_range = (local_t >= 0) & (local_t < v_local)
        idx = local_t.clamp(0, v_local - 1)
        picked = torch.gather(logits_local, -1, idx[:, None])[:, 0]
        z_t = all_reduce(torch.where(in_range, picked,
                                     torch.zeros_like(picked)),
                         mesh, axis=axis)
        ctx.save_for_backward(e / sumexp, idx, in_range)
        return (lse[:, 0] - z_t).mean()

    @staticmethod
    def backward(ctx, dy):
        probs, idx, in_range = ctx.saved_tensors
        n = probs.shape[0]
        dz = probs * (dy / n)
        hit = torch.where(in_range, -dy / n, torch.zeros_like(dy))
        dz.index_put_((torch.arange(n, device=dz.device), idx),
                      hit.to(dz.dtype), accumulate=True)
        return dz, None, None, None


def vp_xent(logits_local: torch.Tensor, targets: torch.Tensor, mesh: Mesh,
            axis: str = MODEL_AXIS) -> torch.Tensor:
    """Vocab-parallel mean cross-entropy: ``logits_local [N, V/n]`` is the
    rank's slice of each row; the row max (``pmax``), the normalizer and
    the target logit (two all-reduces) each complete with one collective.
    The backward is the hand ``(softmax - onehot) dy / N`` on the local
    slice, with no collective (the residuals are local)."""
    return _VPXent.apply(logits_local, targets, mesh, axis)


class _VPHeadXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, wte_local, targets, mesh, axis):
        from ..ops.fused_xent import head_xent_stats
        t_local = targets.long() - axis_index(mesh, axis) * wte_local.shape[0]
        lse_l, tz_l = head_xent_stats(h, wte_local, t_local)
        # the logsumexp merge over the slices: M + log(sum exp(lse - M))
        m = pmax(lse_l, mesh, axis=axis)
        lse_g = m + torch.log(all_reduce(torch.exp(lse_l - m), mesh,
                                         axis=axis))
        z_t = all_reduce(tz_l, mesh, axis=axis)  # one slice holds it
        ctx.save_for_backward(h, wte_local, t_local, lse_g)
        return (lse_g - z_t).mean()

    @staticmethod
    def backward(ctx, dy):
        from ..ops.fused_xent import head_xent_bwd
        dh, dw = head_xent_bwd(dy, *ctx.saved_tensors)
        return dh, dw, None, None, None


def vp_head_xent(h: torch.Tensor, wte_local: torch.Tensor,
                 targets: torch.Tensor, mesh: Mesh,
                 axis: str = MODEL_AXIS) -> torch.Tensor:
    """Vocab-parallel fused head and cross-entropy: ``vp_xent``'s
    collectives over the fused head's kernels (``ops/fused_xent.py``), so
    that no rank stores even its local ``[N, V/n]`` logits. The targets
    shift by the rank's first row ``r V/n`` (on every rank but the
    owner's they fall outside ``[0, V/n)`` and match no column); the
    statistics kernel gives the rank's ``(lse, tz)``, merged by one
    ``pmax`` and two all-reduces; the backward kernel takes the merged
    global ``lse``: ``dw`` is complete for the rank's rows, ``dh`` partial
    (the caller's ``f`` completes it)."""
    return _VPHeadXent.apply(h, wte_local, targets, mesh, axis)


# -- Megatron-LM TP -------------------------------------------------------------

def _lm_tp_specs() -> list:
    """The model-axis dim of each leaf in ``lm_leaves`` order: ``wte``'s
    vocab rows, the blocks' ``TP_SPECS``; ``wpe`` and ``ln_f``
    replicated."""
    return [0, None] + [TP_SPECS[f] for f in FIELDS] + [None]


def lm_tp_shard(params: LMParams, mesh: Mesh) -> LMParams:
    """The rank of ``mesh``'s TP shards of the LM."""
    return lm_from_leaves(shard_leaves(lm_leaves(params), _lm_tp_specs(),
                                       mesh))


def lm_tp_unshard(shards) -> LMParams:
    """The whole LM from the TP shards of the model axis, in its order."""
    return lm_from_leaves(unshard_leaves([lm_leaves(s) for s in shards],
                                         _lm_tp_specs()))


def _map_state(fn, *states, specs=None):
    """The structure of optimizer ``states`` with each param-shaped part
    (an ``LMParams``; JAX ``_lm_state_specs``) replaced by
    ``lm_from_leaves(fn(leaves of each state, specs))`` and each other
    tensor (a step count) by ``fn([[t] of each state], [None])[0]``:
    ``fn`` maps the states' leaves and their sharded dims (``specs``,
    default ``_lm_tp_specs()``) to one list of leaves (a shard, or the
    joined whole)."""
    specs = _lm_tp_specs() if specs is None else specs
    s = states[0]
    if isinstance(s, LMParams):
        return lm_from_leaves(fn([lm_leaves(x) for x in states], specs))
    if isinstance(s, torch.Tensor):
        return fn([[x] for x in states], [None])[0]
    if hasattr(s, "_fields"):
        return type(s)(*(_map_state(fn, *xs, specs=specs)
                         for xs in zip(*states)))
    if isinstance(s, (tuple, list)):
        return type(s)(_map_state(fn, *xs, specs=specs)
                       for xs in zip(*states))
    return s


def lm_tp_shard_state(state, mesh: Mesh):
    """The rank's shards of a whole optimizer state, sharded as the
    params (Megatron's optimizer layout)."""
    return _map_state(lambda ls, dims: shard_leaves(ls[0], dims, mesh),
                      state)


def lm_tp_unshard_state(states):
    """The whole optimizer state from every rank's shards."""
    return _map_state(unshard_leaves, *states)


def lm_tp_grads(params: LMParams, tokens, targets, h_local: int, *,
                mesh: Mesh, attn=None, head_impl: str | None = None):
    """``(loss, grads)`` of the rank's TP shards ``params`` on the batch
    ``tokens, targets [B, T]``, ``grads`` in ``lm_leaves`` order. The
    backward runs in pieces between the collectives: the head, ``f``'s
    all-reduce of its input gradient, the final LayerNorm, the blocks
    (``blocks_backward``), the embedding. In plain TP every rank sees the
    whole ``dx``, so ``wpe`` and the LN gains get whole gradients with no
    reduction, and ``wte`` and the block weights whole ones for the
    rank's own rows and heads."""
    comm = TPComm(mesh)
    fused = resolve_head(head_impl) is not None
    dev, d = params.device, params.d_model
    tokens, targets = tokens.to(dev), targets.reshape(-1).to(dev)
    wte_e, wpe = _leaf(params.wte), _leaf(params.wpe)
    with torch.enable_grad():
        x0 = vp_embed(wte_e, tokens, mesh) + wpe[:tokens.shape[1]]
    x, blocks = blocks_forward(params.blocks, x0.detach(), h_local, comm,
                               True, attn)
    x, ln_f, wte_h = _leaf(x), _leaf(params.ln_f), _leaf(params.wte)
    with torch.enable_grad():
        hf = layernorm(ln_f, x)
    h = _leaf(comm.f(hf.detach()))
    with torch.enable_grad():
        h2 = h.reshape(-1, d)
        loss = (vp_head_xent(h2, wte_h, targets, mesh) if fused else
                vp_xent(h2 @ wte_h.T, targets, mesh))
    dh, dwte_h = torch.autograd.grad(loss, [h, wte_h])
    dx, dln_f = torch.autograd.grad(hf, [x, ln_f], comm.f_t(dh))
    dx, dblocks = blocks_backward(blocks, dx)
    dwte_e, dwpe = torch.autograd.grad(x0, [wte_e, wpe], dx)
    return loss.detach(), [dwte_e + dwte_h, dwpe, *dblocks, dln_f]


def _make_tp_step(batch_size: int, model_size: int, seq_len: int,
                  h_local: int, vocab: int, lr: float, attn=None,
                  data_axes=(), optimizer=None,
                  head_impl: str | None = None, *, mesh: Mesh,
                  batch_fn: Optional[Callable] = None):
    """One vocab-parallel TP step for the rank of ``mesh``: ``(shards,
    seed) -> shards`` with SGD in place, or with ``optimizer``
    ``((shards, state), seed) -> (shards, state)``, the state sharded as
    the shards (the elementwise update needs no collective); the
    gradients are ``lm_tp_grads``', each then summed over every axis of
    ``data_axes`` (the hybrid's data axis)."""
    b = batch_size // seq_len

    def grads_of(params: LMParams, seed) -> list:
        tokens, targets = (batch_fn(seed) if batch_fn is not None else
                           lm_batch_from_seed(seed, b, seq_len, vocab,
                                              device=params.device))
        grads = lm_tp_grads(params, tokens, targets, h_local, mesh=mesh,
                            attn=attn, head_impl=head_impl)[1]
        for axis in data_axes:
            grads = [all_reduce(g, mesh, axis=axis) for g in grads]
        return grads

    def step(params: LMParams, seed) -> LMParams:
        sgd(lm_leaves(params), grads_of(params, seed), lr)
        return params

    def step_opt(carry, seed):
        params, state = carry
        return optimizer.update(lm_from_leaves(grads_of(params, seed)),
                                state, params, lr, mesh=mesh)

    return step if optimizer is None else step_opt


def train_lm_tp(params: LMParams, seeds, batch_size: int, model_size: int,
                mesh: Mesh, lr: float = LR, *, seq_len: int, n_heads: int,
                attn_impl: str | None = None, optimizer=None,
                opt_state=None, return_state: bool = False,
                head_impl: str | None = None, guard=None, guard_state=None,
                return_guard: bool = False,
                batch_fn: Optional[Callable] = None,
                on_step: Optional[Callable[[int], None]] = None,
                timeout: float = DEFAULT_TIMEOUT_S):
    """Megatron-LM TP over the model axis (``_make_tp_step``): data
    replicated, so it takes the steps ``train_lm_single`` takes and must
    agree with it. ``attn_impl``, ``head_impl`` and GQA (the KV heads
    split over the ranks too) as there. ``optimizer`` threads a state
    sharded like the params; with ``return_state`` the result is
    ``(params, opt_state)``, which a later call resumes from. Given the
    whole mesh it launches the ranks and returns the whole params (and
    state) on the device of ``params``; given a rank's view it runs that
    rank and returns its shards, and ``opt_state`` is the rank's shard.
    ``batch_fn(seed) -> (tokens, targets)`` overrides the batches (it
    must pickle to reach spawned ranks).

    ``guard``/``guard_state``/``return_guard`` arm the skip-step
    guardrail (``runtime/guardrails.py``): a step whose new shards or
    state are not finite on any rank is skipped on every rank; with
    ``return_guard`` the result is ``(result, GuardState)``. There is no
    loss-scale hook here: a scaling config raises, as JAX's."""
    from ..runtime.guardrails import check_guard_args, require_scale_hook
    require_axes(mesh, MODEL_AXIS)
    n = mesh.axis_size(MODEL_AXIS)
    h_local = _validate_tp(params.blocks, n_heads, n)
    _validate_lm(batch_size, seq_len, model_size, n_heads, params)
    check_state_args(optimizer, opt_state, return_state)
    if params.vocab % n:
        raise ValueError(f"vocab={params.vocab} not divisible by "
                         f"model-axis size {n}")
    resolve_head(head_impl)
    attn = resolve_attn(attn_impl)
    check_guard_args(guard, guard_state, return_guard)
    require_scale_hook(guard, takes_scale=False)
    if not mesh.in_rank:
        outs = launch_replicated(
            _lm_tp_rank, params, seeds, mesh, batch_size, model_size, lr,
            _trip(opt_state, mesh), dict(seq_len=seq_len, n_heads=n_heads,
                            attn_impl=attn_impl, optimizer=optimizer,
                            head_impl=head_impl, batch_fn=batch_fn,
                            guard=guard,
                            guard_state=_trip(guard_state, mesh)),
            timeout=timeout)
        dev = params.device
        out = to_device(lm_tp_unshard([o[0] for o in outs]), dev)
        if optimizer is not None and return_state:
            out = (out, to_device(lm_tp_unshard_state([o[1] for o in outs]),
                                  dev))
        if return_guard:
            return out, to_device(outs[0][2], dev)
        return out
    step = _make_tp_step(batch_size, model_size, seq_len, h_local,
                         params.vocab, lr, attn, optimizer=optimizer,
                         head_impl=head_impl, mesh=mesh, batch_fn=batch_fn)
    shards = lm_tp_shard(params, mesh)
    carry = (shards if optimizer is None else
             (shards, optimizer.init(shards) if opt_state is None
              else to_device(opt_state, mesh.torch_device)))
    return run_guarded(step, carry, seeds, mesh, on_step, guard,
                       guard_state, return_guard, strided=False,
                       keep=optimizer is None or return_state)


def _lm_tp_rank(mesh: Mesh, payload):
    """One rank of a whole-mesh ``train_lm_tp``: its shards (and its
    optimizer state's, and the guard's state) on the CPU."""
    params, seeds, batch_size, model_size, lr, opt_state, kw = payload
    if opt_state is not None:
        opt_state = lm_tp_shard_state(opt_state, mesh)
    guarded = kw["guard"] is not None
    out = train_lm_tp(params, seeds, batch_size, model_size, mesh, lr,
                      opt_state=opt_state,
                      return_state=kw["optimizer"] is not None,
                      return_guard=guarded, **kw)
    out, g = out if guarded else (out, None)
    g = to_device(g, "cpu")
    if kw["optimizer"] is None:
        return to_device(out, "cpu"), None, g
    return to_device(out[0], "cpu"), to_device(out[1], "cpu"), g


# -- data parallelism: DDP, FSDP/ZeRO-3 and the DDP x TP hybrid ------------------

def train_lm_ddp(params: LMParams, seeds, batch_size: int, model_size: int,
                 mesh: Mesh, lr: float = LR, *, seq_len: int, n_heads: int,
                 attn_impl: str | None = None, optimizer=None,
                 opt_state=None, return_state: bool = False,
                 head_impl: str | None = None, mixed: bool = False,
                 guard=None, guard_state=None, return_guard: bool = False,
                 batch_fn: Optional[Callable] = None,
                 on_step: Optional[Callable[[int], None]] = None,
                 timeout: float = DEFAULT_TIMEOUT_S):
    """DDP over the data axis: every rank holds the whole LM, takes its
    column of the strided seeds (``seeds[t * n + r]`` at step ``t``), runs
    ``lm_grads`` (``attn_impl``, ``head_impl``: the fused head's kernels
    on every rank, ``mixed``: the bf16 trunk) and sums each gradient over
    the axis once (SUM, the unscaled LR) before the update. ``optimizer``
    threads a replicated state; with ``return_state`` the result is
    ``(params, opt_state)``, which a later call resumes from. Given the
    whole mesh it launches the ranks and returns rank 0's params (and
    state) on the device of ``params``; given a rank's view it runs that
    rank and returns its replica. ``batch_fn`` as ``train_lm_tp``'s.
    ``guard``/``guard_state``/``return_guard``: the skip-step guardrail,
    as ``train_lm_tp``'s (no loss-scale hook)."""
    from ..runtime.guardrails import check_guard_args, require_scale_hook
    require_axes(mesh, DATA_AXIS)
    _validate_lm(batch_size, seq_len, model_size, n_heads, params)
    check_state_args(optimizer, opt_state, return_state)
    check_guard_args(guard, guard_state, return_guard)
    require_scale_hook(guard, takes_scale=False)
    head = resolve_head(head_impl)
    attn = resolve_attn(attn_impl)
    kw = dict(seq_len=seq_len, n_heads=n_heads, attn_impl=attn_impl,
              optimizer=optimizer, head_impl=head_impl, mixed=mixed,
              batch_fn=batch_fn, guard=guard,
              guard_state=_trip(guard_state, mesh),
              return_guard=return_guard)
    if not mesh.in_rank:
        outs = launch_strided(_lm_dp_rank, params, seeds, mesh, batch_size,
                              model_size, lr, _trip(opt_state, mesh),
                              ("ddp", kw), timeout=timeout)
        out = to_device(outs[0], params.device)
        if optimizer is None or return_state:
            return out
        return (out[0][0], out[1]) if return_guard else out[0]
    step = _make_step(batch_size, model_size, seq_len, n_heads, lr, attn,
                      batch_fn, head, mixed, optimizer, mesh=mesh)
    local = to_device(clone_lm(params), mesh.torch_device)
    carry = (local if optimizer is None else
             (local, optimizer.init(local) if opt_state is None
              else to_device(opt_state, mesh.torch_device)))
    return run_guarded(step, carry, seeds, mesh, on_step, guard,
                       guard_state, return_guard,
                       keep=optimizer is None or return_state)


def _lm_fsdp_specs() -> list:
    """The data-axis dim of each leaf in ``lm_leaves`` order (JAX
    ``_lm_fsdp_specs``): ``wte`` and ``wpe`` their rows, the blocks
    ``FSDP_SPECS``, ``ln_f`` its features."""
    return [0, 0] + [FSDP_SPECS[f] for f in FIELDS] + [0]


def lm_fsdp_shard(params: LMParams, mesh: Mesh) -> LMParams:
    """The rank of ``mesh``'s FSDP shards of the LM."""
    return lm_from_leaves(shard_leaves(lm_leaves(params), _lm_fsdp_specs(),
                                       mesh, axis=DATA_AXIS))


def lm_fsdp_unshard(shards) -> LMParams:
    """The whole LM from the FSDP shards of the data axis, in its order."""
    return lm_from_leaves(unshard_leaves([lm_leaves(s) for s in shards],
                                         _lm_fsdp_specs()))


def lm_fsdp_shard_state(state, mesh: Mesh):
    """The rank's shards of a whole optimizer state, sharded as the
    params (the FFN FSDP's ``shard_state``)."""
    return _map_state(lambda ls, dims: shard_leaves(ls[0], dims, mesh,
                                                    axis=DATA_AXIS),
                      state, specs=_lm_fsdp_specs())


def lm_fsdp_unshard_state(states):
    """The whole optimizer state from every rank's FSDP shards."""
    return _map_state(unshard_leaves, *states, specs=_lm_fsdp_specs())


def lm_fsdp_grads(shards: LMParams, tokens, targets, n_heads: int, *,
                  mesh: Mesh, attn=None, head=None, mixed: bool = False):
    """``(loss, grads)`` of ``lm_loss`` on the rank's FSDP ``shards``, the
    gradients of the shards in ``lm_leaves`` order. ``wte``, ``wpe`` and
    ``ln_f`` are gathered once (``wte`` in f32 also under ``mixed``: it
    serves the f32 head, and the lookup is cast after, as in
    ``lm_loss(mixed=True)``); the blocks run through the FSDP block stack
    (under ``mixed`` each block shard cast to bf16 before its gather). The
    backward runs in pieces from the rank's thread: the final LayerNorm
    and the head, the blocks from the top, the embedding. ``wte``'s head
    and embedding sides are summed, then every gradient is
    reduce-scattered once onto the rank's shard."""
    dev, bf16 = shards.device, torch.bfloat16
    tokens, targets = tokens.to(dev).long(), targets.reshape(-1).to(dev)
    wte, wpe, ln_f = (all_gather(t, mesh, dim=0, axis=DATA_AXIS)
                      for t in (shards.wte, shards.wpe, shards.ln_f))
    wte_e, wpe = _leaf(wte), _leaf(wpe)
    with torch.enable_grad():
        x0 = (wte_e.to(bf16)[tokens] + wpe[:tokens.shape[1]].to(bf16)
              if mixed else wte_e[tokens] + wpe[:tokens.shape[1]])
    x, inputs = fsdp_blocks_forward(shards.blocks, x0.detach(), n_heads,
                                    mesh, True, attn, mixed)
    x, ln_f, wte_h = _leaf(x), _leaf(ln_f), _leaf(wte)
    with torch.enable_grad():
        h = layernorm(ln_f.to(bf16) if mixed else ln_f, x)
        h = h.reshape(-1, h.shape[-1]).to(wte_h.dtype)
        loss = (head(h, wte_h, targets) if head is not None
                else xent_loss(h @ wte_h.T, targets))
    dx, dln_f, dwte_h = torch.autograd.grad(loss, [x, ln_f, wte_h])
    dx, dblocks = fsdp_blocks_backward(shards.blocks, inputs, dx, n_heads,
                                       mesh, True, attn, mixed)
    dwte_e, dwpe = torch.autograd.grad(x0, [wte_e, wpe], dx)
    return loss.detach(), [
        reduce_scatter(g, mesh, dim=0, axis=DATA_AXIS)
        for g in (dwte_e + dwte_h, dwpe)] + dblocks + [
        reduce_scatter(dln_f, mesh, dim=0, axis=DATA_AXIS)]


def train_lm_fsdp(params: LMParams, seeds, batch_size: int, model_size: int,
                  mesh: Mesh, lr: float = LR, *, seq_len: int, n_heads: int,
                  attn_impl: str | None = None, optimizer=None,
                  opt_state=None, return_state: bool = False,
                  head_impl: str | None = None, mixed: bool = False,
                  batch_fn: Optional[Callable] = None,
                  on_step: Optional[Callable[[int], None]] = None,
                  timeout: float = DEFAULT_TIMEOUT_S):
    """FSDP/ZeRO-3 over the data axis (``lm_fsdp_grads``): the seeds
    strided as DDP's, the LM sharded by ``_lm_fsdp_specs``, the update on
    the shards. The block stack's backward recomputes each block, so
    under flash a step launches ``flash_attn_fwd`` twice a layer (once a
    layer under DDP); the head's kernels run once a step on the gathered
    ``wte``. ``optimizer``'s state is made from the rank's shards and
    stays there; a norm clip sums over the shards with
    ``clipped(axis="data")``. Given the whole mesh it returns the whole
    params (with ``return_state`` also the whole state, re-assembled as
    the params are, which ``opt_state`` takes back and shards again) on
    the device of ``params``; given a rank's view, that rank's shards
    (and its shard of the state, in and out)."""
    require_axes(mesh, DATA_AXIS)
    n = mesh.axis_size(DATA_AXIS)
    _validate_lm(batch_size, seq_len, model_size, n_heads, params)
    check_state_args(optimizer, opt_state, return_state)
    for name in ("wte", "wpe", "ln_f"):
        dim = getattr(params, name).shape[0]
        if dim % n:
            raise ValueError(f"{name} dim {dim} not divisible by {n} shards")
    _check_fsdp(params.blocks, n, prefix="blocks.")
    head = resolve_head(head_impl)
    attn = resolve_attn(attn_impl)
    kw = dict(seq_len=seq_len, n_heads=n_heads, attn_impl=attn_impl,
              optimizer=optimizer, head_impl=head_impl, mixed=mixed,
              batch_fn=batch_fn)
    if not mesh.in_rank:
        outs = launch_strided(_lm_dp_rank, params, seeds, mesh, batch_size,
                              model_size, lr, _trip(opt_state, mesh),
                              ("fsdp", kw), timeout=timeout)
        dev = params.device
        if optimizer is None:
            return to_device(lm_fsdp_unshard(outs), dev)
        out = to_device(lm_fsdp_unshard([o[0] for o in outs]), dev)
        if not return_state:
            return out
        return out, to_device(lm_fsdp_unshard_state([o[1] for o in outs]),
                              dev)

    def grads_fn(shards, tokens, targets):
        return lm_fsdp_grads(shards, tokens, targets, n_heads, mesh=mesh,
                             attn=attn, head=head, mixed=mixed)[1]

    step = _make_step(batch_size, model_size, seq_len, n_heads, lr,
                      batch_fn=batch_fn, optimizer=optimizer, mesh=mesh,
                      grads_fn=grads_fn, vocab=params.vocab)
    shards = lm_fsdp_shard(params, mesh)
    if optimizer is None:
        return run_strided(step, shards, seeds, mesh, on_step)
    state = (optimizer.init(shards) if opt_state is None
             else to_device(opt_state, mesh.torch_device))
    carry = run_strided(step, (shards, state), seeds, mesh, on_step)
    return carry if return_state else carry[0]


def train_lm_hybrid(params: LMParams, seeds, batch_size: int,
                    model_size: int, mesh: Mesh, lr: float = LR, *,
                    seq_len: int, n_heads: int, attn_impl: str | None = None,
                    batch_fn: Optional[Callable] = None,
                    on_step: Optional[Callable[[int], None]] = None,
                    timeout: float = DEFAULT_TIMEOUT_S) -> LMParams:
    """The DDP x vocab-parallel TP hybrid on a data x model mesh:
    ``_make_tp_step``'s ranks on the model axis (the blocks' and the
    vocab-parallel embedding's and cross-entropy's collectives), then each
    gradient summed over the data axis once a step; the params sharded
    over the model axis and replicated over the data axis; the seeds
    strided over the data axis only (``train_ffns.py:182``). As JAX's, it
    takes no ``head_impl``, optimizer or ``mixed``. Given the whole mesh
    it returns the whole params from the ranks of data index 0; given a
    rank's view, that rank's TP shards."""
    require_axes(mesh, DATA_AXIS, MODEL_AXIS)
    n = mesh.axis_size(MODEL_AXIS)
    h_local = _validate_tp(params.blocks, n_heads, n)
    _validate_lm(batch_size, seq_len, model_size, n_heads, params)
    if params.vocab % n:
        raise ValueError(f"vocab={params.vocab} not divisible by "
                         f"model-axis size {n}")
    attn = resolve_attn(attn_impl)
    kw = dict(seq_len=seq_len, n_heads=n_heads, attn_impl=attn_impl,
              batch_fn=batch_fn)
    if not mesh.in_rank:
        outs = launch_strided(_lm_dp_rank, params, seeds, mesh, batch_size,
                              model_size, lr, None, ("hybrid", kw),
                              axis=DATA_AXIS, timeout=timeout)
        return to_device(lm_tp_unshard([o for r, o in enumerate(outs)
                                        if mesh.coords(r)[DATA_AXIS] == 0]),
                         params.device)
    step = _make_tp_step(batch_size, model_size, seq_len, h_local,
                         params.vocab, lr, attn, data_axes=(DATA_AXIS,),
                         mesh=mesh, batch_fn=batch_fn)
    return run_strided(step, lm_tp_shard(params, mesh), seeds, mesh, on_step,
                       axis=DATA_AXIS)


# -- sequence parallelism (long context) --------------------------------------

def lm_seq_grads(params: LMParams, tokens, targets, n_heads: int, *,
                 mesh: Mesh, op: SeqAttention, head=None):
    """``(loss, grads)`` of the rank's share of the LM loss on its token
    block ``tokens, targets [B, T/n]`` of the seq axis (JAX
    ``train_lm_seq``'s ``loss_fn``): the embedding with the ``wpe`` rows
    of the block's global positions, the blocks through ``op``
    (``parallel/sequence.py``'s split block), the final LayerNorm, the
    head and the cross-entropy on the block, the local mean scaled by
    ``1/n``. ``grads`` (``lm_leaves`` order) are partial sums over the
    rank's tokens; the sum over the ranks is the single-device gradient.
    The backward runs in pieces from the rank's thread: the head, the
    blocks from the top, the embedding."""
    n, r = mesh.axis_size(SEQ_AXIS), mesh.axis_index(SEQ_AXIS)
    dev, t_local = params.device, tokens.shape[1]
    tokens, targets = tokens.to(dev).long(), targets.reshape(-1).to(dev)
    wte_e, wpe = _leaf(params.wte), _leaf(params.wpe)
    with torch.enable_grad():
        x0 = wte_e[tokens] + wpe[r * t_local:(r + 1) * t_local]
    x, blocks = seq_blocks_forward(params.blocks, x0.detach(), n_heads, op,
                                   mesh, True)
    x, ln_f, wte_h = _leaf(x), _leaf(params.ln_f), _leaf(params.wte)
    with torch.enable_grad():
        h = layernorm(ln_f, x)
        h = h.reshape(-1, h.shape[-1])
        loss = (head(h, wte_h, targets) if head is not None
                else xent_loss(h @ wte_h.T, targets)) / n
    dx, dln_f, dwte_h = torch.autograd.grad(loss, [x, ln_f, wte_h])
    dx, dblocks = seq_blocks_backward(blocks, dx)
    dwte_e, dwpe = torch.autograd.grad(x0, [wte_e, wpe], dx)
    return loss.detach(), [dwte_e + dwte_h, dwpe, *dblocks, dln_f]


def train_lm_seq(params: LMParams, seeds, batch_size: int, model_size: int,
                 mesh: Mesh, lr: float = LR, *, seq_len: int, n_heads: int,
                 seq_impl: str = "ring", attn_impl: str | None = None,
                 head_impl: str | None = None, optimizer=None,
                 mixed: bool = False, guard=None,
                 batch_fn: Optional[Callable] = None,
                 on_step: Optional[Callable[[int], None]] = None,
                 timeout: float = DEFAULT_TIMEOUT_S) -> LMParams:
    """Long-context LM training (JAX ``train_lm_seq``): the sequence
    sharded over the seq axis, attention across the ranks by the ring or
    Ulysses (``seq_impl``), and everything token-pointwise, the head and
    the cross-entropy included, on the rank's ``T/n`` tokens
    (``lm_seq_grads``). Every seq rank makes the step's whole batch from
    the seed and takes its own token block. The gradients, partial sums
    of the ``1/n``-scaled local losses, are summed by one all-reduce over
    the mesh, then SGD. On a data x seq mesh the seeds are strided over
    the data axis and the sum spans both axes. ``attn_impl`` (oracle or
    flash: the flash kernels on each ring hop, or on Ulysses' local
    heads) and ``head_impl`` (oracle or the fused head's kernels on the
    rank's block) as ``train_lm_single``'s; full MHA only. So the seq mesh
    alone takes ``train_lm_single``'s steps and data x seq
    ``train_lm_ddp``'s over the data axis. JAX's trainer has no
    optimizer, ``mixed`` or guard, and neither has this one (they raise).
    Given the whole mesh it returns rank 0's params (every rank holds the
    same) on the device of ``params``; given a rank's view, that rank's.
    ``batch_fn`` as ``train_lm_tp``'s (the whole batch)."""
    refuse_unported(optimizer=(optimizer, None), mixed=(mixed, False),
                    guard=(guard, None))
    require_axes(mesh, SEQ_AXIS)
    n = mesh.axis_size(SEQ_AXIS)
    dp = mesh.shape.get(DATA_AXIS, 1)
    _validate_lm(batch_size, seq_len, model_size, n_heads, params)
    check_mha(params.blocks)
    op = resolve_seq_attn(seq_impl, n, n_heads, seq_len, attn_impl=attn_impl)
    head = resolve_head(head_impl)
    if not mesh.in_rank:
        kw = dict(seq_len=seq_len, n_heads=n_heads, seq_impl=seq_impl,
                  attn_impl=attn_impl, head_impl=head_impl,
                  batch_fn=batch_fn)
        args = (_lm_dp_rank, params, seeds, mesh, batch_size, model_size, lr,
                None, ("seq", kw))
        outs = (launch_strided(*args, axis=DATA_AXIS, timeout=timeout)
                if dp > 1 else launch_replicated(*args, timeout=timeout))
        return to_device(outs[0], params.device)
    b, t_local = batch_size // seq_len, seq_len // n
    r = mesh.axis_index(SEQ_AXIS)

    def step(params: LMParams, seed) -> LMParams:
        tokens, targets = (batch_fn(seed) if batch_fn is not None else
                           lm_batch_from_seed(seed, b, seq_len, params.vocab,
                                              device=params.device))
        tokens, targets = (t[:, r * t_local:(r + 1) * t_local]
                           for t in (tokens, targets))
        grads = lm_seq_grads(params, tokens, targets, n_heads, mesh=mesh,
                             op=op, head=head)[1]
        sgd(lm_leaves(params), sum_grads(grads, mesh), lr)
        return params

    local = to_device(clone_lm(params), mesh.torch_device)
    if dp > 1:
        return run_strided(step, local, seeds, mesh, on_step, axis=DATA_AXIS)
    return run_replicated(step, local, seeds, mesh, on_step)


def _trip(opt_state, mesh: Mesh):
    """An optimizer state for the trip to the ranks (on the CPU unless
    the ranks are threads)."""
    if opt_state is None or mesh.loopback:
        return opt_state
    return to_device(opt_state, "cpu")


_DP_TRAINERS = {"ddp": train_lm_ddp, "fsdp": train_lm_fsdp,
                "hybrid": train_lm_hybrid, "seq": train_lm_seq}


def _lm_dp_rank(mesh: Mesh, payload):
    """One rank of a whole-mesh DDP, FSDP, hybrid or sequence-parallel
    run: its shards (with an optimizer, and its state's) on the CPU; DDP
    and seq: rank 0's replica alone."""
    params, seeds, batch_size, model_size, lr, opt_state, (kind, kw) = \
        payload
    if opt_state is not None:
        kw = dict(kw, opt_state=(lm_fsdp_shard_state(opt_state, mesh)
                                 if kind == "fsdp" else opt_state))
    if kw.get("optimizer") is not None:
        kw = dict(kw, return_state=True)
    out = _DP_TRAINERS[kind](params, seeds, batch_size, model_size, mesh, lr,
                             **kw)
    if kind in ("ddp", "seq") and mesh.rank:
        return None
    return to_device(out, "cpu")
