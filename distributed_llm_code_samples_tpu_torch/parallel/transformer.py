"""Transformer trainers, as in the JAX package's ``parallel/transformer.py``:
the single-device trainer (``mixed``: the blocks in bf16 over f32
master params), DDP, FSDP/ZeRO-3, Megatron tensor parallelism of the
pre-LN block stack (``models/transformer.py``), plain and
sequence-parallel, and the DDP x TP hybrid, and what the LM trainers
share with them (the shape checks, the ``attn_impl`` switch, the TP and
FSDP layouts, the split TP block and the FSDP block stack).

**DDP**: replicated params, strided seeds, the single-device VJP on each
rank's batch, then one all-reduce (SUM) of each gradient over the data
axis after autograd has returned, and SGD at the unscaled LR
(``train_ffns.py:165``).

**FSDP/ZeRO-3** keeps dim 1 of every stacked leaf (each layer's first
dim) split over the data axis (``FSDP_SPECS``). JAX gathers each layer
in its forward and lets XLA transpose the gather into the
reduce-scatter. Here the gathers run from the rank's own thread
(``fsdp_blocks_forward``): per layer the shards are gathered, the block
runs without autograd and only its input is kept. The backward
(``fsdp_blocks_backward``), from the top layer down, gathers the layer
again, recomputes the block under autograd, takes ``dx`` and the whole
weight gradients, and reduce-scatters them onto the rank's shards, as
the reference's FFN FSDP does (``train_ffns.py:245-256``). No gathered
layer lives from the forward to the backward; the recompute runs each
block's forward twice (JAX's transpose runs it once).

**TP** shards the ``"model"`` axis as Megatron does: heads are
column-parallel (``wq``/``wk``/``wv`` split on their output dim, so each
rank runs ``H/n`` whole heads, and ``H_kv/n`` under GQA), ``wo``
row-parallel, the FFN's ``w1``/``w2`` column/row-parallel (the FFN
stack's ``parallel/tp.py`` layout), LayerNorm gains replicated. Each
sublayer is ``x + g(core(f(LN(x))))`` with Megatron's pair of
operators: ``f`` identity forward and all-reduce backward (the partial
input gradients of the column-parallel projections summed before the
replicated LayerNorm's backward), ``g`` all-reduce forward (the
row-parallel matmul's partial output) and identity backward.

**Sequence-parallel TP** (Korthikanti et al., JAX ``sp_block``) keeps the
residual stream, the LayerNorms and the residual adds on the rank's
token shard ``[b, T/n, d]``: ``f`` becomes the all-gather of the tokens
(its transpose the reduce-scatter) and ``g`` the reduce-scatter (its
transpose the all-gather). The LN gains then see only the shard's tokens,
so their gradients take one all-reduce over the model axis; everything
else is whole on its shard.

**The backward is split at the collectives** and runs them from the
rank's own thread (``_Sublayer``): autograd differentiates only the
pieces between them (LayerNorm; the attention or FFN core), which hold no
collective. PyTorch runs every CUDA backward on one thread per card, so
a loopback rank that blocked there in an all-reduce would stop the other
ranks' (and with them its own): the ``parallel/expert.py`` rule. The
same code serves NCCL on n cards and gloo on the CPU. JAX's
``_f_gate``/``grad_reduce`` machinery compensates for its
varying-manual-axes typing, which PyTorch has not; the port keeps the
plain rule above.

**The hybrid** runs TP's ranks (``tp_grads``) on the model axis of a
data x model mesh and then all-reduces every gradient over the data
axis; the seeds are strided over the data axis only, so every model rank
of a data row takes the same seed.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import batch_from_seed
from ..models.transformer import (FIELDS, TransformerParams, attn_sublayer,
                                  transformer_block, transformer_fwd)
from ..ops.ffn import ffn_block
from ..ops.norm import layernorm
from ..optim import sgd
from .collectives import all_gather, all_reduce, axis_index, reduce_scatter
from .launcher import (DEFAULT_TIMEOUT_S, launch_replicated, launch_strided,
                       run_replicated, run_strided, to_device)
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, require_axes
from .sequence import (check_mha, resolve_seq_attn, seq_blocks_backward,
                       seq_blocks_forward, sum_grads)

# TP layout: the model-axis dim of each stacked leaf in FIELDS order
# (column-parallel projections shard their output dim, row-parallel their
# input dim), None where the leaf is replicated (JAX's TP_SPECS)
TP_SPECS = dict(ln1=None, wq=1, wk=1, wv=1, wo=2, ln2=None, w1=1, w2=2)

# FSDP layout: the data-axis dim of each stacked leaf, dim 1 (each
# layer's first dim) of every one (JAX's FSDP_SPECS, the reference's
# chunk along dim 0, train_ffns.py:265-266)
FSDP_SPECS = dict.fromkeys(FIELDS, 1)


def _validate_shapes(batch_size: int, seq_len: int, model_size: int,
                     n_heads: int) -> None:
    if batch_size % seq_len:
        raise ValueError(f"tokens {batch_size} not divisible by "
                         f"seq_len {seq_len}")
    if model_size % n_heads:
        raise ValueError(f"model_size={model_size} not divisible by "
                         f"n_heads={n_heads} (head dim must be whole)")


def resolve_attn(attn_impl: str | None):
    """The multi-head attention op for ``models.transformer.attn_sublayer``:
    None/"oracle" is the hand-VJP ``mha``/``gqa``; "flash" the flash
    kernels (``ops.flash_attention.flash_mha``, GQA shapes through its
    repeat-KV fan-out); "rope" rotary positions on q and k before the
    hand-VJP op (``models.attention.rope_mha``, GQA shapes compose)."""
    if attn_impl in (None, "oracle"):
        return None
    if attn_impl == "flash":
        from ..ops.flash_attention import flash_mha
        return flash_mha
    if attn_impl == "rope":
        from ..models.attention import rope_mha
        return rope_mha
    raise ValueError(f"unknown attn_impl {attn_impl!r} "
                     "(expected 'oracle', 'flash', or 'rope')")


def _validate_tp(params: TransformerParams, n_heads: int, n: int) -> int:
    """The local head count ``n_heads / n``; raises where the heads, the
    KV heads or the FFN features do not split over ``n`` ranks."""
    if n_heads % n:
        raise ValueError(f"n_heads={n_heads} not divisible by model-axis "
                         f"size {n}")
    dh = params.wq.shape[1] // n_heads
    kv_heads = params.wk.shape[1] // dh
    if kv_heads % n:
        raise ValueError(f"n_kv_heads={kv_heads} (GQA) not divisible by "
                         f"model-axis size {n}")
    ffn_dim = params.w1.shape[1]
    if ffn_dim % n:
        raise ValueError(f"ffn_dim={ffn_dim} not divisible by model-axis "
                         f"size {n}")
    return n_heads // n


# -- shards -------------------------------------------------------------------

def shard_leaves(leaves, dims, mesh: Mesh, axis: str = MODEL_AXIS) -> list:
    """The rank of ``mesh``'s block of each leaf along its dim of ``dims``
    (whole where the dim is None), fresh and contiguous on its device."""
    n, j = mesh.axis_size(axis), mesh.axis_index(axis)
    return [(t if d is None else t.chunk(n, d)[j])
            .to(mesh.torch_device, copy=True).contiguous()
            for t, d in zip(leaves, dims)]


def unshard_leaves(shards, dims) -> list:
    """The whole leaves from every rank's ``shard_leaves``, in rank order
    (rank 0's where a leaf is replicated)."""
    return [ts[0] if d is None else torch.cat(ts, d)
            for ts, d in zip(zip(*shards), dims)]


def tp_shard(params: TransformerParams, mesh: Mesh) -> TransformerParams:
    """The TP shards of the rank of ``mesh`` (``TP_SPECS``)."""
    return TransformerParams(*shard_leaves(
        [getattr(params, f) for f in FIELDS],
        [TP_SPECS[f] for f in FIELDS], mesh))


def tp_unshard(shards) -> TransformerParams:
    """The whole params from the TP shards of the model axis, in its
    order."""
    return TransformerParams(*unshard_leaves(
        [[getattr(s, f) for f in FIELDS] for s in shards],
        [TP_SPECS[f] for f in FIELDS]))


def fsdp_shard(params: TransformerParams, mesh: Mesh) -> TransformerParams:
    """The FSDP shards of the rank of ``mesh`` (``FSDP_SPECS`` over the
    data axis)."""
    return TransformerParams(*shard_leaves(
        [getattr(params, f) for f in FIELDS],
        [FSDP_SPECS[f] for f in FIELDS], mesh, axis=DATA_AXIS))


def fsdp_unshard(shards) -> TransformerParams:
    """The whole params from the FSDP shards of the data axis, in its
    order."""
    return TransformerParams(*unshard_leaves(
        [[getattr(s, f) for f in FIELDS] for s in shards],
        [FSDP_SPECS[f] for f in FIELDS]))


def _check_fsdp(params: TransformerParams, n: int,
                prefix: str = "") -> None:
    """JAX's divisibility check of ``FSDP_SPECS`` over ``n`` shards."""
    for f in FIELDS:
        dim = getattr(params, f).shape[FSDP_SPECS[f]]
        if dim % n:
            raise ValueError(f"{prefix}{f} dim {dim} not divisible by {n} "
                             "shards")


# -- the split TP block ---------------------------------------------------------

class TPComm:
    """Megatron's ``f`` and ``g`` on ``axis`` of the rank's ``mesh``, each
    as its forward and its transpose: ``f`` identity forward, all-reduce
    backward (``f_t``); ``g`` all-reduce forward, identity backward
    (``g_t``)."""

    def __init__(self, mesh: Mesh, axis: str = MODEL_AXIS):
        self.mesh, self.axis = mesh, axis

    def f(self, a):
        return a

    def f_t(self, da):
        return all_reduce(da, self.mesh, axis=self.axis)

    def g(self, o):
        return all_reduce(o, self.mesh, axis=self.axis)

    def g_t(self, do):
        return do


class SPComm(TPComm):
    """Sequence-parallel TP's ``f`` and ``g`` on token shards ``[b, T/n,
    d]``: ``f`` the all-gather of dim 1 (transpose: the reduce-scatter),
    ``g`` the reduce-scatter of dim 1 (transpose: the all-gather)."""

    def f(self, a):
        return all_gather(a, self.mesh, dim=1, axis=self.axis)

    def f_t(self, da):
        return reduce_scatter(da, self.mesh, dim=1, axis=self.axis)

    def g(self, o):
        return reduce_scatter(o, self.mesh, dim=1, axis=self.axis)

    def g_t(self, do):
        return all_gather(do, self.mesh, dim=1, axis=self.axis)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


class _Sublayer:
    """``x + g(core(*weights, f(layernorm(gain, x))))`` of one rank, split
    at ``f`` and ``g``: ``forward`` runs the two autograd pieces (the
    LayerNorm; the core) and the collectives between them; ``backward``
    runs the transposes from the calling thread and autograd over each
    piece, and returns ``(dx, dgain, dweights)``."""

    def __init__(self, comm: TPComm, core: Callable):
        self.comm, self.core, self.saved = comm, core, None

    def forward(self, gain, weights, x):
        x, gain = _leaf(x), _leaf(gain)
        weights = [_leaf(w) for w in weights]
        with torch.enable_grad():
            a = layernorm(gain, x)
        a_in = _leaf(self.comm.f(a.detach()))
        with torch.enable_grad():
            o = self.core(*weights, a_in)
        self.saved = (x, gain, weights, a, a_in, o)
        return x.detach() + self.comm.g(o.detach())

    def backward(self, dx_out):
        x, gain, weights, a, a_in, o = self.saved
        self.saved = None
        da_in, *dweights = torch.autograd.grad(o, [a_in, *weights],
                                               self.comm.g_t(dx_out))
        dx, dgain = torch.autograd.grad(a, [x, gain], self.comm.f_t(da_in))
        return dx_out + dx, dgain, dweights


def _ffn_core(w1, w2, a):
    return ffn_block(w1, w2, a.reshape(-1, a.shape[-1])).reshape(a.shape)


class _Block:
    """One TP transformer block of one rank, JAX's ``tp_block`` (or
    ``sp_block`` under ``SPComm``) with its backward: the attention
    sublayer on the rank's ``h_local`` heads, then the FFN sublayer on
    its features."""

    def __init__(self, comm: TPComm, h_local: int, causal: bool, attn):
        def attn_core(wq, wk, wv, wo, a):
            return attn_sublayer(wq, wk, wv, wo, a, h_local, causal, attn)

        self.attn = _Sublayer(comm, attn_core)
        self.ffn = _Sublayer(comm, _ffn_core)

    def forward(self, layer, x):
        ln1, wq, wk, wv, wo, ln2, w1, w2 = layer
        x = self.attn.forward(ln1, (wq, wk, wv, wo), x)
        return self.ffn.forward(ln2, (w1, w2), x)

    def backward(self, dx):
        """``(dx, grads of the layer in FIELDS order)``."""
        dx, dln2, (dw1, dw2) = self.ffn.backward(dx)
        dx, dln1, (dwq, dwk, dwv, dwo) = self.attn.backward(dx)
        return dx, [dln1, dwq, dwk, dwv, dwo, dln2, dw1, dw2]


def blocks_forward(params: TransformerParams, x: torch.Tensor, h_local: int,
                   comm: TPComm, causal: bool = True, attn=None):
    """The rank's TP stack forward on ``x``: ``(y, blocks)``, ``blocks``
    holding what ``blocks_backward`` needs."""
    blocks = []
    for layer in zip(*(getattr(params, f).unbind(0) for f in FIELDS)):
        blocks.append(_Block(comm, h_local, causal, attn))
        x = blocks[-1].forward(layer, x)
    return x, blocks


def blocks_backward(blocks, dy: torch.Tensor):
    """``(dx, grads)`` of the stack from the cotangent ``dy`` of its
    output; ``grads`` stacked ``[L, ...]`` in FIELDS order."""
    grads = []
    for blk in reversed(blocks):
        dy, g = blk.backward(dy)
        grads.append(g)
    return dy, [torch.stack(gs[::-1]) for gs in zip(*grads)]


# -- the FSDP block stack ---------------------------------------------------------

def _gather_layer(shards: TransformerParams, l: int, mesh: Mesh,
                  mixed: bool) -> list:
    """Layer ``l``'s whole weights in FIELDS order, each gathered from the
    data axis's shards (under ``mixed`` each shard cast to bf16 first:
    half the bytes, the same values as gathering and then casting)."""
    return [all_gather(getattr(shards, f)[l].to(torch.bfloat16) if mixed
                       else getattr(shards, f)[l], mesh, dim=0,
                       axis=DATA_AXIS) for f in FIELDS]


def fsdp_blocks_forward(shards: TransformerParams, x: torch.Tensor,
                        n_heads: int, mesh: Mesh, causal: bool = True,
                        attn=None, mixed: bool = False):
    """The stack forward on the rank's FSDP shards: ``(y, inputs)``. Each
    layer is gathered, run without autograd and dropped; ``inputs`` holds
    each block's input, all ``fsdp_blocks_backward`` needs."""
    inputs = []
    for l in range(shards.n_layers):
        full = _gather_layer(shards, l, mesh, mixed)
        inputs.append(x)
        with torch.no_grad():
            x = transformer_block(*full, x, n_heads, causal, attn)
        del full
    return x, inputs


def fsdp_blocks_backward(shards: TransformerParams, inputs, dy, n_heads: int,
                         mesh: Mesh, causal: bool = True, attn=None,
                         mixed: bool = False):
    """``(dx, grads)`` of the stack from the cotangent ``dy`` of its
    output, top layer first: gather the layer again, recompute its block
    under autograd from the kept input, take ``dx`` and the whole weight
    gradients, and reduce-scatter each (in the shards' dtype, f32 under
    ``mixed``) onto the rank's shard. ``grads`` are the shards' gradients
    stacked ``[L, ...]`` in FIELDS order."""
    grads = []
    for l in reversed(range(shards.n_layers)):
        full = [_leaf(w) for w in _gather_layer(shards, l, mesh, mixed)]
        x = _leaf(inputs[l])
        with torch.enable_grad():
            y = transformer_block(*full, x, n_heads, causal, attn)
        dy, *dw = torch.autograd.grad(y, [x, *full], dy)
        del y, full
        grads.append([reduce_scatter(g.to(getattr(shards, f).dtype), mesh,
                                     dim=0, axis=DATA_AXIS)
                      for f, g in zip(FIELDS, dw)])
    return dy, [torch.stack(gs[::-1]) for gs in zip(*grads)]


# -- trainers -------------------------------------------------------------------

def _reshape_batch(seed, tokens: int, seq_len: int, model_size: int, dtype,
                   device, batch_fn: Callable = batch_from_seed):
    """The step's ``(x, dloss_dx)`` as ``[tokens / seq_len, seq_len, d]``."""
    x, dloss_dx = batch_fn(seed, tokens, model_size, dtype=dtype,
                           device=device)
    b = tokens // seq_len
    return (x.reshape(b, seq_len, model_size),
            dloss_dx.reshape(b, seq_len, model_size))


def transformer_grads(params: TransformerParams, x, dloss_dx, n_heads: int,
                      causal: bool = True, attn=None,
                      mixed: bool = False) -> list:
    """The gradients (FIELDS order) of the stack's VJP at ``dloss_dx`` for
    the batch ``x``, both ``[b, T, d]``: autograd over the hand VJPs.
    ``mixed`` (JAX ``_make_single_step``'s): the blocks run on a bf16 cast
    of the params and of ``x``, the cotangent enters in bf16, and the
    gradients come back f32 through the casts' backward."""
    leaves = [_leaf(t) for _, t in params.named_leaves()]
    with torch.enable_grad():
        p = TransformerParams(*(t.to(torch.bfloat16) if mixed else t
                                for t in leaves))
        y = transformer_fwd(p, x.to(torch.bfloat16) if mixed else x,
                            n_heads, causal, attn)
    return list(torch.autograd.grad(y, leaves, dloss_dx.to(y.dtype)))


def _make_single_step(tokens: int, model_size: int, seq_len: int,
                      n_heads: int, lr: float, causal: bool = True,
                      attn=None, batch_fn: Callable = batch_from_seed,
                      mixed: bool = False, *, mesh: Optional[Mesh] = None):
    """One step ``(params, seed) -> params``: the stack forward, its VJP
    at the batch's ``dloss_dx`` (``transformer_grads``), SGD in place.
    Given a rank's ``mesh`` (DDP), each gradient is summed over its data
    axis first, after autograd has returned."""
    def step(params: TransformerParams, seed) -> TransformerParams:
        x, dloss_dx = _reshape_batch(seed, tokens, seq_len, model_size,
                                     params.w1.dtype, params.w1.device,
                                     batch_fn)
        grads = transformer_grads(params, x, dloss_dx, n_heads, causal, attn,
                                  mixed)
        if mesh is not None:
            grads = [all_reduce(g, mesh, axis=DATA_AXIS) for g in grads]
        return sgd(params, grads, lr)

    return step


def train_transformer_single(params: TransformerParams, seeds,
                             batch_size: int, model_size: int, mesh=None,
                             lr: float = LR, *, seq_len: int, n_heads: int,
                             causal: bool = True,
                             attn_impl: str | None = None,
                             mixed: bool = False,
                             batch_fn: Callable = batch_from_seed,
                             on_step: Optional[Callable[[int], None]] = None
                             ) -> TransformerParams:
    """Train a copy of ``params`` over the seed schedule; ``batch_size`` is
    tokens a step, unfolded to ``[batch_size / seq_len, seq_len, d]`` for
    attention; ``mesh`` is ignored. ``batch_fn`` and ``on_step`` as
    ``train_single``'s. ``mixed`` runs the blocks in bf16 with f32 master
    params, gradients and update (``transformer_grads``)."""
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    step = _make_single_step(batch_size, model_size, seq_len, n_heads, lr,
                             causal, resolve_attn(attn_impl), batch_fn,
                             mixed)
    params = params.with_leaves([t.clone() for _, t in params.named_leaves()])
    for i, seed in enumerate(seeds):
        params = step(params, int(seed))
        if on_step is not None:
            on_step(i)
    return params


def tp_grads(params: TransformerParams, x, dloss_dx, h_local: int, *,
             mesh: Mesh, causal: bool = True, attn=None,
             sequence_parallel: bool = False) -> list:
    """The gradients (FIELDS order, stacked) of the rank's TP shards
    ``params`` for the batch ``x`` and the cotangent ``dloss_dx`` of the
    stack's output, both ``[b, T, d]`` whole; under
    ``sequence_parallel`` the rank takes its token block of both, and
    the LN gains' gradients, which saw that block only, are summed over
    the model axis."""
    if sequence_parallel:
        t_local = x.shape[1] // mesh.axis_size(MODEL_AXIS)
        r = axis_index(mesh, MODEL_AXIS)
        x, dloss_dx = (t[:, r * t_local:(r + 1) * t_local].contiguous()
                       for t in (x, dloss_dx))
    comm = (SPComm if sequence_parallel else TPComm)(mesh)
    _, blocks = blocks_forward(params, x, h_local, comm, causal, attn)
    grads = blocks_backward(blocks, dloss_dx)[1]
    if sequence_parallel:
        for i in (FIELDS.index("ln1"), FIELDS.index("ln2")):
            grads[i] = all_reduce(grads[i], mesh, axis=MODEL_AXIS)
    return grads


def make_tp_step(batch_size: int, model_size: int, seq_len: int,
                 h_local: int, n_shards: int, lr: float = LR,
                 causal: bool = True, attn=None,
                 sequence_parallel: bool = False, *, mesh: Mesh,
                 batch_fn: Callable = batch_from_seed,
                 data_axis: Optional[str] = None):
    """One TP step ``(shards, seed) -> shards`` for the rank of ``mesh``:
    the whole batch (its token block under ``sequence_parallel``), the
    split stack forward and backward, SGD on the shards in place. With
    ``data_axis`` (the hybrid) each gradient is then summed over that
    axis, DDP's reduction on the axis orthogonal to TP's."""
    if sequence_parallel and seq_len % n_shards:
        raise ValueError(f"seq_len={seq_len} not divisible by model-axis "
                         f"size {n_shards} (sequence-parallel TP shards "
                         "tokens)")

    def step(params: TransformerParams, seed) -> TransformerParams:
        x, dloss_dx = _reshape_batch(seed, batch_size, seq_len, model_size,
                                     params.w1.dtype, params.w1.device,
                                     batch_fn)
        grads = tp_grads(params, x, dloss_dx, h_local, mesh=mesh,
                         causal=causal, attn=attn,
                         sequence_parallel=sequence_parallel)
        if data_axis is not None:
            grads = [all_reduce(g, mesh, axis=data_axis) for g in grads]
        return sgd(params, grads, lr)

    return step


def train_transformer_tp(params: TransformerParams, seeds, batch_size: int,
                         model_size: int, mesh: Mesh, lr: float = LR, *,
                         seq_len: int, n_heads: int, causal: bool = True,
                         attn_impl: str | None = None,
                         sequence_parallel: bool = False,
                         batch_fn: Callable = batch_from_seed,
                         on_step: Optional[Callable[[int], None]] = None,
                         timeout: float = DEFAULT_TIMEOUT_S
                         ) -> TransformerParams:
    """Megatron TP over the model axis: data replicated (every rank takes
    every seed), heads and FFN features sharded, two all-reduces a block
    a direction; ``sequence_parallel`` the token-sharded form. So it takes
    the steps ``train_transformer_single`` takes and must agree with it.
    Given the whole mesh it launches the ranks and returns the whole
    params on the device of ``params``; given a rank's view it runs that
    rank and returns its shards (``tp_unshard`` joins them)."""
    require_axes(mesh, MODEL_AXIS)
    n = mesh.axis_size(MODEL_AXIS)
    h_local = _validate_tp(params, n_heads, n)
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    attn = resolve_attn(attn_impl)
    if sequence_parallel and seq_len % n:
        raise ValueError(f"seq_len={seq_len} not divisible by model-axis "
                         f"size {n} (sequence-parallel TP shards tokens)")
    if not mesh.in_rank:
        shards = launch_replicated(
            _transformer_tp_rank, params, seeds, mesh, batch_size,
            model_size, lr, dict(seq_len=seq_len, n_heads=n_heads,
                                 causal=causal, attn_impl=attn_impl,
                                 sequence_parallel=sequence_parallel,
                                 batch_fn=batch_fn), timeout=timeout)
        out = tp_unshard(shards)
        return out.with_leaves([t.to(params.w1.device)
                                for _, t in out.named_leaves()])
    step = make_tp_step(batch_size, model_size, seq_len, h_local, n, lr,
                        causal, attn, sequence_parallel, mesh=mesh,
                        batch_fn=batch_fn)
    return run_replicated(step, tp_shard(params, mesh), seeds, mesh, on_step)


def _transformer_tp_rank(mesh: Mesh, payload):
    params, seeds, batch_size, model_size, lr, kw = payload
    out = train_transformer_tp(params, seeds, batch_size, model_size, mesh,
                               lr, **kw)
    return out.with_leaves([t.cpu() for _, t in out.named_leaves()])


def train_transformer_ddp(params: TransformerParams, seeds, batch_size: int,
                          model_size: int, mesh: Mesh, lr: float = LR, *,
                          seq_len: int, n_heads: int, causal: bool = True,
                          attn_impl: str | None = None,
                          batch_fn: Callable = batch_from_seed,
                          on_step: Optional[Callable[[int], None]] = None,
                          timeout: float = DEFAULT_TIMEOUT_S
                          ) -> TransformerParams:
    """DDP over the data axis: every rank holds the whole stack, takes its
    column of the strided seeds (``seeds[t * n + r]`` at step ``t``), runs
    the single-device VJP and sums each gradient over the axis (SUM, the
    unscaled LR) before SGD. Given the whole mesh it launches the ranks
    and returns rank 0's params on the device of ``params``; given a
    rank's view it runs that rank and returns its replica.
    ``batch_fn`` and ``on_step`` as ``train_transformer_single``'s."""
    require_axes(mesh, DATA_AXIS)
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    attn = resolve_attn(attn_impl)
    kw = dict(seq_len=seq_len, n_heads=n_heads, causal=causal,
              attn_impl=attn_impl, batch_fn=batch_fn)
    if not mesh.in_rank:
        outs = launch_strided(_transformer_dp_rank, params, seeds, mesh,
                              batch_size, model_size, lr,
                              ("ddp", kw), timeout=timeout)
        return to_device(outs[0], params.w1.device)
    step = _make_single_step(batch_size, model_size, seq_len, n_heads, lr,
                             causal, attn, batch_fn, mesh=mesh)
    local = params.with_leaves([t.to(mesh.torch_device, copy=True)
                                for _, t in params.named_leaves()])
    return run_strided(step, local, seeds, mesh, on_step)


def train_transformer_fsdp(params: TransformerParams, seeds,
                           batch_size: int, model_size: int, mesh: Mesh,
                           lr: float = LR, *, seq_len: int, n_heads: int,
                           causal: bool = True,
                           attn_impl: str | None = None,
                           batch_fn: Callable = batch_from_seed,
                           on_step: Optional[Callable[[int], None]] = None,
                           timeout: float = DEFAULT_TIMEOUT_S
                           ) -> TransformerParams:
    """FSDP/ZeRO-3 over the data axis: the seeds strided as DDP's, every
    stacked leaf sharded on dim 1 (``FSDP_SPECS``), each layer gathered in
    the forward and again in the backward, its gradients reduce-scattered
    onto the shards (``fsdp_blocks_forward``/``_backward``), SGD on the
    shards. The backward recomputes each block, so under flash a step
    launches ``flash_attn_fwd`` twice a layer (once a layer under DDP) and
    the backward's kernels once. Given the whole mesh it returns the whole
    params re-assembled from the shards on the device of ``params``;
    given a rank's view, that rank's shards (``fsdp_unshard`` joins
    them)."""
    require_axes(mesh, DATA_AXIS)
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    _check_fsdp(params, mesh.axis_size(DATA_AXIS))
    attn = resolve_attn(attn_impl)
    kw = dict(seq_len=seq_len, n_heads=n_heads, causal=causal,
              attn_impl=attn_impl, batch_fn=batch_fn)
    if not mesh.in_rank:
        outs = launch_strided(_transformer_dp_rank, params, seeds, mesh,
                              batch_size, model_size, lr,
                              ("fsdp", kw), timeout=timeout)
        return to_device(fsdp_unshard(outs), params.w1.device)

    def step(shards: TransformerParams, seed) -> TransformerParams:
        x, dloss_dx = _reshape_batch(seed, batch_size, seq_len, model_size,
                                     shards.w1.dtype, shards.w1.device,
                                     batch_fn)
        _, inputs = fsdp_blocks_forward(shards, x, n_heads, mesh, causal,
                                        attn)
        grads = fsdp_blocks_backward(shards, inputs, dloss_dx, n_heads, mesh,
                                     causal, attn)[1]
        return sgd(shards, grads, lr)

    return run_strided(step, fsdp_shard(params, mesh), seeds, mesh, on_step)


def train_transformer_hybrid(params: TransformerParams, seeds,
                             batch_size: int, model_size: int, mesh: Mesh,
                             lr: float = LR, *, seq_len: int, n_heads: int,
                             causal: bool = True,
                             attn_impl: str | None = None,
                             batch_fn: Callable = batch_from_seed,
                             on_step: Optional[Callable[[int], None]] = None,
                             timeout: float = DEFAULT_TIMEOUT_S
                             ) -> TransformerParams:
    """The DDP x TP hybrid on a data x model mesh: TP's split blocks and
    their all-reduces on the model axis (``tp_grads``), then each
    gradient summed over the data axis; the params TP-sharded over the
    model axis and replicated over the data axis; the seeds strided over
    the data axis only (``train_ffns.py:182``). Given the whole mesh it
    returns the whole params from the ranks of data index 0; given a
    rank's view, that rank's TP shards."""
    require_axes(mesh, DATA_AXIS, MODEL_AXIS)
    n = mesh.axis_size(MODEL_AXIS)
    h_local = _validate_tp(params, n_heads, n)
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    attn = resolve_attn(attn_impl)
    kw = dict(seq_len=seq_len, n_heads=n_heads, causal=causal,
              attn_impl=attn_impl, batch_fn=batch_fn)
    if not mesh.in_rank:
        outs = launch_strided(_transformer_dp_rank, params, seeds, mesh,
                              batch_size, model_size, lr, ("hybrid", kw),
                              axis=DATA_AXIS, timeout=timeout)
        return to_device(tp_unshard([o for r, o in enumerate(outs)
                                     if mesh.coords(r)[DATA_AXIS] == 0]),
                         params.w1.device)
    step = make_tp_step(batch_size, model_size, seq_len, h_local, n, lr,
                        causal, attn, mesh=mesh, batch_fn=batch_fn,
                        data_axis=DATA_AXIS)
    return run_strided(step, tp_shard(params, mesh), seeds, mesh, on_step,
                       axis=DATA_AXIS)


def train_transformer_seq(params: TransformerParams, seeds, batch_size: int,
                          model_size: int, mesh: Mesh, lr: float = LR, *,
                          seq_len: int, n_heads: int, causal: bool = True,
                          seq_impl: str = "ring",
                          batch_fn: Callable = batch_from_seed,
                          on_step: Optional[Callable[[int], None]] = None,
                          timeout: float = DEFAULT_TIMEOUT_S
                          ) -> TransformerParams:
    """Long-context training (JAX ``train_transformer_seq``): the sequence
    sharded over the seq axis, attention across the ranks by the ring or
    Ulysses (``seq_impl``, ``parallel/sequence.py``), everything else on
    the rank's own ``T/n`` tokens. Every seq rank makes the step's whole
    batch from the seed and takes its own token block, so the global
    causal positions are exact. The weight gradients are partial sums over
    the rank's tokens, summed by one all-reduce over the mesh, then SGD at
    the unscaled LR. On a data x seq mesh the seeds are strided over the
    data axis (each data row trains its own steps, DDP's) and the sum
    spans both axes. So the seq mesh alone takes the steps of
    ``train_transformer_single`` and data x seq those of
    ``train_transformer_ddp`` over the data axis. Given the whole mesh it
    returns rank 0's params (every rank holds the same) on the device of
    ``params``; given a rank's view, that rank's."""
    require_axes(mesh, SEQ_AXIS)
    n = mesh.axis_size(SEQ_AXIS)
    dp = mesh.shape.get(DATA_AXIS, 1)
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    check_mha(params)
    op = resolve_seq_attn(seq_impl, n, n_heads, seq_len)
    if not mesh.in_rank:
        kw = dict(seq_len=seq_len, n_heads=n_heads, causal=causal,
                  seq_impl=seq_impl, batch_fn=batch_fn)
        args = (_transformer_dp_rank, params, seeds, mesh, batch_size,
                model_size, lr, ("seq", kw))
        outs = (launch_strided(*args, axis=DATA_AXIS, timeout=timeout)
                if dp > 1 else launch_replicated(*args, timeout=timeout))
        return to_device(outs[0], params.w1.device)
    t_local = seq_len // n
    r = axis_index(mesh, SEQ_AXIS)

    def step(params: TransformerParams, seed) -> TransformerParams:
        x, dloss_dx = (t[:, r * t_local:(r + 1) * t_local].contiguous()
                       for t in _reshape_batch(seed, batch_size, seq_len,
                                               model_size, params.w1.dtype,
                                               params.w1.device, batch_fn))
        _, blocks = seq_blocks_forward(params, x, n_heads, op, mesh, causal)
        grads = seq_blocks_backward(blocks, dloss_dx)[1]
        return sgd(params, sum_grads(grads, mesh), lr)

    local = params.with_leaves([t.to(mesh.torch_device, copy=True)
                                for _, t in params.named_leaves()])
    if dp > 1:
        return run_strided(step, local, seeds, mesh, on_step, axis=DATA_AXIS)
    return run_replicated(step, local, seeds, mesh, on_step)


_DP_TRAINERS = {"ddp": train_transformer_ddp, "fsdp": train_transformer_fsdp,
                "hybrid": train_transformer_hybrid,
                "seq": train_transformer_seq}


def _transformer_dp_rank(mesh: Mesh, payload):
    """One rank of a whole-mesh DDP, FSDP, hybrid or sequence-parallel
    run: its shards on the CPU (DDP, seq: rank 0's replica alone)."""
    params, seeds, batch_size, model_size, lr, (kind, kw) = payload
    out = _DP_TRAINERS[kind](params, seeds, batch_size, model_size, mesh, lr,
                             **kw)
    if kind in ("ddp", "seq") and mesh.rank:
        return None
    return to_device(out, "cpu")
