"""Transformer trainers, as in the JAX package's ``parallel/transformer.py``:
the single-device trainer and Megatron tensor parallelism of the pre-LN
block stack (``models/transformer.py``), plain and sequence-parallel, and
what the LM trainers share with them (the shape checks, the ``attn_impl``
switch, the TP layout and the split TP block).

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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import LR
from ..data import batch_from_seed
from ..models.transformer import (FIELDS, TransformerParams, attn_sublayer,
                                  transformer_fwd)
from ..ops.ffn import ffn_block
from ..ops.norm import layernorm
from ..optim import sgd
from .collectives import all_gather, all_reduce, axis_index, reduce_scatter
from .launcher import (DEFAULT_TIMEOUT_S, launch_replicated,
                       refuse_unported, run_replicated)
from .mesh import MODEL_AXIS, Mesh, require_axes

# TP layout: the model-axis dim of each stacked leaf in FIELDS order
# (column-parallel projections shard their output dim, row-parallel their
# input dim), None where the leaf is replicated (JAX's TP_SPECS)
TP_SPECS = dict(ln1=None, wq=1, wk=1, wv=1, wo=2, ln2=None, w1=1, w2=2)


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


# -- trainers -------------------------------------------------------------------

def _reshape_batch(seed, tokens: int, seq_len: int, model_size: int, dtype,
                   device, batch_fn: Callable = batch_from_seed):
    """The step's ``(x, dloss_dx)`` as ``[tokens / seq_len, seq_len, d]``."""
    x, dloss_dx = batch_fn(seed, tokens, model_size, dtype=dtype,
                           device=device)
    b = tokens // seq_len
    return (x.reshape(b, seq_len, model_size),
            dloss_dx.reshape(b, seq_len, model_size))


def _make_single_step(tokens: int, model_size: int, seq_len: int,
                      n_heads: int, lr: float, causal: bool = True,
                      attn=None, batch_fn: Callable = batch_from_seed):
    """One single-device step ``(params, seed) -> params``: the stack
    forward, its VJP at the batch's ``dloss_dx`` (autograd over the hand
    VJPs), SGD in place."""
    def step(params: TransformerParams, seed) -> TransformerParams:
        x, dloss_dx = _reshape_batch(seed, tokens, seq_len, model_size,
                                     params.w1.dtype, params.w1.device,
                                     batch_fn)
        leaves = [_leaf(t) for _, t in params.named_leaves()]
        with torch.enable_grad():
            y = transformer_fwd(TransformerParams(*leaves), x, n_heads,
                                causal, attn)
        return sgd(params, torch.autograd.grad(y, leaves, dloss_dx), lr)

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
    ``train_single``'s. ``mixed`` is not ported yet."""
    refuse_unported(mixed=(mixed, False))
    _validate_shapes(batch_size, seq_len, model_size, n_heads)
    step = _make_single_step(batch_size, model_size, seq_len, n_heads, lr,
                             causal, resolve_attn(attn_impl), batch_fn)
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
                 batch_fn: Callable = batch_from_seed):
    """One TP step ``(shards, seed) -> shards`` for the rank of ``mesh``:
    the whole batch (its token block under ``sequence_parallel``), the
    split stack forward and backward, SGD on the shards in place."""
    if sequence_parallel and seq_len % n_shards:
        raise ValueError(f"seq_len={seq_len} not divisible by model-axis "
                         f"size {n_shards} (sequence-parallel TP shards "
                         "tokens)")

    def step(params: TransformerParams, seed) -> TransformerParams:
        x, dloss_dx = _reshape_batch(seed, batch_size, seq_len, model_size,
                                     params.w1.dtype, params.w1.device,
                                     batch_fn)
        return sgd(params, tp_grads(params, x, dloss_dx, h_local, mesh=mesh,
                                    causal=causal, attn=attn,
                                    sequence_parallel=sequence_parallel), lr)

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
