"""Sequence parallelism, as in the JAX package's ``parallel/sequence.py``:
ring attention and Ulysses over the ``"seq"`` axis, and the split
attention block the sequence-parallel trainers run
(``train_transformer_seq``, ``train_lm_seq``).

The sequence is sharded over the seq axis: rank r holds tokens ``[r T/n,
(r+1) T/n)``. Everything token-pointwise runs on the rank's own block;
only attention crosses ranks.

**Ring attention**: each rank keeps its Q block and passes its K/V block
round the ring (``collectives.ppermute``, the port of JAX's ``_hop``): at
step i it holds the block of rank ``(r - i) mod n``. The plain ring folds
each held block into a running online softmax (row max ``m``,
denominator ``l``, numerator ``acc``, all f32). The flash ring runs the
flash kernels on each held block instead (``ops/flash_attention.py``),
one launch a hop over every batch element and head, and merges the
partial ``(y_j, lse_j)`` pairs by a stable logsumexp. Under the causal
mask a hop is one of three cases (``_hop_case``): an earlier block runs
the non-causal kernel, the diagonal block the causal one (equal offsets
make the local mask the global one), and a later block is skipped.

The backward is a second ring, written by hand: the forward keeps only
``(q, k, v, y, lse)``. ``(k, v, dk, dv)`` travel together and ``dq``
stays at home, all three accumulated in f32, so every K/V block comes
home with its whole gradient after n hops. The flash backward of each
hop is handed the GLOBAL ``y`` and ``lse`` (and so the global ``D =
rowsum(dy * y)``), never those of its hop's own forward: its probability
tiles ``exp(s - lse)`` are then the ones of the whole row.

**Ulysses**: two all-to-alls trade heads for sequence. The first gives
each rank the whole sequence of ``H/n`` heads; local attention (the
hand-VJP ``mha`` or the flash kernels) runs there; the second trades
back. ``comm="psum"`` exchanges on ``torch.distributed``
(``collectives.all_to_all``), ``comm="pallas_a2a"`` on the all-to-all
kernel (``ops.ring.all_to_all_dma_dims``).

Every collective runs from the rank's own thread: the backwards here are
functions a trainer calls, not ``autograd.Function`` backwards. PyTorch
runs every CUDA backward of a card on one thread, so a loopback rank
that blocked there would stop the others. ``SeqBlock`` splits the
attention sublayer accordingly: autograd covers the LayerNorm and the
q, k, v projections, the sequence-parallel attention and its backward
run from the thread, and autograd covers ``wo``, the residual add and
the FFN sublayer (which holds no collective).

The functions take ``[..., T_local, dh]`` (the ring) or ``[..., H,
T_local, dh]`` (Ulysses) with any leading dims, where the JAX package
``vmap``s a single head, and a rank's view of the mesh with the ``axis``
they run along.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..models.attention import causal_mask
from ..models.transformer import FIELDS, merge_heads, split_heads
from ..ops import flash_attention as fa
from ..ops.ffn import ffn_block
from ..ops.norm import layernorm
from ..ops.ring import all_to_all_dma_dims
from .collectives import all_reduce, all_to_all, ppermute
from .launcher import launch
from .mesh import SEQ_AXIS, require_axes

_NEG = -1e30   # the finite -inf of the masks and of an empty hop's lse
FULL, DIAG, SKIP = 0, 1, 2   # the hop cases (_hop_case)


def _scale(d: int, device) -> torch.Tensor:
    """``1 / sqrt(d)`` in f32, as JAX computes it."""
    return torch.tensor(d, dtype=torch.float32, device=device).sqrt() \
        .reciprocal()


def _hop_case(i: int, rank: int, n: int, causal: bool) -> int:
    """Which program runs for the block held at step ``i``, that of rank
    ``src = (rank - i) % n``: ``FULL`` (src strictly earlier, or no
    mask), ``DIAG`` (the diagonal block) or ``SKIP`` (src later: fully
    masked)."""
    if not causal:
        return FULL
    src = (rank - i) % n
    return DIAG if src == rank else FULL if src < rank else SKIP


def _scores(q, k_blk, scale, causal: bool, rank: int, src: int):
    """The f32 scores of the rank's Q block against the held block, masked
    to -1e30 on global positions under ``causal``."""
    s = (q @ k_blk.transpose(-1, -2)).float() * scale
    if causal:
        t = q.shape[-2]
        keep = causal_mask(t, t, rank * t, device=q.device,
                           k_offset=src * t)
        s = torch.where(keep, s, torch.full((), _NEG, device=s.device))
    return s


# -- the ring -----------------------------------------------------------------

def _ring_fwd_plain(q, k, v, mesh, axis: str, causal: bool):
    """The plain ring (JAX ``_ring_fwd_core``): ``(y, lse)`` with ``lse``
    the logsumexp of each whole masked row."""
    n, rank = mesh.axis_size(axis), mesh.axis_index(axis)
    scale = _scale(q.shape[-1], q.device)
    m = torch.full(q.shape[:-1], _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        s = _scores(q, k_blk, scale, causal, rank, (rank - i) % n)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)            # rescales the old sums
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ v_blk.float()
        m = m_new
        if i < n - 1:      # JAX's last hop only brings the block home
            k_blk, v_blk = ppermute(k_blk, mesh, axis=axis), \
                ppermute(v_blk, mesh, axis=axis)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def _ring_bwd_plain(q, k, v, y, lse, dy, mesh, axis: str, causal: bool):
    """The plain backward ring (JAX ``_ring_attention_bwd``): per held
    block j, ``p = exp(s - lse)``, ``dv_j += p^T dy``, ``ds = p (dy v_j^T -
    delta)`` with ``delta = rowsum(dy * y)``, ``dq += ds k_j * scale``,
    ``dk_j += ds^T q * scale``."""
    n, rank = mesh.axis_size(axis), mesh.axis_index(axis)
    scale = _scale(q.shape[-1], q.device)
    dy32, q32 = dy.float(), q.float()
    delta = (dy32 * y.float()).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    k_blk, v_blk = k, v
    for i in range(n):
        s = _scores(q, k_blk, scale, causal, rank, (rank - i) % n)
        p = torch.exp(s - lse[..., None])       # masked entries give 0
        dv = dv + p.transpose(-1, -2) @ dy32
        ds = p * (dy32 @ v_blk.float().transpose(-1, -2) - delta[..., None])
        dq = dq + (ds @ k_blk.float()) * scale
        dk = dk + (ds.transpose(-1, -2) @ q32) * scale
        if i < n - 1:
            k_blk, v_blk = ppermute(k_blk, mesh, axis=axis), \
                ppermute(v_blk, mesh, axis=axis)
        dk, dv = ppermute(dk, mesh, axis=axis), ppermute(dv, mesh, axis=axis)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _ring_fwd_flash(q, k, v, mesh, axis: str, causal: bool):
    """The flash ring (JAX ``_ring_fwd_flash``): each held block through
    the flash forward (``_hop_case``'s kernel mode), the partials merged
    by the stable two-way logsumexp, ``y`` rounded to ``q``'s dtype after
    every merge; a skipped hop merges ``(0, -1e30)``."""
    n, rank = mesh.axis_size(axis), mesh.axis_index(axis)
    y_run = torch.zeros_like(q)
    lse_run = torch.full(q.shape[:-1], _NEG, dtype=torch.float32,
                         device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        case = _hop_case(i, rank, n, causal)
        if case == SKIP:
            y_j, lse_j = torch.zeros_like(q), torch.full_like(lse_run, _NEG)
        else:
            y_j, lse_j = fa.flash_attention_fwd(q, k_blk, v_blk,
                                                causal=case == DIAG)
        m = torch.maximum(lse_run, lse_j)
        w_run, w_j = torch.exp(lse_run - m), torch.exp(lse_j - m)
        denom = w_run + w_j
        y_run = ((y_run.float() * w_run[..., None]
                  + y_j.float() * w_j[..., None]) / denom[..., None]) \
            .to(q.dtype)
        lse_run = m + torch.log(denom)
        if i < n - 1:
            k_blk, v_blk = ppermute(k_blk, mesh, axis=axis), \
                ppermute(v_blk, mesh, axis=axis)
    return y_run, lse_run


def _ring_bwd_flash(q, k, v, y, lse, dy, mesh, axis: str, causal: bool):
    """The flash backward ring (JAX ``_ring_bwd_flash``): each held block
    through the flash backward against the global ``y`` and ``lse``; each
    hop's gradients widened to f32 before they are added (a skipped hop
    adds nothing)."""
    n, rank = mesh.axis_size(axis), mesh.axis_index(axis)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    k_blk, v_blk = k, v
    for i in range(n):
        case = _hop_case(i, rank, n, causal)
        if case != SKIP:
            dq_j, dk_j, dv_j = fa.flash_attention_bwd(
                dy, q, k_blk, v_blk, y, lse, causal=case == DIAG)
            dq, dk, dv = dq + dq_j.float(), dk + dk_j.float(), \
                dv + dv_j.float()
        if i < n - 1:
            k_blk, v_blk = ppermute(k_blk, mesh, axis=axis), \
                ppermute(v_blk, mesh, axis=axis)
        dk, dv = ppermute(dk, mesh, axis=axis), ppermute(dv, mesh, axis=axis)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _ring_impl(attn_impl: Optional[str]) -> bool:
    """Whether the ring runs the flash kernels (``"flash"``) or the plain
    block compute (None or ``"oracle"``)."""
    if attn_impl not in (None, "oracle", "flash"):
        raise ValueError(f"unknown attn_impl {attn_impl!r} for the ring "
                         "(expected 'oracle' or 'flash')")
    return attn_impl == "flash"


def ring_attention_fwd(q, k, v, mesh, axis: str = SEQ_AXIS,
                       causal: bool = True,
                       attn_impl: Optional[str] = None):
    """``(y, lse)`` of the rank's Q block ``q [..., T_local, dh]`` over the
    whole sequence, whose K/V blocks ``k, v`` the ranks of ``axis`` hold
    in order; ``lse [..., T_local]`` f32. ``attn_impl="flash"`` runs the
    flash kernels on each hop."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    if _ring_impl(attn_impl):
        return _ring_fwd_flash(q, k, v, mesh, axis, causal)
    return _ring_fwd_plain(q, k, v, mesh, axis, causal)


def ring_attention_bwd(q, k, v, y, lse, dy, mesh, axis: str = SEQ_AXIS,
                       causal: bool = True,
                       attn_impl: Optional[str] = None):
    """``(dq, dk, dv)`` of ``ring_attention_fwd`` at the cotangent ``dy``
    from its residuals ``(q, k, v, y, lse)``: the second ring."""
    q, k, v, y, dy = (t.contiguous() for t in (q, k, v, y, dy))
    if _ring_impl(attn_impl):
        return _ring_bwd_flash(q, k, v, y, lse, dy, mesh, axis, causal)
    return _ring_bwd_plain(q, k, v, y, lse, dy, mesh, axis, causal)


def ring_attention(q, k, v, mesh, axis: str = SEQ_AXIS, causal: bool = True,
                   attn_impl: Optional[str] = None) -> torch.Tensor:
    """Ring attention of one rank (JAX ``ring_attention``): ``y [...,
    T_local, dh]`` as if computed over the whole sequence. Its gradients
    are ``ring_attention_bwd``'s, called from the rank's thread."""
    return ring_attention_fwd(q, k, v, mesh, axis, causal, attn_impl)[0]


# -- Ulysses ------------------------------------------------------------------

def _a2a(mesh, axis: str, comm: str):
    """The tiled all-to-all ``(t, split_dim, concat_dim) -> t`` of
    ``comm``."""
    if comm == "pallas_a2a":
        if mesh.axis_size(axis) != mesh.size:
            raise ValueError("comm='pallas_a2a' runs over a mesh of the seq "
                             "axis alone (the kernel's ring spans the mesh)")
        return lambda t, s, c: all_to_all_dma_dims(t, mesh, s, c)
    if comm == "psum":
        return lambda t, s, c: all_to_all(t, mesh, split_dim=s,
                                          concat_dim=c, axis=axis)
    raise ValueError(f"unknown comm {comm!r} (expected 'psum' or "
                     "'pallas_a2a')")


def ulysses_attention_fwd(q, k, v, mesh, axis: str = SEQ_AXIS,
                          causal: bool = True, attn=None,
                          comm: str = "psum"):
    """``(y, residuals)`` of Ulysses on the rank's ``[..., H, T_local,
    dh]`` blocks: heads to sequence (dim -3 split, dim -2 joined), the
    local multi-head op ``attn`` (None: the hand-VJP ``mha``; the flash
    kernels' ``flash_mha``) on ``[..., H/n, T, dh]`` under autograd, and
    back. The residuals hold the local op's inputs and output, all
    ``ulysses_attention_bwd`` needs."""
    from ..models.attention import mha
    a2a = _a2a(mesh, axis, comm)
    if q.shape[-3] % mesh.axis_size(axis):
        raise ValueError(f"n_heads={q.shape[-3]} not divisible by seq-axis "
                         f"size {mesh.axis_size(axis)} (Ulysses scatters "
                         "heads)")
    full = [a2a(t, -3, -2).detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        y_full = (mha if attn is None else attn)(*full, causal)
    return a2a(y_full.detach(), -2, -3), (*full, y_full)


def ulysses_attention_bwd(residuals, dy, mesh, axis: str = SEQ_AXIS,
                          comm: str = "psum"):
    """``(dq, dk, dv)`` of ``ulysses_attention_fwd`` at ``dy``: the
    transpose of each exchange is the exchange with the dims swapped."""
    a2a = _a2a(mesh, axis, comm)
    *full, y_full = residuals
    grads = torch.autograd.grad(y_full, full, a2a(dy.contiguous(), -3, -2))
    return tuple(a2a(g, -2, -3) for g in grads)


def ulysses_attention(q, k, v, mesh, axis: str = SEQ_AXIS,
                      causal: bool = True, attn=None,
                      comm: str = "psum") -> torch.Tensor:
    """Ulysses attention of one rank (JAX ``ulysses_attention``): ``[...,
    H, T_local, dh]`` in and out, exact whole-sequence attention. Its
    gradients are ``ulysses_attention_bwd``'s."""
    return ulysses_attention_fwd(q, k, v, mesh, axis, causal, attn, comm)[0]


# -- the op the trainers run --------------------------------------------------

@dataclass(frozen=True)
class SeqAttention:
    """The sequence-parallel multi-head attention of a trainer (JAX
    ``resolve_seq_attn``'s op): ``forward(q, k, v, causal, mesh) -> (y,
    residuals)`` on ``[B, H, T_local, dh]`` and ``backward(residuals, dy,
    causal, mesh) -> (dq, dk, dv)``, both from the rank's thread."""
    seq_impl: str
    axis: str = SEQ_AXIS
    attn_impl: Optional[str] = None

    def forward(self, q, k, v, causal: bool, mesh):
        if self.seq_impl == "ring":
            y, lse = ring_attention_fwd(q, k, v, mesh, self.axis, causal,
                                        self.attn_impl)
            return y, (q, k, v, y, lse)
        from .transformer import resolve_attn
        return ulysses_attention_fwd(q, k, v, mesh, self.axis, causal,
                                     resolve_attn(self.attn_impl))

    def backward(self, residuals, dy, causal: bool, mesh):
        if self.seq_impl == "ring":
            return ring_attention_bwd(*residuals, dy, mesh, self.axis,
                                      causal, self.attn_impl)
        return ulysses_attention_bwd(residuals, dy, mesh, self.axis)


def resolve_seq_attn(seq_impl: str, n: int, n_heads: int, seq_len: int,
                     axis: str = SEQ_AXIS,
                     attn_impl: Optional[str] = None) -> SeqAttention:
    """The shared dispatch of the sequence-parallel trainers (JAX
    ``resolve_seq_attn``): checks that the sequence (and, under Ulysses,
    the heads) split over the ``n`` ranks of ``axis`` and returns the
    ring's or Ulysses' ``SeqAttention``. As JAX's, it passes no ``comm``:
    Ulysses runs on ``psum``."""
    if seq_len % n:
        raise ValueError(f"seq_len={seq_len} not divisible by seq-axis "
                         f"size {n}")
    if seq_impl == "ring":
        _ring_impl(attn_impl)
    elif seq_impl == "ulysses":
        from .transformer import resolve_attn
        if n_heads % n:
            raise ValueError(f"n_heads={n_heads} not divisible by "
                             f"seq-axis size {n} (Ulysses scatters heads)")
        resolve_attn(attn_impl)
    else:
        raise ValueError(f"unknown seq_impl {seq_impl!r} "
                         "(expected 'ring' or 'ulysses')")
    return SeqAttention(seq_impl, axis, attn_impl)


# -- the split block ----------------------------------------------------------

def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


class SeqBlock:
    """One pre-LN transformer block of one rank on its token block ``[B,
    T_local, d]`` (JAX ``transformer_block`` under a sequence-parallel
    ``attn``), split at the attention: ``forward`` runs autograd over the
    LayerNorm and the q, k, v projections, ``op``'s forward from the
    calling thread, then autograd over ``wo``, the residual add and the
    FFN sublayer; ``backward`` runs autograd back to the attention
    output, ``op``'s backward from the calling thread and autograd over
    the projections, and returns ``(dx, grads in FIELDS order)``."""

    def __init__(self, op: SeqAttention, mesh, n_heads: int, causal: bool):
        self.op, self.mesh, self.n_heads, self.causal = (op, mesh, n_heads,
                                                         causal)
        self.saved = None

    def forward(self, layer, x):
        x = _leaf(x)
        ln1, wq, wk, wv, wo, ln2, w1, w2 = ws = [_leaf(w) for w in layer]
        with torch.enable_grad():
            a = layernorm(ln1, x)
            qkv = [split_heads(a @ w.T, self.n_heads) for w in (wq, wk, wv)]
        y, res = self.op.forward(*(t.detach().contiguous() for t in qkv),
                                 self.causal, self.mesh)
        y = _leaf(y)
        with torch.enable_grad():
            x1 = x + merge_heads(y) @ wo.T
            b, s, d = x1.shape
            f = layernorm(ln2, x1).reshape(b * s, d)
            out = x1 + ffn_block(w1, w2, f).reshape(b, s, d)
        self.saved = (x, ws, qkv, y, res, out)
        return out.detach()

    def backward(self, dout):
        x, ws, qkv, y, res, out = self.saved
        self.saved = None
        ln1, wq, wk, wv, wo, ln2, w1, w2 = ws
        dy, dx_res, dwo, dln2, dw1, dw2 = torch.autograd.grad(
            out, [y, x, wo, ln2, w1, w2], dout)
        dqkv = self.op.backward(res, dy, self.causal, self.mesh)
        dx, dln1, dwq, dwk, dwv = torch.autograd.grad(
            qkv, [x, ln1, wq, wk, wv], dqkv)
        return dx_res + dx, [dln1, dwq, dwk, dwv, dwo, dln2, dw1, dw2]


def check_mha(params) -> None:
    """The sequence-parallel attention takes full MHA: ``params``'
    (``TransformerParams``) K/V heads must be its query heads."""
    if params.wk.shape[1] != params.wq.shape[1]:
        raise ValueError("the sequence-parallel trainers take full MHA (no "
                         "grouped-query KV heads), as JAX's")


def seq_blocks_forward(params, x, n_heads: int, op: SeqAttention, mesh,
                       causal: bool = True):
    """The rank's stack forward on its token block ``x``: ``(y, blocks)``,
    ``blocks`` holding what ``seq_blocks_backward`` needs."""
    blocks = []
    for layer in zip(*(getattr(params, f).unbind(0) for f in FIELDS)):
        blocks.append(SeqBlock(op, mesh, n_heads, causal))
        x = blocks[-1].forward(layer, x)
    return x, blocks


def seq_blocks_backward(blocks, dy):
    """``(dx, grads)`` of the stack from the cotangent ``dy`` of its
    output; ``grads`` stacked ``[L, ...]`` in FIELDS order, partial sums
    over the rank's tokens."""
    grads = []
    for blk in reversed(blocks):
        dy, g = blk.backward(dy)
        grads.append(g)
    return dy, [torch.stack(gs[::-1]) for gs in zip(*grads)]


def sum_grads(grads, mesh) -> list:
    """The partial gradients of the ranks summed over the whole mesh (the
    seq axis, and the data axis of a data x seq mesh: JAX's one ``psum``
    over both), as one flat all-reduce."""
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
    return [t.view_as(g) for t, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


# -- launchers ----------------------------------------------------------------

def _seq_attn_rank(mesh, payload):
    kind, q, k, v, causal, attn_impl = payload
    n, r = mesh.axis_size(SEQ_AXIS), mesh.axis_index(SEQ_AXIS)
    q, k, v = (t.to(mesh.torch_device).chunk(n, -2)[r] for t in (q, k, v))
    if kind == "ring":
        y = ring_attention(q, k, v, mesh, SEQ_AXIS, causal, attn_impl)
    else:
        from .transformer import resolve_attn
        y = ulysses_attention(q, k, v, mesh, SEQ_AXIS, causal,
                              resolve_attn(attn_impl))
    return y.cpu() if not mesh.loopback else y


def _launch_seq(kind, q, k, v, mesh, causal, attn_impl):
    require_axes(mesh, SEQ_AXIS)
    n = mesh.axis_size(SEQ_AXIS)
    if q.shape[-2] % n:
        raise ValueError(f"sequence length {q.shape[-2]} not divisible by "
                         f"{n} seq shards")
    if kind == "ulysses" and q.shape[-3] % n:
        raise ValueError(f"head count {q.shape[-3]} not divisible by {n} "
                         "seq shards (Ulysses scatters heads)")
    dev = q.device
    if not mesh.loopback:
        q, k, v = q.cpu(), k.cpu(), v.cpu()
    outs = launch(_seq_attn_rank, mesh, (kind, q, k, v, causal, attn_impl))
    return torch.cat([o.to(dev) for o in outs], dim=-2)


def sequence_parallel_attention(q, k, v, mesh, causal: bool = True):
    """Launcher (JAX ``sequence_parallel_attention``): ``[..., T, dh]``
    split over the ranks of a seq mesh, ring attention on each, the
    blocks joined again on the device of ``q``."""
    return _launch_seq("ring", q, k, v, mesh, causal, None)


def ulysses_parallel_attention(q, k, v, mesh, causal: bool = True,
                               attn_impl: Optional[str] = None):
    """Launcher (JAX ``ulysses_parallel_attention``): ``[..., H, T, dh]``
    split over the sequence dim, Ulysses on each rank, joined again."""
    return _launch_seq("ulysses", q, k, v, mesh, causal, attn_impl)
