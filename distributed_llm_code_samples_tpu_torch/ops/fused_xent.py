"""The tied LM head and its cross-entropy in hand-written kernels: the
forward's per-row statistics and the backward's two gradients, with the
``[N, V]`` logits never stored whole (the forward keeps none, the
backward one bounded chunk of their gradient at a time). The training
path's ``head_impl="fused"``.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_xent.py``
(``head_xent_stats``, ``head_xent_fwd``, ``head_xent_bwd``,
``head_xent``). On a CUDA tensor each wrapper launches its CUDA kernels
(``csrc/head_xent_fwd.cu``'s copies, sliced statistics and merge;
``csrc/head_xent_bwd.cu``'s chunked products; both on the GEMM core of
``csrc/gemm_core.cuh``; built at first use by ``ops/_build.py``, bound
with ctypes) or raises; on a CPU tensor it runs its plain PyTorch
version ``*_ref``. There is no fallback from a kernel to its plain
version.

``h [N, d]``, ``w [V, d]`` (the tied embedding), ``targets [N]`` int. A
target outside ``[0, V)`` matches no column. The kernels mask the vocab
edge themselves, so the caller's ``w`` is never padded (the JAX package
pads it to its vocab tile). ``mxu_bf16`` rounds h and w, and the logit
gradient before its products, to bf16; sums and statistics stay f32.
Default off.

On bf16 storage (``h`` and ``w`` bf16, the LM's ``--dtype bfloat16``)
each function computes what the Pallas kernels compute on bf16 arrays:
the logits in f32 from the exact bf16 values (``preferred_element_type
=jnp.float32``), ``lse`` and ``tz`` f32, the logit gradient rounded to
bf16 before both products (``dz.astype(w.dtype)``, whatever
``mxu_bf16`` says), the products summed in f32 and ``dh``, ``dw``
rounded to bf16 once. The kernels count their launches as
``head_xent_stats[bf16]`` and ``head_xent_bwd[bf16]``. ``dy * dh`` with
the f32 scalar ``dy`` keeps bf16 (where JAX's wrapper promotes both
gradients to f32).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
# the GEMM core's (csrc/gemm_core.cuh) tile and blocks an SM, shared
# with the FFN kernels
from .fused_ffn import BLOCKS_PER_SM, H100_SMS, TILE, _layout, _sms, _up

FWD, BWD = "head_xent_fwd", "head_xent_bwd"
STATS_COUNT, BWD_COUNT = "head_xent_stats", "head_xent_bwd"


def _op(t: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if mxu_bf16 else t


def _widen(t: torch.Tensor) -> torch.Tensor:
    """bf16 storage as f32, exactly; f32 as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _target_logit(z, targets):
    """``z[i, t_i]`` where ``0 <= t_i < V``, else 0."""
    t = targets.long()
    valid = (t >= 0) & (t < z.shape[-1])
    tz = torch.gather(z, -1, torch.where(valid, t, 0)[:, None])[:, 0]
    return torch.where(valid, tz, torch.zeros((), dtype=z.dtype,
                                              device=z.device))


# -- plain versions --------------------------------------------------------

def head_xent_stats_ref(h, w, targets, *, mxu_bf16: bool = False):
    """``(lse [N], tz [N])``: ``logsumexp(h w^T)`` per row and the target
    logit (0 for a target outside ``[0, V)``); f32 also on bf16
    storage."""
    z = _op(_widen(h), mxu_bf16) @ _op(_widen(w), mxu_bf16).T
    m = z.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(z - m).sum(dim=-1, keepdim=True)))[:, 0]
    return lse, _target_logit(z, targets)


def head_xent_bwd_ref(dy, h, w, targets, lse, *, mxu_bf16: bool = False):
    """``(dh, dw) = dy * (dz w, dz^T h)`` with ``dz = (exp(h w^T - lse) -
    onehot(targets)) / N``; on bf16 storage ``dz`` is rounded to bf16
    before the f32 products and each product once after them."""
    store = h.dtype
    hm, wm = _op(_widen(h), mxu_bf16), _op(_widen(w), mxu_bf16)
    z = hm @ wm.T
    n, v = z.shape
    cols = torch.arange(v, device=z.device)
    onehot = (cols[None, :] == targets.long()[:, None]).to(z.dtype)
    dz = (torch.exp(z - lse[:, None]) - onehot) * (1.0 / n)
    dz = _widen(dz.to(store)) if store == torch.bfloat16 else _op(dz, mxu_bf16)
    return dy * (dz @ wm).to(store), dy * (dz.T @ hm).to(store)


# -- the kernels -----------------------------------------------------------

def _check(h, w, targets):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"h [N, d] and w [V, d] expected, got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    if h.dtype != w.dtype:
        raise ValueError(f"h and w must share one storage type, got "
                         f"{h.dtype} and {w.dtype}")
    if targets.shape != (h.shape[0],):
        raise ValueError(f"targets {tuple(targets.shape)} must be "
                         f"[{h.shape[0]}]")
    if min(h.shape[0], h.shape[1], w.shape[0]) < 1:
        raise ValueError("N, d and V must be at least 1")
    if targets.device != h.device:
        raise ValueError(f"targets must be on {h.device}")
    return h.shape[0], h.shape[1], w.shape[0]


def _targets32(targets):
    return targets.to(torch.int32).contiguous()


def _mode(h, mxu_bf16: bool) -> tuple[int, str]:
    """The kernels' mode (0 f32, 1 f32 with bf16 operands, 2 bf16
    storage) and the suffix its launches count under."""
    if h.dtype == torch.bfloat16:
        return 2, "[bf16]"
    return int(bool(mxu_bf16)), ""


# -- the statistics' plan and scratch (csrc/head_xent_fwd.cu) ---------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stats_plan(n: int, v: int, sms: int = H100_SMS):
    """``(S, L)``: the statistics kernel's vocabulary cut into S slices of
    L columns (L a multiple of ``TILE``, the last slice shorter; S =
    ceil(V / L)): as many slices as let its ``ceil(N / TILE) * S``
    blocks fit one wave of the card's ``sms * BLOCKS_PER_SM`` block
    slots, at least one and at most one a vocab tile. 64 row tiles x 4
    slices at the main shape."""
    vt = _cdiv(v, TILE)
    want = max(1, min(sms * BLOCKS_PER_SM // _cdiv(n, TILE), vt))
    per = _cdiv(vt, want)
    return _cdiv(vt, per), per * TILE


def stats_scratch(n: int, d: int, v: int, plan) -> dict:
    """The statistics kernel's scratch pieces (``fused_ffn._layout``):
    ``h^T`` as ``[d, N4]``, ``w^T`` as ``[d, V4]`` (4-rounded rows) and
    the slices' partials ``[3, S, N]`` (max, sum of exp, target
    logit)."""
    return _layout({"hT": (d, _up(n, 4)), "wT": (d, _up(v, 4)),
                    "part": (3, plan[0], n)})


def head_xent_stats(h, w, targets, *, mxu_bf16: bool = False):
    """``(lse [N], tz [N])``: h and w copied into the GEMM core's operand
    layout, one block per (row tile, vocab slice) folds each logit tile
    into running statistics (``stats_plan``), and a merge over the
    slices (``csrc/head_xent_fwd.cu``). The scratch (``stats_scratch``)
    is one ``torch.empty`` buffer. CPU tensors run
    ``head_xent_stats_ref``."""
    n, d, v = _check(h, w, targets)
    if not _build.on_card(FWD, h, w):
        return head_xent_stats_ref(h, w, targets, mxu_bf16=mxu_bf16)
    t32 = _targets32(targets)
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    tz = torch.empty_like(lse)
    plan = stats_plan(n, v, _sms(h))
    pieces = stats_scratch(n, d, v, plan)
    scratch = torch.empty(pieces.pop("total"), dtype=torch.float32,
                          device=h.device)
    base = scratch.data_ptr()
    mode, suffix = _mode(h, mxu_bf16)
    _build.launch(FWD, "head_xent_stats_launch",
                  [h.data_ptr(), w.data_ptr(), t32.data_ptr(),
                   lse.data_ptr(), tz.data_ptr()]
                  + [base + 4 * off for _, off in pieces.values()],
                  (n, d, v, *plan, mode), h.device, STATS_COUNT + suffix)
    return lse, tz


def head_xent_fwd(h, w, targets, *, mxu_bf16: bool = False):
    """``(loss, lse)``: ``mean_i(lse_i - tz_i)``; lse is the backward's
    one softmax residual."""
    lse, tz = head_xent_stats(h, w, targets, mxu_bf16=mxu_bf16)
    return (lse - tz).mean(), lse


def _bwd_scratch_floats(n: int, d: int, v: int, mode: int) -> int:
    fn = _build.load_library(BWD).head_xent_bwd_scratch_floats
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(n, d, v, mode))


def head_xent_bwd(dy, h, w, targets, lse, *, mxu_bf16: bool = False):
    """``(dh, dw)`` with each logit tile computed once: for each chunk of
    the vocabulary one launch forms the chunk's ``dz`` in a bounded
    scratch and one takes ``dh += dz w_c`` and ``dw_c = dz^T h`` from it
    (``csrc/head_xent_bwd.cu``). ``dz`` carries ``1/N``; the scalar ``dy``
    scales both outside the kernels. ``dh`` and ``dw`` take the storage
    type of ``h`` and ``w``; ``lse`` is f32. CPU tensors run
    ``head_xent_bwd_ref``."""
    n, d, v = _check(h, w, targets)
    if lse.shape != (n,):
        raise ValueError(f"lse {tuple(lse.shape)} must be [{n}]")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    if not _build.on_card(BWD, h, w, lse):
        return head_xent_bwd_ref(dy, h, w, targets, lse, mxu_bf16=mxu_bf16)
    t32 = _targets32(targets)
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    mode, suffix = _mode(h, mxu_bf16)
    scratch = torch.empty(_bwd_scratch_floats(n, d, v, mode),
                          dtype=torch.float32, device=h.device)
    _build.launch(BWD, "head_xent_bwd_launch",
                  [h.data_ptr(), w.data_ptr(), t32.data_ptr(),
                   lse.data_ptr(), dh.data_ptr(), dw.data_ptr(),
                   scratch.data_ptr()],
                  (n, d, v, mode), h.device, BWD_COUNT + suffix)
    return dy * dh, dy * dw


class _HeadXent(torch.autograd.Function):
    """Forward and backward are the kernels; residuals are ``(h, w,
    targets, lse)``."""

    @staticmethod
    def forward(ctx, h, w, targets, mxu_bf16):
        loss, lse = head_xent_fwd(h, w, targets, mxu_bf16=mxu_bf16)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.mxu_bf16 = mxu_bf16
        return loss

    @staticmethod
    def backward(ctx, dy):
        dh, dw = head_xent_bwd(dy, *ctx.saved_tensors, mxu_bf16=ctx.mxu_bf16)
        return dh, dw, None, None


def head_xent(h, w, targets, mxu_bf16: bool = False):
    """Row-mean cross-entropy of the tied head ``h w^T``, computed and
    differentiated by the kernels; ``targets`` takes no gradient."""
    return _HeadXent.apply(h, w, targets, mxu_bf16)
