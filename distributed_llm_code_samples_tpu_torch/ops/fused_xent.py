"""The tied LM head and its cross-entropy in hand-written kernels: the
forward's per-row statistics and the backward's two gradients, with the
``[N, V]`` logits recomputed tile by tile and never stored. The training
path's ``head_impl="fused"``.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_xent.py``
(``head_xent_stats``, ``head_xent_fwd``, ``head_xent_bwd``,
``head_xent``). On a CUDA tensor each wrapper launches its CUDA kernels
(``csrc/head_xent_fwd.cu``; ``csrc/head_xent_bwd.cu``'s dh and dw
kernels; built at first use by ``ops/_build.py``, bound with ctypes) or
raises; on a CPU tensor it runs its plain PyTorch version ``*_ref``.
There is no fallback from a kernel to its plain version.

``h [N, d]``, ``w [V, d]`` (the tied embedding), ``targets [N]`` int. A
target outside ``[0, V)`` matches no column. The kernels mask the vocab
edge themselves, so ``w`` is never padded (the JAX package pads it to
its vocab tile). ``mxu_bf16`` rounds h and w, and the logit gradient
before its products, to bf16; sums and statistics stay f32. Default off.
"""

from __future__ import annotations

import torch

from . import _build

FWD, BWD = "head_xent_fwd", "head_xent_bwd"
STATS_COUNT, DH_COUNT, DW_COUNT = "head_xent_stats", "head_xent_dh", \
    "head_xent_dw"
# the dh kernel sums the vocabulary in this many chunks, added in order
# afterwards (csrc/head_xent_bwd.cu says why)
DH_SPLITS = 8


def _op(t: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if mxu_bf16 else t


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
    logit (0 for a target outside ``[0, V)``)."""
    z = _op(h, mxu_bf16) @ _op(w, mxu_bf16).T
    m = z.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(z - m).sum(dim=-1, keepdim=True)))[:, 0]
    return lse, _target_logit(z, targets)


def head_xent_bwd_ref(dy, h, w, targets, lse, *, mxu_bf16: bool = False):
    """``(dh, dw) = dy * (dz w, dz^T h)`` with ``dz = (exp(h w^T - lse) -
    onehot(targets)) / N``."""
    hm, wm = _op(h, mxu_bf16), _op(w, mxu_bf16)
    z = hm @ wm.T
    n, v = z.shape
    cols = torch.arange(v, device=z.device)
    onehot = (cols[None, :] == targets.long()[:, None]).to(z.dtype)
    dz = _op((torch.exp(z - lse[:, None]) - onehot) * (1.0 / n), mxu_bf16)
    return dy * (dz @ wm), dy * (dz.T @ hm)


# -- the kernels -----------------------------------------------------------

def _check(h, w, targets):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"h [N, d] and w [V, d] expected, got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
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


def head_xent_stats(h, w, targets, *, mxu_bf16: bool = False):
    """``(lse [N], tz [N])`` from one launch: a block per token tile walks
    every vocab tile with an online logsumexp. CPU tensors run
    ``head_xent_stats_ref``."""
    n, d, v = _check(h, w, targets)
    if not _build.on_card(FWD, h, w):
        return head_xent_stats_ref(h, w, targets, mxu_bf16=mxu_bf16)
    t32 = _targets32(targets)
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    tz = torch.empty_like(lse)
    _build.launch(FWD, "head_xent_stats_launch",
                  [h.data_ptr(), w.data_ptr(), t32.data_ptr(),
                   lse.data_ptr(), tz.data_ptr()],
                  (n, d, v, int(bool(mxu_bf16))), h.device, STATS_COUNT)
    return lse, tz


def head_xent_fwd(h, w, targets, *, mxu_bf16: bool = False):
    """``(loss, lse)``: ``mean_i(lse_i - tz_i)``; lse is the backward's
    one softmax residual."""
    lse, tz = head_xent_stats(h, w, targets, mxu_bf16=mxu_bf16)
    return (lse - tz).mean(), lse


def head_xent_bwd(dy, h, w, targets, lse, *, mxu_bf16: bool = False):
    """``(dh, dw)`` with the logit tiles recomputed: the dh launch (a
    block per token tile and vocab chunk, the chunks' sums then added in
    order) and the dw launch (a block per vocab tile, walking the
    tokens). ``dz`` carries ``1/N``; the scalar ``dy`` scales both
    outside the kernels. CPU tensors run ``head_xent_bwd_ref``."""
    n, d, v = _check(h, w, targets)
    if lse.shape != (n,):
        raise ValueError(f"lse {tuple(lse.shape)} must be [{n}]")
    if not _build.on_card(BWD, h, w, lse):
        return head_xent_bwd_ref(dy, h, w, targets, lse, mxu_bf16=mxu_bf16)
    t32 = _targets32(targets)
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    part = torch.empty(DH_SPLITS, n, d, dtype=torch.float32, device=h.device)
    ins = [h.data_ptr(), w.data_ptr(), t32.data_ptr(), lse.data_ptr()]
    mx = int(bool(mxu_bf16))
    _build.launch(BWD, "head_xent_dh_launch",
                  ins + [dh.data_ptr(), part.data_ptr()],
                  (n, d, v, DH_SPLITS, mx), h.device, DH_COUNT)
    _build.launch(BWD, "head_xent_dw_launch", ins + [dw.data_ptr()],
                  (n, d, v, mx), h.device, DW_COUNT)
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
