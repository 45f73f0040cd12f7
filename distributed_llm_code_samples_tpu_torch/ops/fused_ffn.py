"""The FFN block in three hand-written kernels: forward, input gradient
and weight gradients, the training path's ``use_pallas=True`` blocks.

Port of ``distributed_llm_code_samples_tpu/ops/pallas_ffn.py``
(``ffn_fwd_pallas``, ``ffn_bwd_dx_pallas``, ``ffn_bwd_dw_pallas``,
``ffn_bwd_pallas``, ``pallas_ffn_block``). On a CUDA tensor each wrapper
launches its CUDA kernel (``csrc/ffn_fwd.cu``, ``csrc/ffn_bwd_dx.cu``,
``csrc/ffn_bwd_dw.cu``; built at first use by ``ops/_build.py``, bound
with ctypes) or raises; on a CPU tensor it runs its plain PyTorch version
``*_ref``. There is no fallback from a kernel to its plain version.

``mxu_bf16`` is the Pallas kernels' operand mode: x, w1, w2 and dy are
rounded to bf16, and so is the hidden activation before the second
product; products and sums stay f32. The port defaults it off (all f32,
the differential mode); the JAX compiled path defaults it on. The
kernels sum in another order than the plain versions, so the two agree
to rounding, not bit for bit; each kernel is bit-for-bit deterministic
from run to run.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import relu_fwd

FWD, BWD_DX, BWD_DW = "ffn_fwd", "ffn_bwd_dx", "ffn_bwd_dw"


def _op(t: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if mxu_bf16 else t


def _mask(h, da):
    return torch.where(h <= 0, torch.zeros((), dtype=da.dtype,
                                           device=da.device), da)


# -- plain versions --------------------------------------------------------

def ffn_fwd_ref(w1, w2, x, *, mxu_bf16: bool = False):
    """``relu(x w1^T) w2^T``; ``w1 [ffn, d]``, ``w2 [d, ffn]``,
    ``x [T, d]`` -> ``[T, d]``."""
    h = _op(x, mxu_bf16) @ _op(w1, mxu_bf16).T
    return _op(relu_fwd(h), mxu_bf16) @ _op(w2, mxu_bf16).T


def ffn_bwd_dx_ref(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """``dx = where(h <= 0, 0, dy w2) w1`` with ``h = x w1^T``."""
    w1m = _op(w1, mxu_bf16)
    h = _op(x, mxu_bf16) @ w1m.T
    da = _op(dy, mxu_bf16) @ _op(w2, mxu_bf16)
    return _op(_mask(h, da), mxu_bf16) @ w1m


def ffn_bwd_dw_ref(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """``(dw1, dw2) = (dh^T x, dy^T relu(h))`` with ``h = x w1^T`` and
    ``dh = where(h <= 0, 0, dy w2)``."""
    xm, dym = _op(x, mxu_bf16), _op(dy, mxu_bf16)
    h = xm @ _op(w1, mxu_bf16).T
    a = _op(relu_fwd(h), mxu_bf16)
    dh = _op(_mask(h, dym @ _op(w2, mxu_bf16)), mxu_bf16)
    return dh.T @ xm, dym.T @ a


# -- the kernels -----------------------------------------------------------

def _check(x, w1, w2, dy=None):
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("x must be [T, d], w1 [ffn, d] and w2 [d, ffn]")
    t, d = x.shape
    ffn = w1.shape[0]
    if tuple(w1.shape) != (ffn, d) or tuple(w2.shape) != (d, ffn):
        raise ValueError(f"w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do "
                         f"not fit x {tuple(x.shape)}: need w1 [ffn, {d}], "
                         f"w2 [{d}, ffn]")
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match x "
                         f"{tuple(x.shape)}")
    if min(t, d, ffn) < 1:
        raise ValueError("T, d and ffn must be at least 1")
    return t, d, ffn


# -- the kernels' plans and scratch (csrc/ffn_gemm.cuh) --------------------

# their GEMM core (csrc/gemm_core.cuh): output tile, k-step, blocks an SM
TILE, BK, BLOCKS_PER_SM = 128, 16, 2
# pass 2 of each kernel splits its depth axis (tokens for the weight
# gradients, ffn for the forward and the input gradient) into slices
# until its blocks fill at least DW_WAVES (OUT_WAVES) waves of the card's
# block slots, each slice at least MIN_SLICE long. On an H100 at the main
# shape, by chip_smoke.py's ffn-*-slices lines (PERF.md): the weight
# gradients (288 tiles, 264 slots) ran within 2% of each other at 4 to 16
# slices and 13% slower at one; the forward and the input gradient (384
# tiles) ran fastest unsplit, 2-3% faster than at 3 slices and more so
# than at more: their partials and reduce cost more than the waves gain.
DW_WAVES, OUT_WAVES, MIN_SLICE = 4, 1, 256
H100_SMS = 132


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _tiles(v: int) -> int:
    return -(-v // TILE)


def slice_plan(depth: int, tiles: int, waves: int, sms: int = H100_SMS):
    """``(S, L)``: a pass 2 of ``tiles`` output tiles over ``depth`` cut
    into S slices of L (L a multiple of the k-step, the last slice
    shorter; S = ceil(depth / L)), as few as make its ``S * tiles``
    blocks fill ``waves`` waves of ``sms * BLOCKS_PER_SM`` slots, as long
    as each slice keeps ``MIN_SLICE`` of the depth."""
    slots = sms * BLOCKS_PER_SM
    want = max(1, min(-(-waves * slots // tiles), depth // MIN_SLICE))
    length = _up(-(-depth // want), BK)
    return -(-depth // length), length


def dw_plan(t: int, d: int, ffn: int, sms: int = H100_SMS):
    """The weight-gradient kernel's slices of the token axis: its pass 2
    has the ``2 * ceil(ffn / 128) * ceil(d / 128)`` tiles of dw1 and
    dw2."""
    return slice_plan(t, 2 * _tiles(ffn) * _tiles(d), DW_WAVES, sms)


def out_plan(t: int, d: int, ffn: int, sms: int = H100_SMS):
    """The forward's and the input gradient's slices of the ffn axis:
    their pass 2 has the ``ceil(T / 128) * ceil(d / 128)`` tiles of the
    ``[T, d]`` output."""
    return slice_plan(ffn, _tiles(t) * _tiles(d), OUT_WAVES, sms)


def plan_slices(depth: int, plan) -> list[tuple[int, int]]:
    """The range ``[lo, hi)`` of each slice of ``plan`` over ``depth``,
    in order."""
    s, length = plan
    return [(i * length, min(depth, (i + 1) * length)) for i in range(s)]


def _numel(shape) -> int:
    n = 1
    for v in shape:
        n *= v
    return n


def _layout(shapes: dict) -> dict:
    """``{name: (shape, offset)}`` in floats from the start of one
    buffer, each offset 16-byte aligned, in the order given (the order
    the kernel takes its pointers in), and the buffer's floats under
    ``"total"``."""
    out, off = {}, 0
    for name, shape in shapes.items():
        out[name] = (shape, off)
        off += _up(_numel(shape), 4)
    out["total"] = off
    return out


def dw_scratch(t: int, d: int, ffn: int, plan) -> dict:
    """The weight-gradient kernel's scratch pieces (``_layout``): x and
    dy padded as ``[T, d4]`` and transposed as ``[d, T4]``, ``w1^T`` and
    ``w2`` as ``[d, ffn4]``, ``a`` and ``dh`` as ``[T, ffn4]`` (4-rounded
    rows), and, when the plan has more than one slice, the partials
    ``[S, ffn, d]`` and ``[S, d, ffn]``."""
    t4, d4, f4 = _up(t, 4), _up(d, 4), _up(ffn, 4)
    shapes = {"xT": (d, t4), "dyT": (d, t4), "xc": (t, d4), "dyc": (t, d4),
              "w1T": (d, f4), "w2c": (d, f4), "a": (t, f4), "dh": (t, f4)}
    if plan[0] > 1:
        shapes.update(part1=(plan[0], ffn, d), part2=(plan[0], d, ffn))
    return _layout(shapes)


def fwd_scratch(t: int, d: int, ffn: int, plan) -> dict:
    """The forward kernel's scratch pieces (``_layout``): ``x^T`` as
    ``[d, T4]``, ``w1^T`` as ``[d, ffn4]``, ``w2^T`` as ``[ffn, d4]``,
    ``a^T`` as ``[ffn, T4]`` and, when the plan has more than one slice,
    the partials ``[S, T, d]``."""
    t4, d4, f4 = _up(t, 4), _up(d, 4), _up(ffn, 4)
    shapes = {"xT": (d, t4), "w1T": (d, f4), "w2T": (ffn, d4),
              "aT": (ffn, t4)}
    if plan[0] > 1:
        shapes["part"] = (plan[0], t, d)
    return _layout(shapes)


def dx_scratch(t: int, d: int, ffn: int, plan) -> dict:
    """The input-gradient kernel's scratch pieces (``_layout``): ``x^T``
    and ``dy^T`` as ``[d, T4]``, ``w1^T`` and ``w2`` as ``[d, ffn4]``,
    ``w1`` as ``[ffn, d4]``, ``dh^T`` as ``[ffn, T4]`` and, when the plan
    has more than one slice, the partials ``[S, T, d]``."""
    t4, d4, f4 = _up(t, 4), _up(d, 4), _up(ffn, 4)
    shapes = {"xT": (d, t4), "dyT": (d, t4), "w1T": (d, f4),
              "w2c": (d, f4), "w1c": (ffn, d4), "dhT": (ffn, t4)}
    if plan[0] > 1:
        shapes["part"] = (plan[0], t, d)
    return _layout(shapes)


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


# the partials pieces of each kernel's scratch, last in its pointer order
_PARTIALS = {FWD: ("part",), BWD_DX: ("part",), BWD_DW: ("part1", "part2")}


def _launch(name, tensors, pieces, ints, mxu_bf16):
    """Launch ``csrc/<name>.cu`` on ``tensors`` (inputs, then outputs)
    and the scratch ``pieces``, carved from one ``torch.empty`` buffer; a
    one-slice plan has no partials, and null pointers take their place."""
    pieces = dict(pieces)
    scratch = torch.empty(pieces.pop("total"), dtype=torch.float32,
                          device=tensors[0].device)
    base = scratch.data_ptr()
    ptrs = [t.data_ptr() for t in tensors]
    ptrs += [base + 4 * off for _, off in pieces.values()]
    ptrs += [0 for part in _PARTIALS[name] if part not in pieces]
    _build.launch(name, f"{name}_launch", ptrs,
                  (*ints, int(bool(mxu_bf16))), tensors[0].device, name)


def ffn_fwd_fused(w1, w2, x, *, mxu_bf16: bool = False):
    """Linear -> ReLU -> linear forward, ``[T, d]``. The kernel's scratch
    (``fwd_scratch``: the padded operand copies, ``a^T`` as ``[ffn, T]``
    and the slices' partials) is one ``torch.empty`` buffer;
    ``csrc/ffn_fwd.cu`` says why each is there. CPU tensors run
    ``ffn_fwd_ref``."""
    t, d, ffn = _check(x, w1, w2)
    if not _build.on_card(FWD, x, w1, w2):
        return ffn_fwd_ref(w1, w2, x, mxu_bf16=mxu_bf16)
    y = torch.empty_like(x)
    plan = out_plan(t, d, ffn, _sms(x))
    _launch(FWD, [x, w1, w2, y], fwd_scratch(t, d, ffn, plan),
            (t, d, ffn, *plan), mxu_bf16)
    return y


def ffn_bwd_dx_fused(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """Input gradient ``dx [T, d]`` with the pre-activation recomputed.
    The kernel's scratch (``dx_scratch``: the padded operand copies,
    ``dh^T`` as ``[ffn, T]`` and the slices' partials) is one
    ``torch.empty`` buffer; ``csrc/ffn_bwd_dx.cu`` says why each is
    there. CPU tensors run ``ffn_bwd_dx_ref``."""
    t, d, ffn = _check(x, w1, w2, dy)
    if not _build.on_card(BWD_DX, x, dy, w1, w2):
        return ffn_bwd_dx_ref(dy, w1, w2, x, mxu_bf16=mxu_bf16)
    dx = torch.empty_like(x)
    plan = out_plan(t, d, ffn, _sms(x))
    _launch(BWD_DX, [x, dy, w1, w2, dx], dx_scratch(t, d, ffn, plan),
            (t, d, ffn, *plan), mxu_bf16)
    return dx


def ffn_bwd_dw_fused(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """Both weight gradients ``(dw1 [ffn, d], dw2 [d, ffn])``, reduced
    over tokens. The kernel's scratch (``dw_scratch``: the padded operand
    copies, ``a`` and ``dh`` as ``[T, ffn]`` and the slices' partials) is
    one ``torch.empty`` buffer; ``csrc/ffn_bwd_dw.cu`` says why each is
    there. CPU tensors run ``ffn_bwd_dw_ref``."""
    t, d, ffn = _check(x, w1, w2, dy)
    if not _build.on_card(BWD_DW, x, dy, w1, w2):
        return ffn_bwd_dw_ref(dy, w1, w2, x, mxu_bf16=mxu_bf16)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    plan = dw_plan(t, d, ffn, _sms(x))
    _launch(BWD_DW, [x, dy, w1, w2, dw1, dw2], dw_scratch(t, d, ffn, plan),
            (t, d, ffn, *plan), mxu_bf16)
    return dw1, dw2


def ffn_bwd_fused(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """The block VJP from the two backward kernels, ``ops.ffn.ffn_bwd``'s
    signature: ``(dx, (dw1, dw2))``."""
    dx = ffn_bwd_dx_fused(dy, w1, w2, x, mxu_bf16=mxu_bf16)
    return dx, ffn_bwd_dw_fused(dy, w1, w2, x, mxu_bf16=mxu_bf16)


class _FusedBlock(torch.autograd.Function):
    """Forward and backward are the kernels; residuals are the params
    and the block input."""

    @staticmethod
    def forward(ctx, w1, w2, x, mxu_bf16):
        ctx.save_for_backward(w1, w2, x)
        ctx.mxu_bf16 = mxu_bf16
        return ffn_fwd_fused(w1, w2, x, mxu_bf16=mxu_bf16)

    @staticmethod
    def backward(ctx, dy):
        w1, w2, x = ctx.saved_tensors
        dx, (dw1, dw2) = ffn_bwd_fused(dy.contiguous(), w1, w2, x,
                                       mxu_bf16=ctx.mxu_bf16)
        return dw1, dw2, dx, None


def fused_ffn_block(w1, w2, x, mxu_bf16: bool = False):
    """FFN block computed by the kernels and differentiated by them."""
    return _FusedBlock.apply(w1, w2, x, mxu_bf16)
