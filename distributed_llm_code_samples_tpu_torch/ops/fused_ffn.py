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

On bf16 tensors (``--dtype bfloat16``, all operands bf16) each function
computes what the Pallas kernels compute on bf16 arrays: that operand
mode, whatever ``mxu_bf16`` says, and bf16 outputs, each element rounded
once from its f32 sum (``pallas_ffn.py:126, 187, 246-247``), counted as
``<name>[bf16]``. All three kernels run their bf16 operand modes
(``mxu_bf16`` on f32, mode 1; bf16 storage, mode 2) on the tensor cores
(``csrc/ffn_wgmma.cuh``): TMA reads bf16 operands where they lie, or
from a bf16 copy the kernel makes (mode 1's rounding, or bf16 that TMA
cannot read in place: ``tc_staged``). Mode 0 (f32) runs the CUDA-core
passes of ``csrc/ffn_gemm.cuh``.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import relu_fwd

FWD, BWD_DX, BWD_DW = "ffn_fwd", "ffn_bwd_dx", "ffn_bwd_dw"


def _op(t: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if mxu_bf16 else t


def _bf16(x: torch.Tensor, mxu_bf16: bool) -> bool:
    """The operand mode of a call on ``x``: bf16 storage implies it."""
    return mxu_bf16 or x.dtype == torch.bfloat16


def _mask(h, da):
    return torch.where(h <= 0, torch.zeros((), dtype=da.dtype,
                                           device=da.device), da)


# -- plain versions --------------------------------------------------------

def ffn_fwd_ref(w1, w2, x, *, mxu_bf16: bool = False):
    """``relu(x w1^T) w2^T``; ``w1 [ffn, d]``, ``w2 [d, ffn]``,
    ``x [T, d]`` -> ``[T, d]``."""
    mx = _bf16(x, mxu_bf16)
    h = _op(x, mx) @ _op(w1, mx).T
    return (_op(relu_fwd(h), mx) @ _op(w2, mx).T).to(x.dtype)


def ffn_bwd_dx_ref(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """``dx = where(h <= 0, 0, dy w2) w1`` with ``h = x w1^T``."""
    mx = _bf16(x, mxu_bf16)
    w1m = _op(w1, mx)
    h = _op(x, mx) @ w1m.T
    da = _op(dy, mx) @ _op(w2, mx)
    return (_op(_mask(h, da), mx) @ w1m).to(x.dtype)


def ffn_bwd_dw_ref(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """``(dw1, dw2) = (dh^T x, dy^T relu(h))`` with ``h = x w1^T`` and
    ``dh = where(h <= 0, 0, dy w2)``."""
    mx = _bf16(x, mxu_bf16)
    xm, dym = _op(x, mx), _op(dy, mx)
    h = xm @ _op(w1, mx).T
    a = _op(relu_fwd(h), mx)
    dh = _op(_mask(h, dym @ _op(w2, mx)), mx)
    return (dh.T @ xm).to(x.dtype), (dym.T @ a).to(x.dtype)


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
    types = {t.dtype for t in (x, w1, w2, dy) if t is not None}
    if len(types) > 1:
        raise ValueError(f"the operands must share one storage type, got "
                         f"{sorted(map(str, types))}")
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


# -- the tensor-core passes of modes 1 and 2 (csrc/ffn_wgmma.cuh) ----------

# a block's output tile (two consumer warpgroups of 64 rows, one
# m64n256k16 product a k16 step), the depth of a ring stage (one 128-byte
# swizzled row of bf16) and blocks an SM (the ring takes up to 193 KB of
# shared memory; the passes are persistent, one block an SM)
TC_BM, TC_BN, TC_BK, TC_BLOCKS_PER_SM = 128, 256, 64, 1
# the shortest slice of pass 2's depth, and the fewest slices a split
# tile takes: on an H100 at the main shape (chip_smoke.py's
# ffn-tc-dx-slices, PERF.md) splitting dx's last 60 of 192 tiles in two
# saved half a round but lost 2% to the partials and their reduce, while
# dw's last 12 of 144 in eleven saved 13% against every tile whole
TC_MIN_SLICE, TC_MIN_SPLIT = 512, 3
# TMA reads a bf16 operand in place when its base is TC_ALIGN-byte
# aligned and its rows are a multiple of TC_ROW elements (16 bytes);
# scratch pieces start TC_PIECE bytes apart
TC_ALIGN, TC_ROW, TC_PIECE = 16, 8, 256


def _tc_tiles(m: int, n: int) -> int:
    return -(-m // TC_BM) * -(-n // TC_BN)


def tc_plan(depth: int, tiles: int, sms: int = H100_SMS):
    """``(S, L, U)``: a tensor-core pass 2 of ``tiles`` output tiles over
    ``depth``. The tiles that fill whole rounds of the card's SMs, U of
    them, run over the whole depth; the rest, which would leave the last
    round part idle, run over S slices of L each (L a multiple of
    TC_BK, the last slice shorter, S = ceil(depth / L)), as many as the
    last round holds, as long as each keeps TC_MIN_SLICE of the depth
    and there are TC_MIN_SPLIT at least; else every tile runs whole (S
    1, U = tiles). The split tiles' f32 partials are summed in slice
    order, so the bits do not depend on the timing."""
    slots = sms * TC_BLOCKS_PER_SM
    full, rem = divmod(tiles, slots)
    s = min(slots // rem, depth // TC_MIN_SLICE) if rem else 1
    if s >= TC_MIN_SPLIT:
        length = _up(-(-depth // s), TC_BK)
        s = -(-depth // length)
    if s < TC_MIN_SPLIT:
        return 1, _up(depth, TC_BK), tiles
    return s, length, full * slots


def tc_dw_tiles(d: int, ffn: int) -> int:
    """The tensor-core weight gradients' pass-2 tiles: dw1 ``[ffn, d]``'s,
    then dw2 ``[d, ffn]``'s."""
    return _tc_tiles(ffn, d) + _tc_tiles(d, ffn)


def tc_dw_plan(t: int, d: int, ffn: int, sms: int = H100_SMS):
    """The tensor-core weight gradients' pass 2 over the token axis."""
    return tc_plan(t, tc_dw_tiles(d, ffn), sms)


def tc_dx_plan(t: int, d: int, ffn: int, sms: int = H100_SMS):
    """The tensor-core input gradient's pass 2 over the ffn axis, the
    tiles of ``dx [T, d]``."""
    return tc_plan(ffn, _tc_tiles(t, d), sms)


def tc_fwd_plan(t: int, d: int, ffn: int, sms: int = H100_SMS):
    """The tensor-core forward's pass 2 over the ffn axis, the tiles of
    ``y [T, d]``: at the main shape 64 x 3 tiles, every one over all
    3072 columns of ffn (as ``tc_dx_plan``)."""
    return tc_plan(ffn, _tc_tiles(t, d), sms)


def tc_staged(mode: int, operands: dict) -> tuple:
    """The operands of a tensor-core call that the kernel copies into bf16
    scratch before TMA reads them: ``operands`` is ``{piece: (data_ptr,
    row elements)}`` (the FFN kernels' ``xs``, ``dys``, ``w1s``, ``w2s``;
    the head's ``hs``, ``ws``). Mode 1 (f32 storage) copies all of them,
    rounding them; mode 2 (bf16) those whose base is not TC_ALIGN-byte
    aligned or whose rows are not a multiple of TC_ROW elements. The copy
    has the same values, so a staged call gives the bits an aligned one
    gives."""
    return tuple(name for name, (ptr, row) in operands.items()
                 if mode == 1 or ptr % TC_ALIGN or row % TC_ROW)


def _tc_layout(pieces: dict) -> dict:
    """``{name: (shape, offset)}`` in bytes from the start of one buffer,
    each offset a multiple of TC_PIECE, for ``pieces`` ``{name: (shape,
    bytes an element)}`` in the order given, and the buffer's bytes under
    ``"total"``."""
    out, off = {}, 0
    for name, (shape, size) in pieces.items():
        out[name] = (shape, off)
        off += _up(size * _numel(shape), TC_PIECE)
    out["total"] = off
    return out


def _tc_staging(t: int, d: int, ffn: int, staged) -> dict:
    d8, f8 = _up(d, TC_ROW), _up(ffn, TC_ROW)
    shapes = {"xs": (t, d8), "dys": (t, d8), "w1s": (ffn, d8),
              "w2s": (d, f8)}
    return {k: (v, 2) for k, v in shapes.items() if k in staged}


def _tc_partials(plan, tiles: int) -> dict:
    """The split tiles' f32 partials, ``[S, tiles - U, 128, 256]`` (none
    for a one-slice plan)."""
    s, _, whole = plan
    if s == 1:
        return {}
    return {"part": ((s, tiles - whole, TC_BM, TC_BN), 4)}


def tc_dw_scratch(t: int, d: int, ffn: int, plan, staged=()) -> dict:
    """The tensor-core weight gradients' scratch (``_tc_layout``): the
    staged bf16 copies (``tc_staged``), ``a`` and ``dh`` as bf16 ``[T,
    ffn8]`` and the split tiles' partials."""
    f8 = _up(ffn, TC_ROW)
    pieces = _tc_staging(t, d, ffn, staged)
    pieces.update(a=((t, f8), 2), dh=((t, f8), 2))
    pieces.update(_tc_partials(plan, tc_dw_tiles(d, ffn)))
    return _tc_layout(pieces)


def tc_fwd_scratch(t: int, d: int, ffn: int, plan, staged=()) -> dict:
    """The tensor-core forward's scratch (``_tc_layout``): the staged bf16
    copies (``xs``, ``w1s``, ``w2s``), ``a`` as bf16 ``[T, ffn8]`` and
    the split tiles' partials."""
    pieces = _tc_staging(t, d, ffn, staged)
    pieces["a"] = ((t, _up(ffn, TC_ROW)), 2)
    pieces.update(_tc_partials(plan, _tc_tiles(t, d)))
    return _tc_layout(pieces)


def tc_dx_scratch(t: int, d: int, ffn: int, plan, staged=()) -> dict:
    """The tensor-core input gradient's scratch (``_tc_layout``): the
    staged bf16 copies, ``dh`` as bf16 ``[T, ffn8]`` and the split tiles'
    partials."""
    pieces = _tc_staging(t, d, ffn, staged)
    pieces["dh"] = ((t, _up(ffn, TC_ROW)), 2)
    pieces.update(_tc_partials(plan, _tc_tiles(t, d)))
    return _tc_layout(pieces)


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


# the partials pieces of each kernel's scratch, last in its pointer order
_PARTIALS = {FWD: ("part",), BWD_DX: ("part",), BWD_DW: ("part1", "part2")}


def _launch(name, tensors, pieces, ints):
    """Launch the CUDA-core passes of ``csrc/<name>.cu`` (mode 0, f32) on
    ``tensors`` (inputs, then outputs) and the f32 scratch ``pieces``,
    carved from one ``torch.empty`` buffer; a one-slice plan has no
    partials, and null pointers take their place."""
    pieces = dict(pieces)
    scratch = torch.empty(pieces.pop("total"), dtype=torch.float32,
                          device=tensors[0].device)
    base = scratch.data_ptr()
    ptrs = [t.data_ptr() for t in tensors]
    ptrs += [base + 4 * off for _, off in pieces.values()]
    ptrs += [0 for part in _PARTIALS[name] if part not in pieces]
    _build.launch(name, f"{name}_launch", ptrs, (*ints, 0),
                  tensors[0].device, name)


# the operands each tensor-core launch takes first, by their staged
# pieces, and the scratch pieces it takes, in its pointer order
_TC_OPERANDS = {FWD: ("xs", "w1s", "w2s"),
                BWD_DX: ("xs", "dys", "w1s", "w2s"),
                BWD_DW: ("xs", "dys", "w1s", "w2s")}
_TC_PIECES = {FWD: ("xs", "w1s", "w2s", "a", "part"),
              BWD_DX: ("xs", "dys", "w1s", "w2s", "dh", "part"),
              BWD_DW: ("xs", "dys", "w1s", "w2s", "a", "dh", "part")}


def _tc_mode(x, mxu_bf16) -> int:
    """0: the CUDA-core passes (f32); 1: the tensor-core passes on f32
    storage (``mxu_bf16``); 2: on bf16 storage."""
    return 2 if x.dtype == torch.bfloat16 else int(bool(mxu_bf16))


def _launch_tc(name, tensors, scratch_fn, plan, t, d, ffn, mode, sms):
    """Launch ``<name>_tc_launch`` of ``csrc/<name>.cu`` on ``tensors``
    (x, dy (not the forward's), w1, w2, then the outputs) with the
    scratch ``scratch_fn(t, d, ffn, plan, staged)`` carved from one
    ``torch.empty`` buffer (pieces it leaves out are null pointers), its
    persistent passes on ``sms`` blocks at most. Returns the buffer and
    its pieces (what the passes left there: the card tests read ``a``)."""
    x = tensors[0]
    rows = {"xs": d, "dys": d, "w1s": d, "w2s": ffn}
    staged = tc_staged(mode, {p: (v.data_ptr(), rows[p]) for p, v in
                              zip(_TC_OPERANDS[name], tensors)})
    pieces = scratch_fn(t, d, ffn, plan, staged)
    scratch = torch.empty(pieces["total"], dtype=torch.uint8,
                          device=x.device)
    base = scratch.data_ptr()
    ptrs = [v.data_ptr() for v in tensors]
    ptrs += [base + pieces[p][1] if p in pieces else 0
             for p in _TC_PIECES[name]]
    _build.launch(name, f"{name}_tc_launch", ptrs,
                  (t, d, ffn, *plan, mode, sms), x.device,
                  name + "[bf16]" if mode == 2 else name)
    return scratch, pieces


def ffn_fwd_fused(w1, w2, x, *, mxu_bf16: bool = False):
    """Linear -> ReLU -> linear forward, ``[T, d]``. The kernel's scratch
    is one ``torch.empty`` buffer: in f32 (``fwd_scratch``) the padded
    operand copies, ``a^T`` as ``[ffn, T]`` and the slices' partials;
    with bf16 operands (``tc_fwd_scratch``) the staged bf16 copies, ``a``
    as bf16 ``[T, ffn]`` and the partials. ``csrc/ffn_fwd.cu`` says why
    each is there. CPU tensors run ``ffn_fwd_ref``."""
    t, d, ffn = _check(x, w1, w2)
    if not _build.on_card(FWD, x, w1, w2):
        return ffn_fwd_ref(w1, w2, x, mxu_bf16=mxu_bf16)
    y = torch.empty_like(x)
    mode = _tc_mode(x, mxu_bf16)
    if mode:
        sms = _sms(x)
        _launch_tc(FWD, [x, w1, w2, y], tc_fwd_scratch,
                   tc_fwd_plan(t, d, ffn, sms), t, d, ffn, mode, sms)
        return y
    plan = out_plan(t, d, ffn, _sms(x))
    _launch(FWD, [x, w1, w2, y], fwd_scratch(t, d, ffn, plan),
            (t, d, ffn, *plan))
    return y


def ffn_bwd_dx_fused(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """Input gradient ``dx [T, d]`` with the pre-activation recomputed.
    The kernel's scratch is one ``torch.empty`` buffer: in f32
    (``dx_scratch``) the padded operand copies, ``dh^T`` as ``[ffn, T]``
    and the slices' partials; with bf16 operands (``tc_dx_scratch``) the
    staged bf16 copies, ``dh`` as bf16 ``[T, ffn]`` and the partials.
    ``csrc/ffn_bwd_dx.cu`` says why each is there. CPU tensors run
    ``ffn_bwd_dx_ref``."""
    t, d, ffn = _check(x, w1, w2, dy)
    if not _build.on_card(BWD_DX, x, dy, w1, w2):
        return ffn_bwd_dx_ref(dy, w1, w2, x, mxu_bf16=mxu_bf16)
    dx = torch.empty_like(x)
    mode = _tc_mode(x, mxu_bf16)
    if mode:
        sms = _sms(x)
        _launch_tc(BWD_DX, [x, dy, w1, w2, dx], tc_dx_scratch,
                   tc_dx_plan(t, d, ffn, sms), t, d, ffn, mode, sms)
        return dx
    plan = out_plan(t, d, ffn, _sms(x))
    _launch(BWD_DX, [x, dy, w1, w2, dx], dx_scratch(t, d, ffn, plan),
            (t, d, ffn, *plan))
    return dx


def ffn_bwd_dw_fused(dy, w1, w2, x, *, mxu_bf16: bool = False):
    """Both weight gradients ``(dw1 [ffn, d], dw2 [d, ffn])``, reduced
    over tokens. The kernel's scratch is one ``torch.empty`` buffer: in
    f32 (``dw_scratch``) the padded operand copies, ``a`` and ``dh`` as
    ``[T, ffn]`` and the slices' partials; with bf16 operands
    (``tc_dw_scratch``) the staged bf16 copies, ``a`` and ``dh`` as bf16
    and the partials. ``csrc/ffn_bwd_dw.cu`` says why each is there. CPU
    tensors run ``ffn_bwd_dw_ref``."""
    t, d, ffn = _check(x, w1, w2, dy)
    if not _build.on_card(BWD_DW, x, dy, w1, w2):
        return ffn_bwd_dw_ref(dy, w1, w2, x, mxu_bf16=mxu_bf16)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    mode = _tc_mode(x, mxu_bf16)
    if mode:
        sms = _sms(x)
        _launch_tc(BWD_DW, [x, dy, w1, w2, dw1, dw2], tc_dw_scratch,
                   tc_dw_plan(t, d, ffn, sms), t, d, ffn, mode, sms)
        return dw1, dw2
    plan = dw_plan(t, d, ffn, _sms(x))
    _launch(BWD_DW, [x, dy, w1, w2, dw1, dw2], dw_scratch(t, d, ffn, plan),
            (t, d, ffn, *plan))
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
