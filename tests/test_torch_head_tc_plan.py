"""The tensor-core passes of the fused head's backward on the CPU
(``ops/fused_xent.py``): modes 1 (``mxu_bf16`` on f32) and 2 (bf16
storage) of ``csrc/head_xent_bwd.cu`` run its z pass and both products
on ``csrc/ffn_wgmma.cuh``, the vocabulary in bounded chunks, and the
wrapper hands them a chunk plan, scratch and a staging decision that
these tests hold.

The kernels cannot run here. These hold the plain Python functions: the
chunks cover the vocabulary in order, each a whole number of 256-column
tiles but the last; the scratch pieces are aligned for TMA and as large
as the kernel reads and writes, and ``dz`` stays one chunk wide (the
``[N, V]`` logits are never stored whole); an operand is staged into a
bf16 copy exactly where TMA cannot read it in place (and always in mode
1); mode 0's scratch (``bwd_scratch_floats``, the Python mirror of the
library's ``head_xent_bwd_scratch_floats``, which the card tests hold
equal) is as it was. Then a torch model of the tensor-core arithmetic
(per chunk: z summed in f32 from the bf16 operands, ``dz`` rounded to
bf16 once, ``dw_c = dz^T h`` rounded at its store, ``dh`` summed in f32
across the chunks in order and rounded once) is held against JAX's
Pallas ``head_xent_bwd`` in interpret mode, on bf16 storage and under
``mxu_bf16``, with targets outside ``[0, V)``, in one chunk and in
several.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.ops import pallas_xent as jx
from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
    tensor_from_numpy)
from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff
from distributed_llm_code_samples_tpu_torch.ops import fused_xent as fx

# (N, d, V): the LM's main shape and one TP rank's vocab shard of it
# (chip_smoke.py's LM_BF16_HEAD_SHAPES), ragged ones (a prime V past one
# chunk, d not a multiple of 8, a vocabulary under one tile)
SHAPES = {"main": (8192, 768, 50304), "tp_shard": (8192, 768, 12576),
          "ragged": (1001, 203, 1013), "prime": (300, 45, 16411),
          "tiny": (37, 20, 201)}


def _up(v, m):
    return -(-v // m) * m


@pytest.mark.parametrize("chunk", [None, 256, 2048, 6000])
@pytest.mark.parametrize("v", [50304, 12576, 16411, 1013, 256, 201, 1])
def test_chunks_cover_the_vocabulary_in_order(v, chunk):
    """No gap, no overlap, from column 0 to V; every chunk but the last a
    whole number of TC_BN-column tiles and as wide as the others, none
    wider than the cap rounded up to a tile; the kernel's own walk
    (v0 = 0, width, ...) gives the same chunks."""
    n_chunks, width = fx.head_tc_plan(v, chunk)
    cap = fx.HEAD_TC_CHUNK if chunk is None else chunk
    assert width % ff.TC_BN == 0 and width <= _up(cap, ff.TC_BN)
    bounds = fx.head_tc_chunks(v, (n_chunks, width))
    assert len(bounds) == n_chunks == -(-v // width)
    assert bounds[0][0] == 0 and bounds[-1][1] == v
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2 and hi - lo == width
    assert all(lo < hi for lo, hi in bounds)
    assert bounds == [(v0, min(v, v0 + width))
                      for v0 in range(0, v, width)]


def test_chunks_at_the_main_shape():
    """Six chunks of 8448 columns (the last 8064): each chunk's products
    are dh's 64 x 3 tiles (8448 deep) and dw's 66 x 3 (8192 deep), 390
    work items, 2.95 rounds of an H100's 132 SMs; dz [8192, 8448] bf16,
    138.4 MB. One TP rank's 12576 rows: two chunks of 6400."""
    n, d, v = SHAPES["main"]
    assert fx.head_tc_plan(v) == (6, 8448)
    assert fx.head_tc_chunks(v, (6, 8448))[-1] == (42240, 50304)
    tiles = -(-n // ff.TC_BM) * -(-d // ff.TC_BN) + \
        -(-8448 // ff.TC_BM) * -(-d // ff.TC_BN)
    assert tiles == 390 and round(tiles / ff.H100_SMS, 2) == 2.95
    assert fx.head_tc_plan(SHAPES["tp_shard"][2]) == (2, 6400)
    assert 2 * n * 8448 == 138412032


def _check_layout(pieces, want):
    """Pieces in the kernel's pointer order, each TC_PIECE-aligned (so
    16-byte aligned for TMA), of the bytes the kernel touches, no
    overlap."""
    total = pieces.pop("total")
    assert list(pieces) == [p for p in fx._TC_PIECES if p in want]
    assert set(pieces) == set(want)
    end = 0
    for name, (shape, off) in pieces.items():
        numel = 1
        for s in shape:
            numel *= s
        elem = 4 if name == "dh32" else 2
        assert numel * elem == want[name], name
        assert off % ff.TC_PIECE == 0 and off >= end
        end = off + want[name]
    assert end <= total < end + ff.TC_PIECE


@pytest.mark.parametrize("staged", [(), ("hs", "ws"), ("ws",)])
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_scratch_holds_what_the_kernel_reads(name, mode, staged):
    """The staged bf16 copies ``hs [N, d8]``, ``ws [V, d8]``; one chunk's
    ``dz`` as bf16 ``[N, width8]`` (the z pass writes it, both products
    read it); on bf16 storage dh's f32 sum ``dh32 [N, d]`` (mode 1 sums
    into the caller's f32 dh)."""
    n, d, v = SHAPES[name]
    plan = fx.head_tc_plan(v)
    d8 = _up(d, 8)
    copies = {"hs": 2 * n * d8, "ws": 2 * v * d8}
    want = {k: b for k, b in copies.items() if k in staged}
    want["dz"] = 2 * n * _up(plan[1], 8)
    if mode == 2:
        want["dh32"] = 4 * n * d
    _check_layout(fx.head_tc_scratch(n, d, v, plan, mode, staged), want)


def test_scratch_at_the_main_shape_is_one_chunk_of_bf16_dz():
    """Aligned bf16 operands at the main shape: no copies; dz 138.4 MB of
    bf16 (the f32 passes keep dz and dz^T of a 7296-column chunk in f32,
    2 x 239.1 MB), dh's f32 sum 25.2 MB; the TP shard's dz 104.9 MB.
    Mode 1 adds the bf16 copies of h and w, 12.6 and 77.3 MB."""
    n, d, v = SHAPES["main"]
    got = fx.head_tc_scratch(n, d, v, fx.head_tc_plan(v), 2)
    assert [k for k in got if k != "total"] == ["dz", "dh32"]
    assert got["dz"][0] == (n, 8448) and got["dh32"][0] == (n, d)
    assert got["total"] == 138412032 + 25165824
    shard = fx.head_tc_scratch(n, d, 12576, fx.head_tc_plan(12576), 2)
    assert shard["dz"][0] == (n, 6400) and 2 * n * 6400 == 104857600
    m1 = fx.head_tc_scratch(n, d, v, fx.head_tc_plan(v), 1, ("hs", "ws"))
    assert [k for k in m1 if k != "total"] == ["hs", "ws", "dz"]
    assert 2 * n * d == 12582912 and 2 * v * d == 77266944
    assert 4 * n * 7296 == 239075328


def test_staging_decision():
    """Mode 2 reads h and w in place when each base is 16-byte aligned
    and its rows a multiple of 8 elements (the TP shard's w, a row-offset
    view, at d 768 too); mode 1 rounds both into bf16 copies."""
    ops = {"hs": (1 << 20, 768), "ws": (3 << 20, 768)}
    assert ff.tc_staged(2, ops) == ()
    assert ff.tc_staged(1, ops) == ("hs", "ws")
    shard = (3 << 20) + 2 * 12576 * 768
    assert ff.tc_staged(2, dict(ops, ws=(shard, 768))) == ()
    assert ff.tc_staged(2, dict(ops, ws=(ops["ws"][0] + 2, 768))) == ("ws",)
    assert ff.tc_staged(2, {"hs": (1 << 20, 45), "ws": (3 << 20, 45)}) == \
        ("hs", "ws")


def test_mode0_scratch_unchanged():
    """Mode 0's scratch at the main shape and on the TP shard: h^T, h,
    w^T, w in f32 and one 8192-column-or-less chunk's dz and dz^T, as
    before the tensor-core modes (the library's own formula, which the
    card tests hold equal to this mirror)."""
    assert fx.bwd_scratch_floats(*SHAPES["main"]) == 209387520
    assert fx.bwd_scratch_floats(*SHAPES["tp_shard"]) == 136757248
    n, d, v = 37, 20, 201
    assert fx.bwd_scratch_floats(n, d, v) == (
        d * 40 + n * 20 + d * 204 + v * 20 + n * 256 + 256 * 40)


# -- the tensor-core arithmetic against JAX's Pallas kernels ---------------

def tc_model(h, w, targets, lse, plan):
    """What the tensor-core passes compute, in torch: h and w as bf16
    (rounded on f32 storage, mxu_bf16), widened to f32; per chunk of
    ``plan``: z = h w_c^T summed in f32, dz = (exp(z - lse) - onehot) / N
    in f32 (zero for a target outside the chunk) rounded to bf16 once,
    dw_c = dz^T h rounded once to the storage type, and dh summed in f32
    over the chunks in order, rounded once after the last."""
    store = h.dtype
    n, v = h.shape[0], w.shape[0]
    hm, wm = (x.to(torch.bfloat16).float() for x in (h, w))
    t = targets.long()
    dh, dws = None, []
    for v0, v1 in fx.head_tc_chunks(v, plan):
        z = hm @ wm[v0:v1].T
        onehot = (torch.arange(v0, v1)[None, :] == t[:, None]).float()
        dz = ((torch.exp(z - lse[:, None]) - onehot) * (1.0 / n)).to(
            torch.bfloat16).float()
        part = dz @ wm[v0:v1]
        dh = part if dh is None else dh + part
        dws.append((dz.T @ hm).to(store))
    return dh.to(store), torch.cat(dws)


def bf16_steps(got, want):
    """``(max steps, share that differ)``, a step at the larger of an
    element's magnitude and the output's RMS (chip_smoke.py's measure)."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, dtype=np.float32).astype(np.float64)
    rms = np.sqrt((w ** 2).mean())
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), rms))
    return (float((np.abs(g - w) / np.ldexp(1.0, e - 8)).max()),
            float((g != w).mean()))


@pytest.mark.parametrize("chunk", [None, 256])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("v", [1000, 200])
def test_tc_model_matches_jax_pallas_interpret(v, bf16, chunk):
    """N 64, d 32; V 1000 in one chunk and in four (three of 256, the
    last 232; dh summed across them), V 200 under one tile; targets -1,
    V and V + 55 beside in-range ones and the last column. bf16 storage
    (mode 2): dh and dw within one bf16 step of JAX's in at most 1% of
    the elements (JAX sums dh over its own vocab blocks). f32 storage
    under ``mxu_bf16`` (mode 1): within 2e-3 of JAX's largest output,
    the card tests' limit for bf16 operands: an f32-level difference in
    z can round an element of dz to the other bf16 neighbour."""
    n, d = 64, 32
    rng = np.random.default_rng(v + (7 if bf16 else 0))
    h = rng.normal(size=(n, d))
    w = 0.02 * rng.normal(size=(v, d))
    t = rng.integers(0, v, size=n).astype(np.int32)
    t[:4] = [-1, v, v + 55, v - 1]
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    jh, jw = jnp.asarray(h, dtype), jnp.asarray(w, dtype)
    kw = dict(interpret=True, mxu_bf16=not bf16)
    lse, _ = jx.head_xent_stats(jh, jw, t, **kw)
    want = jx.head_xent_bwd(jnp.float32(1.0), jh, jw, t, lse, **kw)
    plan = fx.head_tc_plan(v, chunk)
    assert plan[0] == (1 if chunk is None or v <= 256 else 4)
    got = tc_model(tensor_from_numpy(np.asarray(jh)),
                   tensor_from_numpy(np.asarray(jw)),
                   torch.from_numpy(t), torch.from_numpy(np.array(lse)),
                   plan)
    for g, x in zip(got, want):
        assert tuple(g.shape) == x.shape
        if bf16:
            assert g.dtype == torch.bfloat16
            most, share = bf16_steps(g, x)
            assert most <= 1 and share <= 0.01, (most, share)
        else:
            x = np.asarray(x)
            err = float(np.abs(g.numpy() - x).max())
            assert err <= 2e-3 * float(np.abs(x).max()), err
