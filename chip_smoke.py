#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phase kernel   # build + hold the kernels only
    python3 chip_smoke.py --phase train    # the FFN kernels + training
    python3 chip_smoke.py --phase lm       # the LM kernels + LM training
    python3 chip_smoke.py --phase ring     # the ring kernels + DDP/FSDP,
                                           # 4 virtual ranks on one card
    python3 chip_smoke.py --phase ep       # the all-to-all + expert
                                           # parallelism, 4 virtual ranks
    python3 chip_smoke.py --phase dist     # ring, DDP/FSDP, all-to-all
                                           # and EP on 4 cards (not in
                                           # the default run)

Builds every kernel of the port from ``csrc/``, holds each against its
plain PyTorch version on the card, times both, then drives the port's
paths:

- serving: requests through the ``DecodeEngine`` at the full width of
  the GPT-2-small LM of ``bench_decode.py`` (d=768, 12 layers, 12 heads,
  vocab 50304, max_seq_len 1024, random weights from a seed), once per
  ``kv_dtype`` with ``kernel="fused"`` and once at f32 with
  ``kernel="gather"``;
- training: ``train_single`` for 8 steps at ``bench.py``'s FFN-stack
  headline shape (d 768, 24 layers, ffn 3072, 8192 tokens a step,
  random weights from a seed), through the three FFN kernels
  (``use_pallas=True``, functional and manual loops) and through the
  matmul blocks as the oracle;
- LM training: ``train_lm_single`` for 8 steps at ``bench.py``'s
  LM-family shape (the GPT-2-small width above, 12 layers, 16 sequences
  of 512 tokens a step, random weights from a seed) under every
  attention x head policy: flash attention and the fused head through
  their four kernels, and the oracle ops;
- data parallelism: ``train_ddp`` and ``train_fsdp`` of that FFN stack
  on 4 ranks, 8 steps a rank, every collective one of the four ring
  kernels (the one hop, all-reduce, reduce-scatter and all-gather of
  ``csrc/ring_collectives.cu``). The default run holds the 4 ranks on
  one card in loopback (n workspaces, one cooperative launch a call);
  ``--phase dist``, not part of the default run, spawns one rank a card
  on 4 cards over NCCL and peer-mapped memory, holds each kernel against
  its plain ring and NCCL, trains both strategies under both transports
  and profiles rank 0;
- expert parallelism: ``train_moe_ep`` of the MoE stack of
  ``bench_moe.py``'s headline (d 768, 6 layers, 8 experts of ffn 3072,
  top-2, 8192 tokens a step over 4 ranks) for 8 steps a rank under each
  dispatch (dense, scatter, gather), every exchange the all-to-all
  kernel (``csrc/ring_collectives.cu``): on 4 virtual ranks of one card
  in the default run; ``--phase dist`` also runs it on 4 cards under
  both transports (NCCL's ``all_to_all_single`` and the kernel), which
  must end bit-identical.

It fails (exit code 1) if there is no CUDA device, if a kernel does not
build, launch or agree, if a kernel path did not go through its
kernels, if the head backward's bits differ from those its build gave
before its GEMM core moved into ``csrc/gemm_core.cuh`` or the FFN
weight gradients' from those before their passes moved into
``csrc/ffn_gemm.cuh`` (stored digests), or if the served tokens or the
trained weights are wrong.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it lists the kernels with their launches, errors and
times. This script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from functools import partial

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
L2_FLUSH_BYTES = 256 << 20       # well past the 50 MB L2

# the served model: bench_decode.py's GPT-2-small-proportioned LM
MODEL = dict(vocab=50304, d_model=768, n_layers=12, n_heads=12,
             max_seq_len=1024)
PROMPT_LENS = (17, 300, 45, 128, 64, 191, 100, 256)
MAX_NEW = 32
ENGINE = dict(max_slots=8, block_size=16, prefill_chunk=64,
              max_blocks_per_seq=64, n_blocks=1 + 8 * 64)
SEED = 0
TOL = 2e-5                       # max |kernel - plain| / max |plain|

# the trained model: bench.py's FFN-stack headline shape (bench.py:122-124)
TRAIN = dict(d_model=768, n_layers=24, tokens=8192, steps=8, random_seed=7)
FFN_DIM = 4 * TRAIN["d_model"]
# FFN kernel cases (name, T, d, ffn): the main path's shape and two
# ragged ones that no tile divides
FFN_SHAPES = (("main", TRAIN["tokens"], TRAIN["d_model"], FFN_DIM),
              ("ragged", 1000, 200, 520), ("small", 24, 40, 72))
# max |kernel - plain| / max |plain|. f32: the kernel sums up to 8192
# terms in another order than cuBLAS. bf16 operands: an f32-level
# difference in h can flip one bf16 rounding of a or dh.
FFN_TOL = {False: 1e-4, True: 2e-3}
# slices of the FFN kernels' pass 2, timed at the main shape in f32: the
# weight gradients' token axis (ops/fused_ffn.py dw_plan), the forward's
# and the input gradient's ffn axis (out_plan)
DW_SLICE_SWEEP = (1, 2, 4, 8, 9, 11, 12, 16)
OUT_SLICE_SWEEP = (1, 2, 3, 4, 6, 8, 12)
FFN_KERNELS = (("ffn_fwd", 4, "ops/pallas_ffn.py:129"),
               ("ffn_bwd_dx", 6, "ops/pallas_ffn.py:190"),
               ("ffn_bwd_dw", 8, "ops/pallas_ffn.py:250"))
# One step's gradients at the training shape. Both f32 paths sit some
# 0.2-0.6% (Frobenius, per layer) from a float64 reference: a
# pre-activation within rounding of 0 flips its ReLU mask between two
# summation orders, and each flip moves a whole token row by a few
# percent through the remaining layers. So the kernel path is held to
# the distance the cuBLAS f32 path has: per layer, its relative error
# against float64 at most GRAD_RATIO times the f32 matmul path's.
GRAD_RATIO = 2.0
# Per block, where no flip compounds: each kernel call the trainer makes
# in one step, against float64 on the inputs the trainer gave it. A call's
# error is the 99th percentile over output rows of |row - row64| /
# |row64|: a mask flip moves one row of dx or dw1 by a few percent, and
# the percentile lets up to 1% of the rows flip. f32 sums land near 1e-6
# by this measure, bf16 operands near 1e-3 (a control run shows it).
BLOCK_TOL = 1e-4
# The updates of the kernel run, step by step: each step's p_next - p
# through the kernels and through the f32 matmul blocks, each against a
# float64 step from the same p (the kernel run's own), pooled over the
# layers. The kernel step's relative error may be at most UPDATE_RATIO
# times the matmul step's; weights left unchanged have error exactly 1
# and fail. Each step starts from the same p because free runs drift
# apart: a weight that differs by rounding flips other ReLU masks at the
# next step. At the CLI's LR (1e-5) the updates are about 1e-12, below
# half an ulp of almost every weight, so those runs are for timing only
# (each layer scales activations by about 0.43, so the gradients at this
# depth are about 1e-8). At CHECK_LR a step's largest update is some
# 3e-5, about 1e4 ulps of a weight of 0.02 and well under 1% of it. The
# 8-step run must equal the chain of steps bit for bit.
CHECK_LR = 100.0
UPDATE_RATIO = 2.0

# the trained LM: bench.py's LM-family shape (bench.py:744-749), the
# GPT-2-small width the serving phase serves, at 512 positions
LM = dict(vocab=50304, d_model=768, n_layers=12, n_heads=12, seq_len=512,
          batch=16, steps=8, random_seed=7)
LM_TOKENS = LM["batch"] * LM["seq_len"]
# model flops a step, bench.py:752-755's count
LM_BLOCK_FLOPS = 3 * LM["batch"] * LM["n_layers"] * (
    8 * LM["seq_len"] * LM["d_model"] ** 2
    + 2 * LM["seq_len"] ** 2 * LM["d_model"]
    + 16 * LM["d_model"] ** 2 * LM["seq_len"])
LM_HEAD_FLOPS = 6 * LM_TOKENS * LM["d_model"] * LM["vocab"]
# (name, its module under ops/ and wrapper there, whose plain version is
# the wrapper's name + "_ref"; source, the TPU kernel it replaces, the
# launch counts it makes)
LM_KERNELS = (
    ("flash_attn_fwd", "flash_attention", "flash_attention_fwd",
     "flash_attn_fwd.cu", "ops/pallas_attention.py:149", ("flash_attn_fwd",)),
    ("flash_attn_bwd", "flash_attention", "flash_attention_bwd",
     "flash_attn_bwd.cu", "ops/pallas_attention.py:254",
     ("flash_attn_dq", "flash_attn_dkv")),
    ("head_xent_stats", "fused_xent", "head_xent_stats", "head_xent_fwd.cu",
     "ops/pallas_xent.py:186", ("head_xent_stats",)),
    ("head_xent_bwd", "fused_xent", "head_xent_bwd", "head_xent_bwd.cu",
     "ops/pallas_xent.py:245", ("head_xent_bwd",)))
LM_NAMES = tuple(k[0] for k in LM_KERNELS)
# kernel cases: flash (shape, heads, T, dh, causal) and head (shape, N, d,
# V): the main path's and ragged ones that no tile divides
FLASH_SHAPES = (("main", LM["batch"] * LM["n_heads"], LM["seq_len"],
                 LM["d_model"] // LM["n_heads"], True),
                ("ragged", 24, 200, 40, True), ("ragged", 24, 200, 40, False))
HEAD_SHAPES = (("main", LM_TOKENS, LM["d_model"], LM["vocab"]),
               ("ragged", 1000, 200, 50257))
# One step's gradients, leaf by leaf: the kernel path's relative error
# against float64 at most LM_GRAD_RATIO times the cuBLAS f32 oracle
# path's (two f32 paths are not held to a fixed tolerance, PERF.md §6).
LM_GRAD_RATIO = 2.0
LM_LOSS_TOL = 1e-5
# The head backward's bits from before its GEMM core moved into
# csrc/gemm_core.cuh (head_bits_digest on the previous build of
# head_xent_bwd.cu, on an NVIDIA H100 80GB HBM3): the move must not
# change one bit (tests/test_torch_cuda_kernels.py checks it too).
HEAD_BITS_SHA256 = (
    "974dab8abf840cd5e8d2d97d47b3923a3a9e28519c68237878b4f85754883daa")
# The weight-gradient kernel's bits from before it moved onto the passes
# it shares with the forward and the input gradient (csrc/ffn_gemm.cuh):
# ffn_dw_bits_digest on the previous build of ffn_bwd_dw.cu, on an NVIDIA
# H100 80GB HBM3. The move must not change one bit.
FFN_DW_BITS_SHA256 = (
    "ffdac082593112373c6865e0dc12449ebe1d9ccca14d6c44bfe14e5b7007f4c7")
# the passes of the three FFN kernels (csrc/ffn_gemm.cuh) by the names of
# their kernels in a profile: the template's tag names the FFN kernel
FFN_PASS = re.compile(
    r"(gemm_prep|hidden|slice|reduce)_kernel<ffn_gemm::(fwd|dx|dw)\b")
FFN_PASS_NAMES = {"gemm_prep": "copies", "hidden": "pass1",
                  "slice": "pass2", "reduce": "reduce"}
FFN_TAGS = {"fwd": "ffn_fwd", "dx": "ffn_bwd_dx", "dw": "ffn_bwd_dw"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# cycles of the device-side wait that holds a timed call's start event
# back until the host has launched the call (about 1 ms)
HOST_COVER_CYCLES = 2_000_000


class Timer:
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush, timed with CUDA events. The start event waits on the card
    behind a spin of ``HOST_COVER_CYCLES`` (``torch.cuda._sleep``), so the
    host's cost of launching ``fn`` falls before it and a call that the
    host launches slower than the card runs it reads its device time.
    ``with_host=True`` leaves the spin out (the flush-only measure this
    script took before): the flush alone then covers the host, and a
    slower host shows. ``align`` (across cards) enqueues a call that ends
    on every rank's card at about the same moment, such as a one-float
    NCCL all-reduce, after the spin: a collective then starts together on
    all the cards, and its time is not the skew between the ranks'
    hosts."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, reps: int = 20, with_host: bool = False,
           align=None) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            if not with_host:
                torch.cuda._sleep(HOST_COVER_CYCLES)
            if align is not None:
                align()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


# -- kernel phase ------------------------------------------------------------

def make_case(torch, np, kv_dtype, b, hq, hkv, dh, blk, mb, lengths, seed):
    """One paged-attention case on the card: a pool with random content
    (block 0 the zero scratch block), per-slot tables of distinct blocks
    in shuffled order with scratch tails, ragged ``lengths``."""
    from distributed_llm_code_samples_tpu_torch.decode.paged import _quantize
    rng = np.random.default_rng(seed)
    nb = 1 + b * mb
    src_k = rng.normal(size=(nb, hkv, blk, dh)).astype(np.float32)
    src_v = rng.normal(size=(nb, hkv, blk, dh)).astype(np.float32)
    src_k[0] = src_v[0] = 0.0
    k = torch.from_numpy(src_k).cuda()
    v = torch.from_numpy(src_v).cuda()
    ks = vs = None
    if kv_dtype == "int8":
        valid = torch.ones(nb, hkv, blk, dtype=torch.bool, device="cuda")
        k, ks = _quantize(k, valid)
        v, vs = _quantize(v, valid)
    elif kv_dtype == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // blk)
        tables[i, :used] = perm[i * mb:i * mb + used]
    q = torch.from_numpy(rng.normal(size=(b, hq, dh)).astype(
        np.float32)).cuda()
    return dict(q=q, pool_k=k.contiguous(), pool_v=v.contiguous(),
                k_scale=ks, v_scale=vs,
                tables=torch.from_numpy(tables).cuda(),
                lengths=torch.tensor(list(lengths), dtype=torch.int32,
                                     device="cuda"))


def bound(case, blk):
    """Least time of one launch: the bytes it must move (live KV blocks
    at the storage type, int8 scales, q, y, tables, lengths) over HBM
    rate, against its flops (QK and PV) over f32 rate."""
    q, k = case["q"], case["pool_k"]
    b, hq, dh = q.shape
    hkv = k.shape[1]
    lens = case["lengths"].tolist()
    live_rows = sum(-(-n // blk) * blk for n in lens)
    live_blocks = sum(-(-n // blk) for n in lens)
    nbytes = (2 * live_rows * hkv * dh * k.element_size()
              + (2 * live_blocks * hkv * 4 if case["k_scale"] is not None
                 else 0)
              + 2 * q.numel() * 4 + case["tables"].numel() * 4 + b * 4)
    flops = 4 * hq * dh * sum(lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_ms(torch, timer, case, blk):
    """One PyTorch call beside the kernel: scaled_dot_product_attention
    over the pre-gathered, dequantized view (no single PyTorch call
    reads a paged pool, so the gather is outside the timed call)."""
    import torch.nn.functional as F
    q, k, v = case["q"], case["pool_k"], case["pool_v"]
    b, hq, dh = q.shape
    hkv = k.shape[1]
    t = case["tables"].long()
    kk = k[t].float()
    vv = v[t].float()
    if case["k_scale"] is not None:
        kk = kk * case["k_scale"][t][..., None, None]
        vv = vv * case["v_scale"][t][..., None, None]
    tcap = t.shape[1] * blk
    kk = kk.permute(0, 2, 1, 3, 4).reshape(b, hkv, tcap, dh)
    vv = vv.permute(0, 2, 1, 3, 4).reshape(b, hkv, tcap, dh)
    g = hq // hkv
    kk = kk.repeat_interleave(g, dim=1).contiguous()
    vv = vv.repeat_interleave(g, dim=1).contiguous()
    qq = q[:, :, None, :]
    mask = (torch.arange(tcap, device="cuda")[None, :]
            < case["lengths"][:, None])[:, None, None, :]
    return timer.ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask))


def kernel_phase(torch, np, timer):
    from distributed_llm_code_samples_tpu_torch.ops.paged_attention import (
        paged_decode_attn, paged_decode_attn_ref)
    blk, mb, dh = ENGINE["block_size"], ENGINE["max_blocks_per_seq"], 64
    tcap = blk * mb
    # ragged: 1 (a pad row), a block boundary and one past it, tcap
    ragged = (1, blk, blk + 1, 300, 77, tcap, 5, 513)
    # the serving shapes: 8 slots, 12 heads, lengths of a decode step
    serving = tuple(n + 20 for n in PROMPT_LENS)
    cases = []
    for kv_dtype in ("f32", "bf16", "int8"):
        for hq, hkv, lens, tag in ((12, 12, serving, "serving"),
                                   (12, 12, ragged, "ragged"),
                                   (12, 4, ragged, "gqa")):
            cases.append((kv_dtype, hq, hkv, lens, tag))
    results = []
    for n, (kv_dtype, hq, hkv, lens, tag) in enumerate(cases):
        case = make_case(torch, np, kv_dtype, len(lens), hq, hkv, dh, blk,
                         mb, lens, seed=n)
        y = paged_decode_attn(**case)
        torch.cuda.synchronize()
        want = paged_decode_attn_ref(**case)
        err = float((y - want).abs().max())
        scale = float(want.abs().max())
        ok = bool(torch.isfinite(y).all()) and err <= TOL * scale
        b_ms, b_by = bound(case, blk)
        row = dict(kv_dtype=kv_dtype, shape=tag, heads=hq, kv_heads=hkv,
                   lengths=list(lens), max_abs_err=err,
                   rel_err=err / scale, ok=ok,
                   ms=timer.ms(lambda: paged_decode_attn(**case)),
                   plain_ms=timer.ms(lambda: paged_decode_attn_ref(**case)),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms(torch, timer, case, blk))
        results.append(row)
        print("kernel-case " + json.dumps(row), flush=True)
    return results


# -- serving phase -----------------------------------------------------------

def top2_gap(torch, params, tokens, pos):
    """The greedy top-2 logit gap at ``pos`` of ``tokens``, from the
    contiguous-cache decode (teacher-forced up to ``pos - 1``)."""
    from distributed_llm_code_samples_tpu_torch.models.lm import decode_step
    n_heads = MODEL["n_heads"]
    dh = params.d_model // n_heads
    shape = (params.n_layers, 1, params.blocks.wk.shape[1] // dh,
             params.max_seq_len, dh)
    ck = torch.zeros(shape, device="cuda")
    cv = torch.zeros(shape, device="cuda")
    with torch.no_grad():
        for t in range(pos):
            logits = decode_step(params, ck, cv,
                                 torch.tensor([tokens[t]], device="cuda"),
                                 t, n_heads)
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def profile_summary(prof, wall_ms):
    """Device time by kernel from a torch.profiler trace of one run: the
    device-side events only (kernels, copies, fills), so no time is
    counted twice under the CPU op that launched it."""
    per = []
    for e in prof.key_averages():
        if getattr(e.device_type, "name", str(e.device_type)) == "CPU":
            continue
        per.append((e.device_time_total / 1e3, e.key, e.count))
    per.sort(reverse=True)
    busy = sum(t for t, _, _ in per)
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "device_events": sum(c for _, _, c in per),
            "top": [{"kernel": k[:80], "ms": t, "calls": c}
                    for t, k, c in per[:10]]}


def ffn_passes(prof):
    """Device ms and launches of each FFN kernel's passes in a traced run
    (``FFN_PASS``), and each kernel's share of the three's device time."""
    out = {}
    for e in prof.key_averages():
        m = FFN_PASS.search(e.key)
        if m is None or getattr(e.device_type, "name",
                                str(e.device_type)) == "CPU":
            continue
        row = out.setdefault(FFN_TAGS[m[2]], {}).setdefault(
            FFN_PASS_NAMES[m[1]], {"ms": 0.0, "calls": 0})
        row["ms"] += e.device_time_total / 1e3
        row["calls"] += e.count
    ms = {k: sum(p["ms"] for p in v.values()) for k, v in out.items()}
    for k, v in out.items():
        v["ms"], v["share"] = ms[k], ms[k] / sum(ms.values())
    return out


def serving_phase(torch, np, card):
    from distributed_llm_code_samples_tpu_torch.decode import (DecodeEngine,
                                                               EngineConfig)
    from distributed_llm_code_samples_tpu_torch.models.lm import (generate,
                                                                  init_lm)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_lm(gen, MODEL["vocab"], MODEL["d_model"],
                     MODEL["n_layers"], MODEL["max_seq_len"],
                     n_heads=MODEL["n_heads"])
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, MODEL["vocab"], size=n).tolist()
               for n in PROMPT_LENS]
    # staggered: three requests, two steps later three more, one step
    # later the last two, so admission happens between steps
    arrivals = {0: prompts[:3], 2: prompts[3:6], 3: prompts[6:]}

    def serve(kv_dtype, kernel, rep):
        eng = DecodeEngine(params, MODEL["n_heads"], EngineConfig(
            **ENGINE, kv_dtype=kv_dtype, kernel=kernel))
        torch.cuda.synchronize()
        reset_launch_counts()
        uids, t_sub, t_tok = [], {}, {}
        t0 = time.perf_counter()
        step = 0
        while step <= max(arrivals) or eng.waiting or eng.active:
            for p in arrivals.get(step, []):
                uid = eng.submit(p, MAX_NEW)
                uids.append(uid)
                t_sub[uid], t_tok[uid] = time.perf_counter(), []
            check(eng.step(), "engine stalled")
            now = time.perf_counter()       # the step read its picks back
            for u in uids:
                seq = next((s for s in eng.slots
                            if s is not None and s.uid == u), None)
                n = (len(eng.finished[u]) - eng.prompt_lens[u]
                     if u in eng.finished else len(seq.out) if seq else 0)
                t_tok[u] += [now] * (n - len(t_tok[u]))
            step += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts().get("paged_decode_attn", 0)
        done = eng.finished
        toks = [done.get(u) for u in uids]
        check(not eng.failed, f"requests failed: {eng.failed}")
        check(all(t is not None and len(t) == len(p) + MAX_NEW
                  and all(0 <= x < MODEL["vocab"] for x in t)
                  for t, p in zip(toks, prompts)), "bad token lists")
        ttft = [t_tok[u][0] - t_sub[u] for u in uids]
        itl = [b - a for u in uids for a, b in zip(t_tok[u], t_tok[u][1:])]
        run = dict(kv_dtype=kv_dtype, kernel=kernel, rep=rep,
                   requests=len(uids), failed=len(eng.failed),
                   tokens_generated=eng.tokens_generated, wall_s=wall,
                   tokens_per_sec=eng.tokens_generated / wall,
                   ttft_ms_median=1e3 * statistics.median(ttft),
                   ttft_ms_max=1e3 * max(ttft), ttft_n=len(ttft),
                   itl_ms_median=1e3 * statistics.median(itl),
                   itl_ms_p90=1e3 * pct(itl, 0.9), itl_n=len(itl),
                   engine_steps=eng.steps,
                   decode_dispatches=eng.decode_dispatches,
                   prefill_dispatches=eng.prefill_dispatches,
                   mean_occupancy=eng.mean_occupancy(),
                   kernel_launches=launches, card=card)
        print("serve-run " + json.dumps(run), flush=True)
        want = (MODEL["n_layers"] * eng.decode_dispatches
                if kernel == "fused" else 0)
        check(launches == want,
              f"{kernel} {kv_dtype}: {launches} kernel launches, expected "
              f"{want} (layers x decode dispatches)")
        return toks, run

    # two passes over the four configurations: the first one pays the
    # one-time set-up (cuBLAS handles, the allocator), the second is the
    # steady state; both are checked, and the pair shows the spread
    configs = (("f32", "gather"), ("f32", "fused"), ("bf16", "fused"),
               ("int8", "fused"))
    runs = {}
    for rep in (1, 2):
        for cfg in configs:
            runs[cfg + (rep,)] = serve(*cfg, rep)

    # fused f32 against the gather oracle, token for token; a mismatch
    # passes only at a near tie of the gather path's top two logits
    ref = runs[("f32", "gather", 2)][0]
    for rep in (1, 2):
        got = runs[("f32", "fused", rep)][0]
        for i, (a, b) in enumerate(zip(got, ref)):
            if a == b:
                continue
            pos = next(t for t in range(len(a)) if a[t] != b[t])
            gap = top2_gap(torch, params, b, pos)
            print(f"serve-mismatch request {i} position {pos} "
                  f"top2-gap {gap:.3e}", flush=True)
            check(gap < 1e-3, f"fused != gather at request {i}, pos {pos}")
    check(runs[("f32", "gather", 1)][0] == ref, "gather runs disagree")
    # the engine against the contiguous-cache greedy decode, on the
    # shortest prompts (an oracle that shares no paged code)
    for i in (0, 2):
        want = generate(params, torch.tensor([prompts[i]]), MAX_NEW,
                        MODEL["n_heads"])[0].tolist()
        if want != ref[i]:
            pos = next(t for t in range(len(want)) if want[t] != ref[i][t])
            gap = top2_gap(torch, params, want, pos)
            print(f"serve-vs-generate mismatch request {i} position {pos} "
                  f"top2-gap {gap:.3e}", flush=True)
            check(gap < 1e-3, f"engine != generate at request {i}")
    fused_launches = sum(r["kernel_launches"] for (_, k, _), (_, r)
                         in runs.items() if k == "fused")

    # where the device time goes in one fused f32 run (a traced run:
    # the profiler's own cost is in its wall time)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve("f32", "fused", "traced")
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print("profile " + json.dumps(dict(profile_summary(prof, wall_ms),
                                       card=card)), flush=True)
    return fused_launches


# -- FFN kernels -------------------------------------------------------------

def ffn_bound(name, flop_mult, t, d, f, mxu_bf16):
    """Least time of one launch: its flops over the rate of its operand
    type, against the bytes it must move (each input read once, each
    output written once, f32) over the HBM rate."""
    flops = flop_mult * t * d * f
    floats = {"ffn_fwd": 2 * t * d + 2 * d * f,
              "ffn_bwd_dx": 3 * t * d + 2 * d * f,
              "ffn_bwd_dw": 2 * t * d + 4 * d * f}[name]
    t_ops = flops / (BF16_FLOPS_PER_S if mxu_bf16 else F32_FLOPS_PER_S) * 1e3
    t_bytes = 4 * floats / HBM_BYTES_PER_S * 1e3
    return flops, ((t_ops, "operations") if t_ops >= t_bytes
                   else (t_bytes, "bytes"))


def ffn_kernel_phase(torch, np, timer):
    """Each FFN kernel against its plain version at every shape of
    ``FFN_SHAPES``, both operand modes: error, determinism, times."""
    from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff
    # (kernel, plain) with the backward wrappers' argument order
    fns = {"ffn_fwd": (lambda dy, *w, **k: ff.ffn_fwd_fused(*w, **k),
                       lambda dy, *w, **k: ff.ffn_fwd_ref(*w, **k)),
           "ffn_bwd_dx": (ff.ffn_bwd_dx_fused, ff.ffn_bwd_dx_ref),
           "ffn_bwd_dw": (ff.ffn_bwd_dw_fused, ff.ffn_bwd_dw_ref)}
    results = []
    for n, (shape, t, d, f) in enumerate(FFN_SHAPES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(100 + n)
        w1 = 2e-2 * torch.randn(f, d, generator=gen, device="cuda")
        w2 = 2e-2 * torch.randn(d, f, generator=gen, device="cuda")
        x = torch.randn(t, d, generator=gen, device="cuda")
        dy = 0.1 * torch.randn(t, d, generator=gen, device="cuda")
        for mxu_bf16 in (False, True):
            for name, mult, _ in FFN_KERNELS:
                kern = partial(fns[name][0], dy, w1, w2, x,
                               mxu_bf16=mxu_bf16)
                plain = partial(fns[name][1], dy, w1, w2, x,
                                mxu_bf16=mxu_bf16)
                got, again = kern(), kern()
                torch.cuda.synchronize()
                want = plain()
                got, again, want = (v if isinstance(v, tuple) else (v,)
                                    for v in (got, again, want))
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                scale = max(float(w.abs().max()) for w in want)
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                same = all(torch.equal(g, a) for g, a in zip(got, again))
                flops, (b_ms, b_by) = ffn_bound(name, mult, t, d, f,
                                                mxu_bf16)
                ms = timer.ms(kern)
                row = dict(kernel=name, shape=shape, T=t, d=d, ffn=f,
                           mxu_bf16=mxu_bf16, max_abs_err=err,
                           rel_err=err / scale, tol=FFN_TOL[mxu_bf16],
                           deterministic=same,
                           ok=finite and same
                           and err <= FFN_TOL[mxu_bf16] * scale,
                           ms=ms, plain_ms=timer.ms(plain),
                           bound_ms=b_ms, bound_by=b_by,
                           tflops_per_s=flops / ms / 1e9,
                           library_ms=None)
                results.append(row)
                print("ffn-kernel-case " + json.dumps(row), flush=True)
        if shape == "main":
            for name, tag, attr, depth, counts in (
                    ("ffn_fwd", "fwd", "out_plan", f, OUT_SLICE_SWEEP),
                    ("ffn_bwd_dx", "dx", "out_plan", f, OUT_SLICE_SWEEP),
                    ("ffn_bwd_dw", "dw", "dw_plan", t, DW_SLICE_SWEEP)):
                print(f"ffn-{tag}-slices " + json.dumps(dict(
                    shape=shape, plan=list(getattr(ff, attr)(t, d, f)),
                    ms=slice_sweep(torch, timer, ff, attr, depth, counts,
                                   partial(fns[name][0], dy, w1, w2, x),
                                   partial(fns[name][1], dy, w1, w2, x)))),
                    flush=True)
        del w1, w2, x, dy
    digest = ffn_dw_bits_digest(torch, np, ff)
    row = dict(kernel="ffn_bwd_dw", shape="bits", mxu_bf16=None,
               sha256=digest, want=FFN_DW_BITS_SHA256, max_abs_err=0.0,
               rel_err=0.0, ok=digest == FFN_DW_BITS_SHA256)
    print("ffn-dw-bits " + json.dumps(row), flush=True)
    results.append(row)
    return results


def slice_sweep(torch, timer, ff, attr, depth, counts, kern, plain):
    """``{slices: {ms, rel_err}}`` of an f32 FFN kernel ``kern`` with its
    pass 2's depth cut into each of ``counts`` slices (its plan function
    ``ff.<attr>`` replaced for the run; restored after), each run first
    held to ``FFN_TOL`` against the plain version."""
    def tup(v):
        return v if isinstance(v, tuple) else (v,)

    want = tup(plain())
    scale = max(float(w.abs().max()) for w in want)
    default, out = getattr(ff, attr), {}
    try:
        for s in counts:
            length = -(-(-(-depth // s)) // ff.BK) * ff.BK
            plan = (-(-depth // length), length)
            setattr(ff, attr, lambda *_, plan=plan: plan)
            err = max(float((g - w).abs().max())
                      for g, w in zip(tup(kern()), want))
            check(err <= FFN_TOL[False] * scale,
                  f"{attr} at {plan[0]} slices disagrees: {err}")
            out[plan[0]] = dict(ms=timer.ms(kern), rel_err=err / scale)
    finally:
        setattr(ff, attr, default)
    return out


def ffn_dw_bits_digest(torch, np, ff):
    """sha256 over dw1 and dw2 of ``ffn_bwd_dw`` calls in each operand
    mode, on inputs made with numpy: a ragged shape whose tokens split
    into three slices (the partials and their ordered sum) and one with
    no dim a multiple of 4 (the padded copies), also in three slices."""
    import hashlib
    rng = np.random.default_rng(2025)
    out = hashlib.sha256()
    for t, d, f in ((1000, 200, 520), (1001, 13, 9)):
        w1 = (0.02 * rng.normal(size=(f, d))).astype(np.float32)
        w2 = (0.02 * rng.normal(size=(d, f))).astype(np.float32)
        x = rng.normal(size=(t, d)).astype(np.float32)
        dy = (0.1 * rng.normal(size=(t, d))).astype(np.float32)
        args = [torch.from_numpy(a).cuda() for a in (dy, w1, w2, x)]
        for mxu_bf16 in (False, True):
            for g in ff.ffn_bwd_dw_fused(*args, mxu_bf16=mxu_bf16):
                out.update(g.cpu().numpy().tobytes())
    return out.hexdigest()


# -- training phase ----------------------------------------------------------

FFN_WRAPPERS = {"ffn_fwd": ("ffn_fwd_fused", "ffn_fwd_ref"),
                "ffn_bwd_dx": ("ffn_bwd_dx_fused", "ffn_bwd_dx_ref"),
                "ffn_bwd_dw": ("ffn_bwd_dw_fused", "ffn_bwd_dw_ref")}


@contextlib.contextmanager
def recorded_calls(wrappers):
    """Within the block, every call of each wrapper ``module.attr`` of
    ``wrappers`` (``{kernel: (module, attr)}``) is recorded as ``(kernel,
    args, kwargs, outputs)``, with copies of the tensors (SGD updates the
    params in place); ``outputs`` is a tuple."""
    calls, saved = [], {}

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((name, [a.clone() for a in args], dict(kw),
                          [o.clone() for o in outs]))
            return out
        return call

    for name, (mod, attr) in wrappers.items():
        saved[(mod, attr)] = getattr(mod, attr)
        setattr(mod, attr, recorder(name, saved[(mod, attr)]))
    try:
        yield calls
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def row_err(torch, got, want):
    """99th percentile over rows of |got - want| / |want| (see
    ``BLOCK_TOL``)."""
    num = (got.double() - want).norm(dim=1)
    return float(torch.quantile(num / want.norm(dim=1).clamp_min(1e-300),
                                0.99))


def block_errors(torch, ff, calls):
    """For each recorded call: its operand mode, its error against the
    float64 plain version on the same inputs, and the error the same
    kernel makes there with bf16 operands (the control)."""
    rows = []
    for name, args, kw, outs in calls:
        wrapper, ref = FFN_WRAPPERS[name]
        want = getattr(ff, ref)(*(a.double() for a in args), mxu_bf16=False)
        want = want if isinstance(want, tuple) else (want,)
        bf16 = getattr(ff, wrapper)(*args, mxu_bf16=True)
        bf16 = bf16 if isinstance(bf16, tuple) else (bf16,)
        rows.append(dict(
            kernel=name, mxu_bf16=bool(kw.get("mxu_bf16", False)),
            err=max(row_err(torch, o, w) for o, w in zip(outs, want)),
            bf16_err=max(row_err(torch, o, w) for o, w in zip(bf16, want))))
    return rows


def update_err(torch, got, want, p0):
    """Relative error of the update ``got - p0`` against ``want - p0``,
    pooled over the layers."""
    du = want.double() - p0.double()
    return float((got.double() - want.double()).norm() / du.norm())


def train_phase(torch, np, card):
    """``train_single`` at ``TRAIN`` through the kernels (functional and
    manual loops) and through the matmul blocks; returns the kernel
    launches of the first kernel run."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        FFNStackParams, init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        ffn_block, fused_ffn_block, launch_counts, reset_launch_counts,
        stack_grads)
    from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff
    from distributed_llm_code_samples_tpu_torch.parallel import train_single
    d, n_layers, tokens = TRAIN["d_model"], TRAIN["n_layers"], TRAIN["tokens"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TRAIN["random_seed"])
    params = init_ffn_stack(gen, d, n_layers)
    seeds = make_seed_schedule(TRAIN["steps"], TRAIN["random_seed"])
    flops = 12 * tokens * d * FFN_DIM * n_layers
    want_launches = n_layers * TRAIN["steps"]

    def run(label, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        stamps = []

        def on_step(_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        t0 = time.perf_counter()
        train_single(params, seeds, tokens, d, lr=LR, on_step=on_step, **kw)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        row = dict(run=label, steps=len(steps), tokens_per_step=tokens,
                   wall_s=wall, median_step_ms=1e3 * med,
                   first_step_ms=1e3 * steps[0],
                   tokens_per_s=tokens / med,
                   model_tflops_per_s=flops / med / 1e12,
                   f32_peak_share=flops / med / F32_FLOPS_PER_S,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 2 ** 30, kernel_launches=launches, card=card)
        print("train-run " + json.dumps(row), flush=True)
        return launches

    launches = run("pallas-1", use_pallas=True)
    run("pallas-2", use_pallas=True)
    launches_b = run("pallas-manual", use_pallas=True, manual_loop=True)
    launches_c = run("matmul")
    for name, _, _ in FFN_KERNELS:
        for label, got, want in (("pallas", launches, want_launches),
                                 ("pallas-manual", launches_b,
                                  want_launches),
                                 ("matmul", launches_c, 0)):
            check(got.get(name, 0) == want,
                  f"{label}: {got.get(name, 0)} launches of {name}, "
                  f"expected {want}")

    # one step's gradients, per layer: the kernel path and the f32 matmul
    # path each against the float64 matmul path (see GRAD_RATIO)
    x, dl = batch_from_seed(seeds[0], tokens, d, device="cuda")
    gk = stack_grads(params.w1, params.w2, x, dl, block=fused_ffn_block)[1]
    gm = stack_grads(params.w1, params.w2, x, dl, block=ffn_block)[1]
    g64 = stack_grads(params.w1.double(), params.w2.double(), x.double(),
                      dl.double(), block=ffn_block)[1]
    kernel_err, matmul_err = [], []
    for a, b, c in zip(gk, gm, g64):
        for l in range(n_layers):
            ref = c[l].norm()
            kernel_err.append(float((a[l].double() - c[l]).norm() / ref))
            matmul_err.append(float((b[l].double() - c[l]).norm() / ref))
    del gk, gm, g64
    ratio = max(k / max(m, 1e-30) for k, m in zip(kernel_err, matmul_err))

    # per block: the trainer's own kernel calls of one step (BLOCK_TOL)
    with recorded_calls({n: (ff, w) for n, (w, _) in
                         FFN_WRAPPERS.items()}) as calls:
        train_single(params, seeds[:1], tokens, d, lr=LR, use_pallas=True)
    blocks = block_errors(torch, ff, calls)
    per_kernel = {n: sum(b["kernel"] == n for b in blocks)
                  for n in FFN_WRAPPERS}
    del calls

    # the kernel run's steps at CHECK_LR, each against float64 from the
    # same params (UPDATE_RATIO)
    def batch64(seed, batch, dim, dtype, device):
        return tuple(v.double() for v in
                     batch_from_seed(seed, batch, dim, device=device))

    p, upd_k, upd_m, unchanged, finite = params, [], [], [], True
    for seed in seeds:
        nxt = train_single(p, [seed], tokens, d, lr=CHECK_LR,
                           use_pallas=True)
        mm = train_single(p, [seed], tokens, d, lr=CHECK_LR)
        w64 = train_single(FFNStackParams(p.w1.double(), p.w2.double()),
                           [seed], tokens, d, lr=CHECK_LR, batch_fn=batch64)
        for k, m, w, p0 in zip(nxt, mm, w64, p):
            upd_k.append(update_err(torch, k, w, p0))
            upd_m.append(update_err(torch, m, w, p0))
            unchanged.append(update_err(torch, p0, w, p0))   # exactly 1
        finite &= all(bool(torch.isfinite(t).all()) for t in nxt + mm)
        p = nxt
    upd_ratio = max(k / m for k, m in zip(upd_k, upd_m))
    unchanged_ratio = min(u / m for u, m in zip(unchanged, upd_m))
    full = train_single(params, seeds, tokens, d, lr=CHECK_LR,
                        use_pallas=True)
    chained = all(torch.equal(a, b) for a, b in zip(full, p))
    del p, nxt, mm, w64, full
    print("train-check " + json.dumps(dict(
        grad_err_vs_f64_kernel_max=max(kernel_err),
        grad_err_vs_f64_matmul_max=max(matmul_err),
        grad_err_ratio_max=ratio, grad_ratio_limit=GRAD_RATIO,
        block_calls=per_kernel,
        block_bf16_calls=sum(b["mxu_bf16"] for b in blocks),
        block_err_max=max(b["err"] for b in blocks),
        block_bf16_control_err_min=min(b["bf16_err"] for b in blocks),
        block_tol=BLOCK_TOL, check_lr=CHECK_LR,
        update_err_vs_f64_kernel_max=max(upd_k),
        update_err_vs_f64_matmul_max=max(upd_m),
        update_err_ratio_max=upd_ratio,
        update_unchanged_ratio_min=unchanged_ratio,
        update_ratio_limit=UPDATE_RATIO, steps_chain_identical=chained,
        finite=finite)), flush=True)
    check(finite, "trained params are not finite")
    check(ratio <= GRAD_RATIO, f"kernel grads {ratio:.2f}x as far from "
          f"float64 as the f32 matmul path's")
    check(all(n == n_layers for n in per_kernel.values()),
          f"one step made {per_kernel} kernel calls, expected {n_layers} "
          f"of each")
    check(not any(b["mxu_bf16"] for b in blocks),
          "the trainer called a kernel with bf16 operands")
    check(max(b["err"] for b in blocks) <= BLOCK_TOL,
          "a kernel call of the trainer disagrees with float64")
    check(min(b["bf16_err"] for b in blocks) > BLOCK_TOL,
          "the block check cannot tell bf16 operands from f32")
    check(upd_ratio <= UPDATE_RATIO, f"kernel updates {upd_ratio:.2f}x as "
          f"far from float64 as the f32 matmul path's")
    check(unchanged_ratio > UPDATE_RATIO,
          "the update check cannot tell unchanged weights from trained")
    check(chained, "the 8-step kernel run differs from its chain of steps")

    # where the device time goes in one kernel run (a traced run: the
    # profiler's own cost is in its wall time)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_single(params, seeds, tokens, d, lr=LR, use_pallas=True)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print("train-profile " + json.dumps(dict(profile_summary(prof, wall_ms),
                                             ffn_passes=ffn_passes(prof),
                                             card=card)), flush=True)
    return launches


def ffn_kernel_rows(cases, launches):
    rows = []
    for name, _, replaces in FFN_KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        main = next(c for c in mine
                    if c["shape"] == "main" and not c["mxu_bf16"])
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_code_samples_tpu_torch/csrc/"
                      f"{name}.cu",
            "replaces": f"distributed_llm_code_samples_tpu/{replaces}",
            "launches": None if launches is None else launches.get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["rel_err"] for c in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "ok": all(c["ok"] for c in mine)})
    return rows


# -- LM kernels ---------------------------------------------------------------

def causal_pairs(tq, tk, causal):
    """(query, key) pairs the attention needs."""
    if not causal:
        return tq * tk
    return sum(min(i + 1, tk) for i in range(tq))


def lm_bound(name, shape, mxu_bf16):
    """Least time of one call: its flops at the rate of its operand type
    against the bytes it must move (each f32 input read once, each
    output written once) over the HBM rate. The flops are the function's,
    not the kernels': flash counts the pairs the causal mask leaves, two
    products forward and five backward (s, dp, dq, dk, dv); the head one
    product for its statistics and three backward (z, dh, dw). The
    flash backward executes more (7 products): each of its two launches
    recomputes the score and dp tiles; the head's backward executes its
    three."""
    if name.startswith("flash"):
        bh, t, dh, causal = shape
        pairs = bh * causal_pairs(t, t, causal)
        flops = (4 if name == "flash_attn_fwd" else 10) * dh * pairs
        floats = (4 * bh * t * dh + bh * t if name == "flash_attn_fwd"
                  else 8 * bh * t * dh + bh * t)
    else:
        n, d, v = shape
        flops = (2 if name == "head_xent_stats" else 6) * n * d * v
        floats = (n * d + v * d + 3 * n if name == "head_xent_stats"
                  else 2 * n * d + 2 * v * d + 2 * n)
    t_ops = flops / (BF16_FLOPS_PER_S if mxu_bf16 else F32_FLOPS_PER_S) * 1e3
    t_bytes = 4 * floats / HBM_BYTES_PER_S * 1e3
    return flops, ((t_ops, "operations") if t_ops >= t_bytes
                   else (t_bytes, "bytes"))


def sdpa_ms(torch, timer, q, k, v, dy, causal, backward):
    """The library yardstick: f32 scaled_dot_product_attention on the
    same inputs, forward alone or forward + backward."""
    import torch.nn.functional as F
    if not backward:
        return timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        torch.autograd.grad(out, leaves, dy)
    return timer.ms(fwd_bwd)


def lm_case_row(torch, timer, name, shape_tag, shape, mxu_bf16, kern, plain,
                library):
    """One kernel against its plain version: per-output error over max
    |plain|, a bit-identical repeat, times and bound."""
    got, again = kern(), kern()
    torch.cuda.synchronize()
    want = plain()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    scales = [float(w.abs().max()) for w in want]
    rel = max(e / s for e, s in zip(errs, scales))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    flops, (b_ms, b_by) = lm_bound(name, shape, mxu_bf16)
    ms = timer.ms(kern)
    row = dict(kernel=name, shape=shape_tag, dims=list(shape),
               mxu_bf16=mxu_bf16, max_abs_err=max(errs), rel_err=rel,
               plain_max_abs=scales, tol=FFN_TOL[mxu_bf16],
               deterministic=same,
               ok=finite and same and rel <= FFN_TOL[mxu_bf16],
               ms=ms, plain_ms=timer.ms(plain), bound_ms=b_ms,
               bound_by=b_by, tflops_per_s=flops / ms / 1e9,
               library_ms=library)
    print("lm-kernel-case " + json.dumps(row), flush=True)
    return row


def lm_kernel_phase(torch, np, timer):
    """The four LM kernels against their plain versions at the main
    path's shapes and ragged ones, both operand modes (limits
    ``FFN_TOL``: 1e-4 f32, 2e-3 bf16 operands)."""
    from distributed_llm_code_samples_tpu_torch.ops import fused_xent as fx
    from distributed_llm_code_samples_tpu_torch.ops import (
        flash_attention as fa)
    rows = []
    for n, (tag, bh, t, dh, causal) in enumerate(FLASH_SHAPES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(200 + n)
        q, k, v = (torch.randn(bh, t, dh, generator=gen, device="cuda")
                   for _ in range(3))
        dy = 0.1 * torch.randn(bh, t, dh, generator=gen, device="cuda")
        y, lse = fa.flash_attention_fwd_ref(q, k, v, causal=causal)
        lib_f = sdpa_ms(torch, timer, q, k, v, dy, causal, False)
        lib_b = sdpa_ms(torch, timer, q, k, v, dy, causal, True)
        for mxu_bf16 in (False, True):
            kw = dict(causal=causal, mxu_bf16=mxu_bf16)
            rows.append(lm_case_row(
                torch, timer, "flash_attn_fwd", tag, (bh, t, dh, causal),
                mxu_bf16, partial(fa.flash_attention_fwd, q, k, v, **kw),
                partial(fa.flash_attention_fwd_ref, q, k, v, **kw), lib_f))
            rows.append(lm_case_row(
                torch, timer, "flash_attn_bwd", tag, (bh, t, dh, causal),
                mxu_bf16,
                partial(fa.flash_attention_bwd, dy, q, k, v, y, lse, **kw),
                partial(fa.flash_attention_bwd_ref, dy, q, k, v, y, lse,
                        **kw), lib_b))
        del q, k, v, dy, y, lse
    for n, (tag, tokens, d, vocab) in enumerate(HEAD_SHAPES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(300 + n)
        h = torch.randn(tokens, d, generator=gen, device="cuda")
        w = 0.02 * torch.randn(vocab, d, generator=gen, device="cuda")
        tgt = torch.randint(0, vocab, (tokens,), generator=gen,
                            device="cuda")
        tgt[-1] = vocab - 1                      # the last column
        lse = fx.head_xent_stats_ref(h, w, tgt)[0]
        dy = torch.tensor(1.0, device="cuda")
        for mxu_bf16 in (False, True):
            kw = dict(mxu_bf16=mxu_bf16)
            rows.append(lm_case_row(
                torch, timer, "head_xent_stats", tag, (tokens, d, vocab),
                mxu_bf16, partial(fx.head_xent_stats, h, w, tgt, **kw),
                partial(fx.head_xent_stats_ref, h, w, tgt, **kw), None))
            rows.append(lm_case_row(
                torch, timer, "head_xent_bwd", tag, (tokens, d, vocab),
                mxu_bf16, partial(fx.head_xent_bwd, dy, h, w, tgt, lse, **kw),
                partial(fx.head_xent_bwd_ref, dy, h, w, tgt, lse, **kw),
                None))
        del h, w, tgt, lse
    digest = head_bits_digest(torch, np, fx)
    row = dict(kernel="head_xent_bwd", shape="bits", mxu_bf16=None,
               sha256=digest, want=HEAD_BITS_SHA256, max_abs_err=0.0,
               rel_err=0.0, ok=digest == HEAD_BITS_SHA256)
    print("lm-head-bits " + json.dumps(row), flush=True)
    rows.append(row)
    return rows


def head_bits_digest(torch, np, fx):
    """sha256 over dh and dw of one small ``head_xent_bwd`` call in each
    operand mode, on inputs made with numpy (lse in float64 on the host),
    so that only the kernel runs on the card."""
    import hashlib
    rng = np.random.default_rng(2024)
    n, d, v = 96, 40, 777
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (0.02 * rng.normal(size=(v, d))).astype(np.float32)
    t = rng.integers(0, v, size=n)
    z = h.astype(np.float64) @ w.astype(np.float64).T
    m = z.max(axis=1)
    lse = (m + np.log(np.exp(z - m[:, None]).sum(axis=1))).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (h, w, t, lse)]
    out = hashlib.sha256()
    for mxu_bf16 in (False, True):
        dh, dw = fx.head_xent_bwd(torch.tensor(1.0, device="cuda"), *args,
                                  mxu_bf16=mxu_bf16)
        for g in (dh, dw):
            out.update(g.cpu().numpy().tobytes())
    return out.hexdigest()


# -- LM training phase ---------------------------------------------------------

def lm_wrappers():
    """``{kernel: (module, wrapper name)}`` of the four LM wrappers, from
    ``LM_KERNELS``."""
    import importlib
    return {name: (importlib.import_module(
        f"distributed_llm_code_samples_tpu_torch.ops.{mod}"), attr)
        for name, mod, attr, *_ in LM_KERNELS}


def lm_call_errors(torch, wrappers, calls):
    """For each recorded call: its error against float64 on its own inputs
    (the plain version), and the control's: the same call with ``causal``
    flipped (flash) or with bf16 operands (head). The error is
    ``row_err``'s 99th percentile over rows; it passes over the rows that
    are zero in exact arithmetic, such as each head's first row of dq
    (``ds_00 = p_00 (dp_00 - D_0) = 0``), 1 row in 512 at the LM shape."""
    rows = []
    for name, args, kw, outs in calls:
        mod, attr = wrappers[name]
        args64 = [a.double() if a.is_floating_point() else a for a in args]
        want = getattr(mod, attr + "_ref")(*args64, **kw)
        flip = ({"causal": not kw.get("causal", True)}
                if name.startswith("flash") else {"mxu_bf16": True})
        control = getattr(mod, attr)(*args, **dict(kw, **flip))

        def err(got):
            return max(row_err(torch, g.reshape(-1, g.shape[-1])
                               if g.dim() > 1 else g.reshape(1, -1),
                               w.reshape(-1, w.shape[-1])
                               if w.dim() > 1 else w.reshape(1, -1))
                       for g, w in zip(got, want))
        rows.append(dict(kernel=name,
                         mxu_bf16=bool(kw.get("mxu_bf16", False)),
                         err=err(outs), control_err=err(control)))
    return rows


def grad_errs(torch, got, want):
    """Per leaf, ``|got - want| / |want|`` (Frobenius)."""
    return [float((g.double() - w).norm() / w.norm())
            for g, w in zip(got, want)]


def lm_train_phase(torch, np, card):
    """``train_lm_single`` at ``LM`` under the four attention x head
    policies; the kernels' and the trainer's correctness against float64;
    a profile. Returns the launches of the first kernel-path run."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        lm_batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.lm import (
        init_lm, lm_from_leaves, lm_leaves)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        lm_grads, resolve_attn, resolve_head, train_lm_single)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM["random_seed"])
    params = init_lm(gen, LM["vocab"], LM["d_model"], LM["n_layers"],
                     LM["seq_len"], n_heads=LM["n_heads"])
    seeds = make_seed_schedule(LM["steps"], LM["random_seed"])
    flops = LM_BLOCK_FLOPS + LM_HEAD_FLOPS
    train = partial(train_lm_single, params, seeds, LM_TOKENS, LM["d_model"],
                    lr=LR, seq_len=LM["seq_len"], n_heads=LM["n_heads"])

    def run(label, attn_impl, head_impl):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        stamps = []

        def on_step(_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        t0 = time.perf_counter()
        train(attn_impl=attn_impl, head_impl=head_impl, on_step=on_step)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        print("lm-train-run " + json.dumps(dict(
            run=label, attn_impl=attn_impl or "oracle",
            head_impl=head_impl or "oracle", steps=len(steps),
            tokens_per_step=LM_TOKENS, wall_s=wall, median_step_ms=1e3 * med,
            first_step_ms=1e3 * steps[0], tokens_per_s=LM_TOKENS / med,
            model_tflops_per_s=flops / med / 1e12,
            f32_peak_share=flops / med / F32_FLOPS_PER_S,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            kernel_launches=launches, card=card)), flush=True)
        steps_n, layers = LM["steps"], LM["n_layers"]
        want = {"flash_attn_fwd": layers * steps_n if attn_impl else 0,
                "flash_attn_dq": layers * steps_n if attn_impl else 0,
                "flash_attn_dkv": layers * steps_n if attn_impl else 0,
                "head_xent_stats": steps_n if head_impl else 0,
                "head_xent_bwd": steps_n if head_impl else 0}
        for kname, n in want.items():
            check(launches.get(kname, 0) == n,
                  f"{label}: {launches.get(kname, 0)} launches of {kname}, "
                  f"expected {n}")
        check(set(launches) <= set(want), f"{label}: launches {launches}")
        return launches

    launches = run("kernels-1", "flash", "fused")
    run("kernels-2", "flash", "fused")
    for attn_impl, head_impl in ((None, None), ("flash", None),
                                 (None, "fused")):
        run(f"{attn_impl or 'oracle'}+{head_impl or 'oracle'}", attn_impl,
            head_impl)

    # step 0 from the initial params: the loss of both paths, and the
    # gradients of each f32 path against float64 (the oracle ops), leaf by
    # leaf (LM_GRAD_RATIO); a zero gradient reads exactly 1 and fails
    b = LM_TOKENS // LM["seq_len"]
    toks, tgts = lm_batch_from_seed(int(seeds[0]), b, LM["seq_len"],
                                    LM["vocab"], device="cuda")
    n_heads = LM["n_heads"]
    loss_k, g_k = lm_grads(params, toks, tgts, n_heads, resolve_attn("flash"),
                           resolve_head("fused"))
    loss_o, g_o = lm_grads(params, toks, tgts, n_heads)
    p64 = lm_from_leaves([t.double() for t in lm_leaves(params)])
    loss_64, g_64 = lm_grads(p64, toks, tgts, n_heads)
    del p64
    err_k, err_o = grad_errs(torch, g_k, g_64), grad_errs(torch, g_o, g_64)
    del g_k, g_o, g_64
    ratio = max(k / max(o, 1e-30) for k, o in zip(err_k, err_o))
    zero_ratio = min(1.0 / max(o, 1e-30) for o in err_o)
    loss_rel = abs(float(loss_k) - float(loss_o)) / abs(float(loss_o))

    # per call: the trainer's own kernel calls of one step against float64
    # on their inputs (BLOCK_TOL), with a control that must fail
    wrappers = lm_wrappers()
    with recorded_calls(wrappers) as calls:
        train_lm_single(params, seeds[:1], LM_TOKENS, LM["d_model"], lr=LR,
                        seq_len=LM["seq_len"], n_heads=n_heads,
                        attn_impl="flash", head_impl="fused")
    per_kernel = {n: sum(c[0] == n for c in calls) for n in LM_NAMES}
    blocks = lm_call_errors(torch, wrappers, calls)
    del calls
    names = ("wte", "wpe", "ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2",
             "ln_f")
    print("lm-train-check " + json.dumps(dict(
        loss_kernel=float(loss_k), loss_oracle=float(loss_o),
        loss_f64=float(loss_64), loss_rel_diff=loss_rel,
        loss_tol=LM_LOSS_TOL,
        grad_err_vs_f64_kernel=dict(zip(names, err_k)),
        grad_err_vs_f64_oracle=dict(zip(names, err_o)),
        grad_err_ratio_max=ratio, grad_ratio_limit=LM_GRAD_RATIO,
        zero_grad_ratio_min=zero_ratio, block_calls=per_kernel,
        block_bf16_calls=sum(b["mxu_bf16"] for b in blocks),
        block_err_max={n: max(b["err"] for b in blocks if b["kernel"] == n)
                       for n in LM_NAMES},
        block_control_err_min={n: min(b["control_err"] for b in blocks
                                      if b["kernel"] == n)
                               for n in LM_NAMES},
        block_tol=BLOCK_TOL, card=card)), flush=True)
    check(loss_rel <= LM_LOSS_TOL,
          f"kernel and oracle losses differ by {loss_rel:.2e} (relative)")
    check(all(np.isfinite(err_k)), "kernel-path gradients are not finite")
    check(ratio <= LM_GRAD_RATIO, f"kernel-path gradients {ratio:.2f}x as "
          f"far from float64 as the f32 oracle path's")
    check(zero_ratio > LM_GRAD_RATIO,
          "the gradient check cannot tell a zero gradient from the oracle's")
    want_calls = {"flash_attn_fwd": LM["n_layers"],
                  "flash_attn_bwd": LM["n_layers"], "head_xent_stats": 1,
                  "head_xent_bwd": 1}
    check(per_kernel == want_calls,
          f"one step made {per_kernel} kernel calls, expected {want_calls}")
    check(not any(b["mxu_bf16"] for b in blocks),
          "the trainer called a kernel with bf16 operands")
    check(max(b["err"] for b in blocks) <= BLOCK_TOL,
          "a kernel call of the trainer disagrees with float64")
    check(min(b["control_err"] for b in blocks) > BLOCK_TOL,
          "a kernel call's control does not fail the float64 check")

    # where the device time goes in one kernel-path run (a traced run: the
    # profiler's own cost is in its wall time)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(attn_impl="flash", head_impl="fused")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    summary = profile_summary(prof, wall_ms)
    head_ms = sum(e.device_time_total / 1e3 for e in prof.key_averages()
                  if getattr(e.device_type, "name", "") != "CPU"
                  and "head_xent" in e.key)
    busy = summary["device_busy_ms"]
    summary.update(head_kernel_ms=head_ms,
                   head_kernel_share=head_ms / busy if busy else None,
                   card=card)
    print("lm-train-profile " + json.dumps(summary), flush=True)
    return launches


def lm_kernel_rows(cases, launches):
    rows = []
    for name, _, _, src, replaces, counted in LM_KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        main = next(c for c in mine
                    if c["shape"] == "main" and not c["mxu_bf16"])
        main_bf16 = next(c for c in mine
                         if c["shape"] == "main" and c["mxu_bf16"])
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_code_samples_tpu_torch/csrc/{src}",
            "replaces": f"distributed_llm_code_samples_tpu/{replaces}",
            "launches": None if launches is None
            else sum(launches.get(c, 0) for c in counted),
            "launches_by_kernel": None if launches is None
            else {c: launches.get(c, 0) for c in counted},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["rel_err"] for c in mine),
            "ms": main["ms"], "ms_bf16": main_bf16["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "ok": all(c["ok"] for c in mine)})
    return rows


# -- ring collectives ----------------------------------------------------------

RING_N = 4                        # ranks of the data-parallel slice
NVLINK_BYTES_PER_S = 450e9        # H100 SXM NVLink, each way
# (name, the TPU kernel it replaces); all four in csrc/ring_collectives.cu
RING_KERNELS = (("ppermute_dma", "ops/pallas_ring.py:151"),
                ("ring_all_reduce", "ops/pallas_ring.py:190"),
                ("ring_reduce_scatter", "ops/pallas_ring.py:328"),
                ("ring_all_gather", "ops/pallas_ring.py:406"))
RING_NAMES = tuple(k[0] for k in RING_KERNELS)
D_MODEL = TRAIN["d_model"]
# (kernel, shape tag, per-rank input shape): the slice's (DDP's all-reduce
# of each layer's dw1 and dw2; FSDP's gathers of the w1 and w2 shards and
# its scatters of the full gradients; the hop of one [768, 3072] block)
# and a ragged one each (chunks of 105 floats: the scalar path)
RING_CASES = (("ring_all_reduce", "dw1", (FFN_DIM, D_MODEL)),
              ("ring_all_reduce", "dw2", (D_MODEL, FFN_DIM)),
              ("ring_reduce_scatter", "dw1", (FFN_DIM, D_MODEL)),
              ("ring_reduce_scatter", "dw2", (D_MODEL, FFN_DIM)),
              ("ring_all_gather", "w1_shard", (FFN_DIM // RING_N, D_MODEL)),
              ("ring_all_gather", "w2_shard", (D_MODEL // RING_N, FFN_DIM)),
              ("ppermute_dma", "block", (D_MODEL, FFN_DIM)),
              ("ring_all_reduce", "ragged", (RING_N * 7, 5, 3)),
              ("ring_reduce_scatter", "ragged", (RING_N * 7, 5, 3)),
              ("ring_all_gather", "ragged", (7, 5, 3)),
              ("ppermute_dma", "ragged", (7, 5, 3)))
# the case whose times stand in the kernels line
RING_MAIN = {"ppermute_dma": "block", "ring_all_reduce": "dw1",
             "ring_reduce_scatter": "dw1", "ring_all_gather": "w1_shard"}
# a ring call against float64 on its n inputs: max |out - want| / max
# |want|. Four f32 terms summed in any order land within a few ulps of the
# sum's largest partial; the control leaves one rank's contribution out
# (sums), or takes a rank's own block for its neighbour's (copies).
RING_TOL = 1e-5


def ring_want(torch, op, xs, control=False):
    """What each of the n ranks must hold after ``op`` on ``xs`` (one
    input a rank), in float64; ``control`` gives a wrong answer that the
    check must reject."""
    n = len(xs)
    x64 = [x.double() for x in xs]
    if op == "ppermute_dma":
        return [x64[(r if control else r - 1) % n] for r in range(n)]
    if op == "ring_all_gather":
        order = [1, 0] + list(range(2, n)) if control else range(n)
        full = torch.cat([x64[i] for i in order])
        return [full] * n
    outs = []
    for r in range(n):
        total = sum(x64[i] for i in range(n)
                    if not (control and i == (r + 1) % n))
        outs.append(total if op == "ring_all_reduce" else
                    total.chunk(n)[r])
    return outs


def ring_err(torch, outs, want):
    """max |out - want| over the ranks, over max |want|."""
    scale = max(float(w.abs().max()) for w in want) or 1.0
    return max(float((o.double() - w).abs().max())
               for o, w in zip(outs, want)) / scale


def ring_bytes(op, in_bytes, n):
    """Bytes one rank sends over its link (and receives) in ``op`` on an
    ``in_bytes`` input: 2(n-1)/n of the tensor for the all-reduce, (n-1)/n
    of the full tensor for the reduce-scatter and the all-gather, the
    block for the hop."""
    return {"ring_all_reduce": 2 * (n - 1) * in_bytes / n,
            "ring_reduce_scatter": (n - 1) * in_bytes / n,
            "ring_all_gather": (n - 1) * in_bytes,
            "ppermute_dma": in_bytes}[op]


def ring_loopback_bound(op, in_bytes, n):
    """Least time of one loopback call on one card: the n inputs read and
    the n outputs written once, over the HBM rate (no link is crossed)."""
    out_bytes = {"ring_reduce_scatter": in_bytes / n,
                 "ring_all_gather": in_bytes * n}.get(op, in_bytes)
    return n * (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, "bytes"


def ring_kernel_phase(torch, np, timer):
    """The four ring kernels in loopback (``RING_N`` virtual ranks on one
    card, one cooperative launch) against their plain versions (the same
    ring order in plain torch over the n tensors): bit-identical, with a
    bit-identical repeat, at the slice's shapes and ragged ones."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    ws = ring.PeerWorkspace(4 * FFN_DIM * D_MODEL, "cuda", n=RING_N)
    rows = []
    try:
        for k, (op, tag, shape) in enumerate(RING_CASES):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(400 + k)
            xs = [torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(RING_N)]
            got = ring.loopback(op, xs, ws)
            again = ring.loopback(op, xs, ws)
            torch.cuda.synchronize()
            ws.check()
            want = ring.loopback_ref(op, xs)
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            f64 = ring_err(torch, got, ring_want(torch, op, xs))
            f64_control = ring_err(torch, got,
                                   ring_want(torch, op, xs, control=True))
            b_ms, b_by = ring_loopback_bound(op, 4 * xs[0].numel(), RING_N)
            row = dict(kernel=op, shape=tag, dims=list(shape),
                       ranks=RING_N, mode="loopback", max_abs_err=err,
                       bit_identical=exact, deterministic=same,
                       err_vs_f64=f64, control_err_vs_f64=f64_control,
                       ok=finite and same and exact and f64 <= RING_TOL
                       and f64_control > RING_TOL,
                       ms=timer.ms(lambda: ring.loopback(op, xs, ws)),
                       ms_with_host=timer.ms(lambda: ring.loopback(op, xs, ws),
                                             with_host=True),
                       plain_ms=timer.ms(lambda: ring.loopback_ref(op, xs)),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            rows.append(row)
            print("ring-kernel-case " + json.dumps(row), flush=True)
            del xs, got, again, want
    finally:
        ws.close()
    return rows


@contextlib.contextmanager
def checked_ring_calls(torch, ring):
    """Within the block every loopback ring call is held against float64
    on its n inputs (and its control), as it happens: yields the list of
    ``(kernel, err, control_err)``."""
    seen, inner = [], ring.loopback

    def launch(op, xs, ws):
        outs = inner(op, xs, ws)
        seen.append((op, ring_err(torch, outs, ring_want(torch, op, xs)),
                     ring_err(torch, outs, ring_want(torch, op, xs,
                                                     control=True))))
        return outs

    ring.loopback = launch
    try:
        yield seen
    finally:
        ring.loopback = inner


def ring_train_phase(torch, np, card):
    """DDP and FSDP of the FFN stack at ``TRAIN``'s width on ``RING_N``
    virtual ranks of one card, every collective a ring kernel (loopback):
    8 steps a rank, 8192 tokens a rank a step. Returns the launches of the
    two runs."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts, ring)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, launch, make_mesh, train_ddp, train_fsdp, unshard_params)
    d, n_layers, tokens = TRAIN["d_model"], TRAIN["n_layers"], TRAIN["tokens"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TRAIN["random_seed"])
    params = init_ffn_stack(gen, d, n_layers)
    seeds = make_seed_schedule(RING_N * TRAIN["steps"], TRAIN["random_seed"])
    mesh = make_mesh({DATA_AXIS: RING_N}, loopback=True)
    flops = 12 * tokens * d * FFN_DIM * n_layers * RING_N
    trainers = {"ddp": train_ddp, "fsdp": train_fsdp}

    def run(name, seeds, lr):
        def body(me, _):
            stamps = []

            def on_step(_):
                if me.rank == 0:
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
            out = trainers[name](params, seeds, tokens, d, me, lr=lr,
                                 comm="pallas_ring", on_step=on_step)
            return out, stamps

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = launch(body, mesh)
        return outs, t0, launch_counts()

    steps_n = TRAIN["steps"]
    want = {"ddp": {"ring_all_reduce": 2 * n_layers * steps_n,
                    "ppermute_dma": 1},
            "fsdp": {"ring_all_gather": 4 * n_layers * steps_n,
                     "ring_reduce_scatter": 2 * n_layers * steps_n,
                     "ppermute_dma": 1}}
    launches = {}
    for name in ("ddp", "fsdp"):
        outs, t0, got = run(name, seeds, LR)
        stamps = outs[0][1]
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        print("ring-train-run " + json.dumps(dict(
            run=f"{name}-loopback", ranks=RING_N, mode="loopback",
            steps_per_rank=len(steps), tokens_per_rank_step=tokens,
            median_step_ms=1e3 * med, first_step_ms=1e3 * steps[0],
            tokens_per_s=RING_N * tokens / med,
            model_tflops_per_s=flops / med / 1e12,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            kernel_launches=got, card=card)), flush=True)
        check(got == want[name], f"{name} loopback: launches {got}, "
              f"expected {want[name]}")
        launches[name] = got
        del outs

    # one step a rank at CHECK_LR, every ring call held against float64 as
    # it happens; then DDP's update against FSDP's (the same per-rank
    # gradients, summed in two ring orders)
    with checked_ring_calls(torch, ring) as calls:
        ddp = run("ddp", seeds[:RING_N], CHECK_LR)[0][0][0]
        fsdp = unshard_params([o[0] for o in
                               run("fsdp", seeds[:RING_N], CHECK_LR)[0]])
    calls_by = {n: sum(c[0] == n for c in calls) for n in RING_NAMES}
    du = sum(float((a.double() - p.double()).norm() ** 2)
             for a, p in zip(ddp, params)) ** 0.5
    diff = sum(float((a.double() - b.double()).norm() ** 2)
               for a, b in zip(ddp, fsdp)) ** 0.5
    err_max = {n: max([c[1] for c in calls if c[0] == n], default=None)
               for n in RING_NAMES}
    control_min = {n: min([c[2] for c in calls if c[0] == n], default=None)
                   for n in RING_NAMES}
    print("ring-train-check " + json.dumps(dict(
        calls=calls_by, call_err_vs_f64_max=err_max,
        call_control_err_min=control_min, ring_tol=RING_TOL,
        check_lr=CHECK_LR, ddp_vs_fsdp_update_err=diff / du,
        unchanged_update_err=1.0, card=card)), flush=True)
    check(calls_by == {"ppermute_dma": 2, "ring_all_reduce": 2 * n_layers,
                       "ring_all_gather": 4 * n_layers,
                       "ring_reduce_scatter": 2 * n_layers},
          f"one step a rank made ring calls {calls_by}")
    check(max(c[1] for c in calls) <= RING_TOL,
          "a ring call of the trainers disagrees with float64")
    check(min(c[2] for c in calls) > RING_TOL,
          "a ring call's control passes the float64 check")
    check(diff / du <= RING_TOL, f"DDP and FSDP updates differ by "
          f"{diff / du:.2e} of the update")
    return launches


def ring_kernel_rows(cases, launches, mode="loopback"):
    """The ring kernels' entries of the kernels line: launches from the
    main path's runs, the rest from the main case of each."""
    rows = []
    for name, replaces in RING_KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        main = next(c for c in mine if c["shape"] == RING_MAIN[name])
        rows.append({
            "name": name, "route": "cuda",
            "source": "distributed_llm_code_samples_tpu_torch/csrc/"
                      "ring_collectives.cu",
            "replaces": f"distributed_llm_code_samples_tpu/{replaces}",
            "launches": None if launches is None
            else sum(run.get(name, 0) for run in launches.values()),
            "mode": mode, "ranks": RING_N,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "ok": all(c["ok"] for c in mine)})
    return rows


# -- expert parallelism ----------------------------------------------------------

# the MoE stack of bench_moe.py's headline (bench_moe.py:46-52, run at
# :100-103): d 768, 6 layers, 8 experts of ffn 3072, top-2, capacity
# factor 2, aux coefficient 0.01; 8192 tokens a step over the EP group of
# EP_N ranks (2048 routed by each), 8 steps a rank. The LR is the
# package's (train_ffns.py:29), the -m 7 CLI's default: at bench_moe.py's
# 0.1 the gradients, summed over 8192 tokens, overflow the weights to inf
# and NaN within the first three steps at this width.
EP = dict(d_model=768, n_layers=6, n_experts=8, k=2, capacity_factor=2.0,
          aux_coef=0.01, lr=1e-5, tokens=8192, steps=8, random_seed=7)
EP_N = RING_N
EP_FFN = 4 * EP["d_model"]
EP_T = EP["tokens"] // EP_N
# a rank's capacity, ceil(C_global / n): C_global = 8192 / 8 * 2 = 2048
EP_CAP = 512
EP_DISPATCHES = ("dense", "scatter", "gather")
# exchanges a layer and a step: the dispatch and the return, then the
# backward's transposes of both
EP_A2A_PER_LAYER = 4
A2A_REPLACES = "ops/pallas_ring.py:490"
# (tag, per-rank input shape): the dispatch operand [E, C, d], the
# return's after its split dim moved to the front [n*C, E/n, d], a ragged
# one (chunks of 105 floats: the scalar path), and one whose chunk j of
# rank r holds 10 r + j everywhere
A2A_CASES = (("dispatch", (EP["n_experts"], EP_CAP, EP["d_model"])),
             ("return", (EP_N * EP_CAP, EP["n_experts"] // EP_N,
                         EP["d_model"])),
             ("ragged", (EP_N * 3, 5, 7)),
             ("identifying", (EP_N, 1000)))
A2A_MAIN = "dispatch"
# ranges a chunk of the all-to-all (ops/ring.py A2A_RANGES, 32; capped at
# 4 in a loopback of 4 ranks), timed at the main case
A2A_RANGE_SWEEP = (4, 16, 32, 64)
# ranges a chunk of the reduce-scatter (ops/ring.py RS_RANGES, 32), timed
# across the cards at the main case (dw1)
RS_RANGE_SWEEP = (8, 16, 32, 64)
# one step's gradients, leaf by leaf: EP's relative error against a
# float64 dense run at most EP_GRAD_RATIO times the f32 dense oracle's
# (the GRAD_RATIO pattern)
EP_GRAD_RATIO = 2.0
# a token whose expert choice differs between EP and the dense oracle
# passes only at a logit gap below this (the two f32 paths may sum in
# other orders); the group's later layers then follow from it
ROUTE_GAP_TOL = 1e-4


def a2a_input(torch, tag, shape, r, n, seed):
    """Rank r's input of an all-to-all case."""
    if tag == "identifying":
        return (10.0 * r + torch.arange(n, device="cuda"))[:, None].repeat(
            1, shape[1]).contiguous()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda")


def a2a_identified(torch, got, r, n):
    """Whether rank r's output of the identifying case holds 10 j + r at
    chunk j."""
    return bool((got[:, 0] == 10.0 * torch.arange(n, device=got.device)
                 + r).all())


def a2a_kernel_phase(torch, np, timer):
    """The all-to-all kernel in loopback (``EP_N`` virtual ranks on one
    card, one cooperative launch) against its plain version (the chunks
    moved in plain torch): bit-identical, with a bit-identical repeat; a
    control, the un-exchanged input, must differ."""
    from distributed_llm_code_samples_tpu_torch.ops import ring
    op = ring.ALL_TO_ALL
    ws = ring.PeerWorkspace(4 * EP["n_experts"] * EP_CAP * EP["d_model"],
                            "cuda", n=EP_N)
    rows = []
    try:
        for k, (tag, shape) in enumerate(A2A_CASES):
            xs = [a2a_input(torch, tag, shape, r, EP_N, 600 + 10 * k + r)
                  for r in range(EP_N)]
            got = ring.loopback(op, xs, ws)
            again = ring.loopback(op, xs, ws)
            torch.cuda.synchronize()
            ws.check()
            want = ring.loopback_ref(op, xs)
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            control = all(torch.equal(g, x) for g, x in zip(got, xs))
            ident = tag != "identifying" or all(
                a2a_identified(torch, g, r, EP_N) for r, g in enumerate(got))
            b_ms, b_by = ring_loopback_bound(op, 4 * xs[0].numel(), EP_N)
            row = dict(kernel=op, shape=tag, dims=list(shape), ranks=EP_N,
                       mode="loopback",
                       max_abs_err=max(float((g - w).abs().max())
                                       for g, w in zip(got, want)),
                       bit_identical=exact, deterministic=same,
                       control_equal_to_input=control, identified=ident,
                       ok=exact and same and not control and ident,
                       ms=timer.ms(lambda: ring.loopback(op, xs, ws)),
                       ms_with_host=timer.ms(lambda: ring.loopback(op, xs, ws),
                                             with_host=True),
                       plain_ms=timer.ms(lambda: ring.loopback_ref(op, xs)),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            rows.append(row)
            print("a2a-kernel-case " + json.dumps(row), flush=True)
            del xs, got, again, want
        shape = dict(A2A_CASES)[A2A_MAIN]
        xs = [a2a_input(torch, A2A_MAIN, shape, r, EP_N, 650 + r)
              for r in range(EP_N)]
        print("a2a-ranges " + json.dumps(dict(
            shape=A2A_MAIN, mode="loopback",
            ms=range_sweep(torch, timer.ms, ring, ws.check, lambda: [
                torch.equal(g, w) for g, w in zip(
                    ring.loopback(op, xs, ws), ring.loopback_ref(op, xs))],
                lambda: ring.loopback(op, xs, ws)))), flush=True)
        stamps = ring.traced(lambda: ring.loopback(op, xs, ws), "cuda")
        ws.check()
        print("a2a-trace " + json.dumps(dict(
            shape=A2A_MAIN, mode="loopback", phases=ring.A2A_PHASES,
            ranks=a2a_trace_summary(stamps, EP_N, EP_N))), flush=True)
    finally:
        ws.close()
    return rows


def a2a_trace_summary(stamps, n, ranks):
    """The all-to-all kernel's own trace of one call (``ring.traced``:
    ``[blocks, phases]`` ns; ``ranks`` virtual ranks' blocks in turn, each
    rank's 2n - 1 roles of P blocks: own chunk, pushes, copy-outs) as
    microseconds from the rank's first block entry: for each role, the
    median and the last of each of its phases, and the call's end."""
    from distributed_llm_code_samples_tpu_torch.ops.ring import A2A_PHASES
    rows = stamps.tolist()
    per_rank = len(rows) // ranks
    p = per_rank // (2 * n - 1)
    out = []
    for r in range(ranks):
        mine = rows[r * per_rank:(r + 1) * per_rank]
        t0 = min(b[0] for b in mine)

        def phases(blocks, cols):
            res = {}
            for i in cols:
                us = sorted((b[i] - t0) / 1e3 for b in blocks)
                res[A2A_PHASES[i]] = {"median": us[len(us) // 2],
                                      "last": us[-1]}
            return res

        own, push, copy = (mine[:p], mine[p:n * p], mine[n * p:])
        out.append(dict(own=phases(own, (0, 1, 2)),
                        push=phases(push, (0, 1, 2)),
                        copy_out=phases(copy, (0, 3, 4)),
                        end_us=(max(max(b[2] for b in own + push),
                                    max(b[4] for b in copy)) - t0) / 1e3))
    return out


def range_sweep(torch, time_ms, ring, check_ws, agree, kern, sweep=None):
    """``{label: ms}`` of a kernel under each setting of ``sweep``
    (``{label: {ops.ring attribute: value}}``; by default the all-to-all
    at each ranges a chunk of ``A2A_RANGE_SWEEP``; the kernel takes at
    most its cap), timed by ``time_ms``, each run first checked with
    ``agree`` (a list of bools) and the workspace's error word; the
    defaults are restored."""
    if sweep is None:
        sweep = {p: {"A2A_RANGES": p} for p in A2A_RANGE_SWEEP}
    saved, out = {}, {}
    try:
        for label, setting in sweep.items():
            for attr, value in setting.items():
                saved.setdefault(attr, getattr(ring, attr))
                setattr(ring, attr, value)
            ok = all(agree())
            torch.cuda.synchronize()
            check_ws()
            check(ok, f"{setting}: the kernel disagrees")
            out[label] = time_ms(kern)
    finally:
        for attr, value in saved.items():
            setattr(ring, attr, value)
    return out


def rs_trace_summary(stamps):
    """One rank's reduce-scatter trace (``ops.ring.traced``) in
    microseconds from its first block's entry: when its pushing blocks
    started and finished, and when its blocks (every block sums) saw
    their range land from every source and had summed their part (min,
    median, max)."""
    s = stamps.double()
    t0 = s[:, 0].min()
    push, summed = s[s[:, 1] > 0], s

    def spread(v):
        v = (v - t0) / 1e3
        return [float(v.min()), float(v.median()), float(v.max())]

    return dict(pushing_blocks=len(push), summing_blocks=len(summed),
                push_start_us=spread(push[:, 1]),
                pushed_us=spread(push[:, 2]),
                arrived_us=spread(summed[:, 3]),
                released_us=spread(summed[:, 4]))


@contextlib.contextmanager
def recorded_routes(torch, moe, gaps=False):
    """Within the block every ``ops.moe.route_topk`` call records its
    expert indices (and, with ``gaps``, each token's smallest gap between
    neighbouring logits of its top k+1) under the calling thread: yields
    ``{thread ident: [idx or (idx, gap), ...]}``."""
    seen, inner = {}, moe.route_topk

    def route(wg, x, k=2, renormalize=True):
        idx, gates = inner(wg, x, k, renormalize)
        rec = idx
        if gaps:
            top = torch.sort(x.detach() @ wg.detach().T, dim=-1,
                             descending=True).values[:, :k + 1]
            rec = (idx, (top[:, :-1] - top[:, 1:]).min(1).values)
        seen.setdefault(threading.get_ident(), []).append(rec)
        return idx, gates

    moe.route_topk = route
    try:
        yield seen
    finally:
        moe.route_topk = inner


def kept_pairs(moe, routes):
    """The (token, choice) pairs that found a slot in each step, over
    recorded routes (each thread's a layer at a time, step by step; each
    ``[T, k]`` of one rank's layer at the capacity ``EP_CAP``)."""
    per_step = [0] * EP["steps"]
    for recs in routes.values():
        for i, idx in enumerate(recs):
            per_step[i // EP["n_layers"]] += int(moe._slot_positions(
                idx.T.reshape(-1), EP["n_experts"], EP_CAP)[1].sum())
    return per_step


@contextlib.contextmanager
def checked_a2a_calls(torch, ring):
    """Within the block every loopback all-to-all is held against its plain
    version on its own inputs as it happens: yields ``[(bit identical,
    equal to the un-exchanged input), ...]``."""
    seen, inner = [], ring.loopback

    def launch(op, xs, ws):
        outs = inner(op, xs, ws)
        want = ring.loopback_ref(op, xs)
        seen.append((all(torch.equal(o, w) for o, w in zip(outs, want)),
                     all(torch.equal(o, x) for o, x in zip(outs, xs))))
        return outs

    ring.loopback = launch
    try:
        yield seen
    finally:
        ring.loopback = inner


def route_agreement(torch, ep_routes, dense_routes):
    """EP's routing (``{rank: [(idx, gap) a layer]}``) against the grouped
    dense oracle's (group-major ``[(idx, gap)]``): per rank, the first
    layer where some token's experts differ, how many differ and their
    largest logit gap in EP's run. Later layers of that rank follow from
    it and are not compared."""
    layers, out = EP["n_layers"], []
    for r in range(EP_N):
        for l in range(layers):
            (a, gap), (b, _) = ep_routes[r][l], dense_routes[r * layers + l]
            diff = (a != b).any(1)
            if bool(diff.any()):
                out.append(dict(rank=r, layer=l, tokens=int(diff.sum()),
                                max_gap=float(gap[diff].max())))
                break
    return out


def ep_train_phase(torch, np, card):
    """``train_moe_ep(comm="pallas_a2a")`` at ``EP``'s full configuration
    on ``EP_N`` virtual ranks of one card (loopback), 8 steps a rank, for
    each dispatch; one step's exchanges, routing and gradients checked;
    a profile. Returns the launches of the three runs."""
    from distributed_llm_code_samples_tpu_torch.data import (
        batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.moe import (
        MoEStackParams, init_moe_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, moe, reset_launch_counts, ring)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        EXPERT_AXIS, expert, launch, make_mesh, train_moe_ep)
    d, n_layers, n_exp, k = (EP["d_model"], EP["n_layers"], EP["n_experts"],
                             EP["k"])
    cf, aux = EP["capacity_factor"], EP["aux_coef"]
    check(expert._local_capacity(EP_T, EP_N, n_exp, cf) == EP_CAP,
          "EP_CAP is not the trainer's capacity")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(EP["random_seed"])
    params = init_moe_stack(gen, d, n_layers, n_exp)
    seeds = make_seed_schedule(EP_N * EP["steps"], EP["random_seed"])
    mesh = make_mesh({EXPERT_AXIS: EP_N}, loopback=True)
    kw = dict(lr=EP["lr"], capacity_factor=cf, k=k, aux_coef=aux)
    want = {"all_to_all_dma": EP_A2A_PER_LAYER * n_layers * EP["steps"]}

    def run(dispatch):
        def body(me, _):
            stamps = []

            def on_step(_):
                if me.rank == 0:
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
            out = train_moe_ep(params, seeds, EP["tokens"], d, me,
                               dispatch=dispatch, comm="pallas_a2a",
                               on_step=on_step, **kw)
            return stamps, all(bool(torch.isfinite(t).all()) for t in out)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = launch(body, mesh)
        launches = launch_counts()
        check(all(o[1] for o in outs), "EP's trained params are not finite")
        return t0, outs[0][0], launches

    launches = {}
    for dispatch in EP_DISPATCHES:
        with recorded_routes(torch, moe) as routes:
            t0, stamps, got = run(dispatch)
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        kept = kept_pairs(moe, routes)
        # model flops: 12 d ffn a kept (token, choice) pair and layer, over
        # steps 2-8 (the steps the median covers)
        flops = 12 * d * EP_FFN * statistics.mean(kept[1:])
        print("ep-train-run " + json.dumps(dict(
            run=f"{dispatch}-pallas_a2a-loopback", ranks=EP_N,
            mode="loopback", steps_per_rank=len(steps),
            tokens_per_step=EP["tokens"], median_step_ms=1e3 * med,
            first_step_ms=1e3 * steps[0], tokens_per_s=EP["tokens"] / med,
            routed_pairs_per_step=EP["tokens"] * k * n_layers,
            kept_pairs_per_step=kept,
            model_tflops_per_s=flops / med / 1e12,
            f32_peak_share=flops / med / F32_FLOPS_PER_S,
            param_gb=4 * params.num_params() / 2 ** 30,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            kernel_launches=got, card=card)), flush=True)
        check(got == want, f"EP {dispatch} loopback: launches {got}, "
              f"expected {want}")
        launches[dispatch] = got
        del routes

    # one step a rank: every exchange against its plain version bit for
    # bit; the routing against the grouped dense oracle's on the same
    # card; the gradients, leaf by leaf, against a float64 dense run
    batches = [batch_from_seed(int(s), EP_T, d, device="cuda")
               for s in seeds[:EP_N]]
    p64 = MoEStackParams(*(t.double() for t in params))
    b64 = [(x.double(), dl.double()) for x, dl in batches]
    for dispatch in EP_DISPATCHES:
        ranks = {}

        def body(me, _):
            ranks[threading.get_ident()] = me.rank
            me.ring(expert.a2a_bytes(params, EP_T, EP_N, cf), probe=False)
            grads = expert.make_grads(EP_T, d, cf, k=k, aux_coef=aux,
                                      dispatch=dispatch, comm="pallas_a2a",
                                      mesh=me)
            return grads(expert.shard_params(params, me), int(seeds[me.rank]))

        with recorded_routes(torch, moe, gaps=True) as routes, \
                checked_a2a_calls(torch, ring) as calls:
            g_ep = expert.unshard_params(launch(body, mesh))
        ep_routes = {ranks[t]: recs for t, recs in routes.items()}
        with recorded_routes(torch, moe, gaps=True) as routes:
            g32 = expert.dense_grads(params, batches, cf, k, aux, EP_CAP,
                                     dispatch)
        flips = route_agreement(torch, ep_routes,
                                next(iter(routes.values())))
        g64 = expert.dense_grads(p64, b64, cf, k, aux, EP_CAP, dispatch)
        err_ep, err_32 = grad_errs(torch, g_ep, g64), grad_errs(torch, g32,
                                                                g64)
        # the control: each rank's expert gradients given to the next
        # rank's experts
        err_ctl = grad_errs(torch, MoEStackParams(
            g_ep.wg, g_ep.w1.roll(n_exp // EP_N, 1), g_ep.w2), g64)
        ratio = max(e / max(o, 1e-30) for e, o in zip(err_ep, err_32))
        ctl_ratio = max(e / max(o, 1e-30) for e, o in zip(err_ctl, err_32))
        print("ep-train-check " + json.dumps(dict(
            dispatch=dispatch, exchanges=len(calls),
            exchanges_bit_identical=sum(c[0] for c in calls),
            exchanges_equal_to_input=sum(c[1] for c in calls),
            route_differences=flips, route_gap_tol=ROUTE_GAP_TOL,
            grad_err_vs_f64_ep=dict(zip(("wg", "w1", "w2"), err_ep)),
            grad_err_vs_f64_dense=dict(zip(("wg", "w1", "w2"), err_32)),
            grad_err_vs_f64_control=dict(zip(("wg", "w1", "w2"), err_ctl)),
            grad_err_ratio_max=ratio, control_ratio_max=ctl_ratio,
            grad_ratio_limit=EP_GRAD_RATIO, card=card)), flush=True)
        check(len(calls) == EP_A2A_PER_LAYER * n_layers,
              f"one EP step made {len(calls)} exchanges")
        check(all(c[0] for c in calls), "an exchange of the EP step "
              "differs from its plain version")
        check(not any(c[1] for c in calls), "an exchange's control (its "
              "un-exchanged input) passes")
        check(all(f["layer"] > 0 and f["max_gap"] < ROUTE_GAP_TOL
                  for f in flips),
              f"EP routes tokens apart from the dense oracle: {flips}")
        check(all(np.isfinite(err_ep)), "EP gradients are not finite")
        check(ratio <= EP_GRAD_RATIO, f"EP gradients {ratio:.2f}x as far "
              "from float64 as the dense f32 oracle's")
        check(ctl_ratio > EP_GRAD_RATIO,
              "the gradient check cannot tell misplaced expert gradients")
        del g_ep, g32, g64, routes, ep_routes, calls
    del p64, b64, batches

    # where the device time goes in one EP run (dense; a traced run: the
    # profiler's own cost is in its wall time)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run("dense")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    summary = profile_summary(prof, wall_ms)
    a2a_ms = sum(e.device_time_total / 1e3 for e in prof.key_averages()
                 if getattr(e.device_type, "name", "") != "CPU"
                 and "all_to_all" in e.key)
    busy = summary["device_busy_ms"]
    print("ep-train-profile " + json.dumps(dict(
        summary, a2a_kernel_ms=a2a_ms,
        a2a_kernel_share=a2a_ms / busy if busy else None, card=card)),
        flush=True)
    return launches


def a2a_kernel_row(cases, launches, mode="loopback"):
    """The all-to-all's entry of the kernels line: launches from the main
    path's runs (the three dispatches), the rest from the main case."""
    main = next(c for c in cases if c["shape"] == A2A_MAIN)
    return {
        "name": "all_to_all_dma", "route": "cuda",
        "source": "distributed_llm_code_samples_tpu_torch/csrc/"
                  "ring_collectives.cu",
        "replaces": f"distributed_llm_code_samples_tpu/{A2A_REPLACES}",
        "launches": None if launches is None
        else sum(run.get("all_to_all_dma", 0) for run in launches.values()),
        "mode": mode, "ranks": EP_N,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "ok": all(c["ok"] for c in cases)}


# -- ring collectives across four cards -----------------------------------------

def ring_dist_bound(op, in_bytes, n):
    """Least time of one call on one rank of n cards: the bytes it sends
    over its NVLink (``ring_bytes``) at the link's rate each way, against
    its own input read and output written once at the HBM rate."""
    out_bytes = {"ring_reduce_scatter": in_bytes / n,
                 "ring_all_gather": in_bytes * n}.get(op, in_bytes)
    t_link = ring_bytes(op, in_bytes, n) / NVLINK_BYTES_PER_S * 1e3
    t_hbm = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    return max(t_link, t_hbm), "bytes"


def _nccl_call(torch, dist, op, x):
    """The NCCL collective that computes ``op`` on ``x`` (the kernels'
    library yardstick), or None for the hop, which has none."""
    n = dist.get_world_size()
    if op == "ring_all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        return y
    if op == "ring_reduce_scatter":
        y = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                        device=x.device)
        dist.reduce_scatter_tensor(y, x)
        return y
    if op == "ring_all_gather":
        y = torch.empty((x.shape[0] * n,) + tuple(x.shape[1:]),
                        device=x.device)
        dist.all_gather_into_tensor(y, x)
        return y
    return None


def a2a_dist_bound(in_bytes, n):
    """Least time of one all-to-all on one rank of n cards: the (n-1)/n of
    its tensor that leaves over its NVLink at the link's rate each way,
    against its input read and output written once at the HBM rate."""
    return max((n - 1) * in_bytes / n / NVLINK_BYTES_PER_S,
               2 * in_bytes / HBM_BYTES_PER_S) * 1e3, "bytes"


def _nccl_a2a(torch, dist, x):
    """NCCL's ``all_to_all_single`` of ``x`` (the kernel's library
    yardstick)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out


def _all_inputs(torch, dist, x):
    xs = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(xs, x)
    return xs


def dist_rank(mesh, payload):
    """One rank of ``--phase dist`` (its card is ``cuda:<rank>``): the
    ring kernels and the all-to-all across the cards against their plain
    versions (NCCL point to point) and NCCL's collectives, then DDP and
    FSDP at ``TRAIN``'s width under both transports, the per-call and
    per-step checks and a profile on rank 0, then EP at ``EP``'s under
    both transports and a profile on rank 0. Rank 0 prints; it returns the
    kernel cases and launches."""
    import torch
    import torch.distributed as dist

    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.models.moe import (
        init_moe_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, moe, reset_launch_counts, ring)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        EXPERT_AXIS, expert, make_mesh, train_ddp, train_fsdp, train_moe_ep)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, n, dev = mesh.rank, mesh.size, mesh.torch_device
    card = payload["card"]
    lead = r == 0

    def say(tag, row):
        if lead:
            print(f"{tag} " + json.dumps(row), flush=True)

    def gathered(value):
        out = [None] * n
        dist.all_gather_object(out, value)
        return out

    # -- each kernel across the cards ---------------------------------------
    timer = Timer(torch)
    token = torch.zeros(1, device=dev)
    aligned = partial(timer.ms, align=partial(dist.all_reduce, token))
    rg = mesh.ring(4 * max(FFN_DIM * D_MODEL,
                           EP["n_experts"] * EP_CAP * EP["d_model"]))
    cases = []
    for k, (op, tag, shape) in enumerate(RING_CASES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(500 + 10 * k + r)
        x = torch.randn(shape, generator=gen, device=dev)
        kern = partial(getattr(ring, op), x, rg)
        plain = partial(getattr(ring, op + "_ref"), x, rg)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        mesh.check()
        want = plain()
        xs = _all_inputs(torch, dist, x)
        f64 = [w[r] for w in (ring_want(torch, op, xs),
                              ring_want(torch, op, xs, control=True))]
        nccl = _nccl_call(torch, dist, op, x)
        err = ring_err(torch, [got], [f64[0]])
        row = dict(kernel=op, shape=tag, dims=list(shape), ranks=n,
                   mode="4 cards", bit_identical_to_plain=torch.equal(got, want),
                   deterministic=torch.equal(got, again),
                   max_abs_err=float((got - want).abs().max()),
                   err_vs_f64=err,
                   control_err_vs_f64=ring_err(torch, [got], [f64[1]]),
                   nccl_err_vs_f64=(None if nccl is None else
                                    ring_err(torch, [nccl], [f64[0]])),
                   ms=aligned(kern),
                   ms_with_host=timer.ms(kern, with_host=True),
                   plain_ms=aligned(plain),
                   library_ms=(None if nccl is None else aligned(
                       partial(_nccl_call, torch, dist, op, x))))
        row["bound_ms"], row["bound_by"] = ring_dist_bound(
            op, 4 * x.numel(), n)
        every = gathered({key: row[key] for key in
                          ("ms", "plain_ms", "library_ms", "err_vs_f64",
                           "control_err_vs_f64", "bit_identical_to_plain",
                           "deterministic")})
        row["ms_max_over_ranks"] = max(e["ms"] for e in every)
        row["ok"] = all(e["bit_identical_to_plain"] and e["deterministic"]
                        and e["err_vs_f64"] <= RING_TOL
                        and e["control_err_vs_f64"] > RING_TOL
                        for e in every) and (
            row["nccl_err_vs_f64"] is None
            or row["nccl_err_vs_f64"] <= RING_TOL)
        say("dist-kernel-case", row)
        cases.append(row)
        del x, xs, got, again, want, nccl, f64
    # the reduce-scatter at other ranges a chunk, each run bit-identical
    # to the plain ring
    gen = torch.Generator(device=dev)
    gen.manual_seed(560 + r)
    x = torch.randn((FFN_DIM, D_MODEL), generator=gen, device=dev)
    want = ring.ring_reduce_scatter_ref(x, rg)
    sweep = range_sweep(
        torch, aligned, ring, mesh.check,
        lambda: [torch.equal(ring.ring_reduce_scatter(x, rg), want)],
        partial(ring.ring_reduce_scatter, x, rg),
        {p: dict(RS_RANGES=p) for p in RS_RANGE_SWEEP})
    every = gathered(sweep)
    say("dist-rs-ranges", dict(shape="dw1", mode="4 cards", ms=sweep,
                               ms_max_over_ranks={
                                   p: max(e[p] for e in every)
                                   for p in sweep}))

    def rs_together():
        torch.cuda._sleep(HOST_COVER_CYCLES)
        dist.all_reduce(token)
        ring.ring_reduce_scatter(x, rg)

    stamps = ring.traced(rs_together, dev)
    mesh.check()
    say("dist-rs-trace", dict(shape="dw1", mode="4 cards",
                              ranks=gathered(rs_trace_summary(
                                  stamps.cpu()))))
    del x, want, stamps
    # the all-to-all: against its plain version (NCCL send / receive) and
    # NCCL's all_to_all_single, bit for bit
    a2a_cases = []
    for k, (tag, shape) in enumerate(A2A_CASES):
        with torch.cuda.device(dev):
            x = a2a_input(torch, tag, shape, r, n, 700 + 10 * k + r)
        kern = partial(ring.all_to_all_dma, x, rg)
        plain = partial(ring.all_to_all_dma_ref, x, rg)
        lib = partial(_nccl_a2a, torch, dist, x)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        mesh.check()
        want, nccl = plain(), lib()
        row = dict(kernel="all_to_all_dma", shape=tag, dims=list(shape),
                   ranks=n, mode="4 cards",
                   bit_identical_to_plain=torch.equal(got, want),
                   bit_identical_to_nccl=torch.equal(got, nccl),
                   deterministic=torch.equal(got, again),
                   control_equal_to_input=torch.equal(got, x),
                   identified=(tag != "identifying"
                               or a2a_identified(torch, got, r, n)),
                   max_abs_err=float((got - want).abs().max()),
                   ms=aligned(kern),
                   ms_with_host=timer.ms(kern, with_host=True),
                   plain_ms=aligned(plain), library_ms=aligned(lib),
                   library_ms_with_host=timer.ms(lib, with_host=True))
        row["bound_ms"], row["bound_by"] = a2a_dist_bound(4 * x.numel(), n)
        every = gathered({key: row[key] for key in
                          ("ms", "ms_with_host", "plain_ms", "library_ms",
                           "bit_identical_to_plain", "bit_identical_to_nccl",
                           "deterministic", "control_equal_to_input",
                           "identified")})
        row["ms_max_over_ranks"] = max(e["ms"] for e in every)
        row["ms_with_host_max_over_ranks"] = max(e["ms_with_host"]
                                                 for e in every)
        row["library_ms_max_over_ranks"] = max(e["library_ms"]
                                               for e in every)
        row["ok"] = all(e["bit_identical_to_plain"]
                        and e["bit_identical_to_nccl"] and e["deterministic"]
                        and not e["control_equal_to_input"] and e["identified"]
                        for e in every)
        say("dist-a2a-kernel-case", row)
        a2a_cases.append(row)
        del x, got, again, want, nccl
    with torch.cuda.device(dev):
        x = a2a_input(torch, A2A_MAIN, dict(A2A_CASES)[A2A_MAIN], r, n,
                      750 + r)
    nccl = _nccl_a2a(torch, dist, x)
    sweep = range_sweep(
        torch, aligned, ring, mesh.check,
        lambda: [torch.equal(ring.all_to_all_dma(x, rg), nccl)],
        partial(ring.all_to_all_dma, x, rg))
    every = gathered(sweep)
    say("dist-a2a-ranges", dict(shape=A2A_MAIN, mode="4 cards", ms=sweep,
                                ms_max_over_ranks={
                                    p: max(e[p] for e in every)
                                    for p in sweep}))

    def started_together():
        torch.cuda._sleep(HOST_COVER_CYCLES)
        dist.all_reduce(token)
        ring.all_to_all_dma(x, rg)

    stamps = ring.traced(started_together, dev)
    mesh.check()
    say("dist-a2a-trace", dict(
        shape=A2A_MAIN, mode="4 cards", phases=ring.A2A_PHASES,
        ranks=[t[0] for t in gathered(a2a_trace_summary(stamps.cpu(), n,
                                                        1))]))
    del x, nccl, timer, token, stamps
    mesh.close()
    check(all(c["ok"] for c in cases), "a ring kernel across the cards "
          "disagrees with its plain ring, NCCL or float64")
    check(all(c["ok"] for c in a2a_cases), "the all-to-all across the cards "
          "disagrees with its plain version or NCCL")

    # -- DDP and FSDP at the FFN headline width -----------------------------
    d, n_layers, tokens = TRAIN["d_model"], TRAIN["n_layers"], TRAIN["tokens"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN["random_seed"])
    params = init_ffn_stack(gen, d, n_layers)
    seeds = make_seed_schedule(n * TRAIN["steps"], TRAIN["random_seed"])
    trainers = {"ddp": train_ddp, "fsdp": train_fsdp}
    flops = 12 * tokens * d * FFN_DIM * n_layers * n

    def run(name, comm, seeds=seeds, lr=LR):
        view = mesh.for_rank(r, group=mesh.group)
        stamps = []

        def on_step(_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = trainers[name](params, seeds, tokens, d, view, lr=lr,
                             comm=comm, on_step=on_step)
        launches = launch_counts()
        view.close()
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        return out, steps, launches

    steps_n = TRAIN["steps"]
    want = {("ddp", "pallas_ring"): {"ring_all_reduce": 2 * n_layers * steps_n,
                                     "ppermute_dma": 1},
            ("fsdp", "pallas_ring"): {
                "ring_all_gather": 4 * n_layers * steps_n,
                "ring_reduce_scatter": 2 * n_layers * steps_n,
                "ppermute_dma": 1},
            ("ddp", "psum"): {}, ("fsdp", "psum"): {}}
    launches, param_bytes = {}, {}
    for name, comm in (("ddp", "psum"), ("ddp", "pallas_ring"),
                       ("fsdp", "psum"), ("fsdp", "pallas_ring")):
        out, steps, got = run(name, comm)
        med = statistics.median(steps[1:])
        pbytes = sum(4 * t.numel() for t in out)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        every = gathered(dict(med=med, launches=got, peak=peak))
        say("dist-train-run", dict(
            run=f"{name}-{comm}", ranks=n, mode="4 cards",
            steps_per_rank=len(steps), tokens_per_rank_step=tokens,
            median_step_ms=1e3 * med,
            median_step_ms_max_over_ranks=1e3 * max(e["med"] for e in every),
            first_step_ms=1e3 * steps[0],
            tokens_per_s=n * tokens / med,
            model_tflops_per_s=flops / med / 1e12,
            param_gb_per_rank=pbytes / 2 ** 30,
            max_memory_allocated_gb_per_rank=[e["peak"] for e in every],
            kernel_launches_per_rank=[e["launches"] for e in every],
            card=card))
        check(all(e["launches"] == want[name, comm] for e in every),
              f"{name}-{comm}: launches {[e['launches'] for e in every]}, "
              f"expected {want[name, comm]} on every rank")
        launches[name, comm] = got
        param_bytes[name] = pbytes
        del out
    check(param_bytes["fsdp"] * n == param_bytes["ddp"],
          f"FSDP keeps {param_bytes['fsdp']} bytes of params a rank, DDP "
          f"{param_bytes['ddp']}: not a 1/{n} share")

    # -- one step a rank at CHECK_LR: every ring call against float64 (and
    # NCCL), the ring's update against psum's, DDP's against FSDP's --------
    calls, inner = [], ring._collective

    def record(op, x, rg):
        out = inner(op, x, rg)
        calls.append((op, x.clone(), out))
        return out

    ring._collective = record
    try:
        one = {(name, "pallas_ring"): run(name, "pallas_ring", seeds[:n],
                                          CHECK_LR)[0]
               for name in ("ddp", "fsdp")}
    finally:
        ring._collective = inner
    errs, controls, nccl_errs = {}, {}, []
    for op, x, out in calls:
        xs = _all_inputs(torch, dist, x)
        want64 = ring_want(torch, op, xs)[r]
        errs.setdefault(op, []).append(ring_err(torch, [out], [want64]))
        controls.setdefault(op, []).append(ring_err(
            torch, [out], [ring_want(torch, op, xs, control=True)[r]]))
        if op == "ring_all_reduce":
            nccl_errs.append(ring_err(
                torch, [_nccl_call(torch, dist, op, x)], [want64]))
        del xs, want64
    del calls
    one["ddp", "psum"] = run("ddp", "psum", seeds[:n], CHECK_LR)[0]
    full_fsdp = [torch.cat(_all_inputs(torch, dist, t.contiguous()), 1)
                 for t in one["fsdp", "pallas_ring"]]

    def update_err(a, b):
        du = sum(float((x.double() - p.double()).norm() ** 2)
                 for x, p in zip(a, params)) ** 0.5
        return sum(float((x.double() - y.double()).norm() ** 2)
                   for x, y in zip(a, b)) ** 0.5 / du

    ring_vs_psum = update_err(one["ddp", "psum"], one["ddp", "pallas_ring"])
    ddp_vs_fsdp = update_err(one["ddp", "pallas_ring"], full_fsdp)
    unchanged = update_err(one["ddp", "psum"], params)
    every = gathered(dict(errs={k: max(v) for k, v in errs.items()},
                          controls={k: min(v) for k, v in controls.items()},
                          nccl=max(nccl_errs), ring_vs_psum=ring_vs_psum,
                          ddp_vs_fsdp=ddp_vs_fsdp, unchanged=unchanged,
                          calls={k: len(v) for k, v in errs.items()}))
    say("dist-train-check", dict(
        calls_per_rank=every[0]["calls"],
        call_err_vs_f64_max={k: max(e["errs"][k] for e in every)
                             for k in every[0]["errs"]},
        call_control_err_min={k: min(e["controls"][k] for e in every)
                              for k in every[0]["controls"]},
        nccl_all_reduce_err_vs_f64_max=max(e["nccl"] for e in every),
        ring_tol=RING_TOL, check_lr=CHECK_LR,
        ring_vs_psum_update_err=max(e["ring_vs_psum"] for e in every),
        ddp_vs_fsdp_update_err=max(e["ddp_vs_fsdp"] for e in every),
        unchanged_update_err=min(e["unchanged"] for e in every), card=card))
    check(every[0]["calls"] == {"ppermute_dma": 2,
                                "ring_all_reduce": 2 * n_layers,
                                "ring_all_gather": 4 * n_layers,
                                "ring_reduce_scatter": 2 * n_layers},
          f"one step a rank made ring calls {every[0]['calls']}")
    for e in every:
        check(max(e["errs"].values()) <= RING_TOL,
              "a ring call of the trainers disagrees with float64")
        check(min(e["controls"].values()) > RING_TOL,
              "a ring call's control passes the float64 check")
        check(e["nccl"] <= RING_TOL, "NCCL's all-reduce disagrees with "
              "float64")
        check(e["ring_vs_psum"] <= RING_TOL and e["ddp_vs_fsdp"] <= RING_TOL,
              f"one step's updates differ: ring vs psum "
              f"{e['ring_vs_psum']:.2e}, DDP vs FSDP {e['ddp_vs_fsdp']:.2e}")
        check(e["unchanged"] > RING_TOL,
              "the update check cannot tell unchanged weights from trained")
    del one, full_fsdp

    # -- where the time goes: DDP over the ring, traced on rank 0 -----------
    from torch.profiler import ProfilerActivity, profile
    if lead:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run("ddp", "pallas_ring")
            wall_ms = 1e3 * (time.perf_counter() - t0)
        summary = profile_summary(prof, wall_ms)
        ring_ms = sum(e.device_time_total / 1e3 for e in prof.key_averages()
                      if getattr(e.device_type, "name", "") != "CPU"
                      and "ring_" in e.key)
        busy = summary["device_busy_ms"]
        summary.update(ring_kernel_ms=ring_ms,
                       ring_kernel_share=ring_ms / busy if busy else None,
                       card=card)
        say("dist-profile", summary)
    else:
        run("ddp", "pallas_ring")

    # -- expert parallelism at the MoE headline width ------------------------
    d, n_layers = EP["d_model"], EP["n_layers"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(EP["random_seed"])
    ep_params = init_moe_stack(gen, d, n_layers, EP["n_experts"])
    ep_seeds = make_seed_schedule(n * EP["steps"], EP["random_seed"])
    kw = dict(lr=EP["lr"], capacity_factor=EP["capacity_factor"], k=EP["k"],
              aux_coef=EP["aux_coef"])

    ep_mesh = make_mesh({EXPERT_AXIS: n}, device="cuda")

    def ep_run(dispatch, comm):
        view = ep_mesh.for_rank(r, group=mesh.group)
        stamps = []

        def on_step(_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = train_moe_ep(ep_params, ep_seeds, EP["tokens"], d, view,
                           dispatch=dispatch, comm=comm, on_step=on_step,
                           **kw)
        launches = launch_counts()
        view.close()
        return out, [b - a for a, b in zip([t0] + stamps, stamps)], launches

    ep_want = {"psum": {}, "pallas_a2a": {
        "all_to_all_dma": EP_A2A_PER_LAYER * n_layers * EP["steps"]}}
    ep_launches, same, moved = {}, {}, {}
    start = expert.shard_params(ep_params, ep_mesh.for_rank(r))

    def bits(t):
        return t.view(torch.int32)

    for dispatch in EP_DISPATCHES:
        finals = {}
        for comm in ("psum", "pallas_a2a"):
            with recorded_routes(torch, moe) as routes:
                out, steps, got = ep_run(dispatch, comm)
            med = statistics.median(steps[1:])
            every = gathered(dict(
                med=med, launches=got, kept=kept_pairs(moe, routes),
                peak=torch.cuda.max_memory_allocated() / 2 ** 30))
            kept = [sum(c) for c in zip(*(e["kept"] for e in every))]
            say("dist-ep-run", dict(
                run=f"{dispatch}-{comm}", ranks=n, mode="4 cards",
                steps_per_rank=len(steps), tokens_per_step=EP["tokens"],
                median_step_ms=1e3 * med,
                median_step_ms_max_over_ranks=1e3 * max(e["med"]
                                                        for e in every),
                first_step_ms=1e3 * steps[0],
                tokens_per_s=EP["tokens"] / med,
                routed_pairs_per_step=EP["tokens"] * EP["k"] * n_layers,
                kept_pairs_per_step=kept,
                model_tflops_per_s=(12 * d * EP_FFN * statistics.mean(
                    kept[1:]) / med / 1e12),
                param_gb_per_rank=sum(4 * t.numel() for t in out) / 2 ** 30,
                max_memory_allocated_gb_per_rank=[e["peak"] for e in every],
                kernel_launches_per_rank=[e["launches"] for e in every],
                card=card))
            check(all(e["launches"] == ep_want[comm] for e in every),
                  f"EP {dispatch}-{comm}: launches "
                  f"{[e['launches'] for e in every]}, expected "
                  f"{ep_want[comm]} on every rank")
            check(all(gathered(all(bool(torch.isfinite(t).all())
                                   for t in out))),
                  f"EP {dispatch}-{comm}: trained params are not finite")
            finals[comm] = out
            if comm == "pallas_a2a":
                ep_launches[dispatch] = got
            del routes
        same[dispatch] = all(gathered(all(
            torch.equal(bits(a), bits(b))
            for a, b in zip(finals["psum"], finals["pallas_a2a"]))))
        # the control: the trained params against the initial ones
        moved[dispatch] = all(gathered(not any(
            torch.equal(bits(a), bits(b))
            for a, b in zip(finals["psum"], start))))
        del finals
    say("dist-ep-check", dict(final_params_bit_identical=same,
                              control_params_moved=moved, card=card))
    check(all(same.values()), f"EP's two transports end apart: {same}")
    check(all(moved.values()), "the bitwise check cannot tell trained "
          "params from the initial ones")
    # the exchange's device time in a traced dense run under each
    # transport: the kernel's, or NCCL's (all_to_all_single runs as
    # NCCL's send/receive kernel; the router's all-reduce is apart)
    for comm, mark in (("pallas_a2a", "all_to_all"), ("psum", "sendrecv")):
        if not lead:
            ep_run("dense", comm)
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ep_run("dense", comm)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        summary = profile_summary(prof, wall_ms)
        events = [e for e in prof.key_averages()
                  if getattr(e.device_type, "name", "") != "CPU"
                  and mark in e.key.lower()]
        ex_ms = sum(e.device_time_total / 1e3 for e in events)
        busy = summary["device_busy_ms"]
        summary.update(comm=comm, exchange_kernel_ms=ex_ms,
                       exchange_calls=sum(e.count for e in events),
                       exchange_share=ex_ms / busy if busy else None,
                       card=card)
        say("dist-ep-profile", summary)
    if not lead:
        return None
    return dict(cases=cases, launches={
        name: launches[name, "pallas_ring"] for name in ("ddp", "fsdp")},
        a2a_cases=a2a_cases, ep_launches=ep_launches)


def card_lines() -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()


def dist_phase(torch):
    """``--phase dist``: ``RING_N`` ranks, one a card, over NCCL and the
    peer-mapped workspaces (``dist_rank``). Returns the ring kernels' and
    the all-to-all's entries of the kernels line."""
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, launch, make_mesh)
    n = torch.cuda.device_count()
    check(n >= RING_N, f"--phase dist needs {RING_N} cards, {n} visible")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    print("dist-topo\n" + topo.stdout.rstrip(), flush=True)
    cards = card_lines()[:RING_N]
    print("dist-cards " + json.dumps(cards), flush=True)
    for i in range(RING_N):
        for j in range(RING_N):
            check(i == j or torch.cuda.can_device_access_peer(i, j),
                  f"cuda:{i} has no peer access to cuda:{j}: the ring "
                  "kernels store over peer mappings, never through the host")
    out = launch(dist_rank, make_mesh({DATA_AXIS: RING_N}, device="cuda"),
                 {"card": cards}, timeout=900)[0]
    rows = ring_kernel_rows(out["cases"], out["launches"], mode="4 cards")
    rows.append(a2a_kernel_row(out["a2a_cases"], out["ep_launches"],
                               mode="4 cards"))
    for row in rows:
        row["cards"] = cards
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase",
                    choices=["all", "kernel", "train", "lm", "ring", "ep",
                             "dist"],
                    default="all")
    args = ap.parse_args(argv)
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        from distributed_llm_code_samples_tpu_torch.ops import _build
    except ImportError as e:
        print(f"error: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {json.dumps(secs)} total "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _build.build_logs.items():
        print(f"build-log {name}:\n{log}", flush=True)

    if args.phase == "dist":
        kernels = dist_phase(torch)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0 if all(k["ok"] for k in kernels) else 1

    timer = Timer(torch)
    kernels, bad = [], []
    ffn_phases, lm_phases = ("all", "kernel", "train"), ("all", "lm")
    ring_phases, ep_phases = ("all", "ring"), ("all", "ep")
    if args.phase in ("all", "kernel"):
        cases = kernel_phase(torch, np, timer)
        bad += [c for c in cases if not c["ok"]]
    if args.phase in ffn_phases:
        ffn_cases = ffn_kernel_phase(torch, np, timer)
        bad += [c for c in ffn_cases if not c["ok"]]
    if args.phase in lm_phases:
        lm_cases = lm_kernel_phase(torch, np, timer)
        bad += [c for c in lm_cases if not c["ok"]]
    if args.phase in ring_phases:
        ring_cases = ring_kernel_phase(torch, np, timer)
        bad += [c for c in ring_cases if not c["ok"]]
    if args.phase in ep_phases:
        a2a_cases = a2a_kernel_phase(torch, np, timer)
        bad += [c for c in a2a_cases if not c["ok"]]
    launches = ffn_launches = lm_launches = ring_launches = None
    ep_launches = None
    if not bad and args.phase == "all":
        launches = serving_phase(torch, np, card)
    if not bad and args.phase in ("all", "train"):
        ffn_launches = train_phase(torch, np, card)
    if not bad and args.phase in lm_phases:
        lm_launches = lm_train_phase(torch, np, card)
    if not bad and args.phase in ring_phases:
        ring_launches = ring_train_phase(torch, np, card)
    if not bad and args.phase in ep_phases:
        ep_launches = ep_train_phase(torch, np, card)
    if args.phase in ("all", "kernel"):
        main_case = next(c for c in cases if c["shape"] == "serving"
                         and c["kv_dtype"] == "f32")
        kernels.append({
            "name": "paged_decode_attn", "route": "cuda",
            "source": "distributed_llm_code_samples_tpu_torch/csrc/"
                      "paged_decode_attn.cu",
            "replaces": "distributed_llm_code_samples_tpu/ops/"
                        "pallas_paged_attention.py:129",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["rel_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "ok": all(c["ok"] for c in cases)})
    if args.phase in ffn_phases:
        kernels += ffn_kernel_rows(ffn_cases, ffn_launches)
    if args.phase in lm_phases:
        kernels += lm_kernel_rows(lm_cases, lm_launches)
    if args.phase in ring_phases:
        kernels += ring_kernel_rows(ring_cases, ring_launches)
    if args.phase in ep_phases:
        kernels.append(a2a_kernel_row(a2a_cases, ep_launches))
    print(json.dumps({"kernels": kernels}), flush=True)
    if bad:
        print(f"error: kernel disagrees with its plain version: {bad}",
              file=sys.stderr)
        return 1
    if args.phase != "all":
        return 0
    # the smoke drives one device, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
