#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phase kernel   # build + hold the kernels only
    python3 chip_smoke.py --phase train    # the FFN kernels + training
    python3 chip_smoke.py --phase lm       # the LM kernels + LM training

Builds every kernel of the port from ``csrc/``, holds each against its
plain PyTorch version on the card, times both, then drives the port's
three paths:

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
  their four kernels, and the oracle ops.

It fails (exit code 1) if there is no CUDA device, if a kernel does not
build, launch or agree, if a kernel path did not go through its
kernels, or if the served tokens or the trained weights are wrong.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it lists the kernels with their launches, errors and
times. This script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
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
     "ops/pallas_xent.py:245", ("head_xent_dh", "head_xent_dw")))
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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


class Timer:
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush, timed with CUDA events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, reps: int = 20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
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
        del w1, w2, x, dy
    return results


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
    backward kernels execute more (7 and 4 products): each of their two
    launches recomputes the score and dp tiles, or the logit tiles."""
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
    return rows


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
                "head_xent_dh": steps_n if head_impl else 0,
                "head_xent_dw": steps_n if head_impl else 0}
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
    print("lm-train-profile " + json.dumps(dict(
        profile_summary(prof, wall_ms), card=card)), flush=True)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=["all", "kernel", "train", "lm"],
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

    timer = Timer(torch)
    kernels, bad = [], []
    ffn_phases, lm_phases = ("all", "kernel", "train"), ("all", "lm")
    if args.phase in ("all", "kernel"):
        cases = kernel_phase(torch, np, timer)
        bad += [c for c in cases if not c["ok"]]
    if args.phase in ffn_phases:
        ffn_cases = ffn_kernel_phase(torch, np, timer)
        bad += [c for c in ffn_cases if not c["ok"]]
    if args.phase in lm_phases:
        lm_cases = lm_kernel_phase(torch, np, timer)
        bad += [c for c in lm_cases if not c["ok"]]
    launches = ffn_launches = lm_launches = None
    if not bad and args.phase == "all":
        launches = serving_phase(torch, np, card)
    if not bad and args.phase in ("all", "train"):
        ffn_launches = train_phase(torch, np, card)
    if not bad and args.phase in lm_phases:
        lm_launches = lm_train_phase(torch, np, card)
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
