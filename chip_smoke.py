#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phase kernel   # build + hold the kernels only

Builds every kernel of the port from ``csrc/``, holds each against its
plain PyTorch version on the card, times both, then serves requests
through the port's ``DecodeEngine`` at the full width of the GPT-2-small
LM of ``bench_decode.py`` (d=768, 12 layers, 12 heads, vocab 50304,
max_seq_len 1024, random weights from a seed): once per ``kv_dtype``
with ``kernel="fused"`` and once at f32 with ``kernel="gather"``. It
fails (exit code 1) if there is no CUDA device, if a kernel does not
build, launch or agree, if the fused run did not go through the kernel,
or if the served tokens are wrong.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels with their launches, errors and
times. This script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=["all", "kernel"], default="all")
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
    cases = kernel_phase(torch, np, timer)
    bad = [c for c in cases if not c["ok"]]
    launches = None
    if not bad and args.phase == "all":
        launches = serving_phase(torch, np, card)
    main_case = next(c for c in cases
                     if c["shape"] == "serving" and c["kv_dtype"] == "f32")
    kernels = [{
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
        "ok": not bad}]
    print(json.dumps({"kernels": kernels}), flush=True)
    if bad:
        print(f"error: kernel disagrees with its plain version: {bad}",
              file=sys.stderr)
        return 1
    if args.phase != "all":
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
