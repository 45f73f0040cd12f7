"""``generate`` for the port: drive the decode engine end to end and print
one JSON line, as the JAX package's ``decode/generate_cli.py`` does.

    python -m distributed_llm_code_samples_tpu_torch.decode.generate_cli \\
        -d 768 -l 12 --heads 12 --vocab 50304 --max_seq_len 1024 \\
        --prompt_lens 17,120,300 --max_new 32 --kv_dtype bf16

The model is the LM family at the flagged shape with random weights
from ``-r``; prompts are explicit token-id lists (``--prompts "3,1,4;9,2"``)
or seeded random draws (``--prompt_lens`` with ``--prompt_seed``). It runs
on the card unless ``--device cpu`` is given.

``--prefix_cache`` (default on; ``--no-prefix_cache``) and
``--prefix_partial`` set the radix prefix cache, and ``--max_retries``,
``--deadline_steps``, ``--queue_limit`` and ``--preempt_after`` the
engine's ``ServePolicy``; a bad value exits 2. A request shed by the
queue limit is counted, not an error. ``--speculate K`` drafts K tokens a
decode step (greedy only; with ``--temperature`` above 0 it exits 2), and
``--spill_blocks N`` arms the host spill tier of N blocks behind the
prefix cache, restoring at most ``--spill_restore_per_step`` blocks a
step. Beside the JSON line, standard error gets JAX's prefix-cache
summary line ("prefix cache hit N block(s) (rate r), saved S prefill
token(s), peak P shared block(s), C CoW cop(ies)"), the counts of shed,
preempted, expired, retried and failed requests, and, when they are on,
a speculation line (drafted, accepted, tokens a decode dispatch) and a
spill line (blocks spilled, restores, host bytes, restore seconds).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_generate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="generate",
        description="Continuous-batching decode over the paged KV engine "
                    "(PyTorch port)")
    p.add_argument("-d", "--model_size", type=int, default=64)
    p.add_argument("-l", "--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv_heads", type=int, default=0,
                   help="GQA KV heads (0 = full MHA)")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--max_seq_len", type=int, default=256)
    p.add_argument("-r", "--random_seed", type=int, default=0,
                   help="model init seed")
    p.add_argument("--use_rope", action="store_true",
                   help="rotary attention (must match training)")
    p.add_argument("--prompts", default=None,
                   help="semicolon-separated comma-lists of token ids, "
                        'e.g. "3,1,4;9,2,6,5"')
    p.add_argument("--prompt_lens", default=None,
                   help="comma-separated lengths of random prompts "
                        "(deterministic per --prompt_seed), e.g. 5,9,13")
    p.add_argument("--prompt_seed", type=int, default=0)
    p.add_argument("--max_new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy argmax")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--sample_seed", type=int, default=0)
    p.add_argument("--kv_dtype", choices=["f32", "bf16", "int8"],
                   default="f32")
    p.add_argument("--block_size", type=int, default=16)
    p.add_argument("--n_blocks", type=int, default=0,
                   help="KV pool blocks incl. the scratch block "
                        "(0 = sized for max_slots full sequences)")
    p.add_argument("--max_slots", type=int, default=4)
    p.add_argument("--max_blocks_per_seq", type=int, default=0,
                   help="per-sequence table width (0 = cover the longest "
                        "request, up to max_seq_len)")
    p.add_argument("--prefill_chunk", type=int, default=16)
    p.add_argument("--speculate", type=int, default=0,
                   help="speculative decoding: draft tokens a decode step "
                        "from the n-gram prompt-copy drafter, verified "
                        "greedily (requires temperature 0; a step emits "
                        "1 + accepted tokens; 0 = off)")
    p.add_argument("--kernel", choices=["gather", "fused"], default="fused",
                   help="decode attention: 'fused' (the paged CUDA "
                        "kernel; its plain version on the CPU) or "
                        "'gather' (gather + decode_attn, the oracle)")
    p.add_argument("--prefix_cache", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="shared-prefix KV reuse (decode/prefix.py): "
                        "requests sharing a prompt prefix map its cached "
                        "full blocks instead of prefilling them again, "
                        "refcounted and copy-on-write; the output is "
                        "unchanged (default on)")
    p.add_argument("--spill_blocks", type=int, default=0,
                   help="host-RAM KV spill tier capacity in blocks "
                        "(decode/spill.py): pool-pressure evictions of "
                        "cached prefix blocks move their bytes to host "
                        "RAM, and a hit on a spilled edge restores them "
                        "instead of prefilling again (0 = off; needs "
                        "--prefix_cache)")
    p.add_argument("--spill_restore_per_step", type=int, default=2,
                   help="most spilled blocks restored an engine step; an "
                        "admission past it waits for the next step")
    p.add_argument("--prefix_partial", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="sub-block sharing: a partial-block hit copies "
                        "the shared leading rows into a private block "
                        "(f32 and bf16 output unchanged; int8 rows keep "
                        "the donor's frozen scale); needs --prefix_cache")
    p.add_argument("--max_retries", type=int, default=0,
                   help="per-request retry budget for quarantined "
                        "sequences (replayed; 0 = fail on the first "
                        "fault)")
    p.add_argument("--deadline_steps", type=int, default=0,
                   help="per-request time to live in engine steps from "
                        "submit (0 = none); an expired request fails with "
                        "reason 'deadline'")
    p.add_argument("--queue_limit", type=int, default=0,
                   help="bounded waiting queue: submissions past it are "
                        "shed (rejected, not an error; 0 = unbounded)")
    p.add_argument("--preempt_after", type=int, default=0,
                   help="pool-pressure preemption: a head-of-line request "
                        "starved of blocks for N steps evicts the "
                        "youngest running sequence (0 = off)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def prefix_summary(engine) -> str:
    """The JAX report's prefix-cache line."""
    rate = (round(engine.prefix_hit_blocks / engine.prefix_lookup_blocks, 4)
            if engine.prefix_lookup_blocks else None)
    return (f"prefix cache hit {engine.prefix_hit_blocks} block(s)"
            + (f" (rate {rate})" if rate is not None else "")
            + f", saved {engine.prefill_tokens_saved} prefill token(s), "
            f"peak {engine.shared_blocks_peak} shared block(s), "
            f"{engine.cow_copies} CoW cop(ies)")


def generate_main(argv=None) -> int:
    args = build_generate_parser().parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..models.lm import init_lm
    from ..ops import launch_counts, reset_launch_counts
    from .engine import (AdmissionError, DecodeEngine, EngineConfig,
                         ServePolicy)

    if (args.prompts is None) == (args.prompt_lens is None):
        print("error: pass exactly one of --prompts / --prompt_lens",
              file=sys.stderr)
        return 2
    try:
        if args.prompts is not None:
            prompts = [[int(t) for t in grp.split(",") if t.strip()]
                       for grp in args.prompts.split(";") if grp.strip()]
        else:
            lens = [int(x) for x in args.prompt_lens.split(",")
                    if x.strip()]
            rng = np.random.default_rng(args.prompt_seed)
            prompts = [rng.integers(0, args.vocab, size=n).tolist()
                       for n in lens]
    except ValueError:
        print("error: unparseable --prompts / --prompt_lens",
              file=sys.stderr)
        return 2
    if not prompts or any(not pr for pr in prompts):
        print("error: need at least one non-empty prompt", file=sys.stderr)
        return 2

    need_tokens = max(len(pr) for pr in prompts) + args.max_new
    mbps = args.max_blocks_per_seq or -(
        -min(args.max_seq_len, need_tokens) // args.block_size)
    n_blocks = args.n_blocks or 1 + args.max_slots * mbps
    try:
        device = resolve_device(args.device)
        cfg = EngineConfig(
            block_size=args.block_size, n_blocks=n_blocks,
            max_slots=args.max_slots, max_blocks_per_seq=mbps,
            prefill_chunk=args.prefill_chunk, kv_dtype=args.kv_dtype,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.sample_seed,
            use_rope=args.use_rope, kernel=args.kernel,
            prefix_cache=args.prefix_cache,
            prefix_partial=args.prefix_partial, speculate=args.speculate,
            spill_blocks=args.spill_blocks,
            spill_restore_per_step=args.spill_restore_per_step)
        policy = ServePolicy(
            queue_limit=args.queue_limit,
            deadline_steps=args.deadline_steps,
            max_retries=args.max_retries,
            preempt_after_steps=args.preempt_after)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.random_seed)
        params = init_lm(gen, args.vocab, args.model_size, args.layers,
                         max_seq_len=args.max_seq_len, n_heads=args.heads,
                         n_kv_heads=args.kv_heads or None)
        engine = DecodeEngine(params, args.heads, cfg, policy=policy)
        shed = 0
        for pr in prompts:
            try:
                engine.submit(pr, args.max_new)
            except AdmissionError:
                shed += 1       # recorded as a `rejected` event
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    payload = {
        "sequences": [{"uid": u, "tokens": toks,
                       "prompt_len": engine.prompt_lens.get(u)}
                      for u, toks in sorted(engine.finished.items())],
        "failed": {str(u): info for u, info in sorted(engine.failed.items())},
        "tokens_generated": engine.tokens_generated,
        "wall_s": round(wall, 4),
        "tokens_per_sec": round(engine.tokens_generated / wall, 2),
        "engine_steps": engine.steps,
        "mean_occupancy": round(engine.mean_occupancy(), 4),
        "kv_dtype": args.kv_dtype,
        "kernel": args.kernel,
        "device": str(device),
        "kernel_launches": launch_counts(),
        "speculate": args.speculate,
        "decode_dispatches": engine.decode_dispatches,
        "drafted_tokens": engine.drafted_tokens,
        "accepted_tokens": engine.accepted_tokens,
        "accept_rate": (round(engine.accepted_tokens
                              / engine.drafted_tokens, 4)
                        if engine.drafted_tokens else None),
        "prefix_cache": args.prefix_cache,
        "prefix_partial": args.prefix_partial,
        "prefix_hit_blocks": engine.prefix_hit_blocks,
        "prefix_lookup_blocks": engine.prefix_lookup_blocks,
        "prefill_tokens_saved": engine.prefill_tokens_saved,
        "prefill_dispatches": engine.prefill_dispatches,
        "shared_blocks_peak": engine.shared_blocks_peak,
        "cow_copies": engine.cow_copies,
        "spill_blocks": args.spill_blocks,
        "spilled_blocks": engine.spilled_blocks,
        "spill_bytes": engine.spill_bytes,
        "restores": engine.restores,
        "restore_tokens_saved": engine.restore_tokens_saved,
        "restore_stall_s": round(engine.restore_stall_s, 6),
        "partial_hits": engine.partial_hits,
        "quarantined": engine.quarantined,
        "retried": engine.retried,
        "preempted": engine.preempted,
        "rejected": engine.rejected,
        "expired": engine.expired,
        "shed": shed,
    }
    if args.prefix_cache:
        print(prefix_summary(engine), file=sys.stderr)
    print(f"requests: {shed} shed, {engine.preempted} preempted, "
          f"{engine.expired} expired, {engine.retried} retried, "
          f"{len(engine.failed)} failed", file=sys.stderr)
    if args.speculate:
        per = (round(engine.tokens_generated / engine.decode_dispatches, 4)
               if engine.decode_dispatches else None)
        print(f"speculation: {engine.drafted_tokens} drafted, "
              f"{engine.accepted_tokens} accepted (rate "
              f"{payload['accept_rate']}), {per} token(s) a decode "
              "dispatch", file=sys.stderr)
    if args.spill_blocks:
        print(f"spill tier: {engine.spilled_blocks} block(s) spilled "
              f"({engine.spill_bytes} bytes), {engine.restores} "
              f"restore(s) saving {engine.restore_tokens_saved} prefill "
              f"token(s) in {engine.restore_stall_s:.6f} s",
              file=sys.stderr)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(generate_main())
