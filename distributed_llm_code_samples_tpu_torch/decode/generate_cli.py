"""``generate`` for the port: drive the decode engine end to end and print
one JSON line, as the JAX package's ``decode/generate_cli.py`` does.

    python -m distributed_llm_code_samples_tpu_torch.decode.generate_cli \\
        -d 768 -l 12 --heads 12 --vocab 50304 --max_seq_len 1024 \\
        --prompt_lens 17,120,300 --max_new 32 --kv_dtype bf16

The model is the LM family at the flagged shape with random weights
from ``-r``; prompts are explicit token-id lists (``--prompts "3,1,4;9,2"``)
or seeded random draws (``--prompt_lens`` with ``--prompt_seed``). It runs
on the card unless ``--device cpu`` is given.
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
    p.add_argument("--kernel", choices=["gather", "fused"], default="fused",
                   help="decode attention: 'fused' (the paged CUDA "
                        "kernel; its plain version on the CPU) or "
                        "'gather' (gather + decode_attn, the oracle)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def generate_main(argv=None) -> int:
    args = build_generate_parser().parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..models.lm import init_lm
    from ..ops import launch_counts, reset_launch_counts
    from .engine import DecodeEngine, EngineConfig

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
            use_rope=args.use_rope, kernel=args.kernel)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.random_seed)
        params = init_lm(gen, args.vocab, args.model_size, args.layers,
                         max_seq_len=args.max_seq_len, n_heads=args.heads,
                         n_kv_heads=args.kv_heads or None)
        engine = DecodeEngine(params, args.heads, cfg)
        for pr in prompts:
            engine.submit(pr, args.max_new)
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
    }
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(generate_main())
