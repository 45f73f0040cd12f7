"""Training CLI of the port, the JAX package's ``cli.py`` for the methods
that are ported (today ``-m 1``, the single-device trainer).

    python -m distributed_llm_code_samples_tpu_torch.cli -m 1 -s 8 \\
        -bs 8 -n 1024 -l 24 -d 768 -r 7 --pallas

The reference's seven flags keep their short names and defaults; any
method other than 1, the default 0 included, exits 2. It runs on the
card unless ``--device cpu`` is given. It prints the reference's banner
and ``PARAMS:`` line, then one JSON line: steps, tokens per step, wall
time, the median step time (host clock, each step ending in a
synchronize, the first step left out unless it is the only one), and
from it tokens/s and the model TFLOP/s (``12 * T * d * ffn * L`` a
step); the device, the kernel launch counts and a per-layer checksum of
the final parameters. With ``--pallas`` on the card the kernels are
built before the clock starts (``build_s``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

PORTED_METHODS = (1,)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="FFN-stack training on one NVIDIA GPU (PyTorch port; "
                    "reference-parity flags, train_ffns.py:342-351)")
    p.add_argument("-s", "--num_steps", type=int, default=1)
    p.add_argument("-bs", "--batch_size", type=int, default=8)
    p.add_argument("-n", "--seq_len", type=int, default=1024)
    p.add_argument("-l", "--layers", type=int, default=1)
    p.add_argument("-d", "--model_size", type=int, default=4)
    p.add_argument("-m", "--method", type=int, default=0,
                   help="1=single device (the only method ported so far)")
    p.add_argument("-r", "--random_seed", type=int, default=0,
                   help="!=0 makes runs reproducible (train_ffns.py:350)")
    p.add_argument("--pallas", action="store_true",
                   help="run each FFN block through the three CUDA kernels "
                        "(their plain versions on the CPU)")
    p.add_argument("--mixed", action="store_true",
                   help="bf16 matmul operands, f32 params/grads/sums")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation chunks per step (SUM "
                        "semantics)")
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default: the reference's 1e-5)")
    p.add_argument("--scan", action="store_true",
                   help="does nothing in the port (accepted for parity "
                        "with the JAX CLI; both of its loop forms are one "
                        "Python loop here)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.method not in PORTED_METHODS:
        print(f"error: method {args.method} is not ported yet (ported: "
              f"{', '.join(map(str, PORTED_METHODS))})", file=sys.stderr)
        return 2
    tokens = args.batch_size * args.seq_len   # seq folded into batch
    if args.accum < 1 or tokens % args.accum:
        print(f"error: --accum {args.accum} must be >= 1 and divide the "
              f"{tokens} tokens of a step", file=sys.stderr)
        return 2

    import torch

    from . import LR, resolve_device
    from .data import make_seed_schedule
    from .models.ffn_stack import init_ffn_stack, params_size_gb
    from .ops import build_all, launch_counts, reset_launch_counts
    from .ops.fused_ffn import BWD_DW, BWD_DX, FWD
    from .parallel.single import make_step, train_single

    try:
        device = resolve_device(args.device)
        lr = LR if args.lr is None else args.lr
        kwargs = dict(lr=lr, unroll=not args.scan, use_pallas=args.pallas,
                      mixed=args.mixed, accum=args.accum)
        make_step(tokens, args.model_size, **kwargs)   # raises on bad combos
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    build_s = None
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if args.pallas:
            t0 = time.perf_counter()
            build_all([FWD, BWD_DX, BWD_DW])
            build_s = time.perf_counter() - t0

    # banner (train_ffns.py:353)
    print(f"ARGS:\n num_steps: {args.num_steps}\n BS: {args.batch_size}\n"
          f" N: {args.seq_len}\n D: {args.model_size}\n"
          f" FFN: {4 * args.model_size}\n")
    seeds = make_seed_schedule(args.num_steps, args.random_seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.random_seed)
    params = init_ffn_stack(gen, args.model_size, args.layers)
    print(f"PARAMS: {params.num_params():_} "
          f"(size {params_size_gb(params)} GB)\n\n", flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    stamps = []

    def on_step(_):
        sync()
        stamps.append(time.perf_counter())

    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_single(params, seeds, tokens, args.model_size,
                       on_step=on_step, **kwargs)
    wall = time.perf_counter() - t0
    steps = [b - a for a, b in zip([t0] + stamps, stamps)]
    step_s = statistics.median(steps[1:] if len(steps) > 1 else steps)
    flops = 12 * tokens * args.model_size * params.ffn_dim * args.layers
    print(f"\ntrain_single takes {wall} seconds")
    payload = {
        "method": args.method,
        "steps": args.num_steps,
        "tokens_per_step": tokens,
        "wall_s": wall,
        "build_s": build_s,
        "first_step_ms": 1e3 * steps[0],
        "median_step_ms": 1e3 * step_s,
        "tokens_per_s": tokens / step_s,
        "model_tflops_per_s": flops / step_s / 1e12,
        "pallas": args.pallas,
        "mixed": args.mixed,
        "accum": args.accum,
        "lr": lr,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "kernel_launches": launch_counts(),
        "layer_checksums": [[float(out.w1[l].double().sum()),
                             float(out.w2[l].double().sum())]
                            for l in range(out.n_layers)],
    }
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
