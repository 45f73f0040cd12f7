"""Training CLI of the port, the JAX package's ``cli.py`` for the methods
that are ported: ``-m 1`` (single device), ``-m 2`` (DDP), ``-m 3``
(FSDP) and ``-m 7`` (expert parallelism of the MoE stack).

    python -m distributed_llm_code_samples_tpu_torch.cli -m 1 -s 8 \\
        -bs 8 -n 1024 -l 24 -d 768 -r 7 --pallas
    python -m distributed_llm_code_samples_tpu_torch.cli -m 2 -s 32 \\
        -bs 8 -n 1024 -l 24 -d 768 -r 7 --comm pallas_ring
    python -m distributed_llm_code_samples_tpu_torch.cli --device cpu \\
        --fake_devices 4 -m 3 -s 8 -bs 2 -n 16 -l 2 -d 32 -r 7
    python -m distributed_llm_code_samples_tpu_torch.cli --device cpu \\
        --fake_devices 4 -m 7 -s 8 -bs 4 -n 16 -l 2 -d 32 -r 7 --experts 8

The reference's seven flags keep their short names and defaults; any
other method, the default 0 included, exits 2. It runs on the card
unless ``--device cpu`` is given. Methods 2, 3 and 7 spawn one rank per
visible card, or ``--fake_devices`` gloo ranks on the CPU; ``-s`` is the
global step count, split stride-wise over the ranks. ``--comm`` picks
the transport of methods 2 and 3 (``psum``: ``torch.distributed``;
``pallas_ring``: the ring kernels). Method 7 takes, as the JAX CLI's,
``--experts`` and the LR and leaves the rest at ``train_moe_ep``'s
defaults (top-1, capacity factor 2, no aux loss, the dense dispatch,
``comm="psum"``); its tokens a step (``-bs`` x ``-n``) are the whole EP
group's. It prints the reference's banner and ``PARAMS:`` line, then one
JSON line: steps, tokens per step (a rank; the group's for method 7),
wall time, the median step time (host clock, each step ending in a
synchronize, the first step left out unless it is the only one; rank
0's for the multi-rank methods), and from it tokens/s and the model
TFLOP/s (``12 * T * d * ffn * L`` a step, over all ranks; for method 7
T counts every routed token, dropped ones too); the device, the kernel
launch counts (rank 0's, and every rank's) and a per-layer checksum of
the final parameters. The kernels a run uses on the card are built
before the clock starts (``build_s``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

PORTED_METHODS = (1, 2, 3, 7)
RANK_METHODS = (2, 3, 7)


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
                   help="1=single device, 2=DDP, 3=FSDP, 7=MoE expert "
                        "parallelism (the methods ported so far)")
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
    p.add_argument("--comm", choices=["psum", "pallas_ring"], default=None,
                   help="with --method 2 (DDP) or 3 (FSDP): the transport, "
                        "psum (torch.distributed: NCCL, gloo on the CPU; "
                        "the default) or pallas_ring (the ring kernels: "
                        "DDP grad all-reduce; FSDP param all-gathers and "
                        "grad reduce-scatters)")
    p.add_argument("--experts", type=int, default=8,
                   help="expert count for --method 7 (MoE)")
    p.add_argument("--fake_devices", type=int, default=0,
                   help="with --device cpu and --method 2/3/7: run on N "
                        "gloo ranks (default 1)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _flag_error(args) -> str | None:
    """What is wrong with the flags, or None."""
    if args.method not in PORTED_METHODS:
        return (f"method {args.method} is not ported yet (ported: "
                f"{', '.join(map(str, PORTED_METHODS))})")
    if args.comm is not None and args.method not in (2, 3):
        return "--comm applies to --method 2 (DDP) or 3 (FSDP)"
    if args.fake_devices and args.method not in RANK_METHODS:
        return "--fake_devices applies to --method 2, 3 or 7"
    if args.fake_devices and args.device != "cpu":
        return ("--fake_devices runs gloo ranks on the CPU: pass --device "
                "cpu (on the card there is one rank a card)")
    if args.method in RANK_METHODS and (args.pallas or args.mixed
                                        or args.accum != 1):
        return ("--pallas, --mixed and --accum apply to --method 1 (the "
                "multi-rank trainers run the matmul blocks; mixed and "
                "accumulation are not ported there yet)")
    return None


def _rank_run(mesh, payload):
    """The body of one rank of ``-m 2|3|7``: train, time the steps, count
    the launches; returns them with rank 0's replica (DDP) or the rank's
    shards (FSDP, EP) on the CPU."""
    import torch

    from .ops import launch_counts, reset_launch_counts
    from .parallel import train_ddp, train_fsdp, train_moe_ep
    params, seeds, tokens, d, lr, method, comm = payload
    cuda = mesh.torch_device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.torch_device)

    stamps = []

    def on_step(_):
        sync()
        stamps.append(time.perf_counter())

    train = {2: train_ddp, 3: train_fsdp, 7: train_moe_ep}[method]
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train(params, seeds, tokens, d, mesh, lr, comm=comm,
                on_step=on_step)
    wall = time.perf_counter() - t0
    keep = method != 2 or mesh.rank == 0
    return dict(steps=[b - a for a, b in zip([t0] + stamps, stamps)],
                wall=wall, launches=launch_counts(),
                params=tuple(t.cpu() for t in out) if keep else None,
                device=(torch.cuda.get_device_name(mesh.torch_device)
                        if cuda else "cpu"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    err = _flag_error(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
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

    if args.method in RANK_METHODS:
        return _main_ranks(args, tokens)
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


def _main_ranks(args, tokens: int) -> int:
    """``-m 2`` (DDP), ``-m 3`` (FSDP) and ``-m 7`` (EP) over the ranks of
    the mesh."""
    import torch

    from . import LR, resolve_device
    from .data import make_seed_schedule, shard_seeds_strided
    from .models.ffn_stack import (FFNStackParams, init_ffn_stack,
                                   params_size_gb)
    from .models.moe import MoEStackParams, init_moe_stack
    from .ops import build_all
    from .parallel import DATA_AXIS, EXPERT_AXIS, launch_strided, make_mesh
    from .parallel import expert, fsdp
    comm = args.comm or "psum"
    lr = LR if args.lr is None else args.lr
    moe = args.method == 7
    axis = EXPERT_AXIS if moe else DATA_AXIS
    try:
        device = resolve_device(args.device)
        n = ((args.fake_devices or 1) if device.type == "cpu"
             else torch.cuda.device_count())
        mesh = make_mesh({axis: n}, device=device.type)
        seeds = make_seed_schedule(args.num_steps, args.random_seed)
        shard_seeds_strided(seeds, n)
        if args.method == 3 and (4 * args.model_size) % n:
            raise ValueError(f"FSDP shards d and ffn over {n} ranks: -d "
                             f"{args.model_size} does not split")
        if moe and (args.experts % n or tokens % n):
            raise ValueError(f"EP splits the {args.experts} experts and the "
                             f"{tokens} tokens of a step over {n} ranks: "
                             "they must divide")
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    build_s = None
    if device.type == "cuda" and comm == "pallas_ring":
        t0 = time.perf_counter()
        build_all(["ring_collectives"])
        build_s = time.perf_counter() - t0

    print(f"ARGS:\n num_steps: {args.num_steps}\n BS: {args.batch_size}\n"
          f" N: {args.seq_len}\n D: {args.model_size}\n"
          f" FFN: {4 * args.model_size}\n")
    gen = torch.Generator()
    gen.manual_seed(args.random_seed)
    params = (init_moe_stack(gen, args.model_size, args.layers, args.experts)
              if moe else init_ffn_stack(gen, args.model_size, args.layers))
    print(f"PARAMS: {params.num_params():_} "
          f"(size {params_size_gb(params)} GB)\n\n", flush=True)
    t0 = time.perf_counter()
    outs = launch_strided(_rank_run, params, seeds, mesh, tokens,
                          args.model_size, lr, args.method, comm)
    wall = time.perf_counter() - t0
    name = {2: "train_ddp", 3: "train_fsdp", 7: "train_moe_ep"}[args.method]
    print(f"\n{name} takes {wall} seconds")
    if args.method == 2:
        out = FFNStackParams(*outs[0]["params"])
    else:
        unshard = expert.unshard_params if moe else fsdp.unshard_params
        out = unshard([(MoEStackParams if moe else FFNStackParams)(
            *o["params"]) for o in outs])
    steps = outs[0]["steps"]
    step_s = statistics.median(steps[1:] if len(steps) > 1 else steps)
    # a rank's tokens: EP's -bs x -n are the group's
    flops = (12 * tokens * args.model_size * params.ffn_dim * args.layers
             * (1 if moe else n))
    payload = {
        "method": args.method,
        "steps": args.num_steps,
        "steps_per_rank": len(steps),
        "ranks": n,
        "comm": comm,
        "tokens_per_step": tokens,
        "wall_s": wall,
        "rank0_train_s": outs[0]["wall"],
        "build_s": build_s,
        "first_step_ms": 1e3 * steps[0],
        "median_step_ms": 1e3 * step_s,
        "tokens_per_s": (1 if moe else n) * tokens / step_s,
        "model_tflops_per_s": flops / step_s / 1e12,
        "lr": lr,
        "device": outs[0]["device"],
        "kernel_launches": outs[0]["launches"],
        "kernel_launches_per_rank": [o["launches"] for o in outs],
        "layer_checksums": [[float(out.w1[l].double().sum()),
                             float(out.w2[l].double().sum())]
                            for l in range(out.n_layers)],
    }
    if moe:
        payload["experts"] = args.experts
        payload["router_checksums"] = [float(out.wg[l].double().sum())
                                       for l in range(out.n_layers)]
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
