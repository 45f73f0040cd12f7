"""Training CLI of the port, the JAX package's ``cli.py`` for the methods
that are ported: ``-m 0`` (methods 1-4, then the cross-strategy check),
``-m 1`` (single device), ``-m 2`` (DDP), ``-m 3`` (FSDP), ``-m 4``
(Megatron TP; ``--tp_sp`` its sequence-parallel form), ``-m 5`` (the
hybrid DDP x TP on a ``--dp`` x ``--tp`` mesh), ``-m 7`` (expert
parallelism of the MoE stack), ``-m 8`` (Megatron TP of the transformer
blocks), ``-m 11`` (Megatron TP of the language model on the real
cross-entropy, vocab-parallel) and ``-m 13`` (the language model with its
sequence sharded over the ranks: ring attention or Ulysses).

    python -m distributed_llm_code_samples_tpu_torch.cli -m 1 -s 8 \\
        -bs 8 -n 1024 -l 24 -d 768 -r 7 --pallas
    python -m distributed_llm_code_samples_tpu_torch.cli -m 0 -s 8 \\
        -bs 8 -n 1024 -l 24 -d 768 -r 7 --strict --comm pallas_ring
    python -m distributed_llm_code_samples_tpu_torch.cli --device cpu \\
        --fake_devices 4 -s 8 -bs 2 -n 16 -l 2 -d 32 -r 7 --strict
    python -m distributed_llm_code_samples_tpu_torch.cli --device cpu \\
        --fake_devices 4 -m 5 --tp 2 -s 8 -bs 2 -n 16 -l 2 -d 32 -r 7
    python -m distributed_llm_code_samples_tpu_torch.cli --device cpu \\
        --fake_devices 4 -m 7 -s 8 -bs 4 -n 16 -l 2 -d 32 -r 7 --experts 8
    python -m distributed_llm_code_samples_tpu_torch.cli --device cpu \\
        --fake_devices 4 -m 2 --zero1 --optimizer adam --mixed -s 8 -bs 2 \\
        -n 16 -l 4 -d 32 -r 7
    python -m distributed_llm_code_samples_tpu_torch.cli --device cpu \\
        --fake_devices 4 --tp 4 -m 11 --head fused --attn flash -s 4 \\
        -bs 2 -n 16 -l 2 -d 32 -r 7 --vocab 256 --heads 4
    python -m distributed_llm_code_samples_tpu_torch.cli --device cpu \\
        --fake_devices 4 -m 13 --seq_impl ulysses --attn flash \\
        --head fused -s 4 -bs 2 -n 64 -l 2 -d 32 -r 7 --vocab 256

The reference's seven flags keep their short names and defaults; the
default method is 0, as the reference's; any method not listed exits 2.
It runs on the card unless ``--device cpu`` is given. Methods 2, 3, 4, 5,
7, 8, 11 and 13 spawn one rank per visible card (fewer than 2 cards exit
2), or
``--fake_devices`` gloo ranks on the CPU; ``-s`` is the global step
count, split stride-wise over the data ranks (TP's ranks each take every
step). ``--comm`` picks the transport of methods 2 and 3 (``psum``:
``torch.distributed``; ``pallas_ring``: the ring kernels); TP and the
hybrid reduce through ``torch.distributed`` (as in JAX, they have no
kernel transport). Method 5's mesh is ``--dp`` x ``--tp`` ranks,
``--dp`` defaulting to the ranks over ``--tp``. Method 7 takes, as the
JAX CLI's, ``--experts`` and the LR and leaves the rest at
``train_moe_ep``'s defaults (top-1, capacity factor 2, no aux loss, the
dense dispatch, ``comm="psum"``); its tokens a step (``-bs`` x ``-n``)
are the whole EP group's. Methods 8 and 11 run on a model axis of
``min(--tp, ranks)`` ranks (``--tp`` defaulting to 2), as the JAX CLI's:
``--heads`` heads, ``--attn`` (oracle, rope or flash), 8 also ``--tp_sp``,
11 ``--vocab``, ``--kv_heads`` (grouped-query attention; it must divide
``--heads`` and be divisible by the model axis) and ``--head`` (oracle
or the fused kernels); ``-n`` is the sequence length. Method 13 trains
the LM as ``train_lm_seq`` does, on a seq axis of the most ranks that
divide ``-n`` (and, under ``--seq_impl ulysses``, ``--heads``), as the
JAX CLI's: ``--seq_impl`` (ring or ulysses), ``--attn`` (oracle or
flash), ``--head``, ``--heads`` and ``--vocab``; full MHA only.

``--dtype bfloat16`` stores the params in bf16, as the JAX CLI's does,
for every ported method under SGD: the FFN stack's (methods 1-5 and 0),
the MoE stack's (7), the transformer's (8) and the LM's (11, 13). Every
block, gradient, sum and update is then bf16 (the kernels' f32 sums
rounded once where the Pallas kernels round them, the ring kernels'
sums rounded every add); the fused head (``-m 11 --head fused``) keeps
its statistics in f32 and returns bf16 gradients, so it trains where
the JAX CLI's asserts (its wrapper promotes them to f32). The optimizer
flags (``--optimizer`` other than sgd, ``--zero1``, ``--clip_norm``,
``--mixed``) refuse it for now (exit 2, ROADMAP.md Queue 1).

The training options follow the JAX CLI's rules: ``--optimizer``
(``optim.OPTIMIZERS``) and ``--clip_norm`` apply to methods 2 and 3
(clipping sums its norm over the data axis where the update runs on
shards: FSDP and ZeRO-1); ``--zero1`` runs method 2 as
``train_ddp_zero1`` (the optimizer state sharded over the ranks, not
with ``--comm pallas_ring``); ``--mixed`` (bf16 matmul operands) applies
to methods 1-5, also inside 0, and not with ``--pallas``; ``--accum``
to methods 1 and 2.

It prints the reference's banner, ``PARAMS:`` line and the first layer's
5x5 corners, then for each method its ``<trainer> takes N seconds`` line,
its final corners and one JSON line: steps, tokens per step (a rank;
the group's for method 7), wall time, the median step time (host clock,
each step ending in a synchronize, the first step left out unless it is
the only one; rank 0's for the multi-rank methods), the training
options, and from it tokens/s
and the model TFLOP/s (``12 * T * d * ffn * L`` a step for each batch
the mesh takes: once for TP, whose ranks share one batch, once a data
rank for DDP, FSDP and the hybrid; for method 7 T counts every routed
token, dropped ones too; for 8, 11 and 13 ``bench.py``'s count of the
blocks, and 11 and 13 add the head's ``6 * T * d * V``); the device, the kernel launch counts (rank
0's, and every rank's) and a per-layer checksum of the final
parameters. Method 0 then holds DDP against FSDP and single-device
against TP, leaf by leaf, within rtol 1e-5 and atol 1e-7 (1e-4 and 1e-5
under ``--pallas``): one ``verify`` line a pair, a ``SoftAssertionError:``
line for each leaf that disagrees, and with ``--strict`` exit code 1 if
one does; under ``--mixed`` within rtol 2e-2, atol 1e-4 (TP's bf16
contraction is split over the shards). ``--pallas`` applies to method 1
and ``--comm`` to methods 2 and 3, also inside method 0. The kernels a
run uses on the card are built before the clock starts (``build_s``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

PORTED_METHODS = (0, 1, 2, 3, 4, 5, 7, 8, 11, 13)
RANK_METHODS = (2, 3, 4, 5, 7, 8, 11, 13)
TRAINERS = {1: "train_single", 2: "train_ddp", 3: "train_fsdp",
            4: "train_tp", 5: "train_hybrid", 7: "train_moe_ep",
            8: "train_transformer_tp", 11: "train_lm_tp", 13: "train_lm_seq"}
# method 0's checks (JAX cli.py:944-955): (rtol, atol), under --pallas and
# under --mixed
CHECK_TOL, PALLAS_CHECK_TOL = (1e-5, 1e-7), (1e-4, 1e-5)
MIXED_CHECK_TOL = (2e-2, 1e-4)
OPTIMIZER_NAMES = ("sgd", "momentum", "adam", "adamw")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="FFN-stack training on NVIDIA GPUs (PyTorch port; "
                    "reference-parity flags, train_ffns.py:342-351)")
    p.add_argument("-s", "--num_steps", type=int, default=1)
    p.add_argument("-bs", "--batch_size", type=int, default=8)
    p.add_argument("-n", "--seq_len", type=int, default=1024)
    p.add_argument("-l", "--layers", type=int, default=1)
    p.add_argument("-d", "--model_size", type=int, default=4)
    p.add_argument("-m", "--method", type=int, default=0,
                   help="0=all(1-4) and the cross-strategy check, "
                        "1=single device, 2=DDP, 3=FSDP, 4=TP, 5=hybrid "
                        "DDP x TP, 7=MoE expert parallelism, 8=transformer "
                        "blocks (Megatron TP; --heads), 11=language model on "
                        "the real cross-entropy (vocab-parallel Megatron "
                        "TP; --vocab --heads), 13=long-context LM (the "
                        "sequence sharded; --seq_impl --vocab --heads) (the "
                        "methods ported so far)")
    p.add_argument("-r", "--random_seed", type=int, default=0,
                   help="!=0 makes runs reproducible (train_ffns.py:350)")
    p.add_argument("--pallas", action="store_true",
                   help="with --method 1 (also inside 0): run each FFN "
                        "block through the three CUDA kernels (their plain "
                        "versions on the CPU)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="the param storage of every method (SGD only): "
                        "bf16 params, blocks, gradients and sums with "
                        "--dtype bfloat16 (distinct from --mixed)")
    p.add_argument("--mixed", action="store_true",
                   help="with --method 1-5 (also inside 0, with --zero1 and "
                        "--tp_sp): bf16 matmul operands, f32 params/grads/"
                        "sums; FSDP gathers its shards in bf16")
    p.add_argument("--accum", type=int, default=1,
                   help="with --method 1 or 2 (also --zero1): gradient-"
                        "accumulation chunks per step (SUM semantics)")
    p.add_argument("--optimizer", choices=OPTIMIZER_NAMES, default="sgd",
                   help="with --method 2 or 3: the update rule (optim.py; "
                        "sgd is the reference's inline SGD)")
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="with --method 2 or 3: clip the gradients to this "
                        "global norm (0: off)")
    p.add_argument("--zero1", action="store_true",
                   help="with --method 2: ZeRO-1, the optimizer state "
                        "sharded over the ranks (train_ddp_zero1)")
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default: the reference's 1e-5)")
    p.add_argument("--scan", action="store_true",
                   help="does nothing in the port (accepted for parity "
                        "with the JAX CLI; both of its loop forms are one "
                        "Python loop here)")
    p.add_argument("--comm", choices=["psum", "pallas_ring"], default=None,
                   help="with --method 2 (DDP) or 3 (FSDP), also inside 0: "
                        "the transport, psum (torch.distributed: NCCL, "
                        "gloo on the CPU; the default) or pallas_ring (the "
                        "ring kernels: DDP grad all-reduce; FSDP param "
                        "all-gathers and grad reduce-scatters)")
    p.add_argument("--seq_impl", choices=["ring", "ulysses"],
                   default="ring",
                   help="with --method 13: the attention across the seq "
                        "ranks, ring (K/V blocks passed round the ring) or "
                        "ulysses (two all-to-alls trade heads for sequence)")
    p.add_argument("--tp_sp", action="store_true",
                   help="with --method 4 or 8: sequence-parallel TP (the "
                        "stream between blocks token-sharded; all-gather "
                        "in, reduce-scatter out)")
    p.add_argument("--dp", type=int, default=None,
                   help="with --method 5: data-axis size (default: the "
                        "ranks // --tp)")
    p.add_argument("--tp", type=int, default=None,
                   help="with --method 5, 8 or 11: model-axis size "
                        "(default 2; 8 and 11 take min(--tp, ranks))")
    p.add_argument("--heads", type=int, default=4,
                   help="attention heads for --method 8, 11 and 13")
    p.add_argument("--vocab", type=int, default=256,
                   help="vocabulary size for --method 11 (divisible by the "
                        "model-axis size) and 13")
    p.add_argument("--kv_heads", type=int, default=0,
                   help="with --method 11: grouped-query attention with this "
                        "many KV heads (0 = full MHA; must divide --heads "
                        "and the model-axis size must divide it)")
    p.add_argument("--attn", choices=["oracle", "rope", "flash"],
                   default="oracle",
                   help="attention for --method 8, 11 and 13: the hand-VJP "
                        "oracle, rotary positions (not 13), or the flash "
                        "kernels (their plain versions on the CPU)")
    p.add_argument("--head", choices=["oracle", "fused"], default="oracle",
                   help="LM head and loss for --method 11 and 13: the logits "
                        "and the hand-VJP cross-entropy, or the fused head's "
                        "kernels (11: vocab-parallel merge)")
    p.add_argument("--strict", action="store_true",
                   help="with --method 0: a failed cross-strategy check "
                        "exits 1 (the reference only soft-asserts, "
                        ":386-391)")
    p.add_argument("--experts", type=int, default=8,
                   help="expert count for --method 7 (MoE)")
    p.add_argument("--fake_devices", type=int, default=0,
                   help="with --device cpu and --method 0, 2, 3, 4, 5, 7, 8, "
                        "11 or 13: run on N gloo ranks (default 1)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _flag_error(args) -> str | None:
    """What is wrong with the flags, or None."""
    m = args.method
    if m not in PORTED_METHODS:
        return (f"method {m} is not ported yet (ported: "
                f"{', '.join(map(str, PORTED_METHODS))})")
    if args.comm is not None and m not in (0, 2, 3):
        return "--comm applies to --method 2 (DDP) or 3 (FSDP), or 0"
    if args.zero1 and m != 2:
        return "--zero1 applies to --method 2 only"
    if args.zero1 and args.comm not in (None, "psum"):
        return ("--comm pallas_ring does not apply to --zero1 (ZeRO-1's "
                "reduce-scatter and all-gather keep the psum transport); "
                "drop one of the flags")
    if args.mixed and args.pallas:
        return ("--mixed cannot combine with --pallas: the fused kernel "
                "block has its own residual and precision policy")
    if args.mixed and m not in (0, 1, 2, 3, 4, 5):
        return "--mixed applies to --method 1-5 (also inside 0)"
    if args.accum != 1 and m not in (1, 2):
        return "--accum applies to --method 1 or 2 only"
    if args.optimizer != "sgd" and m not in (2, 3):
        return "--optimizer applies to --method 2 or 3 only"
    if args.clip_norm and m not in (2, 3):
        return "--clip_norm applies to --method 2 or 3 only"
    if args.clip_norm < 0:
        return f"--clip_norm must be >= 0 (got {args.clip_norm})"
    if args.fake_devices and m not in (0,) + RANK_METHODS:
        return ("--fake_devices applies to --method 0, 2, 3, 4, 5, 7, 8, 11 "
                "or 13")
    if args.fake_devices and args.device != "cpu":
        return ("--fake_devices runs gloo ranks on the CPU: pass --device "
                "cpu (on the card there is one rank a card)")
    if args.pallas and m not in (0, 1):
        return ("--pallas applies to --method 1, also inside 0 (the "
                "multi-rank trainers run the matmul blocks)")
    if args.tp_sp and m not in (4, 8):
        return "--tp_sp applies to --method 4 or 8 only"
    if args.dp is not None and m != 5:
        return "--dp applies to --method 5 only"
    if args.tp is not None and m not in (5, 8, 11):
        return "--tp applies to --method 5, 8 or 11 only"
    # the transformer and LM flags, with the JAX CLI's messages
    if args.attn != "oracle" and m not in (8, 11, 13):
        return ("--attn applies to --method 8, 11, 13, or 6 with "
                "--pp_family transformer/lm")
    if m == 13 and args.kv_heads:
        return ("--method 13 (sequence-parallel LM) supports full MHA only "
                "(no --kv_heads): the ring vmaps equal q/kv heads")
    if m == 13 and args.attn == "rope":
        return ("--attn rope is not supported by --method 13 (the ring's "
                "per-hop programs take oracle or flash)")
    if args.kv_heads < 0:
        return f"--kv_heads must be >= 0 (got {args.kv_heads})"
    if args.kv_heads and m != 11:
        return ("--kv_heads applies to the LM family only (--method 11, 9, "
                "or 6 with --pp_family lm)")
    if args.kv_heads and args.heads % args.kv_heads:
        return (f"--heads {args.heads} not divisible by --kv_heads "
                f"{args.kv_heads}")
    if args.head != "oracle" and m not in (11, 13):
        return ("--head fused applies to --method 11 (LM TP), 12 (MoE LM "
                "EP), 13 (sequence-parallel LM), or the --method 9 sweep "
                "(which verifies them)")
    if args.strict and m != 0:
        return "--strict applies to --method 0 only (its checks)"
    if args.dtype == "bfloat16":
        return _bf16_error(args)
    return None


def _bf16_error(args) -> str | None:
    """What ``--dtype bfloat16`` does not take yet: the optimizer options,
    whose bf16 forms are the next slice's work."""
    queued = ("is ported under SGD only so far (every method); the "
              "optimizers, ZeRO-1, clipping and --mixed on bf16 params are "
              "queued in ROADMAP.md Queue 1")
    for flag, on in (("--optimizer " + args.optimizer,
                      args.optimizer != "sgd"), ("--zero1", args.zero1),
                     ("--clip_norm", bool(args.clip_norm)),
                     ("--mixed", args.mixed)):
        if on:
            return f"--dtype bfloat16 with {flag}: bf16 storage " + queued
    return None


def _meshes(args, tokens: int, seeds, device) -> dict:
    """The mesh of each multi-rank method this run takes, checked as the
    trainers would check it, so a bad combination exits 2 before
    anything is spawned."""
    import torch

    from .data import shard_seeds_strided
    from .parallel import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS,
                           make_mesh)
    methods = [1, 2, 3, 4] if args.method == 0 else [args.method]
    methods = [m for m in methods if m in RANK_METHODS]
    if not methods:
        return {}
    n = ((args.fake_devices or 1) if device.type == "cpu"
         else torch.cuda.device_count())
    if device.type == "cuda" and n < 2:
        raise RuntimeError(f"only {n} card visible; the multi-rank methods "
                           "need >= 2 (one rank a card), or --device cpu "
                           "--fake_devices N")
    ffn = 4 * args.model_size
    meshes = {}
    for m in methods:
        if m in (8, 11):
            meshes[m] = _tp_family_mesh(args, m, min(args.tp or 2, n),
                                        device)
            continue
        if m == 13:
            # the seq axis over the most ranks that divide the sequence
            # (and, for Ulysses, the heads it scatters): JAX cli.py
            k = max(k for k in range(1, n + 1)
                    if n % k == 0 and args.seq_len % k == 0
                    and (args.seq_impl == "ring" or args.heads % k == 0))
            if args.model_size % args.heads:
                raise ValueError(f"model_size={args.model_size} not "
                                 f"divisible by n_heads={args.heads} (head "
                                 "dim must be whole)")
            meshes[m] = make_mesh({SEQ_AXIS: k}, device=device.type)
            continue
        if m in (2, 3):
            shard_seeds_strided(seeds, n)
            if m == 3 and ffn % n:
                raise ValueError(f"FSDP shards d and ffn over {n} ranks: "
                                 f"-d {args.model_size} does not split")
            if args.zero1 and args.layers % n:
                raise ValueError(f"{args.layers} layers not divisible "
                                 f"across {n} ranks: ZeRO-1 partitions "
                                 "optimizer state in whole-layer units")
            meshes[m] = make_mesh({DATA_AXIS: n}, device=device.type)
        elif m == 4:
            if ffn % n or (args.tp_sp and tokens % n):
                raise ValueError(f"TP splits the ffn dim {ffn}"
                                 + (f" and the {tokens} tokens" if args.tp_sp
                                    else "") + f" over {n} ranks: "
                                 "they must divide")
            meshes[m] = make_mesh({MODEL_AXIS: n}, device=device.type)
        elif m == 5:
            tp = 2 if args.tp is None else args.tp
            dp = args.dp or max(1, n // tp)
            if dp < 1 or tp < 1 or dp * tp > n:
                raise ValueError(f"the hybrid mesh {dp} x {tp} needs "
                                 f"{dp * tp} ranks, {n} available")
            if ffn % tp:
                raise ValueError(f"ffn_dim {ffn} not divisible by {tp} "
                                 "model shards")
            shard_seeds_strided(seeds, dp)
            meshes[m] = make_mesh({DATA_AXIS: dp, MODEL_AXIS: tp},
                                  device=device.type)
        else:
            shard_seeds_strided(seeds, n)
            if args.experts % n or tokens % n:
                raise ValueError(f"EP splits the {args.experts} experts and "
                                 f"the {tokens} tokens of a step over {n} "
                                 "ranks: they must divide")
            meshes[m] = make_mesh({EXPERT_AXIS: n}, device=device.type)
    return meshes


def _tp_family_mesh(args, m: int, tp: int, device):
    """The model-axis mesh of method 8 or 11 (JAX ``cli.py``'s
    ``min(--tp, devices)``), its splits checked as the trainers check
    them."""
    from .parallel import MODEL_AXIS, make_mesh
    if args.kv_heads and tp > 1 and args.kv_heads % tp:
        raise ValueError(f"--kv_heads {args.kv_heads} not divisible by the "
                         f"model-axis size {tp} (min(--tp, devices)) "
                         f"required by --method {m}")
    d = args.model_size
    if d % args.heads or args.heads % tp or (4 * d) % tp:
        raise ValueError(f"TP splits the {args.heads} heads of d {d} and "
                         f"the ffn dim {4 * d} over {tp} ranks: they must "
                         "divide")
    if m == 11 and args.vocab % tp:
        raise ValueError(f"vocab={args.vocab} not divisible by model-axis "
                         f"size {tp}")
    if m == 8 and args.tp_sp and args.seq_len % tp:
        raise ValueError(f"seq_len={args.seq_len} not divisible by "
                         f"model-axis size {tp} (sequence-parallel TP "
                         "shards tokens)")
    return make_mesh({MODEL_AXIS: tp}, device=device.type)


def _rank_run(mesh, payload):
    """The body of one rank of a multi-rank method: train, time the steps,
    count the launches; returns them with rank 0's replica (DDP) or the
    rank's shards (the others) on the CPU."""
    import torch

    from .ops import launch_counts, reset_launch_counts
    from .optim import leaves
    from .parallel import (train_ddp, train_ddp_zero1, train_fsdp,
                           train_hybrid, train_lm_seq, train_lm_tp,
                           train_moe_ep, train_tp, train_tp_sp,
                           train_transformer_tp)
    params, seeds, tokens, d, lr, method, comm, tp_sp, options = payload
    cuda = mesh.torch_device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.torch_device)

    stamps = []

    def on_step(_):
        sync()
        stamps.append(time.perf_counter())

    kwargs = dict(on_step=on_step, **options)
    if method in (2, 3, 7) and not options.get("zero1"):
        kwargs["comm"] = comm
    train = {2: train_ddp, 3: train_fsdp, 4: train_tp_sp if tp_sp
             else train_tp, 5: train_hybrid, 7: train_moe_ep,
             8: train_transformer_tp, 11: train_lm_tp,
             13: train_lm_seq}[method]
    if kwargs.pop("zero1", False):
        train = train_ddp_zero1
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train(params, seeds, tokens, d, mesh, lr, **kwargs)
    wall = time.perf_counter() - t0
    keep = method not in (2, 13) or mesh.rank == 0   # replicas: rank 0's
    return dict(steps=[b - a for a, b in zip([t0] + stamps, stamps)],
                wall=wall, launches=launch_counts(),
                params=[t.cpu() for t in leaves(out)] if keep else None,
                device=(torch.cuda.get_device_name(mesh.torch_device)
                        if cuda else "cpu"))


def _stack(params):
    """The container of the per-layer ``w1``/``w2`` the reports read: the
    LM's blocks, else the params."""
    return getattr(params, "blocks", params)


def _corners(params, moe: bool) -> str:
    """The first layer's shapes and 5x5 corners (JAX ``cli.py``)."""
    params = _stack(params)

    def corner(w):
        return (w[0, 0] if moe else w[0])[:5, :5]
    return (f"layers_params[0] {tuple(params.w1[0].shape)} "
            f"{tuple(params.w2[0].shape)}\n{corner(params.w1)}\n"
            f"{corner(params.w2)}")


def _median_step(steps) -> float:
    return statistics.median(steps[1:] if len(steps) > 1 else steps)


def _checksums(out) -> list:
    out = _stack(out)
    return [[float(out.w1[l].double().sum()), float(out.w2[l].double().sum())]
            for l in range(out.n_layers)]


def _init(args, gen):
    """The initial params of ``args.method``'s family (JAX ``cli.py``'s
    ``params_for``), at ``--dtype``."""
    import torch

    from .models import init_lm, init_transformer
    from .models.ffn_stack import init_ffn_stack
    from .models.moe import init_moe_stack
    d, layers = args.model_size, args.layers
    dtype = getattr(torch, args.dtype)
    if args.method == 7:
        return init_moe_stack(gen, d, layers, args.experts, dtype=dtype)
    if args.method == 8:
        return init_transformer(gen, d, layers, dtype=dtype)
    if args.method in (11, 13):
        return init_lm(gen, args.vocab, d, layers, max_seq_len=args.seq_len,
                       n_heads=args.heads, n_kv_heads=args.kv_heads or None,
                       dtype=dtype)
    return init_ffn_stack(gen, d, layers, dtype=dtype)


def _model_flops(args, tokens: int, m: int) -> float:
    """Model flops of one batch: ``12 T d ffn L`` for the FFN stack and the
    MoE (method 7 counts every routed token), ``bench.py``'s count for the
    transformer blocks (``3 B L (8 S d^2 + 2 S^2 d + 16 d^2 S)``, B the
    sequences, S their length), plus the head's ``6 T d V`` for the LM."""
    d, layers, seq = args.model_size, args.layers, args.seq_len
    if m not in (8, 11, 13):
        return 12 * tokens * d * 4 * d * layers
    flops = 3 * (tokens // seq) * layers * (
        8 * seq * d ** 2 + 2 * seq ** 2 * d + 16 * d ** 2 * seq)
    return flops + (6 * tokens * d * args.vocab if m in (11, 13) else 0)


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
    from .models.ffn_stack import params_size_gb
    from .ops import build_all
    from .ops.fused_ffn import BWD_DW, BWD_DX, FWD
    from .parallel.single import make_step

    methods = [1, 2, 3, 4] if args.method == 0 else [args.method]
    lr = LR if args.lr is None else args.lr
    comm = args.comm or "psum"
    seeds = make_seed_schedule(args.num_steps, args.random_seed)
    single_kwargs = dict(lr=lr, unroll=not args.scan, use_pallas=args.pallas,
                         mixed=args.mixed, accum=args.accum)
    try:
        device = resolve_device(args.device)
        meshes = _meshes(args, tokens, seeds, device)
        if 1 in methods:
            make_step(tokens, args.model_size, **single_kwargs)  # bad combos
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    build_s = None
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        libs = ([FWD, BWD_DX, BWD_DW] if args.pallas else []) + (
            ["ring_collectives"] if comm == "pallas_ring" else []) + (
            ["flash_attn_fwd", "flash_attn_bwd"] if args.attn == "flash"
            else []) + (["head_xent_fwd", "head_xent_bwd"]
                        if args.head == "fused" else [])
        if libs:
            t0 = time.perf_counter()
            build_all(libs)
            build_s = time.perf_counter() - t0

    # banner (train_ffns.py:353)
    print(f"ARGS:\n num_steps: {args.num_steps}\n BS: {args.batch_size}\n"
          f" N: {args.seq_len}\n D: {args.model_size}\n"
          f" FFN: {4 * args.model_size}\n")
    moe = args.method == 7
    gen = torch.Generator()
    gen.manual_seed(args.random_seed)
    params = _init(args, gen)
    print(f"PARAMS: {params.num_params():_} "
          f"(size {params_size_gb(params)} GB)\n\n", flush=True)
    print(f"initial {_corners(params, moe)}", flush=True)
    results = {}
    for m in methods:
        common = dict(method=m, steps=args.num_steps, tokens_per_step=tokens,
                      lr=lr, dtype=args.dtype, build_s=build_s)
        if m == 1:
            out, payload = _run_single(args, params, seeds, tokens, device,
                                       single_kwargs)
        else:
            out, payload = _run_ranks(args, m, meshes[m], params, seeds,
                                      tokens, lr, comm)
        results[m] = out
        name = ("train_ddp_zero1" if m == 2 and args.zero1
                else TRAINERS[m])
        print(f"final {name} {_corners(out, moe)}")
        print(json.dumps(dict(common, **payload,
                              layer_checksums=_checksums(out))), flush=True)
    if args.method == 0:
        failed = _check(results, *(PALLAS_CHECK_TOL if args.pallas else
                                    MIXED_CHECK_TOL if args.mixed
                                    else CHECK_TOL))
        return 1 if failed and args.strict else 0
    return 0


def _run_single(args, params, seeds, tokens: int, device, kwargs):
    """Method 1 on ``device``: ``train_single`` with its steps timed."""
    import torch

    from .ops import launch_counts, reset_launch_counts
    from .parallel.single import train_single

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    stamps = []

    def on_step(_):
        sync()
        stamps.append(time.perf_counter())

    params = type(params)(*(t.to(device) for t in params))
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_single(params, seeds, tokens, args.model_size,
                       on_step=on_step, **kwargs)
    wall = time.perf_counter() - t0
    print(f"\ntrain_single takes {wall} seconds")
    steps = [b - a for a, b in zip([t0] + stamps, stamps)]
    step_s = _median_step(steps)
    flops = _model_flops(args, tokens, 1)
    return type(out)(*(t.cpu() for t in out)), {
        "wall_s": wall,
        "first_step_ms": 1e3 * steps[0],
        "median_step_ms": 1e3 * step_s,
        "tokens_per_s": tokens / step_s,
        "model_tflops_per_s": flops / step_s / 1e12,
        "pallas": args.pallas,
        "mixed": args.mixed,
        "accum": args.accum,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "kernel_launches": launch_counts(),
    }


def _run_ranks(args, m: int, mesh, params, seeds, tokens: int, lr: float,
               comm: str):
    """Method ``m`` over the ranks of ``mesh``; returns the full final
    params and the method's payload."""
    from .models import TransformerParams, lm_from_leaves
    from .models.ffn_stack import FFNStackParams
    from .models.moe import MoEStackParams
    from .parallel import DATA_AXIS, expert, fsdp, hybrid, launch_replicated
    from .parallel import lm as lm_mod
    from .parallel import tp as tp_mod
    from .parallel import transformer as tf_mod
    n = mesh.size
    # the batches the mesh takes a step: one a data rank (DDP, FSDP, the
    # hybrid); TP's and the seq axis's ranks share one, and EP's tokens
    # are the group's
    batches = {2: n, 3: n, 4: 1, 5: mesh.shape.get(DATA_AXIS, 1), 7: 1,
               8: 1, 11: 1, 13: 1}[m]
    comm = comm if m in (2, 3, 7) and not args.zero1 else "psum"
    options = _rank_options(args, m)
    t0 = time.perf_counter()
    outs = launch_replicated(_rank_run, params, seeds, mesh, tokens,
                             args.model_size, lr, m, comm, args.tp_sp,
                             options)
    wall = time.perf_counter() - t0
    name = "train_ddp_zero1" if args.zero1 else TRAINERS[m]
    print(f"\n{name} takes {wall} seconds")
    make = {7: MoEStackParams, 8: TransformerParams,
            11: lambda *ls: lm_from_leaves(ls),
            13: lambda *ls: lm_from_leaves(ls)}.get(m, FFNStackParams)
    shards = [make(*o["params"]) for o in outs if o["params"] is not None]
    if m in (2, 13):
        out = shards[0]
    elif m == 5:
        out = hybrid.unshard_params(shards, mesh)
    elif m == 8:
        out = tf_mod.tp_unshard(shards)
    elif m == 11:
        out = lm_mod.lm_tp_unshard(shards)
    else:
        out = {3: fsdp, 4: tp_mod, 7: expert}[m].unshard_params(shards)
    steps = outs[0]["steps"]
    step_s = _median_step(steps)
    flops = _model_flops(args, tokens, m) * batches
    payload = {
        "steps_per_rank": len(steps),
        "ranks": n,
        "mesh": dict(mesh.shape),
        "comm": comm,
        "wall_s": wall,
        "rank0_train_s": outs[0]["wall"],
        "first_step_ms": 1e3 * steps[0],
        "median_step_ms": 1e3 * step_s,
        "tokens_per_s": batches * tokens / step_s,
        "model_tflops_per_s": flops / step_s / 1e12,
        "device": outs[0]["device"],
        "kernel_launches": outs[0]["launches"],
        "kernel_launches_per_rank": [o["launches"] for o in outs],
        "mixed": args.mixed, "accum": args.accum,
        "optimizer": (getattr(options.get("optimizer"), "name", None)),
        "zero1": args.zero1,
    }
    if m in (4, 8):
        payload["sequence_parallel"] = args.tp_sp
    if m in (8, 11, 13):
        payload.update(heads=args.heads, attn=args.attn)
    if m in (11, 13):
        payload.update(vocab=args.vocab, kv_heads=args.kv_heads,
                       head=args.head)
    if m == 13:
        payload["seq_impl"] = args.seq_impl
    if m == 7:
        payload["experts"] = args.experts
        payload["router_checksums"] = [float(out.wg[l].double().sum())
                                       for l in range(out.n_layers)]
    return out, payload


def _rank_options(args, m: int) -> dict:
    """The trainer keywords of method ``m`` from the training flags (JAX
    ``cli.py``'s): ``mixed`` for 2-5, ``accum`` for 2, and for 2 and 3
    the optimizer, clipped (over the data axis where the update runs on
    shards) when ``--clip_norm`` is set; ``zero1`` picks
    ``train_ddp_zero1``; for 8, 11 and 13 the sequence length, the heads
    and the attention (and head) policy, for 13 also ``seq_impl``."""
    from .optim import OPTIMIZERS, clipped
    from .parallel import DATA_AXIS
    out = {}
    if args.mixed and m in (2, 3, 4, 5):
        out["mixed"] = True
    if args.accum != 1 and m == 2:
        out["accum"] = args.accum
    if m in (2, 3) and (args.optimizer != "sgd" or args.zero1
                        or args.clip_norm):
        opt = OPTIMIZERS[args.optimizer]()
        if args.clip_norm:
            sharded = m == 3 or args.zero1
            opt = clipped(opt, args.clip_norm,
                          axis=DATA_AXIS if sharded else None)
        out["optimizer"] = opt
    if args.zero1:
        out["zero1"] = True
    if m in (8, 11, 13):
        # the trainer keywords of JAX cli.py:715-729
        out.update(seq_len=args.seq_len, n_heads=args.heads)
        if args.attn != "oracle":
            out["attn_impl"] = args.attn
        if m == 8 and args.tp_sp:
            out["sequence_parallel"] = True
        if m in (11, 13) and args.head != "oracle":
            out["head_impl"] = args.head
        if m == 13:
            out["seq_impl"] = args.seq_impl
    return out


def _check(results: dict, rtol: float, atol: float) -> bool:
    """Method 0's checks (JAX ``cli.py:944-955``): DDP against FSDP (the
    reference's own, ``train_ffns.py:386-391``) and single-device against
    TP (the same steps). Prints a ``verify`` line a pair and a
    ``SoftAssertionError:`` line for each leaf that disagrees; returns
    whether one did."""
    import numpy as np
    failed = False
    for la, lb, a, b in (("ddp", "fsdp", results[2], results[3]),
                         ("1dev", "tp", results[1], results[4])):
        diffs = {}
        for field, pa, pb in zip(a._fields, a, b):
            # bf16 widened exactly: their differences are exact in f32
            pa, pb = pa.float().numpy(), pb.float().numpy()
            diffs[field] = float(np.abs(pa - pb).max())
            if not np.allclose(pa, pb, rtol=rtol, atol=atol):
                print(f"SoftAssertionError: {la}.{field} vs {lb}.{field} "
                      f"max|diff|={diffs[field]}")
                failed = True
        print("verify " + json.dumps(dict(a=la, b=lb, max_abs_diff=diffs,
                                          rtol=rtol, atol=atol)),
              flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
