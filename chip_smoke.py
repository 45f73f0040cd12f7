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
    python3 chip_smoke.py --phase tp       # TP, TP-SP and the hybrid,
                                           # 4 virtual ranks
    python3 chip_smoke.py --phase opt      # the bf16-storage kernels, the
                                           # optimizers, ZeRO-1, mixed
    python3 chip_smoke.py --phase lmtp     # the LM kernels, Megatron TP
                                           # of the LM and the transformer,
                                           # 4 virtual ranks
    python3 chip_smoke.py --phase lmdp     # the LM kernels, DDP, FSDP and
                                           # the hybrid of the LM and the
                                           # transformer, 4 virtual ranks
    python3 chip_smoke.py --phase bf16     # --dtype bfloat16: the FFN
                                           # kernels, the head, the ring
                                           # sums, hop and all-to-all on
                                           # bf16; the FFN stack's, the
                                           # LM's, the transformer's and
                                           # the MoE stack's training
    python3 chip_smoke.py --phase seq      # the LM kernels, ring attention
                                           # and Ulysses, the LM at 4096
                                           # positions on 4 virtual ranks
    python3 chip_smoke.py --phase dist     # ring, DDP/FSDP, all-to-all,
                                           # EP, TP, the hybrid, LM TP,
                                           # cli.py -m 0, 8, 11 and LM DP
                                           # on 4 cards (not in the
                                           # default run)
    python3 chip_smoke.py --phase dist-tp  # --phase dist's TP, hybrid,
                                           # LM TP and -m 0, 8, 11 alone
    python3 chip_smoke.py --phase dist-lmdp  # --phase dist's LM and
                                             # transformer DDP, FSDP and
                                             # hybrid alone
    python3 chip_smoke.py --phase dist-bf16  # --phase dist's bf16 ring
                                             # sums, hop, all-to-all, EP,
                                             # LM TP and -m 0, 7, 8, 11 in
                                             # bf16 alone
    python3 chip_smoke.py --phase dist-seq   # --phase seq's training on 4
                                             # cards over NCCL and cli.py
                                             # -m 13 ring and Ulysses (not
                                             # in --phase dist)

Builds every kernel of the port from ``csrc/`` (printing ptxas's spill
counts as ``ptxas-spills``), holds each against its plain PyTorch
version on the card, times both (the paged decode attention also at
each split size, ``paged-splits``), then drives the port's paths:

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
  its plain ring and NCCL, traces one reduce-scatter, one all-reduce,
  one all-gather, one hop and one all-to-all (``dist-rs-trace``,
  ``dist-ar-trace``, ``dist-ag-trace``, ``dist-hop-trace``,
  ``dist-a2a-trace``), runs one workspace through a sequence of the
  kernels with one rank's card held back (``dist-ring-sequence``), trains
  both strategies under both transports and profiles rank 0;
- expert parallelism: ``train_moe_ep`` of the MoE stack of
  ``bench_moe.py``'s headline (d 768, 6 layers, 8 experts of ffn 3072,
  top-2, 8192 tokens a step over 4 ranks) for 8 steps a rank under each
  dispatch (dense, scatter, gather), every exchange the all-to-all
  kernel (``csrc/ring_collectives.cu``): on 4 virtual ranks of one card
  in the default run; ``--phase dist`` also runs it on 4 cards under
  both transports (NCCL's ``all_to_all_single`` and the kernel), which
  must end bit-identical;
- tensor parallelism: ``train_tp`` and ``train_tp_sp`` of that FFN stack
  on 4 ranks and ``train_hybrid`` on a 2 x 2 data x model mesh, 8 steps
  a rank (``tp-train-run``), then one step of each at ``CHECK_LR`` held
  against float64 (``tp-train-check``: TP's and TP-SP's update against
  ``train_single``'s error, the hybrid's against DDP's on 2 ranks, and
  unchanged weights as a control that must fail). Their collectives
  launch no kernel (TP has no kernel transport, as in JAX): on one card
  in loopback they are plain torch within each axis group; ``--phase
  dist`` runs them one rank a card over NCCL row and column groups, and
  then the reference's own ``-m 0`` through ``cli.py`` at this shape
  with ``--strict`` (``dist-cli-m0``);
- the stateful optimizers and the bf16 ``mixed`` policy (``--phase
  opt``): the kernels that take bf16 storage (the all-gather of FSDP's
  bf16 shards bit for bit, the flash forward and backward at the LM
  shape against float64, ``bf16-kernel-case``), DDP, ZeRO-1 and FSDP of
  that FFN stack under Adam and DDP and FSDP under clipped mixed AdamW
  on 4 virtual ranks, 8 steps a rank (``opt-train-run``: launches, the
  state ZeRO-1's ranks hold), their agreement and one Adam step of each
  at ``CHECK_LR`` against float64 (``opt-train-check``), and the LM
  under mixed AdamW through the bf16 flash kernels against the same run
  in f32 (``opt-lm-run``, ``opt-lm-check``). ``--phase dist`` also holds
  the bf16 gather across the 4 cards against NCCL's
  (``dist-bf16-kernel-case``), runs those FFN strategies one rank a card
  under both transports (``dist-opt-train-run``,
  ``dist-opt-train-check``) and ``cli.py -m 2 --zero1 --optimizer adam
  --mixed``, ``-m 3 --optimizer adamw --clip_norm 1.0 --mixed --comm
  pallas_ring`` and ``-m 0 --mixed --strict`` (``dist-cli-zero1``,
  ``dist-cli-fsdp-adamw``, ``dist-cli-m0-mixed``);
- Megatron TP of the LM and of the transformer (``--phase lmtp``): at
  the LM-training shape above on 4 ranks, each with 3 of the 12 heads
  and 12576 of the 50304 vocab rows, ``train_lm_tp`` under flash
  attention with the fused head, flash with the oracle head and rope
  with the oracle head, and ``train_transformer_tp`` of the 12-layer
  trunk plain and sequence-parallel under flash, 8 steps each
  (``lmtp-train-run``: the step, tokens/s and each LM kernel's launches a
  rank, which must be exact); one step of each at ``CHECK_LR`` held
  against float64 over the single-device trainer's error
  (``lmtp-train-check``, unchanged weights as the control); and the
  head kernels on each rank's vocab shard against float64
  (``lmtp-head-case``: shifted targets outside the shard and in the pad
  columns of an unaligned shard, the backward given the merged lse, with
  controls that must fail). The default run holds the ranks on one card
  in loopback; ``--phase dist`` and ``dist-tp`` run them one rank a card
  over NCCL and then ``cli.py -m 11 --head fused --attn flash`` and
  ``-m 8 --tp_sp --attn flash`` at that shape (``dist-cli-m11``,
  ``dist-cli-m8-sp``);
- data parallelism of the LM and of the transformer (``--phase lmdp``):
  at the LM-training shape, 16 sequences of 512 tokens a rank a step,
  ``train_lm_ddp`` and ``train_lm_fsdp`` under flash attention and the
  fused head, ``train_lm_hybrid`` under flash on a 2 x 2 data x model
  mesh, ``train_transformer_ddp``, ``_fsdp`` and ``_hybrid`` of the
  12-layer trunk under flash, and the LM's DDP and FSDP under clipped
  mixed AdamW (the bf16 flash kernels), 4 steps each on 4 ranks
  (``lmdp-train-run``: the step, tokens/s, peak memory and each LM
  kernel's launches a rank, exact: 12 of each flash kernel a step, FSDP
  24 forwards since its backward recomputes each block, and 1 of each
  head kernel where the fused head runs); one step of each at
  ``CHECK_LR`` against a float64 update on the summed gradients of the
  ranks' batches over the error of the same sum of the single-device f32
  gradients (``lmdp-train-check``, unchanged weights as the control).
  The default run holds the ranks on one card in loopback; ``--phase
  dist`` and ``dist-lmdp`` run them one rank a card over NCCL, where
  FSDP's peak memory a rank must be below DDP's (``lmdp-memory``);
- ``--dtype bfloat16`` of the FFN stack (``--phase bf16``): the three
  FFN kernels on bf16 storage at the training and a ragged shape against
  their plain versions and against float64 with the kernels' roundings
  (``BF16_SHARE``, with a control that must fail), timed beside their f32
  calls and the cuBLAS bf16 composition, and the all-reduce and the
  reduce-scatter of bf16 in loopback bit for bit against the plain ring
  (``bf16-ffn-kernel-case``, ``bf16-ring-kernel-case``); ``train_single``
  on bf16 params at the training shape through the kernels and through
  cuBLAS bf16 blocks (``bf16-train-run``: 24 launches of each FFN
  kernel's ``[bf16]`` form a step, exact), ``cli.py -m 1 --pallas
  --dtype bfloat16`` there (``bf16-cli-m1``), DDP and FSDP over the ring
  kernels on 4 virtual ranks (``bf16-ring-train-run``: 48
  ``ring_all_reduce[bf16]`` a step, exact), and ``bf16-train-check``
  (one step's gradients against float64 over the cuBLAS bf16 path's
  error, every ring call of one step bit for bit, DDP against FSDP
  within two steps). ``--phase dist`` and ``dist-bf16`` hold the bf16
  sums across the 4 cards against the plain ring and NCCL's bf16 calls
  (``dist-bf16-kernel-case``) and run ``cli.py -m 0 --dtype bfloat16
  --strict --comm pallas_ring`` (``dist-cli-m0-bf16``);
- ``--dtype bfloat16`` of the LM, transformer and MoE methods (``--phase
  bf16`` too): the fused head's two kernels on bf16 storage at the LM
  shape and on one TP rank's vocab shard against float64 (the
  statistics within ``FFN_TOL``, the gradients within one bf16 step in
  at most ``BF16_SHARE`` of them, each with a control that must fail)
  and their plain versions, timed beside the f32 kernel on the same
  values (``lm-bf16-head-case``); the hop and the all-to-all of bf16 in
  loopback bit for bit at the hop's block, EP's dispatch operand and an
  odd element count (``lm-bf16-move-case``); ``train_lm_single`` on bf16
  params at the LM shape under flash and the fused head, ``train_lm_tp``
  (flash, fused head) and ``train_transformer_tp`` (flash) on 4 virtual
  ranks, and ``train_moe_ep`` at the EP headline under ``pallas_a2a``
  and ``psum``, 8 steps each with exact launches (``lm-bf16-train-run``);
  ``lm-bf16-train-check`` (one fused-head step at ``CHECK_LR`` against
  float64 over the bf16 oracle path's error; EP's two transports' routes
  and weights bit for bit). ``--phase dist`` and ``dist-bf16`` hold the
  bf16 hop and all-to-all across the 4 cards against the plain versions
  and NCCL's ``all_to_all_single`` (``dist-lm-bf16-move-case``), run EP
  (``dist-lm-bf16-ep-run``, ``-check``) and LM TP
  (``dist-lm-bf16-tp-run``) on bf16 one rank a card, and ``cli.py -m 11
  --head fused --attn flash``, ``-m 8 --attn flash`` and ``-m 7`` with
  ``--dtype bfloat16`` at their full widths (``dist-cli-m11-bf16``,
  ``dist-cli-m8-bf16``, ``dist-cli-m7-bf16``).

- sequence parallelism (``--phase seq`` too): the flash kernels as the
  causal ring of 4 loopback ranks calls them at the GPT-2-small LM's
  attention over 4096 positions (``[2, 12, 4096, 64]``, 1024 a rank): every
  hop's call, forward and backward, against float64 on its own inputs
  with the causal-flipped control, and the ring's ``y``, ``lse`` and
  gradients against float64 attention over the whole sequence, with the
  control that must fail: the backward handed each hop's own ``lse``
  (``seq-kernel``); the kernels at one hop's shape against their plain
  versions (``lm-kernel-case``, shape ``seq-hop``); Ulysses on the
  all-to-all kernel, bit for bit the plain exchange and the ``psum``
  transport's (``seq-a2a``); ``train_lm_seq`` at that LM with flash
  attention and the fused head, ring and Ulysses, 4 steps each with
  exact launches (``seq-train-run``); one step of each at ``CHECK_LR``
  against float64 over ``train_lm_single``'s error at 4096 positions
  (``seq-train-check``). ``--phase dist-seq`` runs the training on 4 cards
  over NCCL and ``cli.py -m 13 --attn flash --head fused`` at that shape,
  ring and Ulysses (``dist-cli-m13-ring``, ``-ulysses``).

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
import itertools
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
# the paged kernel at a table past the old kernel's shared-memory cap
# (a [G, tcap] score row): (H, H_kv, dh, blocks a table, lengths, tag),
# 8192 positions of block 16, G 8, dh 128
LONG_TABLE = (64, 8, 128, 512, (8192, 1, 4000, 65), "long")
# positions a split timed at the serving case (paged-splits)
PAGED_SPLIT_SWEEP = (32, 64, 128, 256)

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
# the LM kernels' launches by the names of their CUDA kernels in a
# profile: (LM kernel, part, pattern)
LM_PARTS = (
    ("flash_attn_fwd", "fwd", r"flash_fwd_kernel<"),
    ("flash_attn_bwd", "rowsum", r"flash_rowsum_kernel"),
    ("flash_attn_bwd", "dkv", r"flash_dkv_kernel<"),
    ("flash_attn_bwd", "dq", r"flash_dq_kernel<"),
    ("head_xent_stats", "copies", r"gemm_prep_kernel<xent::stats\b"),
    ("head_xent_stats", "main", r"head_xent_stats_kernel"),
    ("head_xent_stats", "merge", r"head_xent_merge_kernel"),
    ("head_xent_bwd", "copies", r"gemm_prep_kernel<void\b"),
    ("head_xent_bwd", "products", r"head_xent_gemm_kernel"))
# the statistics kernel's vocab slices (head-stats-slices) and the flash
# backward's (key tile, query-ring stages) plans (flash-bwd-tiles) timed
# at the main shape
STATS_SLICE_SWEEP = (1, 2, 4, 8)
FLASH_BWD_PLANS = ((128, 2), (128, 1), (64, 2), (64, 1))


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
        paged_decode_attn, paged_decode_attn_ref, split_plan)
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
            cases.append((kv_dtype, hq, hkv, dh, mb, lens, tag))
        cases.append((kv_dtype,) + LONG_TABLE)
    results = []
    for n, (kv_dtype, hq, hkv, hd, nblk, lens, tag) in enumerate(cases):
        case = make_case(torch, np, kv_dtype, len(lens), hq, hkv, hd, blk,
                         nblk, lens, seed=n)
        y = paged_decode_attn(**case)
        again = paged_decode_attn(**case)
        torch.cuda.synchronize()
        want = paged_decode_attn_ref(**case)
        err = float((y - want).abs().max())
        scale = float(want.abs().max())
        same = torch.equal(y, again)
        ok = bool(torch.isfinite(y).all()) and err <= TOL * scale and same
        b_ms, b_by = bound(case, blk)
        plan = split_plan(len(lens), hq, hkv, hd, blk, nblk,
                          case["pool_k"].element_size())
        row = dict(kv_dtype=kv_dtype, shape=tag, heads=hq, kv_heads=hkv,
                   head_dim=hd, tcap=blk * nblk, lengths=list(lens),
                   split_positions=plan[0], splits=plan[1],
                   smem_bytes=plan[3], max_abs_err=err,
                   rel_err=err / scale, deterministic=same, ok=ok,
                   ms=timer.ms(lambda: paged_decode_attn(**case)),
                   plain_ms=timer.ms(lambda: paged_decode_attn_ref(**case)),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms(torch, timer, case, blk))
        results.append(row)
        print("kernel-case " + json.dumps(row), flush=True)
        del case, y, again, want
    return results


def paged_split_sweep(torch, np, timer):
    """The paged kernel at the serving case (f32) under each split size of
    ``PAGED_SPLIT_SWEEP``, each checked against the plain version first:
    ``{"<positions>": ms}``."""
    from distributed_llm_code_samples_tpu_torch.ops import paged_attention
    blk, mb = ENGINE["block_size"], ENGINE["max_blocks_per_seq"]
    lens = tuple(n + 20 for n in PROMPT_LENS)
    case = make_case(torch, np, "f32", len(lens), 12, 12, 64, blk, mb, lens,
                     seed=0)
    want = paged_attention.paged_decode_attn_ref(**case)
    saved = paged_attention.SPLIT_POSITIONS
    out, device = {}, {}
    try:
        for pos in PAGED_SPLIT_SWEEP:
            paged_attention.SPLIT_POSITIONS = pos
            y = paged_attention.paged_decode_attn(**case)
            torch.cuda.synchronize()
            err = float((y - want).abs().max())
            check(err <= TOL * float(want.abs().max()),
                  f"paged split {pos}: error {err}")
            out[str(pos)] = timer.ms(
                lambda: paged_attention.paged_decode_attn(**case))
            device[str(pos)] = profiled_ms(
                torch, timer, lambda: paged_attention.paged_decode_attn(
                    **case), r"paged_split_kernel")
    finally:
        paged_attention.SPLIT_POSITIONS = saved
    # what the timer reads for one elementwise kernel on q: its floor
    floor = timer.ms(lambda: case["q"].neg())
    print("paged-splits " + json.dumps(dict(
        shape="serving", kv_dtype="f32", ms=out, device_ms=device,
        one_kernel_floor_ms=floor)), flush=True)
    return out


def profiled_ms(torch, timer, fn, pattern, reps=20):
    """The device time of ``fn``'s kernels whose names match ``pattern``,
    a call, by the profiler's own trace (launch latency not counted),
    each of ``reps`` calls after an L2 flush."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if re.search(pattern, e.key)) / 1e3 / reps


def ptxas_spills(logs):
    """``{source: {kernel: spill bytes (stores + loads)}}`` from the ptxas
    reports of the build (``_build.build_logs``)."""
    out = {}
    for name, log in logs.items():
        kernel, rows = None, {}
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                kernel = m[1]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and kernel is not None:
                rows[kernel] = int(m[1]) + int(m[2])
        out[name] = rows
    return out


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


def lm_parts(prof):
    """Device ms and launches of each LM kernel's CUDA kernels in a traced
    run (``LM_PARTS``), each kernel's total and its share of the four's
    device time."""
    out = {}
    for e in prof.key_averages():
        if getattr(e.device_type, "name", str(e.device_type)) == "CPU":
            continue
        for kernel, part, pattern in LM_PARTS:
            if re.search(pattern, e.key):
                row = out.setdefault(kernel, {}).setdefault(
                    part, {"ms": 0.0, "calls": 0})
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
    paged = {"ms": 0.0, "calls": 0}
    for e in prof.key_averages():
        if re.search(r"paged_split_kernel", e.key) and getattr(
                e.device_type, "name", str(e.device_type)) != "CPU":
            paged["ms"] += e.device_time_total / 1e3
            paged["calls"] += e.count
    print("profile " + json.dumps(dict(profile_summary(prof, wall_ms),
                                       paged_kernel=paged, card=card)),
          flush=True)
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
    kernels execute these products once each, over whole tiles at the
    causal diagonal (the flash backward's dq from the ds scratch its dkv
    launch writes)."""
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
        if tag == "main":
            print("flash-fwd-tiles " + json.dumps(dict(
                shape=tag, plan=list(fa.FWD_PLAN),
                smem_bytes={plan_key(p): fa.fwd_smem_bytes(p)
                            for p in fa.FWD_PLANS},
                blocks_per_sm={plan_key(p): fa.fwd_blocks_per_sm(p)
                               for p in fa.FWD_PLANS},
                ms=flash_fwd_sweep(torch, timer, fa, q, k, v, causal))),
                flush=True)
            print("flash-bwd-tiles " + json.dumps(dict(
                shape=tag, plan=list(fa.BWD_PLAN),
                ms=flash_bwd_sweep(torch, timer, fa, dy, q, k, v, y, lse,
                                   causal))), flush=True)
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
        if tag == "main":
            print("head-stats-slices " + json.dumps(dict(
                shape=tag, plan=list(fx.stats_plan(tokens, vocab)),
                ms=stats_slice_sweep(torch, timer, fx, h, w, tgt))),
                flush=True)
        del h, w, tgt, lse
    digest = head_bits_digest(torch, np, fx)
    row = dict(kernel="head_xent_bwd", shape="bits", mxu_bf16=None,
               sha256=digest, want=HEAD_BITS_SHA256, max_abs_err=0.0,
               rel_err=0.0, ok=digest == HEAD_BITS_SHA256)
    print("lm-head-bits " + json.dumps(row), flush=True)
    rows.append(row)
    return rows


def stats_slice_sweep(torch, timer, fx, h, w, tgt):
    """``{slices: {ms, rel_err}}`` of the f32 statistics kernel with the
    vocabulary cut into each of ``STATS_SLICE_SWEEP`` slices (its plan
    function ``fx.stats_plan`` replaced for the run; restored after),
    each run first held to ``FFN_TOL`` against the plain version."""
    want = fx.head_xent_stats_ref(h, w, tgt)
    tiles = -(-w.shape[0] // fx.TILE)
    default, out = fx.stats_plan, {}
    try:
        for s in STATS_SLICE_SWEEP:
            length = -(-tiles // s) * fx.TILE
            plan = (-(-w.shape[0] // length), length)
            fx.stats_plan = lambda *_, plan=plan: plan
            run = partial(fx.head_xent_stats, h, w, tgt)
            rel = max(float((g - r).abs().max()) / float(r.abs().max())
                      for g, r in zip(run(), want))
            check(rel <= FFN_TOL[False],
                  f"head_xent_stats at {plan[0]} slices disagrees: {rel}")
            out[plan[0]] = dict(ms=timer.ms(run), rel_err=rel)
    finally:
        fx.stats_plan = default
    return out


def plan_key(plan):
    return "x".join(map(str, plan))


def flash_fwd_sweep(torch, timer, fa, q, k, v, causal):
    """``{"query_tile x key_tile x stages": {ms, rel_err}}`` of the f32
    flash forward under each plan of ``fa.FWD_PLANS`` (``fa.FWD_PLAN``
    replaced for the run; restored after), each run first held to
    ``FFN_TOL`` against the plain version, with a bit-identical
    repeat."""
    want = fa.flash_attention_fwd_ref(q, k, v, causal=causal)
    default, out = fa.FWD_PLAN, {}
    try:
        for plan in fa.FWD_PLANS:
            fa.FWD_PLAN = plan
            run = partial(fa.flash_attention_fwd, q, k, v, causal=causal)
            got, again = run(), run()
            rel = max(float((g - r).abs().max()) / float(r.abs().max())
                      for g, r in zip(got, want))
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            check(rel <= FFN_TOL[False] and same,
                  f"flash_attention_fwd at plan {plan} disagrees: {rel}, "
                  f"repeat bit-identical {same}")
            out[plan_key(plan)] = dict(ms=timer.ms(run), rel_err=rel)
    finally:
        fa.FWD_PLAN = default
    return out


def flash_bwd_sweep(torch, timer, fa, dy, q, k, v, y, lse, causal):
    """``{"key_tile x stages": {ms, rel_err}}`` of the f32 flash backward
    under each plan of ``FLASH_BWD_PLANS`` (``fa.BWD_PLAN`` replaced for
    the run; restored after), each run first held to ``FFN_TOL`` against
    the plain version."""
    want = fa.flash_attention_bwd_ref(dy, q, k, v, y, lse, causal=causal)
    default, out = fa.BWD_PLAN, {}
    try:
        for plan in FLASH_BWD_PLANS:
            fa.BWD_PLAN = plan
            run = partial(fa.flash_attention_bwd, dy, q, k, v, y, lse,
                          causal=causal)
            rel = max(float((g - r).abs().max()) / float(r.abs().max())
                      for g, r in zip(run(), want))
            check(rel <= FFN_TOL[False],
                  f"flash_attention_bwd at plan {plan} disagrees: {rel}")
            out[plan_key(plan)] = dict(ms=timer.ms(run), rel_err=rel)
    finally:
        fa.BWD_PLAN = default
    return out


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
    parts = lm_parts(prof)
    # the fused head's launches, its operand copies included
    head_ms = sum(parts.get(k, {}).get("ms", 0.0)
                  for k in ("head_xent_stats", "head_xent_bwd"))
    busy = summary["device_busy_ms"]
    summary.update(head_kernel_ms=head_ms,
                   head_kernel_share=head_ms / busy if busy else None,
                   lm_kernels=parts, card=card)
    print("lm-train-profile " + json.dumps(summary), flush=True)
    return launches


def lm_kernel_rows(cases, launches, tp_launches=None, dp_launches=None,
                   seq_launches=None):
    """The LM kernels' rows of the kernels line: ``launches`` from the
    single-device LM run, ``tp_launches`` (a rank's) from the first LM TP
    run (``lmtp_phase``), ``dp_launches`` (a rank's, by run) from the
    f32 data-parallel runs (``lmdp_phase``) and ``seq_launches`` (all
    ranks', by run) from the sequence-parallel runs (``seq_phase``),
    where they ran; ``seq_hop_ms`` the flash kernels at one ring hop."""
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
            "lmtp_launches_per_rank": None if tp_launches is None
            else sum(tp_launches.get(c, 0) for c in counted),
            "lmdp_launches_per_rank": dp_rows(dp_launches, counted),
            "seq_launches": dp_rows(seq_launches, counted),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["rel_err"] for c in mine),
            "ms": main["ms"], "ms_bf16": main_bf16["ms"],
            "seq_hop_ms": next((c["ms"] for c in mine
                                if c["shape"] == "seq-hop"), None),
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
# ranges a chunk of the reduce-scatter and of the all-reduce (ops/ring.py
# RS_RANGES, AR_RANGES, 32; the all-reduce takes at most 32 at n 4),
# timed across the cards at the main case (dw1)
RS_RANGE_SWEEP = (8, 16, 32, 64)
AR_RANGE_SWEEP = (8, 16, 32)
# ranges of the hop's block (ops/ring.py HOP_RANGES, 64), timed across
# the cards at the main case
HOP_RANGE_SWEEP = (8, 16, 32, 64)
# ``--phase dist``'s sequence on one workspace (``dist-ring-sequence``):
# the hop after a gather and before each other kind of call, and the
# ranks held back in turn before each call
SEQ_OPS = ("ring_all_gather", "ppermute_dma", "ring_reduce_scatter",
           "ppermute_dma", "ring_all_reduce", "ppermute_dma",
           "all_to_all_dma", "ring_all_gather")
SEQ_LATE_RANKS = (2, 1)
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
    """One rank's reduce-scatter, all-reduce or hop trace
    (``ops.ring.traced``) in microseconds from its first block's entry:
    when its pushing blocks started and finished, and when its receiving
    blocks (every block of the reduce-scatter and the all-reduce sums;
    the hop's copy-out blocks) saw their range land from every source and
    had summed or copied out their part (the all-reduce's sums: stored on
    to every peer and flagged) and, for the all-reduce, copied out their
    part of every peer's sum (min, median, max)."""
    s = stamps.double()
    t0 = s[:, 0].min()
    push, summed = s[s[:, 1] > 0], s[s[:, 3] > 0]

    def spread(v):
        v = (v - t0) / 1e3
        return [float(v.min()), float(v.median()), float(v.max())]

    out = dict(pushing_blocks=len(push), summing_blocks=len(summed),
               push_start_us=spread(push[:, 1]),
               pushed_us=spread(push[:, 2]),
               arrived_us=spread(summed[:, 3]),
               released_us=spread(summed[:, 4]))
    if bool((s[:, 5] > 0).all()):
        out["copied_us"] = spread(s[:, 5])
    return out


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


def a2a_kernel_row(cases, launches, mode="loopback", seq_launches=None):
    """The all-to-all's entry of the kernels line: launches from the main
    path's runs (the three dispatches; ``seq_launches`` from Ulysses on
    the kernel, ``seq_a2a_phase``), the rest from the main case."""
    main = next(c for c in cases if c["shape"] == A2A_MAIN)
    return {
        "name": "all_to_all_dma", "route": "cuda",
        "source": "distributed_llm_code_samples_tpu_torch/csrc/"
                  "ring_collectives.cu",
        "replaces": f"distributed_llm_code_samples_tpu/{A2A_REPLACES}",
        "launches": None if launches is None
        else sum(run.get("all_to_all_dma", 0) for run in launches.values()),
        "seq_launches": seq_launches,
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
    library yardstick); the hop's is an ``all_to_all_single`` whose one
    split that is not empty is the block, to the rank after and from the
    rank before."""
    n = dist.get_world_size()
    if op == "ppermute_dma":
        r, rows = dist.get_rank(), x.shape[0]
        send, recv = [0] * n, [0] * n
        send[(r + 1) % n], recv[(r - 1) % n] = rows, rows
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, recv, send)
        return y
    if op == "ring_all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        return y
    if op == "ring_reduce_scatter":
        y = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(y, x)
        return y
    if op == "ring_all_gather":
        y = torch.empty((x.shape[0] * n,) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(y, x)
        return y
    raise ValueError(op)


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
                   nccl_err_vs_f64=ring_err(torch, [nccl], [f64[0]]),
                   ms=aligned(kern),
                   ms_with_host=timer.ms(kern, with_host=True),
                   plain_ms=aligned(plain),
                   library_ms=aligned(partial(_nccl_call, torch, dist, op,
                                              x)))
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
            row["nccl_err_vs_f64"] <= RING_TOL)
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
    del want, stamps
    # the all-reduce of dw1 at other ranges a chunk, each run bit-identical
    # to the plain ring, and one call's own stamps: entry, pushes stored,
    # sums stored on and flagged, gathers copied out
    want = ring.ring_all_reduce_ref(x, rg)
    sweep = range_sweep(
        torch, aligned, ring, mesh.check,
        lambda: [torch.equal(ring.ring_all_reduce(x, rg), want)],
        partial(ring.ring_all_reduce, x, rg),
        {p: dict(AR_RANGES=p) for p in AR_RANGE_SWEEP})
    every = gathered(sweep)
    say("dist-ar-ranges", dict(shape="dw1", mode="4 cards", ms=sweep,
                               ms_max_over_ranks={
                                   p: max(e[p] for e in every)
                                   for p in sweep}))

    def ar_together():
        torch.cuda._sleep(HOST_COVER_CYCLES)
        dist.all_reduce(token)
        ring.ring_all_reduce(x, rg)

    for _ in range(3):          # warm, as the timer's calls are
        ar_together()
    stamps = ring.traced(ar_together, dev)
    mesh.check()
    say("dist-ar-trace", dict(shape="dw1", mode="4 cards",
                              phases=ring.A2A_PHASES,
                              ranks=gathered(rs_trace_summary(
                                  stamps.cpu()))))
    del x, want, stamps
    # one all-gather of the w1 shard on the all-to-all's push design, its
    # blocks' own stamps (own chunk, pushes, copy-outs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(570 + r)
    x = torch.randn((FFN_DIM // n, D_MODEL), generator=gen, device=dev)

    def ag_together():
        torch.cuda._sleep(HOST_COVER_CYCLES)
        dist.all_reduce(token)
        ring.ring_all_gather(x, rg)

    for _ in range(3):          # warm, as the timer's calls are
        ag_together()
    stamps = ring.traced(ag_together, dev)
    mesh.check()
    say("dist-ag-trace", dict(
        shape="w1_shard", mode="4 cards", phases=ring.A2A_PHASES,
        ranks=[t[0] for t in gathered(a2a_trace_summary(stamps.cpu(), n,
                                                        1))]))
    del x, stamps
    # the hop of the [768, 3072] block at other ranges, each run (ten
    # calls) bit-identical to the plain hop, and one call's own stamps:
    # pushes stored and flagged, ranges arrived, copied out and released
    gen = torch.Generator(device=dev)
    gen.manual_seed(580 + r)
    x = torch.randn((D_MODEL, FFN_DIM), generator=gen, device=dev)
    want = ring.ppermute_dma_ref(x, rg)

    def hop_agree():
        return [torch.equal(ring.ppermute_dma(x, rg), want)
                for _ in range(10)]

    sweep = range_sweep(
        torch, aligned, ring, mesh.check, hop_agree,
        partial(ring.ppermute_dma, x, rg),
        {p: dict(HOP_RANGES=p) for p in HOP_RANGE_SWEEP})
    every = gathered(sweep)
    say("dist-hop-ranges", dict(shape="block", mode="4 cards", ms=sweep,
                                ms_max_over_ranks={
                                    p: max(e[p] for e in every)
                                    for p in sweep}))

    def hop_together():
        torch.cuda._sleep(HOST_COVER_CYCLES)
        dist.all_reduce(token)
        ring.ppermute_dma(x, rg)

    for _ in range(3):          # warm, as the timer's calls are
        hop_together()
    stamps = ring.traced(hop_together, dev)
    mesh.check()
    say("dist-hop-trace", dict(shape="block", mode="4 cards",
                               phases=ring.A2A_PHASES,
                               ranks=gathered(rs_trace_summary(
                                   stamps.cpu()))))
    del x, want, stamps
    # one workspace through the main path's calls in an order that puts
    # a hop after a gather and before a reduce-scatter, an all-reduce and
    # an all-to-all, enqueued with no host sync between them, the card
    # of one rank held back by a spin before one call after another: the
    # other ranks run ahead, and none may store over a slot that the late
    # rank has yet to read. Every output bit-identical to its plain
    # version.
    seq = tuple(zip(SEQ_OPS, ((FFN_DIM // n, D_MODEL), (D_MODEL, FFN_DIM),
                              (FFN_DIM, D_MODEL), (D_MODEL, FFN_DIM),
                              (FFN_DIM, D_MODEL), (D_MODEL, FFN_DIM),
                              (FFN_DIM, D_MODEL), (D_MODEL // n, FFN_DIM))))
    gen = torch.Generator(device=dev)
    gen.manual_seed(590 + r)
    xs = [torch.randn(shape, generator=gen, device=dev) for _, shape in seq]
    wants = [getattr(ring, op + "_ref")(x, rg) for (op, _), x in zip(seq, xs)]
    bad = []
    for late, held in itertools.product(SEQ_LATE_RANKS, range(len(seq))):
        dist.all_reduce(token)
        outs = []
        for i, ((op, _), x) in enumerate(zip(seq, xs)):
            if r == late and i == held:
                torch.cuda._sleep(HOST_COVER_CYCLES)
            outs.append(getattr(ring, op)(x, rg))
        torch.cuda.synchronize()
        mesh.check()
        bad += [[late, held, i] for i, (got, want) in
                enumerate(zip(outs, wants)) if not torch.equal(got, want)]
    every = gathered(bad)
    say("dist-ring-sequence", dict(
        ops=list(SEQ_OPS), mode="4 cards", late_ranks=list(SEQ_LATE_RANKS),
        spin_cycles=HOST_COVER_CYCLES,
        rounds=len(SEQ_LATE_RANKS) * len(seq),
        mismatches=every, ok=not any(every)))
    check(not any(every), "a ring kernel behind a late rank disagrees with "
          f"its plain version: [late rank, held call, call] {every}")
    del xs, wants, outs
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


# -- tensor parallelism of the FFN stack ---------------------------------------

# TP and TP-SP on TP_N ranks and the hybrid on a HYBRID mesh, at TRAIN's
# width; the default run holds the ranks on one card in loopback, whose
# collectives are plain torch within each axis group (TP has no kernel
# transport, as in JAX), ``--phase dist`` one rank a card over NCCL
TP_N = RING_N
HYBRID = {"data": 2, "model": 2}
TP_RUNS = (("tp", "train_tp"), ("tp-sp", "train_tp_sp"),
           ("hybrid", "train_hybrid"))


def tp_rank(mesh, payload):
    """One rank of a ``tp`` run (module level: ``--phase dist`` spawns
    it): ``trainer`` over ``seeds`` with rank 0's steps stamped; returns
    the rank's final shards on the CPU, the stamps and, in a process of
    its own, the rank's launch counts and peak memory."""
    import torch

    from distributed_llm_code_samples_tpu_torch import parallel
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    trainer, params, seeds, lr = payload
    stamps = []

    def on_step(_):
        if mesh.rank == 0:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    if not mesh.loopback:
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = getattr(parallel, trainer)(params, seeds, TRAIN["tokens"],
                                     TRAIN["d_model"], mesh, lr=lr,
                                     on_step=on_step)
    torch.cuda.synchronize()
    return dict(shards=tuple(t.cpu() for t in out), t0=t0, stamps=stamps,
                launches=None if mesh.loopback else launch_counts(),
                max_memory_allocated_gb=None if mesh.loopback else
                torch.cuda.max_memory_allocated() / 2 ** 30)


def tp_phase(torch, card, cards: int = 0):
    """TP, TP-SP and the hybrid at ``TRAIN``'s width: 8 timed steps a rank
    at the package LR (``tp-train-run``), then one step at ``CHECK_LR``
    held against float64 (``tp-train-check``). ``cards`` 0: the ranks in
    loopback on one card; else one rank a card over NCCL. The f32 peak
    share is over every card the run holds; the memory is the card's in
    loopback, rank 0's card's over NCCL."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        FFNStackParams, init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        ffn_block, launch_counts, reset_launch_counts, stack_grads)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, MODEL_AXIS, launch, make_mesh, train_ddp, train_single)
    from distributed_llm_code_samples_tpu_torch.parallel import hybrid, tp
    t_phase = time.perf_counter()
    d, n_layers, tokens = TRAIN["d_model"], TRAIN["n_layers"], TRAIN["tokens"]
    mode = f"{cards} cards" if cards else "loopback"
    where = dict(device="cuda") if cards else dict(loopback=True)
    meshes = {"tp": make_mesh({MODEL_AXIS: TP_N}, **where),
              "hybrid": make_mesh(HYBRID, **where)}
    meshes["tp-sp"] = meshes["tp"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TRAIN["random_seed"])
    params = init_ffn_stack(gen, d, n_layers)
    host = FFNStackParams(*(t.cpu() for t in params)) if cards else params
    dp = HYBRID["data"]
    seeds = make_seed_schedule(dp * TRAIN["steps"], TRAIN["random_seed"])

    def run(label, trainer, seeds, lr):
        mesh = meshes[label]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        outs = launch(tp_rank, mesh, (trainer, host, seeds, lr),
                      timeout=300)
        full = (hybrid.unshard_params([FFNStackParams(*o["shards"])
                                       for o in outs], mesh)
                if label == "hybrid" else
                tp.unshard_params([FFNStackParams(*o["shards"])
                                   for o in outs]))
        full = FFNStackParams(*(t.to(params.w1.device) for t in full))
        launches = outs[0]["launches"] if cards else launch_counts()
        mem = (outs[0]["max_memory_allocated_gb"] if cards else
               torch.cuda.max_memory_allocated() / 2 ** 30)
        return full, outs[0], launches, mem

    finite = True
    for label, trainer in TP_RUNS:
        batches = dp if label == "hybrid" else 1
        run_seeds = seeds if label == "hybrid" else seeds[:TRAIN["steps"]]
        full, r0, got, mem = run(label, trainer, run_seeds, LR)
        finite &= all(bool(torch.isfinite(t).all()) for t in full)
        steps = [b - a for a, b in zip([r0["t0"]] + r0["stamps"],
                                       r0["stamps"])]
        med = statistics.median(steps[1:])
        flops = 12 * tokens * d * FFN_DIM * n_layers * batches
        ring_kernels = sorted(k for k in got if k in RING_NAMES)
        print("tp-train-run " + json.dumps(dict(
            run=f"{label}-{'nccl' if cards else 'loopback'}", mode=mode,
            mesh=dict(meshes[label].shape), steps_per_rank=len(steps),
            tokens_per_step=tokens * batches, median_step_ms=1e3 * med,
            first_step_ms=1e3 * steps[0],
            tokens_per_s=tokens * batches / med,
            model_tflops_per_s=flops / med / 1e12,
            f32_peak_share=flops / med / (F32_FLOPS_PER_S * (cards or 1)),
            max_memory_allocated_gb=mem, kernel_launches=got,
            ring_kernels=ring_kernels, card=card)), flush=True)
        check(not ring_kernels, f"{label} launched the ring kernels "
              f"{ring_kernels}: TP has no kernel transport")
        del full
    check(finite, "TP-trained params are not finite")

    # one step at CHECK_LR from the same params, each update against a
    # float64 step (UPDATE_RATIO): TP and TP-SP against train_single's,
    # the hybrid against DDP's on HYBRID["data"] ranks
    def batch64(seed, batch, dim, dtype, device):
        return tuple(v.double() for v in
                     batch_from_seed(seed, batch, dim, device=device))

    p64 = FFNStackParams(*(t.double() for t in params))
    w64 = train_single(p64, seeds[:1], tokens, d, lr=CHECK_LR,
                       batch_fn=batch64)
    single = train_single(params, seeds[:1], tokens, d, lr=CHECK_LR)
    g64 = None
    for seed in seeds[:dp]:
        x, dl = batch_from_seed(seed, tokens, d, device=params.w1.device)
        g = stack_grads(p64.w1, p64.w2, x.double(), dl.double(),
                        block=ffn_block)[1]
        g64 = g if g64 is None else tuple(a + b for a, b in zip(g64, g))
    ddp64 = FFNStackParams(*(p - CHECK_LR * g for p, g in zip(p64, g64)))
    del g64
    ddp_mesh = (make_mesh({DATA_AXIS: dp}, device="cuda") if cards else
                make_mesh({DATA_AXIS: dp}, loopback=True))
    ddp = train_ddp(params, seeds[:dp], tokens, d, ddp_mesh, lr=CHECK_LR,
                    comm="psum" if cards else "pallas_ring")

    def errs(got, want):
        return [update_err(torch, g, w, p0)
                for g, w, p0 in zip(got, want, params)]

    row = dict(mode=mode, check_lr=CHECK_LR, update_ratio_limit=UPDATE_RATIO)
    base = {"tp": errs(single, w64), "hybrid": errs(ddp, ddp64)}
    base["tp-sp"] = base["tp"]
    row["single_update_err_vs_f64"] = base["tp"]
    row["ddp_update_err_vs_f64"] = base["hybrid"]
    ratios = {}
    for label, trainer in TP_RUNS:
        n_seeds = dp if label == "hybrid" else 1
        got = run(label, trainer, seeds[:n_seeds], CHECK_LR)[0]
        want = ddp64 if label == "hybrid" else w64
        e = errs(got, want)
        ratios[label] = max(a / b for a, b in zip(e, base[label]))
        row[f"{label}_update_err_vs_f64"] = e
        row[f"{label}_update_err_ratio_max"] = ratios[label]
        if label == "hybrid":
            row["hybrid_vs_ddp_update_err"] = errs(got, ddp)
        del got
    # the control: weights left unchanged have error exactly 1
    unchanged = min(1.0 / b for b in base["tp"] + base["hybrid"])
    row.update(unchanged_ratio_min=unchanged,
               phase_s=time.perf_counter() - t_phase, card=card)
    print("tp-train-check " + json.dumps(row), flush=True)
    for label, ratio in ratios.items():
        check(ratio <= UPDATE_RATIO, f"{label}'s update {ratio:.2f}x as far "
              f"from float64 as the f32 reference's")
    check(unchanged > UPDATE_RATIO,
          "the update check cannot tell unchanged weights from trained")


# -- Megatron TP of the LM and of the transformer (lmtp) ---------------------
#
# At LM's shape on LMTP_N ranks: the LM under three attention x head
# policies and the transformer trunk plain and sequence-parallel, all
# with flash attention on the rank's 3 of 12 heads; the fused head on the
# rank's 12576 of 50304 vocab rows. (label, family, attn_impl, head_impl,
# sequence_parallel)
LMTP_N = RING_N
LMTP_RUNS = (("lm-flash-fused", "lm", "flash", "fused", False),
             ("lm-flash-oracle", "lm", "flash", None, False),
             ("lm-rope-oracle", "lm", "rope", None, False),
             ("tf-flash", "tf", "flash", None, False),
             ("tf-sp-flash", "tf", "flash", None, True))
# the LM kernels' launch counters on the TP path
LMTP_COUNTERS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                 "head_xent_stats", "head_xent_bwd")
# the head kernels on one rank's vocab shard (lmtp-head-case): V/n
# 12576 at the LM's vocab, and 12573 (V 50292), whose 4-rounded w^T has
# three pad columns a shifted target can name
LMTP_HEAD_SHARDS = (("lm", LM["vocab"]), ("pad", 4 * 12573))


def lmtp_rank(mesh, payload):
    """One rank of an ``lmtp`` run (module level: ``--phase dist`` spawns
    it): ``train_lm_tp`` or ``train_transformer_tp`` at ``LM``'s shape
    with rank 0's steps stamped; returns the rank's final shards on the
    CPU, the stamps and, in a process of its own, its launch counts and
    peak memory."""
    import torch

    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.optim import leaves
    from distributed_llm_code_samples_tpu_torch.parallel import (
        train_lm_tp, train_transformer_tp)
    family, params, seeds, lr, kw = payload
    stamps = []

    def on_step(_):
        if mesh.rank == 0:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    if not mesh.loopback:
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
    train = train_lm_tp if family == "lm" else train_transformer_tp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train(params, seeds, LM_TOKENS, LM["d_model"], mesh, lr=lr,
                seq_len=LM["seq_len"], n_heads=LM["n_heads"],
                on_step=on_step, **kw)
    torch.cuda.synchronize()
    return dict(shards=[t.cpu() for t in leaves(out)], t0=t0, stamps=stamps,
                launches=None if mesh.loopback else launch_counts(),
                max_memory_allocated_gb=None if mesh.loopback else
                torch.cuda.max_memory_allocated() / 2 ** 30)


def lmtp_head_cases(torch, np, card):
    """The head kernels on each rank's vocab shard at the TP path's shape
    (N 8192, d 768, 4 ranks), against float64 (``BLOCK_TOL`` by
    ``row_err``): the statistics with the targets shifted by ``r V/n``
    (most below 0 or at and past V/n), at V/n 12576 and at 12573 with a
    third of the rows' shifted targets in the pad columns ``[V/n, V/n +
    3)``; the backward given the merged global lse; and the merged lse,
    the summed tz and dh and the joined dw against the whole vocabulary's.
    Controls that must fail: the statistics against targets wrapped into
    the shard (``t mod V/n``), the pad case's against its pad targets
    clamped to the last real column, the backward given the rank's own
    lse."""
    from distributed_llm_code_samples_tpu_torch.ops import fused_xent as fx
    n, d = LM_TOKENS, LM["d_model"]

    def err(got, want):
        return max(row_err(torch, g.reshape(-1, g.shape[-1]) if g.dim() > 1
                           else g.reshape(1, -1),
                           w.reshape(-1, w.shape[-1]) if w.dim() > 1
                           else w.reshape(1, -1))
                   for g, w in zip(got, want))

    rows = []
    for tag, v in LMTP_HEAD_SHARDS:
        vl = v // LMTP_N
        rng = np.random.default_rng(v)
        h = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda()
        w = torch.from_numpy((0.02 * rng.normal(size=(v, d))).astype(
            np.float32)).cuda()
        t = rng.integers(0, v, size=n)
        if tag == "pad":
            # a third of the rows target (k + 1) V/n + j, j < 3: rank k
            # sees the pad column V/n + j
            j = np.arange(n // 3)
            t[:n // 3] = ((j // 3) % (LMTP_N - 1) + 1) * vl + j % 3
        t = torch.from_numpy(t).cuda()
        h64, w64 = h.double(), w.double()
        dy = torch.tensor(1.0, device="cuda")
        stats, want_stats = [], []
        for r in range(LMTP_N):
            wr, tr = w[r * vl:(r + 1) * vl], t - r * vl
            stats.append(fx.head_xent_stats(h, wr, tr))
            want_stats.append(fx.head_xent_stats_ref(h64, wr.double(), tr))
        lse_l = torch.stack([s_[0] for s_ in stats])
        m = lse_l.amax(0)
        lse_g = m + torch.log(torch.exp(lse_l - m).sum(0))
        lse64, tz64 = fx.head_xent_stats_ref(h64, w64, t)
        merged = err((lse_g, sum(s_[1] for s_ in stats)), (lse64, tz64))
        dh_sum, dws, bwd_err, own_err, stats_err, ctl_err = 0, [], 0, [], 0, []
        for r in range(LMTP_N):
            wr, tr = w[r * vl:(r + 1) * vl], t - r * vl
            stats_err = max(stats_err, err(stats[r], want_stats[r]))
            wrong = (tr.clamp(max=vl - 1) if tag == "pad"
                     else torch.remainder(tr, vl))
            if not torch.equal(wrong, tr):
                ctl_err.append(err(stats[r], fx.head_xent_stats_ref(
                    h64, wr.double(), wrong)))
            dh, dw = fx.head_xent_bwd(dy, h, wr, tr, lse_g)
            want = fx.head_xent_bwd_ref(dy.double(), h64, wr.double(), tr,
                                        lse64)
            bwd_err = max(bwd_err, err((dh, dw), want))
            own_err.append(err(fx.head_xent_bwd(dy, h, wr, tr,
                                                stats[r][0]), want))
            dh_sum = dh_sum + dh
            dws.append(dw)
            del want
        full = fx.head_xent_bwd_ref(dy.double(), h64, w64, t, lse64)
        whole = err((dh_sum, torch.cat(dws)), full)
        shifted = t[:, None] - torch.arange(LMTP_N, device="cuda") * vl
        row = dict(case=tag, n=n, d=d, vocab=v, v_local=vl,
                   targets_out_of_shard=float(((shifted < 0) | (shifted >= vl))
                                              .float().mean()),
                   targets_in_pad=int(((shifted >= vl) & (shifted < vl + 3))
                                      .sum()) if tag == "pad" else 0,
                   stats_err=stats_err, merged_err=merged, bwd_err=bwd_err,
                   whole_vocab_err=whole, control_target_err_min=min(ctl_err),
                   control_own_lse_err_min=min(own_err), tol=BLOCK_TOL,
                   card=card)
        print("lmtp-head-case " + json.dumps(row), flush=True)
        rows.append(row)
        del full, dws, dh_sum, h64, w64
    for row in rows:
        check(max(row["stats_err"], row["merged_err"], row["bwd_err"],
                  row["whole_vocab_err"]) <= BLOCK_TOL,
              f"the head kernels on a vocab shard ({row['case']}) disagree "
              "with float64")
        check(min(row["control_target_err_min"],
                  row["control_own_lse_err_min"]) > BLOCK_TOL,
              f"a control of the vocab-shard check ({row['case']}) passes")
    check(rows[1]["targets_in_pad"] > 0, "no target fell in a pad column")


def lmtp_phase(torch, np, card, cards: int = 0):
    """Megatron TP of the LM and of the transformer at ``LM``'s shape on
    ``LMTP_N`` ranks (``LMTP_RUNS``, 8 steps at the package LR each,
    ``lmtp-train-run``), one step at ``CHECK_LR`` of each against
    float64 over the single-device trainer's error (``lmtp-train-check``)
    and, on one card, a traced run (``lmtp-train-profile``) and the head
    kernels on a vocab shard (``lmtp-head-case``). ``cards`` 0: the ranks in loopback on one card;
    else one rank a card over NCCL. Returns the TP path's launches of the
    LM kernels a rank, from the first run."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models import (
        TransformerParams, init_lm, lm_from_leaves)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.optim import leaves
    from distributed_llm_code_samples_tpu_torch.parallel import (
        MODEL_AXIS, launch, make_mesh, train_lm_single,
        train_transformer_single)
    from distributed_llm_code_samples_tpu_torch.parallel import lm as lm_mod
    from distributed_llm_code_samples_tpu_torch.parallel import transformer
    t_phase = time.perf_counter()
    mode = f"{cards} cards" if cards else "loopback"
    mesh = make_mesh({MODEL_AXIS: LMTP_N},
                     **(dict(device="cuda") if cards else
                        dict(loopback=True)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM["random_seed"])
    params = init_lm(gen, LM["vocab"], LM["d_model"], LM["n_layers"],
                     LM["seq_len"], n_heads=LM["n_heads"])
    start = {"lm": params, "tf": params.blocks}
    host = ({k: v.with_leaves([t.cpu() for t in leaves(v)])
             for k, v in start.items()} if cards else start)
    seeds = make_seed_schedule(LM["steps"], LM["random_seed"])
    layers, steps_n = LM["n_layers"], LM["steps"]

    def run(label, family, attn, head, sp, seeds, lr):
        kw = dict(attn_impl=attn)
        if family == "lm":
            kw["head_impl"] = head
        else:
            kw["sequence_parallel"] = sp
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        outs = launch(lmtp_rank, mesh, (family, host[family], seeds, lr, kw),
                      timeout=600)
        if cards:
            per_rank = outs[0]["launches"]
            mem = outs[0]["max_memory_allocated_gb"]
        else:
            per_rank = {k: c / LMTP_N for k, c in launch_counts().items()}
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
        if family == "lm":
            full = lm_mod.lm_tp_unshard([lm_from_leaves(o["shards"])
                                         for o in outs])
        else:
            full = transformer.tp_unshard([TransformerParams(*o["shards"])
                                           for o in outs])
        full = full.with_leaves([t.cuda() for t in leaves(full)])
        return full, outs[0], per_rank, mem

    first = None
    for label, family, attn, head, sp in LMTP_RUNS:
        full, r0, per_rank, mem = run(label, family, attn, head, sp, seeds,
                                      LR)
        check(all(bool(torch.isfinite(t).all()) for t in leaves(full)),
              f"lmtp {label}: trained params are not finite")
        del full
        steps = [b - a for a, b in zip([r0["t0"]] + r0["stamps"],
                                       r0["stamps"])]
        med = statistics.median(steps[1:])
        flops = LM_BLOCK_FLOPS + (LM_HEAD_FLOPS if family == "lm" else 0)
        flash = layers * steps_n if attn == "flash" else 0
        want = {"flash_attn_fwd": flash, "flash_attn_dq": flash,
                "flash_attn_dkv": flash,
                "head_xent_stats": steps_n if head else 0,
                "head_xent_bwd": steps_n if head else 0}
        print("lmtp-train-run " + json.dumps(dict(
            run=f"{label}-{'nccl' if cards else 'loopback'}", mode=mode,
            family=family, attn_impl=attn, head_impl=head or "oracle",
            sequence_parallel=sp, mesh={MODEL_AXIS: LMTP_N},
            heads_per_rank=LM["n_heads"] // LMTP_N,
            vocab_rows_per_rank=LM["vocab"] // LMTP_N,
            steps_per_rank=len(steps), tokens_per_step=LM_TOKENS,
            median_step_ms=1e3 * med, first_step_ms=1e3 * steps[0],
            tokens_per_s=LM_TOKENS / med,
            model_tflops_per_s=flops / med / 1e12,
            f32_peak_share=flops / med / (F32_FLOPS_PER_S * (cards or 1)),
            max_memory_allocated_gb=mem, launches_per_rank=per_rank,
            card=card)), flush=True)
        for name, n in want.items():
            check(per_rank.get(name, 0) == n, f"lmtp {label}: "
                  f"{per_rank.get(name, 0)} launches of {name} a rank, "
                  f"expected {n}")
        check(set(per_rank) <= set(want),
              f"lmtp {label}: launches {per_rank}")
        if first is None:
            first = {k: per_rank.get(k, 0) for k in LMTP_COUNTERS}
    if not cards:
        # where the device time goes in 3 steps of the first run (a traced
        # launch: its wall time holds the ranks' start, the sharding and
        # the shards' trip back as well as the steps)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(*LMTP_RUNS[0], seeds[:3], LR)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        summary = profile_summary(prof, wall_ms)
        summary.update(run=LMTP_RUNS[0][0], steps=3,
                       lm_kernels=lm_parts(prof), card=card)
        print("lmtp-train-profile " + json.dumps(summary), flush=True)
        del prof

    # one step at CHECK_LR from the same params, each update against a
    # float64 step (the oracle ops) over the error of the single-device
    # f32 trainer under the same policy (UPDATE_RATIO), leaf by leaf
    def batch64(seed, batch, dim, dtype, device):
        return tuple(v.double() for v in
                     batch_from_seed(seed, batch, dim, device=device))

    one = seeds[:1]
    lm_kw = dict(lr=CHECK_LR, seq_len=LM["seq_len"], n_heads=LM["n_heads"])
    want64 = {}

    def reference(family, attn):
        """The float64 step of ``family``: the oracle ops, rotary
        positions under ``rope`` (flash and the fused head compute the
        oracle's function; their kernels take no float64)."""
        attn = "rope" if attn == "rope" else None
        if (family, attn) not in want64:
            want64.clear()
            p64 = start[family].with_leaves([t.double() for t in
                                             leaves(start[family])])
            if family == "lm":
                want64[family, attn] = train_lm_single(
                    p64, one, LM_TOKENS, LM["d_model"], attn_impl=attn,
                    **lm_kw)
            else:
                want64[family, attn] = train_transformer_single(
                    p64, one, LM_TOKENS, LM["d_model"], attn_impl=attn,
                    batch_fn=batch64, **lm_kw)
        return want64[family, attn]

    def errs(got, family, attn):
        return [update_err(torch, g, w, p0) for g, w, p0 in zip(
            leaves(got), leaves(reference(family, attn)),
            leaves(start[family]))]

    row = dict(mode=mode, check_lr=CHECK_LR, update_ratio_limit=UPDATE_RATIO)
    ratios, unchanged = {}, []
    for label, family, attn, head, sp in LMTP_RUNS:
        if family == "lm":
            single = train_lm_single(params, one, LM_TOKENS, LM["d_model"],
                                     attn_impl=attn, head_impl=head, **lm_kw)
        else:
            single = train_transformer_single(params.blocks, one, LM_TOKENS,
                                              LM["d_model"], attn_impl=attn,
                                              **lm_kw)
        base = errs(single, family, attn)
        del single
        got = run(label, family, attn, head, sp, one, CHECK_LR)[0]
        e = errs(got, family, attn)
        del got
        ratios[label] = max(a / b for a, b in zip(e, base))
        unchanged.append(min(1.0 / b for b in base))
        row[f"{label}_single_update_err_vs_f64"] = base
        row[f"{label}_update_err_vs_f64"] = e
        row[f"{label}_update_err_ratio_max"] = ratios[label]
    row.update(unchanged_ratio_min=min(unchanged), card=card)
    del want64
    print("lmtp-train-check " + json.dumps(row), flush=True)
    for label, ratio in ratios.items():
        check(ratio <= UPDATE_RATIO, f"lmtp {label}'s update {ratio:.2f}x "
              "as far from float64 as the single-device f32 trainer's")
    check(min(unchanged) > UPDATE_RATIO,
          "the update check cannot tell unchanged weights from trained")
    if not cards:
        lmtp_head_cases(torch, np, card)
    print("lmtp-phase " + json.dumps(dict(
        mode=mode, phase_s=time.perf_counter() - t_phase, card=card)),
        flush=True)
    return first


# -- data parallelism of the LM and of the transformer (lmdp) ---------------
#
# At LM's shape, LM_TOKENS a rank a step: DDP and FSDP on LMDP_N ranks,
# the DDP x TP hybrid on 2 x 2. (label, family, strategy, attn_impl,
# head_impl, mixed clipped AdamW)
LMDP_N = RING_N
LMDP_HYBRID = {"data": 2, "model": 2}
LMDP_STEPS = 4
LMDP_RUNS = (("lm-ddp", "lm", "ddp", "flash", "fused", False),
             ("lm-fsdp", "lm", "fsdp", "flash", "fused", False),
             ("lm-hybrid", "lm", "hybrid", "flash", None, False),
             ("tf-ddp", "tf", "ddp", "flash", None, False),
             ("tf-fsdp", "tf", "fsdp", "flash", None, False),
             ("tf-hybrid", "tf", "hybrid", "flash", None, False),
             ("lm-ddp-mixed-adamw", "lm", "ddp", "flash", "fused", True),
             ("lm-fsdp-mixed-adamw", "lm", "fsdp", "flash", "fused", True))
LMDP_LABELS = tuple(r[0] for r in LMDP_RUNS)


def lmdp_mesh(kind, cards):
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, make_mesh)
    axes = LMDP_HYBRID if kind == "hybrid" else {DATA_AXIS: LMDP_N}
    return make_mesh(axes, **(dict(device="cuda") if cards else
                              dict(loopback=True)))


def lmdp_optimizer(kind, mixed):
    """The mixed runs' clipped AdamW; FSDP's clip sums its norm over the
    data axis (its gradients are shards)."""
    from distributed_llm_code_samples_tpu_torch import optim
    if not mixed:
        return None
    return optim.clipped(optim.adamw(), 1.0,
                         axis="data" if kind == "fsdp" else None)


def lmdp_want(family, kind, attn, head, mixed, steps):
    """The launches a rank makes in ``steps`` steps: each layer's flash
    forward, dq and dkv (FSDP's backward recomputes each block, so its
    forward runs twice a layer), the head's two kernels once a step where
    the fused head runs; ``[bf16]`` under the mixed trunk."""
    layers = LM["n_layers"] * steps if attn == "flash" else 0
    tag = "[bf16]" if mixed else ""
    want = {f"flash_attn_fwd{tag}": layers * (2 if kind == "fsdp" else 1),
            f"flash_attn_dq{tag}": layers, f"flash_attn_dkv{tag}": layers}
    if head == "fused":
        want.update(head_xent_stats=steps, head_xent_bwd=steps)
    return want


def lmdp_rank(mesh, payload):
    """One rank of an ``lmdp`` run (module level: ``--phase dist`` spawns
    it): a DDP, FSDP or hybrid trainer of the LM or the transformer at
    ``LM``'s shape with rank 0's steps stamped. Returns the rank's final
    params or shards on the CPU (DDP: rank 0's alone), the stamps and,
    in a process of its own, its launch counts and peak memory."""
    import torch

    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.optim import leaves
    from distributed_llm_code_samples_tpu_torch.parallel import (
        train_lm_ddp, train_lm_fsdp, train_lm_hybrid, train_transformer_ddp,
        train_transformer_fsdp, train_transformer_hybrid)
    trainers = {("lm", "ddp"): train_lm_ddp, ("lm", "fsdp"): train_lm_fsdp,
                ("lm", "hybrid"): train_lm_hybrid,
                ("tf", "ddp"): train_transformer_ddp,
                ("tf", "fsdp"): train_transformer_fsdp,
                ("tf", "hybrid"): train_transformer_hybrid}
    family, kind, params, seeds, lr, kw = payload
    stamps = []

    def on_step(_):
        if mesh.rank == 0:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    if not mesh.loopback:
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainers[family, kind](params, seeds, LM_TOKENS, LM["d_model"],
                                 mesh, lr=lr, seq_len=LM["seq_len"],
                                 n_heads=LM["n_heads"], on_step=on_step, **kw)
    torch.cuda.synchronize()
    keep = kind != "ddp" or mesh.rank == 0
    return dict(shards=[t.cpu() for t in leaves(out)] if keep else None,
                t0=t0, stamps=stamps,
                launches=None if mesh.loopback else launch_counts(),
                max_memory_allocated_gb=None if mesh.loopback else
                torch.cuda.max_memory_allocated() / 2 ** 30)


def lmdp_phase(torch, np, card, cards: int = 0):
    """DDP, FSDP and the DDP x TP hybrid of the LM and of the transformer
    at ``LM``'s shape (``LMDP_RUNS``, ``LMDP_STEPS`` steps at the package
    LR each, ``lmdp-train-run``: the step, tokens/s, peak memory and each
    LM kernel's launches a rank, held exactly against ``lmdp_want``), then
    one step of each at ``CHECK_LR`` against a float64 update on the
    summed gradients of the ranks' batches, over the error of the same
    sum through the single-device f32 gradients (``lmdp-train-check``;
    unchanged weights as the control). ``cards`` 0: the ranks in
    loopback on one card; else one rank a card over NCCL, where FSDP's
    peak memory a rank must be below DDP's. Returns each run's launches
    a rank."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        batch_from_seed, lm_batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models import (
        TransformerParams, init_lm, lm_from_leaves)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.optim import leaves, sgd
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, launch, lm_grads, resolve_attn, resolve_head)
    from distributed_llm_code_samples_tpu_torch.parallel import lm as lm_mod
    from distributed_llm_code_samples_tpu_torch.parallel import transformer
    t_phase = time.perf_counter()
    mode = f"{cards} cards" if cards else "loopback"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM["random_seed"])
    params = init_lm(gen, LM["vocab"], LM["d_model"], LM["n_layers"],
                     LM["seq_len"], n_heads=LM["n_heads"])
    start = {"lm": params, "tf": params.blocks}
    host = ({k: v.with_leaves([t.cpu() for t in leaves(v)])
             for k, v in start.items()} if cards else start)
    seeds = make_seed_schedule(LMDP_N * LMDP_STEPS, LM["random_seed"])
    b = LM_TOKENS // LM["seq_len"]

    def data_ranks(kind):
        return LMDP_HYBRID["data"] if kind == "hybrid" else LMDP_N

    def run(label, seeds, lr):
        _, family, kind, attn, head, mixed = LMDP_RUNS[
            LMDP_LABELS.index(label)]
        kw = dict(attn_impl=attn)
        if family == "lm" and kind != "hybrid":
            kw.update(head_impl=head, mixed=mixed,
                      optimizer=lmdp_optimizer(kind, mixed))
        mesh = lmdp_mesh(kind, cards)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        outs = launch(lmdp_rank, mesh, (family, kind, host[family], seeds,
                                        lr, kw), timeout=600)
        if cards:
            per_rank = outs[0]["launches"]
            mem = [o["max_memory_allocated_gb"] for o in outs]
        else:
            per_rank = {k: c / mesh.size for k, c in launch_counts().items()}
            mem = [torch.cuda.max_memory_allocated() / 2 ** 30]
        shards = [o["shards"] for o in outs]
        if kind == "ddp":
            full = shards[0]
        elif kind == "fsdp":
            full = leaves(lm_mod.lm_fsdp_unshard(
                [lm_from_leaves(s) for s in shards]) if family == "lm"
                else transformer.fsdp_unshard(
                    [TransformerParams(*s) for s in shards]))
        else:
            rows = [s for r, s in enumerate(shards)
                    if mesh.coords(r)[DATA_AXIS] == 0]
            full = leaves(lm_mod.lm_tp_unshard(
                [lm_from_leaves(s) for s in rows]) if family == "lm"
                else transformer.tp_unshard(
                    [TransformerParams(*s) for s in rows]))
        return [t.cuda() for t in full], outs[0], per_rank, mem

    launches, peaks = {}, {}
    for label, family, kind, attn, head, mixed in LMDP_RUNS:
        n_data = data_ranks(kind)
        full, r0, per_rank, mem = run(label, seeds[:n_data * LMDP_STEPS],
                                      LR)
        check(all(bool(torch.isfinite(t).all()) for t in full),
              f"lmdp {label}: trained params are not finite")
        del full
        steps = [b_ - a for a, b_ in zip([r0["t0"]] + r0["stamps"],
                                         r0["stamps"])]
        med = statistics.median(steps[1:])
        flops = n_data * (LM_BLOCK_FLOPS
                          + (LM_HEAD_FLOPS if family == "lm" else 0))
        want = lmdp_want(family, kind, attn, head, mixed, len(steps))
        print("lmdp-train-run " + json.dumps(dict(
            run=f"{label}-{'nccl' if cards else 'loopback'}", mode=mode,
            family=family, strategy=kind, attn_impl=attn,
            head_impl=head or "oracle", mixed=mixed,
            optimizer="clipped-adamw" if mixed else "sgd",
            mesh=LMDP_HYBRID if kind == "hybrid" else {"data": LMDP_N},
            steps_per_rank=len(steps), tokens_per_rank_step=LM_TOKENS,
            tokens_per_step=n_data * LM_TOKENS, median_step_ms=1e3 * med,
            first_step_ms=1e3 * steps[0],
            tokens_per_s=n_data * LM_TOKENS / med,
            model_tflops_per_s=flops / med / 1e12,
            f32_peak_share=flops / med / (F32_FLOPS_PER_S * (cards or 1)),
            max_memory_allocated_gb=mem if cards else mem[0],
            launches_per_rank=per_rank, want_launches_per_rank=want,
            card=card)), flush=True)
        for name, n in want.items():
            check(per_rank.get(name, 0) == n, f"lmdp {label}: "
                  f"{per_rank.get(name, 0)} launches of {name} a rank, "
                  f"expected {n}")
        check(set(per_rank) <= set(want), f"lmdp {label}: launches "
              f"{per_rank}")
        launches[label], peaks[label] = per_rank, max(mem)
    if cards:
        for family in ("lm", "tf"):
            ddp, fsdp = peaks[f"{family}-ddp"], peaks[f"{family}-fsdp"]
            print("lmdp-memory " + json.dumps(dict(
                family=family, ddp_peak_gb_per_rank=ddp,
                fsdp_peak_gb_per_rank=fsdp, fsdp_over_ddp=fsdp / ddp,
                card=card)), flush=True)
            check(fsdp < ddp, f"lmdp {family}: FSDP's peak {fsdp:.2f} GB a "
                  f"rank is not below DDP's {ddp:.2f} GB")

    # one step at CHECK_LR from the same params: each run's update against
    # a float64 update on the sum of the ranks' float64 gradients (the
    # oracle ops), over the error of the same sum of the single-device f32
    # gradients under the run's policy (UPDATE_RATIO), leaf by leaf
    def grads(family, p, seed, attn=None, head=None, mixed=False):
        if family == "lm":
            toks, tgts = lm_batch_from_seed(seed, b, LM["seq_len"],
                                            LM["vocab"], device="cuda")
            return lm_grads(p, toks, tgts, LM["n_heads"], resolve_attn(attn),
                            resolve_head(head), mixed)[1]
        x, dy = (t.to(leaves(p)[0].dtype).reshape(b, LM["seq_len"], -1)
                 for t in batch_from_seed(seed, LM_TOKENS, LM["d_model"],
                                          device="cuda"))
        return transformer.transformer_grads(p, x, dy, LM["n_heads"],
                                             attn=resolve_attn(attn))

    def summed(family, p, n, **kw):
        total = None
        for seed in seeds[:n]:
            g = grads(family, p, int(seed), **kw)
            total = g if total is None else [a + c for a, c in zip(total, g)]
        return total

    def update(p, g, mixed):
        """One step of the run's rule from ``p``: SGD, or the mixed
        runs' clipped AdamW (DDP's: the sum is whole)."""
        p = p.with_leaves([t.clone() for t in leaves(p)])
        if not mixed:
            return leaves(sgd(p, g, CHECK_LR))
        opt = lmdp_optimizer("ddp", True)
        return leaves(opt.update(p.with_leaves(g), opt.init(p), p,
                                 CHECK_LR)[0])

    row = dict(mode=mode, check_lr=CHECK_LR, update_ratio_limit=UPDATE_RATIO)
    ratios, unchanged, want64 = {}, [], {}
    for label, family, kind, attn, head, mixed in LMDP_RUNS:
        n_data = data_ranks(kind)
        p0 = start[family]
        key = (family, n_data, mixed)
        if key not in want64:
            want64.clear()
            p64 = p0.with_leaves([t.double() for t in leaves(p0)])
            want64[key] = update(p64, summed(family, p64, n_data), mixed)
            del p64
        base = update(p0, summed(family, p0, n_data, attn=attn, head=head,
                                 mixed=mixed), mixed)
        base_errs = [update_err(torch, g, w, q) for g, w, q in
                     zip(base, want64[key], leaves(p0))]
        del base
        got = run(label, seeds[:n_data], CHECK_LR)[0]
        e = [update_err(torch, g, w, q) for g, w, q in
             zip(got, want64[key], leaves(p0))]
        del got
        ratios[label] = max(a / c for a, c in zip(e, base_errs))
        unchanged.append(min(1.0 / c for c in base_errs))
        row[f"{label}_single_update_err_vs_f64"] = base_errs
        row[f"{label}_update_err_vs_f64"] = e
        row[f"{label}_update_err_ratio_max"] = ratios[label]
    del want64
    row.update(unchanged_ratio_min=min(unchanged),
               phase_s=time.perf_counter() - t_phase, card=card)
    print("lmdp-train-check " + json.dumps(row), flush=True)
    for label, ratio in ratios.items():
        check(ratio <= UPDATE_RATIO, f"lmdp {label}'s update {ratio:.2f}x as "
              "far from float64 as the single-device f32 gradients' sum")
    check(min(unchanged) > UPDATE_RATIO,
          "the update check cannot tell unchanged weights from trained")
    return launches


# -- sequence parallelism: ring attention and Ulysses ------------------------
#
# The long-context LM: the GPT-2-small width of LM at 4096 positions over
# SEQ_N seq ranks (1024 tokens a rank), 2 sequences a step: 8192 tokens, as
# LM's 16 x 512, so the two step times compare.
SEQ_N = RING_N
SEQ_LM = dict(seq_len=4096, batch=2, steps=4)
SEQ_TOKENS = SEQ_LM["batch"] * SEQ_LM["seq_len"]
SEQ_IMPLS = ("ring", "ulysses")
SEQ_DH = LM["d_model"] // LM["n_heads"]
SEQ_BLOCK_FLOPS = 3 * SEQ_LM["batch"] * LM["n_layers"] * (
    8 * SEQ_LM["seq_len"] * LM["d_model"] ** 2
    + 2 * SEQ_LM["seq_len"] ** 2 * LM["d_model"]
    + 16 * LM["d_model"] ** 2 * SEQ_LM["seq_len"])
SEQ_FLOPS = SEQ_BLOCK_FLOPS + 6 * SEQ_TOKENS * LM["d_model"] * LM["vocab"]
# cli.py -m 13 at the same shape on every card (--phase dist-seq)
SEQ_CLI_SHAPE = ("-m", "13", "--attn", "flash", "--head", "fused", "-s", "4",
                 "-bs", str(SEQ_LM["batch"]), "-n", str(SEQ_LM["seq_len"]),
                 "-l", str(LM["n_layers"]), "-d", str(LM["d_model"]), "-r",
                 "7", "--heads", str(LM["n_heads"]), "--vocab",
                 str(LM["vocab"]))
CLI_SEQ = tuple((f"dist-cli-m13-{impl}", SEQ_CLI_SHAPE + ("--seq_impl", impl))
                for impl in SEQ_IMPLS)
# the ring's flash calls by the rank whose thread made them (loopback)
_SEQ_THREAD_RANK: dict = {}


def seq_want(seq_impl, steps, rank=None):
    """The LM kernels' launches in ``steps`` steps of a seq rank (``rank``
    None: of all SEQ_N ranks). The causal ring runs the flash forward and
    backward on the blocks at or before the rank's own: rank r on r + 1
    of the n a layer; Ulysses runs them once a layer on the whole
    sequence of its heads; the fused head's two kernels once a step."""
    ranks = range(SEQ_N) if rank is None else [rank]
    layers = LM["n_layers"] * steps
    flash = sum(layers * (r + 1 if seq_impl == "ring" else 1) for r in ranks)
    return {"flash_attn_fwd": flash, "flash_attn_dq": flash,
            "flash_attn_dkv": flash, "head_xent_stats": steps * len(ranks),
            "head_xent_bwd": steps * len(ranks)}


def seq_device_time(prof, wall_ms):
    """The device busy time and idle share of a traced run, and the flash
    kernels' and the fused head's device ms in it."""
    parts = lm_parts(prof)
    summary = profile_summary(prof, wall_ms)
    return dict(traced_wall_ms=wall_ms,
                device_busy_ms=summary["device_busy_ms"],
                device_idle_share=summary["device_idle_share"],
                flash_ms=sum(parts.get(k, {}).get("ms", 0.0)
                             for k in ("flash_attn_fwd", "flash_attn_bwd")),
                head_ms=sum(parts.get(k, {}).get("ms", 0.0)
                            for k in ("head_xent_stats", "head_xent_bwd")),
                top=summary["top"][:5])


def seq_rank(mesh, payload):
    """One rank of a ``seq`` run (module level: ``--phase dist-seq``
    spawns it): ``train_lm_seq`` at ``SEQ_LM`` with rank 0's steps
    stamped. Returns rank 0's final params (on the CPU from a process of
    its own), the stamps and, in a process of its own, the launch counts,
    the peak memory and, with ``traced``, the device time of the steps
    after the first (``seq_device_time``): the rank's own on its card, or
    in loopback all the ranks' on the one card (rank 0 traces)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.optim import leaves
    from distributed_llm_code_samples_tpu_torch.parallel import train_lm_seq
    params, seeds, lr, keep, traced, kw = payload
    _SEQ_THREAD_RANK[threading.get_ident()] = mesh.rank
    stamps = []
    prof = None
    if traced and (mesh.rank == 0 or not mesh.loopback):
        # the profiler's first start sets up device tracing (seconds):
        # once here, outside the traced steps
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])

    def on_step(i):
        if mesh.rank == 0 or prof is not None:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        if i == 0 and prof is not None:
            prof.start()

    if not mesh.loopback:
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_lm_seq(params, seeds, SEQ_TOKENS, LM["d_model"], mesh, lr=lr,
                       seq_len=SEQ_LM["seq_len"], n_heads=LM["n_heads"],
                       on_step=on_step, **kw)
    torch.cuda.synchronize()
    device = None
    if prof is not None:
        prof.stop()
        device = seq_device_time(prof, 1e3 * (stamps[-1] - stamps[0]))
    got = None
    if keep and mesh.rank == 0:
        got = [t if mesh.loopback else t.cpu() for t in leaves(out)]
    finite = all(bool(torch.isfinite(t).all()) for t in leaves(out))
    return dict(params=got, finite=finite, t0=t0, stamps=stamps,
                launches=None if mesh.loopback else launch_counts(),
                max_memory_allocated_gb=None if mesh.loopback else
                torch.cuda.max_memory_allocated() / 2 ** 30,
                device=device)


def float64_attention(torch):
    """Attention in float64 through the flash kernels' plain versions (no
    ``[T, T]`` tile saved for the backward), one sequence at a time: the
    attention op of a 4096-position step's float64 reference."""
    from distributed_llm_code_samples_tpu_torch.ops import (
        flash_attention as fa)

    class Attn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            outs = [fa.flash_attention_fwd_ref(q[i], k[i], v[i],
                                               causal=causal)
                    for i in range(q.shape[0])]
            y = torch.stack([o[0] for o in outs])
            lse = torch.stack([o[1] for o in outs])
            ctx.save_for_backward(q, k, v, y, lse)
            ctx.causal = causal
            return y

        @staticmethod
        def backward(ctx, dy):
            q, k, v, y, lse = ctx.saved_tensors
            grads = [fa.flash_attention_bwd_ref(
                dy[i], q[i], k[i], v[i], y[i], lse[i], causal=ctx.causal)
                for i in range(q.shape[0])]
            return (*(torch.stack(g) for g in zip(*grads)), None)

    return lambda q, k, v, causal: Attn.apply(q, k, v, causal)


def seq_kernel_phase(torch, np, timer, card):
    """The flash kernels as the causal ring calls them at ``SEQ_LM``'s
    shape (one layer, ``[2, 12, 4096, 64]`` over SEQ_N loopback ranks):
    every recorded hop call, forward and backward, against float64 on
    its own inputs with the causal-flipped control (``BLOCK_TOL``,
    ``seq-kernel``); the ring's ``y``, ``lse``, ``dq``, ``dk``, ``dv``
    against float64 attention over the whole 4096 positions, and the
    control that must fail: the backward handed each hop's own ``lse``
    in place of the global one. Then each kernel at the hop's shape (an
    earlier block: non-causal) against its plain version and timed
    (``lm-kernel-case`` lines, shape ``seq-hop``). Returns the cases."""
    from distributed_llm_code_samples_tpu_torch.ops import (
        flash_attention as fa)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        SEQ_AXIS, launch, make_mesh)
    from distributed_llm_code_samples_tpu_torch.parallel import sequence as sq
    b, h, t = SEQ_LM["batch"], LM["n_heads"], SEQ_LM["seq_len"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(500)
    q, k, v = (torch.randn(b, h, t, SEQ_DH, generator=gen, device="cuda")
               for _ in range(3))
    dy = 0.1 * torch.randn(b, h, t, SEQ_DH, generator=gen, device="cuda")

    def blocks(r):
        return [x.chunk(SEQ_N, -2)[r].contiguous() for x in (q, k, v, dy)]

    def ring(mesh, fwd_only):
        qb, kb, vb, dyb = blocks(mesh.axis_index(SEQ_AXIS))
        y, lse = sq.ring_attention_fwd(qb, kb, vb, mesh, attn_impl="flash")
        if fwd_only:
            return y, lse
        return (y, lse, *sq.ring_attention_bwd(qb, kb, vb, y, lse, dyb,
                                               mesh, attn_impl="flash"))

    def joined(outs):
        return [torch.cat([o[i] for o in outs], -1 if i == 1 else -2)
                for i in range(len(outs[0]))]

    wrappers = {n: w for n, w in lm_wrappers().items()
                if n.startswith("flash")}
    with recorded_calls(wrappers) as calls:
        got = joined(launch(ring, make_mesh({SEQ_AXIS: SEQ_N},
                                            loopback=True), False,
                            timeout=300))
    torch.cuda.synchronize()
    per_call = lm_call_errors(torch, wrappers, calls)
    n_calls = {n: sum(c[0] == n for c in calls) for n in wrappers}
    del calls
    # the control: each hop's backward handed the lse of its own forward
    bwd = fa.flash_attention_bwd

    def own_lse(dy_, q_, k_, v_, y_, lse_, *, causal=True, mxu_bf16=False):
        lse_j = fa.flash_attention_fwd(q_, k_, v_, causal=causal)[1]
        return bwd(dy_, q_, k_, v_, y_, lse_j, causal=causal,
                   mxu_bf16=mxu_bf16)

    fa.flash_attention_bwd = own_lse
    try:
        control = joined(launch(ring, make_mesh({SEQ_AXIS: SEQ_N},
                                                loopback=True), False,
                                timeout=300))[2:]
    finally:
        fa.flash_attention_bwd = bwd
    names = ("y", "lse", "dq", "dk", "dv")
    errs = {n: 0.0 for n in names}
    control_errs = {n: 0.0 for n in names[2:]}
    for i in range(b):
        y64, lse64 = fa.flash_attention_fwd_ref(
            *(x[i].double() for x in (q, k, v)), causal=True)
        want = [y64, lse64, *fa.flash_attention_bwd_ref(
            dy[i].double(), *(x[i].double() for x in (q, k, v)), y64, lse64,
            causal=True)]
        for n, g, w in zip(names, got, want):
            width = 1 if n == "lse" else SEQ_DH
            errs[n] = max(errs[n], row_err(torch, g[i].reshape(-1, width),
                                           w.reshape(-1, width)))
        for n, g, w in zip(names[2:], control, want[2:]):
            control_errs[n] = max(control_errs[n], row_err(
                torch, g[i].reshape(-1, SEQ_DH), w.reshape(-1, SEQ_DH)))
        del y64, lse64, want
    want_calls = {"flash_attn_fwd": SEQ_N * (SEQ_N + 1) // 2,
                  "flash_attn_bwd": SEQ_N * (SEQ_N + 1) // 2}
    row = dict(
        shape=[b, h, t, SEQ_DH], ranks=SEQ_N, calls=n_calls,
        want_calls=want_calls,
        call_err_max={n: max(c["err"] for c in per_call if c["kernel"] == n)
                      for n in wrappers},
        call_control_err_min={n: min(c["control_err"] for c in per_call
                                     if c["kernel"] == n) for n in wrappers},
        ring_err_vs_f64=errs, own_lse_control_err_vs_f64=control_errs,
        block_tol=BLOCK_TOL, card=card)
    row["ok"] = (n_calls == want_calls
                 and max(row["call_err_max"].values()) <= BLOCK_TOL
                 and min(row["call_control_err_min"].values()) > BLOCK_TOL
                 and max(errs.values()) <= BLOCK_TOL
                 and min(control_errs.values()) > BLOCK_TOL)
    print("seq-kernel " + json.dumps(row), flush=True)
    cases = [dict(row, kernel="seq-ring", max_abs_err=0.0, rel_err=0.0)]
    del q, k, v, dy, got, control
    # the kernels at one hop of the ring: an earlier block, non-causal
    gen.manual_seed(501)
    shape = (b * h, t // SEQ_N, SEQ_DH)
    qh, kh, vh = (torch.randn(*shape, generator=gen, device="cuda")
                  for _ in range(3))
    dyh = 0.1 * torch.randn(*shape, generator=gen, device="cuda")
    yh, lseh = fa.flash_attention_fwd_ref(qh, kh, vh, causal=False)
    kw = dict(causal=False, mxu_bf16=False)
    cases.append(lm_case_row(
        torch, timer, "flash_attn_fwd", "seq-hop", (*shape, False), False,
        partial(fa.flash_attention_fwd, qh, kh, vh, **kw),
        partial(fa.flash_attention_fwd_ref, qh, kh, vh, **kw),
        sdpa_ms(torch, timer, qh, kh, vh, dyh, False, False)))
    cases.append(lm_case_row(
        torch, timer, "flash_attn_bwd", "seq-hop", (*shape, False), False,
        partial(fa.flash_attention_bwd, dyh, qh, kh, vh, yh, lseh, **kw),
        partial(fa.flash_attention_bwd_ref, dyh, qh, kh, vh, yh, lseh, **kw),
        sdpa_ms(torch, timer, qh, kh, vh, dyh, False, True)))
    return cases


def seq_a2a_phase(torch, card):
    """Ulysses on the all-to-all kernel (``comm="pallas_a2a"``) at ``[2,
    12, 1024, 64]`` a rank on SEQ_N loopback ranks: each re-shard of q, k
    and v bit for bit against the plain exchange, then the forward and
    the backward (flash on the local heads) against the ``psum``
    transport's, bit for bit: an all-to-all only moves blocks
    (``seq-a2a``). Returns the kernel's launches in the pallas_a2a
    forward and backward, counted from 0 just before them."""
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.ops.flash_attention import (
        flash_mha)
    from distributed_llm_code_samples_tpu_torch.ops.ring import (
        all_to_all_dma_dims)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        SEQ_AXIS, all_to_all, launch, make_mesh)
    from distributed_llm_code_samples_tpu_torch.parallel import sequence as sq
    b, h, t = SEQ_LM["batch"], LM["n_heads"], SEQ_LM["seq_len"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(502)
    full = [torch.randn(b, h, t, SEQ_DH, generator=gen, device="cuda")
            for _ in range(4)]

    def reshards(mesh, _):
        blocks = [x.chunk(SEQ_N, -2)[mesh.axis_index(SEQ_AXIS)].contiguous()
                  for x in full[:3]]
        return [torch.equal(all_to_all_dma_dims(x, mesh, -3, -2),
                            all_to_all(x, mesh, split_dim=-3, concat_dim=-2,
                                       axis=SEQ_AXIS)) for x in blocks]

    def ulysses(mesh, comm):
        qb, kb, vb, dyb = (x.chunk(SEQ_N, -2)[mesh.axis_index(SEQ_AXIS)]
                           .contiguous() for x in full)
        y, res = sq.ulysses_attention_fwd(qb, kb, vb, mesh, attn=flash_mha,
                                          comm=comm)
        return (y, *sq.ulysses_attention_bwd(res, dyb, mesh, comm=comm))

    t0 = time.perf_counter()
    same = launch(reshards, make_mesh({SEQ_AXIS: SEQ_N}, loopback=True),
                  timeout=300)
    torch.cuda.synchronize()
    reset_launch_counts()
    kern = launch(ulysses, make_mesh({SEQ_AXIS: SEQ_N}, loopback=True),
                  "pallas_a2a", timeout=300)
    torch.cuda.synchronize()
    launches = launch_counts().get("all_to_all_dma", 0)
    plain = launch(ulysses, make_mesh({SEQ_AXIS: SEQ_N}, loopback=True),
                   "psum", timeout=300)
    equal = all(torch.equal(a, c) for ko, po in zip(kern, plain)
                for a, c in zip(ko, po))
    finite = all(bool(torch.isfinite(a).all()) for ko in kern for a in ko)
    row = dict(shape_per_rank=[b, h, t // SEQ_N, SEQ_DH], ranks=SEQ_N,
               reshards_bit_equal=same, ulysses_bit_equal_psum=equal,
               finite=finite, all_to_all_dma_launches=launches,
               want_launches=8, seconds=time.perf_counter() - t0, card=card)
    print("seq-a2a " + json.dumps(row), flush=True)
    check(all(all(s) for s in same), "the all-to-all kernel's re-shard "
          "differs from the plain exchange")
    check(equal and finite, "Ulysses on the all-to-all kernel differs from "
          "the psum transport's")
    # four exchanges forward (q, k, v, y), four backward (dy, dq, dk, dv)
    check(launches == 8, f"{launches} all_to_all_dma launches, expected 8")
    return launches


def seq_phase(torch, np, card, cards: int = 0):
    """``train_lm_seq`` at ``SEQ_LM`` (the GPT-2-small LM at 4096 positions
    over SEQ_N seq ranks), flash attention and the fused head, ring and
    Ulysses, ``SEQ_LM["steps"]`` steps each (``seq-train-run``: the step,
    tokens/s, peak memory, each LM kernel's launches held exactly against
    ``seq_want``, and in loopback the ring's flash calls by rank);
    ``train_lm_single`` at the same shape and kernels on one card
    (``seq-single-run``); a run of 3 steps of each with steps 2-3 traced
    (``seq-train-profile``: the device's busy time and idle share, each
    rank's on four cards, and the flash kernels' device time: the causal
    ring's rank r runs r + 1 of the n blocks); then one step of each at
    ``CHECK_LR`` against a float64 update, over the error of
    ``train_lm_single``'s (``LM_GRAD_RATIO``; unchanged weights as the
    control, ``seq-train-check``). ``cards`` 0: the ranks in loopback on
    one card; else one rank a card over NCCL (the hops on
    ``batch_isend_irecv``). Returns each run's launches over the ranks."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        lm_batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.lm import (
        init_lm, lm_from_leaves, lm_leaves)
    from distributed_llm_code_samples_tpu_torch.ops import (
        flash_attention as fa)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        SEQ_AXIS, launch, lm_grads, make_mesh, train_lm_single)
    t_phase = time.perf_counter()
    mode = f"{cards} cards" if cards else "loopback"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM["random_seed"])
    params = init_lm(gen, LM["vocab"], LM["d_model"], LM["n_layers"],
                     SEQ_LM["seq_len"], n_heads=LM["n_heads"])
    host = lm_from_leaves([t.cpu() for t in lm_leaves(params)]) if cards \
        else params
    seeds = make_seed_schedule(SEQ_LM["steps"], LM["random_seed"])
    kw = dict(attn_impl="flash", head_impl="fused")

    def run(seq_impl, seeds, lr, keep=False, traced=False):
        mesh = make_mesh({SEQ_AXIS: SEQ_N}, **(dict(device="cuda") if cards
                                                else dict(loopback=True)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        _SEQ_THREAD_RANK.clear()
        fwd, by_rank = fa.flash_attention_fwd, [0] * SEQ_N

        def counted(*a, **k):      # the rank threads' forward calls
            r = _SEQ_THREAD_RANK.get(threading.get_ident())
            if r is not None:
                by_rank[r] += 1
            return fwd(*a, **k)

        fa.flash_attention_fwd = counted
        try:
            outs = launch(seq_rank, mesh, (host, seeds, lr, keep, traced,
                                           dict(kw, seq_impl=seq_impl)),
                          timeout=600)
        finally:
            fa.flash_attention_fwd = fwd
        if cards:
            per_rank = [o["launches"] for o in outs]
            total = {n: sum(p.get(n, 0) for p in per_rank)
                     for n in set().union(*per_rank)}
            mem = [o["max_memory_allocated_gb"] for o in outs]
        else:
            total = launch_counts()
            per_rank = None
            mem = [torch.cuda.max_memory_allocated() / 2 ** 30]
        check(all(o["finite"] for o in outs),
              f"seq {seq_impl}: trained params are not finite")
        got = outs[0]["params"]
        return (None if got is None else [t.cuda() for t in got], outs,
                total, per_rank, by_rank, mem)

    launches = {}
    for seq_impl in SEQ_IMPLS:
        _, outs, total, per_rank, by_rank, mem = run(seq_impl, seeds, LR)
        r0 = outs[0]
        steps = [b_ - a for a, b_ in zip([r0["t0"]] + r0["stamps"],
                                         r0["stamps"])]
        med = statistics.median(steps[1:])
        want = seq_want(seq_impl, len(steps))
        want_by_rank = [seq_want(seq_impl, len(steps), r)["flash_attn_fwd"]
                        for r in range(SEQ_N)]
        print("seq-train-run " + json.dumps(dict(
            run=f"lm-seq-{seq_impl}-{'nccl' if cards else 'loopback'}",
            mode=mode, seq_impl=seq_impl, attn_impl="flash",
            head_impl="fused", mesh={"seq": SEQ_N},
            seq_len=SEQ_LM["seq_len"], tokens_per_rank=SEQ_TOKENS // SEQ_N,
            steps=len(steps), tokens_per_step=SEQ_TOKENS,
            median_step_ms=1e3 * med, first_step_ms=1e3 * steps[0],
            tokens_per_s=SEQ_TOKENS / med,
            model_tflops_per_s=SEQ_FLOPS / med / 1e12,
            f32_peak_share=SEQ_FLOPS / med / (F32_FLOPS_PER_S * (cards or 1)),
            max_memory_allocated_gb=mem if cards else mem[0],
            launches=total, want_launches=want,
            launches_per_rank_per_step=None if per_rank is None else [
                {n: c / len(steps) for n, c in p.items()} for p in per_rank],
            ring_flash_fwd_calls_by_rank=None if cards else by_rank,
            want_flash_fwd_by_rank=want_by_rank, card=card)), flush=True)
        for name, n in want.items():
            check(total.get(name, 0) == n, f"seq {seq_impl}: "
                  f"{total.get(name, 0)} launches of {name}, expected {n}")
            check(n > 0, f"seq {seq_impl}: no launch of {name}")
        check(set(total) <= set(want), f"seq {seq_impl}: launches {total}")
        if per_rank is not None:
            for r, p in enumerate(per_rank):
                check(p == seq_want(seq_impl, len(steps), r),
                      f"seq {seq_impl} rank {r}: launches {p}")
        elif seq_impl == "ring":
            check(by_rank == want_by_rank, f"seq ring: the ranks' flash "
                  f"forward calls {by_rank}, expected {want_by_rank}")
        launches[seq_impl] = total

    # the same steps on one card, and where a traced run's device time goes
    stamps = []

    def on_step(_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_lm_single(params, seeds, SEQ_TOKENS, LM["d_model"], lr=LR,
                    seq_len=SEQ_LM["seq_len"], n_heads=LM["n_heads"],
                    on_step=on_step, **kw)
    steps = [b_ - a for a, b_ in zip([t0] + stamps, stamps)]
    single_ms = 1e3 * statistics.median(steps[1:])
    print("seq-single-run " + json.dumps(dict(
        seq_len=SEQ_LM["seq_len"], tokens_per_step=SEQ_TOKENS,
        steps=len(steps), median_step_ms=single_ms,
        tokens_per_s=1e3 * SEQ_TOKENS / single_ms,
        model_tflops_per_s=SEQ_FLOPS / single_ms / 1e9, card=card)),
        flush=True)
    for seq_impl in SEQ_IMPLS:
        outs = run(seq_impl, seeds[:3], LR, traced=True)[1]
        device = [o["device"] for o in outs if o["device"] is not None]
        print("seq-train-profile " + json.dumps(dict(
            run=f"lm-seq-{seq_impl}-{'nccl' if cards else 'loopback'}",
            mode=mode, traced_steps=2, device_by_rank=device if cards
            else None, device=None if cards else device[0],
            flash_ms_by_rank=[d["flash_ms"] for d in device],
            idle_share_by_rank=[d["device_idle_share"] for d in device],
            card=card)), flush=True)

    # one step at CHECK_LR: each run's update against a float64 update
    # (the oracle head, float64 attention) over the error of
    # train_lm_single's at the same 4096 positions with the same kernels
    toks, tgts = lm_batch_from_seed(int(seeds[0]), SEQ_LM["batch"],
                                    SEQ_LM["seq_len"], LM["vocab"],
                                    device="cuda")
    p64 = lm_from_leaves([t.double() for t in lm_leaves(params)])
    g64 = lm_grads(p64, toks, tgts, LM["n_heads"],
                   float64_attention(torch))[1]
    want64 = [p - CHECK_LR * g for p, g in zip(lm_leaves(p64), g64)]
    del p64, g64
    torch.cuda.empty_cache()
    single = lm_leaves(train_lm_single(
        params, seeds[:1], SEQ_TOKENS, LM["d_model"], lr=CHECK_LR,
        seq_len=SEQ_LM["seq_len"], n_heads=LM["n_heads"], **kw))
    base = [update_err(torch, g, w, p0) for g, w, p0 in
            zip(single, want64, lm_leaves(params))]
    del single
    names = ("wte", "wpe", "ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2",
             "ln_f")
    row = dict(mode=mode, check_lr=CHECK_LR, grad_ratio_limit=LM_GRAD_RATIO,
               single_update_err_vs_f64=dict(zip(names, base)))
    ratios = {}
    for seq_impl in SEQ_IMPLS:
        got = run(seq_impl, seeds[:1], CHECK_LR, keep=True)[0]
        errs = [update_err(torch, g, w, p0) for g, w, p0 in
                zip(got, want64, lm_leaves(params))]
        del got
        ratios[seq_impl] = max(e / c for e, c in zip(errs, base))
        row[f"{seq_impl}_update_err_vs_f64"] = dict(zip(names, errs))
        row[f"{seq_impl}_update_err_ratio_max"] = ratios[seq_impl]
    unchanged = min(1.0 / c for c in base)
    row.update(unchanged_ratio_min=unchanged,
               phase_s=time.perf_counter() - t_phase, card=card)
    print("seq-train-check " + json.dumps(row), flush=True)
    del want64
    for seq_impl, ratio in ratios.items():
        check(ratio <= LM_GRAD_RATIO, f"seq {seq_impl}'s update {ratio:.2f}x "
              "as far from float64 as train_lm_single's")
    check(unchanged > LM_GRAD_RATIO,
          "the update check cannot tell unchanged weights from trained")
    return launches


# -- the stateful optimizers, ZeRO-1 and the bf16 mixed policy -------------
#
# The kernels on bf16 storage: (kernels-line row, source, the TPU kernel
# it replaces, the launch counts it makes). FSDP's mixed gathers move bf16
# shards through the all-gather; the LM's mixed trunk hands the flash
# kernels bf16 q, k, v.
BF16_KERNELS = (
    ("ring_all_gather[bf16]", "ring_collectives.cu", "ops/pallas_ring.py:406",
     ("ring_all_gather[bf16]",)),
    ("flash_attn_fwd[bf16]", "flash_attn_fwd.cu",
     "ops/pallas_attention.py:149", ("flash_attn_fwd[bf16]",)),
    ("flash_attn_bwd[bf16]", "flash_attn_bwd.cu",
     "ops/pallas_attention.py:254",
     ("flash_attn_dq[bf16]", "flash_attn_dkv[bf16]")))
# FSDP's bf16 shards under mixed: a rank's [768, 768] of each layer's w1
# and [192, 3072] of its w2
BF16_GATHER_CASES = (("w1_shard", (FFN_DIM // RING_N, D_MODEL)),
                     ("w2_shard", (D_MODEL // RING_N, FFN_DIM)))
# A bf16-storage flash call against float64 on its own bf16 inputs, with
# the arithmetic the kernel runs (p and ds rounded to bf16, as mxu_bf16),
# by BLOCK_TOL's measure (row_err): each output is rounded to bf16 once,
# which moves it by up to half a bf16 step, 2^-9 of it, so a row errs by
# about one step (on an NVIDIA H100 80GB HBM3 at 700 W: 3.0e-3 forward,
# 2.1e-3 backward, 2^-8 = 3.9e-3); the limit is two steps. The control
# (causal flipped) errs by O(1). Against its plain version a bf16 output
# may differ by one bf16 step (2^-8 of the largest output) where an
# f32-level difference flips a rounding, beside the bf16-operand limit
# FFN_TOL[True].
BF16_BLOCK_TOL = 2 ** -7
BF16_STEP = 2 ** -8
# DDP, ZeRO-1 and FSDP under Adam (and DDP and FSDP under mixed AdamW),
# step by step: from DDP's params and Adam state after each of its 8
# steps, one step of each strategy, |a - b| / |a - p| (Frobenius, pooled
# over the layers) against DDP's update. Their per-rank gradients are the
# same, summed in other orders: the first step's updates differ by some
# 2.5e-6 (on an NVIDIA H100 80GB HBM3). Free runs are not compared: at
# this depth a difference of 2.5e-6 in one step's update grows to 2e-3 in
# the next and to 0.19 after 8 (momentum likewise), as ReLU masks within
# rounding of 0 flip (the drift is printed, free_run_drift).
OPT_AGREE = 1e-4
# the runs held step by step: (the chain's strategy, the others)
OPT_CHAINS = (("ddp-adam", ("zero1-adam", "fsdp-adam")),
              ("ddp-mixed-adamw", ("fsdp-mixed-adamw",)))
# One Adam step at CHECK_LR against a float64 Adam step from the same
# params on the same four seeds, as tp-train-check holds TP's: each
# strategy's update error (update_err, pooled over the layers) at most
# UPDATE_RATIO times the f32 matmul path's (stack_grads over the four
# seeds, summed, and the same Adam step); weights left unchanged have
# error exactly 1 and must fail.
# the LM under mixed AdamW: its loss within the mixed tolerance of the
# f32 run's (rtol 2e-2, as cli.py -m 0 --mixed checks its strategies)
MIXED_LOSS_TOL = 2e-2


def flash_bf16_bound(name, shape):
    """``lm_bound`` for bf16 storage: the same products at the bf16 rate,
    q, k, v, y (dy, dq, dk, dv) at 2 bytes an element, lse (and D) at 4."""
    bh, t, dh, causal = shape
    pairs = bh * causal_pairs(t, t, causal)
    fwd = name.startswith("flash_attn_fwd")
    flops = (4 if fwd else 10) * dh * pairs
    nbytes = (2 * (4 if fwd else 8) * bh * t * dh
              + 4 * bh * t * (1 if fwd else 2))
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return flops, ((t_ops, "operations") if t_ops >= t_bytes
                   else (t_bytes, "bytes"))


def bf16_kernel_phase(torch, np, timer):
    """The kernels that take bf16 storage, at the main path's shapes: the
    all-gather of FSDP's two bf16 shards in loopback (``RING_N`` virtual
    ranks), bit for bit against its plain ring and the concatenation in
    float64; the flash forward and backward at the LM shape against their
    plain versions and against float64 on their own inputs
    (``BF16_BLOCK_TOL``, with the causal-flipped control). Each is timed
    beside the f32 call on the same values."""
    from distributed_llm_code_samples_tpu_torch.ops import (
        flash_attention as fa)
    from distributed_llm_code_samples_tpu_torch.ops import ring
    rows = []
    op = "ring_all_gather"
    ws = ring.PeerWorkspace(4 * FFN_DIM * D_MODEL, "cuda", n=RING_N)
    try:
        for k, (tag, shape) in enumerate(BF16_GATHER_CASES):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(600 + k)
            xs = [torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for _ in range(RING_N)]
            got = ring.loopback(op, xs, ws)
            again = ring.loopback(op, xs, ws)
            torch.cuda.synchronize()
            ws.check()
            want = ring.loopback_ref(op, xs)
            bits = all(g.dtype == torch.bfloat16 and torch.equal(
                g.view(torch.int16), w.view(torch.int16))
                for g, w in zip(got, want))
            same = all(torch.equal(g.view(torch.int16), a.view(torch.int16))
                       for g, a in zip(got, again))
            f64 = ring_err(torch, got, ring_want(torch, op, xs))
            control = ring_err(torch, got, ring_want(torch, op, xs,
                                                     control=True))
            xs32 = [x.float() for x in xs]
            b_ms, b_by = ring_loopback_bound(op, 2 * xs[0].numel(), RING_N)
            row = dict(kernel="ring_all_gather[bf16]", shape=tag,
                       dims=list(shape), ranks=RING_N, mode="loopback",
                       max_abs_err=max(float((g.float() - w.float()).abs()
                                             .max())
                                       for g, w in zip(got, want)),
                       bit_identical=bits, deterministic=same,
                       err_vs_f64=f64, control_err_vs_f64=control,
                       ok=bits and same and f64 <= RING_TOL
                       and control > RING_TOL,
                       ms=timer.ms(lambda: ring.loopback(op, xs, ws)),
                       ms_with_host=timer.ms(lambda: ring.loopback(op, xs,
                                                                   ws),
                                             with_host=True),
                       plain_ms=timer.ms(lambda: ring.loopback_ref(op, xs)),
                       f32_ms=timer.ms(lambda: ring.loopback(op, xs32, ws)),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            rows.append(row)
            print("bf16-kernel-case " + json.dumps(row), flush=True)
            del xs, xs32, got, again, want
    finally:
        ws.close()

    tag, bh, t, dh, causal = FLASH_SHAPES[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(610)
    q, k, v = (torch.randn(bh, t, dh, generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    dy = (0.1 * torch.randn(bh, t, dh, generator=gen,
                            device="cuda")).bfloat16()
    y, lse = fa.flash_attention_fwd_ref(q, k, v, causal=causal)
    f32 = [a.float() for a in (q, k, v, dy, y)]
    cases = (
        ("flash_attn_fwd[bf16]", fa.flash_attention_fwd, (q, k, v),
         (f32[0], f32[1], f32[2]), False),
        ("flash_attn_bwd[bf16]", fa.flash_attention_bwd,
         (dy, q, k, v, y, lse), (f32[3], f32[0], f32[1], f32[2], f32[4],
                                 lse), True))
    for name, kern_fn, args, args32, backward in cases:
        ref_fn = getattr(fa, kern_fn.__name__ + "_ref")
        kern = partial(kern_fn, *args, causal=causal)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        want = ref_fn(*args, causal=causal)
        errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want)]
        scales = [float(w.float().abs().max()) for w in want]
        rel = max(e / s for e, s in zip(errs, scales))
        args64 = [a.double() for a in args]
        want64 = ref_fn(*args64, causal=causal, mxu_bf16=True)
        flipped = kern_fn(*args, causal=not causal)

        def err64(outs):
            return max(row_err(torch, o.reshape(-1, o.shape[-1]) if o.dim()
                               > 1 else o.reshape(1, -1),
                               w.reshape(-1, w.shape[-1]) if w.dim() > 1
                               else w.reshape(1, -1))
                       for o, w in zip(outs, want64))
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        dtypes = [str(g.dtype) for g in got]
        want_dtypes = [str(w.dtype) for w in want]
        f64, control = err64(got), err64(flipped)
        flops, (b_ms, b_by) = flash_bf16_bound(name, (bh, t, dh, causal))
        ms = timer.ms(kern)
        row = dict(kernel=name, shape=tag, dims=[bh, t, dh, causal],
                   out_dtypes=dtypes, max_abs_err=max(errs), rel_err=rel,
                   tol=FFN_TOL[True] + BF16_STEP, err_vs_f64=f64,
                   control_err_vs_f64=control, bf16_block_tol=BF16_BLOCK_TOL,
                   deterministic=same,
                   ok=finite and same and dtypes == want_dtypes
                   and rel <= FFN_TOL[True] + BF16_STEP
                   and f64 <= BF16_BLOCK_TOL and control > BF16_BLOCK_TOL,
                   ms=ms, plain_ms=timer.ms(partial(ref_fn, *args,
                                                    causal=causal)),
                   f32_ms=timer.ms(partial(kern_fn, *args32,
                                           causal=causal)),
                   bound_ms=b_ms, bound_by=b_by,
                   tflops_per_s=flops / ms / 1e9,
                   library_ms=sdpa_ms(torch, timer, q, k, v, dy, causal,
                                      backward))
        rows.append(row)
        print("bf16-kernel-case " + json.dumps(row), flush=True)
        del got, again, want, want64, flipped, args64
    return rows


def opt_train_phase(torch, np, card):
    """The stateful optimizers and ZeRO-1 at ``TRAIN``'s width on
    ``RING_N`` virtual ranks of one card: DDP (ring all-reduce), ZeRO-1
    (its reduce-scatter and all-gather: plain torch in loopback, as
    ``collectives.py`` runs them there) and FSDP (ring gathers and
    reduce-scatters) under Adam, and DDP and FSDP under mixed AdamW
    clipped at 1.0 (FSDP's gathers bf16), 8 steps a rank at the package
    LR (``opt-train-run``), pairwise agreement (``OPT_AGREE``), the state
    ZeRO-1's ranks hold, then one Adam step of each at ``CHECK_LR``
    against float64 (``opt-train-check``). Returns the launches of the
    mixed FSDP run."""
    from distributed_llm_code_samples_tpu_torch import LR, optim
    from distributed_llm_code_samples_tpu_torch.data import (
        batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        FFNStackParams, init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        ffn_block, launch_counts, reset_launch_counts, stack_grads)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, fsdp, launch, make_mesh, train_ddp, train_ddp_zero1,
        train_fsdp, unshard_params, zero1)
    t_phase = time.perf_counter()
    d, n_layers, tokens = TRAIN["d_model"], TRAIN["n_layers"], TRAIN["tokens"]
    steps_n = TRAIN["steps"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TRAIN["random_seed"])
    params = init_ffn_stack(gen, d, n_layers)
    seeds = make_seed_schedule(RING_N * steps_n, TRAIN["random_seed"])
    mesh = make_mesh({DATA_AXIS: RING_N}, loopback=True)
    flops = 12 * tokens * d * FFN_DIM * n_layers * RING_N
    ring = dict(comm="pallas_ring")
    runs = {
        "ddp-adam": (train_ddp, dict(optimizer=optim.adam(), **ring)),
        "zero1-adam": (train_ddp_zero1, dict(optimizer=optim.adam(),
                                             return_state=True)),
        "fsdp-adam": (train_fsdp, dict(optimizer=optim.adam(), **ring)),
        "ddp-mixed-adamw": (train_ddp, dict(
            optimizer=optim.clipped(optim.adamw(), 1.0), mixed=True, **ring)),
        "fsdp-mixed-adamw": (train_fsdp, dict(
            optimizer=optim.clipped(optim.adamw(), 1.0, axis=DATA_AXIS),
            mixed=True, **ring))}
    layer_calls = n_layers * steps_n
    want = {"ddp-adam": {"ring_all_reduce": 2 * layer_calls,
                         "ppermute_dma": 1},
            "zero1-adam": {},
            "fsdp-adam": {"ring_all_gather": 4 * layer_calls,
                          "ring_reduce_scatter": 2 * layer_calls,
                          "ppermute_dma": 1}}
    want["ddp-mixed-adamw"] = want["ddp-adam"]
    want["fsdp-mixed-adamw"] = {"ring_all_gather[bf16]": 4 * layer_calls,
                                "ring_reduce_scatter": 2 * layer_calls,
                                "ppermute_dma": 1}

    def run(name, seeds, lr):
        trainer, kw = runs[name]

        def body(me, _):
            stamps = []

            def on_step(_):
                if me.rank == 0:
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
            out = trainer(params, seeds, tokens, d, me, lr=lr,
                          on_step=on_step, **kw)
            return out, stamps

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = launch(body, mesh, timeout=600)
        got = launch_counts()
        per_rank = [o[0] for o in outs]
        state = None
        if name.startswith("zero1"):
            state = [o[1] for o in per_rank]
            per_rank = [o[0] for o in per_rank]
        full = (unshard_params(per_rank) if name.startswith("fsdp")
                else per_rank[0])
        return full, state, outs[0][1], t0, got

    finals, launches = {}, {}
    for name in runs:
        full, state, stamps, t0, got = run(name, seeds, LR)
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        row = dict(run=f"{name}-loopback", ranks=RING_N, mode="loopback",
                   optimizer=runs[name][1]["optimizer"].name,
                   mixed=runs[name][1].get("mixed", False),
                   steps_per_rank=len(steps), tokens_per_rank_step=tokens,
                   median_step_ms=1e3 * med, first_step_ms=1e3 * steps[0],
                   tokens_per_s=RING_N * tokens / med,
                   model_tflops_per_s=flops / med / 1e12,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 2 ** 30, kernel_launches=got, card=card)
        if state is not None:
            row["state_layers_per_rank"] = [int(s.mu.w1.shape[0])
                                            for s in state]
            row["state_gb_per_rank"] = [
                sum(4 * x.numel() for x in optim.tree_tensors(s)) / 2 ** 30
                for s in state]
            check(all(s.mu.w1.shape[0] == n_layers // RING_N
                      and s.nu.w2.shape[0] == n_layers // RING_N
                      for s in state),
                  f"ZeRO-1's ranks hold {row['state_layers_per_rank']} "
                  f"layers of Adam state, not {n_layers // RING_N} each")
        print("opt-train-run " + json.dumps(row), flush=True)
        check(got == want[name], f"{name} loopback: launches {got}, "
              f"expected {want[name]}")
        check(all(bool(torch.isfinite(t).all()) for t in full),
              f"{name}: the trained params are not finite")
        finals[name], launches[name] = full, got
        del state

    drift = {f"{a}/{b}": opt_agree(finals[a], finals[b], params)[0]
             for a, others in OPT_CHAINS for b in others}
    del finals

    def one_step(name, p, state, s):
        trainer, kw = runs[name]
        kind = name.split("-")[0]
        shard = {"zero1": zero1.shard_state,
                 "fsdp": fsdp.shard_state}.get(kind)

        def body(me, _):
            k = dict(kw, return_state=True)
            if state is not None:
                k["opt_state"] = shard(state, me) if shard else state
            return trainer(p, s, tokens, d, me, lr=LR, **k)

        outs = launch(body, mesh, timeout=600)
        if kind == "fsdp":
            return (unshard_params([o[0] for o in outs]),
                    fsdp.unshard_state([o[1] for o in outs]))
        if kind == "zero1":
            return outs[0][0], zero1.unshard_state([o[1] for o in outs])
        return outs[0]

    pairs = opt_step_chains(one_step, params, seeds, RING_N, steps_n)

    # one Adam step a rank at CHECK_LR from the same params: each
    # strategy's update against float64's (and the f32 matmul path's)
    g64 = g32 = None
    p64 = FFNStackParams(*(t.double() for t in params))
    for seed in seeds[:RING_N]:
        x, dl = batch_from_seed(seed, tokens, d, device=params.w1.device)
        g = stack_grads(p64.w1, p64.w2, x.double(), dl.double(),
                        block=ffn_block)[1]
        g64 = g if g64 is None else tuple(a + b for a, b in zip(g64, g))
        g = stack_grads(params.w1, params.w2, x, dl, block=ffn_block)[1]
        g32 = g if g32 is None else tuple(a + b for a, b in zip(g32, g))
    adam = optim.adam()
    want64 = adam.update(FFNStackParams(*g64), adam.init(p64), p64,
                         CHECK_LR)[0]
    del g64, p64
    base = adam.update(FFNStackParams(*g32), adam.init(params), params,
                       CHECK_LR)[0]
    del g32

    def errs(got):
        return [update_err(torch, g, w, p0)
                for g, w, p0 in zip(got, want64, params)]

    base_errs = errs(base)
    del base
    row = dict(mode="loopback", check_lr=CHECK_LR,
               update_ratio_limit=UPDATE_RATIO, agree=pairs,
               agree_limit=OPT_AGREE, chain_steps=steps_n,
               free_run_drift=drift,
               f32_matmul_update_err_vs_f64=base_errs)
    ratios = {}
    for name in ("ddp-adam", "zero1-adam", "fsdp-adam"):
        e = errs(run(name, seeds[:RING_N], CHECK_LR)[0])
        row[f"{name}_update_err_vs_f64"] = e
        ratios[name] = max(a / b for a, b in zip(e, base_errs))
    unchanged = min(1.0 / b for b in base_errs)
    row.update(update_err_ratio_max=ratios, unchanged_ratio_min=unchanged,
               phase_s=time.perf_counter() - t_phase, card=card)
    print("opt-train-check " + json.dumps(row), flush=True)
    for pair, a in pairs.items():
        check(a <= OPT_AGREE, f"{pair}: their updates differ by {a:.2e}")
    for name, ratio in ratios.items():
        check(ratio <= UPDATE_RATIO, f"{name}'s Adam update {ratio:.2f}x as "
              "far from float64 as the f32 matmul path's")
    check(unchanged > UPDATE_RATIO,
          "the update check cannot tell unchanged weights from trained")
    return launches["fsdp-mixed-adamw"]


def opt_step_chains(one_step, params, seeds, n, steps):
    """Each chain of ``OPT_CHAINS``: its strategy's ``steps`` steps from
    ``params``, and at each step every other strategy's one step from the
    same params and optimizer state (``one_step(name, p, state, seeds) ->
    (full params, full state)``, ``n`` seeds a step); returns the largest
    ``opt_agree`` share of each pair over the steps."""
    agree = {}
    for ref, others in OPT_CHAINS:
        p, state = params, None
        for t in range(steps):
            s = seeds[t * n:(t + 1) * n]
            outs = {name: one_step(name, p, state, s)
                    for name in (ref,) + others}
            for name in others:
                key = f"{ref}/{name}"
                agree[key] = max(agree.get(key, 0.0), opt_agree(
                    outs[ref][0], outs[name][0], p)[0])
            p, state = outs[ref]
            del outs
    return agree


def opt_agree(a, b, p0):
    """``(|a - b| / |a - p0|, max |a - b| / max |a - p0|)`` over every
    leaf of two runs' params from the start ``p0`` (``OPT_AGREE``)."""
    num = sum(float((x.double() - y.double()).norm() ** 2)
              for x, y in zip(a, b)) ** 0.5
    den = sum(float((x.double() - p.double()).norm() ** 2)
              for x, p in zip(a, p0)) ** 0.5
    peak = max(float((x - y).abs().max()) for x, y in zip(a, b))
    moved = max(float((x - p).abs().max()) for x, p in zip(a, p0))
    return num / den, peak / moved


def opt_lm_phase(torch, np, card):
    """``train_lm_single`` at ``LM`` with AdamW, under ``mixed`` (the bf16
    trunk: the flash kernels on bf16 storage) and in f32, flash attention
    and the fused head, 8 steps each (``opt-lm-run``); the mixed run's
    launches (12 bf16 forwards, dkv and dq a step), and its loss against
    the f32 run's at the start and after the steps (``opt-lm-check``).
    Returns the mixed run's launches."""
    from distributed_llm_code_samples_tpu_torch import LR, optim
    from distributed_llm_code_samples_tpu_torch.data import (
        lm_batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.lm import (
        init_lm, lm_leaves, lm_loss)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        resolve_attn, resolve_head, train_lm_single)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM["random_seed"])
    params = init_lm(gen, LM["vocab"], LM["d_model"], LM["n_layers"],
                     LM["seq_len"], n_heads=LM["n_heads"])
    seeds = make_seed_schedule(LM["steps"], LM["random_seed"])
    flops = LM_BLOCK_FLOPS + LM_HEAD_FLOPS
    steps_n, layers = LM["steps"], LM["n_layers"]

    def run(mixed):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        stamps = []

        def on_step(_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        t0 = time.perf_counter()
        out = train_lm_single(params, seeds, LM_TOKENS, LM["d_model"],
                              lr=LR, seq_len=LM["seq_len"],
                              n_heads=LM["n_heads"], attn_impl="flash",
                              head_impl="fused", optimizer=optim.adamw(),
                              mixed=mixed, on_step=on_step)
        launches = launch_counts()
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        print("opt-lm-run " + json.dumps(dict(
            run="mixed-adamw" if mixed else "f32-adamw", mixed=mixed,
            optimizer="adamw", attn_impl="flash", head_impl="fused",
            steps=len(steps), tokens_per_step=LM_TOKENS,
            median_step_ms=1e3 * med, first_step_ms=1e3 * steps[0],
            tokens_per_s=LM_TOKENS / med,
            model_tflops_per_s=flops / med / 1e12,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            kernel_launches=launches, card=card)), flush=True)
        return out, launches

    mixed_out, launches = run(True)
    f32_out, f32_launches = run(False)
    want = {"flash_attn_fwd[bf16]": layers * steps_n,
            "flash_attn_dkv[bf16]": layers * steps_n,
            "flash_attn_dq[bf16]": layers * steps_n,
            "head_xent_stats": steps_n, "head_xent_bwd": steps_n}
    b = LM_TOKENS // LM["seq_len"]
    toks, tgts = lm_batch_from_seed(int(seeds[0]), b, LM["seq_len"],
                                    LM["vocab"], device="cuda")
    attn, head = resolve_attn("flash"), resolve_head("fused")
    with torch.no_grad():
        loss = {(when, mixed): float(lm_loss(p, toks, tgts, LM["n_heads"],
                                             attn, head, mixed=mixed))
                for when, p in (("start", params), ("end-mixed", mixed_out),
                                ("end-f32", f32_out))
                for mixed in (True, False)}
    start_rel = abs(loss["start", True] - loss["start", False]) / \
        abs(loss["start", False])
    end_rel = abs(loss["end-mixed", True] - loss["end-f32", False]) / \
        abs(loss["end-f32", False])
    f32_leaves = all(t.dtype == torch.float32 for t in lm_leaves(mixed_out))
    print("opt-lm-check " + json.dumps(dict(
        launches=launches, want_launches=want,
        f32_run_launches=f32_launches,
        loss_start_mixed=loss["start", True],
        loss_start_f32=loss["start", False],
        loss_end_mixed=loss["end-mixed", True],
        loss_end_f32=loss["end-f32", False], loss_start_rel=start_rel,
        loss_end_rel=end_rel, tol=MIXED_LOSS_TOL, params_f32=f32_leaves,
        card=card)), flush=True)
    check(launches == want, f"mixed LM run: launches {launches}, expected "
          f"{want}")
    check(all(np.isfinite(v) for v in loss.values()),
          f"an LM loss is not finite: {loss}")
    check(start_rel <= MIXED_LOSS_TOL and end_rel <= MIXED_LOSS_TOL,
          f"the mixed LM's loss differs from f32's by {start_rel:.2e} at "
          f"the start, {end_rel:.2e} after the steps")
    check(f32_leaves, "the mixed LM's params are not f32")
    return launches


# -- --dtype bfloat16: bf16 storage in the FFN kernels and the ring sums ----

# the bf16 forms of the FFN kernels: (name, source, the TPU kernel, flops
# per T d ffn)
DTYPE_FFN_KERNELS = (
    ("ffn_fwd[bf16]", "ffn_fwd.cu", "ops/pallas_ffn.py:129", 4),
    ("ffn_bwd_dx[bf16]", "ffn_bwd_dx.cu", "ops/pallas_ffn.py:190", 6),
    ("ffn_bwd_dw[bf16]", "ffn_bwd_dw.cu", "ops/pallas_ffn.py:250", 8))
# the bf16 forms of the ring sums: (name, the TPU kernel)
DTYPE_RING_KERNELS = (
    ("ring_all_reduce[bf16]", "ops/pallas_ring.py:190"),
    ("ring_reduce_scatter[bf16]", "ops/pallas_ring.py:328"))
# ring cases on bf16: DDP's dw1 and dw2 a rank (the all-reduce), FSDP's
# full gradients before their scatter, and a ragged one each (chunks of
# 140 elements, 70 words: the scalar path)
DTYPE_RING_CASES = (("ring_all_reduce", "dw1", (FFN_DIM, D_MODEL)),
                    ("ring_all_reduce", "dw2", (D_MODEL, FFN_DIM)),
                    ("ring_reduce_scatter", "dw1", (FFN_DIM, D_MODEL)),
                    ("ring_reduce_scatter", "dw2", (D_MODEL, FFN_DIM)),
                    ("ring_all_reduce", "ragged", (RING_N * 7, 5, 4)),
                    ("ring_reduce_scatter", "ragged", (RING_N * 7, 5, 4)))
# A bf16 FFN call against float64 on its own bf16 inputs, with the
# kernel's arithmetic (the hidden activation, a or dh, rounded to bf16),
# the result rounded to bf16: each element within one bf16 step (at the
# larger of its magnitude and the output's RMS, so that an element near
# zero does not count a tiny step), and at most BF16_SHARE of them one
# step away (an f32 sum rounds to the other neighbour only where float64
# lies near a rounding tie; 0.03-0.54% on an NVIDIA H100). The control
# keeps the hidden activation in float64: its rounding moves some 42% of
# the outputs to the other neighbour, so it must differ in more than
# BF16_SHARE of them.
BF16_SHARE = 0.05
# bf16 training runs: loopback DDP and FSDP steps a rank (each launches
# exact counts; 4 keeps the phase near a minute), and the LR of the one
# step held against float64: at CHECK_LR a step's largest update is some
# 3e-5, a quarter of the bf16 step of a weight of 0.02, so no bf16 weight
# would move; at 1e4 the largest moves about 25 steps
BF16_DP_STEPS = 4
BF16_CHECK_LR = 1e4
# the CLI's single-device run at TRAIN's shape on bf16 params
CLI_M1_BF16 = ("-m", "1", "--pallas", "--dtype", "bfloat16", "-s",
               str(TRAIN["steps"]), "-bs", "8", "-n",
               str(TRAIN["tokens"] // 8), "-l", str(TRAIN["n_layers"]),
               "-d", str(TRAIN["d_model"]), "-r", str(TRAIN["random_seed"]))


def ffn_bf16_want(torch, name, dy, w1, w2, x, round_hidden=True):
    """``name``'s outputs in float64 on the bf16 inputs, the hidden
    activation rounded to bf16 as the kernel rounds it (not with
    ``round_hidden=False``, the control)."""
    x, dy, w1, w2 = (t.double() for t in (x, dy, w1, w2))

    def rnd(t):
        return t.to(torch.bfloat16).double() if round_hidden else t

    h = x @ w1.T
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    if name == "ffn_fwd":
        return (rnd(torch.where(h <= 0, zero, h)) @ w2.T,)
    dh = rnd(torch.where(h <= 0, zero, dy @ w2))
    if name == "ffn_bwd_dx":
        return (dh @ w1,)
    return dh.T @ x, dy.T @ rnd(torch.where(h <= 0, zero, h))


def bf16_steps(torch, got, want):
    """``(max steps, share that differ)`` of ``got`` (bf16) against
    ``want`` rounded to bf16, a step at the larger of an element's
    magnitude and ``want``'s RMS."""
    w = want.to(torch.bfloat16).double()
    g = got.double()
    rms = w.pow(2).mean().sqrt()
    _, e = torch.frexp(torch.maximum(torch.maximum(g.abs(), w.abs()), rms))
    steps = (g - w).abs() / torch.ldexp(torch.ones_like(w), e - 8)
    return float(steps.max()), float((g != w).double().mean())


def ffn_bf16_bound(flops, t, d, f, name):
    """Least time of one bf16 launch: the bytes it must move (inputs read
    and outputs written once, 2 bytes an element) over the HBM rate,
    against its flops at the bf16 tensor-core rate (``bound_ms``) and at
    the f32 rate of the CUDA cores the kernel's simple products run on
    (``bound_f32_ms``)."""
    elems = {"ffn_fwd": 2 * t * d + 2 * d * f,
             "ffn_bwd_dx": 3 * t * d + 2 * d * f,
             "ffn_bwd_dw": 2 * t * d + 4 * d * f}[name]
    t_bytes = 2 * elems / HBM_BYTES_PER_S * 1e3
    t_bf16 = flops / BF16_FLOPS_PER_S * 1e3
    t_f32 = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bf16, t_bytes), "operations" if t_bf16 >= t_bytes
            else "bytes", max(t_f32, t_bytes))


def ffn_bf16_staging(ff, name, t, d, f):
    """Bytes of a kernel's f32 scratch at one slice: its padded f32
    copies of the operands (``copy_bytes``, what bf16 storage stages in
    f32) and the f32 hidden activation (``hidden_bytes``)."""
    pieces = {"ffn_fwd": ff.fwd_scratch, "ffn_bwd_dx": ff.dx_scratch,
              "ffn_bwd_dw": ff.dw_scratch}[name](t, d, f, (1, 0))
    hidden = sum(4 * (pieces[k][0][0] * pieces[k][0][1])
                 for k in ("aT", "dhT", "a", "dh") if k in pieces)
    return dict(copy_bytes=4 * pieces["total"] - hidden,
                hidden_bytes=hidden)


def ffn_cublas_bf16(torch, name, dy, w1, w2, x):
    """The same function from cuBLAS bf16 products (tensor cores, f32
    sums, every product rounded to bf16): the library yardstick."""
    h = x @ w1.T
    if name == "ffn_fwd":
        return torch.relu(h) @ w2.T
    dh = (dy @ w2) * (h > 0)
    if name == "ffn_bwd_dx":
        return dh @ w1
    return dh.T @ x, dy.T @ torch.relu(h)


def dtype_bf16_kernel_phase(torch, np, timer):
    """The bf16 forms of this slice's kernels, each against its plain
    version on the card: the three FFN kernels at the main and ragged
    shapes on bf16 operands (against the plain version and against
    float64 with the kernel's roundings, ``BF16_SHARE``, with the
    unrounded-hidden control; timed beside the f32 kernel on the same
    values and the cuBLAS bf16 composition), then the all-reduce and the
    reduce-scatter of bf16 in loopback, bit for bit against the plain
    ring, timed beside the f32 call on the same values."""
    from distributed_llm_code_samples_tpu_torch.ops import fused_ffn as ff
    from distributed_llm_code_samples_tpu_torch.ops import ring
    fns = {"ffn_fwd": (lambda dy, *w: ff.ffn_fwd_fused(*w),
                       lambda dy, *w: ff.ffn_fwd_ref(*w)),
           "ffn_bwd_dx": (ff.ffn_bwd_dx_fused, ff.ffn_bwd_dx_ref),
           "ffn_bwd_dw": (ff.ffn_bwd_dw_fused, ff.ffn_bwd_dw_ref)}

    def tup(v):
        return v if isinstance(v, tuple) else (v,)

    rows = []
    for n, (shape, t, d, f) in enumerate(FFN_SHAPES[:2]):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(700 + n)
        w1 = (2e-2 * torch.randn(f, d, generator=gen, device="cuda"))
        w2 = (2e-2 * torch.randn(d, f, generator=gen, device="cuda"))
        x = torch.randn(t, d, generator=gen, device="cuda")
        dy = 0.1 * torch.randn(t, d, generator=gen, device="cuda")
        args = tuple(a.bfloat16() for a in (dy, w1, w2, x))
        args32 = tuple(a.float() for a in args)
        for kname, _, _, mult in DTYPE_FFN_KERNELS:
            name = kname.split("[")[0]
            kern = partial(fns[name][0], *args)
            plain = partial(fns[name][1], *args)
            got, again = tup(kern()), tup(kern())
            torch.cuda.synchronize()
            want = tup(plain())
            want64 = ffn_bf16_want(torch, name, *args)
            control64 = ffn_bf16_want(torch, name, *args,
                                      round_hidden=False)
            vs_plain = [bf16_steps(torch, g, w) for g, w in zip(got, want)]
            vs64 = [bf16_steps(torch, g, w) for g, w in zip(got, want64)]
            control = [bf16_steps(torch, g, w)
                       for g, w in zip(got, control64)]
            same = all(torch.equal(g.view(torch.int16), a.view(torch.int16))
                       for g, a in zip(got, again))
            dtypes = all(g.dtype == torch.bfloat16 for g in got)
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            flops = mult * t * d * f
            b_ms, b_by, b32_ms = ffn_bf16_bound(flops, t, d, f, name)
            ms = timer.ms(kern)
            row = dict(
                kernel=kname, shape=shape, T=t, d=d, ffn=f,
                max_abs_err=max(float((g.float() - w.float()).abs().max())
                                for g, w in zip(got, want)),
                steps_vs_plain_max=max(s[0] for s in vs_plain),
                share_vs_plain=max(s[1] for s in vs_plain),
                steps_vs_f64_max=max(s[0] for s in vs64),
                share_vs_f64=max(s[1] for s in vs64),
                control_share_vs_f64=min(s[1] for s in control),
                share_limit=BF16_SHARE, deterministic=same,
                ok=finite and same and dtypes
                and max(s[0] for s in vs_plain + vs64) <= 1
                and max(s[1] for s in vs_plain + vs64) <= BF16_SHARE
                and min(s[1] for s in control) > BF16_SHARE,
                ms=ms, plain_ms=timer.ms(plain),
                f32_ms=timer.ms(partial(fns[name][0], *args32)),
                library_ms=timer.ms(partial(ffn_cublas_bf16, torch, name,
                                            *args)),
                bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b32_ms,
                tflops_per_s=flops / ms / 1e9,
                **ffn_bf16_staging(ff, name, t, d, f))
            rows.append(row)
            print("bf16-ffn-kernel-case " + json.dumps(row), flush=True)
            del got, again, want, want64, control64
        del w1, w2, x, dy, args, args32

    ws = ring.PeerWorkspace(4 * FFN_DIM * D_MODEL, "cuda", n=RING_N)
    try:
        for k, (op, tag, shape) in enumerate(DTYPE_RING_CASES):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(720 + k)
            xs = [torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for _ in range(RING_N)]
            got = ring.loopback(op, xs, ws)
            again = ring.loopback(op, xs, ws)
            torch.cuda.synchronize()
            ws.check()
            want = ring.loopback_ref(op, xs)
            bits = all(g.dtype == torch.bfloat16 and torch.equal(
                g.view(torch.int16), w.view(torch.int16))
                for g, w in zip(got, want))
            same = all(torch.equal(g.view(torch.int16), a.view(torch.int16))
                       for g, a in zip(got, again))
            xs32 = [x.float() for x in xs]
            b_ms, b_by = ring_loopback_bound(op, 2 * xs[0].numel(), RING_N)
            row = dict(kernel=op + "[bf16]", shape=tag, dims=list(shape),
                       ranks=RING_N, mode="loopback",
                       max_abs_err=max(float((g.float() - w.float()).abs()
                                             .max())
                                       for g, w in zip(got, want)),
                       bit_identical=bits, deterministic=same,
                       ok=bits and same,
                       ms=timer.ms(lambda: ring.loopback(op, xs, ws)),
                       ms_with_host=timer.ms(lambda: ring.loopback(op, xs,
                                                                   ws),
                                             with_host=True),
                       plain_ms=timer.ms(lambda: ring.loopback_ref(op, xs)),
                       f32_ms=timer.ms(lambda: ring.loopback(op, xs32, ws)),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            rows.append(row)
            print("bf16-ring-kernel-case " + json.dumps(row), flush=True)
            del xs, xs32, got, again, want
    finally:
        ws.close()
    return rows


@contextlib.contextmanager
def bit_checked_ring_calls(torch, ring):
    """Within the block every loopback ring call is held bit for bit
    against its plain version on the same inputs, as it happens: yields
    the list of ``(kernel, dtype, bit_identical)``."""
    seen, inner = [], ring.loopback

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def launch(op, xs, ws):
        outs = inner(op, xs, ws)
        want = ring.loopback_ref(op, xs)
        seen.append((op, str(xs[0].dtype), all(
            o.dtype == w.dtype and torch.equal(bits(o), bits(w))
            for o, w in zip(outs, want))))
        return outs

    ring.loopback = launch
    try:
        yield seen
    finally:
        ring.loopback = inner


def dtype_bf16_train_phase(torch, np, card):
    """``--dtype bfloat16`` at ``TRAIN``'s width: ``train_single`` through
    the kernels and through the cuBLAS bf16 blocks (8 steps), the CLI's
    ``-m 1 --pallas --dtype bfloat16`` (``CLI_M1_BF16``), one step's
    gradients against float64, then DDP and FSDP over the ring kernels on
    ``RING_N`` loopback ranks (``BF16_DP_STEPS`` steps a rank), every
    ring call of one step bit for bit against its plain version, and
    DDP's one step at ``BF16_CHECK_LR`` against FSDP's. Returns the
    launches of the kernel runs."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        ffn_block, fused_ffn_block, launch_counts, reset_launch_counts, ring,
        stack_grads)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, launch, make_mesh, train_ddp, train_fsdp, train_single,
        unshard_params)
    d, n_layers, tokens = TRAIN["d_model"], TRAIN["n_layers"], TRAIN["tokens"]
    steps_n = TRAIN["steps"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TRAIN["random_seed"])
    params = init_ffn_stack(gen, d, n_layers, dtype=torch.bfloat16)
    seeds = make_seed_schedule(steps_n, TRAIN["random_seed"])
    flops = 12 * tokens * d * FFN_DIM * n_layers

    def run(label, **kw):
        torch.cuda.synchronize()
        reset_launch_counts()
        stamps = []

        def on_step(_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        t0 = time.perf_counter()
        out = train_single(params, seeds, tokens, d, lr=LR, on_step=on_step,
                           **kw)
        got = launch_counts()
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        print("bf16-train-run " + json.dumps(dict(
            run=label, steps=len(steps), tokens_per_step=tokens,
            median_step_ms=1e3 * med, first_step_ms=1e3 * steps[0],
            tokens_per_s=tokens / med, model_tflops_per_s=flops / med / 1e12,
            out_dtype=str(out.w1.dtype),
            finite=all(bool(torch.isfinite(t.float()).all()) for t in out),
            kernel_launches=got, card=card)), flush=True)
        check(out.w1.dtype == torch.bfloat16, f"{label}: params left bf16")
        return got

    launches = run("pallas-bf16", use_pallas=True)
    matmul = run("matmul-bf16")
    for name, _, _, _ in DTYPE_FFN_KERNELS:
        check(launches.get(name, 0) == n_layers * steps_n,
              f"bf16 kernel run: {launches.get(name, 0)} launches of "
              f"{name}, expected {n_layers * steps_n}")
    check(not any(launches.get(k[0].split("[")[0]) for k in
                  DTYPE_FFN_KERNELS) and not matmul,
          f"bf16 runs launched f32 kernels: {launches} {matmul}")
    cli = cli_m0_phase(card, CLI_M1_BF16, "bf16-cli-m1")[0]
    check(cli["dtype"] == "bfloat16" and cli["kernel_launches"] == {
        k[0]: n_layers * steps_n for k in DTYPE_FFN_KERNELS},
        f"cli -m 1 --dtype bfloat16 launched {cli['kernel_launches']}")

    # one step's gradients, per layer, against float64 on the same bf16
    # params and batch (GRAD_RATIO over the cuBLAS bf16 path's error)
    x, dl = batch_from_seed(seeds[0], tokens, d, dtype=torch.bfloat16,
                            device="cuda")
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

    # DDP and FSDP over the ring kernels in loopback
    mesh = make_mesh({DATA_AXIS: RING_N}, loopback=True)
    dp_seeds = make_seed_schedule(RING_N * BF16_DP_STEPS,
                                  TRAIN["random_seed"])
    trainers = {"ddp": train_ddp, "fsdp": train_fsdp}

    def dp_run(name, seeds, lr):
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
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = launch(body, mesh, timeout=600)
        full = (unshard_params([o[0] for o in outs]) if name == "fsdp"
                else outs[0][0])
        return full, outs[0][1], t0, launch_counts()

    layer_calls = n_layers * BF16_DP_STEPS
    want = {"ddp": {"ring_all_reduce[bf16]": 2 * layer_calls,
                    "ppermute_dma": 1},
            "fsdp": {"ring_all_gather[bf16]": 4 * layer_calls,
                     "ring_reduce_scatter[bf16]": 2 * layer_calls,
                     "ppermute_dma": 1}}
    for name in ("ddp", "fsdp"):
        full, stamps, t0, got = dp_run(name, dp_seeds, LR)
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        print("bf16-ring-train-run " + json.dumps(dict(
            run=f"{name}-bf16-loopback", ranks=RING_N, mode="loopback",
            steps_per_rank=len(steps), tokens_per_rank_step=tokens,
            median_step_ms=1e3 * med, first_step_ms=1e3 * steps[0],
            tokens_per_s=RING_N * tokens / med,
            model_tflops_per_s=RING_N * flops / med / 1e12,
            out_dtype=str(full.w1.dtype), kernel_launches=got, card=card)),
            flush=True)
        check(got == want[name], f"{name} bf16 loopback: launches {got}, "
              f"expected {want[name]}")
        check(full.w1.dtype == torch.bfloat16, f"{name}: params left bf16")
        launches.update({k: v for k, v in got.items() if "[bf16]" in k})
        del full

    # one step a rank at BF16_CHECK_LR, every ring call bit for bit
    with bit_checked_ring_calls(torch, ring) as calls:
        ddp = dp_run("ddp", dp_seeds[:RING_N], BF16_CHECK_LR)[0]
        fsdp = dp_run("fsdp", dp_seeds[:RING_N], BF16_CHECK_LR)[0]
    moved = float((ddp.w1 != params.w1).double().mean())
    apart = max(bf16_steps(torch, a, b.double())[0]
                for a, b in zip(ddp, fsdp))
    print("bf16-train-check " + json.dumps(dict(
        grad_err_vs_f64_kernel_max=max(kernel_err),
        grad_err_vs_f64_matmul_max=max(matmul_err),
        grad_err_ratio_max=ratio, grad_ratio_limit=GRAD_RATIO,
        ring_calls={f"{op}/{dt}": sum(c[0] == op and c[1] == dt
                                      for c in calls)
                    for op, dt in sorted({c[:2] for c in calls})},
        ring_calls_bit_identical=all(c[2] for c in calls),
        check_lr=BF16_CHECK_LR, ddp_moved_share=moved,
        ddp_vs_fsdp_steps_max=apart, card=card)), flush=True)
    check(ratio <= GRAD_RATIO, f"bf16 kernel grads {ratio:.2f}x as far from "
          "float64 as the cuBLAS bf16 path's")
    check(all(c[2] for c in calls) and len(calls) == 2 + 8 * n_layers,
          f"a ring call of the bf16 trainers differs from its plain "
          f"version, or {len(calls)} calls")
    check(moved > 0.1, f"only {moved:.3f} of DDP's bf16 weights moved at "
          f"lr {BF16_CHECK_LR}")
    check(apart <= 2, f"DDP and FSDP in bf16 {apart} steps apart")
    return launches


def dtype_bf16_rows(cases, launches, mode="loopback"):
    """The bf16 forms of the FFN kernels and of the ring sums in the
    kernels line: launches from the main path's runs (``launches``), the
    rest from the main case of each."""
    rows = []
    forms = [(k[0], k[1], k[2]) for k in DTYPE_FFN_KERNELS] + [
        (k[0], "ring_collectives.cu", k[1]) for k in DTYPE_RING_KERNELS]
    for name, src, replaces in forms:
        mine = [c for c in cases if c["kernel"] == name]
        if not mine:
            continue
        main = next(c for c in mine if c["shape"] in ("main", "dw1"))
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_code_samples_tpu_torch/csrc/{src}",
            "replaces": f"distributed_llm_code_samples_tpu/{replaces}",
            "launches": None if launches is None else launches.get(name, 0),
            "mode": mode, "storage": "bf16",
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main["ms"], "f32_ms": main["f32_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "bound_f32_ms": main.get("bound_f32_ms"),
            "library_ms": main["library_ms"],
            "ok": all(c["ok"] for c in mine)})
    return rows


def dist_bf16_rank(mesh, payload):
    """One rank of ``--phase dist``'s bf16 part (its card is
    ``cuda:<rank>``): the all-reduce and the reduce-scatter of bf16 at
    DDP's and FSDP's gradient shapes across the cards, bit for bit
    against the plain ring (NCCL point to point), beside NCCL's bf16
    ``all_reduce`` and ``reduce_scatter_tensor`` (which add in their own
    order: their distance in bf16 steps is reported). Rank 0 prints;
    returns the cases."""
    import torch
    import torch.distributed as dist

    from distributed_llm_code_samples_tpu_torch.ops import ring
    r, n, dev = mesh.rank, mesh.size, mesh.torch_device
    timer = Timer(torch)
    token = torch.zeros(1, device=dev)
    aligned = partial(timer.ms, align=partial(dist.all_reduce, token))
    rg = mesh.ring(4 * FFN_DIM * D_MODEL)
    cases = []
    for k, (op, tag, shape) in enumerate(DTYPE_RING_CASES[:4]):
        gen = torch.Generator(device=dev)
        gen.manual_seed(740 + 10 * k + r)
        x = torch.randn(shape, generator=gen, device=dev).bfloat16()
        kern = partial(getattr(ring, op), x, rg)
        plain = partial(getattr(ring, op + "_ref"), x, rg)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        mesh.check()
        want = plain()
        nccl = _nccl_call(torch, dist, op, x)
        row = dict(kernel=op + "[bf16]", shape=tag, dims=list(shape),
                   ranks=n, mode="4 cards",
                   bit_identical_to_plain=torch.equal(
                       got.view(torch.int16), want.view(torch.int16)),
                   deterministic=torch.equal(got.view(torch.int16),
                                             again.view(torch.int16)),
                   max_abs_err=float((got.float() - want.float()).abs()
                                     .max()),
                   nccl_steps_max=bf16_steps(torch, nccl, got.double())[0],
                   ms=aligned(kern),
                   ms_with_host=timer.ms(kern, with_host=True),
                   plain_ms=aligned(plain),
                   f32_ms=aligned(partial(getattr(ring, op), x.float(), rg)),
                   library_ms=aligned(partial(_nccl_call, torch, dist, op,
                                              x)),
                   library_f32_ms=aligned(partial(_nccl_call, torch, dist,
                                                  op, x.float())))
        row["bound_ms"], row["bound_by"] = ring_dist_bound(
            op, 2 * x.numel(), n)
        every = [None] * n
        dist.all_gather_object(every, {key: row[key] for key in (
            "ms", "bit_identical_to_plain", "deterministic")})
        row["ms_max_over_ranks"] = max(e["ms"] for e in every)
        row["ok"] = all(e["bit_identical_to_plain"] and e["deterministic"]
                        for e in every)
        if r == 0:
            print("dist-bf16-kernel-case " + json.dumps(row), flush=True)
        cases.append(row)
        del x, got, again, want, nccl
    return cases


# -- --dtype bfloat16 of the LM, transformer and MoE methods -----------------

# the bf16 forms of this slice: (name, source, the TPU kernel)
LM_BF16_KERNELS = (
    ("head_xent_stats[bf16]", "head_xent_fwd.cu", "ops/pallas_xent.py:186"),
    ("head_xent_bwd[bf16]", "head_xent_bwd.cu", "ops/pallas_xent.py:245"),
    ("ppermute_dma[bf16]", "ring_collectives.cu", "ops/pallas_ring.py:151"),
    ("all_to_all_dma[bf16]", "ring_collectives.cu", A2A_REPLACES))
# the head on bf16 storage: (tag, N, d, V, target shift) at the LM's shape
# and on one TP rank's vocab shard (rank 1's 12576 rows: the targets
# shifted by its first row, three in four of them outside the shard)
LM_BF16_HEAD_SHAPES = (
    ("main", LM_TOKENS, LM["d_model"], LM["vocab"], 0),
    ("shard", LM_TOKENS, LM["d_model"], LM["vocab"] // LMTP_N,
     LM["vocab"] // LMTP_N))
# the hop and the all-to-all on bf16 in loopback, bit for bit: (op, tag,
# per-rank shape) at the hop's main block and EP's dispatch operand, and
# one whose chunk holds an odd element count (105 and 15; they move
# through copies padded by one element a chunk)
LM_BF16_MOVE_CASES = (
    ("ppermute_dma", "block", (D_MODEL, FFN_DIM)),
    ("ppermute_dma", "odd", (3, 5, 7)),
    ("all_to_all_dma", "dispatch", (EP["n_experts"], EP_CAP, EP["d_model"])),
    ("all_to_all_dma", "odd", (EP_N, 3, 5)))
LM_BF16_MOVE_MAIN = {"ppermute_dma": "block", "all_to_all_dma": "dispatch"}
# a workspace with room for the largest of these cases in f32 (the f32
# call beside each bf16 one)
LM_BF16_MOVE_BYTES = max(4 * EP["n_experts"] * EP_CAP * EP["d_model"],
                         4 * D_MODEL * FFN_DIM)
# the bf16 EP runs' LR: at the package's 1e-5 no bf16 weight of 0.02
# moves (its step is 2^-13), so two runs would agree trivially; 1e-4
# moves them and stays finite (1e-3 overflows within 8 steps on an
# NVIDIA H100)
LM_BF16_EP_LR = 1e-4
def head_bf16_bound(name, n, d, v):
    """Least time of one head call on bf16 storage: its flops (one product
    for the statistics, three for the backward) at the bf16 tensor-core
    rate (``bound_ms``) and at the f32 rate of the CUDA cores its
    products run on (``bound_f32_ms``), against the bytes it must move:
    h and w (and dh, dw) 2 bytes an element, targets, lse and tz 4."""
    stats = name.startswith("head_xent_stats")
    flops = (2 if stats else 6) * n * d * v
    nbytes = (2 * (n * d + v * d) + 12 * n if stats
              else 4 * (n * d + v * d) + 8 * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_bf16 = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bf16, t_bytes), "operations" if t_bf16 >= t_bytes
            else "bytes", max(flops / F32_FLOPS_PER_S * 1e3, t_bytes))


def head_bf16_want(torch, stats, h, w, tgt, lse=None, control=False):
    """The head's outputs in float64 on the bf16 ``h``, ``w``: the
    statistics (``stats``) of the exact logits, or the backward as the
    kernels compute it, ``dz`` rounded to bf16 before the products. The
    controls that must fail: the statistics of the logits rounded to bf16
    (what the plain version computed on bf16 before this slice), the
    backward with ``dz`` not rounded."""
    h64, w64 = h.double(), w.double()
    z = h64 @ w64.T
    n, v = z.shape
    t = tgt.long()
    valid = (t >= 0) & (t < v)
    if stats:
        if control:
            z = z.to(torch.bfloat16).double()
        m = z.amax(dim=-1, keepdim=True)
        lse64 = (m + (z - m).exp().sum(dim=-1, keepdim=True).log())[:, 0]
        tz = z.gather(-1, torch.where(valid, t, 0)[:, None])[:, 0]
        return lse64, torch.where(valid, tz, torch.zeros_like(tz))
    p = z.sub_(lse.double()[:, None]).exp_()
    rows = valid.nonzero()[:, 0]
    p[rows, t[rows]] -= 1.0
    dz = p.div_(n)
    if not control:
        dz = dz.to(torch.bfloat16).double()
    return dz @ w64, dz.T @ h64


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, the largest of the outputs."""
    return max(float((g.double() - w.double()).abs().max())
               / max(float(w.double().abs().max()), 1e-300)
               for g, w in zip(got, want))


def lm_bf16_kernel_phase(torch, np, timer):
    """The bf16 forms of this slice's kernels on the card: the head's
    statistics and backward at ``LM_BF16_HEAD_SHAPES`` against float64
    (``FFN_TOL`` for the f32 statistics; the bf16 gradients within one
    bf16 step in at most ``BF16_SHARE`` of them; each with a control that
    must fail) and against the plain version on the card, timed beside
    the f32 kernel on the same values (``lm-bf16-head-case``); the hop
    and the all-to-all of bf16 in loopback at ``LM_BF16_MOVE_CASES``, bit
    for bit against their plain versions, timed beside the f32 call
    (``lm-bf16-move-case``)."""
    from distributed_llm_code_samples_tpu_torch.ops import fused_xent as fx
    from distributed_llm_code_samples_tpu_torch.ops import ring
    tol = FFN_TOL[False]
    rows = []
    for k, (tag, n, d, v, shift) in enumerate(LM_BF16_HEAD_SHAPES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(760 + k)
        h = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(v, d, generator=gen,
                                device="cuda")).bfloat16()
        tgt = torch.randint(0, LM["vocab"], (n,), generator=gen,
                            device="cuda") - shift
        tgt[-1] = v - 1                          # the last column
        dy = torch.tensor(1.0, device="cuda")
        lse = fx.head_xent_stats_ref(h, w, tgt)[0]
        forms = (
            ("head_xent_stats[bf16]",
             partial(fx.head_xent_stats, h, w, tgt),
             partial(fx.head_xent_stats_ref, h, w, tgt),
             partial(fx.head_xent_stats, h.float(), w.float(), tgt)),
            ("head_xent_bwd[bf16]",
             partial(fx.head_xent_bwd, dy, h, w, tgt, lse),
             partial(fx.head_xent_bwd_ref, dy, h, w, tgt, lse),
             partial(fx.head_xent_bwd, dy, h.float(), w.float(), tgt, lse)))
        for name, kern, plain, f32 in forms:
            stats = name.startswith("head_xent_stats")
            got, again = kern(), kern()
            torch.cuda.synchronize()
            want = plain()
            want64 = head_bf16_want(torch, stats, h, w, tgt, lse)
            control64 = head_bf16_want(torch, stats, h, w, tgt, lse,
                                       control=True)
            same = all(torch.equal(g.view(torch.int16), a.view(torch.int16))
                       for g, a in zip(got, again))
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            out_dtype = torch.float32 if stats else torch.bfloat16
            dtypes = all(g.dtype == out_dtype for g in got)
            b_ms, b_by, b32_ms = head_bf16_bound(name, n, d, v)
            row = dict(kernel=name, shape=tag, dims=[n, d, v],
                       target_shift=shift,
                       targets_in_range=float(((tgt >= 0) & (tgt < v))
                                              .double().mean()),
                       max_abs_err=max(float((g.double() - x.double()).abs()
                                             .max())
                                       for g, x in zip(got, want)),
                       deterministic=same, out_dtype=str(got[0].dtype))
            if stats:
                row.update(rel_err_vs_plain=rel_err(got, want),
                           rel_err_vs_f64=rel_err(got, want64),
                           control_rel_err_vs_f64=rel_err(got, control64),
                           tol=tol)
                ok = (row["rel_err_vs_plain"] <= tol
                      and row["rel_err_vs_f64"] <= tol
                      and row["control_rel_err_vs_f64"] > tol)
            else:
                vs_plain = [bf16_steps(torch, g, x.double())
                            for g, x in zip(got, want)]
                vs64 = [bf16_steps(torch, g, x) for g, x in zip(got, want64)]
                ctl = [bf16_steps(torch, g, x)
                       for g, x in zip(got, control64)]
                row.update(steps_vs_plain_max=max(s[0] for s in vs_plain),
                           share_vs_plain=max(s[1] for s in vs_plain),
                           steps_vs_f64_max=max(s[0] for s in vs64),
                           share_vs_f64=[s[1] for s in vs64],
                           control_share_vs_f64=[s[1] for s in ctl],
                           share_limit=BF16_SHARE)
                ok = (max(s[0] for s in vs_plain + vs64) <= 1
                      and max(s[1] for s in vs_plain + vs64) <= BF16_SHARE
                      and max(s[1] for s in ctl) > BF16_SHARE)
            ms = timer.ms(kern)
            row.update(ok=ok and finite and same and dtypes, ms=ms,
                       f32_ms=timer.ms(f32), plain_ms=timer.ms(plain),
                       bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b32_ms,
                       library_ms=None,
                       tflops_per_s=(2 if stats else 6) * n * d * v / ms
                       / 1e9)
            rows.append(row)
            print("lm-bf16-head-case " + json.dumps(row), flush=True)
            del got, again, want, want64, control64
        del h, w, tgt, lse

    ws = ring.PeerWorkspace(LM_BF16_MOVE_BYTES, "cuda", n=RING_N)
    try:
        for k, (op, tag, shape) in enumerate(LM_BF16_MOVE_CASES):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(780 + k)
            xs = [torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for _ in range(RING_N)]
            got = ring.loopback(op, xs, ws)
            again = ring.loopback(op, xs, ws)
            torch.cuda.synchronize()
            ws.check()
            want = ring.loopback_ref(op, xs)
            bits = all(g.dtype == torch.bfloat16 and g.shape == w.shape
                       and torch.equal(g.view(torch.int16),
                                       w.view(torch.int16))
                       for g, w in zip(got, want))
            same = all(torch.equal(g.view(torch.int16), a.view(torch.int16))
                       for g, a in zip(got, again))
            moved = not all(torch.equal(g, x) for g, x in zip(got, xs))
            xs32 = [x.float() for x in xs]
            b_ms, b_by = ring_loopback_bound(op, 2 * xs[0].numel(), RING_N)
            row = dict(kernel=op + "[bf16]", shape=tag, dims=list(shape),
                       ranks=RING_N, mode="loopback",
                       odd_chunk=ring._odd(op, xs[0], RING_N),
                       max_abs_err=max(float((g.float() - w.float()).abs()
                                             .max())
                                       for g, w in zip(got, want)),
                       bit_identical=bits, deterministic=same,
                       control_equal_to_input=not moved,
                       ok=bits and same and moved,
                       ms=timer.ms(lambda: ring.loopback(op, xs, ws)),
                       ms_with_host=timer.ms(lambda: ring.loopback(op, xs,
                                                                   ws),
                                             with_host=True),
                       plain_ms=timer.ms(lambda: ring.loopback_ref(op, xs)),
                       f32_ms=timer.ms(lambda: ring.loopback(op, xs32, ws)),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            rows.append(row)
            print("lm-bf16-move-case " + json.dumps(row), flush=True)
            del xs, xs32, got, again, want
    finally:
        ws.close()
    return rows


def lm_bf16_train_phase(torch, np, card):
    """``--dtype bfloat16`` of the LM, transformer and MoE methods at full
    width, 8 steps each with exact launches (``lm-bf16-train-run``):
    ``train_lm_single`` on bf16 params at ``LM`` under flash attention and
    the fused head; ``train_lm_tp`` (flash, fused head) and
    ``train_transformer_tp`` (flash) on ``LMTP_N`` loopback ranks;
    ``train_moe_ep(comm="pallas_a2a")`` at ``EP`` on ``EP_N`` loopback
    ranks through the kernel and through its plain version
    (``plain_loopback_calls``), whose routes and final weights must agree
    bit for bit. Then ``lm-bf16-train-check``: one step of the
    fused-head LM at ``CHECK_LR`` against a float64 step of the oracle
    ops, over the bf16 oracle-head path's error (``UPDATE_RATIO``, with
    unchanged weights as the control). Returns the launches (a rank's for
    the TP runs)."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models import (
        init_lm, lm_from_leaves, lm_leaves)
    from distributed_llm_code_samples_tpu_torch.models.moe import (
        init_moe_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, moe, reset_launch_counts, ring)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        EXPERT_AXIS, MODEL_AXIS, expert, launch, make_mesh, train_lm_single,
        train_moe_ep)
    t_phase = time.perf_counter()
    bf = torch.bfloat16
    d, layers, steps_n = LM["d_model"], LM["n_layers"], LM["steps"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM["random_seed"])
    params = init_lm(gen, LM["vocab"], d, layers, LM["seq_len"],
                     n_heads=LM["n_heads"], dtype=bf)
    seeds = make_seed_schedule(steps_n, LM["random_seed"])
    flash = {f"flash_attn_{k}[bf16]": layers * steps_n
             for k in ("fwd", "dq", "dkv")}
    head = {"head_xent_stats[bf16]": steps_n, "head_xent_bwd[bf16]": steps_n}

    def report(label, mode, steps, launches, want, flops, extra):
        med = statistics.median(steps[1:])
        print("lm-bf16-train-run " + json.dumps(dict(
            run=label, mode=mode, steps=len(steps), median_step_ms=1e3 * med,
            first_step_ms=1e3 * steps[0], model_tflops_per_s=flops / med
            / 1e12, kernel_launches=launches, card=card, **extra(med))),
            flush=True)
        check(launches == want, f"{label}: launches {launches}, expected "
              f"{want}")

    # the LM on one device
    stamps = []

    def on_step(_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_lm_single(params, seeds, LM_TOKENS, d, lr=LR,
                          seq_len=LM["seq_len"], n_heads=LM["n_heads"],
                          attn_impl="flash", head_impl="fused",
                          on_step=on_step)
    single = launch_counts()
    flops = LM_BLOCK_FLOPS + LM_HEAD_FLOPS
    report("lm-flash-fused-bf16", "1 card",
           [b - a for a, b in zip([t0] + stamps, stamps)], single,
           dict(flash, **head), flops, lambda med: dict(
               tokens_per_step=LM_TOKENS, tokens_per_s=LM_TOKENS / med,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 2 ** 30,
               out_dtypes=sorted({str(t.dtype) for t in lm_leaves(out)}),
               finite=all(bool(torch.isfinite(t.float()).all())
                          for t in lm_leaves(out))))
    check(all(t.dtype == bf and bool(torch.isfinite(t.float()).all())
              for t in lm_leaves(out)), "the bf16 LM's params left bf16 or "
          "are not finite")
    del out
    launches = dict(single)

    # TP of the LM and of the trunk on loopback ranks, a rank's launches
    mesh = make_mesh({MODEL_AXIS: LMTP_N}, loopback=True)
    tp = {}
    for label, family, p, kw, want in (
            ("lm-tp-flash-fused-bf16", "lm", params,
             dict(attn_impl="flash", head_impl="fused"), dict(flash, **head)),
            ("tf-tp-flash-bf16", "tf", params.blocks,
             dict(attn_impl="flash", sequence_parallel=False), flash)):
        torch.cuda.synchronize()
        reset_launch_counts()
        outs = launch(lmtp_rank, mesh, (family, p, seeds, LR, kw),
                      timeout=600)
        per_rank = {k: c / LMTP_N for k, c in launch_counts().items()}
        r0 = outs[0]
        shards = [t for o in outs for t in o["shards"]]
        check(all(t.dtype == bf and bool(torch.isfinite(t.float()).all())
                  for t in shards), f"{label}: shards left bf16 or are "
              "not finite")
        flops = LM_BLOCK_FLOPS + (LM_HEAD_FLOPS if family == "lm" else 0)
        report(label, "loopback", [b - a for a, b in zip(
            [r0["t0"]] + r0["stamps"], r0["stamps"])], per_rank, want, flops,
            lambda med: dict(mesh={MODEL_AXIS: LMTP_N},
                             tokens_per_step=LM_TOKENS,
                             tokens_per_s=LM_TOKENS / med))
        tp[label] = per_rank
        del outs, shards

    # EP through the all-to-all kernel on loopback ranks, and through its
    # plain version (the same exchanges in plain torch: what psum's
    # exchange moves; a loopback mesh has no process group for psum
    # itself, which --phase dist-bf16 runs on the cards): the same routes
    # and weights bit for bit
    gen.manual_seed(EP["random_seed"])
    ep_params = init_moe_stack(gen, EP["d_model"], EP["n_layers"],
                               EP["n_experts"], dtype=bf)
    ep_seeds = make_seed_schedule(EP_N * EP["steps"], EP["random_seed"])
    ep_mesh = make_mesh({EXPERT_AXIS: EP_N}, loopback=True)
    ep_kw = dict(lr=LM_BF16_EP_LR, capacity_factor=EP["capacity_factor"],
                 k=EP["k"], aux_coef=EP["aux_coef"], dispatch="dense",
                 comm="pallas_a2a")
    ep = {}
    for exchange in ("kernel", "plain"):
        ranks = {}

        def body(me, _):
            ranks[threading.get_ident()] = me.rank
            stamps = []

            def on_step(_):
                if me.rank == 0:
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
            out = train_moe_ep(ep_params, ep_seeds, EP["tokens"],
                               EP["d_model"], me, on_step=on_step, **ep_kw)
            return out, stamps

        with recorded_routes(torch, moe) as routes, \
                plain_loopback_calls(ring, exchange == "plain"):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            outs = launch(body, ep_mesh, timeout=600)
            got = launch_counts()
        full = expert.unshard_params([o[0] for o in outs])
        ep[exchange] = (full, {ranks[t]: recs for t, recs in routes.items()})
        want = ({"all_to_all_dma[bf16]": EP_A2A_PER_LAYER * EP["n_layers"]
                 * EP["steps"]} if exchange == "kernel" else {})
        report(f"ep-dense-{exchange}-exchange-bf16", "loopback",
               [b - a for a, b in zip([t0] + outs[0][1], outs[0][1])], got,
               want, 12 * EP["d_model"] * EP_FFN * EP["tokens"] * EP["k"]
               * EP["n_layers"], lambda med: dict(
                   ranks=EP_N, lr=LM_BF16_EP_LR,
                   tokens_per_step=EP["tokens"],
                   tokens_per_s=EP["tokens"] / med,
                   moved_share=float((full.w1 != ep_params.w1).double()
                                     .mean()),
                   finite=all(bool(torch.isfinite(t.float()).all())
                              for t in full)))
        if exchange == "kernel":
            launches.update(got)
        del outs, routes
    (a2a_w, a2a_r), (psum_w, psum_r) = ep["kernel"], ep["plain"]
    same_w = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                 for a, b in zip(a2a_w, psum_w))
    same_r = sorted(a2a_r) == sorted(psum_r) and all(
        len(a2a_r[r]) == len(psum_r[r]) and all(
            torch.equal(x, y) for x, y in zip(a2a_r[r], psum_r[r]))
        for r in a2a_r)
    moved = float((a2a_w.w1 != ep_params.w1).double().mean())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in a2a_w)
    del ep, a2a_w, psum_w, ep_params

    # one step at CHECK_LR against float64, over the bf16 oracle path's
    one = seeds[:1]
    kw = dict(lr=CHECK_LR, seq_len=LM["seq_len"], n_heads=LM["n_heads"])
    p64 = lm_from_leaves([t.double() for t in lm_leaves(params)])
    want64 = lm_leaves(train_lm_single(p64, one, LM_TOKENS, d, **kw))
    del p64
    start = lm_leaves(params)

    def errs(run):
        return [update_err(torch, g, w, p0) for g, w, p0 in zip(
            lm_leaves(run), want64, start)]

    err_f = errs(train_lm_single(params, one, LM_TOKENS, d,
                                 attn_impl="flash", head_impl="fused", **kw))
    err_o = errs(train_lm_single(params, one, LM_TOKENS, d, **kw))
    del want64
    ratio = max(f / max(o, 1e-30) for f, o in zip(err_f, err_o))
    unchanged = min(1.0 / max(o, 1e-30) for o in err_o)
    names = ("wte", "wpe", "ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2",
             "ln_f")
    print("lm-bf16-train-check " + json.dumps(dict(
        check_lr=CHECK_LR, update_err_vs_f64_fused=dict(zip(names, err_f)),
        update_err_vs_f64_oracle=dict(zip(names, err_o)),
        update_err_ratio_max=ratio, update_ratio_limit=UPDATE_RATIO,
        unchanged_ratio_min=unchanged, ep_lr=LM_BF16_EP_LR,
        ep_kernel_vs_plain_weights_bit_identical=same_w,
        ep_kernel_vs_plain_routes_identical=same_r,
        ep_moved_share=moved, ep_finite=finite,
        phase_s=time.perf_counter() - t_phase, card=card)), flush=True)
    check(ratio <= UPDATE_RATIO, f"the bf16 fused-head LM's update {ratio:.2f}"
          "x as far from float64 as the bf16 oracle path's")
    check(unchanged > UPDATE_RATIO,
          "the update check cannot tell unchanged weights from trained")
    check(same_w and same_r, "bf16 EP through the kernel and the plain "
          f"exchange: weights identical {same_w}, routes identical {same_r}")
    check(finite and moved > 0.1, f"bf16 EP: finite {finite}, moved share "
          f"{moved:.3f}")
    return dict(launches=launches, tp=tp)


@contextlib.contextmanager
def plain_loopback_calls(ring, on=True):
    """Within the block (with ``on``) every loopback ring call returns its
    plain version's outputs (``ring.loopback_ref``) and launches no
    kernel."""
    inner = ring.loopback
    if on:
        ring.loopback = lambda op, xs, ws: ring.loopback_ref(op, xs)
    try:
        yield
    finally:
        ring.loopback = inner


def lm_bf16_rows(cases, launches, mode="loopback"):
    """This slice's bf16 forms in the kernels line: ``launches`` from the
    main path's runs (``lm_bf16_train_phase``: the LM's for the head, EP's
    for the all-to-all; the hop is on no strategy's path, as in f32, and
    is held alone), each TP run's a rank, the rest from the main case of
    each."""
    rows = []
    for name, src, replaces in LM_BF16_KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        if not mine:
            continue
        op = name.split("[")[0]
        main = next(c for c in mine if c["shape"] in (
            "main", LM_BF16_MOVE_MAIN.get(op)))
        got = None if launches is None else launches["launches"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_code_samples_tpu_torch/csrc/{src}",
            "replaces": f"distributed_llm_code_samples_tpu/{replaces}",
            "launches": None if got is None else got.get(name, 0),
            "lmtp_launches_per_rank": None if launches is None else {
                label: n.get(name, 0) for label, n in launches["tp"].items()
                if n.get(name, 0)},
            "on_main_path": op != "ppermute_dma",
            "mode": mode, "storage": "bf16",
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main["ms"], "f32_ms": main["f32_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "bound_f32_ms": main.get("bound_f32_ms"),
            "library_ms": main["library_ms"],
            "ok": all(c["ok"] for c in mine)})
    return rows


def dist_lm_bf16_rank(mesh, payload):
    """One rank of ``--phase dist``'s part for this slice (its card is
    ``cuda:<rank>``): the hop and the all-to-all of bf16 at
    ``LM_BF16_MOVE_CASES`` across the cards, bit for bit against their
    plain versions (NCCL point to point) and NCCL's bf16
    ``all_to_all_single``, timed beside the f32 call on the same values;
    then ``train_moe_ep`` on bf16 params at ``EP`` under both transports,
    one rank a card, whose weights must end bit for bit the same. Rank 0
    prints; returns the cases and the EP run's launches."""
    import torch
    import torch.distributed as dist

    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.moe import (
        init_moe_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        launch_counts, reset_launch_counts, ring)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        expert, train_moe_ep)
    r, n, dev = mesh.rank, mesh.size, mesh.torch_device
    timer = Timer(torch)
    token = torch.zeros(1, device=dev)
    aligned = partial(timer.ms, align=partial(dist.all_reduce, token))
    rg = mesh.ring(LM_BF16_MOVE_BYTES)

    def gathered(obj):
        every = [None] * n
        dist.all_gather_object(every, obj)
        return every

    cases = []
    for k, (op, tag, shape) in enumerate(LM_BF16_MOVE_CASES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(790 + 10 * k + r)
        x = torch.randn(shape, generator=gen, device=dev).bfloat16()
        kern = partial(getattr(ring, op), x, rg)
        plain = partial(getattr(ring, op + "_ref"), x, rg)
        lib = (partial(_nccl_a2a, torch, dist, x) if op == "all_to_all_dma"
               else partial(_nccl_call, torch, dist, op, x))
        got, again = kern(), kern()
        torch.cuda.synchronize()
        mesh.check()
        want, nccl = plain(), lib()
        bits = [torch.equal(got.view(torch.int16), y.view(torch.int16))
                for y in (want, nccl, again)]
        row = dict(kernel=op + "[bf16]", shape=tag, dims=list(shape),
                   ranks=n, mode="4 cards",
                   odd_chunk=ring._odd(op, x, n),
                   bit_identical_to_plain=bits[0],
                   bit_identical_to_nccl=bits[1], deterministic=bits[2],
                   max_abs_err=float((got.float() - want.float()).abs()
                                     .max()),
                   ms=aligned(kern),
                   ms_with_host=timer.ms(kern, with_host=True),
                   plain_ms=aligned(plain),
                   f32_ms=aligned(partial(getattr(ring, op), x.float(), rg)),
                   library_ms=aligned(lib))
        row["bound_ms"], row["bound_by"] = (
            a2a_dist_bound(2 * x.numel(), n) if op == "all_to_all_dma"
            else ring_dist_bound(op, 2 * x.numel(), n))
        every = gathered({key: row[key] for key in (
            "ms", "bit_identical_to_plain", "bit_identical_to_nccl",
            "deterministic")})
        row["ms_max_over_ranks"] = max(e["ms"] for e in every)
        row["ok"] = all(e["bit_identical_to_plain"]
                        and e["bit_identical_to_nccl"] and e["deterministic"]
                        for e in every)
        if r == 0:
            print("dist-lm-bf16-move-case " + json.dumps(row), flush=True)
        cases.append(row)
        del x, got, again, want, nccl

    gen = torch.Generator(device=dev)
    gen.manual_seed(EP["random_seed"])
    params = init_moe_stack(gen, EP["d_model"], EP["n_layers"],
                            EP["n_experts"], dtype=torch.bfloat16)
    seeds = make_seed_schedule(EP_N * EP["steps"], EP["random_seed"])
    kw = dict(lr=LM_BF16_EP_LR, capacity_factor=EP["capacity_factor"],
              k=EP["k"], aux_coef=EP["aux_coef"], dispatch="dense")
    outs, launches = {}, {}
    for comm in ("pallas_a2a", "psum"):
        stamps = []

        def on_step(_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs[comm] = train_moe_ep(params, seeds, EP["tokens"],
                                  EP["d_model"], mesh, comm=comm,
                                  on_step=on_step, **kw)
        launches[comm] = launch_counts()
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        med = statistics.median(steps[1:])
        every = gathered(med)
        if r == 0:
            print("dist-lm-bf16-ep-run " + json.dumps(dict(
                run=f"ep-dense-{comm}-bf16", mode="4 cards", ranks=n,
                lr=LM_BF16_EP_LR, steps_per_rank=len(steps),
                tokens_per_step=EP["tokens"], median_step_ms=1e3 * med,
                median_step_ms_max_over_ranks=1e3 * max(every),
                tokens_per_s=EP["tokens"] / max(every),
                kernel_launches=launches[comm],
                card=payload["card"])), flush=True)
    same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(outs["pallas_a2a"], outs["psum"]))
    moved = float((outs["pallas_a2a"].w1 != expert.shard_params(
        params, mesh).w1).double().mean())
    every = gathered(dict(same=same, moved=moved))
    return dict(cases=cases, ep_launches=launches,
                ep_same=all(e["same"] for e in every),
                ep_moved=min(e["moved"] for e in every))


def dist_lm_bf16_phase(torch, np, cards):
    """``--phase dist``'s part for this slice: ``dist_lm_bf16_rank`` on
    ``RING_N`` cards, then ``train_lm_tp`` on bf16 params (flash, fused
    head) one rank a card at ``LM``'s shape (``dist-lm-bf16-tp-run``,
    exact launches a rank), and ``cli.py -m 11 --head fused --attn
    flash``, ``-m 8 --attn flash`` and ``-m 7`` on bf16 params at their
    full widths (``CLI_LM_BF16``). Returns this slice's rows of the
    kernels line."""
    from distributed_llm_code_samples_tpu_torch import LR
    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models import init_lm
    from distributed_llm_code_samples_tpu_torch.optim import leaves
    from distributed_llm_code_samples_tpu_torch.parallel import (
        EXPERT_AXIS, MODEL_AXIS, launch, make_mesh)
    out = launch(dist_lm_bf16_rank, make_mesh({EXPERT_AXIS: RING_N},
                                              device="cuda"),
                 {"card": cards}, timeout=900)[0]
    want = {"all_to_all_dma[bf16]": EP_A2A_PER_LAYER * EP["n_layers"]
            * EP["steps"]}
    print("dist-lm-bf16-ep-check " + json.dumps(dict(
        weights_bit_identical=out["ep_same"], moved_share=out["ep_moved"],
        launches=out["ep_launches"], cards=cards)), flush=True)
    check(out["ep_launches"]["pallas_a2a"] == want
          and out["ep_launches"]["psum"] == {},
          f"bf16 EP on the cards launched {out['ep_launches']}")
    check(out["ep_same"] and out["ep_moved"] > 0.1, "bf16 EP on the cards: "
          "the transports' weights differ, or too few moved")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(LM["random_seed"])
    params = init_lm(gen, LM["vocab"], LM["d_model"], LM["n_layers"],
                     LM["seq_len"], n_heads=LM["n_heads"],
                     dtype=torch.bfloat16)
    host = params.with_leaves([t.cpu() for t in leaves(params)])
    seeds = make_seed_schedule(LM["steps"], LM["random_seed"])
    outs = launch(lmtp_rank, make_mesh({MODEL_AXIS: LMTP_N}, device="cuda"),
                  ("lm", host, seeds, LR, dict(attn_impl="flash",
                                               head_impl="fused")),
                  timeout=900)
    r0 = outs[0]
    steps = [b - a for a, b in zip([r0["t0"]] + r0["stamps"], r0["stamps"])]
    med = statistics.median(steps[1:])
    flash = LM["n_layers"] * LM["steps"]
    want = {f"flash_attn_{k}[bf16]": flash for k in ("fwd", "dq", "dkv")}
    want.update({"head_xent_stats[bf16]": LM["steps"],
                 "head_xent_bwd[bf16]": LM["steps"]})
    print("dist-lm-bf16-tp-run " + json.dumps(dict(
        run="lm-tp-flash-fused-bf16-nccl", mode=f"{LMTP_N} cards",
        steps_per_rank=len(steps), tokens_per_step=LM_TOKENS,
        median_step_ms=1e3 * med, tokens_per_s=LM_TOKENS / med,
        max_memory_allocated_gb=r0["max_memory_allocated_gb"],
        launches_per_rank=[o["launches"] for o in outs], cards=cards)),
        flush=True)
    check(all(o["launches"] == want for o in outs),
          f"bf16 LM TP on the cards: launches {[o['launches'] for o in outs]}"
          f", expected {want} a rank")
    check(all(t.dtype == torch.bfloat16
              and bool(torch.isfinite(t.float()).all())
              for o in outs for t in o["shards"]),
          "bf16 LM TP on the cards: shards left bf16 or are not finite")
    for tag, argv in CLI_LM_BF16:
        runs = cli_m0_phase(cards, argv, tag)
        check(all(r.get("dtype") == "bfloat16" for r in runs),
              f"{tag}: a run is not bf16")
    rows = lm_bf16_rows(out["cases"], None, mode="4 cards")
    for row in rows:
        row["cards"] = cards
    return rows


def dp_rows(dp_launches, counted):
    """A kernel's launches a rank in each ``lmdp`` run that made any."""
    if dp_launches is None:
        return None
    return {label: sum(got.get(c, 0) for c in counted)
            for label, got in dp_launches.items()
            if any(got.get(c, 0) for c in counted)}


def bf16_kernel_rows(cases, launches, mode="loopback", dp_launches=None):
    """The bf16-storage kernels' entries of the kernels line: launches
    from the main path's runs (FSDP's mixed gathers, the LM's mixed
    trunk; ``dp_launches``, a rank's by run, from the mixed LM DDP and
    FSDP runs), the rest from the main case of each (the w1 shard's
    gather)."""
    rows = []
    for name, src, replaces, counted in BF16_KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        if not mine:            # --phase dist holds the gather alone
            continue
        main = next(c for c in mine if c["shape"] in ("w1_shard", "main"))
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_code_samples_tpu_torch/csrc/{src}",
            "replaces": f"distributed_llm_code_samples_tpu/{replaces}",
            "launches": None if launches is None
            else sum(launches.get(c, 0) for c in counted),
            "launches_by_kernel": None if launches is None
            else {c: launches.get(c, 0) for c in counted},
            "lmdp_launches_per_rank": dp_rows(dp_launches, counted),
            "mode": mode, "storage": "bf16",
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main["ms"], "f32_ms": main["f32_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "ok": all(c["ok"] for c in mine)})
    return rows


def dist_opt_rank(mesh, payload):
    """One rank of ``--phase dist``'s optimizer part (its card is
    ``cuda:<rank>``): the all-gather of FSDP's two bf16 shards across the
    cards against its plain ring (NCCL point to point) and NCCL's
    ``all_gather_into_tensor`` on bf16, bit for bit; then the opt phase's
    FFN runs one rank a card under both transports (ZeRO-1 under psum
    alone, as in the CLI), their launches, ZeRO-1's state shards and the
    pairwise agreement (``OPT_AGREE``), and one Adam step of each at
    ``CHECK_LR`` against float64 (``UPDATE_RATIO``). Rank 0 prints; it
    returns the gather cases and the mixed FSDP ring run's launches."""
    import torch
    import torch.distributed as dist

    from distributed_llm_code_samples_tpu_torch import LR, optim
    from distributed_llm_code_samples_tpu_torch.data import (
        batch_from_seed, make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        FFNStackParams, init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.ops import (
        ffn_block, launch_counts, reset_launch_counts, ring, stack_grads)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, fsdp, train_ddp, train_ddp_zero1, train_fsdp, zero1)
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

    def bits(a, b):
        return a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                                  b.view(torch.int16))

    # -- the bf16 gather across the cards -----------------------------------
    timer = Timer(torch)
    token = torch.zeros(1, device=dev)
    aligned = partial(timer.ms, align=partial(dist.all_reduce, token))
    rg = mesh.ring(4 * FFN_DIM * D_MODEL)
    op = "ring_all_gather"
    cases = []
    for k, (tag, shape) in enumerate(BF16_GATHER_CASES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(620 + 10 * k + r)
        x = torch.randn(shape, generator=gen, device=dev).bfloat16()
        kern = partial(ring.ring_all_gather, x, rg)
        plain = partial(ring.ring_all_gather_ref, x, rg)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        mesh.check()
        want = plain()
        xs = _all_inputs(torch, dist, x)
        f64 = [w[r] for w in (ring_want(torch, op, xs),
                              ring_want(torch, op, xs, control=True))]
        nccl = _nccl_call(torch, dist, op, x)
        row = dict(kernel="ring_all_gather[bf16]", shape=tag,
                   dims=list(shape), ranks=n, mode="4 cards",
                   bit_identical_to_plain=bits(got, want),
                   bit_identical_to_nccl=bits(got, nccl),
                   deterministic=bits(got, again),
                   max_abs_err=float((got.float() - want.float()).abs()
                                     .max()),
                   err_vs_f64=ring_err(torch, [got], [f64[0]]),
                   control_err_vs_f64=ring_err(torch, [got], [f64[1]]),
                   ms=aligned(kern),
                   ms_with_host=timer.ms(kern, with_host=True),
                   plain_ms=aligned(plain),
                   f32_ms=aligned(partial(ring.ring_all_gather, x.float(),
                                          rg)),
                   library_ms=aligned(partial(_nccl_call, torch, dist, op,
                                              x)))
        row["bound_ms"], row["bound_by"] = ring_dist_bound(
            op, 2 * x.numel(), n)
        every = gathered({key: row[key] for key in
                          ("ms", "err_vs_f64", "control_err_vs_f64",
                           "bit_identical_to_plain", "bit_identical_to_nccl",
                           "deterministic")})
        row["ms_max_over_ranks"] = max(e["ms"] for e in every)
        row["ok"] = all(e["bit_identical_to_plain"]
                        and e["bit_identical_to_nccl"] and e["deterministic"]
                        and e["err_vs_f64"] <= RING_TOL
                        and e["control_err_vs_f64"] > RING_TOL
                        for e in every)
        say("dist-bf16-kernel-case", row)
        cases.append(row)
        del x, xs, got, again, want, nccl, f64

    # -- the FFN strategies under Adam and mixed AdamW -----------------------
    d, n_layers, tokens = TRAIN["d_model"], TRAIN["n_layers"], TRAIN["tokens"]
    steps_n = TRAIN["steps"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN["random_seed"])
    params = init_ffn_stack(gen, d, n_layers)
    seeds = make_seed_schedule(n * steps_n, TRAIN["random_seed"])
    flops = 12 * tokens * d * FFN_DIM * n_layers * n
    layer_calls = n_layers * steps_n
    trainers = {
        "ddp-adam": (train_ddp, lambda: dict(optimizer=optim.adam())),
        "zero1-adam": (train_ddp_zero1, lambda: dict(
            optimizer=optim.adam())),
        "fsdp-adam": (train_fsdp, lambda: dict(optimizer=optim.adam())),
        "ddp-mixed-adamw": (train_ddp, lambda: dict(
            optimizer=optim.clipped(optim.adamw(), 1.0), mixed=True)),
        "fsdp-mixed-adamw": (train_fsdp, lambda: dict(
            optimizer=optim.clipped(optim.adamw(), 1.0, axis=DATA_AXIS),
            mixed=True))}
    ring_want_launches = {
        "ddp-adam": {"ring_all_reduce": 2 * layer_calls, "ppermute_dma": 1},
        "fsdp-adam": {"ring_all_gather": 4 * layer_calls,
                      "ring_reduce_scatter": 2 * layer_calls,
                      "ppermute_dma": 1},
        "fsdp-mixed-adamw": {"ring_all_gather[bf16]": 4 * layer_calls,
                             "ring_reduce_scatter": 2 * layer_calls,
                             "ppermute_dma": 1}}
    ring_want_launches["ddp-mixed-adamw"] = ring_want_launches["ddp-adam"]
    runs = [(name, "psum") for name in trainers] + [
        (name, "pallas_ring") for name in trainers if name != "zero1-adam"]

    def full(t, dim):
        return torch.cat(_all_inputs(torch, dist, t.contiguous()), dim)

    def run(name, comm, seeds=seeds, lr=LR, start=params, opt_state=None):
        """``name`` over ``seeds`` from ``start`` (and, given, the full
        ``opt_state``): the full params, the full state (FSDP's and
        ZeRO-1's gathered from the ranks' shards), the step times, the
        launches and the layers of the rank's own state."""
        trainer, kw = trainers[name]
        kind = name.split("-")[0]
        kw = dict(kw(), return_state=True)
        if kind != "zero1":
            kw["comm"] = comm
        view = mesh.for_rank(r, group=mesh.group)
        if opt_state is not None:
            shard = {"zero1": zero1.shard_state,
                     "fsdp": fsdp.shard_state}.get(kind)
            kw["opt_state"] = shard(opt_state, view) if shard else opt_state
        stamps = []

        def on_step(_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, state = trainer(start, seeds, tokens, d, view, lr=lr,
                             on_step=on_step, **kw)
        launches = launch_counts()
        view.close()
        layers = int(state.mu.w1.shape[0])
        if kind in ("zero1", "fsdp"):
            dim = 0 if kind == "zero1" else 1
            state = optim.tree_map(lambda t: full(t, dim) if t.dim() == 3
                                   else t, state)
        if kind == "fsdp":
            out = FFNStackParams(*(full(t, 1) for t in out))
        steps = [b - a for a, b in zip([t0] + stamps, stamps)]
        return out, state, steps, launches, layers

    finals, mixed_ring_launches = {}, None
    for name, comm in runs:
        out, state, steps, got, layers = run(name, comm)
        med = statistics.median(steps[1:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        every = gathered(dict(med=med, launches=got, peak=peak,
                              layers=layers))
        row = dict(run=f"{name}-{comm}", ranks=n, mode="4 cards",
                   steps_per_rank=len(steps), tokens_per_rank_step=tokens,
                   median_step_ms=1e3 * med,
                   median_step_ms_max_over_ranks=1e3 * max(e["med"]
                                                           for e in every),
                   first_step_ms=1e3 * steps[0],
                   tokens_per_s=n * tokens / med,
                   model_tflops_per_s=flops / med / 1e12,
                   max_memory_allocated_gb_per_rank=[e["peak"]
                                                     for e in every],
                   kernel_launches_per_rank=[e["launches"] for e in every],
                   card=card)
        if name.startswith("zero1"):
            row["state_layers_per_rank"] = [e["layers"] for e in every]
            check(all(e["layers"] == n_layers // n for e in every),
                  f"ZeRO-1's ranks hold {row['state_layers_per_rank']} "
                  f"layers of Adam state, not {n_layers // n} each")
        say("dist-opt-train-run", row)
        want = (ring_want_launches[name] if comm == "pallas_ring" else {})
        check(all(e["launches"] == want for e in every),
              f"{name}-{comm}: launches {[e['launches'] for e in every]}, "
              f"expected {want} on every rank")
        check(all(bool(torch.isfinite(t).all()) for t in out),
              f"{name}-{comm}: the trained params are not finite")
        if (name, comm) == ("fsdp-mixed-adamw", "pallas_ring"):
            mixed_ring_launches = got
        finals[name, comm] = out
        del out, state

    drift = {f"{a}/{b}/{comm}": opt_agree(finals[a, comm], finals[b, comm],
                                          params)[0]
             for comm in ("psum", "pallas_ring")
             for a, others in OPT_CHAINS for b in others
             if (b, comm) in finals}
    del finals

    def one_step(name, p, state, s):
        out, state = run(name, "pallas_ring", s, start=p,
                         opt_state=state)[:2]
        return out, state

    every = gathered(opt_step_chains(one_step, params, seeds, n, steps_n))
    pairs = {k: max(e[k] for e in every) for k in every[0]}

    # -- one Adam step a rank at CHECK_LR against float64 --------------------
    x, dl = batch_from_seed(int(seeds[r]), tokens, d, device=dev)
    p64 = FFNStackParams(*(t.double() for t in params))
    g64 = [g.contiguous() for g in stack_grads(
        p64.w1, p64.w2, x.double(), dl.double(), block=ffn_block)[1]]
    g32 = [g.contiguous() for g in stack_grads(params.w1, params.w2, x, dl,
                                               block=ffn_block)[1]]
    for g in g64 + g32:
        dist.all_reduce(g)
    adam = optim.adam()
    want64 = adam.update(FFNStackParams(*g64), adam.init(p64), p64,
                         CHECK_LR)[0]
    base = adam.update(FFNStackParams(*g32), adam.init(params), params,
                       CHECK_LR)[0]
    del g64, g32, p64

    def errs(got):
        return [update_err(torch, g, w, p0)
                for g, w, p0 in zip(got, want64, params)]

    base_errs = errs(base)
    del base
    mine = {"unchanged": min(1.0 / b for b in base_errs)}
    for name, comm in runs:
        if "mixed" in name:
            continue
        e = errs(run(name, comm, seeds[:n], CHECK_LR)[0])
        mine[f"{name}-{comm}"] = max(a / b for a, b in zip(e, base_errs))
    mine["f32_matmul"] = max(base_errs)
    every = gathered(mine)
    ratios = {k: max(e[k] for e in every) for k in mine
              if k not in ("unchanged", "f32_matmul")}
    say("dist-opt-train-check", dict(
        mode="4 cards", check_lr=CHECK_LR, update_ratio_limit=UPDATE_RATIO,
        update_err_ratio_max=ratios,
        f32_matmul_update_err_vs_f64_max=max(e["f32_matmul"] for e in every),
        unchanged_ratio_min=min(e["unchanged"] for e in every),
        agree=pairs, agree_limit=OPT_AGREE, chain_steps=steps_n,
        chain_comm="pallas_ring (ZeRO-1: psum)", free_run_drift=drift,
        card=card))
    for pair, a in pairs.items():
        check(a <= OPT_AGREE, f"{pair}: their updates differ by {a:.2e}")
    for k, ratio in ratios.items():
        check(ratio <= UPDATE_RATIO, f"{k}'s Adam update {ratio:.2f}x as far "
              "from float64 as the f32 matmul path's")
    check(min(e["unchanged"] for e in every) > UPDATE_RATIO,
          "the update check cannot tell unchanged weights from trained")
    return dict(cases=cases, launches=mixed_ring_launches)


# the reference's own default invocation, -m 0, at TRAIN's shape on every
# card (--phase dist)
CLI_M0 = ("-m", "0", "-s", "8", "-bs", "8", "-n", "1024", "-l", "24", "-d",
          "768", "-r", "7", "--strict", "--comm", "pallas_ring")
# the optimizer slice's runs of the CLI at the same shape on every card
# (--phase dist): ZeRO-1 under Adam and mixed, FSDP under clipped mixed
# AdamW over the ring kernels (its gathers bf16), and -m 0 under mixed
CLI_OPT = (
    ("dist-cli-zero1", ("-m", "2", "--zero1", "--optimizer", "adam",
                        "--mixed") + CLI_M0[2:14]),
    ("dist-cli-fsdp-adamw", ("-m", "3", "--optimizer", "adamw",
                             "--clip_norm", "1.0", "--mixed", "--comm",
                             "pallas_ring") + CLI_M0[2:14]),
    ("dist-cli-m0-mixed", CLI_M0 + ("--mixed",)))
# -m 0 on bf16 params over the ring kernels at the same shape on every
# card (--phase dist, dist-bf16)
CLI_M0_BF16 = CLI_M0 + ("--dtype", "bfloat16")


# the LM's and the transformer's TP through the CLI at LM's shape on every
# card (--phase dist, dist-tp): the fused head and flash attention, and
# sequence-parallel TP of the blocks
LMTP_CLI_SHAPE = ("-s", "8", "-bs", str(LM["batch"]), "-n",
                  str(LM["seq_len"]), "-l", str(LM["n_layers"]), "-d",
                  str(LM["d_model"]), "-r", "7", "--heads",
                  str(LM["n_heads"]), "--tp", str(LMTP_N))
CLI_LMTP = (
    ("dist-cli-m11", ("-m", "11", "--head", "fused", "--attn", "flash",
                      "--vocab", str(LM["vocab"])) + LMTP_CLI_SHAPE),
    ("dist-cli-m8-sp", ("-m", "8", "--tp_sp", "--attn", "flash")
     + LMTP_CLI_SHAPE))


# the LM, the transformer and the MoE stack through the CLI on bf16 params
# at their full widths on every card (--phase dist, dist-bf16)
CLI_LM_BF16 = (
    ("dist-cli-m11-bf16", CLI_LMTP[0][1] + ("--dtype", "bfloat16")),
    ("dist-cli-m8-bf16", ("-m", "8", "--attn", "flash") + LMTP_CLI_SHAPE
     + ("--dtype", "bfloat16")),
    ("dist-cli-m7-bf16", ("-m", "7", "-s", "8", "-bs", "16", "-n", "512",
                          "-l", str(EP["n_layers"]), "-d",
                          str(EP["d_model"]), "-r", "7", "--experts",
                          str(EP["n_experts"]), "--lr", str(LM_BF16_EP_LR),
                          "--dtype", "bfloat16")))



def cli_m0_phase(cards, argv=CLI_M0, tag="dist-cli-m0") -> list:
    """``cli.py`` with ``argv`` (default ``-m 0 ... --strict``: methods 1-4
    in turn, then DDP against FSDP and single-device against TP) as a
    subprocess. Prints its exit code, its ``takes`` and ``verify`` lines,
    every ``SoftAssertionError`` line and each method's step time and
    launches (``tag``); returns each method's payload."""
    cmd = [sys.executable, "-m", "distributed_llm_code_samples_tpu_torch.cli",
           *argv]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lines = out.stdout.splitlines()
    runs = [json.loads(l) for l in lines if l.startswith("{")]
    print(f"{tag} " + json.dumps(dict(
        argv=list(argv), rc=out.returncode,
        seconds=time.perf_counter() - t0,
        takes=[l for l in lines if " takes " in l],
        verify=[json.loads(l.split(" ", 1)[1]) for l in lines
                if l.startswith("verify ")],
        soft_assertions=[l for l in lines
                         if l.startswith("SoftAssertionError")],
        runs=[{k: r.get(k) for k in ("method", "ranks", "mesh", "comm",
                                     "dtype", "optimizer", "zero1", "mixed",
                                     "sequence_parallel", "attn", "head",
                                     "median_step_ms", "tokens_per_s",
                                     "model_tflops_per_s",
                                     "kernel_launches")} for r in runs],
        cards=cards)), flush=True)
    if out.returncode != 0:
        print(f"{tag}-stderr\n" + out.stderr[-4000:], flush=True)
    check(out.returncode == 0, f"cli {' '.join(argv)} exited "
          f"{out.returncode}")
    return runs


def card_lines() -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()


def dist_phase(torch, part: str = "all"):
    """``--phase dist``: ``RING_N`` ranks, one a card, over NCCL and the
    peer-mapped workspaces (``dist_rank``), then TP, TP-SP and the hybrid
    on the cards (``tp_phase``), ``cli.py -m 0`` (``cli_m0_phase``), LM
    and transformer TP (``lmtp_phase``) and their CLI runs, the
    optimizer slice's CLI runs, and DDP, FSDP and the hybrid of the LM and
    the transformer (``lmdp_phase``). Returns the ring kernels' and the
    all-to-all's entries of the kernels line. ``part`` ``"tp"`` (``--phase
    dist-tp``) runs TP, ``-m 0`` and LM TP with their CLI runs alone;
    ``"lmdp"`` (``--phase dist-lmdp``) the data-parallel LM and
    transformer alone; ``"seq"`` (``--phase dist-seq``, which ``"all"``
    does not run) ``seq_phase`` over NCCL and ``cli.py -m 13`` ring and
    Ulysses alone; ``"bf16"`` (``--phase dist-bf16``) the bf16 ring
    sums across the cards (``dist_bf16_rank``), ``cli.py -m 0 --dtype
    bfloat16``, and the bf16 hop, all-to-all, EP, LM TP and ``cli.py -m
    11``, ``-m 8``, ``-m 7`` on bf16 (``dist_lm_bf16_phase``) alone, which
    ``"all"`` runs too."""
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, launch, make_mesh)
    import numpy as np
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
    rows = []
    if part == "all":
        out = launch(dist_rank, make_mesh({DATA_AXIS: RING_N},
                                          device="cuda"),
                     {"card": cards}, timeout=900)[0]
        rows = ring_kernel_rows(out["cases"], out["launches"],
                                mode="4 cards")
        rows.append(a2a_kernel_row(out["a2a_cases"], out["ep_launches"],
                                   mode="4 cards"))
        opt = launch(dist_opt_rank, make_mesh({DATA_AXIS: RING_N},
                                              device="cuda"),
                     {"card": cards}, timeout=900)[0]
        rows += bf16_kernel_rows(opt["cases"], opt["launches"],
                                 mode="4 cards")
        for row in rows:
            row["cards"] = cards
    if part in ("all", "tp"):
        tp_phase(torch, cards, cards=RING_N)
        cli_m0_phase(cards)
        lmtp_phase(torch, np, cards, cards=RING_N)
        for tag, argv in CLI_LMTP:
            cli_m0_phase(cards, argv, tag)
    if part == "all":
        for tag, argv in CLI_OPT:
            cli_m0_phase(cards, argv, tag)
    if part in ("all", "lmdp"):
        lmdp_phase(torch, np, cards, cards=RING_N)
    if part == "seq":
        seq_phase(torch, np, cards, cards=SEQ_N)
        for tag, argv in CLI_SEQ:
            cli_m0_phase(cards, argv, tag)
    if part in ("all", "bf16"):
        cases = launch(dist_bf16_rank, make_mesh({DATA_AXIS: RING_N},
                                                 device="cuda"),
                       {"card": cards}, timeout=600)[0]
        cli_m0_phase(cards, CLI_M0_BF16, "dist-cli-m0-bf16")
        bf16_rows = dtype_bf16_rows(cases, None, mode="4 cards")
        for row in bf16_rows:
            row["cards"] = cards
        rows += bf16_rows + dist_lm_bf16_phase(torch, np, cards)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase",
                    choices=["all", "kernel", "train", "lm", "ring", "ep",
                             "tp", "opt", "lmtp", "lmdp", "bf16", "seq",
                             "dist", "dist-tp", "dist-lmdp", "dist-bf16",
                             "dist-seq"],
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
    print("ptxas-spills " + json.dumps(ptxas_spills(_build.build_logs)),
          flush=True)

    if args.phase in ("dist", "dist-tp", "dist-lmdp", "dist-bf16",
                      "dist-seq"):
        kernels = dist_phase(torch, part=args.phase[5:] or "all")
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0 if all(k["ok"] for k in kernels) else 1

    timer = Timer(torch)
    kernels, bad = [], []
    ffn_phases, lm_phases = ("all", "kernel", "train"), ("all", "lm")
    lm_kernel_phases = ("all", "lm", "lmtp", "lmdp", "seq")
    ring_phases, ep_phases = ("all", "ring"), ("all", "ep")
    opt_phases, bf16_phases = ("all", "opt"), ("all", "bf16")
    if args.phase in ("all", "kernel"):
        cases = kernel_phase(torch, np, timer)
        bad += [c for c in cases if not c["ok"]]
        if not bad:
            paged_split_sweep(torch, np, timer)
    if args.phase in ffn_phases:
        ffn_cases = ffn_kernel_phase(torch, np, timer)
        bad += [c for c in ffn_cases if not c["ok"]]
    if args.phase in lm_kernel_phases:
        lm_cases = lm_kernel_phase(torch, np, timer)
        bad += [c for c in lm_cases if not c["ok"]]
    if args.phase in ring_phases:
        ring_cases = ring_kernel_phase(torch, np, timer)
        bad += [c for c in ring_cases if not c["ok"]]
    if args.phase in ep_phases:
        a2a_cases = a2a_kernel_phase(torch, np, timer)
        bad += [c for c in a2a_cases if not c["ok"]]
    if args.phase in opt_phases:
        bf16_cases = bf16_kernel_phase(torch, np, timer)
        bad += [c for c in bf16_cases if not c["ok"]]
    if args.phase in bf16_phases:
        dtype_cases = dtype_bf16_kernel_phase(torch, np, timer)
        bad += [c for c in dtype_cases if not c["ok"]]
        lm_bf16_cases = lm_bf16_kernel_phase(torch, np, timer)
        bad += [c for c in lm_bf16_cases if not c["ok"]]
    if args.phase in ("all", "seq"):
        seq_cases = seq_kernel_phase(torch, np, timer, card)
        bad += [c for c in seq_cases if not c["ok"]]
        lm_cases = lm_cases + [c for c in seq_cases
                               if c["shape"] == "seq-hop"]
    launches = ffn_launches = lm_launches = ring_launches = None
    ep_launches = bf16_launches = lmtp_launches = lmdp_launches = None
    dtype_launches = lm_bf16_launches = seq_launches = seq_a2a = None
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
    if not bad and args.phase in ("all", "tp"):
        tp_phase(torch, card)
    if not bad and args.phase in opt_phases:
        bf16_launches = dict(opt_train_phase(torch, np, card),
                             **opt_lm_phase(torch, np, card))
    if not bad and args.phase in bf16_phases:
        dtype_launches = dtype_bf16_train_phase(torch, np, card)
        lm_bf16_launches = lm_bf16_train_phase(torch, np, card)
    if not bad and args.phase in ("all", "lmtp"):
        lmtp_launches = lmtp_phase(torch, np, card)
    if not bad and args.phase in ("all", "lmdp"):
        lmdp_launches = lmdp_phase(torch, np, card)
    if not bad and args.phase in ("all", "seq"):
        seq_a2a = seq_a2a_phase(torch, card)
        seq_launches = seq_phase(torch, np, card)
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
    if args.phase in lm_kernel_phases:
        kernels += lm_kernel_rows(lm_cases, lm_launches, lmtp_launches,
                                  lmdp_launches, seq_launches)
    if args.phase in ring_phases:
        kernels += ring_kernel_rows(ring_cases, ring_launches)
    if args.phase in ep_phases:
        kernels.append(a2a_kernel_row(a2a_cases, ep_launches,
                                      seq_launches=seq_a2a))
    if args.phase in opt_phases:
        kernels += bf16_kernel_rows(bf16_cases, bf16_launches,
                                    dp_launches=lmdp_launches)
    if args.phase in bf16_phases:
        kernels += dtype_bf16_rows(dtype_cases, dtype_launches)
        kernels += lm_bf16_rows(lm_bf16_cases, lm_bf16_launches)
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
