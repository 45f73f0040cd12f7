"""PyTorch / CUDA port of ``distributed_llm_code_samples_tpu`` for an
NVIDIA H100 (Hopper).

The JAX package beside this one is the reference; each module here
mirrors the JAX module of the same path. This package imports ``torch``
and never ``jax`` or anything of the JAX package.

Slice 1 is the serving path: the paged-KV, continuously batched decode
engine (``decode/engine.py``) over the LM family (``models/lm.py``), with
decode attention in a hand-written CUDA kernel
(``csrc/paged_decode_attn.cu``, bound by ``ops/paged_attention.py``).

Slice 2 is the single-device FFN trainer: seeds-as-dataset batches
(``data/``), the hand-VJP linear -> ReLU -> linear blocks (``ops/ffn.py``)
walked by ``ops/stack.py``, inline SGD (``optim.py``) and
``parallel/single.py::train_single``, run by ``cli.py -m 1``. With
``use_pallas`` (CLI ``--pallas``) each block runs three hand-written CUDA
kernels, the forward, the input gradient and the weight gradients
(``csrc/ffn_*.cu``, bound by ``ops/fused_ffn.py``).

Slice 3 is the single-device LM trainer,
``parallel/lm.py::train_lm_single``: the hand-VJP LayerNorm, attention
and cross-entropy (``ops/norm.py``, ``models/attention.py``,
``ops/xent.py``) in the pre-LN stack of ``models/transformer.py`` and
the LM of ``models/lm.py``. ``attn_impl="flash"`` runs flash attention in
hand-written CUDA kernels (``csrc/flash_attn_*.cu``, bound by
``ops/flash_attention.py``), ``head_impl="fused"`` the tied head and its
loss (``csrc/head_xent_*.cu``, bound by ``ops/fused_xent.py``).

Subpackages: ``ops`` (LayerNorm, linear, ReLU, cross-entropy, the FFN
block and stack, the kernels and their build), ``models`` (parameters,
attention, the transformer, the LM, the FFN stack), ``data`` (seed
schedule and batches), ``parallel`` (the trainers), ``decode`` (paged
pool, sampling, engine, CLI), ``runtime`` (guardrails).
"""

from __future__ import annotations

import torch

__version__ = "0.3.0"

# Training hyperparameters of the reference workload (train_ffns.py:29-30),
# the same values as the JAX package's.
LR = 1e-5
DLOSS_DX_COEF = 0.1


def resolve_device(device=None) -> torch.device:
    """The device the port's entry points run on: CUDA unless the caller
    asks for the CPU. Asking for CUDA where there is none raises; it
    never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
