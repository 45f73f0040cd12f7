"""PyTorch / CUDA port of ``distributed_llm_code_samples_tpu`` for an
NVIDIA H100 (Hopper).

The JAX package beside this one is the reference; each module here
mirrors the JAX module of the same path. This package imports ``torch``
and never ``jax`` or anything of the JAX package.

Slice 1 is the serving path: the paged-KV, continuously batched decode
engine (``decode/engine.py``) over the LM family (``models/lm.py``), with
decode attention in a hand-written CUDA kernel
(``csrc/paged_decode_attn.cu``, bound by ``ops/paged_attention.py``).

Subpackages: ``ops`` (LayerNorm, the paged-attention kernel and its
build), ``models`` (parameters, attention, the LM), ``decode`` (paged
pool, sampling, engine, CLI), ``runtime`` (guardrails).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


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
