"""Numerical core of the port: LayerNorm and the paged decode-attention
kernel with its plain version, build and launch count."""

from ._build import build_all, launch_counts, reset_launch_counts
from .norm import EPS, layernorm
from .paged_attention import paged_decode_attn, paged_decode_attn_ref

__all__ = ["EPS", "build_all", "launch_counts", "layernorm",
           "paged_decode_attn", "paged_decode_attn_ref",
           "reset_launch_counts"]
