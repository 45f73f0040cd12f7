"""Numerical core of the port: LayerNorm, the bias-free linear layer,
ReLU and the cross-entropy with their hand VJPs, the FFN block family
and the stack walker, and the hand-written kernels (paged decode
attention; the FFN forward, input gradient and weight gradients; flash
attention forward and backward; the fused LM head's statistics and
gradients) with their plain versions, build and launch counts."""

from ._build import build_all, launch_counts, reset_launch_counts
from .activations import relu_bwd, relu_fwd
from .ffn import (ffn_block, ffn_block_mixed, ffn_block_mixed_remat,
                  ffn_block_saved, ffn_bwd, ffn_bwd_mixed, ffn_bwd_saved,
                  ffn_fwd, ffn_fwd_mixed)
from .fused_ffn import (ffn_bwd_dw_fused, ffn_bwd_dw_ref, ffn_bwd_dx_fused,
                        ffn_bwd_dx_ref, ffn_bwd_fused, ffn_fwd_fused,
                        ffn_fwd_ref, fused_ffn_block)
# (the function ``flash_attention`` stays in its module: exported here it
# would hide the module ``ops.flash_attention``)
from .flash_attention import (flash_attention_bwd, flash_attention_bwd_ref,
                              flash_attention_fwd, flash_attention_fwd_ref,
                              flash_mha)
from .fused_xent import (head_xent, head_xent_bwd, head_xent_bwd_ref,
                         head_xent_fwd, head_xent_stats, head_xent_stats_ref)
from .linear import init_linear, linear_bwd, linear_fwd
from .norm import EPS, layernorm, ln_bwd, ln_fwd
from .paged_attention import paged_decode_attn, paged_decode_attn_ref
from .stack import accumulated_grads, stack_bwd, stack_fwd, stack_grads
from .xent import xent_bwd, xent_fwd, xent_loss

__all__ = ["EPS", "accumulated_grads", "build_all", "ffn_block",
           "ffn_block_mixed", "ffn_block_mixed_remat", "ffn_block_saved",
           "ffn_bwd", "ffn_bwd_dw_fused", "ffn_bwd_dw_ref",
           "ffn_bwd_dx_fused", "ffn_bwd_dx_ref", "ffn_bwd_fused",
           "ffn_bwd_mixed", "ffn_bwd_saved", "ffn_fwd", "ffn_fwd_fused",
           "ffn_fwd_mixed", "ffn_fwd_ref", "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_fwd", "flash_attention_fwd_ref", "flash_mha",
           "fused_ffn_block", "head_xent", "head_xent_bwd",
           "head_xent_bwd_ref", "head_xent_fwd", "head_xent_stats",
           "head_xent_stats_ref", "init_linear", "launch_counts",
           "layernorm", "linear_bwd", "linear_fwd", "ln_bwd", "ln_fwd",
           "paged_decode_attn", "paged_decode_attn_ref", "relu_bwd",
           "relu_fwd", "reset_launch_counts", "stack_bwd", "stack_fwd",
           "stack_grads", "xent_bwd", "xent_fwd", "xent_loss"]
