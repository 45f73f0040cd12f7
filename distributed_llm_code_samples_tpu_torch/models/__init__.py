"""Model pieces of the port: the transformer stack's parameters, the
attention ops of the serving path, and the LM."""

from .attention import causal_mask, chunk_attn, gather_paged_kv, rope
from .lm import (LMParams, decode_attn, decode_step, generate, init_lm,
                 lm_params_from_numpy)
from .transformer import TransformerParams, init_transformer

__all__ = ["LMParams", "TransformerParams", "causal_mask", "chunk_attn",
           "decode_attn", "decode_step", "gather_paged_kv", "generate",
           "init_lm", "init_transformer", "lm_params_from_numpy", "rope"]
