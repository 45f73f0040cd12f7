"""Model pieces of the port: the transformer stack's parameters, the
attention ops of the serving path, the LM, and the FFN stack that the
single-device trainer trains."""

from .attention import causal_mask, chunk_attn, gather_paged_kv, rope
from .ffn_stack import (FFNStackParams, clone_params, ffn_params_from_numpy,
                        init_ffn_stack, params_size_gb)
from .lm import (LMParams, decode_attn, decode_step, generate, init_lm,
                 lm_params_from_numpy)
from .transformer import TransformerParams, init_transformer

__all__ = ["FFNStackParams", "LMParams", "TransformerParams", "causal_mask",
           "chunk_attn", "clone_params", "decode_attn", "decode_step",
           "ffn_params_from_numpy", "gather_paged_kv", "generate",
           "init_ffn_stack", "init_lm", "init_transformer",
           "lm_params_from_numpy", "params_size_gb", "rope"]
