"""Model pieces of the port: attention (the hand-VJP oracle and the
serving pieces), the transformer stack, the LM with its loss, and the
FFN stack that the single-device FFN trainer trains."""

from .attention import causal_mask, chunk_attn, gather_paged_kv, gqa, mha, rope
from .ffn_stack import (FFNStackParams, clone_params, ffn_params_from_numpy,
                        init_ffn_stack, params_size_gb)
from .lm import (LMParams, clone_lm, decode_attn, decode_step, generate,
                 init_lm, lm_from_leaves, lm_hidden, lm_leaves, lm_logits,
                 lm_loss, lm_params_from_numpy)
from .transformer import (TransformerParams, init_transformer,
                          transformer_block, transformer_fwd)

__all__ = ["FFNStackParams", "LMParams", "TransformerParams", "causal_mask", "chunk_attn", "clone_lm", "clone_params",
           "decode_attn", "decode_step", "ffn_params_from_numpy",
           "gather_paged_kv", "generate", "gqa", "init_ffn_stack", "init_lm",
           "init_transformer", "lm_from_leaves", "lm_hidden", "lm_leaves",
           "lm_logits", "lm_loss", "lm_params_from_numpy", "mha",
           "params_size_gb", "rope", "transformer_block", "transformer_fwd"]
