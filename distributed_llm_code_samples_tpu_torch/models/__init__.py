"""Model pieces of the port: attention (the hand-VJP oracle and the
serving pieces), the transformer stack, the LM with its loss, the FFN
stack that the FFN trainers train, and the mixture-of-experts FFN stack
of expert parallelism."""

from .attention import (causal_mask, chunk_attn, gather_paged_kv, gqa, mha,
                        rope, rope_mha)
from .ffn_stack import (FFNStackParams, clone_params, ffn_params_from_numpy,
                        init_ffn_stack, params_size_gb)
from .lm import (LMParams, clone_lm, decode_attn, decode_step, generate,
                 init_lm, lm_from_leaves, lm_hidden, lm_leaves, lm_logits,
                 lm_loss, lm_params_from_numpy, sample, sample_pick)
from .moe import (MoEStackParams, clone_moe, init_moe_stack,
                  moe_params_from_numpy)
from .transformer import (TransformerParams, init_transformer,
                          transformer_block, transformer_fwd,
                          transformer_params_from_numpy)

__all__ = ["FFNStackParams", "LMParams", "MoEStackParams",
           "TransformerParams", "causal_mask", "chunk_attn", "clone_lm",
           "clone_moe", "clone_params",
           "decode_attn", "decode_step", "ffn_params_from_numpy",
           "gather_paged_kv", "generate", "gqa", "init_ffn_stack", "init_lm",
           "init_moe_stack",
           "init_transformer", "lm_from_leaves", "lm_hidden", "lm_leaves",
           "lm_logits", "lm_loss", "lm_params_from_numpy", "mha",
           "moe_params_from_numpy",
           "params_size_gb", "rope", "rope_mha", "sample", "sample_pick",
           "transformer_block",
           "transformer_fwd", "transformer_params_from_numpy"]
