"""The port's decode engine: paged KV pool, radix prefix cache with its
host spill tier, sampling, the n-gram drafter of speculative decoding,
the continuously batched engine with its serving policy, and its CLI."""

from .draft import draft_tokens
from .engine import (AdmissionError, DecodeEngine, EngineConfig,
                     ServePolicy, blocks_needed)
from .paged import (KV_DTYPES, SCRATCH_BLOCK, PagedKV, copy_block,
                    copy_block_rows, corrupt_block, extract_blocks,
                    fused_decode_attn, gather_layer, implant_block,
                    init_pool, kv_bytes_per_token, scrub_blocks,
                    storage_dtype, write_chunk, write_rows)
from .prefix import PrefixCache, PrefixNode
from .sampling import (check_sampling, check_speculation, gumbel_noise,
                       make_pick)
from .spill import SpillTier

__all__ = ["AdmissionError", "DecodeEngine", "EngineConfig", "KV_DTYPES",
           "PagedKV", "PrefixCache", "PrefixNode", "SCRATCH_BLOCK",
           "ServePolicy", "SpillTier", "blocks_needed", "check_sampling",
           "check_speculation", "copy_block", "copy_block_rows",
           "corrupt_block", "draft_tokens", "extract_blocks",
           "fused_decode_attn", "gather_layer", "gumbel_noise",
           "implant_block", "init_pool", "kv_bytes_per_token", "make_pick",
           "scrub_blocks", "storage_dtype", "write_chunk", "write_rows"]
