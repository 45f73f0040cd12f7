"""The port's decode engine: paged KV pool, radix prefix cache, sampling,
the continuously batched engine with its serving policy, and its CLI."""

from .engine import (AdmissionError, DecodeEngine, EngineConfig,
                     ServePolicy, blocks_needed)
from .paged import (KV_DTYPES, SCRATCH_BLOCK, PagedKV, copy_block,
                    copy_block_rows, corrupt_block, fused_decode_attn,
                    gather_layer, init_pool, kv_bytes_per_token,
                    scrub_blocks, storage_dtype, write_chunk, write_rows)
from .prefix import PrefixCache, PrefixNode
from .sampling import check_sampling, gumbel_noise, make_pick

__all__ = ["AdmissionError", "DecodeEngine", "EngineConfig", "KV_DTYPES",
           "PagedKV", "PrefixCache", "PrefixNode", "SCRATCH_BLOCK",
           "ServePolicy", "blocks_needed", "check_sampling", "copy_block",
           "copy_block_rows", "corrupt_block", "fused_decode_attn",
           "gather_layer", "gumbel_noise", "init_pool",
           "kv_bytes_per_token", "make_pick", "scrub_blocks",
           "storage_dtype", "write_chunk", "write_rows"]
