"""The port's decode engine: paged KV pool, sampling, the continuously
batched engine and its CLI."""

from .engine import DecodeEngine, EngineConfig, blocks_needed
from .paged import (KV_DTYPES, SCRATCH_BLOCK, PagedKV, fused_decode_attn,
                    gather_layer, init_pool, kv_bytes_per_token,
                    scrub_blocks, storage_dtype, write_chunk, write_rows)
from .sampling import check_sampling, gumbel_noise, make_pick

__all__ = ["DecodeEngine", "EngineConfig", "KV_DTYPES", "PagedKV",
           "SCRATCH_BLOCK", "blocks_needed", "check_sampling",
           "fused_decode_attn", "gather_layer", "gumbel_noise", "init_pool",
           "kv_bytes_per_token", "make_pick", "scrub_blocks",
           "storage_dtype", "write_chunk", "write_rows"]
