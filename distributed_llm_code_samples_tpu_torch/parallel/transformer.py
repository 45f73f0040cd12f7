"""What the LM trainers share with the transformer trainers, as in the
JAX package's ``parallel/transformer.py``: the shape checks and the
``attn_impl`` switch. The transformer trainers themselves are not ported
yet."""

from __future__ import annotations


def _validate_shapes(batch_size: int, seq_len: int, model_size: int,
                     n_heads: int) -> None:
    if batch_size % seq_len:
        raise ValueError(f"tokens {batch_size} not divisible by "
                         f"seq_len {seq_len}")
    if model_size % n_heads:
        raise ValueError(f"model_size={model_size} not divisible by "
                         f"n_heads={n_heads} (head dim must be whole)")


def resolve_attn(attn_impl: str | None):
    """The multi-head attention op for ``models.transformer.attn_sublayer``:
    None/"oracle" is the hand-VJP ``mha``/``gqa``; "flash" the flash
    kernels (``ops.flash_attention.flash_mha``, GQA shapes through its
    repeat-KV fan-out). "rope" is not ported yet."""
    if attn_impl in (None, "oracle"):
        return None
    if attn_impl == "flash":
        from ..ops.flash_attention import flash_mha
        return flash_mha
    if attn_impl == "rope":
        raise NotImplementedError("attn_impl='rope' is not ported yet")
    raise ValueError(f"unknown attn_impl {attn_impl!r} "
                     "(expected 'oracle', 'flash', or 'rope')")
