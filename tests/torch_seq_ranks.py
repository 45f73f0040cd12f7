"""Rank bodies for ``tests/test_torch_sequence.py``, at module level so
that the spawned gloo ranks can import them by name. This module imports
the port and torch only (the ranks import no JAX)."""

from distributed_llm_code_samples_tpu_torch.parallel import sequence as seq


def ring_fwd_bwd(mesh, q, k, v, dy, attn_impl=None, causal=True):
    """The rank's ``ring_attention_fwd`` and ``ring_attention_bwd`` on its
    blocks: ``(y, lse, dq, dk, dv)``."""
    y, lse = seq.ring_attention_fwd(q, k, v, mesh, causal=causal,
                                    attn_impl=attn_impl)
    return (y, lse, *seq.ring_attention_bwd(q, k, v, y, lse, dy, mesh,
                                            causal=causal,
                                            attn_impl=attn_impl))
