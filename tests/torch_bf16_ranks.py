"""Rank bodies for ``tests/test_torch_train_bf16.py``, at module level so
that the spawned gloo ranks can import them by name. This module imports
the port and torch only (the ranks import no JAX)."""

from distributed_llm_code_samples_tpu_torch.ops import ring
from distributed_llm_code_samples_tpu_torch.parallel import ddp, train_ddp


def ddp_f32_ring_sums(*args, **kwargs):
    """``train_ddp(comm="pallas_ring")`` whose ring adds bf16 gradients
    in f32 and rounds each sum once: the control that a bf16 DDP run
    against JAX's must tell apart from the ring's rounding after every
    add."""
    inner = ddp.ring_all_reduce
    ddp.ring_all_reduce = lambda g, mesh: inner(g.float(), mesh).to(g.dtype)
    try:
        return train_ddp(*args, comm="pallas_ring", **kwargs)
    finally:
        ddp.ring_all_reduce = inner
