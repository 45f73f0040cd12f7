"""Rank bodies and weight metrics of the bf16 tests
(``tests/test_torch_train_bf16.py``, ``test_torch_lm_bf16.py``,
``test_torch_train_lm_tp_bf16.py``, ``test_torch_train_moe_bf16.py``),
at module level so that the spawned gloo ranks can import them by name.
This module imports the port, torch and numpy only (the ranks import no
JAX)."""

import numpy as np
import torch

from distributed_llm_code_samples_tpu_torch.ops import ring
from distributed_llm_code_samples_tpu_torch.parallel import (
    MODEL_AXIS, ddp, train_ddp, vp_head_xent)


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


def vp_head_bf16(mesh, cases):
    """``vp_head_xent`` on bf16 operands on the rank of ``mesh``, forward
    and backward: each case ``(h, w, targets)`` (bf16 tensors, the whole
    ``w``) -> ``(loss, dh, dw_local)``, ``dh`` the rank's partial."""
    n, r = mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)
    out = []
    for h, w, targets in cases:
        h = h.clone().requires_grad_()
        wl = w.chunk(n)[r].clone().requires_grad_()
        loss = vp_head_xent(h, wl, targets, mesh)
        dh, dw = torch.autograd.grad(loss, [h, wl])
        out.append((loss.detach(), dh, dw))
    return out


def as_f64(a) -> np.ndarray:
    """A tensor (f32 or bf16) or an array as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def bf16_steps(got, want, floor=None):
    """``(most, share)``: the largest ``|got - want|`` in bf16 steps (the
    spacing of bf16 numbers at the larger of the two magnitudes, or at
    ``floor`` where that is larger: ``want``'s RMS by default) and the
    share of elements that differ at all."""
    g, w = as_f64(got), as_f64(want)
    floor = np.sqrt(np.mean(w ** 2)) if floor is None else floor
    _, e = np.frexp(np.maximum(np.maximum(np.abs(g), np.abs(w)), floor))
    return (float((np.abs(g - w) / np.ldexp(1.0, e - 8)).max()),
            float((g != w).mean()))


def update_gap(got, want, start) -> float:
    """``|got - want| / |want - start|`` (Frobenius norms): how much of
    the reference's update the port's run misses; ``inf`` where the
    reference left the leaf as it was and the port did not."""
    g, w, s = as_f64(got), as_f64(want), as_f64(start)
    den = np.linalg.norm(w - s)
    num = np.linalg.norm(g - w)
    if den == 0:
        return 0.0 if num == 0 else float("inf")
    return float(num / den)
