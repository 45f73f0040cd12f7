"""Rank bodies for ``tests/test_torch_train_lm_tp.py``, at module level so
that the spawned gloo ranks can import them by name. This module imports
the port and torch only (the ranks import no JAX)."""

import torch

from distributed_llm_code_samples_tpu_torch.parallel import (
    MODEL_AXIS, vp_embed, vp_head_xent, vp_xent)
from distributed_llm_code_samples_tpu_torch.parallel import lm as lm_mod


def _t(a):
    return torch.from_numpy(a)


def vp_cases(mesh, cases):
    """Each case on the rank of ``mesh``, forward and backward, as numpy:
    ``("embed", (wte, tokens, dy))`` -> ``(y, dw_local)``; ``("xent",
    (logits, targets))`` -> ``(loss, dz_local)``; ``("head", (h, w,
    targets))`` -> ``(loss, dh, dw_local)``, ``dh`` the rank's partial.
    The rank takes its block of the vocab: rows of ``wte``/``w``, columns
    of ``logits``."""
    n, r = mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)
    out = []
    for kind, arrays in cases:
        if kind == "embed":
            wte, tokens, dy = arrays
            w = _t(wte).chunk(n)[r].clone().requires_grad_()
            y = vp_embed(w, _t(tokens), mesh)
            dw, = torch.autograd.grad(y, w, _t(dy))
            out.append((y.detach().numpy(), dw.numpy()))
        elif kind == "xent":
            logits, targets = arrays
            z = _t(logits).chunk(n, dim=1)[r].clone().requires_grad_()
            loss = vp_xent(z, _t(targets), mesh)
            dz, = torch.autograd.grad(loss, z)
            out.append((loss.item(), dz.numpy()))
        else:
            h, w, targets = arrays
            h = _t(h).requires_grad_()
            wl = _t(w).chunk(n)[r].clone().requires_grad_()
            loss = vp_head_xent(h, wl, _t(targets), mesh)
            dh, dw = torch.autograd.grad(loss, [h, wl])
            out.append((loss.item(), dh.numpy(), dw.numpy()))
    return out


def lm_tp_first_grads(mesh, payload):
    """The rank's first-step ``lm_tp_grads`` of ``params`` on one batch,
    on the CPU: ``(loss, grads)``."""
    params, tokens, targets, n_heads, attn_impl, head_impl = payload
    from distributed_llm_code_samples_tpu_torch.parallel import resolve_attn
    shards = lm_mod.lm_tp_shard(params, mesh)
    h_local = n_heads // mesh.axis_size(MODEL_AXIS)
    loss, grads = lm_mod.lm_tp_grads(shards, tokens, targets, h_local,
                                     mesh=mesh,
                                     attn=resolve_attn(attn_impl),
                                     head_impl=head_impl)
    return float(loss), [g.cpu() for g in grads]


def transformer_tp_first_grads(mesh, payload):
    """The rank's ``tp_grads`` of ``params`` for one batch ``(x,
    dloss_dx)``, on the CPU, plain or sequence-parallel."""
    params, x, dy, n_heads, attn_impl, sequence_parallel = payload
    from distributed_llm_code_samples_tpu_torch.parallel import resolve_attn
    from distributed_llm_code_samples_tpu_torch.parallel import transformer
    h_local = n_heads // mesh.axis_size(MODEL_AXIS)
    grads = transformer.tp_grads(transformer.tp_shard(params, mesh), x, dy,
                                 h_local, mesh=mesh,
                                 attn=resolve_attn(attn_impl),
                                 sequence_parallel=sequence_parallel)
    return [g.cpu() for g in grads]
