"""Optimizers, as in the JAX package's ``optim.py``. Only the
reference's inline SGD is ported (``train_ffns.py:29, :114``); the
stateful optimizers come with the strategies that shard their state."""

from __future__ import annotations

import torch

from . import LR


@torch.no_grad()
def sgd(params, grads, lr: float = LR):
    """``p - lr * g`` for every tensor of ``params`` (a tuple type such as
    ``FFNStackParams``), the JAX ``sgd``'s arithmetic (``lr * g`` rounded
    to the param dtype, then subtracted).

    It updates ``params`` in place and returns it, which saves one copy
    of the parameters; callers that need the old values clone first, as
    ``train_single`` does."""
    for p, g in zip(params, grads):
        p.sub_(g.to(p.dtype) * lr)
    return params
