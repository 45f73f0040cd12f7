"""Rank bodies for ``tests/test_torch_train_lm_dp.py`` and
``tests/test_torch_train_transformer_dp.py``, at module level so that the
spawned gloo ranks can import them by name. This module imports the port
and torch only (the ranks import no JAX)."""

import torch

from distributed_llm_code_samples_tpu_torch.parallel import lm as lm_mod
from distributed_llm_code_samples_tpu_torch.parallel import transformer

# the collectives the data-parallel trainers call, by the module that
# calls each
TRACED = {lm_mod: ("all_gather", "all_reduce", "reduce_scatter", "pmax"),
          transformer: ("all_gather", "all_reduce", "reduce_scatter")}


def traced(fn, *args, **kw):
    """``fn(*args, **kw)`` with every collective the trainers' modules
    call recorded: ``(result, trace)``, ``trace`` one ``(op, dtype, shape,
    in_backward)`` a call in order, ``in_backward`` whether autograd was
    running a backward node when it was called (it must never be)."""
    trace, saved = [], []

    def wrap(op, f):
        def call(x, *a, **k):
            trace.append((op, str(x.dtype).replace("torch.", ""),
                          tuple(x.shape),
                          torch._C._current_autograd_node() is not None))
            return f(x, *a, **k)
        return call

    for mod, names in TRACED.items():
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, wrap(name, getattr(mod, name)))
    try:
        return fn(*args, **kw), trace
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
