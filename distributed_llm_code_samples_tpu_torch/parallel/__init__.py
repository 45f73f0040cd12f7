"""Trainers of the port: the single-device FFN trainer (slice 2) and the
single-device LM trainer (slice 3)."""

from .lm import lm_grads, resolve_head, train_lm_single
from .single import make_step, train_single
from .transformer import resolve_attn

__all__ = ["lm_grads", "make_step", "resolve_attn", "resolve_head",
           "train_lm_single", "train_single"]
