"""Trainers of the port. Slice 2 has the single-device one."""

from .single import make_step, train_single

__all__ = ["make_step", "train_single"]
