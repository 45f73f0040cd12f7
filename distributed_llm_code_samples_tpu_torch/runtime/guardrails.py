"""Anomaly guardrails, as in the JAX package's ``runtime/guardrails.py``:
the skip-step guard with dynamic loss scaling and clipping for the
trainers, and the serving row flag ``rows_finite``.

JAX checks each step's candidate carry inside its compiled scan and
``jnp.where``-selects the old carry on a bad step. The port runs its
steps eagerly and does the same with device tensors (``guarded_step``):

- the step computes the candidate carry (params and optimizer state) on
  a copy, so the old carry survives;
- one 0-d bool over every float leaf of the candidate says whether it is
  finite; on a mesh it is summed over every rank as an int32
  (``collectives.psum``) and compared with the world size, so every rank
  takes the same branch;
- ``torch.where`` keeps the candidate or the old carry, leaf by leaf;
- ``advance`` folds the flag into ``GuardState``, four 0-d device
  tensors: the skip and overflow counts, the live loss scale and the
  clean steps since the last growth.

Nothing is read back to the host inside a step: the flag, the select
and the counters stay on the device, and the host reads them where JAX's
does, on return and through ``summarize``. The flag's all-reduce runs
from the rank's thread, between steps, never inside an autograd backward.

With ``mixed`` the data-parallel trainers scale the upstream gradient by
the live scale before the backward (``loss_scale > 0``), unscale and clip
the reduced gradients (``finalize_grads``), and the scale grows
``scale_growth`` times after ``growth_interval`` clean steps and shrinks
``scale_backoff`` times on a step that overflowed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..optim import clip_by_norm, tree_map, tree_tensors


@dataclass(frozen=True)
class GuardrailConfig:
    """The guard's settings (JAX ``GuardrailConfig``, frozen as there).

    ``loss_scale`` is the initial dynamic loss scale (0: scaling off);
    ``clip_norm`` clips the gradients to that global L2 norm before the
    update (0: off). The other fields set the grow and shrink
    schedule."""

    clip_norm: float = 0.0
    loss_scale: float = 0.0
    scale_growth: float = 2.0
    scale_backoff: float = 0.5
    growth_interval: int = 200
    min_scale: float = 1.0

    @property
    def scaling(self) -> bool:
        return self.loss_scale > 0


class GuardState(NamedTuple):
    """The guard's carry: three counters and the live scale, each a 0-d
    tensor on the params' device."""

    skipped: torch.Tensor      # int32: updates dropped by the finite check
    overflows: torch.Tensor    # int32: skips while loss scaling was on
    loss_scale: torch.Tensor   # float32: the live scale (1.0 when off)
    good_steps: torch.Tensor   # int32: clean steps since the last change


def init_state(cfg: GuardrailConfig, device="cpu") -> GuardState:
    """A fresh guard state on ``device``, made there (a fill, no copy from
    the host)."""
    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)
    return GuardState(
        skipped=i32(), overflows=i32(),
        loss_scale=torch.full((), cfg.loss_scale if cfg.scaling else 1.0,
                              dtype=torch.float32, device=device),
        good_steps=i32())


def summarize(state: GuardState) -> dict:
    """The host's view of a ``GuardState`` (one read a field: call it
    between calls of a trainer, never inside a step)."""
    return {"skipped": int(state.skipped),
            "overflows": int(state.overflows),
            "loss_scale": float(state.loss_scale),
            "good_steps": int(state.good_steps)}


def finite_flag(tree: Any) -> torch.Tensor:
    """One 0-d bool: every float leaf of ``tree`` is free of NaN and Inf.
    Integer leaves (Adam's count) are always finite and skipped."""
    ok = None
    for t in tree_tensors(tree):
        if t.is_floating_point() or t.is_complex():
            f = torch.isfinite(t).all()
            ok = f if ok is None else torch.logical_and(ok, f)
    return torch.ones((), dtype=torch.bool) if ok is None else ok


def rows_finite(logits: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite flag over a logits block ``[..., V] -> [...]``.
    The decode engine fails a request whose row is not finite."""
    return torch.isfinite(logits).all(dim=-1)


def advance(cfg: GuardrailConfig, state: GuardState,
            ok: torch.Tensor) -> GuardState:
    """Fold one step's finite flag into the guard state: count the skip
    and, with scaling on, run the grow and shrink schedule."""
    ok_i = ok.to(torch.int32)
    skipped = state.skipped + (1 - ok_i)
    if not cfg.scaling:
        return state._replace(skipped=skipped)
    overflows = state.overflows + (1 - ok_i)
    good = torch.where(ok, state.good_steps + 1,
                       torch.zeros_like(state.good_steps))
    grown = torch.logical_and(ok, good >= cfg.growth_interval)
    scale = torch.where(
        ok,
        torch.where(grown, state.loss_scale * cfg.scale_growth,
                    state.loss_scale),
        torch.clamp(state.loss_scale * cfg.scale_backoff,
                    min=cfg.min_scale))
    good = torch.where(grown, torch.zeros_like(good), good)
    return GuardState(skipped=skipped, overflows=overflows,
                      loss_scale=scale, good_steps=good)


def unscale_grads(grads: Any, scale: torch.Tensor) -> Any:
    """Every gradient leaf times ``1 / scale`` (in f32, then in the leaf's
    dtype), after the reduction."""
    inv = (1.0 / scale).to(torch.float32)
    return tree_map(lambda g: g * inv.to(g.dtype), grads)


def clip_by_global_norm(grads: Any, max_norm: float, mesh=None,
                        axis: Optional[str] = None) -> Any:
    """Global-norm clipping for the SGD paths (the stateful ones compose
    ``optim.clipped``; both are ``optim.clip_by_norm``). With ``axis`` the
    gradients are shards over that axis of the rank's ``mesh`` (FSDP's),
    and the squared norm is summed over it first."""
    return clip_by_norm(grads, max_norm, mesh, axis)


def anomaly_delta(prev: dict, cur: dict, step: int,
                  steps: list) -> dict | None:
    """The ``anomaly`` record of a chunk from two ``summarize`` snapshots:
    per-chunk deltas of ``skipped`` and ``overflows`` with the running
    totals beside them, or None when neither advanced."""
    if (cur["skipped"] <= prev["skipped"]
            and cur["overflows"] <= prev["overflows"]):
        return None
    return {"step": int(step), "steps": list(steps),
            "skipped": cur["skipped"] - prev["skipped"],
            "total_skipped": cur["skipped"],
            "overflows": cur["overflows"] - prev["overflows"],
            "total_overflows": cur["overflows"],
            "loss_scale": cur["loss_scale"]}


def finalize_grads(grads: Any, scale, guard: GuardrailConfig | None,
                   mesh=None, axis: Optional[str] = None) -> Any:
    """The epilogue of a guarded step after the reduction: unscale by the
    live loss scale (when scaling ran), then clip to ``guard.clip_norm``.
    ``axis`` is the mesh axis the gradients are sharded over (FSDP)."""
    if scale is not None:
        grads = unscale_grads(grads, scale)
    if guard is not None and guard.clip_norm > 0:
        grads = clip_by_global_norm(grads, guard.clip_norm, mesh, axis)
    return grads


def require_mixed_for_scaling(guard, mixed: bool) -> None:
    """Dynamic loss scaling protects a narrow-precision backward; the f32
    paths have none."""
    if guard is not None and guard.scaling and not mixed:
        raise ValueError("dynamic loss scaling (guard.loss_scale > 0) "
                         "applies to the mixed=True path: the f32 path "
                         "has no narrow-precision backward to protect")


def require_scale_hook(guard, takes_scale: bool) -> None:
    """A scaling config on a trainer with no loss-scale hook would scale
    nothing while the schedule still moved: refused (JAX's launcher)."""
    if guard is not None and guard.scaling and not takes_scale:
        raise ValueError(
            "guard.loss_scale > 0 but this strategy has no loss-scale "
            "hook: dynamic scaling is a mixed-precision DDP/FSDP surface "
            "— pass loss_scale=0 here")


def _copy(carry):
    return tree_map(lambda t: t.clone(), carry)


def guarded_step(step: Callable, cfg: GuardrailConfig, mesh=None,
                 takes_scale: bool = False) -> Callable:
    """Wrap a step ``(carry, seed) -> carry`` into ``((carry, GuardState),
    seed) -> (carry, GuardState)`` with the skip (JAX
    ``guarded_scan_step``; module docstring). ``step`` runs on a copy of
    the carry (the SGD steps update in place). ``mesh`` (a rank's view):
    the flag is summed over all of its ranks. ``takes_scale`` calls
    ``step(carry, seed, loss_scale)``, the hook of the mixed trainers."""
    world = 1 if mesh is None else mesh.size

    def gstep(carry_g, seed):
        carry, g = carry_g
        new = _copy(carry)
        new = (step(new, seed, g.loss_scale) if takes_scale
               else step(new, seed))
        ok = finite_flag(new).to(g.skipped.device)
        if world > 1:
            from ..parallel.collectives import psum
            ok = psum(ok.to(torch.int32), mesh) == world
        sel = tree_map(lambda n, o: torch.where(ok, n, o, out=n), new,
                       carry)
        return sel, advance(cfg, g, ok)

    return gstep


def mesh_world(mesh) -> tuple[tuple, int]:
    """``(axis names, ranks)`` of a mesh: the domain of the finite flag's
    sum."""
    if mesh is None:
        return (), 1
    shape = dict(mesh.shape)
    return tuple(shape.keys()), int(math.prod(shape.values())) or 1


def check_guard_args(guard, guard_state, return_guard) -> None:
    """The guarded-trainer surface contract (``optim.check_state_args``'s
    twin): guard state in and out needs a config."""
    if guard is None and (return_guard or guard_state is not None):
        raise ValueError("guard_state/return_guard need a guard config")
    if guard is not None and not isinstance(guard, GuardrailConfig):
        raise TypeError(f"guard must be a GuardrailConfig, got "
                        f"{type(guard).__name__}")


def host_state(state_or_none, cfg: GuardrailConfig,
               device="cpu") -> GuardState:
    """The incoming guard state of a trainer call on ``device``: a fresh
    ``init_state(cfg)`` when None, else the caller's (the scale and the
    counters carried across chunked calls), a plain tuple too."""
    if state_or_none is None:
        return init_state(cfg, device)
    types = (torch.int32, torch.int32, torch.float32, torch.int32)
    return GuardState(*[torch.as_tensor(x).to(device, dt)
                        for x, dt in zip(state_or_none, types)])


def delta_norm(old_params, new_params) -> float:
    """The host's global L2 norm of a params update (the segment-level
    spike signal), in float64; a non-finite delta gives inf."""
    sq = 0.0
    for o, n in zip(tree_tensors(old_params), tree_tensors(new_params)):
        if not o.is_floating_point():
            continue
        d = (n.detach().double().cpu().numpy()
             - o.detach().double().cpu().numpy())
        sq += float(np.sum(d * d))
    return math.sqrt(sq) if np.isfinite(sq) else float("inf")
