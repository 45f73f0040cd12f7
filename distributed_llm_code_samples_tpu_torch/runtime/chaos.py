"""Deterministic fault injection for training, the training half of the
JAX package's ``runtime/chaos.py``.

A ``FaultPlan`` is a deterministic schedule of faults keyed on absolute
1-based training-step indices (the indices of the checkpoints'
``step_{N}`` dirs), parsed from the CLI's ``--chaos`` grammar::

    spec  := fault ("," fault)* ("," "seed=" INT)?
    fault := KIND "@" STEP (":" ARG)?

``KIND`` is any of JAX's ``KINDS`` (the parse accepts the whole grammar,
with JAX's messages); the training CLI takes the training kinds alone:

- ``nan_grad@s`` / ``inf_grad@s``: step ``s`` trains on a NaN/Inf
  upstream gradient. With the in-graph guard armed
  (``begin_segment(in_graph=True)``) the poison rides the step's own seed
  (``data.POISON_NAN_BIT``/``POISON_INF_BIT``), so the skip-step guard
  must neutralize exactly that step; otherwise the segment's returned
  params are poisoned after the fact and the checkpoint layer's
  non-finite guard refuses to checkpoint them.
- ``loss_spike@s:mult``: the segment that trains step ``s`` returns
  params whose update is scaled by ``mult`` (default 100): finite, so
  only the segment-delta spike guard (``spike_factor``) catches it.
- ``slow_step@s[:secs]``: the segment sleeps ``secs`` (default 1.0),
  then completes.
- ``hang@s[:secs]``: the segment sleeps ``secs`` (default 0.25), long
  enough to latch a ``Watchdog`` armed by the supervisor.
- ``kill@s``: SIGKILL this process right after the checkpoint of step
  ``s`` is published; a resumed run starts past ``s`` and never re-fires
  it.
- ``corrupt_ckpt@s[:frac]``: truncate step ``s``'s freshly published
  array file to ``frac`` of its bytes (default 0.5); the checksum must
  send the next restore to the previous verified step.

In-segment faults fire once a process; publish faults once a publish of
their step. The serving and fleet kinds (``DECODE_KINDS``,
``FLEET_KINDS``) parse here; their hooks (``decode_due``,
``mark_decode_fired_through``, ``fleet_due``, ``validate_decode_plan``,
``validate_fleet_plan``) come with the engine supervisor and the fleet
(ROADMAP.md Queue 1 items 4.5-4.8).
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..optim import tree_map, tree_tensors, weak

IN_SEGMENT_KINDS = ("nan_grad", "inf_grad", "loss_spike", "slow_step",
                    "hang")
PUBLISH_KINDS = ("corrupt_ckpt", "kill")
DECODE_KINDS = ("nan_logits", "hang_step", "corrupt_block",
                "corrupt_spill", "kill")
FLEET_KINDS = ("kill_worker", "hang_worker", "corrupt_wire",
               "corrupt_deploy", "partition_worker", "slow_link",
               "drop_conn")
KINDS = IN_SEGMENT_KINDS + PUBLISH_KINDS + tuple(
    k for k in DECODE_KINDS if k not in PUBLISH_KINDS) + FLEET_KINDS


@dataclass
class Fault:
    kind: str
    step: int          # absolute 1-based training step index
    arg: float | None = None
    fired: bool = False


@dataclass
class FaultPlan:
    """A deterministic, seeded schedule of injected faults."""

    faults: list = field(default_factory=list)
    seed: int = 0
    events: list = field(default_factory=list)  # fired-fault audit trail
    _armed: list = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``--chaos`` grammar (see the module docstring)."""
        faults, seed = [], 0
        for entry in (e.strip() for e in spec.split(",") if e.strip()):
            if entry.startswith("seed="):
                seed = int(entry[len("seed="):])
                continue
            if "@" not in entry:
                raise ValueError(
                    f"bad --chaos entry {entry!r}: expected KIND@STEP"
                    f"[:ARG] with KIND in {KINDS} (or seed=N)")
            kind, _, rest = entry.partition("@")
            if kind not in KINDS:
                raise ValueError(
                    f"bad --chaos kind {kind!r}: known kinds {KINDS}")
            step_s, _, arg_s = rest.partition(":")
            try:
                step = int(step_s)
            except ValueError:
                raise ValueError(
                    f"bad --chaos step {step_s!r} in {entry!r}: "
                    "steps are absolute 1-based integers") from None
            if step < 1:
                raise ValueError(
                    f"bad --chaos step {step} in {entry!r}: must be >= 1")
            try:
                arg = float(arg_s) if arg_s else None
            except ValueError:
                raise ValueError(
                    f"bad --chaos arg {arg_s!r} in {entry!r}: the "
                    "optional :ARG is a number (seconds, multiplier, "
                    "fraction)") from None
            faults.append(Fault(kind, step, arg))
        if not faults:
            raise ValueError(f"empty --chaos spec {spec!r}")
        return cls(faults=faults, seed=seed)

    def _note(self, fault: Fault, **extra):
        fault.fired = True
        self.events.append({"kind": fault.kind, "step": fault.step,
                            "t": time.time(), **extra})

    # -- segment integration ------------------------------------------------
    def begin_segment(self, start: int, n: int,
                      in_graph: bool = False) -> None:
        """Arm the in-segment faults whose step the segment ``(start,
        start + n]`` trains (0-based ``start``, 1-based steps).
        ``in_graph`` routes nan/inf faults through the seeds' poison bits
        (``poison_segment_seeds``) instead of poisoning the result."""
        self._start = start
        self._in_graph = in_graph
        self._armed = [f for f in self.faults
                       if f.kind in IN_SEGMENT_KINDS and not f.fired
                       and start < f.step <= start + n]

    def poison_segment_seeds(self, seg_seeds):
        """Apply the armed nan/inf faults to the segment's seeds (the
        in-graph path; a no-op unless armed ``in_graph``). Returns the
        seeds, a copy where a fault fired; fired faults are consumed so
        ``wrap`` does not fire them again."""
        if not getattr(self, "_in_graph", False):
            return seg_seeds
        from ..data import POISON_INF_BIT, POISON_NAN_BIT
        seeds = None
        for f in list(self._armed):
            if f.kind not in ("nan_grad", "inf_grad"):
                continue
            if seeds is None:
                seeds = np.array(seg_seeds)
            idx = f.step - self._start - 1
            bit = POISON_NAN_BIT if f.kind == "nan_grad" else POISON_INF_BIT
            seeds[idx] = int(seeds[idx]) | bit
            self._note(f, mode="in_graph")
            self._armed.remove(f)
        return seg_seeds if seeds is None else seeds

    def wrap(self, train_fn):
        """A trainer that injects this plan's armed in-segment faults
        around ``train_fn``; ``begin_segment`` must come first."""
        def chaotic(params, seeds, *args, **kwargs):
            for f in list(self._armed):
                if f.kind in ("hang", "slow_step"):
                    default = 0.25 if f.kind == "hang" else 1.0
                    secs = default if f.arg is None else f.arg
                    self._note(f, sleep_s=secs)
                    time.sleep(secs)
            out = train_fn(params, seeds, *args, **kwargs)
            for f in list(self._armed):
                if f.kind in ("nan_grad", "inf_grad"):
                    poison = float("nan" if f.kind == "nan_grad" else "inf")
                    self._note(f)
                    first = [True]

                    def poisoned(t):
                        if first[0]:
                            first[0] = False
                            return torch.full_like(t, poison)
                        return t
                    out = tree_map(poisoned, out)
                elif f.kind == "loss_spike":
                    mult = 100.0 if f.arg is None else f.arg
                    self._note(f, mult=mult)
                    # new = old + mult * (new - old) on the params leaves,
                    # which come first in the result (params alone, or
                    # params then the optimizer state)
                    old = tree_tensors(params)
                    i = [0]

                    def spiked(t):
                        k = i[0]
                        i[0] += 1
                        if k >= len(old):
                            return t
                        o = old[k].to(t.device)
                        return o + weak(mult, t) * (t - o)
                    out = tree_map(spiked, out)
            self._armed = []
            return out

        return chaotic

    # -- publish integration --------------------------------------------------
    def after_publish(self, step: int, path: str) -> None:
        """Fire the publish faults of ``step`` on its freshly published
        checkpoint ``path``: corruption before kill, so
        ``corrupt_ckpt@s,kill@s`` leaves a torn latest step behind a dead
        process."""
        due = [f for f in self.faults
               if f.kind in PUBLISH_KINDS and not f.fired and f.step == step]
        for f in sorted(due, key=lambda f: PUBLISH_KINDS.index(f.kind)):
            if f.kind == "corrupt_ckpt":
                self._note(f, path=path)
                truncate_checkpoint(path, frac=0.5 if f.arg is None
                                    else f.arg)
            elif f.kind == "kill":
                self._note(f, path=path)
                os.kill(os.getpid(), signal.SIGKILL)


def truncate_checkpoint(path: str, frac: float = 0.5) -> str:
    """Truncate a published checkpoint's primary array file mid-file:
    ``arrays.npz`` when present, else the first ``*.raw`` leaf in sorted
    order (the native backend). Returns the damaged file."""
    candidates = ([os.path.join(path, "arrays.npz")]
                  if os.path.exists(os.path.join(path, "arrays.npz"))
                  else sorted(os.path.join(path, name)
                              for name in os.listdir(path)
                              if name.endswith(".raw")))
    if not candidates:
        raise FileNotFoundError(f"no array file to corrupt under {path}")
    target = candidates[0]
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(max(1, int(size * frac)))
    return target
