"""Failure detection and recovery, as in the JAX package's
``runtime/failure.py``: ``supervise`` wraps
``checkpoint.run_with_checkpointing`` in the rollback ladder, with the
native ``Watchdog`` (``native/watchdog.cpp``) as hang evidence and
``device_healthcheck`` (a small op on each device) between restarts.
A failed attempt resumes from the last published verified checkpoint,
so the final params equal an uninterrupted run's.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Callable

import torch

from ..checkpoint import (LossSpikeError, NonFiniteParamsError,
                          latest_verified_step, run_with_checkpointing)

# The ladder's cheap rung catches exactly the failures whose remedy is
# "rewind to the last verified checkpoint and retrain": a poisoned
# segment (nonfinite="raise") and a loss spike (spike_factor). Anything
# else goes to the restart rung with backoff and the healthcheck.
RECOVERABLE = (NonFiniteParamsError, LossSpikeError)


def _head(exc: BaseException) -> str:
    """First line of ``Type: message``."""
    return f"{type(exc).__name__}: {exc}".splitlines()[0][:300]


def backoff_delay(attempt: int, base_s: float, max_s: float,
                  jitter: float, rng: random.Random) -> float:
    """Jittered exponential backoff: ``base_s * 2^attempt`` capped at
    ``max_s``, scaled by ``uniform(1-j, 1+j)`` from the caller's seeded
    RNG."""
    b = min(base_s * (2 ** attempt), max_s)
    return b * (1.0 + jitter * (2.0 * rng.random() - 1.0))


class HealthCheckError(RuntimeError):
    """A device failed the liveness probe."""


def device_healthcheck(devices=None, timeout_s: float = 30.0,
                       allow_degraded: bool = False) -> list:
    """Prove each device still executes: ``x + 1`` on a small tensor on
    each one (every visible CUDA device, or the CPU where there is none),
    the result read back and checked, under ``timeout_s``. Returns the
    healthy devices; raises ``HealthCheckError`` naming the first failure,
    or with ``allow_degraded`` records it and raises only when none
    survives."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    healthy, dead = [], []
    for d in devices:
        t0 = time.monotonic()
        reason = None
        try:
            y = torch.ones(8, dtype=torch.float32, device=d) + 1.0
            if not bool(torch.all(y.cpu() == 2.0)):
                reason = f"device {d} returned wrong result"
            elif time.monotonic() - t0 > timeout_s:
                reason = f"device {d} probe exceeded {timeout_s}s"
        except Exception as e:  # noqa: BLE001 - any backend error fails it
            reason = f"device {d} failed liveness probe: {e}"
        if reason is None:
            healthy.append(d)
        elif allow_degraded:
            dead.append(reason)
        else:
            raise HealthCheckError(reason)
    if not healthy:
        raise HealthCheckError(
            "no healthy devices survived the probe: " + "; ".join(dead))
    return healthy


def supervise(train_fn: Callable, params, seeds, *args,
              ckpt_dir: str, every: int, max_restarts: int = 3,
              max_rollbacks: int = 2,
              on_failure: Callable[[int, BaseException], None] | None = None,
              healthcheck: bool = False,
              backoff_base_s: float = 0.5, backoff_max_s: float = 30.0,
              backoff_jitter: float = 0.5, backoff_seed: int = 0,
              log_path: str | None = None, chaos=None,
              nonfinite: str | None = "skip", watchdog_ms: int = 0,
              **kwargs):
    """Run a trainer under failure supervision, up the rollback ladder:

    1. the in-graph skip (``guard=`` in ``kwargs``) and 2. the loss-scale
       shrink run inside the trainer and show as ``anomaly`` events;
    3. **rollback** (``max_rollbacks``): a recoverable failure
       (``NonFiniteParamsError``, ``LossSpikeError``) rewinds to
       ``latest_verified_step`` in process, with no backoff and no
       restart spent; the spike baseline and the guard state carry into
       the retry;
    4. **restart**: anything else costs a restart, with jittered backoff
       from ``random.Random(backoff_seed)``, ``on_failure(attempt, e)``
       and, with ``healthcheck``, ``device_healthcheck``.

    Every attempt appends JSON records to ``log_path`` (default
    ``{ckpt_dir}/supervise.jsonl``): each recovery event of the checkpoint
    layer, ``rollback`` and ``attempt_failed`` records with their
    ``rung``, and ``completed``. With ``watchdog_ms > 0`` a native
    ``Watchdog`` is armed around each attempt and kicked at every
    checkpoint event; a segment that stalled past it shows as
    ``watchdog_expired: true``. When the restarts are spent the raised
    ``RuntimeError`` carries every attempt's exception."""
    history: list[BaseException] = []
    rng = random.Random(backoff_seed)
    os.makedirs(ckpt_dir, exist_ok=True)
    if log_path is None:
        log_path = os.path.join(ckpt_dir, "supervise.jsonl")
    caller_on_event = kwargs.pop("on_event", None)

    def log(record: dict) -> None:
        record.setdefault("t", time.time())
        try:
            with open(log_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            pass  # logging never takes down the supervised run

    attempt = 0
    rollbacks = 0
    while attempt <= max_restarts:
        t0 = time.monotonic()
        dog = None
        hang_latched = False
        if watchdog_ms > 0:
            from . import native
            dog = native.Watchdog(watchdog_ms)

        def emit(record: dict, _dog=dog) -> None:
            # checkpoint progress re-arms the hang detector; the latch is
            # read before the kick clears it
            nonlocal hang_latched
            if _dog is not None:
                if _dog.expired:
                    hang_latched = True
                    record = dict(record, watchdog_expired=True)
                _dog.kick()
            log(record)
            if caller_on_event is not None:
                try:
                    caller_on_event(record)
                except Exception:  # noqa: BLE001 - observability only
                    pass

        expired = None
        try:
            out = run_with_checkpointing(
                train_fn, params, seeds, *args, ckpt_dir=ckpt_dir,
                every=every, chaos=chaos, nonfinite=nonfinite,
                on_event=emit, **kwargs)
            if dog is not None:
                expired = bool(dog.expired) or hang_latched
            log({"event": "completed", "attempt": attempt,
                 "rollbacks": rollbacks,
                 "elapsed_s": round(time.monotonic() - t0, 3),
                 "watchdog_expired": expired})
            return out
        except Exception as e:  # noqa: BLE001 - the supervisor catches all
            if dog is not None:
                expired = bool(dog.expired) or hang_latched
            if isinstance(e, RECOVERABLE) and rollbacks < max_rollbacks:
                rollbacks += 1
                if isinstance(e, LossSpikeError) and e.baseline:
                    kwargs["spike_baseline"] = e.baseline
                if getattr(e, "guard_state", None) is not None:
                    kwargs["guard_state"] = e.guard_state
                emit({"event": "rollback", "rung": "rollback",
                      "rollback": rollbacks, "max_rollbacks": max_rollbacks,
                      "attempt": attempt, "error": _head(e),
                      "resume_step": latest_verified_step(ckpt_dir),
                      "elapsed_s": round(time.monotonic() - t0, 3),
                      "watchdog_expired": expired})
                continue
            history.append(e)
            record = {"event": "attempt_failed", "rung": "restart",
                      "attempt": attempt, "error": _head(e),
                      "elapsed_s": round(time.monotonic() - t0, 3),
                      "watchdog_expired": expired,
                      "restarts_left": max_restarts - attempt,
                      "backoff_s": None}
            if attempt == max_restarts:
                log(record)
                break  # exhausted: no restart follows
            backoff = backoff_delay(attempt, backoff_base_s, backoff_max_s,
                                    backoff_jitter, rng)
            record["backoff_s"] = round(backoff, 3)
            log(record)
            if on_failure is not None:
                on_failure(attempt, e)
            if healthcheck:
                device_healthcheck()
            if backoff > 0:
                time.sleep(backoff)
            attempt += 1
        finally:
            if dog is not None:
                dog.close()
    heads = "; ".join(f"attempt {i}: {_head(e)}"
                      for i, e in enumerate(history))
    raise RuntimeError(
        f"training failed after {max_restarts} restarts; "
        f"attempt history: [{heads}]") from history[-1]
