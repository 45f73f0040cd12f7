"""Runtime pieces of the port: the anomaly guardrails (the trainers'
skip-step guard with dynamic loss scaling, and the serving row flag), the
wire format of the spill tier's documents and the integrity primitives
of the checkpoints (``wire``), the training half of fault injection
(``chaos``), the failure supervisor and its rollback ladder
(``failure``), and the bindings of the host C++ (``native``: the async
checkpoint writer and the watchdog)."""

from .guardrails import (GuardrailConfig, GuardState, rows_finite,
                         summarize)

__all__ = ["GuardState", "GuardrailConfig", "rows_finite", "summarize"]
