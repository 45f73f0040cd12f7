"""Runtime pieces of the port: the anomaly guardrails (the trainers'
skip-step guard with dynamic loss scaling, and the serving row flag) and
the wire format of the spill tier's documents (``wire``)."""

from .guardrails import (GuardrailConfig, GuardState, rows_finite,
                         summarize)

__all__ = ["GuardState", "GuardrailConfig", "rows_finite", "summarize"]
