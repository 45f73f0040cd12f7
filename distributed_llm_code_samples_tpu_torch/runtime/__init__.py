"""Runtime pieces of the port: the serving guardrail."""

from .guardrails import rows_finite

__all__ = ["rows_finite"]
