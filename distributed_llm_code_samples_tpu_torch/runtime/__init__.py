"""Runtime pieces of the port: the serving guardrail and the wire format
of the spill tier's documents (``wire``)."""

from .guardrails import rows_finite

__all__ = ["rows_finite"]
