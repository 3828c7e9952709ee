"""Typed error hierarchy for the serving layer (counterpart of
``repro/serve/errors.py``, DESIGN.md §15).

Every client-visible failure is a :class:`ServeError` subclass raised at
the service boundary, so callers can distinguish "your request is
wrong" (:class:`BadRequestError`, :class:`UnknownOperatorError`), "the
service is misconfigured" (:class:`ConfigError`) and "the service is
protecting itself" (:class:`AdmissionRejected` — SLO-aware admission
control / load shedding, the open-loop overload story).

``BadRequestError``/``ConfigError`` double as ``ValueError`` and
``UnknownOperatorError`` as ``KeyError`` so pre-existing callers that
caught the builtin types keep working.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for every serving-layer failure."""


class UnknownOperatorError(ServeError, KeyError):
    """Request names an operator key that was never registered."""

    def __init__(self, op_key):
        super().__init__(f"operator {op_key!r} not registered")
        self.op_key = op_key

    def __str__(self) -> str:          # KeyError quotes its arg; don't
        return self.args[0]


class BadRequestError(ServeError, ValueError):
    """Malformed solve request: wrong RHS shape, non-finite entries,
    nonsensical tolerance or deadline."""


class ConfigError(ServeError, ValueError):
    """Service/operator registration misconfiguration (unknown
    preconditioner kind, missing block size, bad scheduler knobs)."""


class WorkerFault(ServeError, RuntimeError):
    """A slab worker's backing program/process faulted mid-serve (device
    runtime error, dead fabric rank, injected chaos fault).  The
    scheduler tears the worker down and hands its unretired in-flight
    requests back to the service for resubmission through the retry
    policy (DESIGN.md §19 self-healing serve)."""


class AdmissionRejected(ServeError):
    """Request refused by the admission policy (queue depth above the
    configured ceiling, or a deadline that cannot be met).

    ``reason`` is machine-readable: ``"queue_full"`` or
    ``"deadline_infeasible"``.  ``retry_after_s`` is the service's
    backoff hint: resubmit no sooner than this many (service-clock)
    seconds, or None when retrying cannot help (an infeasible deadline
    stays infeasible; a service without a retry policy offers no hint).
    """

    def __init__(self, reason: str, detail: str = "",
                 retry_after_s: float | None = None):
        hint = (f"; retry after {retry_after_s:g}s"
                if retry_after_s is not None else "")
        super().__init__(f"admission rejected ({reason})"
                         + (f": {detail}" if detail else "") + hint)
        self.reason = reason
        self.retry_after_s = retry_after_s
