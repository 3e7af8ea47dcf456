"""Typed serving errors (port of ``mxnet_tpu/serving/errors.py``, the
same names and the same ``TypeName:`` message prefix).

Every client-facing failure of the serving runtime is one of these —
callers (including the C ABI, which only sees ``MXGetLastError`` text)
dispatch on the type or on the ``TypeName:`` prefix ``__str__`` adds.
Overload/deadline/circuit errors are *expected* under load: they are the
runtime doing its job (shedding) rather than queueing unboundedly, so
they deliberately subclass a common :class:`ServingError` that callers
can catch as "retry later elsewhere" without catching real bugs.
"""
from __future__ import annotations

from ..base import MXNetError
from ..deploy import TopologyMismatch

__all__ = ["ServingError", "Overloaded", "DeadlineExceeded", "CircuitOpen",
           "ExecFailed", "SwapFailed", "TopologyMismatch", "QuotaExceeded",
           "ReplicaUnavailable", "Cancelled"]


class ServingError(MXNetError):
    """Base of every typed serving-runtime error."""

    def __str__(self):
        # the C boundary flattens exceptions to their message string
        # (capi/c_api.cc FailFromPython -> MXGetLastError); the prefix
        # keeps the TYPE recoverable on that side of the ABI
        return "%s: %s" % (type(self).__name__,
                           super().__str__() or "(no detail)")


class Overloaded(ServingError):
    """Admission denied: the bounded queue is full and this request lost
    the priority comparison (or was evicted by a higher-priority one)."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed — before dispatch (dropped without
    touching the device) or before its result was delivered."""


class CircuitOpen(ServingError):
    """The circuit breaker is open (health BROKEN): the executor failed
    repeatedly and the runtime is shedding instantly until the cooldown
    probe succeeds."""


class ExecFailed(ServingError):
    """The compiled executor raised even after retry/backoff; the batch's
    requests fail with this and the circuit breaker records it."""


class SwapFailed(ServingError):
    """A hot model-swap was rejected (load failure, schema mismatch, or
    canary validation) — the previous model is still serving."""


class QuotaExceeded(Overloaded):
    """The fleet router shed this request at its TENANT's quota (token
    bucket or in-flight cap) — the tenant is flooding, and only its own
    traffic pays.  Subclasses :class:`Overloaded`: callers that already
    treat overload as "retry later" need no new handling."""


class ReplicaUnavailable(ServingError):
    """The replica holding this request died or its link broke before a
    result came back.  Internal to the router's retry/hedge machinery —
    callers only see it when every re-dispatch avenue is exhausted."""


class Cancelled(ServingError):
    """The router cancelled this dispatch (a hedge raced it and won, or
    the fleet is shutting down).  Never delivered to fleet callers: the
    winning copy's result, or a typed error, always arrives first."""
