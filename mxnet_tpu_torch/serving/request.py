"""Request: one admitted unit of inference work + its delivery future.

A request carries 1..B rows of every model input (B = the artifact's
fixed batch dimension), an integer priority (higher = more important),
and an ABSOLUTE deadline on the monotonic clock.  Completion is a
one-shot future: exactly one of ``_deliver`` / ``_fail`` wins, whichever
runs first — the loser is a no-op, so a request shed by the admission
queue can never also be completed by the dispatch thread.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .errors import DeadlineExceeded, ServingError

__all__ = ["Request"]


class Request:
    """One admitted inference request (see module docstring)."""

    __slots__ = ("inputs", "rows", "priority", "deadline", "enqueued_at",
                 "seq", "t_popped", "t_dispatched", "t_exec_done",
                 "trace", "batch_seq",
                 "_event", "_outputs", "_error", "_done_at")

    def __init__(self, inputs: Dict[str, np.ndarray], rows: int,
                 priority: int = 0, deadline: Optional[float] = None,
                 seq: int = -1):
        self.inputs = inputs          # name -> (rows, *example_shape)
        self.rows = int(rows)
        self.priority = int(priority)
        self.deadline = deadline      # absolute time.monotonic(), or None
        self.enqueued_at = time.monotonic()
        self.seq = seq
        # telemetry phase timestamps (monotonic), set by the pipeline:
        # queue pop -> batch close/dispatch -> executor done -> delivery
        self.t_popped: Optional[float] = None
        self.t_dispatched: Optional[float] = None
        self.t_exec_done: Optional[float] = None
        # distributed tracing (telemetry/tracing.py): the wire-propagated
        # trace context this request belongs to, and the executor batch
        # it rode in — both None outside a traced fleet
        self.trace = None
        self.batch_seq: Optional[int] = None
        self._event = threading.Event()
        self._outputs: Optional[List[np.ndarray]] = None
        self._error: Optional[BaseException] = None
        self._done_at: Optional[float] = None

    # -- state ------------------------------------------------------------
    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None and
                (now if now is not None else time.monotonic())
                >= self.deadline)

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - (now if now is not None
                                else time.monotonic())

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency(self) -> Optional[float]:
        """Enqueue-to-delivery seconds, once done."""
        if self._done_at is None:
            return None
        return self._done_at - self.enqueued_at

    @property
    def done_at(self) -> Optional[float]:
        return self._done_at

    # -- completion (runtime side) ----------------------------------------
    def _deliver(self, outputs: List[np.ndarray]) -> bool:
        if self._event.is_set():
            return False
        if self.expired():
            # acceptance invariant: nothing completes after its deadline
            # without a DeadlineExceeded result — even if the value was
            # computed, a caller past its deadline must not be told "ok"
            return self._fail(DeadlineExceeded(
                "result ready %.3fs past the deadline"
                % (time.monotonic() - self.deadline)))
        self._outputs = outputs
        self._done_at = time.monotonic()
        self._event.set()
        return True

    def _fail(self, error: BaseException) -> bool:
        if self._event.is_set():
            return False
        self._error = error
        self._done_at = time.monotonic()
        self._event.set()
        return True

    # -- delivery (caller side) -------------------------------------------
    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        """Block for the outcome; raises the typed serving error on
        failure.  ``timeout`` only bounds THIS wait — the request itself
        stays governed by its deadline."""
        if not self._event.wait(timeout):
            raise ServingError("no result within %.3fs wait" % timeout)
        if self._error is not None:
            raise self._error
        return self._outputs
