"""Circuit breaker + health states for the serving runtime.

Health is a three-state ladder driven by CONSECUTIVE executor failures
(a failure = the compiled program raising even after retry/backoff):

* ``SERVING``  — closed circuit, no active failure streak.
* ``DEGRADED`` — circuit still closed but a streak is building, or the
  breaker is half-open (cooldown elapsed, probe traffic allowed).
* ``BROKEN``   — open circuit: ``threshold`` consecutive failures.
  Admission sheds instantly with :class:`errors.CircuitOpen` — a broken
  executor must cost callers an error in microseconds, not a queue slot
  and a deadline — until ``cooldown`` elapses and a probe batch closes
  the circuit again.

The states also cross the C ABI as ints (``MXPredGetHealth``):
SERVING=0, DEGRADED=1, BROKEN=2.
"""
from __future__ import annotations

import threading
import time

__all__ = ["SERVING", "DEGRADED", "BROKEN", "HEALTH_NAMES",
           "CircuitBreaker"]

SERVING, DEGRADED, BROKEN = 0, 1, 2
HEALTH_NAMES = {SERVING: "SERVING", DEGRADED: "DEGRADED", BROKEN: "BROKEN"}


class CircuitBreaker:
    """Consecutive-failure breaker (see module docstring)."""

    def __init__(self, threshold: int = 3, cooldown: float = 5.0):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self._lock = threading.Lock()
        self._streak = 0
        self._opened_at = None       # monotonic time the circuit opened
        self._half_open = False
        self.opened_total = 0        # telemetry: times the circuit opened
        self.recovered_total = 0     # telemetry: open -> closed recoveries

    # -- events -----------------------------------------------------------
    def record_success(self):
        with self._lock:
            if self._opened_at is not None:
                self.recovered_total += 1
            self._streak = 0
            self._opened_at = None
            self._half_open = False

    def record_failure(self):
        with self._lock:
            self._streak += 1
            if self._half_open:
                # failed probe: re-open for a fresh cooldown
                self._opened_at = time.monotonic()
                self._half_open = False
            elif self._opened_at is None and self._streak >= self.threshold:
                self._opened_at = time.monotonic()
                self.opened_total += 1

    # -- queries ----------------------------------------------------------
    def _cooldown_elapsed(self):
        return (self._opened_at is not None and
                time.monotonic() - self._opened_at >= self.cooldown)

    def admit_ok(self) -> bool:
        """May a new request enter the queue right now?  Open circuit:
        no (instant shed); half-open: yes (it becomes probe traffic)."""
        with self._lock:
            if self._opened_at is None or self._half_open:
                return True
            if self._cooldown_elapsed():
                self._half_open = True
                return True
            return False

    def dispatch_ok(self) -> bool:
        """May the worker send a batch to the executor right now?"""
        with self._lock:
            if self._opened_at is None or self._half_open:
                return True
            if self._cooldown_elapsed():
                self._half_open = True
                return True
            return False

    def health(self) -> int:
        with self._lock:
            if self._opened_at is not None:
                if self._half_open or self._cooldown_elapsed():
                    return DEGRADED
                return BROKEN
            return DEGRADED if self._streak > 0 else SERVING

    def describe(self) -> dict:
        with self._lock:
            return {
                "health": HEALTH_NAMES[
                    BROKEN if (self._opened_at is not None and
                               not self._half_open and
                               not self._cooldown_elapsed())
                    else (DEGRADED if (self._opened_at is not None or
                                       self._streak > 0) else SERVING)],
                "failure_streak": self._streak,
                "open": self._opened_at is not None,
                "half_open": self._half_open,
                "opened_total": self.opened_total,
                "recovered_total": self.recovered_total,
            }
